"""The check catches each fault a cell can have (its family's ``faults``),
planted in the timed path of a whole run at a tiny size on the CPU; for
the ``gnn`` family: a step that returns its state unchanged, the loss's
mean over half of the training nodes, an answer (an evaluation logit)
altered where it is produced, the lowest backward SpMM's result wrong in
one row block, and (with RSC) a planner that allocates half of the
budget. One card, so no exchange between cards to leave out."""
import pytest

import gb_check
import gb_harness
import readings
from gb_testing import (VARIANTS, of_family, one_torch_thread,  # noqa: F401
                        tiny_cell)


def _faults(name):
    cell = tiny_cell(name)
    return gb_harness.family_of(cell).faults(cell)


CASES = [(name, fault) for name in VARIANTS for fault in _faults(name)]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f}" for n, f in CASES])
def test_fault_is_not_correct(name, fault):
    out = gb_harness.run_cell(tiny_cell(name, epochs=16), 31, 0.5,
                              trace=False, device="cpu", fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", of_family("gnn"))
def test_layer0_fault_shows_in_its_layer(name):
    """The fault below the lowest backward SpMM moves that layer's leaves:
    the per-layer numbers fail where the median over all leaves need
    not."""
    cell = tiny_cell(name)
    rows = {r["reading"]: r for r in readings.read_seed(
        cell, 2027, "cpu", faults=("layer0",), control=False)}
    ok, checks = gb_check.judge(rows["sound"]["numbers"], cell["limits"])
    assert ok, checks
    bad = rows["layer0"]["numbers"]
    assert bad["grad1_layer"] > cell["limits"]["grad1_layer"], bad
    # the lowest backward SpMM hands its gradient to layer 0's leaves
    gaps = rows["layer0"]["where"]["grad1_gaps"]
    assert gb_check.layer_of(max(gaps, key=gaps.get)) == 0, gaps
