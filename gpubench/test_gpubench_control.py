"""The control, each cell's family's (for ``gnn``: the plain reference
computed in TF32, one precision below the configuration's float32 with
TF32 off) put in the program's place, at a tiny size on the CPU, fails the
cell's limits; the program's own readings there pass them."""
import pytest

import gb_check
import readings
from gb_testing import VARIANTS, one_torch_thread, tiny_cell  # noqa: F401


@pytest.mark.parametrize("name", VARIANTS)
def test_control_fails_and_program_passes(name):
    cell = tiny_cell(name)
    rows = {r["reading"]: r["numbers"]
            for r in readings.read_seed(cell, 2024, "cpu", faults=())}
    ok, checks = gb_check.judge(rows["sound"], cell["limits"])
    assert ok, checks
    (control,) = [n for r, n in rows.items() if r != "sound"]
    ok, checks = gb_check.judge(control, cell["limits"])
    assert not ok, checks
