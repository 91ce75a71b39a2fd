"""What the benchmark's CPU tests share: the program on the path, one
torch thread per test module (``one_torch_thread``, imported by each
module), and the cells cut to a tiny size and run through the kernels'
plain versions. (Not a ``conftest.py``: the repository's tests import
their own ``conftest`` by name.)

``CELLS`` are ``BENCHMARK.json``'s workloads; ``VARIANTS`` adds, for each,
the same cell under every other traffic mix in ``traffic/`` (named
``<config>-<mix>``), so a mix no cell runs yet stays tested."""
import copy
import json
import sys
from pathlib import Path

import pytest
import torch

_SRC = str(Path(__file__).resolve().parent.parent / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

import gb_harness  # noqa: E402

_BENCH = json.loads((gb_harness.ROOT / "BENCHMARK.json").read_text())
CELLS = tuple(w["name"] for w in _BENCH["workloads"])
_MIXES = sorted(p.stem for p in (gb_harness.HERE / "traffic").glob("*.json"))
# variant name -> (cell it copies, traffic mix it runs)
VARIANTS = {name: (name, None) for name in CELLS}
for _w in _BENCH["workloads"]:
    for _mix in _MIXES:
        _name = f"{_w['config']}-{_mix}"
        if _mix != _w["traffic"] and _name not in VARIANTS:
            VARIANTS[_name] = (_w["name"], _mix)
# Every width cut, the graph to a few hundred nodes, a training to 30
# epochs: the first plan refresh (step 10), the switch-back (step 24) and
# evaluations stay in.
TINY = {"nodes": 640, "feat_dim": 24, "hidden": 16, "block": 32,
        "avg_degree": 12.0}


def tiny_cell(name: str, **traffic) -> dict:
    """A cell of ``VARIANTS`` cut to the tiny size; its limits are those of
    the cell it copies."""
    base, mix = VARIANTS[name]
    cell = copy.deepcopy(gb_harness.load_cell(base))
    if mix is not None:
        cell["traffic"] = json.loads((gb_harness.HERE / "traffic"
                                      / f"{mix}.json").read_text())
    cell["config"].update(TINY)
    cell["traffic"].update({"epochs": 30, **traffic})
    return cell


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
