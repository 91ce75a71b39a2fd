"""What the benchmark's CPU tests share: the program on the path, one
torch thread per test module (``one_torch_thread``, imported by each
module), and the cells cut to a tiny size and run through the kernels'
plain versions. (Not a ``conftest.py``: the repository's tests import
their own ``conftest`` by name.)

``CELLS`` are ``BENCHMARK.json``'s workloads; ``VARIANTS`` adds, for each,
the same cell under every other traffic mix of its family in ``traffic/``
(named ``<config>-<mix>``), so a mix no cell runs yet stays tested;
``FAMILY`` gives each variant's family. Each family cuts its cells to the
tiny size (its ``tiny``)."""
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
_MIXES = {p.stem: gb_harness.family_name(json.loads(p.read_text()))
          for p in sorted((gb_harness.HERE / "traffic").glob("*.json"))}
# variant name -> (cell it copies, traffic mix it runs)
VARIANTS = {name: (name, None) for name in CELLS}
FAMILY = {name: gb_harness.load_cell(name)["family"] for name in CELLS}
for _w in _BENCH["workloads"]:
    for _mix, _fam in _MIXES.items():
        _name = f"{_w['config']}-{_mix}"
        if (_mix != _w["traffic"] and _fam == FAMILY[_w["name"]]
                and _name not in VARIANTS):
            VARIANTS[_name] = (_w["name"], _mix)
            FAMILY[_name] = _fam


def of_family(family: str) -> list[str]:
    """The variants of one family."""
    return [v for v in VARIANTS if FAMILY[v] == family]


def tiny_cell(name: str, **traffic) -> dict:
    """A cell of ``VARIANTS`` cut by its family to the tiny size; its
    limits are those of the cell it copies."""
    base, mix = VARIANTS[name]
    cell = copy.deepcopy(gb_harness.load_cell(base))
    if mix is not None:
        cell["traffic"] = json.loads((gb_harness.HERE / "traffic"
                                      / f"{mix}.json").read_text())
    return gb_harness.family_of(cell).tiny(cell, **traffic)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
