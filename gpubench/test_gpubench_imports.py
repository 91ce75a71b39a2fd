"""What the run imports: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (the JAX package; ``repro_torch`` is the
program), neither loaded nor named in an import statement of any file the
run loads from the checkout; and nothing the harness runs reads the JAX
package's benches or their results."""
import ast
import json
import subprocess
import sys

import gb_harness
import run as run_entry

ROOT = gb_harness.ROOT
PROBE = r"""
import json, sys
sys.path.insert(0, "gpubench")
import run
run._environment()
import torch
torch.set_num_threads(1)
import gb_testing, gb_harness
out = gb_harness.run_cell(gb_testing.tiny_cell("sage-reddit-rsc"), 3, 0.5,
                          trace=True, device="cpu")
gb_harness.metrics_line(out, trace=True)
files = sorted({getattr(m, "__file__", None) or "" for m in
                list(sys.modules.values())} - {""})
print(json.dumps({"modules": sorted(sys.modules), "files": files,
                  "correct": out["correct"]}))
"""


def _imported_tops(path) -> set[str]:
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_run_imports_no_jax_and_no_reference_package():
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"]
    loaded = {m.split(".")[0] for m in res["modules"]}
    assert not loaded & set(run_entry.FORBIDDEN)
    ours = [f for f in res["files"] if f.startswith(str(ROOT))]
    assert any("/src/repro_torch/" in f for f in ours)
    assert any(f.endswith("gpubench/gb_harness.py") for f in ours)
    for f in ours:
        bad = _imported_tops(f) & set(run_entry.FORBIDDEN)
        assert not bad, f"{f} imports {bad}"


def test_harness_reads_no_reference_bench():
    words = ("benchmarks" + "/", "BENCH" + "_", "chip_smoke")
    for path in gb_harness.HERE.rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        text = path.read_text()
        assert not any(w in text for w in words), path
        assert not _imported_tops(path) & set(run_entry.FORBIDDEN), path
