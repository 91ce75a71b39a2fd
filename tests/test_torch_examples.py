"""The port's examples (``examples/torch_*.py``) on the CPU.

Each runs in a subprocess with ``--device cpu`` at small arguments, all
at once (one intra-op thread each): its output has its namesake's JSON
keys (read from the namesake's source: the dict it hands to
``json.dumps``), less ``compiles`` for the GraphSAINT example (the port
compiles nothing); the quickstart prints its namesake's lines.
``torch_train_lm_rsc.py`` runs twice on one checkpoint directory and the
second run resumes from the first's last step. Without ``--device`` an
example asks for the card and fails here. None of them, nor
``chip_smoke.py``, imports JAX or ``repro``.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EX = ROOT / "examples"
RUNS = {
    "quickstart": [],
    "train_gcn_rsc": ["--epochs", "5", "--scale", "0.002"],
    "train_saint_rsc": ["--epochs", "2", "--scale", "0.002", "--subgraphs",
                        "4", "--roots", "50", "--walk-length", "2"],
    "train_lm_rsc": ["--steps", "16", "--batch", "2", "--seq", "16",
                     "--width", "64", "--rsc"],
    "serve_lm": ["--requests", "4", "--batch", "2", "--gen", "4"],
}
TIMEOUT = 240


def _start(name: str, args: list, env: dict) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(EX / f"torch_{name}.py"), *args], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen) -> tuple[int, str, str]:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               RSC_TORCH_AUTOTUNE_CACHE=str(tmp / "autotune.json"))
    ckpt = ["--ckpt", str(tmp / "lm_ckpt")]
    procs = {name: _start(name, args + ckpt * (name == "train_lm_rsc")
                          + ["--device", "cpu"], env)
             for name, args in RUNS.items()}
    procs["no_device"] = _start("serve_lm", RUNS["serve_lm"], env)
    out = {"lm_first": _finish(procs.pop("train_lm_rsc"))}
    resumed = RUNS["train_lm_rsc"].copy()
    resumed[1] = "32"
    procs["train_lm_rsc"] = _start("train_lm_rsc", resumed + ckpt
                                   + ["--device", "cpu"], env)
    out.update({name: _finish(p) for name, p in procs.items()})
    return out


def _json_keys(node) -> set:
    """The keys of a dict literal, nested ones as ``outer/inner``."""
    keys = set()
    for k, v in zip(node.keys, node.values):
        keys.add(k.value)
        if isinstance(v, ast.Dict):
            keys |= {f"{k.value}/{kk}" for kk in _json_keys(v)}
        elif isinstance(v, ast.DictComp):
            keys.add(f"{k.value}/*")
    return keys


def _namesake_keys(name: str) -> set:
    """The keys of the JSON the reference's example prints."""
    tree = ast.parse((EX / f"{name}.py").read_text())
    dumps = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "dumps"]
    assert len(dumps) == 1
    return _json_keys(dumps[0].args[0])


def _printed_keys(obj, prefix="") -> set:
    keys = set()
    for k, v in obj.items():
        keys.add(prefix + k)
        if isinstance(v, dict):
            keys |= ({f"{prefix}{k}/*"} if k == "modes"
                     else _printed_keys(v, f"{prefix}{k}/"))
    return keys


def _last_json(stdout: str) -> dict:
    """The JSON object at the end of the output (one line, or indented
    from a line that is ``{``)."""
    lines = stdout.rstrip().splitlines()
    if lines[-1].startswith("{"):
        return json.loads(lines[-1])
    start = max(i for i, line in enumerate(lines) if line == "{")
    return json.loads("\n".join(lines[start:]))


@pytest.mark.parametrize("name", ["train_gcn_rsc", "train_saint_rsc",
                                  "train_lm_rsc", "serve_lm"])
def test_example_prints_its_namesakes_keys(runs, name):
    rc, out, err = runs[name]
    assert rc == 0, err[-3000:]
    want = _namesake_keys(name) - {"compiles"}
    assert _printed_keys(_last_json(out)) == want


def test_quickstart_prints_its_namesakes_lines(runs):
    rc, out, err = runs["quickstart"]
    assert rc == 0, err[-3000:]
    tree = ast.parse((EX / "quickstart.py").read_text())
    heads = [n.args[0].values[0].value for n in ast.walk(tree)
             if isinstance(n, ast.Call) and getattr(n.func, "id", "") ==
             "print"]
    lines = out.strip().splitlines()
    assert len(lines) == len(heads) == 4
    assert all(line.startswith(h) for line, h in zip(lines, heads))


def test_lm_example_resumes_from_its_checkpoint(runs):
    rc, out, err = runs["lm_first"]
    assert rc == 0, err[-3000:]
    assert _last_json(out)["steps"] == 16
    rc, out, err = runs["train_lm_rsc"]
    assert rc == 0, err[-3000:]
    assert "resumed from step 16" in out
    assert _last_json(out)["steps"] == 16


def test_example_without_device_asks_for_the_card(runs):
    rc, out, err = runs["no_device"]
    assert rc != 0 and "no CUDA device" in err


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_examples_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted(EX.glob("torch_*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) == 6
    bad = [(f.name, n) for f in files for n in _imports(f)
           if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
