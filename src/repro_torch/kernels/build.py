"""Build the CUDA sources under ``csrc/`` into ctypes-loadable libraries.

Each ``csrc/<name>.cu`` exports a plain C launch function. It is compiled
with ``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at
the repository root (listed in ``.gitignore``) the first time it is needed;
the hash covers the source, every shared header ``csrc/*.cuh`` and the
flags, so an edited source or header rebuilds and an unchanged one is
loaded as it is. Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    Returns the library path and the compiler's log (``-Xptxas -v``:
    registers, shared memory and spills per kernel; empty when nothing
    was compiled). Raises ``RuntimeError`` with the log if ``nvcc`` fails.
    The library is written to a temporary name and renamed, so concurrent
    builds never load a half-written file.
    """
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def sass_counts(path: Path, opcodes: tuple[str, ...]) -> dict[str, int]:
    """How many instructions of each opcode the library's SASS holds
    (``cuobjdump -sass``, found beside ``nvcc``): ``HGMMA`` is a wgmma,
    ``HMMA`` an mma.sync, ``UTMALDG`` a TMA tensor load and ``LDGSTS`` a
    cp.async copy."""
    tool = Path(nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                          text=True, check=True)
    words = proc.stdout.split()
    return {op: sum(w.startswith(op) for w in words) for op in opcodes}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, under the
    span ``kernels.build`` (arguments ``name``, and ``compiled``: whether
    ``nvcc`` ran)."""
    from repro_torch import obs
    with obs.get_tracer().span("kernels.build", name=name) as sp:
        compiled = not library_path(name).exists()
        path, _ = build(name)
        sp.set(compiled=compiled)
        return ctypes.CDLL(str(path))
