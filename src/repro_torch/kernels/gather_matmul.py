"""Block-gathered matmul (the sampled weight gradient of ``rsc_matmul``):
the CUDA kernel's wrapper.

    out = Σ_t X[idx[t]·bk : +bk, :]ᵀ @ G[idx[t]·bk : +bk, :]

summed in f32 and cast to x's dtype. The port of the Pallas TPU kernel
``repro.kernels.gather_matmul.gather_matmul`` (its XᵀG form, the only one
``rsc_matmul`` uses). The kernel is ``csrc/gather_matmul.cu`` (design and
bound in its header), built with ``nvcc`` on first use and called through
``ctypes``. It has three variants, chosen by ``variant(dtype, m, q)`` from
the dtype and the widths alone: ``"wgmma"`` (bf16, m and q multiples of 8:
TMA ring + wgmma), ``"mma"`` (bf16, other widths: mma.sync) and ``"fma"``
(f32).

For a CUDA tensor the wrapper launches the kernel or raises; for a tensor
that lies on the CPU it runs the plain version,
``repro_torch.kernels.ref.gather_matmul_ref``. Nothing falls back from one
to the other. ``launches`` counts kernel launches (never plain-version
calls) and ``launches_by_variant`` splits them by variant.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import gather_matmul_ref

KC = 32            # the kernel stages 32 tokens at a time: bk % KC == 0
_TILE = 128        # the bf16 kernel's output tile (the f32 one's is 64)
_GRID_Y_MAX = 65535
_DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("fma", "mma", "wgmma")   # the kernel's codes 0, 1, 2

launches = 0      # kernel launches since the last reset_launches()
launches_by_variant = dict.fromkeys(VARIANTS, 0)
# calls with no selected block on this rank (a sharded RSC dW whose global
# selection falls wholly on other ranks' tokens), not launched
skipped = 0
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    global launches, skipped
    launches = skipped = 0
    launches_by_variant.update(dict.fromkeys(VARIANTS, 0))


def skip() -> None:
    """Count a call this rank did not launch: it held none of the selected
    blocks, and its share of the product is zero."""
    global skipped
    skipped += 1


def variant(dtype: torch.dtype, m: int, q: int) -> str:
    """The kernel variant that x of ``dtype`` with output ``(m, q)`` runs:
    ``"wgmma"`` for bf16 with m and q multiples of 8 (TMA needs 16-byte
    row strides), ``"mma"`` for other bf16 widths, ``"fma"`` for f32."""
    if dtype == torch.float32:
        return "fma"
    if dtype == torch.bfloat16:
        return "wgmma" if m % 8 == 0 and q % 8 == 0 else "mma"
    raise ValueError(f"no gather_matmul kernel for {dtype}")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("gather_matmul")
        fn = lib.gather_matmul_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, g, idx, bk) -> None:
    """Shape and dtype checks shared by both devices (raise ValueError)."""
    if x.dim() != 2 or g.dim() != 2 or x.shape[0] != g.shape[0]:
        raise ValueError(f"x and g must be (n, m) and (n, q), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if x.dtype not in _DTYPES or g.dtype != x.dtype:
        raise ValueError(f"x and g must share a dtype in {_DTYPES}, got "
                         f"{x.dtype} and {g.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be a 1-D int32 tensor, got "
                         f"{idx.dtype} of shape {tuple(idx.shape)}")
    if not isinstance(bk, int) or bk < 1 or x.shape[0] % bk:
        raise ValueError(f"bk must be a positive int dividing n = "
                         f"{x.shape[0]}, got {bk!r}")


def _check_range(idx, n_blocks) -> None:
    """Every id in ``[0, n_blocks)`` (copies idx to the host)."""
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n_blocks):
        raise ValueError(f"idx holds a block id outside [0, {n_blocks})")


def _check_cuda(x, g, idx, bk) -> None:
    for name, t in (("g", g), ("idx", idx)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("g", g), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("x", x), ("g", g)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if bk % KC:
        raise ValueError(f"the kernel takes bk a multiple of {KC}, got {bk}")
    if idx.numel() < 1:
        raise ValueError("the kernel needs at least one selected block")
    n, m = x.shape
    if -(-m // _TILE) > _GRID_Y_MAX or max(n, m, g.shape[1]) >= 2 ** 31:
        raise ValueError(f"x of shape {tuple(x.shape)} exceeds the kernel's "
                         f"grid or int32 sizes")


def gather_matmul(
    x: torch.Tensor,     # (n, m)
    g: torch.Tensor,     # (n, q)
    idx: torch.Tensor,   # (k_sel,) int32 selected bk-row blocks
    *,
    bk: int,
) -> torch.Tensor:
    """The contraction above, ``(m, q)`` in x's dtype.

    Checks on the host that every id lies in ``[0, n / bk)``, which
    synchronises with the card (``gather_matmul_in_range`` skips it).
    Raises ``ValueError`` on an id out of range and on inputs the kernel
    does not take (on a CUDA tensor: bk not a multiple of 32, no selected
    block, mixed devices, non-contiguous or misaligned tensors), and
    ``RuntimeError`` if the launch fails.
    """
    _check(x, g, idx, bk)
    _check_range(idx, x.shape[0] // bk)
    return _dispatch(x, g, idx, bk)


def gather_matmul_in_range(x, g, idx, *, bk) -> torch.Tensor:
    """``gather_matmul`` for ids in ``[0, n / bk)`` by construction
    (``core.rsc_matmul``'s top-k): no host check, so no synchronisation.
    The kernel does not check ids either; one out of range reads past x."""
    _check(x, g, idx, bk)
    return _dispatch(x, g, idx, bk)


def _dispatch(x, g, idx, bk) -> torch.Tensor:
    if x.device.type == "cpu":
        return gather_matmul_ref(x, g, idx, bk=bk)
    if x.device.type != "cuda":
        raise ValueError(f"gather_matmul takes CUDA tensors (kernel) or CPU "
                         f"tensors (plain version), got {x.device}")
    _check_cuda(x, g, idx, bk)
    out = torch.empty((x.shape[1], g.shape[1]), dtype=x.dtype,
                      device=x.device)
    if out.numel():
        launch(x, g, idx, out, bk=bk)
    return out


def launch(x, g, idx, out, *, bk) -> None:
    """Launch the kernel into ``out`` on the current stream, without the
    wrapper's checks — for inputs a ``gather_matmul`` call has accepted
    (the timing loop of ``chip_smoke.py``). Counts the launch under its
    variant."""
    global launches
    lib = _library()
    (n, m), q = x.shape, g.shape[1]
    var = variant(x.dtype, m, q)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gather_matmul_launch(
            x.data_ptr(), g.data_ptr(), idx.data_ptr(), out.data_ptr(), n, m,
            q, idx.numel(), bk, VARIANTS.index(var), stream)
    if err != 0:
        raise RuntimeError(f"gather_matmul kernel ({var}) launch failed: "
                           f"CUDA error {err}")
    launches += 1
    launches_by_variant[var] += 1
