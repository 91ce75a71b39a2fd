"""Flash-attention forward (GQA, causal, sliding window): the CUDA kernel's
wrapper.

    out[b, i, h] = softmax_j(q[b, i, h] · k[b, j, h // (nq/nkv)] · hd^-0.5,
                             masked to -1e30) @ v[b, :, h // (nq/nkv)]

Query ``i`` sits at position ``q_offset + i``. The port of the Pallas TPU
kernel ``repro.kernels.flash_attention.flash_attention_fwd``. The kernel is
``csrc/flash_attention.cu`` (design and bound in its header), built with
``nvcc`` on first use and called through ``ctypes``. It has four
variants, chosen by ``variant(dtype, hd)`` from the dtype and the head
dimension alone: ``"wgmma"`` (bf16, hd 64 or 128: TMA ring + wgmma),
``"wgmma_hd256"`` (bf16, hd 256: the same with one consumer warpgroup),
``"mma"`` (bf16, hd 16: mma.sync) and ``"fma"`` (f32).

For a CUDA tensor the wrapper launches the kernel or raises; for a tensor
that lies on the CPU it runs the plain version,
``repro_torch.kernels.ref.flash_attention_ref``. Nothing falls back from
one to the other. ``launches`` counts kernel launches (never plain-version
calls) and ``launches_by_variant`` splits them by variant.

The wrapper calls the custom op ``torch.ops.repro_torch.flash_attention_fwd``,
whose implementation is that dispatch. On ``meta`` tensors (the dry run,
``launch/dryrun.py``) or under a ``FakeTensorMode`` its registered fake
runs instead: an empty tensor of q's shape and dtype, after the kernel's
own shape checks; a FLOP counter counts its registered formula
(``flops``: the operations of the kernel's bound), not the plain
version's (b, h, q, k) scores.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (16, 64, 128, 256)   # the models' 64, 128 and 256; smoke 16
_GRID_Y_MAX = 65535
_DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("fma", "mma", "wgmma", "wgmma_hd256")   # kernel codes 0-3

launches = 0      # kernel launches since the last reset_launches()
launches_by_variant = dict.fromkeys(VARIANTS, 0)
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_variant.update(dict.fromkeys(VARIANTS, 0))


def variant(dtype: torch.dtype, hd: int) -> str:
    """The kernel variant that q of ``dtype`` and head dimension ``hd``
    runs: ``"wgmma"`` for bf16 at hd 64 or 128, ``"wgmma_hd256"`` for bf16
    at hd 256, ``"mma"`` for bf16 at hd 16, ``"fma"`` for f32 at any hd in
    ``HEAD_DIMS``."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes hd in {HEAD_DIMS}, got {hd}")
    if dtype == torch.float32:
        return "fma"
    if dtype == torch.bfloat16:
        return {16: "mma", 256: "wgmma_hd256"}.get(hd, "wgmma")
    raise ValueError(f"no flash_attention kernel for {dtype}")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k, v, q_offset, window) -> None:
    """Shape and dtype checks shared by both devices (raise ValueError)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (b, t, heads, hd)")
    b, tq, nq, hd = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != b \
            or k.shape[3] != hd:
        raise ValueError(f"k and v must be (b={b}, tk, nkv, hd={hd}) alike, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    tk, nkv = k.shape[1], k.shape[2]
    if tk < 1 or nkv < 1 or nq % nkv:
        raise ValueError(f"need tk >= 1 and nq % nkv == 0, got tk={tk}, "
                         f"nq={nq}, nkv={nkv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in {_DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not isinstance(q_offset, int):
        raise ValueError(f"q_offset must be an int, got {type(q_offset)}")
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"window must be None or a positive int, got "
                         f"{window!r}")


def _check_cuda(q, k, v, q_offset, window) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, tq, nq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes hd in {HEAD_DIMS}, got {hd}")
    if b * nq > _GRID_Y_MAX:
        raise ValueError(f"b * nq = {b * nq} exceeds the kernel's grid")
    if abs(q_offset) + tq + k.shape[1] + (window or 0) >= 2 ** 31:
        raise ValueError("positions exceed the kernel's int32 arithmetic")


def flash_attention(
    q: torch.Tensor,    # (b, tq, nq, hd)
    k: torch.Tensor,    # (b, tk, nkv, hd)
    v: torch.Tensor,    # (b, tk, nkv, hd)
    *,
    q_offset: int = 0,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """The attention above, output of q's shape and dtype.

    Raises ``ValueError`` on inputs the kernel does not take (on a CUDA
    tensor: hd not in ``HEAD_DIMS``, mixed devices, non-contiguous or
    misaligned tensors) and ``RuntimeError`` if the launch fails.
    """
    _check(q, k, v, q_offset, window)
    return torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, q_offset, bool(causal), window or 0)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_offset: int, causal: bool,
                         window: int) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors
    (``window`` 0: none)."""
    window = window or None
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_offset=q_offset, causal=causal,
                                   window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CUDA tensors (kernel) or "
                         f"CPU tensors (plain version), got {q.device}")
    _check_cuda(q, k, v, q_offset, window)
    out = torch.empty_like(q)
    if q.shape[1] > 0 and q.shape[0] > 0:
        launch(q, k, v, out, q_offset=q_offset, causal=causal, window=window)
    return out


@_flash_attention_fwd.register_fake
def _(q, k, v, q_offset, causal, window):
    variant(q.dtype, q.shape[3])          # raises where the kernel would
    if q.shape[0] * q.shape[2] > _GRID_Y_MAX:
        raise ValueError(f"b * nq = {q.shape[0] * q.shape[2]} exceeds the "
                         "kernel's grid")
    return torch.empty_like(q)


def attended_pairs(tq: int, tk: int, q_offset: int = 0, causal: bool = True,
                   window: int | None = None) -> int:
    """The (query, key) pairs the masks keep: query ``i`` at position
    ``q_offset + i`` sees keys ``j`` with ``j <= q_offset + i`` (causal)
    and ``j > q_offset + i - window``."""
    qpos = q_offset + np.arange(tq, dtype=np.int64)
    hi = np.minimum(tk - 1, qpos) if causal else np.full(tq, tk - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(tq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flops(q_shape, k_shape, q_offset: int = 0, causal: bool = True,
          window: int | None = None) -> int:
    """The kernel's operations, as its bound counts them: ``4·hd`` (Q·Kᵀ
    and P·V, a multiply and an add each) for every attended (query, key)
    pair of every batch row and query head."""
    b, tq, nq, hd = q_shape
    return 4 * b * nq * hd * attended_pairs(tq, k_shape[1], q_offset, causal,
                                            window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flash_flops(q_shape, k_shape, v_shape, q_offset, causal, window, *,
                 out_shape=None, **kwargs) -> int:
    return flops(q_shape, k_shape, q_offset, causal, window or None)


def launch(q, k, v, out, *, q_offset, causal, window) -> None:
    """Launch the kernel into ``out`` on the current stream, without the
    wrapper's checks — for inputs a ``flash_attention`` call has accepted
    (the timing loop of ``chip_smoke.py``). Counts the launch under its
    variant."""
    global launches
    lib = _library()
    b, tq, nq, hd = q.shape
    tk, nkv = k.shape[1], k.shape[2]
    var = variant(q.dtype, hd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, tq, tk, nq, nkv, hd, q_offset, int(bool(causal)),
            window or 0, hd ** -0.5, VARIANTS.index(var), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({var}) launch failed: "
                           f"CUDA error {err}")
    launches += 1
    launches_by_variant[var] += 1
