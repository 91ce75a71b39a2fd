"""Public dispatch for the hand-written kernels.

``bcoo_spmm`` picks the column tile ``bd`` the way ``repro.kernels.ops``
does: when none is given it reads ``autotune.lookup`` for the operand's
signature (``kernel``, or ``kernel_plain`` for a CPU tensor), whose miss
answers the reference's heuristic default (``default_bd``), so a shape
nobody tuned launches as it always did; a ``bd`` that does not divide
``d`` falls back to the ``gcd``. It then calls the kernel wrapper, which
launches the CUDA kernel for a CUDA tensor and runs the plain version for
a CPU tensor; ``bcoo_spmm_in_range`` is the same call without the host
check of the indices, for the planner's plans. ``gather_matmul`` and ``flash_attention``
call their wrappers the same way (kernel on a CUDA tensor, plain version
on a CPU tensor); each wrapper picks its kernel variant from the dtype and
shape alone.
"""
from __future__ import annotations

import logging
import math

from repro_torch import obs
from repro_torch.kernels import bcoo_spmm as _bcoo
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gather_matmul as _gather

logger = logging.getLogger(__name__)

DEFAULT_BD = 512
_bd_fallback_logged: set[tuple[int, int]] = set()


def default_bd(d: int) -> int:
    """The reference's heuristic column tile: ``min(512, d)``, or the
    whole of ``d`` when that does not divide it."""
    bd = min(DEFAULT_BD, d)
    return d if d % bd else bd


def resolve_bd(bd: int | None, d: int) -> int:
    if bd is None:
        bd = default_bd(d)
    bd = min(bd, d)
    if d % bd:
        # A requested bd that does not divide d falls back to the largest
        # common tile rather than failing dispatch; logged once per (bd, d).
        fell = math.gcd(bd, d)
        obs.get_registry().counter("autotune.bd_fallback", bd=bd, d=d)
        if (bd, d) not in _bd_fallback_logged:
            _bd_fallback_logged.add((bd, d))
            logger.info("bd=%d does not divide d=%d; dispatching gcd tile "
                        "bd=%d instead", bd, d, fell)
        bd = fell
    return bd


def bcoo_spmm(blocks, sel, row_ids, col_ids, h, *, n_row_blocks, bm, bk,
              bd: int | None = None, row_ptr=None, bias=None, residual=None,
              relu: bool = False):
    return _bcoo_call(_bcoo.bcoo_spmm, blocks, sel, row_ids, col_ids, h,
                      n_row_blocks, bm, bk, bd, row_ptr, bias, residual, relu)


def bcoo_spmm_in_range(blocks, sel, row_ids, col_ids, h, *, n_row_blocks,
                       bm, bk, bd: int | None = None, row_ptr=None,
                       bias=None, residual=None, relu: bool = False):
    """``bcoo_spmm`` without the host check of the indices (no device
    sync), for plans in range by construction: ``build_plan``,
    ``full_plan`` and ``exact_plan``'s (the training path)."""
    return _bcoo_call(_bcoo.bcoo_spmm_in_range, blocks, sel, row_ids,
                      col_ids, h, n_row_blocks, bm, bk, bd, row_ptr, bias,
                      residual, relu)


def tuned_bd(h, s_pad: int, n_row_blocks: int, bm: int, bk: int) -> int:
    """The autotuned column tile of this operand's signature, or
    ``default_bd(d)`` on a miss."""
    from repro_torch.kernels import autotune
    d = h.shape[-1]
    backend = "kernel" if h.device.type == "cuda" else "kernel_plain"
    sig = autotune.signature(
        backend, bm=bm, bk=bk, d=d, s_pad=s_pad, n_row_blocks=n_row_blocks,
        n_col_blocks=h.shape[0] // bk)
    bd = autotune.lookup(sig, d=d).bd
    obs.get_ledger().note_backend(sig, backend)
    return bd


def _bcoo_call(fn, blocks, sel, row_ids, col_ids, h, n_row_blocks, bm, bk,
               bd, row_ptr, bias, residual, relu):
    if h.dim() != 2 or h.shape[-1] < 1:
        raise ValueError(f"h must be (n_cols, d) with d >= 1, got "
                         f"{tuple(h.shape)}")
    if bd is None:
        bd = tuned_bd(h, sel.shape[0], n_row_blocks, bm, bk)
    return fn(blocks, sel, row_ids, col_ids, h, n_row_blocks=n_row_blocks,
              bm=bm, bk=bk, bd=resolve_bd(bd, h.shape[-1]), row_ptr=row_ptr,
              bias=bias, residual=residual, relu=relu)


def gather_matmul(x, g, idx, *, bk: int):
    return _gather.gather_matmul(x, g, idx, bk=bk)


def flash_attention(q, k, v, *, q_offset: int = 0, causal: bool = True,
                    window: int | None = None):
    return _flash.flash_attention(q, k, v, q_offset=q_offset, causal=causal,
                                  window=window)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {"bcoo_spmm": _bcoo.launches, "gather_matmul": _gather.launches,
            "flash_attention": _flash.launches}


def launch_counts_by_variant() -> dict[str, dict[str, int]]:
    """Launches of the kernels that have variants, split by variant."""
    return {"bcoo_spmm": dict(_bcoo.launches_by_variant),
            "gather_matmul": dict(_gather.launches_by_variant),
            "flash_attention": dict(_flash.launches_by_variant)}


def reset_launch_counts() -> None:
    _bcoo.reset_launches()
    _gather.reset_launches()
    _flash.reset_launches()
