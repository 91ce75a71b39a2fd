"""Row-segmented block-COO SpMM with a fused epilogue: the CUDA kernel's
wrapper.

    out[r·bm:(r+1)·bm, c] = epilogue(
        Σ_{s ∈ [row_ptr[r], row_ptr[r+1])} blocks[sel[s]] @ h[col_ids[s]·bk:+bk, c])
    epilogue(y) = relu?(y + bias[c] + residual[r·bm:(r+1)·bm, c])

The port of the Pallas TPU kernel ``repro.kernels.bcoo_spmm.bcoo_spmm``.
The kernel is ``csrc/bcoo_spmm.cu`` (design and bound in its header),
built with ``nvcc`` on first use and called through ``ctypes``. It has
three variants, chosen by ``variant(dtype, bm, bk, d)`` from the dtype and
the shape alone: ``"tf32x3"`` (f32, bk a multiple of 8: cp.async ring,
3xTF32 ``mma.sync``), ``"mma"`` (bf16, bk a multiple of 8: the same ring,
bf16 ``mma.sync``) and ``"fma"`` (FP32 FMAs, for bk not a multiple of 8).
The tensor-core variants cut each row block's segment into
``chunks(...)`` pieces (split-K, summed in a fixed order by a second
kernel), so a partition of few, long row blocks fills the card. No sum
depends on the CTAs' schedule: two launches on the same inputs give
bit-equal outputs. The column tile ``bd`` changes the grid, and through
it the chunk count, so other ``bd`` agree within the f32 tolerance.

For a CUDA tensor the wrapper launches the kernel or raises; for a tensor
that lies on the CPU it runs the plain version,
``repro_torch.kernels.ref.bcoo_spmm_ref``. Nothing falls back from one to
the other. ``launches`` counts kernel calls (one per SpMM, never
plain-version calls) and ``launches_by_variant`` splits them by variant.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.plan import plan_row_ptr
from repro_torch.kernels import build
from repro_torch.kernels.ref import bcoo_spmm_ref

BM_MAX = 128      # the kernel's largest tile height
TD = 64           # the fma variant's CTA column width
KSTEP = 8         # the tensor-core variants take bk % KSTEP == 0
MIN_CHUNK = 8     # a split leaves at least this many entries per chunk
_GRID_X_MAX = 2 ** 31 - 1
_GRID_YZ_MAX = 65535
_DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("fma", "tf32x3", "mma")   # the kernel's codes 0, 1, 2

launches = 0      # kernel calls since the last reset_launches()
launches_by_variant = dict.fromkeys(VARIANTS, 0)
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_variant.update(dict.fromkeys(VARIANTS, 0))


def variant(dtype: torch.dtype, bm: int, bk: int, d: int) -> str:
    """The kernel variant for tiles of ``(bm, bk)`` and ``d`` columns in
    ``dtype``: ``"tf32x3"`` for f32 and ``"mma"`` for bf16 when bk is a
    multiple of 8 (any d: ragged columns are masked), ``"fma"`` otherwise.
    Raises ``ValueError`` for other dtypes and shapes no kernel takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"no bcoo_spmm kernel for {dtype}")
    if not (1 <= bm <= BM_MAX and bk >= 1 and d >= 1):
        raise ValueError(f"no bcoo_spmm kernel for bm={bm}, bk={bk}, d={d} "
                         f"(bm <= {BM_MAX})")
    if bk % KSTEP:
        return "fma"
    return "tf32x3" if dtype == torch.float32 else "mma"


def _tile(bd: int) -> tuple[int, int]:
    """The tensor-core variants' column tile for a dispatched ``bd`` and
    how many such CTAs an SM holds (``Tile::CTAS`` in the kernel)."""
    return (48, 2) if bd <= 48 else (64, 2) if bd <= 64 else (128, 1)


def column_tiles(d: int, bd: int) -> int:
    """Column tiles of a row block in the tensor-core variants: each
    bd-wide tile cut into 48 (bd <= 48), 64 (bd <= 64) or 128 columns."""
    return d // bd * -(-bd // _tile(bd)[0])


def chunks(n_row_blocks: int, s_pad: int, d: int, bd: int,
           n_sm: int) -> int:
    """How many pieces the tensor-core variants cut each row block's
    segment into, from static shapes: as many as keep the (row block,
    chunk, column tile) CTAs within one wave of the card's slots (``n_sm``
    times the CTAs an SM holds at this tile), with at least ``MIN_CHUNK``
    entries per piece on average. 1 when the row blocks alone fill the
    card or the segments are short (a sampled backward plan's 1–10
    tiles)."""
    if n_row_blocks < 1:
        return 1
    fill = n_sm * _tile(bd)[1] // (n_row_blocks * column_tiles(d, bd))
    deep = s_pad // (n_row_blocks * MIN_CHUNK)
    return max(1, min(fill, deep))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("bcoo_spmm")
        fn = lib.bcoo_spmm_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(blocks, sel, row_ids, col_ids, h, n_row_blocks, bm, bk, bd,
           row_ptr, bias, residual) -> None:
    """Shape and dtype checks shared by both devices (raise ValueError)."""
    if blocks.dim() != 3 or tuple(blocks.shape[1:]) != (bm, bk):
        raise ValueError(f"blocks must be (S+1, {bm}, {bk}), "
                         f"got {tuple(blocks.shape)}")
    if h.dim() != 2 or h.shape[0] % bk:
        raise ValueError(f"h must be (n_cols, d) with n_cols % {bk} == 0, "
                         f"got {tuple(h.shape)}")
    d = h.shape[1]
    if d < 1 or bd < 1 or d % bd:
        raise ValueError(f"bd={bd} must divide d={d}")
    if blocks.dtype not in _DTYPES or h.dtype != blocks.dtype:
        raise ValueError(f"blocks and h must share a dtype in {_DTYPES}, "
                         f"got {blocks.dtype} and {h.dtype}")
    n = sel.shape[0]
    for name, ids in (("sel", sel), ("row_ids", row_ids),
                      ("col_ids", col_ids)):
        if ids.dim() != 1 or ids.shape[0] != n or ids.dtype != torch.int32:
            raise ValueError(f"{name} must be ({n},) int32, got "
                             f"{tuple(ids.shape)} {ids.dtype}")
    if row_ptr is not None and (row_ptr.dtype != torch.int32
                                or tuple(row_ptr.shape) != (n_row_blocks + 1,)):
        raise ValueError(f"row_ptr must be ({n_row_blocks + 1},) int32, got "
                         f"{tuple(row_ptr.shape)} {row_ptr.dtype}")
    if bias is not None and (tuple(bias.shape) != (d,)
                             or bias.dtype != h.dtype):
        raise ValueError(f"bias must be ({d},) {h.dtype}")
    if residual is not None and (
            tuple(residual.shape) != (n_row_blocks * bm, d)
            or residual.dtype != h.dtype):
        raise ValueError(f"residual must be ({n_row_blocks * bm}, {d}) "
                         f"{h.dtype}")


def _check_cuda(tensors: dict, device: torch.device, n_row_blocks: int,
                bm: int, bk: int, bd: int, d: int) -> None:
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, h on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bm > BM_MAX:
        raise ValueError(f"the kernel takes bm <= {BM_MAX}, got {bm}")
    if variant(tensors["h"].dtype, bm, bk, d) == "fma":
        if n_row_blocks > _GRID_X_MAX or d // bd > _GRID_YZ_MAX \
                or -(-bd // TD) > _GRID_YZ_MAX:
            raise ValueError(f"d={d}, bd={bd} exceed the kernel's grid")
        return
    # the chunks ride in the same grid dimension: at most the card's slots
    # when there is more than one, so the row blocks' count bounds it
    if n_row_blocks * column_tiles(d, bd) > _GRID_X_MAX:
        raise ValueError(f"{n_row_blocks} row blocks of d={d}, bd={bd} "
                         f"exceed the kernel's grid")
    for name in ("blocks", "h"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_indices(sel, col_ids, row_ptr, n_tiles: int,
                   n_col_blocks: int) -> None:
    """Index ranges, checked on the host (one device sync) so the kernel
    never reads outside its operands."""
    n = sel.shape[0]
    lims = [row_ptr[0], row_ptr[-1], torch.diff(row_ptr).min()
            if row_ptr.shape[0] > 1 else row_ptr[0] * 0]
    if n:
        lims += [sel.min(), sel.max(), col_ids.min(), col_ids.max()]
    v = torch.stack([x.to(torch.int64) for x in lims]).tolist()
    if v[0] < 0 or v[1] > n or v[2] < 0:
        raise ValueError(f"row_ptr must be non-decreasing within [0, {n}]")
    if n and (v[3] < 0 or v[4] >= n_tiles):
        raise ValueError(f"sel must lie in [0, {n_tiles})")
    if n and (v[5] < 0 or v[6] >= n_col_blocks):
        raise ValueError(f"col_ids must lie in [0, {n_col_blocks})")


def bcoo_spmm(
    blocks: torch.Tensor,    # (S+1, bm, bk) — +1 zero sentinel
    sel: torch.Tensor,       # (s_pad,) int32
    row_ids: torch.Tensor,   # (s_pad,) int32, sorted ascending
    col_ids: torch.Tensor,   # (s_pad,) int32
    h: torch.Tensor,         # (n_cols, d)
    *,
    n_row_blocks: int,
    bm: int,
    bk: int,
    bd: int,
    row_ptr: torch.Tensor | None = None,   # (n_row_blocks+1,) int32
    bias: torch.Tensor | None = None,      # (d,)
    residual: torch.Tensor | None = None,  # (n_row_blocks*bm, d)
    relu: bool = False,
) -> torch.Tensor:
    """The SpMM above, output ``(n_row_blocks·bm, d)`` in ``h``'s dtype.

    ``bd`` is the dispatcher's column tile and must divide ``d``. Without
    ``row_ptr`` it is recovered from the sorted ``row_ids``. On a CUDA
    tensor the index ranges are checked on the host, which synchronises
    with the card (``bcoo_spmm_in_range`` skips it). Raises
    ``ValueError`` on inputs the kernel does not take and
    ``RuntimeError`` if the launch fails.
    """
    return _dispatch(blocks, sel, row_ids, col_ids, h, n_row_blocks, bm, bk,
                     bd, row_ptr, bias, residual, relu, checked=True)


def bcoo_spmm_in_range(blocks, sel, row_ids, col_ids, h, *, n_row_blocks,
                       bm, bk, bd, row_ptr=None, bias=None, residual=None,
                       relu: bool = False) -> torch.Tensor:
    """``bcoo_spmm`` for plans whose indices lie in range by construction
    (``core.plan.build_plan`` / ``full_plan``, ``core.rsc_spmm.exact_plan``:
    the training path): no host check of the indices, so no
    synchronisation. The kernel does not check them either; an index out
    of range reads past the operands."""
    return _dispatch(blocks, sel, row_ids, col_ids, h, n_row_blocks, bm, bk,
                     bd, row_ptr, bias, residual, relu, checked=False)


def _dispatch(blocks, sel, row_ids, col_ids, h, n_row_blocks, bm, bk, bd,
              row_ptr, bias, residual, relu, *, checked: bool):
    _check(blocks, sel, row_ids, col_ids, h, n_row_blocks, bm, bk, bd,
           row_ptr, bias, residual)
    if h.device.type == "cpu":
        return bcoo_spmm_ref(blocks, sel, row_ids, col_ids, h,
                             n_row_blocks=n_row_blocks, bm=bm, bk=bk,
                             bias=bias, residual=residual, relu=relu)
    if h.device.type != "cuda":
        raise ValueError(f"bcoo_spmm takes CUDA tensors (kernel) or CPU "
                         f"tensors (plain version), got {h.device}")
    d = h.shape[1]
    if row_ptr is None:
        row_ptr = plan_row_ptr(row_ids, n_row_blocks)
    _check_cuda({"blocks": blocks, "sel": sel, "row_ids": row_ids,
                 "col_ids": col_ids, "h": h, "row_ptr": row_ptr,
                 "bias": bias, "residual": residual}, h.device,
                n_row_blocks, bm, bk, bd, d)
    if checked:
        _check_indices(sel, col_ids, row_ptr, blocks.shape[0],
                       h.shape[0] // bk)
    out = torch.empty((n_row_blocks * bm, d), dtype=h.dtype, device=h.device)
    if n_row_blocks > 0:
        launch(blocks, sel, col_ids, row_ptr, h, bias, residual, out,
               bm=bm, bk=bk, bd=bd, relu=relu)
    return out


def launch(blocks, sel, col_ids, row_ptr, h, bias, residual, out, *, bm,
           bk, bd, relu, force: str | None = None) -> None:
    """Launch the kernel into ``out`` on the current stream, without the
    wrapper's checks — for inputs a ``bcoo_spmm`` call has accepted (the
    timing loop and the sweep of ``chip_smoke.py``). ``force="fma"`` runs
    the FMA variant where a tensor-core one would be picked. Counts the
    call once, under its variant."""
    global launches
    lib = _library()
    n_row_blocks, d = out.shape[0] // bm, out.shape[1]
    var = variant(h.dtype, bm, bk, d)
    if force not in (None, "fma", var):
        raise ValueError(f"variant {force!r} does not take {h.dtype} tiles "
                         f"of ({bm}, {bk})")
    var = force or var
    n = 1 if var == "fma" else chunks(
        n_row_blocks, sel.shape[0], d, bd, _sm_count(h.device.index))
    ws = torch.empty((n, out.shape[0], d), dtype=torch.float32,
                     device=h.device) if n > 1 else None
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.bcoo_spmm_launch(
            blocks.data_ptr(), sel.data_ptr(), col_ids.data_ptr(),
            row_ptr.data_ptr(), h.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), ws.data_ptr() if ws is not None else None,
            n_row_blocks, bm, bk, d, bd, blocks.shape[0] - 1,
            int(bool(relu)), int(h.dtype == torch.bfloat16),
            VARIANTS.index(var), n, stream)
    if err != 0:
        raise RuntimeError(f"bcoo_spmm kernel ({var}) launch failed: CUDA "
                           f"error {err}")
    launches += 1
    launches_by_variant[var] += 1
