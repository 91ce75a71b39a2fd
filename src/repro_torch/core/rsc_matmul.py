"""rsc_matmul: the top-k-sampled weight gradient of transformer linears.

The port of ``repro.core.rsc_matmul`` (beyond the paper: RSC's dense
ancestor, Adelman et al. 2021 column-row sampling, applied to the weight
gradient of the LM's MLP products):

    y  = x @ w          x: (n, m)  w: (m, q)   n = tokens (dW's contraction)
    dW = xᵀ @ g         approximated: keep the top-k token BLOCKS by
                        ‖x_blk‖·‖g_blk‖ (bk-token granularity)
    dx = g @ wᵀ         exact (the forward and dx are exact, as in the paper)

The blocks are chosen inside the backward (the scores depend on g) from a
static keep count. Backends of the sampled dW:

* ``"kernel"`` — ``kernels.gather_matmul``: on a CUDA tensor the
  hand-written kernel, on a CPU tensor its plain version;
* ``"ref"`` — CPU tensors only: the plain version (the tests' yardstick);
  on the card it raises rather than run beside the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gather_matmul as gmod
from repro_torch.kernels.ref import gather_matmul_ref
from repro_torch.models.lm.sharding import current_mesh

BACKENDS = ("kernel", "ref")


def _block_norms(x: torch.Tensor, bk: int) -> torch.Tensor:
    """f32 L2 mass per ``bk``-row block: ``(n // bk,)``."""
    n = x.shape[0]
    x32 = x.float().reshape(n // bk, bk, -1)
    return torch.sqrt(torch.sum(x32 * x32, dim=(1, 2)))


def top_blocks(scores: torch.Tensor, keep_blocks: int) -> torch.Tensor:
    """The ``keep_blocks`` largest scores' block ids, sorted ascending,
    int32. Equal scores go to the lower block id first, as
    ``jax.lax.top_k`` breaks ties (a stable descending sort)."""
    order = torch.sort(scores, descending=True, stable=True).indices
    return torch.sort(order[:keep_blocks]).values.to(torch.int32)


def select_blocks(x: torch.Tensor, g: torch.Tensor, keep_blocks: int,
                  bk: int) -> torch.Tensor:
    """The ``keep_blocks`` blocks of largest ``‖x_blk‖·‖g_blk‖``
    (``top_blocks``)."""
    return top_blocks(_block_norms(x, bk) * _block_norms(g, bk), keep_blocks)


def _check_backend(backend: str, x: torch.Tensor) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown rsc_matmul backend {backend!r}; expected "
                         f"one of {BACKENDS}")
    if backend == "ref" and x.device.type != "cpu":
        raise ValueError(f"backend 'ref' runs CPU tensors only, got "
                         f"{x.device}; use backend 'kernel' on the card")


def _gather(x, g, idx, bk: int, backend: str) -> torch.Tensor:
    if backend == "ref":
        return gather_matmul_ref(x, g, idx, bk=bk)
    # top-k ids lie in [0, n / bk) by construction: no host check, no sync
    return gmod.gather_matmul_in_range(x.contiguous(), g.contiguous(), idx,
                                       bk=bk)


def sampled_xt_g(x: torch.Tensor, g: torch.Tensor, keep_blocks: int,
                 bk: int, backend: str = "kernel") -> torch.Tensor:
    """approx(xᵀ g) keeping the top-``keep_blocks`` token blocks."""
    _check_backend(backend, x)
    return _gather(x, g, select_blocks(x, g, keep_blocks, bk), bk, backend)


def sharded_xt_g(x: torch.Tensor, g: torch.Tensor, keep_frac: float,
                 bk: int, backend: str, split: str | None,
                 mesh) -> torch.Tensor:
    """This rank's share of approx(xᵀ g) under the reference's *global*
    block selection, on a bound mesh (``launch.mesh.Mesh``).

    ``x`` (n, m) and ``g`` (n, q) are this rank's tokens: its block of
    the global microbatch's rows over the batch axes (``pod``, ``data``),
    so its token blocks are the global ones ``[i·n/bk, (i+1)·n/bk)`` for
    its batch index ``i``. ``split`` names the operand whose feature
    dimension is split over ``model`` (``"g"`` for a column-parallel
    product, ``"x"`` for a row-parallel one): its squared block norms are
    summed over ``model``. The scores are gathered over the batch axes,
    one stable top-k picks ``keep_count`` of the global token count's
    blocks, and this rank contracts the selected blocks it holds: the
    ``(m, q)`` partial sum the gradient's reduction over the batch axes
    completes. A rank that holds none gives zeros and counts a skipped
    launch (``kernels.gather_matmul.skip``). A global token count that
    ``bk`` does not divide takes the exact ``xᵀ g``, as the reference
    does."""
    dp = mesh.dp_axes
    n_loc = x.shape[0]
    n = n_loc * mesh.axis_size(dp)
    if n % bk:
        return torch.matmul(x.t(), g)
    if n_loc % bk:
        raise ValueError(f"{n_loc} tokens per rank do not split into "
                         f"{bk}-token blocks ({n} over the batch axes do)")
    nb = n_loc // bk
    sq = []
    for name, t in (("x", x), ("g", g)):
        t32 = t.float().reshape(nb, bk, -1)
        s = torch.sum(t32 * t32, dim=(1, 2))
        sq.append(mesh.all_reduce(s, "model") if split == name else s)
    scores = torch.sqrt(sq[0]) * torch.sqrt(sq[1])
    idx = top_blocks(mesh.all_gather(scores, dp, 0),
                     keep_count(n, keep_frac, bk))
    lo = mesh.index(dp) * nb
    mine = idx[(idx >= lo) & (idx < lo + nb)] - lo
    if mine.numel() == 0:
        gmod.skip()
        return torch.zeros((x.shape[1], g.shape[1]), dtype=x.dtype,
                           device=x.device)
    return _gather(x, g, mine.to(torch.int32), bk, backend)


def keep_count(n: int, keep_frac: float, bk: int) -> int:
    """Blocks kept out of ``max(n // bk, 1)``: ``round(keep_frac · blocks)``
    (Python's round, half to even), at least 1 and at most all."""
    n_blocks = max(n // bk, 1)
    return max(1, min(n_blocks, int(round(keep_frac * n_blocks))))


class _RSCMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, keep_frac, bk, backend, split, mesh):
        ctx.save_for_backward(x, w)
        ctx.rsc = (keep_frac, bk, backend, split, mesh)
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        keep_frac, bk, backend, split, mesh = ctx.rsc
        # tokens flattened row-major over the leading (b, t) dims, as the
        # reference reshapes them
        x2 = x.reshape(-1, x.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g2, w.t()).reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1] and mesh is not None:
            dw = sharded_xt_g(x2, g2, keep_frac, bk, backend, split,
                              mesh).to(w.dtype)
        elif ctx.needs_input_grad[1]:
            n = x2.shape[0]
            if n % bk:   # ragged tail: the exact dW
                dw = torch.matmul(x2.t(), g2)
            else:
                dw = sampled_xt_g(x2, g2, keep_count(n, keep_frac, bk), bk,
                                  backend)
            dw = dw.to(w.dtype)
        return dx, dw, None, None, None, None, None


def rsc_matmul(x: torch.Tensor, w: torch.Tensor, keep_frac: float = 0.3,
               bk: int = 128, backend: str = "kernel",
               split: str | None = None) -> torch.Tensor:
    """``x @ w`` with a top-k-sampled dW and an exact dx. Under a mesh
    context of more than one rank (``models.lm.sharding``) the blocks are
    chosen globally (``sharded_xt_g``; ``split`` names the operand split
    over ``model``)."""
    _check_backend(backend, x)
    mesh = current_mesh()
    if mesh is not None and mesh.size == 1:
        mesh = None
    return _RSCMatmul.apply(x, w, keep_frac, bk, backend, split, mesh)
