"""The mesh context of the LM stack: logical axes, shape checks, and the
collectives of FSDP and tensor parallelism.

The port of ``repro.models.lm.sharding``. The reference's model code
annotates activations with logical axes (``shard(x, "batch", None,
"heads", None)``) and XLA lays them out on the mesh a launcher installs.
The port runs one process per rank, so nothing can be laid out for it:

* ``mesh_context(mesh, rules, sizes)`` installs the mesh, the
  logical-to-mesh rules (``TRAIN_RULES``, ``DECODE_RULES``, the
  reference's) and the global size of each logical axis the caller knows;
* ``shard(x, *logical_axes)`` is where a module checks that its local
  tensor has the shape the rules give on this rank (global size over the
  mesh axes the rule names), and returns ``x``; without a context it is a
  no-op;
* ``gather_params`` is FSDP's unit (a layer's parameters): each
  parameter's stored block is all-gathered over every mesh axis its
  compute layout does not keep, and in the backward its gradient is
  reduce-scattered back to the block (and summed over the axes it is
  replicated on), one collective per mesh line and dtype;
* ``copy_to_model`` / ``reduce_from_model`` are Megatron's conjugate
  pair around a tensor-parallel region (identity forward and all-reduce
  over ``model`` backward, and the reverse);
* ``gather_from_model`` turns a ``model``-split activation whole (an
  all-gather forward), its backward either this rank's slice of a
  gradient that is whole on every rank, or the reduce-scatter of one
  that each rank holds only a share of;
* serving under ``DECODE_RULES`` keeps the KV cache sequence parallel
  (``kv_seq`` over ``model``): ``kv_seq_slice`` is a rank's range of
  such an axis (the whole axis where ``model`` does not divide it), and
  decode attention gathers the queries over ``model`` (``gather_heads``)
  and merges the softmax of the ranks' blocks (``softmax_over_model``:
  an all-reduce max of the row maxima, then one all-reduce sum of the
  exponential sums and the f32 partial outputs).

The context is process-wide, not thread-local as in the reference: the
autograd engine runs a CUDA backward (and the recomputation of a
checkpointed layer) on its own thread, which must see it too.
"""
from __future__ import annotations

import contextlib
import re

import torch

# Logical-axis dictionaries (the reference's).
TRAIN_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    # kv heads replicated across TP: GQA kv counts rarely divide it
    "kv_heads": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "kv_seq": None,
}

DECODE_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": None,       # GQA kv counts rarely divide TP
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "kv_seq": "model",      # sequence-parallel KV cache
}

_STACK: list[tuple] = []


def _axes_in_mesh(mesh, axes):
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if axes in mesh.axis_names else None
    kept = tuple(a for a in axes if a in mesh.axis_names)
    return kept if kept else None


@contextlib.contextmanager
def mesh_context(mesh, rules: dict, sizes: dict | None = None):
    """Install ``mesh`` (a bound ``launch.mesh.Mesh``) and ``rules`` for
    the enclosed code; ``sizes`` gives the global size of the logical
    axes ``shard`` should check (``{"batch": rows, "heads": n_heads,
    ...}``)."""
    _STACK.append((mesh, rules, dict(sizes or {})))
    try:
        yield
    finally:
        _STACK.pop()


def current_mesh():
    return _STACK[-1][0] if _STACK else None


def shard(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """Check ``x``'s local shape against the rules (see the module's
    docstring); returns ``x``. Raises ``ValueError`` on a mismatch."""
    if not _STACK:
        return x
    mesh, rules, sizes = _STACK[-1]
    if len(logical_axes) != x.ndim:
        raise ValueError(f"{len(logical_axes)} logical axes for a tensor of "
                         f"shape {tuple(x.shape)}")
    for d, name in enumerate(logical_axes):
        if name is None or name not in sizes:
            continue
        k = mesh.axis_size(_axes_in_mesh(mesh, rules.get(name)))
        if sizes[name] % k or x.shape[d] != sizes[name] // k:
            raise ValueError(
                f"logical axis {name!r} (global {sizes[name]}, over "
                f"{rules.get(name)!r} = {k} ranks): dim {d} of the local "
                f"tensor is {x.shape[d]}")
    return x


def tp_size(mesh=None) -> int:
    """The ``model`` axis's size of ``mesh`` (the current one by
    default); 1 without a mesh."""
    mesh = mesh if mesh is not None else current_mesh()
    return 1 if mesh is None else mesh.axis_size("model")


def global_size(name: str) -> int | None:
    """The global size of logical axis ``name`` the current context was
    given (``mesh_context``'s ``sizes``), or None."""
    return _STACK[-1][2].get(name) if _STACK else None


def kv_seq_slice(n: int) -> slice:
    """This rank's range of a ``kv_seq`` axis of global length ``n``: its
    block where the rules split ``kv_seq`` (``DECODE_RULES``: over
    ``model``) and the mesh divides ``n``, else the whole axis (as
    ``launch.shardings.sanitize_shardings`` replicates it)."""
    if not _STACK:
        return slice(0, n)
    mesh, rules, _ = _STACK[-1]
    axes = _axes_in_mesh(mesh, rules.get("kv_seq"))
    k = mesh.axis_size(axes)
    if k == 1 or n % k:
        return slice(0, n)
    i = mesh.index(axes)
    return slice(i * n // k, (i + 1) * n // k)


def kv_seq_block(x: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's ``kv_seq`` block (``kv_seq_slice``) of the whole ``x``
    (b, n, ...): a copy that owns its memory, or ``x`` itself where the
    axis is not split."""
    sl = kv_seq_slice(n)
    return x if sl.stop - sl.start == n else x[:, sl].clone()


def kv_seq_length(block: torch.Tensor) -> int:
    """The global sequence length of a full-attention (or MLA) cache of
    which ``block`` (b, S, ...) is this rank's share: the context's
    ``kv_seq`` size, which the sharded serving steps set."""
    n = global_size("kv_seq")
    if n is None:
        raise ValueError("sharded decode needs the cache's global length "
                         "(mesh_context sizes['kv_seq'])")
    sl = kv_seq_slice(n)
    if block.shape[1] != sl.stop - sl.start:
        raise ValueError(f"a cache block of {block.shape[1]} positions, "
                         f"this rank's share of {n} is {sl}")
    return n


# ------------------------------------------------------------ TP collectives

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a tensor-parallel region: ``x`` as it is, its
    gradient summed over ``model`` (each rank's holds only its own
    heads' or columns' share)."""
    mesh = current_mesh()
    return x if tp_size(mesh) == 1 else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel product: the sum of every ``model``
    rank's partial ``x``; the gradient passes through."""
    mesh = current_mesh()
    return x if tp_size(mesh) == 1 else _ReduceFromModel.apply(x, mesh)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, partial):
        ctx.mesh, ctx.dim, ctx.partial = mesh, dim, partial
        return mesh.all_gather(x, "model", dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.mesh, ctx.dim
        if ctx.partial:
            return mesh.reduce_scatter(g, "model", dim), None, None, None
        n = g.shape[dim] // mesh.axis_size("model")
        return g.narrow(dim, mesh.index("model") * n, n), None, None, None


def gather_from_model(x: torch.Tensor, dim: int = -1, *,
                      partial: bool = False) -> torch.Tensor:
    """The whole tensor of a ``model``-split ``x`` (every rank's block
    along ``dim``, in rank order). Without ``partial`` everything after
    the gather is computed alike on every ``model`` rank, so each holds
    the whole gradient and keeps its slice of it; with ``partial`` each
    rank goes on with its own columns only, so its gradient of the whole
    tensor is a share, reduce-scattered back to the blocks."""
    mesh = current_mesh()
    if tp_size(mesh) == 1:
        return x
    return _GatherFromModel.apply(x, mesh, dim % x.ndim, partial)


def model_slice(n: int) -> slice:
    """This rank's block of ``n`` items split whole over ``model`` (all
    of them without tensor parallelism)."""
    tp = tp_size()
    if n % tp:
        raise ValueError(f"model={tp} does not divide {n}")
    k = n // tp
    i = current_mesh().index("model") if tp > 1 else 0
    return slice(i * k, (i + 1) * k)


def gather_heads(q: torch.Tensor, mesh, dim: int = 2) -> torch.Tensor:
    """Every ``model`` rank's heads of ``q`` (split over ``model`` along
    ``dim``), in rank order: the first collective of sequence-parallel
    decode, which scores every head against this rank's share of the
    cache."""
    return mesh.all_gather(q, "model", dim)


def softmax_over_model(s: torch.Tensor, pv, mesh) -> torch.Tensor:
    """``softmax(s) @ values`` along the last axis of ``s`` (f32 scores,
    masked to ``NEG_INF``) when each ``model`` rank holds a block of that
    axis: ``pv(p)`` is the rank's partial product of ``p`` (its block's
    weights) with its block's values. The row maximum is reduced over
    ``model`` before any exponential (a rank whose block holds no valid
    key would otherwise weigh each masked key ``exp(0) = 1``), then the
    sums of exponentials and the f32 partial products in one all-reduce:
    the only traffic, all the size of the rows of ``s`` times the
    values' width."""
    mx = mesh.all_reduce(s.amax(-1), "model", "max")
    p = torch.exp(s - mx[..., None])
    l, acc = mesh.all_reduce_many([p.sum(-1), pv(p)], "model")
    return acc / l[..., None]


def check_same_over_model(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` (integers) is the same on every ``model`` rank:
    one all-reduce of ``(t, -t)`` under ``max``. On a mesh bound to a
    fake process group (the dry run) there is nothing to compare, and
    nothing is checked."""
    mesh = current_mesh()
    if tp_size(mesh) == 1 or mesh.fake:
        return
    both = torch.stack([t, -t])
    if not torch.equal(mesh.all_reduce(both, "model", "max"), both):
        raise RuntimeError(f"{what} differs between the ranks of a 'model' "
                           "line")


# ------------------------------------------------------------ FSDP

def _by_key(items) -> dict:
    groups: dict = {}
    for key, i in items:
        groups.setdefault(key, []).append(i)
    return groups


class _GatherParams(torch.autograd.Function):
    """Several parameters' compute tensors from their blocks, one
    collective per mesh line, dtype and stage (a parameter gathered over
    two axes takes two stages); the backward reduces the gradients back
    the same way."""

    @staticmethod
    def forward(ctx, mesh, plans, *blocks):
        ctx.mesh, ctx.plans = mesh, plans
        cur = list(blocks)
        for k in range(max(len(g) for g, _ in plans)):
            todo = [((plans[i][0][k][1], cur[i].dtype), i)
                    for i in range(len(cur)) if len(plans[i][0]) > k]
            for (axes, _), ids in _by_key(todo).items():
                parts = mesh.all_gather_many([cur[i] for i in ids], axes)
                for i, ps in zip(ids, parts):
                    cur[i] = torch.cat(ps, plans[i][0][k][0])
        ctx.shapes = [(tuple(c.shape), c.dtype, c.device) for c in cur]
        return tuple(c if c is not b else b.view_as(b)
                     for c, b in zip(cur, blocks))

    @staticmethod
    def backward(ctx, *grads):
        mesh, plans = ctx.mesh, ctx.plans
        g = [gr if gr is not None else torch.zeros(s, dtype=dt, device=dv)
             for gr, (s, dt, dv) in zip(grads, ctx.shapes)]
        for k in reversed(range(max(len(gs) for gs, _ in plans))):
            todo = []
            for i, (gs, _) in enumerate(plans):
                if len(gs) <= k:
                    continue
                dim, axes, summed = gs[k]
                if summed:
                    todo.append(((axes, g[i].dtype), i))
                else:   # every rank's gradient is whole: keep this block
                    n = g[i].shape[dim] // mesh.axis_size(axes)
                    g[i] = g[i].narrow(dim, mesh.index(axes) * n, n)
            for (axes, _), ids in _by_key(todo).items():
                n = mesh.axis_size(axes)
                parts = [list(g[i].chunk(n, plans[i][0][k][0])) for i in ids]
                for i, b in zip(ids, mesh.reduce_scatter_many(parts, axes)):
                    g[i] = b
        todo = [((axes, g[i].dtype), i) for i, (_, sums) in enumerate(plans)
                for axes in sums]
        for (axes, _), ids in _by_key(todo).items():
            for i, t in zip(ids, mesh.all_reduce_many([g[i] for i in ids],
                                                      axes)):
                g[i] = t
        return (None, None, *g)


# The compute layout of tensor-parallel parameters: (port name pattern,
# dimension kept split over 'model', gradient partial over 'model'); the
# first match wins. A partial gradient is summed over 'model': the
# parameter is used whole but each rank's loss reaches it only through its
# own heads, experts or columns (wk / wv, the q / k norms, MLA's latent
# projections, the router, xLSTM's gates and recurrent matrices). Where
# the stored split does not fall on the dimension a rank computes by (the
# packed mLSTM ``up``, sLSTM's ``wo`` stored row-split), the parameter is
# used whole and the rank takes its columns. Everything else is used
# whole with a whole gradient (norms and gates outside the parallel
# regions, biases added after a reduction).
_TP_COMPUTE = [
    (r"^embed$", 0, False),
    (r"^unembed\.w$", 1, False),
    # attention (dense, local, cross)
    (r"\.attn\.wq\.w$", 1, False),
    (r"\.attn\.wq\.b$", 0, False),
    (r"\.attn\.w[kv]\.[wb]$", None, True),
    (r"\.attn\.wo\.w$", 0, False),
    (r"\.attn\.[qk]_norm\.g$", None, True),
    # MLA: the latents and the query's down-projection serve every head
    (r"\.attn\.(w_dkv|w_kr|w_dq)\.w$", None, True),
    (r"\.attn\.kv_norm\.g$", None, True),
    (r"\.attn\.(w_uk|w_uv|w_uq|w_q)\.w$", 1, False),
    # MoE: each rank its experts; the shared experts as the dense MLP
    (r"\.moe\.experts\.(gate|up|down)\.w$", 0, False),
    (r"\.moe\.router\.w$", None, True),
    (r"\.(mlp|moe\.shared\.\d+)\.(gate|up)\.w$", 1, False),
    (r"\.(mlp|moe\.shared\.\d+)\.(gate|up)\.b$", 0, False),
    (r"\.(mlp|moe\.shared\.\d+)\.down\.w$", 0, False),
    # RG-LRU: each rank its share of the LRU width
    (r"\.rec\.(in_gate|in_rec|wa|wx)\.w$", 1, False),
    (r"\.rec\.conv_w$", 1, False),
    (r"\.rec\.(conv_b|lambda)$", 0, False),
    (r"\.rec\.out\.w$", 0, False),
    # mLSTM: each rank its heads
    (r"\.cell\.up\.w$", None, True),
    (r"\.cell\.conv_w$", 1, False),
    (r"\.cell\.conv_b$", 0, False),
    (r"\.cell\.w[qkv]\.w$", 1, False),
    (r"\.cell\.(wgate\.w|head_norm\.g)$", None, True),
    (r"\.cell\.down\.w$", 0, False),
    # sLSTM: each rank its heads; the FFN as the dense MLP
    (r"\.cell\.wo\.w$", None, True),
    (r"\.cell\.w[zif]\.w$", 1, False),
    (r"\.cell\.r[zifo]$", None, True),
    (r"\.cell\.ffn_(gate|up)\.w$", 1, False),
    (r"\.cell\.ffn_down\.w$", 0, False),
]


def compute_layout(name: str) -> tuple[int | None, bool]:
    """(dimension kept split over ``model``, gradient partial over
    ``model``) of the port's parameter ``name`` under tensor
    parallelism."""
    for pat, dim, partial in _TP_COMPUTE:
        if re.search(pat, name):
            return dim, partial
    return None, False


def gather_plan(name: str, sharding) -> tuple[tuple, tuple]:
    """How ``gather_params`` rebuilds parameter ``name`` stored under
    ``sharding``: ``gathers`` ``(dim, axes, summed)`` (all-gathered in
    the forward, reduce-scattered in the backward when ``summed``) and
    ``sums`` (mesh axes its gradient is all-reduced over). The batch
    axes always sum (each rank has its own rows); ``model`` sums for a
    partial gradient."""
    mesh = sharding.mesh
    tp = tp_size(mesh)
    split, partial = compute_layout(name) if tp > 1 else (None, False)
    gathers, named = [], set()
    for d, a in enumerate(sharding.spec):
        if a is None:
            continue
        axes = (a,) if isinstance(a, str) else tuple(a)
        named.update(axes)
        if axes == ("model",) and split == d:
            continue
        if "model" in axes and len(axes) > 1:
            raise ValueError(f"{name}: dimension {d} mixes 'model' with "
                             f"{axes}")
        gathers.append((d, axes, axes != ("model",) or partial))
    if split is not None and "model" not in (sharding.spec[split:split + 1]
                                             or (None,)):
        raise ValueError(f"{name}: tensor parallelism needs dimension "
                         f"{split} split over 'model', its spec is "
                         f"{sharding.spec!r}")
    sums = []
    dp = tuple(a for a in mesh.dp_axes if a not in named)
    if dp and mesh.axis_size(dp) > 1:
        sums.append(dp)
    if partial and "model" not in named:
        sums.append(("model",))
    return tuple(gathers), tuple(sums)


def gather_params(blocks: list[torch.Tensor], plans: list,
                  mesh) -> list[torch.Tensor]:
    """The compute tensors of parameters from this rank's stored
    ``blocks`` (each plan from ``gather_plan``), differentiable, the
    gradients reduced back to the blocks; the parameters of one layer go
    together, in as few collectives as their layouts allow."""
    live = [i for i, (g, s) in enumerate(plans) if g or s]
    out = list(blocks)
    if live:
        got = _GatherParams.apply(mesh, tuple(plans[i] for i in live),
                                  *(blocks[i] for i in live))
        for i, t in zip(live, got):
            out[i] = t
    return out


def check_tensor_parallel(cfg, mesh) -> None:
    """Raise unless ``model`` (of ``mesh``; a mesh without it, or of size
    1, passes every config) divides each dimension of ``cfg`` that tensor
    parallelism splits whole per rank, naming the first that it does
    not divide."""
    tp = tp_size(mesh)
    if tp == 1:
        return
    kinds = set(cfg.layer_plan())
    dims = []
    if kinds & {"attn", "attn_moe", "local", "cross"}:
        dims.append(("n_heads (MLA heads)" if cfg.mla is not None
                     else "n_heads (query heads)", cfg.n_heads))
    dense_mlp = {"local", "cross", "rglru"} | ({"attn"} if cfg.moe is None
                                               else set())
    if cfg.mlp != "none" and kinds & dense_mlp:
        dims.append(("d_ff", cfg.d_ff))
    if cfg.moe is not None:
        if "attn" in kinds:
            dims.append(("d_ff_dense", cfg.moe.d_ff_dense))
        dims += [("n_routed (experts)", cfg.moe.n_routed),
                 ("d_expert (shared experts)", cfg.moe.d_expert)]
    if "rglru" in kinds:
        dims.append(("lru_width", cfg.lru_width or cfg.d_model))
    if "mlstm" in kinds:
        dims.append(("mlstm_heads", cfg.mlstm_heads))
    if "slstm" in kinds:
        dims.append(("slstm_heads", cfg.slstm_heads))
    dims.append(("vocab", cfg.vocab))
    for what, n in dims:
        if n % tp:
            raise ValueError(f"{cfg.name}: model={tp} does not divide "
                             f"{what} = {n}; tensor parallelism splits it "
                             "whole per rank")
