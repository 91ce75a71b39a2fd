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
  over ``model`` backward, and the reverse).

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


# The compute layout of tensor-parallel parameters (the dense family):
# (port name pattern, dimension kept split over 'model', gradient partial
# over 'model'). A partial gradient is summed over 'model'; wk / wv and
# the q / k norms serve every rank's own heads, so each rank holds a share
# of their gradient. Everything else is used whole with a whole gradient.
_TP_COMPUTE = [
    (r"^embed$", 0, False),
    (r"^unembed\.w$", 1, False),
    (r"\.attn\.wq\.w$", 1, False),
    (r"\.attn\.wq\.b$", 0, False),
    (r"\.attn\.w[kv]\.[wb]$", None, True),
    (r"\.attn\.wo\.w$", 0, False),
    (r"\.attn\.[qk]_norm\.g$", None, True),
    (r"\.mlp\.(gate|up)\.w$", 1, False),
    (r"\.mlp\.(gate|up)\.b$", 0, False),
    (r"\.mlp\.down\.w$", 0, False),
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


# Layer kinds whose blocks are tensor parallel, and the module that holds
# each kind that is not.
_TP_KINDS = {"attn"}
_NOT_TP = {
    "attn_moe": "models/lm/moe.py (MoE experts)",
    "local": "models/lm/attention.py (sliding-window self_attention)",
    "cross": "models/lm/attention.py (cross_attention)",
    "rglru": "models/lm/rglru.py (RG-LRU)",
    "mlstm": "models/lm/xlstm.py (mLSTM)",
    "slstm": "models/lm/xlstm.py (sLSTM)",
}


def check_tensor_parallel(cfg, mesh) -> None:
    """Raise unless ``cfg`` can run tensor parallel on ``mesh``'s
    ``model`` axis: every layer a dense attention + gated MLP block
    (naming the first module that is not), and ``model`` dividing the
    query heads, ``d_ff`` and the vocabulary (naming the dimension). A
    mesh without ``model`` (or of size 1) passes every config."""
    tp = tp_size(mesh)
    if tp == 1:
        return
    if cfg.mla is not None:
        raise ValueError(f"{cfg.name}: tensor parallelism over 'model' "
                         f"({tp}) is not implemented for models/lm/mla.py "
                         "(MLA attention)")
    for i, kind in enumerate(cfg.layer_plan()):
        if kind not in _TP_KINDS:
            raise ValueError(f"{cfg.name}: tensor parallelism over 'model' "
                             f"({tp}) is not implemented for "
                             f"{_NOT_TP.get(kind, kind)}, layer {i}")
    if cfg.embeds_input:
        raise ValueError(f"{cfg.name}: tensor parallelism over 'model' "
                         f"({tp}) is not implemented for the embedding "
                         "inputs of models/lm/backbone.py")
    if cfg.mlp not in ("swiglu", "geglu"):
        raise ValueError(f"{cfg.name}: tensor parallelism over 'model' "
                         f"({tp}) is not implemented for the {cfg.mlp} MLP "
                         "of models/lm/layers.py")
    for what, n in (("n_heads (query heads)", cfg.n_heads),
                    ("d_ff", cfg.d_ff), ("vocab", cfg.vocab)):
        if n % tp:
            raise ValueError(f"{cfg.name}: model={tp} does not divide "
                             f"{what} = {n}; tensor parallelism splits it "
                             "whole per rank")
