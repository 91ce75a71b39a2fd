"""Parameter / optimizer / batch / cache sharding rules.

The port of ``repro.launch.shardings``, with the reference's rules copied
verbatim. Parameters: FSDP over ``data`` (their d_model or d_ff dimension)
× tensor parallelism over ``model`` (heads, ffn, vocab, experts);
replicated over ``pod`` (pure data parallelism across pods), except that
the FSDP dimension spans ``("pod", "data")`` on a mesh that has both.
Stacked (scanned) parameters get a leading None. Caches (decode): batch
over the batch axes, sequence over ``model``.

A spec is a :class:`P`, a tuple with one entry per leading dimension: an
axis name, a tuple of names, or None (a one-name tuple reads as the name,
as ``jax.sharding.PartitionSpec`` normalises it). A :class:`Sharding`
pairs a spec with a ``launch.mesh.Mesh``; with a bound mesh it slices a
whole array into this rank's block (``local``). Trees are nested dicts,
lists and tuples whose leaves have a ``shape`` (``meta`` tensors for an
abstract tree); a leaf's path is its keys joined by ``/``, as the
reference's ``_path_str`` joins them.
"""
from __future__ import annotations

import dataclasses
import re

from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm.config import LMConfig


class P(tuple):
    """A partition spec: ``P("data", None)`` shards dimension 0 over
    ``data`` and leaves dimension 1 whole; trailing dimensions past the
    spec are whole."""

    def __new__(cls, *axes):
        norm = []
        for a in axes:
            if isinstance(a, (tuple, list)):
                a = tuple(a)
                a = a[0] if len(a) == 1 else (a or None)
            norm.append(a)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec laid over a mesh."""

    mesh: Mesh
    spec: P

    def axes(self, ndim: int) -> list:
        """The spec padded with None to ``ndim`` entries."""
        return list(self.spec) + [None] * (ndim - len(self.spec))

    def local_shape(self, shape) -> tuple[int, ...]:
        """The shape of one rank's block of an array of ``shape``."""
        out = []
        for n, a in zip(shape, self.axes(len(shape))):
            k = self.mesh.axis_size(a)
            if n % k:
                raise ValueError(f"dimension {n} does not split over {a} "
                                 f"({k})")
            out.append(n // k)
        return tuple(out)

    def local(self, x):
        """This rank's block of the whole array ``x`` (numpy or torch;
        needs a bound mesh), a view where ``x`` allows one."""
        for d, a in enumerate(self.axes(len(x.shape))):
            if a is None:
                continue
            k = self.mesh.axis_size(a)
            n = x.shape[d] // k
            i = self.mesh.index(a)
            x = x[(slice(None),) * d + (slice(i * n, (i + 1) * n),)]
        return x

    @property
    def lead(self) -> bool:
        """Whether this rank holds the copy of its block that counts once
        in a sum over every rank: coordinate 0 on each axis the spec does
        not name (the block is replicated along those)."""
        named = {n for a in self.spec if a is not None
                 for n in ((a,) if isinstance(a, str) else a)}
        c = self.mesh.coords
        return all(c[a] == 0 for a in self.mesh.axis_names if a not in named)


# (path regex, spec for the TRAILING dims). First match wins. All name
# alternatives are anchored to path-segment boundaries via (?:^|/).
_B = r"(?:^|/)"
_PARAM_RULES: list[tuple[str, tuple]] = [
    (_B + r"embed$",                    ("model", "data")),
    (_B + r"unembed/w$",                ("data", "model")),
    (_B + r"(wq|wk|wv)/w$",             ("data", "model")),
    (_B + r"(wq|wk|wv)/b$",             ("model",)),
    (_B + r"wo/w$",                     ("model", "data")),
    (_B + r"wo/b$",                     (None,)),
    # MoE: experts stacked on leading E dim (EP over 'model') — must match
    # before the generic MLP rules below.
    (_B + r"experts/(gate|up)/w$",      ("model", "data", None)),
    (_B + r"experts/down/w$",           ("model", None, "data")),
    (_B + r"experts/.*/b$",             ("model", None)),
    (_B + r"router/w$",                 ("data", None)),
    (_B + r"router/b$",                 (None,)),
    (_B + r"(gate|up|ffn_gate|ffn_up)/w$",   ("data", "model")),
    (_B + r"(down|ffn_down)/w$",        ("model", "data")),
    (_B + r"(gate|up|ffn_gate|ffn_up)/b$",   ("model",)),
    (_B + r"(down|ffn_down)/b$",        (None,)),
    # MLA
    (_B + r"w_dkv/w$",                  ("data", None)),
    (_B + r"w_kr/w$",                   ("data", None)),
    (_B + r"w_dq/w$",                   ("data", None)),
    (_B + r"(w_uk|w_uv|w_uq|w_q)/w$",   (None, "model")),
    # RG-LRU / conv
    (_B + r"(in_gate|in_rec|wa|wx)/w$", ("data", "model")),
    (_B + r"(in_gate|in_rec|wa|wx)/b$", ("model",)),
    (_B + r"out/w$",                    ("model", "data")),
    (_B + r"out/b$",                    (None,)),
    (_B + r"conv_w$",                   (None, "model")),
    (_B + r"conv_b$",                   ("model",)),
    (_B + r"lambda$",                   ("model",)),
    # xLSTM
    (_B + r"wgate/w$",                  ("data", None)),
    (_B + r"wgate/b$",                  (None,)),
    (_B + r"r[zifo]$",                  (None, None, None)),
    (_B + r"w[zifo]/w$",                ("data", "model")),
    (_B + r"w[zifo]/b$",                ("model",)),
    # norms, gates, everything small: replicate
    (r".*",                             None),
]


def _mesh_axes(mesh: Mesh, name):
    if name is None:
        return None
    if name == "data":
        # the FSDP dimension spans pod + data on a multi-pod mesh
        if "pod" in mesh.axis_names and "data" in mesh.axis_names:
            return ("pod", "data")
        return "data" if "data" in mesh.axis_names else None
    return name if name in mesh.axis_names else None


def param_spec(path: str, shape: tuple, mesh: Mesh) -> P:
    """The spec of the parameter at ``path`` (the reference's tree path,
    ``/``-joined) of ``shape``: the first matching rule's axes on the
    trailing dimensions, each dropped where the mesh cannot split that
    dimension evenly."""
    ndim = len(shape)
    for pat, trailing in _PARAM_RULES:
        if re.search(pat, path):
            if trailing is None:
                return P()
            axes = [_mesh_axes(mesh, a) for a in trailing]
            if ndim < len(axes):
                return P()
            spec = [None] * (ndim - len(axes)) + axes
            # divisibility safety net: drop axes the dim can't host
            for i, a in enumerate(spec):
                if a is not None and shape[i] % mesh.axis_size(a) != 0:
                    spec[i] = None
            return P(*spec)
    return P()


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; ``None``
    stays ``None``."""
    def join(k):
        return f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def tree_leaves_with_path(tree, path: str = "") -> list[tuple[str, object]]:
    """``(path, leaf)`` of every leaf, in tree order."""
    out: list = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree, path)
    return out


def param_shardings(params_abstract, mesh: Mesh):
    """A :class:`Sharding` for every leaf of a parameter tree in the
    reference's layout (``convert.lm_tree`` of the port's parameters)."""
    return tree_map_with_path(
        lambda p, leaf: Sharding(mesh, param_spec(p, tuple(leaf.shape),
                                                  mesh)), params_abstract)


def opt_shardings(opt_state_abstract, params_shardings, mesh: Mesh) -> dict:
    """Adam's m and v mirror the parameters; the count is replicated."""
    return {"m": params_shardings, "v": params_shardings,
            "count": Sharding(mesh, P())}


def _sanitize(sh: Sharding, shape) -> Sharding:
    spec = sh.axes(len(shape))
    for i, a in enumerate(spec):
        if a is not None and shape[i] % sh.mesh.axis_size(a) != 0:
            spec[i] = None
    return Sharding(sh.mesh, P(*spec))


def sanitize_shardings(sh_tree, abstract_tree):
    """Drop sharding axes whose mesh size does not divide the dim."""
    if isinstance(sh_tree, Sharding):
        return _sanitize(sh_tree, tuple(getattr(abstract_tree, "shape", ())))
    if isinstance(sh_tree, dict):
        return {k: sanitize_shardings(v, abstract_tree[k])
                for k, v in sh_tree.items()}
    if isinstance(sh_tree, (list, tuple)):
        return type(sh_tree)(sanitize_shardings(v, a)
                             for v, a in zip(sh_tree, abstract_tree))
    return sh_tree


def batch_shardings(batch_abstract: dict, mesh: Mesh, dp) -> dict:
    """Every batch entry split over ``dp`` (``launch.mesh.dp_axes``) on its
    first dimension."""
    return {k: Sharding(mesh, P(dp, *([None] * (len(v.shape) - 1))))
            for k, v in batch_abstract.items()}


# ------------------------------- caches -------------------------------------

def _layer_cache_spec(cfg: LMConfig, kind: str, dp, mesh: Mesh) -> dict:
    tp = _mesh_axes(mesh, "model")
    if kind in ("attn", "attn_moe"):
        if cfg.mla is not None:
            return {"ckv": P(dp, tp, None), "krope": P(dp, tp, None)}
        return {"k": P(dp, tp, None, None), "v": P(dp, tp, None, None)}
    if kind == "local":
        return {"k": P(dp, tp, None, None), "v": P(dp, tp, None, None),
                "pos": P(None)}
    if kind == "cross":
        return {"k": P(dp, tp, None, None), "v": P(dp, tp, None, None)}
    if kind == "rglru":
        return {"h": P(dp, tp), "conv": P(dp, None, tp)}
    if kind == "mlstm":
        return {"C": P(dp, None, None, None), "n": P(dp, None, None),
                "m": P(dp, None), "conv": P(dp, None, tp)}
    if kind == "slstm":
        return {"c": P(dp, None, None), "n": P(dp, None, None),
                "h": P(dp, None, None), "m": P(dp, None, None)}
    raise ValueError(kind)


def cache_shardings(cfg: LMConfig, mesh: Mesh, dp) -> dict:
    """The decode caches' shardings in the reference's cache layout
    (``prefix`` and ``suffix`` lists, ``blocks`` stacked over the
    repeats with a leading None, ``len``); ``convert.lm_cache_shardings``
    lays them over the port's per-layer caches for sharded serving."""
    def layer(kind, stacked=False):
        specs = _layer_cache_spec(cfg, kind, dp, mesh)
        return {k: Sharding(mesh, P(None, *s) if stacked else s)
                for k, s in specs.items()}

    return {
        "prefix": [layer(k) for k in cfg.prefix],
        "blocks": tuple(layer(k, stacked=True) for k in cfg.pattern)
        if cfg.repeats else (),
        "suffix": [layer(k) for k in cfg.suffix],
        "len": Sharding(mesh, P()),
    }
