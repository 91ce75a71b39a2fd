"""Carry parameters across from (and back to) the JAX package's layout.

The reference keeps GNN parameters as a tree of arrays and computes
``x @ w + b`` with each linear as ``{"w": (d_in, d_out), "b": (d_out,)}``
and each batchnorm as ``{"g": (d,), "b": (d,)}`` or ``None``:

* GCN: ``{"lin": [linear, ...], "bn": [bn | None, ...]}``;
* GraphSAGE: ``{"self": [linear, ...], "neigh": [linear, ...],
  "bn": [bn | None, ...]}``;
* GCNII: ``{"proj_in": linear, "w": [linear, ...], "bn": [bn | None, ...],
  "proj_out": linear}``.

GCN and GraphSAGE carry one ``bn`` entry per layer, ``None`` on the last;
GCNII one per layer, the last included. ``nn.Linear.weight`` is
``(d_out, d_in)``, so ``w`` is transposed exactly once here. The tree holds
numpy arrays (``jax.device_get`` of the reference's params gives them);
this module imports no JAX.

The same mappings give the training state in the reference's checkpoint
layout (``gnn_state_tree`` / ``lm_state_tree``: ``(params, {"count", "m",
"v"})``, Adam's moments keyed like the parameters), so each package
restores the other's checkpoints.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.gnn import MODELS
from repro_torch.models.gnn.gcn import GCN
from repro_torch.models.gnn.gcnii import GCNII
from repro_torch.models.gnn.graphsage import GraphSAGE


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _arr(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _d_in_out(p) -> tuple[int, int]:
    d_in, d_out = np.shape(p["w"])
    return int(d_in), int(d_out)


def _bn_flags(bns: list, n_layers: int, last: bool) -> bool:
    """Whether the layers carry batchnorm: one entry per layer, ``None`` on
    the last unless ``last``, and on every other layer or on none."""
    if len(bns) != n_layers or (not last and bns[-1] is not None):
        raise ValueError("expected one bn entry per layer" +
                         ("" if last else ", None on the last"))
    with_bn = [b is not None for b in (bns if last else bns[:-1])]
    if any(with_bn) and not all(with_bn):
        raise ValueError("batchnorm must be on every hidden layer or none")
    return bool(with_bn) and all(with_bn)


def _set_linear(lin: torch.nn.Linear, p) -> None:
    w = _tensor(p["w"])
    if tuple(w.shape) != (lin.in_features, lin.out_features):
        raise ValueError(f"w of shape {tuple(w.shape)} does not chain with "
                         f"the other layers")
    lin.weight.copy_(w.t())
    lin.bias.copy_(_tensor(p["b"]))


def _set_bns(net, bns: list) -> None:
    for l, p in enumerate(bns):
        if p is not None:
            bn = net.batchnorm(l)
            bn.weight.copy_(_tensor(p["g"]))
            bn.bias.copy_(_tensor(p["b"]))


def _get_linear(lin: torch.nn.Linear) -> dict:
    return {"w": _arr(lin.weight).T.copy(), "b": _arr(lin.bias)}


def _get_bns(net, n: int) -> list:
    bns = [net.batchnorm(l) for l in range(n)]
    return [None if bn is None else {"g": _arr(bn.weight),
                                     "b": _arr(bn.bias)} for bn in bns]


def gnn_params_from_numpy(model: str, tree: dict, device="cuda"):
    """The port's ``nn.Module`` for ``model`` (``gcn``, ``graphsage`` or
    ``gcnii``) holding the tree's values, on ``device`` (``cuda`` by
    default, which raises without a card)."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r} (expected one of "
                         f"{sorted(MODELS)})")
    device = resolve_device(device)
    if model == "gcnii":
        ws = tree["w"]
        (d_in, hidden), (_, n_classes) = (_d_in_out(tree["proj_in"]),
                                          _d_in_out(tree["proj_out"]))
        net = GCNII(d_in, hidden, n_classes, len(ws),
                    _bn_flags(tree["bn"], len(ws), last=True), device=device)
        pairs = [(net.proj_in, tree["proj_in"]), *zip(net.w, ws),
                 (net.proj_out, tree["proj_out"])]
    else:
        lins = tree["lin" if model == "gcn" else "self"]
        dims = [_d_in_out(lins[0])[0]] + [_d_in_out(p)[1] for p in lins]
        batchnorm = _bn_flags(tree["bn"], len(lins), last=False)
        if model == "gcn":
            net = GCN(dims, batchnorm, device=device)
            pairs = list(zip(net.lin, lins))
        else:
            if len(tree["neigh"]) != len(lins):
                raise ValueError("expected as many neigh as self layers")
            net = GraphSAGE(dims, batchnorm, device=device)
            pairs = [*zip(net.self_lin, lins),
                     *zip(net.neigh_lin, tree["neigh"])]
    with torch.no_grad():
        for lin, p in pairs:
            _set_linear(lin, p)
        _set_bns(net, tree["bn"])
    return net


def gnn_params_to_numpy(model) -> dict:
    """The inverse of ``gnn_params_from_numpy``: the reference's tree
    (f32 numpy leaves; ``w`` as ``(d_in, d_out)``, ``None`` for a layer
    without batchnorm) from the port's GCN, GraphSAGE or GCNII, so trained
    parameters can be compared leaf by leaf with the reference's."""
    if isinstance(model, GCNII):
        return {"proj_in": _get_linear(model.proj_in),
                "w": [_get_linear(lin) for lin in model.w],
                "bn": _get_bns(model, len(model.w)),
                "proj_out": _get_linear(model.proj_out)}
    if isinstance(model, GraphSAGE):
        return {"self": [_get_linear(lin) for lin in model.self_lin],
                "neigh": [_get_linear(lin) for lin in model.neigh_lin],
                "bn": _get_bns(model, len(model.self_lin))}
    if isinstance(model, GCN):
        return {"lin": [_get_linear(lin) for lin in model.lin],
                "bn": _get_bns(model, len(model.lin))}
    raise TypeError(f"not a GNN of the port: {type(model).__name__}")


def _unstack(tree: dict, cfg) -> list[dict]:
    """The reference's per-layer trees in ``cfg.layer_plan()`` order: the
    prefix, then for each repeat the pattern's layers sliced out of the
    stacked ``blocks``, then the suffix."""
    def take(x, r):
        if isinstance(x, dict):
            return {k: take(v, r) for k, v in x.items()}
        return np.asarray(x)[r]

    blocks = tree.get("blocks") or ()
    layers = list(tree.get("prefix", []))
    for r in range(cfg.repeats):
        layers += [take(blocks[i], r) for i in range(len(cfg.pattern))]
    return layers + list(tree.get("suffix", []))


def _copy_tree(module: torch.nn.Module, tree: dict, path: str) -> int:
    """Copy every leaf of ``tree`` into the same-named parameter or
    submodule of ``module``; returns the number of parameters filled."""
    n = 0
    for key, val in tree.items():
        target = getattr(module, key, None)
        where = f"{path}.{key}" if path else key
        if isinstance(val, dict):
            if not isinstance(target, torch.nn.Module):
                raise ValueError(f"{where}: no such submodule in the port")
            n += _copy_tree(target, val, where)
            continue
        if not isinstance(target, torch.nn.Parameter):
            raise ValueError(f"{where}: no such parameter in the port")
        x = _tensor(val)
        if tuple(x.shape) != tuple(target.shape):
            raise ValueError(f"{where}: shape {tuple(x.shape)}, the port "
                             f"has {tuple(target.shape)}")
        target.copy_(x)
        n += 1
    return n


def lm_params_from_numpy(cfg, tree: dict, device="cuda"):
    """The port's ``LM`` module holding the reference's LM parameters.

    ``tree`` is ``repro.models.lm.backbone.init_params``'s output as numpy
    (bf16 leaves as ``ml_dtypes`` bf16 or as f32). The stacked ``blocks``
    are unstacked into one module per layer; ``x @ w`` orientation is kept
    (the port's ``Linear.w`` is ``(d_in, d_out)`` too), and each leaf takes
    the dtype of the port's parameter (the config's dtype, f32 for norms).
    Raises ``ValueError`` if a leaf has no counterpart or a parameter is
    left unfilled.
    """
    from repro_torch.models.lm.backbone import LM
    with torch.no_grad():
        net = LM(cfg, resolve_device(device))
        top = {k: v for k, v in tree.items()
               if k not in ("prefix", "blocks", "suffix")}
        n = _copy_tree(net, top, "")
        layers = _unstack(tree, cfg)
        if len(layers) != len(net.layers):
            raise ValueError(f"the tree has {len(layers)} layers, the "
                             f"config {len(net.layers)}")
        for i, (blk, sub) in enumerate(zip(net.layers, layers)):
            n += _copy_tree(blk, sub, f"layers.{i}")
    total = sum(1 for _ in net.parameters())
    if n != total:
        raise ValueError(f"filled {n} of the port's {total} parameters")
    return net


def _module_tree(module: torch.nn.Module) -> dict:
    """``{name: f32 numpy array or subtree}`` of a module's own parameters
    and submodules (absent ones, such as a missing bias, are left out)."""
    tree = {k: p.detach().float().cpu().numpy()
            for k, p in module.named_parameters(recurse=False)}
    tree.update({k: _module_tree(m) for k, m in module.named_children()})
    return tree


def lm_params_to_numpy(net, cfg) -> dict:
    """The inverse of ``lm_params_from_numpy``: the reference's parameter
    tree (f32 numpy leaves) from the port's ``LM``, with the pattern's
    layers re-stacked over the repeats into ``blocks``, so trained
    parameters can be compared leaf by leaf with the reference's tree."""
    layers = [_module_tree(blk) for blk in net.layers]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"the module has {len(layers)} layers, the config "
                         f"{cfg.n_layers}")
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    tree = {k: v for k, v in _module_tree(net).items() if k != "layers"}
    tree["prefix"] = layers[:n_pre]
    tree["blocks"] = tuple(
        stack([layers[n_pre + r * n_pat + i] for r in range(cfg.repeats)])
        for i in range(n_pat)) if cfg.repeats else ()
    tree["suffix"] = layers[n_pre + cfg.repeats * n_pat:]
    return tree


# ------------------------------------------------------------ training state
def _gnn_pairs(model) -> list[tuple[tuple, torch.nn.Parameter, bool]]:
    """(reference tree path, parameter, stored transposed) of every
    parameter of a GCN, GraphSAGE or GCNII."""
    def linear(path, lin):
        return [(path + ("w",), lin.weight, True),
                (path + ("b",), lin.bias, False)]

    if isinstance(model, GCNII):
        lins = [(("proj_in",), model.proj_in),
                *((("w", i), l) for i, l in enumerate(model.w)),
                (("proj_out",), model.proj_out)]
        n = len(model.w)
    elif isinstance(model, GraphSAGE):
        lins = [*((("self", i), l) for i, l in enumerate(model.self_lin)),
                *((("neigh", i), l) for i, l in enumerate(model.neigh_lin))]
        n = len(model.self_lin)
    elif isinstance(model, GCN):
        lins = [(("lin", i), l) for i, l in enumerate(model.lin)]
        n = len(model.lin)
    else:
        raise TypeError(f"not a GNN of the port: {type(model).__name__}")
    out = [p for path, lin in lins for p in linear(path, lin)]
    for l in range(n):
        bn = model.batchnorm(l)
        if bn is not None:
            out += [(("bn", l, "g"), bn.weight, False),
                    (("bn", l, "b"), bn.bias, False)]
    return out


def gnn_param_paths(model) -> dict[str, tuple[tuple, bool]]:
    """``{parameter name: (reference tree path, stored transposed)}``."""
    names = {id(p): n for n, p in model.named_parameters()}
    paths = {names[id(p)]: (path, tr) for path, p, tr in _gnn_pairs(model)}
    if len(paths) != len(names):
        raise ValueError(f"{len(names) - len(paths)} parameters of "
                         f"{type(model).__name__} have no reference path")
    return paths


def _nest(flat: dict[tuple, object]):
    """A tree of dicts (str keys) and lists (int keys; gaps ``None``)."""
    def build(items):
        heads = {}
        for path, v in items:
            heads.setdefault(path[0], []).append((path[1:], v))
        kids = {k: (vs[0][1] if vs[0][0] == () else build(vs))
                for k, vs in heads.items()}
        if all(isinstance(k, int) for k in kids):
            return [kids.get(i) for i in range(max(kids) + 1)]
        return kids
    return build(list(flat.items()))


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def gnn_state_tree(model, opt_state: dict) -> tuple:
    """``(params, opt_state)`` in the reference's tree layout: the leaves
    are the port's tensors (``w`` as a transposed view), the step count an
    int32 scalar, as ``repro``'s ``Adam.init`` keeps it."""
    paths = gnn_param_paths(model)

    def tree(named):
        return _nest({paths[n][0]: (t.t() if paths[n][1] else t)
                      for n, t in named.items()})
    return (tree(dict(model.named_parameters())),
            {"count": np.int32(opt_state["count"]),
             "m": tree(opt_state["m"]), "v": tree(opt_state["v"])})


@torch.no_grad()
def load_gnn_state(model, opt_state: dict, tree: tuple) -> dict:
    """Copy a ``gnn_state_tree``-shaped tree into ``model``'s parameters;
    returns the optimizer state it holds (moments as tensors like the
    parameters')."""
    params, opt = tree
    named = dict(model.named_parameters())
    out = {"m": {}, "v": {}, "count": int(opt["count"])}
    for name, (path, tr) in gnn_param_paths(model).items():
        named[name].copy_(_unview(_get(params, path), tr))
        for k in ("m", "v"):
            out[k][name] = _unview(_get(opt[k], path), tr).to(
                device=opt_state[k][name].device,
                dtype=opt_state[k][name].dtype).contiguous()
    return out


def _unview(x: torch.Tensor, transposed: bool) -> torch.Tensor:
    return x.t() if transposed else x


def _named_tree(named: dict) -> dict:
    """Dotted parameter names as a tree of dicts."""
    tree: dict = {}
    for name, v in named.items():
        *head, last = name.split(".")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _dotted(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_dotted(v, name + "."))
        else:
            out[name] = v
    return out


def lm_tree(named: dict[str, torch.Tensor], cfg) -> dict:
    """``{parameter name: tensor}`` of the port's ``LM`` (parameters or
    anything keyed like them, such as Adam's moments) as the reference's
    tree: the pattern's layers stacked over the repeats into ``blocks``.
    Leaves are CPU tensors (the stacks are made on the host)."""
    tree = _named_tree({n: t.detach().cpu() for n, t in named.items()})
    layers = tree.pop("layers", {})
    layers = [layers.get(str(i), {}) for i in range(cfg.n_layers)]
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    tree["prefix"] = layers[:n_pre]
    tree["blocks"] = tuple(
        stack([layers[n_pre + r * n_pat + i] for r in range(cfg.repeats)])
        for i in range(n_pat)) if cfg.repeats else ()
    tree["suffix"] = layers[n_pre + cfg.repeats * n_pat:]
    return tree


def lm_named(tree: dict, cfg) -> dict[str, torch.Tensor]:
    """The inverse of ``lm_tree``: ``{parameter name: tensor}``."""
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    top = {k: v for k, v in tree.items()
           if k not in ("prefix", "blocks", "suffix")}
    out = _dotted(top)
    for i, sub in enumerate(tree.get("prefix", [])):
        out.update(_dotted(sub, f"layers.{i}."))
    for i, blk in enumerate(tree.get("blocks") or ()):
        for name, x in _dotted(blk).items():
            for r in range(cfg.repeats):
                out[f"layers.{n_pre + r * n_pat + i}.{name}"] = x[r]
    first = n_pre + cfg.repeats * n_pat
    for i, sub in enumerate(tree.get("suffix", [])):
        out.update(_dotted(sub, f"layers.{first + i}."))
    return out


def lm_state_tree(net, opt_state: dict, cfg) -> tuple:
    """``(params, opt_state)`` of the port's LM in the reference's tree
    layout (CPU tensors; the step count an int32 scalar)."""
    return (lm_tree(dict(net.named_parameters()), cfg),
            {"count": np.int32(opt_state["count"]),
             "m": lm_tree(opt_state["m"], cfg),
             "v": lm_tree(opt_state["v"], cfg)})


@torch.no_grad()
def load_lm_state(net, opt_state: dict, tree: tuple, cfg) -> dict:
    """Copy an ``lm_state_tree``-shaped tree into ``net``'s parameters;
    returns the optimizer state it holds."""
    params, opt = tree
    named = dict(net.named_parameters())
    got = lm_named(params, cfg)
    if set(got) != set(named):
        raise ValueError(f"checkpoint parameters differ from the model's: "
                         f"{sorted(set(got) ^ set(named))[:4]}")
    for n, p in named.items():
        p.copy_(got[n])
    out = {"count": int(opt["count"])}
    for k in ("m", "v"):
        out[k] = {n: x.to(device=opt_state[k][n].device,
                          dtype=opt_state[k][n].dtype).contiguous()
                  for n, x in lm_named(opt[k], cfg).items()}
    return out
