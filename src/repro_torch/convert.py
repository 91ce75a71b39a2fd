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
