"""Carry parameters across from (and back to) the JAX package's layout.

The reference keeps GNN parameters as a tree of arrays,
``{"lin": [{"w": (d_in, d_out), "b": (d_out,)}, ...],
"bn": [{"g": (d,), "b": (d,)} | None, ...]}``, and computes ``x @ w + b``.
``nn.Linear.weight`` is ``(d_out, d_in)``, so ``w`` is transposed exactly
once here. The tree holds numpy arrays (``jax.device_get`` of the
reference's params gives them); this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.gnn import MODELS


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def gnn_params_from_numpy(model: str, tree: dict, device="cuda"):
    """The port's ``nn.Module`` for ``model`` holding the tree's values,
    on ``device`` (``cuda`` by default, which raises without a card)."""
    if model != "gcn":
        raise NotImplementedError(f"{model!r} is not ported yet "
                                  "(ROADMAP.md Queue 1 item 2b)")
    lins, bns = tree["lin"], tree["bn"]
    if len(bns) != len(lins) or bns[-1] is not None:
        raise ValueError("expected one bn entry per layer, None on the last")
    with_bn = [b is not None for b in bns[:-1]]
    if any(with_bn) and not all(with_bn):
        raise ValueError("batchnorm must be on every hidden layer or none")
    dims = [int(np.shape(lins[0]["w"])[0])] + [int(np.shape(p["w"])[1])
                                               for p in lins]
    net = MODELS[model].GCN(dims, all(with_bn) and len(bns) > 1,
                            device=resolve_device(device))
    with torch.no_grad():
        for lin, p in zip(net.lin, lins):
            w = _tensor(p["w"])
            if tuple(w.shape) != (lin.in_features, lin.out_features):
                raise ValueError(f"w of shape {tuple(w.shape)} does not "
                                 f"chain with the other layers")
            lin.weight.copy_(w.t())
            lin.bias.copy_(_tensor(p["b"]))
        for l, p in enumerate(bns[:-1]):
            if p is not None:
                bn = net.batchnorm(l)
                bn.weight.copy_(_tensor(p["g"]))
                bn.bias.copy_(_tensor(p["b"]))
    return net


def gnn_params_to_numpy(model) -> dict:
    """The inverse of ``gnn_params_from_numpy``: the reference's tree
    (f32 numpy leaves; ``w`` as ``(d_in, d_out)``, ``None`` for a layer
    without batchnorm) from the port's GCN, so trained parameters can be
    compared leaf by leaf with the reference's."""
    def arr(t):
        return t.detach().float().cpu().numpy()

    n = len(model.lin)
    bns = [model.batchnorm(l) if l < n - 1 else None for l in range(n)]
    return {"lin": [{"w": arr(lin.weight).T.copy(), "b": arr(lin.bias)}
                    for lin in model.lin],
            "bn": [None if bn is None else {"g": arr(bn.weight),
                                            "b": arr(bn.bias)}
                   for bn in bns]}


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
