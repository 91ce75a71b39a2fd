"""Carry parameters across from the JAX package's layout.

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

from repro_torch.models.gnn import MODELS


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def gnn_params_from_numpy(model: str, tree: dict, device="cpu"):
    """The port's ``nn.Module`` for ``model`` holding the tree's values."""
    if model != "gcn":
        raise NotImplementedError(f"{model!r} is not ported yet "
                                  "(ROADMAP.md Queue 1 item 2)")
    lins, bns = tree["lin"], tree["bn"]
    if len(bns) != len(lins) or bns[-1] is not None:
        raise ValueError("expected one bn entry per layer, None on the last")
    with_bn = [b is not None for b in bns[:-1]]
    if any(with_bn) and not all(with_bn):
        raise ValueError("batchnorm must be on every hidden layer or none")
    dims = [int(np.shape(lins[0]["w"])[0])] + [int(np.shape(p["w"])[1])
                                               for p in lins]
    net = MODELS[model].GCN(dims, all(with_bn) and len(bns) > 1,
                            device=device)
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
