"""Placing a checkpointed tree on a rank's device.

The port of ``repro.distributed.elastic``. Checkpoints hold whole logical
arrays (host npz), so elasticity is re-placement: every leaf of a host
(numpy) or torch tree goes to the device its target names. With one
process per rank there is no mesh to lay a leaf out over: a leaf is whole
on each rank's device, and ``replicate_tree`` puts every leaf there.
"""
from __future__ import annotations

import numpy as np
import torch


def _place(x, device):
    if isinstance(x, np.ndarray) or np.isscalar(x):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device)


def reshard_tree(tree, targets):
    """Place every leaf of ``tree`` on its target device (``targets``:
    the same tree of devices); a ``None`` target leaves the leaf where it
    is."""
    if isinstance(tree, dict):
        return {k: reshard_tree(v, targets[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(reshard_tree(v, t) for v, t in zip(tree, targets))
    if tree is None or targets is None:
        return tree
    return _place(tree, targets)


def _targets_like(tree, device):
    if isinstance(tree, dict):
        return {k: _targets_like(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_targets_like(v, device) for v in tree)
    return device


def replicate_tree(tree, device):
    """Every leaf of ``tree`` whole on ``device`` (the rank's own)."""
    return reshard_tree(tree, _targets_like(tree, device))
