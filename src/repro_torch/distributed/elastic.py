"""Elastic resharding: place a checkpointed tree on a rank, on any mesh.

The port of ``repro.distributed.elastic``. Checkpoints hold whole logical
arrays (host npz), so elasticity is re-placement: every leaf of a host
(numpy) or torch tree goes where its target says. A target is a device
(the leaf goes there whole) or a ``launch.shardings.Sharding`` on a bound
mesh (this rank's block of the leaf goes to the mesh's device), so a
state trained on one mesh continues on another: ``gather_tree`` rebuilds
the whole arrays from the blocks of the old mesh, ``reshard_tree`` cuts
them for the new one. ``replicate_tree`` puts every leaf whole on one
device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.shardings import Sharding


def _place(x, device):
    if isinstance(x, np.ndarray) or np.isscalar(x):
        x = torch.as_tensor(np.ascontiguousarray(x) if np.ndim(x)
                            else np.asarray(x))
    return x.to(device)


def reshard_tree(tree, targets):
    """Place every leaf of ``tree`` as its target says (``targets``: the
    same tree of devices or ``Sharding``s; a ``Sharding`` gives a copy of
    this rank's block, contiguous, on its mesh's device); a ``None`` target
    leaves the leaf where it is."""
    if isinstance(tree, dict):
        return {k: reshard_tree(v, targets[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(reshard_tree(v, t) for v, t in zip(tree, targets))
    if tree is None or targets is None:
        return tree
    if isinstance(targets, Sharding):   # a copy: the block owns its memory
        block = targets.local(tree)
        dev = targets.mesh.device or "cpu"
        if isinstance(block, torch.Tensor):
            return block.contiguous().to(dev, copy=True)
        return torch.from_numpy(np.array(block)).to(dev)
    return _place(tree, targets)


def gather_tree(tree, shardings):
    """The inverse of ``reshard_tree`` with ``Sharding`` targets: every
    leaf's blocks all-gathered over the mesh axes of its spec into the
    whole array, on every rank of the mesh (each must call it). A leaf
    that is no tensor (a cache's ``len``, a host int) is whole already."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, s) for v, s in zip(tree, shardings))
    if not isinstance(tree, torch.Tensor) or \
            not isinstance(shardings, Sharding):
        return tree
    x = tree.detach()
    for d, a in enumerate(shardings.spec):
        if a is not None:
            x = shardings.mesh.all_gather(x, a, d)
    return x.contiguous()


def _targets_like(tree, device):
    if isinstance(tree, dict):
        return {k: _targets_like(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_targets_like(v, device) for v in tree)
    return device


def replicate_tree(tree, device):
    """Every leaf of ``tree`` whole on ``device`` (the rank's own)."""
    return reshard_tree(tree, _targets_like(tree, device))
