"""Hand-rolled Adam / AdamW over named parameter tensors.

The port of ``repro.train.optimizer``: decoupled weight decay, a global-norm
clip and f32 moments whatever the parameters' dtype (bf16-safe for the LM
stack). Parameters, gradients and updates are ``{name: tensor}`` dicts
(``dict(module.named_parameters())``), not ``torch.optim`` state, so one
optimizer serves every model of the port and its arithmetic stays the
reference's: the clip and the moments in f32, the update cast to the
parameter's dtype and then added. The moments are updated in place (the
reference returns new arrays; the values are the same) so that a step at
full width holds one copy of them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensors = dict[str, torch.Tensor]


def tree_zeros_f32(params: Tensors) -> Tensors:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def global_sq_norm(grads: Tensors, shardings: dict | None = None
                   ) -> torch.Tensor:
    """``Σ g²`` over every gradient (f32). With ``shardings`` (``{name:
    launch.shardings.Sharding}``, the gradients this rank's blocks) each
    leaf counts once: only the rank that leads its replicas adds its
    block, and the sum runs over the whole mesh."""
    if shardings is None:
        return sum(torch.sum(torch.square(g.float())) for g in grads.values())
    first = next(iter(grads.values()))
    total = torch.zeros((), dtype=torch.float32, device=first.device)
    for k, g in grads.items():
        if shardings[k].lead:
            total = total + torch.sum(torch.square(g.float()))
    mesh = shardings[next(iter(grads))].mesh
    return mesh.all_reduce(total, mesh.axis_names)


def clip_by_global_norm(grads: Tensors, max_norm: float,
                        shardings: dict | None = None
                        ) -> tuple[Tensors, torch.Tensor]:
    """Gradients scaled by ``min(1, max_norm / max(norm, 1e-12))``, in f32
    (a bf16 gradient times the reference's f32 scale is f32 there too),
    and the global norm ``sqrt(Σ g²)`` (f32, left on the device; over a
    mesh, ``shardings`` as ``global_sq_norm`` takes them)."""
    scale, gn = _clip_scale(grads, max_norm, shardings)
    return {k: g.float() * scale for k, g in grads.items()}, gn


def _clip_scale(grads: Tensors, max_norm: float, shardings=None):
    """``min(1, max_norm / max(norm, 1e-12))`` and the global norm."""
    gn = torch.sqrt(global_sq_norm(grads, shardings))
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0), gn


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """``p ← p + u.to(p.dtype)`` in place: the update is cast to the
    parameter's dtype first and then added, as the reference adds it."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float = 1e-2
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0   # decoupled (AdamW) when > 0
    clip_norm: float | None = None

    def init(self, params: Tensors) -> dict:
        return {"m": tree_zeros_f32(params), "v": tree_zeros_f32(params),
                "count": 0}

    @torch.no_grad()
    def update(self, grads: Tensors, state: dict, params: Tensors,
               shardings: dict | None = None) -> tuple[Tensors, dict]:
        """The step to add to each parameter (f32) and the state, whose
        moments are updated in place. On a mesh the tensors are this
        rank's blocks (Adam is elementwise) and ``shardings`` say how, for
        the clip's global norm."""
        scale = None
        if self.clip_norm is not None:
            # clip_by_global_norm leaf by leaf: no clipped copy of every
            # gradient is held at once
            scale, _ = _clip_scale(grads, self.clip_norm, shardings)
        count = state["count"] + 1
        # bias corrections in f32, as the reference computes them
        b1c = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        b2c = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        steps = {}
        for k, g in grads.items():
            g32 = g.float() if scale is None else g.float() * scale
            m = state["m"][k].mul_(self.b1).add_((1 - self.b1) * g32)
            v = state["v"][k].mul_(self.b2).add_((1 - self.b2) * g32 * g32)
            mh, vh = m / b1c, v / b2c
            step = -self.lr * mh / (torch.sqrt(vh) + self.eps)
            if self.weight_decay:
                step = step - self.lr * self.weight_decay * params[k].float()
            steps[k] = step
        return steps, {"m": state["m"], "v": state["v"], "count": count}
