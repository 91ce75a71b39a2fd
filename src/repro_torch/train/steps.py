"""GNN train/eval steps: the loss, its gradients and the optimizer step.

The port of ``repro.train.steps``' single-device part (``gnn_loss``,
``make_gnn_grads``, ``make_gnn_steps``). The reference's steps are pure
functions under ``jax.jit``; these run eagerly on the module's device and
update its parameters (and the optimizer's moments) in place. The ∇H row
norms the planner scores with come from the gradient of zero-valued taps
(``models/gnn/common.py``) taken with the parameters' in one
``torch.autograd.grad``; they stay on the device.
"""
from __future__ import annotations

import torch

from repro_torch.core.sampling import row_norms
from repro_torch.train.optimizer import Adam, apply_updates


def gnn_loss(logits: torch.Tensor, ops) -> torch.Tensor:
    """Masked mean cross-entropy (softmax) or sigmoid BCE (multilabel).

    With per-node loss weights (``ops.loss_w``) the mean is
    weight-normalized, ``Σ w·L / Σ w`` over valid train nodes; uniform
    weights (full batch) give the plain mean.
    """
    valid = torch.arange(logits.shape[0], device=logits.device) \
        < ops.n_valid
    m = (ops.train_mask & valid).float()
    if ops.loss_w is not None:
        m = m * ops.loss_w
    if ops.multilabel:
        ls = torch.nn.functional.logsigmoid(logits)
        lns = torch.nn.functional.logsigmoid(-logits)
        per = -(ops.labels * ls + (1 - ops.labels) * lns).sum(-1)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        per = -logp.gather(-1, ops.labels.long()[:, None])[:, 0]
    return torch.sum(per * m) / torch.clamp(torch.sum(m), min=1.0)


def make_gnn_grads(module, dims: dict[str, int], rsc_names,
                   *, dropout: float, backend: str):
    """Build the gradient functions every step flavor shares.

    Returns ``(rsc_grads, exact_grads, eval_logits)``:

    * ``rsc_grads(model, ops, plans, gen) -> (loss, grads, norms)`` where
      ``norms[name]`` are the per-node ∇H row norms of each sampled SpMM
      (via the tap trick), on the device;
    * ``exact_grads(model, ops, gen) -> (loss, grads)``;
    * ``eval_logits(model, ops) -> logits``.

    ``grads`` maps each of ``model.named_parameters()`` to its gradient;
    ``loss`` is a 0-d tensor on the device (reading it syncs).
    """
    rsc_names = tuple(rsc_names)

    def _grads(model, ops, taps, plans, gen):
        logits = module.apply(model, ops, taps, plans, dropout_rate=dropout,
                              train=True, generator=gen, backend=backend)
        loss = gnn_loss(logits, ops)
        params = dict(model.named_parameters())
        out = torch.autograd.grad(loss, [*params.values(), *taps.values()])
        grads = dict(zip(params, out[:len(params)]))
        return loss.detach(), grads, dict(zip(taps, out[len(params):]))

    def rsc_grads(model, ops, plans, gen):
        n_pad = ops.features.shape[0]
        taps = {k: torch.zeros((n_pad, dims[k]), dtype=torch.float32,
                               device=ops.features.device,
                               requires_grad=True)
                for k in rsc_names}
        loss, grads, gt = _grads(model, ops, taps, plans, gen)
        return loss, grads, {k: row_norms(g) for k, g in gt.items()}

    def exact_grads(model, ops, gen):
        loss, grads, _ = _grads(model, ops, {}, None, gen)
        return loss, grads

    @torch.no_grad()
    def eval_logits(model, ops):
        return module.apply(model, ops, {}, None, dropout_rate=0.0,
                            train=False, generator=None, backend=backend)

    return rsc_grads, exact_grads, eval_logits


def make_gnn_steps(module, opt: Adam, dims: dict[str, int], rsc_names,
                   *, dropout: float, backend: str):
    """Build (rsc_step, exact_step, eval_logits) for a GNN module.

    ``rsc_step(model, opt_state, ops, plans, gen) -> (model, opt_state,
    loss, norms)`` and ``exact_step(model, opt_state, ops, gen) -> (model,
    opt_state, loss)`` update ``model``'s parameters in place (the
    reference returns new ones; the values are the same).
    """
    rsc_grads, exact_grads, eval_logits = make_gnn_grads(
        module, dims, rsc_names, dropout=dropout, backend=backend)

    def _update(model, opt_state, grads):
        params = dict(model.named_parameters())
        upd, opt_state = opt.update(grads, opt_state, params)
        apply_updates(params, upd)
        return opt_state

    def rsc_step(model, opt_state, ops, plans, gen):
        loss, grads, norms = rsc_grads(model, ops, plans, gen)
        return model, _update(model, opt_state, grads), loss, norms

    def exact_step(model, opt_state, ops, gen):
        loss, grads = exact_grads(model, ops, gen)
        return model, _update(model, opt_state, grads), loss

    return rsc_step, exact_step, eval_logits
