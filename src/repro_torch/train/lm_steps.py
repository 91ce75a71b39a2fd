"""LM steps: train (microbatched gradient accumulation), prefill, decode.

The port of ``repro.train.lm_steps``. The reference's steps are
``jax.jit``-able pure functions; these run eagerly. The train step updates
the module's parameters (and the optimizer's moments) in place and returns
them; prefill and decode run under ``torch.inference_mode``.
"""
from __future__ import annotations

import torch

from repro_torch.models.lm.backbone import LM, forward
from repro_torch.models.lm.config import LMConfig
from repro_torch.train.optimizer import Adam, apply_updates


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token NLL, ``mean(logsumexp − picked)``; logits f32 (b, t, v).
    Picking the target's logit with ``gather`` gives exactly the
    reference's one-hot sum (one nonzero term) without its (b, t, v)
    one-hot tensor."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - picked).mean()


def _grads(loss: torch.Tensor, named: dict) -> list[torch.Tensor]:
    """d loss / d each parameter; zeros for one the loss does not use
    (an embedding-input model's ``embed`` in training), as
    ``jax.value_and_grad`` gives."""
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(named.values(), gs)]


def _fwd_kwargs(batch: dict) -> dict:
    return {k: batch[k] for k in ("tokens", "embeds", "cross_states")
            if k in batch}


def make_train_step(cfg: LMConfig, opt: Adam, n_microbatches: int = 1,
                    rsc: dict | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``. Microbatch ``i`` takes batch rows ``[i·b/n, (i+1)·b/n)``; their
    gradients are added into f32 accumulators and divided by ``n``, and
    the loss is the mean of theirs. With ``n = 1`` the raw gradients (in
    the parameters' dtype) go to the optimizer, as in the reference."""
    def loss_fn(params: LM, mb: dict) -> torch.Tensor:
        logits, _ = forward(params, cfg, mode="train", rsc=rsc,
                            **_fwd_kwargs(mb))
        return cross_entropy(logits, mb["targets"])

    def train_step(params: LM, opt_state: dict, batch: dict):
        named = dict(params.named_parameters())
        if n_microbatches == 1:
            loss = loss_fn(params, batch)
            grads = dict(zip(named, _grads(loss, named)))
            loss = loss.detach()
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % n_microbatches:
                raise ValueError(f"batch {rows} is not a multiple of "
                                 f"{n_microbatches} microbatches")
            per = rows // n_microbatches
            gsum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in named.items()}
            lsum = 0.0
            for i in range(n_microbatches):
                mb = {k: x[i * per:(i + 1) * per] for k, x in batch.items()}
                l = loss_fn(params, mb)
                gs = _grads(l, named)
                for k, g in zip(named, gs):
                    gsum[k] += g.float()
                lsum = lsum + l.detach()
                del l, gs
            grads = {k: g.div_(n_microbatches) for k, g in gsum.items()}
            loss = lsum / n_microbatches
        updates, opt_state = opt.update(grads, opt_state, named)
        del grads
        apply_updates(named, updates)
        return params, opt_state, loss

    return train_step


def make_prefill_step(cfg: LMConfig):
    def prefill_step(params: LM, batch: dict):
        with torch.inference_mode():
            return forward(params, cfg, mode="prefill", last_only=True,
                           **_fwd_kwargs(batch))

    return prefill_step


def make_decode_step(cfg: LMConfig):
    def decode_step(params: LM, cache: dict, batch: dict):
        with torch.inference_mode():
            return forward(params, cfg, mode="decode", cache=cache,
                           **_fwd_kwargs(batch))

    return decode_step
