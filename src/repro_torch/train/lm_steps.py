"""LM step builders: prefill and decode.

The serving half of ``repro.train.lm_steps``. The reference's steps are
``jax.jit``-able pure functions; these run eagerly under
``torch.inference_mode``. The training step (``make_train_step``,
``cross_entropy``) comes with ROADMAP.md Queue 1 item 9b.
"""
from __future__ import annotations

import torch

from repro_torch.models.lm.backbone import LM, forward
from repro_torch.models.lm.config import LMConfig


def _fwd_kwargs(batch: dict) -> dict:
    return {k: batch[k] for k in ("tokens", "embeds", "cross_states")
            if k in batch}


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
