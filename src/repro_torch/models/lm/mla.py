"""Multi-head Latent Attention (DeepSeek-V2), with a compressed KV cache.

The port of ``repro.models.lm.mla``. Train and prefill use the expanded
form: k and v up-projected from the latent (q and k ``qk_nope + qk_rope``
wide, v ``v_head`` wide) through the plain kv-chunked
``attention.flash_attention``, as the reference runs its jnp flash there.
Decode uses the absorbed form in f32: ``W_uk`` folded into the query and
``W_uv`` into the output, scores taken directly against the
``(b, S, kv_lora)`` latent cache ``ckv`` and the ``(b, S, qk_rope)``
``krope``, which decode writes in place at the new position.

Queries come through ``w_q`` or, with ``q_lora`` (deepseek-v2-236b),
through ``w_dq`` → ``q_norm`` → ``w_uq``.

Tensor parallel over ``model``: ``w_q`` / ``w_uq``, ``w_uk`` and
``w_uv`` hold this rank's heads (a contiguous block of their columns is
whole heads in the order the reshapes below read them), the latents
(``w_dkv``, ``w_kr``, ``kv_norm``) and the query's down-projection
(``w_dq``, ``q_norm``) are whole on every rank, and the row-parallel
``wo``'s partial output is summed over ``model``. Serving keeps the
latent cache sequence parallel (``DECODE_RULES``): prefill caches this
rank's ``kv_seq`` block of ``ckv`` / ``krope``; absorbed decode gathers
every head's ``q_eff`` and ``q_rope`` over ``model`` (one collective),
scores them against the rank's latents, merges the softmax over
``model`` and keeps its heads' ``out_lat`` for its ``w_uv`` heads.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.lm.attention import flash_attention
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import Linear, Norm, apply_norm, \
    apply_rope, linear, row_linear
from repro_torch.models.lm.sharding import copy_to_model, current_mesh, \
    gather_heads, kv_seq_block, kv_seq_length, kv_seq_slice, shard, \
    softmax_over_model, tp_size


class MLA(nn.Module):
    """``w_dkv``, ``w_kr``, ``kv_norm``, ``w_uk``, ``w_uv``, ``wo`` and
    either ``w_q`` or ``w_dq``, ``q_norm``, ``w_uq``."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
        dt = getattr(torch, cfg.dtype)

        def lin(a, b):
            return Linear(a, b, dt, device, gen=gen)

        self.w_dkv = lin(d, m.kv_lora)
        self.w_kr = lin(d, m.qk_rope)
        self.kv_norm = Norm(m.kv_lora, device=device)
        self.w_uk = lin(m.kv_lora, h * m.qk_nope)
        self.w_uv = lin(m.kv_lora, h * m.v_head)
        self.wo = lin(h * m.v_head, d)
        if m.q_lora:
            self.w_dq = lin(d, m.q_lora)
            self.q_norm = Norm(m.q_lora, device=device)
            self.w_uq = lin(m.q_lora, h * (m.qk_nope + m.qk_rope))
        else:
            self.w_q = lin(d, h * (m.qk_nope + m.qk_rope))


def _queries(p: MLA, cfg: LMConfig, x, positions):
    m = cfg.mla
    b, t, _ = x.shape
    if m.q_lora:
        cq = apply_norm(p.q_norm, linear(p.w_dq, x), cfg.norm_eps)
        q = linear(p.w_uq, cq)
    else:
        q = linear(p.w_q, x)
    q = shard(q.reshape(b, t, -1, m.qk_nope + m.qk_rope), "batch", "seq",
              "heads", None)
    q_nope, q_rope = q[..., : m.qk_nope], q[..., m.qk_nope:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latents(p: MLA, cfg: LMConfig, x, positions):
    ckv = apply_norm(p.kv_norm, linear(p.w_dkv, x), cfg.norm_eps)
    krope = linear(p.w_kr, x)[:, :, None, :]               # (b, t, 1, rope)
    krope = apply_rope(krope, positions, cfg.rope_theta)[:, :, 0]
    return ckv, krope


def absorbed_attention(q_eff, q_rope, ckv, krope, kv_positions,
                       q_position: int, scale: float, mesh=None):
    """The absorbed form's attention of one query token: ``q_eff`` (b, 1,
    h, kv_lora; ``W_uk`` folded in) and ``q_rope`` (b, 1, h, qk_rope)
    scored against the latents ``ckv`` (b, S, kv_lora) and ``krope`` (b,
    S, qk_rope) at ``kv_positions`` (keys past ``q_position`` masked),
    and the f32 ``out_lat`` (b, 1, h, kv_lora) they weigh.

    With ``mesh`` it is sequence parallel: the latents are this rank's
    block of the cache, every head's ``q_eff`` and ``q_rope`` are
    gathered over ``model`` (one collective), scored against the block,
    the softmax merged over ``model`` (``sharding.softmax_over_model``),
    and the rank's heads of ``out_lat`` returned."""
    lora = ckv.shape[-1]
    ckv, krope = ckv.float(), krope.float()
    q_all = torch.cat([q_eff.float(), q_rope.float()], -1)
    if mesh is not None:
        q_all = gather_heads(q_all, mesh)
    scores = torch.einsum("bthl,bsl->bths", q_all[..., :lora], ckv)
    scores = scores + torch.einsum("bthr,bsr->bths", q_all[..., lora:],
                                   krope)
    scores = scores * scale
    scores = torch.where(kv_positions <= q_position, scores,
                         torch.full((), NEG_INF, device=scores.device))
    if mesh is None:
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bths,bsl->bthl", probs, ckv)
    out = softmax_over_model(
        scores, lambda p: torch.einsum("bths,bsl->bthl", p, ckv), mesh)
    h = q_eff.shape[2]
    h0 = mesh.index("model") * h
    return out[:, :, h0:h0 + h]


def mla_attention(p: MLA, cfg: LMConfig, x, positions, *,
                  cache: dict | None = None, cache_len: int | None = None,
                  mode: str = "train"):
    """Returns (out, new_cache). Modes: train | prefill | decode."""
    m = cfg.mla
    b, t, _ = x.shape
    mesh = current_mesh()
    tp = tp_size(mesh) > 1
    if tp:
        x = copy_to_model(x)
    q_nope, q_rope = _queries(p, cfg, x, positions)
    h = q_nope.shape[2]          # this rank's heads

    if mode in ("train", "prefill"):
        ckv, krope = _latents(p, cfg, x, positions)
        k_nope = linear(p.w_uk, ckv).reshape(b, t, h, m.qk_nope)
        v = linear(p.w_uv, ckv).reshape(b, t, h, m.v_head)
        k = torch.cat([k_nope, krope[:, :, None, :].expand(
            b, t, h, m.qk_rope)], -1)
        q = torch.cat([q_nope, q_rope], -1)
        out = flash_attention(q, k, v, q_positions=positions,
                              kv_positions=positions, chunk=cfg.attn_chunk,
                              remat_chunks=(mode == "train"))
        new_cache = {"ckv": kv_seq_block(ckv, t),
                     "krope": kv_seq_block(krope, t)} \
            if mode == "prefill" else None
        out = out.reshape(b, t, h * m.v_head)
    elif mode == "decode":   # t == 1: absorbed form against the latents
        if cache is None or cache_len is None:
            raise ValueError("decode needs a cache and its length")
        n = kv_seq_length(cache["ckv"]) if tp else cache["ckv"].shape[1]
        sl = kv_seq_slice(n)
        ckv_t, krope_t = _latents(p, cfg, x, positions)
        if sl.start <= cache_len < sl.stop:  # the rank that holds it
            cache["ckv"][:, cache_len - sl.start] = ckv_t[:, 0]
            cache["krope"][:, cache_len - sl.start] = krope_t[:, 0]
        w_uk = p.w_uk.w.reshape(m.kv_lora, h, m.qk_nope).float()
        q_eff = torch.einsum("bthn,lhn->bthl", q_nope.float(), w_uk)
        kv_pos = torch.arange(sl.start, sl.stop, device=x.device)
        out_lat = absorbed_attention(
            q_eff, q_rope, cache["ckv"], cache["krope"], kv_pos, cache_len,
            (m.qk_nope + m.qk_rope) ** -0.5,
            mesh if tp and sl.stop - sl.start < n else None)
        w_uv = p.w_uv.w.reshape(m.kv_lora, h, m.v_head).float()
        out = torch.einsum("bthl,lhv->bthv", out_lat, w_uv).to(x.dtype)
        out = out.reshape(b, t, h * m.v_head)
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return row_linear(p.wo, out), new_cache
