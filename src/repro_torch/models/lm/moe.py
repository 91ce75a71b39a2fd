"""DeepSeek-V2 MoE: shared experts + top-k routed experts.

The port of ``repro.models.lm.moe``, in plain tensor code, as the
reference computes it outside any Pallas kernel. Routing, slot positions
and the capacity scatter are per batch row:

* router logits and softmax in f32; top-k through a stable descending
  sort, so equal probabilities keep the lower expert first, the order
  ``lax.top_k`` gives them (``torch.topk`` promises no order for ties, and
  the k-order decides which entries overflow);
* each entry's position within its expert from a stable argsort of the
  experts and its inverse permutation;
* ``cap = min(t, max(1, ceil(int(cf·t·k) / E)))``; entries at or past it
  go to slot ``E`` with weight 0;
* the experts' FFN over stacked ``(E, d, f)`` weights (``einsum``), the
  combine weighted, summed over k and cast back to the model dtype, and
  the shared experts (always on) added.

Experts take no RSC, as in the reference.

Expert parallel over ``model`` in training, prefill and decode (each
row routes on its own: ``capacity`` counts a row's tokens, so a decode
step's one token needs no count across ranks): every rank holds the
whole router and computes the same routing (its input is replicated over
``model``; each layer checks that the expert ids agree), runs only the
``n_routed / model`` experts it holds (its slots of the dispatch buffer;
the others' entries go to the dropped slot), and combines only their
outputs; the shared experts are column- and row-parallel as the dense
MLP, and the routed and shared partial outputs are summed over ``model``
once.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import MLP, Linear, gelu, linear, \
    mlp_apply, normal, silu
from repro_torch.models.lm.sharding import check_same_over_model, \
    copy_to_model, model_slice, reduce_from_model, shard, tp_size


class StackedLinear(nn.Module):
    """``E`` linears ``x @ w[e]``: ``w`` is ``(E, d_in, d_out)``, each
    ``N(0, 1/d_in)``."""

    def __init__(self, n: int, d_in: int, d_out: int, dtype, device,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.w = nn.Parameter(normal((n, d_in, d_out), math.sqrt(1.0 / d_in),
                                     dtype, device, gen))


class Experts(nn.Module):
    """The routed experts' MLPs stacked over their leading axis:
    ``gate`` (gated kinds only), ``up``, ``down``."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        m, d, dt = cfg.moe, cfg.d_model, getattr(torch, cfg.dtype)
        self.gate = StackedLinear(m.n_routed, d, m.d_expert, dt, device,
                                  gen) \
            if cfg.mlp in ("swiglu", "geglu") else None
        self.up = StackedLinear(m.n_routed, d, m.d_expert, dt, device, gen)
        self.down = StackedLinear(m.n_routed, m.d_expert, d, dt, device, gen)


class MoE(nn.Module):
    """``router`` (f32 linear to the routed experts), ``experts`` and
    ``shared`` (a list of MLPs of width ``d_expert``)."""

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        m, d, dt = cfg.moe, cfg.d_model, getattr(torch, cfg.dtype)
        self.router = Linear(d, m.n_routed, torch.float32, device, gen=gen)
        self.experts = Experts(cfg, device, gen)
        self.shared = nn.ModuleList(
            MLP(d, m.d_expert, cfg.mlp, dt, device, gen)
            for _ in range(m.n_shared))


def capacity(cfg: LMConfig, t: int) -> int:
    """Slots per expert per batch row of ``t`` tokens."""
    m = cfg.moe
    cap = max(1, -(-int(m.capacity_factor * t * m.top_k) // m.n_routed))
    return min(cap, t)


def route(p: MoE, cfg: LMConfig, x: torch.Tensor) -> dict:
    """The routing of ``x`` (b, t, d), per row of its ``t·k`` entries
    (token-major, then the k picks in descending probability): ``expert``
    and ``weight`` (f32) of each pick, its ``slot`` (expert, or ``E`` when
    it overflowed) and ``pos`` within the slot (0 when it overflowed),
    ``overflow`` and ``cap``."""
    m = cfg.moe
    b, t, _ = x.shape
    probs = torch.softmax(linear(p.router, x.float()), dim=-1)   # (b, t, E)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    fw = srt[..., : m.top_k].reshape(b, t * m.top_k)
    fe = idx[..., : m.top_k].reshape(b, t * m.top_k)
    order = torch.argsort(fe, dim=1, stable=True)
    ar = torch.arange(t * m.top_k, device=x.device).expand(b, -1)
    rank = torch.empty_like(order).scatter_(1, order, ar)  # inverse of order
    counts = torch.zeros((b, m.n_routed), dtype=torch.long,
                         device=x.device).scatter_add_(1, fe,
                                                       torch.ones_like(fe))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = rank - starts.gather(1, fe)
    cap = capacity(cfg, t)
    overflow = pos >= cap
    return {"expert": fe, "weight": fw,
            "slot": torch.where(overflow, m.n_routed, fe),
            "pos": torch.where(overflow, 0, pos), "overflow": overflow,
            "cap": cap}


def _expert_ffn(experts: Experts, xb: torch.Tensor, kind: str):
    """xb: (b, E, cap, d) -> the same through each expert's FFN."""
    if kind in ("swiglu", "geglu"):
        g = torch.einsum("becd,edf->becf", xb, experts.gate.w)
        u = torch.einsum("becd,edf->becf", xb, experts.up.w)
        h = (silu(g) if kind == "swiglu" else gelu(g)) * u
    else:
        h = gelu(torch.einsum("becd,edf->becf", xb, experts.up.w))
    return torch.einsum("becf,efd->becd", h, experts.down.w)


def moe_apply(p: MoE, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (b, t, d) -> (b, t, d), in x's dtype."""
    m = cfg.moe
    b, t, d = x.shape
    dt = x.dtype
    tp = tp_size() > 1
    if tp:
        x = copy_to_model(x)
    r = route(p, cfg, x)
    cap = r["cap"]
    slot, pos = r["slot"], r["pos"]
    if tp:   # this rank's experts; every other entry to the dropped slot
        check_same_over_model(r["expert"], "the MoE routing")
        mine = model_slice(m.n_routed)
        n_exp = mine.stop - mine.start
        slot = slot - mine.start
        keep = (slot >= 0) & (slot < n_exp)
        slot = torch.where(keep, slot, n_exp)
        pos = torch.where(keep, pos, 0)
    else:
        n_exp = m.n_routed
    n_slots = n_exp + 1
    # dispatch: each entry's row of x into its (row, slot, pos); the
    # overflowed ones all land in the last slot, which is dropped
    flat = (torch.arange(b, device=x.device)[:, None] * n_slots
            + slot) * cap + pos                                   # (b, t·k)
    tok = torch.arange(t, device=x.device).repeat_interleave(m.top_k)
    xg = x[:, tok].reshape(b * t * m.top_k, d)
    xb = torch.zeros((b * n_slots * cap, d), dtype=dt, device=x.device)
    xb = xb.index_add(0, flat.reshape(-1), xg).view(b, n_slots, cap, d)
    yb = _expert_ffn(p.experts, shard(xb[:, :n_exp], "batch", "experts",
                                      None, None), cfg.mlp)
    yb = torch.cat([yb, torch.zeros((b, 1, cap, d), dtype=yb.dtype,
                                    device=x.device)], dim=1)
    # combine: gather back, weight, sum over the k picks
    y_tok = yb.reshape(b * n_slots * cap, d)[flat.reshape(-1)]
    w_eff = torch.where(r["overflow"], 0.0, r["weight"]).to(dt)
    y_tok = (y_tok.view(b, t * m.top_k, d) * w_eff[..., None]).view(
        b, t, m.top_k, d)
    y = y_tok.sum(dim=2).to(dt)
    if tp:
        for sp in p.shared:
            y = y + mlp_apply(sp, x, cfg.mlp, partial=True)
        return reduce_from_model(y).to(dt)
    for sp in p.shared:
        y = y + mlp_apply(sp, x, cfg.mlp)
    return y.to(dt)
