"""The plain reference of full-batch GCN / GraphSAGE training with RSC.

Plain PyTorch (sparse CSR products, dense matmuls, autograd) and numpy. It
imports nothing of the program and takes nothing the program made: it
re-derives the normalised operands, the planner's block scores and
allocations, the dropout masks and every step from the graph, the
configuration, the initial weights and the seeds the benchmark hands to
both sides. What it follows of the program, and why:

* node order and padding: nodes relabelled by descending degree (stable),
  rows padded to a multiple of ``block``. The dropout masks are drawn over
  the padded rows in that order, so they fix both;
* dropout: ``torch.rand((rows, width), generator=g) < 1 - rate`` at every
  layer's input, in layer order, ``g`` a generator on the run's device
  seeded with the training's seed + 1;
* a plan refresh whose allocation differs from the reference's only by
  near-ties (:func:`judge_plan`) is followed as the program chose it.

The sampled backward keeps the column blocks of the backward operand that
the allocation kept: ``∇J = Opᵀ (∇H ⊙ kept rows)``. Copies, frozen here:
``block_scores`` and ``greedy_allocate`` (``repro_torch.core.{sampling,
allocator}``), the Adam update (``repro_torch.train.optimizer``), the
normalisations (``repro_torch.sparse.topology``).

``precision="tf32"`` rounds both inputs of every product to TF32 (10
mantissa bits) first: the benchmark's control, one precision below the
configuration's float32 with TF32 off.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}
# A refresh whose allocation loses at most this share of the reference's
# Eq. 4a objective (and keeps to the budget) is a near-tie: rounding moved
# a block across the cut, and the reference follows the program's choice.
PLAN_TIE = 1e-4


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to the nearest TF32 value (ties away from 0)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


# ------------------------------------------------------------- operands

@dataclasses.dataclass
class Operands:
    """The reference's own operands, on one device, padded to ``n_pad``."""

    n: int
    n_pad: int
    block: int
    op: torch.Tensor             # (n_pad, n_pad) sparse CSR: Ã or D⁻¹A
    op_t: torch.Tensor           # its transpose, sparse CSR
    x: torch.Tensor              # (n_pad, d_in)
    labels: torch.Tensor         # (n_pad,) int64
    train: torch.Tensor          # (n_pad,) bool, real rows only
    val: torch.Tensor
    test: torch.Tensor
    valid: torch.Tensor
    # planner metadata of op_t (host): ‖op_t[:, i]‖ per node (f32), tiles
    # per column block, ‖op‖_F
    col_norm: np.ndarray
    col_block_tiles: np.ndarray
    fro: float


def degree_order(rowptr: np.ndarray) -> np.ndarray:
    """``perm[new] = old``: nodes by descending degree, stable."""
    return np.argsort(-np.diff(rowptr), kind="stable").astype(np.int64)


def build_operands(graph, model: str, block: int, device) -> Operands:
    """Ã = D̃^-½ (A + I) D̃^-½ for GCN, D⁻¹A for GraphSAGE, in degree order."""
    n = graph.n
    n_pad = -(-n // block) * block
    perm = degree_order(graph.rowptr)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    rows, cols = inv[graph.rows()], inv[graph.col.astype(np.int64)]
    deg = np.zeros(n, np.float64)
    np.add.at(deg, rows, 1.0)
    if model == "gcn":
        loop = np.arange(n, dtype=np.int64)
        rows, cols = np.concatenate([rows, loop]), np.concatenate([cols, loop])
        dis = 1.0 / np.sqrt(deg + 1.0)
        val = (dis[rows] * dis[cols]).astype(np.float32)
    elif model == "graphsage":
        val = np.where(deg[rows] > 0, 1.0 / np.maximum(deg[rows], 1),
                       0.0).astype(np.float32)
    else:
        raise ValueError(f"no reference for model {model!r}")

    def csr(r, c):
        t = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([r, c])), torch.from_numpy(val),
            (n_pad, n_pad), check_invariants=False).coalesce()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Sparse CSR tensor support")
            return t.to_sparse_csr().to(device)

    col_norm = np.zeros(n, np.float64)          # columns of op_t = rows of op
    np.add.at(col_norm, rows, val.astype(np.float64) ** 2)
    n_cb = n_pad // block
    key = np.unique((rows // block) * n_cb + cols // block)
    tiles = np.bincount(key // n_cb, minlength=n_cb).astype(np.int64)

    def pad(a, dtype):
        out = np.zeros((n_pad,) + a.shape[1:], dtype)
        out[:n] = a[perm]
        return torch.from_numpy(out).to(device)

    valid = torch.arange(n_pad, device=device) < n
    return Operands(
        n=n, n_pad=n_pad, block=block, op=csr(rows, cols), op_t=csr(cols, rows),
        x=pad(graph.features, np.float32), labels=pad(graph.labels, np.int64),
        train=pad(graph.train_mask, bool), val=pad(graph.val_mask, bool),
        test=pad(graph.test_mask, bool), valid=valid,
        col_norm=np.sqrt(col_norm).astype(np.float32), col_block_tiles=tiles,
        fro=float(np.sqrt(np.sum(val.astype(np.float64) ** 2))))


# ------------------------------------------------------------- products

class _Spmm(torch.autograd.Function):
    """``op @ x``; the backward ``op_t @ (g ⊙ keep)`` (``keep`` None: all)."""

    @staticmethod
    def forward(ctx, op, op_t, keep, x, low):
        ctx.op_t, ctx.keep, ctx.low = op_t, keep, low
        return torch.sparse.mm(op, tf32(x) if low else x)

    @staticmethod
    def backward(ctx, g):
        if ctx.keep is not None:
            g = g * ctx.keep[:, None]
        g = tf32(g) if ctx.low else g
        return None, None, None, torch.sparse.mm(ctx.op_t, g), None


class _Mm(torch.autograd.Function):
    """``x @ w``, with both inputs of each product rounded to TF32 when
    ``low`` (forward and backward)."""

    @staticmethod
    def forward(ctx, x, w, low):
        ctx.save_for_backward(x, w)
        ctx.low = low
        r = tf32 if low else (lambda t: t)
        return r(x) @ r(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        r = tf32 if ctx.low else (lambda t: t)
        gx = r(g) @ r(w).t() if ctx.needs_input_grad[0] else None
        return gx, r(x).t() @ r(g), None


# ------------------------------------------------------------- the model

def layer_dims(cfg: dict, n_classes: int) -> list[int]:
    L = cfg["n_layers"]
    return [cfg["feat_dim"]] + [cfg["hidden"]] * (L - 1) + [n_classes]


def leaf_shapes(cfg: dict, n_classes: int) -> dict[str, tuple]:
    """Every parameter by the reference's name, in a fixed order: linear
    weights ``(d_in, d_out)`` and biases, batchnorm ``g`` / ``b`` on the
    hidden layers."""
    dims = layer_dims(cfg, n_classes)
    heads = ["lin"] if cfg["model"] == "gcn" else ["self", "neigh"]
    out = {}
    for l in range(cfg["n_layers"]):
        for h in heads:
            out[f"{h}.{l}.w"] = (dims[l], dims[l + 1])
            out[f"{h}.{l}.b"] = (dims[l + 1],)
    if cfg["batchnorm"]:
        for l in range(cfg["n_layers"] - 1):
            out[f"bn.{l}.g"] = (dims[l + 1],)
            out[f"bn.{l}.b"] = (dims[l + 1],)
    return out


def spmm_names(cfg: dict) -> list[int]:
    """The layers whose backward SpMM the planner samples: every layer for
    GCN; GraphSAGE's layer 0 acts on the features and has no backward."""
    first = 0 if cfg["model"] == "gcn" else 1
    return list(range(first, cfg["n_layers"]))


def spmm_width(cfg: dict, n_classes: int, l: int) -> int:
    """The width of layer ``l``'s SpMM: its output for GCN, its input for
    GraphSAGE."""
    dims = layer_dims(cfg, n_classes)
    return dims[l + 1] if cfg["model"] == "gcn" else dims[l]


def _batchnorm(x, g, b, valid):
    m = valid.float()[:, None]
    cnt = torch.clamp(m.sum(), min=1.0)
    mu = torch.sum(x * m, 0) / cnt
    var = torch.sum(((x - mu) ** 2) * m, 0) / cnt
    return (x - mu) / torch.sqrt(var + 1e-5) * g + b


def draw_masks(cfg: dict, ops: Operands, gen) -> list:
    """The dropout keep masks of one training step, drawn in layer order
    over each layer's input ``(rows, width)``."""
    rate, dims = cfg["dropout"], layer_dims(cfg, cfg["classes"])
    if rate == 0:
        return [None] * cfg["n_layers"]
    return [torch.rand((ops.n_pad, dims[l]), generator=gen,
                       device=ops.x.device) < (1.0 - rate)
            for l in range(cfg["n_layers"])]


def forward(cfg: dict, p: dict, ops: Operands, *, masks, keep, low: bool):
    """Logits ``(n_pad, C)`` and each layer's SpMM output (the sampled
    layers' gradients there are the ∇H the planner scores). ``masks``:
    :func:`draw_masks`' (training), or None (evaluation)."""
    L, rate = cfg["n_layers"], cfg["dropout"]
    h, taps = ops.x, {}
    for l in range(L):
        if masks is not None and masks[l] is not None:
            h = torch.where(masks[l], h / (1.0 - rate),
                            torch.zeros((), device=h.device))
        kl = keep.get(l) if keep else None
        if cfg["model"] == "gcn":
            j = _Mm.apply(h, p[f"lin.{l}.w"], low) + p[f"lin.{l}.b"]
            hp = _Spmm.apply(ops.op, ops.op_t, kl, j, low)
            taps[l] = hp
        else:
            m = _Spmm.apply(ops.op, ops.op_t, kl, h, low)
            taps[l] = m
            hp = (_Mm.apply(h, p[f"self.{l}.w"], low) + p[f"self.{l}.b"]
                  + _Mm.apply(m, p[f"neigh.{l}.w"], low) + p[f"neigh.{l}.b"])
        if l < L - 1:
            if cfg["batchnorm"]:
                hp = _batchnorm(hp, p[f"bn.{l}.g"], p[f"bn.{l}.b"], ops.valid)
            hp = torch.relu(hp)
        h = hp
    return h, taps


def loss_of(logits, ops: Operands):
    m = (ops.train & ops.valid).float()
    logp = torch.log_softmax(logits, dim=-1)
    per = -logp.gather(-1, ops.labels[:, None])[:, 0]
    return torch.sum(per * m) / torch.clamp(torch.sum(m), min=1.0)


# ------------------------------------------------------------- planner

def block_scores(col_norm, g, block, n_cb):
    """Eq. 3 summed per ``block``-wide column block."""
    s = col_norm.astype(np.float64) * g.astype(np.float64)
    out = np.zeros(n_cb, np.float64)
    np.add.at(out, np.arange(s.shape[0]) // block, s)
    return out


def greedy_allocate(layers, budget_frac, step_frac):
    """Algorithm 1 at block granularity; ``layers`` are ``(scores, tiles,
    d, norm)``. Returns each layer's keep mask and the budget (tiles x d):
    each move drops the ``step`` lowest-score kept blocks of the layer
    whose Eq. 4a error grows least, until the kept cost fits."""
    total = sum(float(np.sum(t)) * d for _, t, d, _ in layers)
    budget = budget_frac * total
    orders, pv, pc = [], [], []
    for s, t, d, norm in layers:
        o = np.argsort(s, kind="stable")
        orders.append(o)
        pv.append(np.concatenate([[0.0], np.cumsum(
            s[o].astype(np.float64) / max(norm, 1e-30))]))
        pc.append(np.concatenate([[0.0], np.cumsum(
            t[o].astype(np.float64) * d)]))
    n_cb = [s.shape[0] for s, *_ in layers]
    step = [max(1, int(round(step_frac * n))) for n in n_cb]
    dropped = [0] * len(layers)
    cost = total
    while cost > budget:
        best, best_inc, best_new = -1, np.inf, 0
        for l in range(len(layers)):
            new = min(dropped[l] + step[l], n_cb[l])
            if new == dropped[l]:
                continue
            inc = pv[l][new] - pv[l][dropped[l]]
            if inc < best_inc:
                best, best_inc, best_new = l, inc, new
        if best < 0:
            break
        cost -= pc[best][best_new] - pc[best][dropped[best]]
        dropped[best] = best_new
    keep = []
    for l, n in enumerate(n_cb):
        m = np.ones(n, bool)
        m[orders[l][:dropped[l]]] = False
        keep.append(m)
    return keep, budget


def plan_error(layers, keeps) -> tuple[float, float]:
    """(Eq. 4a error, cost) of per-layer keep masks under ``layers``."""
    err = sum(float(np.sum(s[~k])) / max(norm, 1e-30)
              for (s, _, _, norm), k in zip(layers, keeps))
    cost = sum(float(np.sum(t[k])) * d for (_, t, d, _), k in zip(layers, keeps))
    return err, cost


def judge_plan(layers, ref_keep, budget, prog_keep) -> tuple[bool, float]:
    """Whether the program's allocation is the reference's up to
    near-ties, and the share of the reference's error it loses."""
    if prog_keep is None:
        return False, float("inf")
    if all(np.array_equal(a, b) for a, b in zip(ref_keep, prog_keep)):
        return True, 0.0
    e_ref, _ = plan_error(layers, ref_keep)
    e_prog, c_prog = plan_error(layers, prog_keep)
    gap = max(e_prog - e_ref, 0.0) / max(e_ref, 1e-30)
    return gap <= PLAN_TIE and c_prog <= budget * (1 + 1e-9), gap


# ------------------------------------------------------------- training

def adam_update(p: dict, g: dict, st: dict) -> None:
    st["count"] += 1
    c = np.float32(st["count"])
    b1c = float(np.float32(1.0) - np.float32(ADAM["b1"]) ** c)
    b2c = float(np.float32(1.0) - np.float32(ADAM["b2"]) ** c)
    lr = st["lr"]
    with torch.no_grad():
        for k, gk in g.items():
            m = st["m"][k].mul_(ADAM["b1"]).add_((1 - ADAM["b1"]) * gk)
            v = st["v"][k].mul_(ADAM["b2"]).add_((1 - ADAM["b2"]) * gk * gk)
            p[k].add_(-lr * (m / b1c) / (torch.sqrt(v / b2c) + ADAM["eps"]))


def use_rsc(traffic: dict, step: int) -> bool:
    """The switch-back schedule (paper §3.3.2): RSC for the first
    ``rsc_fraction`` of the steps, exact after."""
    if not traffic["rsc"]:
        return False
    if not traffic["switching"]:
        return True
    return step < int(traffic["epochs"] * traffic["rsc_fraction"])


def refresh_every(traffic: dict) -> int:
    """Plans are cached between refreshes (§3.3.1); without caching every
    RSC step refreshes."""
    return traffic["refresh_every"] if traffic["caching"] else 1


def follow(cfg: dict, traffic: dict, ops: Operands, init: dict, seed: int,
           steps, eval_epochs, *, states=None, eval_params=None,
           prog_plans=None, precision: str = "f32") -> dict:
    """The followed ``steps`` of one training from ``init`` (the
    reference's leaf names), as the program's schedule runs them.

    Without ``states`` the reference trains on its own from ``init``
    through the last followed step and records its state (parameters,
    Adam's ``m``, ``v`` and ``count``) at the start of each followed step
    and after it. With ``states`` (the same, of the program) each followed
    step starts from the program's state: training here is chaotic at the
    level of rounding (an element whose gradient is near 0 moves by about
    ``lr`` one way or the other under Adam), so a step is judged from the
    state it started from. The dropout generator is drawn forward over
    every step, followed or not; the planner's refresh scores the
    gradients of the step before it, which is followed.

    Returns ``loss`` (step -> value), ``grad1`` (each leaf's first
    gradient norm), ``update`` (step -> each leaf's norm of the step's
    change), ``grad_norm`` (step -> each leaf's gradient norm), ``states``
    (the recorded states, without ``states``),
    ``logits`` and ``eval_params`` (epoch -> the evaluation after it and
    the parameters it evaluated; given ``eval_params``, the program's,
    the reference evaluates those, and an epoch missing there reads None)
    and ``plans`` (each refresh: the reference's allocation, the program's
    (``prog_plans``: refresh step -> keep mask per sampled layer) judged
    against it (``ok``: the same up to near-ties), and the one
    followed)."""
    low = precision == "tf32"
    if low:
        ops = dataclasses.replace(ops, op=_tf32_csr(ops.op),
                                  op_t=_tf32_csr(ops.op_t))
    dev = ops.x.device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in init.items()}
    st = {"m": {k: torch.zeros_like(v) for k, v in p.items()},
          "v": {k: torch.zeros_like(v) for k, v in p.items()},
          "count": 0, "lr": float(cfg["lr"])}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    names = spmm_names(cfg)
    steps = sorted(steps)
    keep_rows, last_norms = None, None
    out = {"loss": {}, "grad1": None, "update": {}, "grad_norm": {},
           "logits": {}, "eval_params": {}, "plans": {},
           "states": None if states is not None else {}}

    def state():
        return {"count": st["count"],
                **{s: {k: v.detach().clone() for k, v in d.items()}
                   for s, d in (("params", p), ("m", st["m"]),
                                ("v", st["v"]))}}
    for step in range(steps[-1] + 1):
        masks = draw_masks(cfg, ops, gen)
        if step not in steps and states is not None:
            continue
        if states is not None:
            if step not in states:        # the program never ran it
                out["missing"] = step
                break
            with torch.no_grad():
                for k in p:
                    p[k].copy_(states[step]["params"][k])
                    st["m"][k].copy_(states[step]["m"][k])
                    st["v"][k].copy_(states[step]["v"][k])
            st["count"] = states[step]["count"]
        elif step in steps:
            out["states"][step] = state()
        rsc = use_rsc(traffic, step)
        if (rsc and step % refresh_every(traffic) == 0
                and last_norms is not None):
            keep_rows = _refresh(cfg, traffic, ops, names, last_norms, step,
                                 prog_plans, out["plans"])
        logits, taps = forward(cfg, p, ops, masks=masks,
                               keep=keep_rows if rsc else None, low=low)
        loss = loss_of(logits, ops)
        leaves = list(p)
        tap_l = names if rsc else []
        gr = torch.autograd.grad(loss, [p[k] for k in leaves]
                                 + [taps[l] for l in tap_l])
        grads = dict(zip(leaves, gr[:len(leaves)]))
        if rsc:
            last_norms = {l: torch.sqrt(torch.sum(t * t, -1)).cpu().numpy()
                          for l, t in zip(tap_l, gr[len(leaves):])}
        if step == 0:
            out["grad1"] = {k: float(torch.linalg.vector_norm(g))
                            for k, g in grads.items()}
        before = {k: v.detach().clone() for k, v in p.items()}
        adam_update(p, grads, st)
        if step in steps:
            out["loss"][step] = float(loss.detach())
            out["grad_norm"][step] = {k: float(torch.linalg.vector_norm(g))
                                      for k, g in grads.items()}
            out["update"][step] = {k: float(torch.linalg.vector_norm(
                p[k].detach() - before[k])) for k in p}
            if states is None and step + 1 not in steps:
                out["states"][step + 1] = state()
        if step in eval_epochs and eval_params is None:
            out["eval_params"][step] = {k: v.detach().clone()
                                        for k, v in p.items()}
            out["logits"][step] = evaluate(cfg, ops, p, low)
    if eval_params is not None:
        out["logits"] = {e: (evaluate(cfg, ops, eval_params[e], low)
                             if e in eval_params else None)
                         for e in eval_epochs}
    return out


@torch.no_grad()
def evaluate(cfg: dict, ops: Operands, params: dict, low: bool = False):
    """The evaluation forward (no dropout, batch statistics of this pass)."""
    return forward(cfg, params, ops, masks=None, keep=None,
                   low=low)[0].detach()


def _tf32_csr(a: torch.Tensor) -> torch.Tensor:
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        return torch.sparse_csr_tensor(a.crow_indices(), a.col_indices(),
                                       tf32(a.values()), a.shape,
                                       check_invariants=False)


def _refresh(cfg, traffic, ops, names, norms, step, prog_plans,
             record) -> dict:
    n_cb = ops.n_pad // ops.block
    layers = []
    for l in names:
        g = norms[l].astype(np.float64)
        s = block_scores(ops.col_norm, g[:ops.n], ops.block, n_cb)
        gfro = float(np.sqrt(np.sum(g * g)))
        layers.append((s, ops.col_block_tiles,
                       spmm_width(cfg, cfg["classes"], l),
                       ops.fro * max(gfro, 1e-30)))
    ref_keep, budget = greedy_allocate(layers, traffic["budget"],
                                       traffic["step_frac"])
    prog = None if prog_plans is None else prog_plans.get(step)
    prog_keep = None if prog is None else [prog.get(l) for l in names]
    if prog_keep is not None and any(k is None for k in prog_keep):
        prog_keep = None
    ok, gap = judge_plan(layers, ref_keep, budget, prog_keep)
    chosen = prog_keep if ok else ref_keep
    record[step] = {"gap": gap, "followed": "program" if ok and gap > 0
                    else "reference",
                    "kept": [int(k.sum()) for k in ref_keep],
                    "ok": ok, "equal": ok and gap == 0.0,
                    "keep": dict(zip(names, chosen))}
    dev = ops.x.device
    return {l: torch.from_numpy(np.repeat(k, ops.block).astype(np.float32))
            .to(dev) for l, k in zip(names, chosen)}
