"""GNN train/eval steps: the loss, its gradients and the optimizer step.

The port of ``repro.train.steps``. The reference's steps are pure
functions under ``jax.jit``; these run eagerly on the module's device and
update its parameters (and the optimizer's moments) in place. The ∇H row
norms the planner scores with come from the gradient of zero-valued taps
(``models/gnn/common.py``) taken with the parameters' in one
``torch.autograd.grad``; they stay on the device.

Layering, as in the reference: :func:`make_gnn_grads` builds the
gradient functions, :func:`make_gnn_steps` composes them with the
optimizer into single-device steps, and :func:`make_dp_gnn_steps` into
data-parallel ones. There each rank runs its own subgraph, the gradients
are all-reduced over the group (a sum, then a divide by the world size:
the reference's ``pmean``), optionally through the int8 error-feedback
compressor first (per leaf), and every rank applies the same update. The
loss is the mean over ranks; the ∇H row norms stay on their own rank, so
each shard's plan caches refresh from their own gradients.

:class:`GradReducer` holds the all-reduce. Per leaf, one collective per
parameter in the reference's tree order; with ``overlap_allreduce`` the
leaves are cut into the reference's buckets (:func:`bucket_bounds`, the
cumulative-size rule of ``_bucketed_pmean``) and each bucket is one flat
f32 ``all_reduce``, issued asynchronously from the parameters' gradient
hooks as soon as its last leaf's gradient exists, so communication
overlaps the rest of the backward. The mean is element-wise, so either
way the trajectory is the same bit for bit; quantization happens per
leaf, before any bucket is cut. Buckets are issued in one fixed order
(last first, as the backward produces them), whatever order the hooks
fire in, so every rank issues the same sequence of collectives.

Compression and the error state use the reference's layout of each
parameter (``convert.gnn_param_paths``: a linear's ``w`` is ``(d_in,
d_out)``, the transpose of ``nn.Linear.weight``), so codes, blocks and
residuals are the reference's.
"""
from __future__ import annotations

import time
from functools import partial

import torch

from repro_torch import obs
from repro_torch.core.sampling import row_norms
from repro_torch.distributed.compression import ErrorFeedbackCompressor
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

    def _grads(model, ops, tap_names, plans, gen):
        """The loss, the parameters' gradients and the row norms of the
        taps ``tap_names``, under the ``forward`` and ``backward`` spans
        (host and device)."""
        tracer, dev = obs.get_tracer(), ops.features.device
        with tracer.span("forward"), tracer.device_span("forward", dev):
            n_pad = ops.features.shape[0]
            taps = {k: torch.zeros((n_pad, dims[k]), dtype=torch.float32,
                                   device=dev, requires_grad=True)
                    for k in tap_names}
            logits = module.apply(model, ops, taps, plans,
                                  dropout_rate=dropout, train=True,
                                  generator=gen, backend=backend)
            loss = gnn_loss(logits, ops)
        params = dict(model.named_parameters())
        with tracer.span("backward"), tracer.device_span("backward", dev):
            out = torch.autograd.grad(loss,
                                      [*params.values(), *taps.values()])
            norms = {k: row_norms(g)
                     for k, g in zip(taps, out[len(params):])}
        grads = dict(zip(params, out[:len(params)]))
        return loss.detach(), grads, norms

    def rsc_grads(model, ops, plans, gen):
        return _grads(model, ops, rsc_names, plans, gen)

    def exact_grads(model, ops, gen):
        loss, grads, _ = _grads(model, ops, (), None, gen)
        return loss, grads

    @torch.no_grad()
    def eval_logits(model, ops):
        return module.apply(model, ops, {}, None, dropout_rate=0.0,
                            train=False, generator=None, backend=backend)

    return rsc_grads, exact_grads, eval_logits


def _update(opt: Adam, model, opt_state, grads):
    """One optimizer step on ``model``'s parameters, in place, under the
    ``optimizer`` spans (host and device); the new optimizer state."""
    tracer = obs.get_tracer()
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    with tracer.span("optimizer"), tracer.device_span("optimizer", dev):
        upd, opt_state = opt.update(grads, opt_state, params)
        apply_updates(params, upd)
    return opt_state


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

    def rsc_step(model, opt_state, ops, plans, gen):
        loss, grads, norms = rsc_grads(model, ops, plans, gen)
        return model, _update(opt, model, opt_state, grads), loss, norms

    def exact_step(model, opt_state, ops, gen):
        loss, grads = exact_grads(model, ops, gen)
        return model, _update(opt, model, opt_state, grads), loss

    return rsc_step, exact_step, eval_logits


# ---------------------------------------------------------------------------
# Data-parallel steps: one subgraph per rank, all-reduced gradients.
# ---------------------------------------------------------------------------

def bucket_bounds(sizes: list[int], n_buckets: int) -> list[list[int]]:
    """Leaf indices of each bucket: leaves in tree order, cut where the
    cumulative size first reaches each even share of the total (the
    reference's ``_bucketed_pmean`` rule)."""
    if len(sizes) <= 1:
        return [[i] for i in range(len(sizes))]
    n_buckets = max(1, min(n_buckets, len(sizes)))
    total = sum(sizes)
    buckets: list[list[int]] = []
    cur: list[int] = []
    acc = 0
    for i, s in enumerate(sizes):
        cur.append(i)
        acc += s
        if (len(buckets) < n_buckets - 1
                and acc * n_buckets >= total * (len(buckets) + 1)):
            buckets.append(cur)
            cur = []
    if cur:
        buckets.append(cur)
    return buckets


def _issue(leaves: list[torch.Tensor], group):
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
    return flat, group.all_reduce_sum(flat, async_op=True)


def _split(flat: torch.Tensor, leaves: list[torch.Tensor], world: int
           ) -> list[torch.Tensor]:
    flat.div_(world)
    out, off = [], 0
    for t in leaves:
        n = t.numel()
        out.append(flat[off: off + n].reshape(t.shape).to(t.dtype))
        off += n
    return out


def bucketed_all_reduce(grads: dict[str, torch.Tensor], group,
                        n_buckets: int) -> dict[str, torch.Tensor]:
    """The mean over ranks of ``grads`` (leaves in the dict's order, the
    reference's tree order), as ``n_buckets`` flat f32 all-reduces: the
    port of ``_bucketed_pmean``. One leaf or fewer is reduced per leaf."""
    names = list(grads)
    if len(names) <= 1:
        return {n: group.mean_(grads[n].clone()) for n in names}
    out: dict[str, torch.Tensor] = {}
    pending = []
    for idx in bucket_bounds([grads[n].numel() for n in names], n_buckets):
        leaves = [grads[names[i]] for i in idx]
        pending.append((idx, leaves, *_issue(leaves, group)))
    for idx, leaves, flat, work in pending:
        work.wait()
        for i, t in zip(idx, _split(flat, leaves, group.world_size)):
            out[names[i]] = t
    return {n: out[n] for n in names}


def init_error_feedback(model) -> dict[str, torch.Tensor]:
    """Zero error-feedback accumulators of this rank, f32, one per
    parameter in the reference's layout (the rank's row of the
    reference's stacked ``(n_devices, ...)`` state)."""
    from repro_torch.convert import gnn_param_paths
    paths = gnn_param_paths(model)
    return {n: torch.zeros((p.t() if paths[n][1] else p).shape,
                           dtype=torch.float32, device=p.device)
            for n, p in model.named_parameters()}


class GradReducer:
    """One step's gradient all-reduce over a :class:`DPGroup`.

    ``run(grads_fn, model, err, compress)`` calls ``grads_fn()`` (which
    returns ``(loss, grads, ...)``), compresses each leaf when
    ``compress`` (the error state ``err`` in the reference's layout, by
    parameter name), reduces the gradients per leaf or in buckets
    (``overlap_allreduce``: issued from the gradient hooks during the
    backward), and returns ``grads_fn``'s tuple with the mean loss and the
    mean gradients in place of its own, and the new error state.

    Per step it keeps ``last_reduce_ms`` (host clock from the backward's
    return to the reduced gradients; on a card gloo's copies first wait
    for the backward's kernels), ``reduce_ms`` (every step's) and the
    bytes it all-reduces (``f32_bytes``; ``int8_bytes``, what the codes
    and scales of the same leaves would take) and observes
    ``dp.allreduce_ms`` in the registry.
    """

    def __init__(self, model, group, *, compress_block: int = 128,
                 overlap_allreduce: bool = False, overlap_buckets: int = 4):
        from repro_torch.convert import gnn_param_paths
        paths = gnn_param_paths(model)
        named = dict(model.named_parameters())
        self.group = group
        self.names = sorted(named, key=lambda n: paths[n][0])
        self.transposed = {n: paths[n][1] for n in named}
        self.ef = ErrorFeedbackCompressor(block=compress_block)
        self.overlap = overlap_allreduce
        self.buckets = [[self.names[i] for i in idx] for idx in
                        bucket_bounds([named[n].numel() for n in self.names],
                                      overlap_buckets)]
        numel = sum(p.numel() for p in named.values())
        self.f32_bytes = 4 * numel
        self.int8_bytes = sum(
            ErrorFeedbackCompressor.wire_bytes(p.numel(), compress_block)
            for p in named.values())
        self.reduce_ms: list[float] = []

    @property
    def last_reduce_ms(self) -> float | None:
        return self.reduce_ms[-1] if self.reduce_ms else None

    def compress_leaf(self, name: str, g: torch.Tensor, e: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """One leaf through the codec in the reference's layout."""
        if self.transposed[name]:
            deq, e = self.ef.compress_one(g.t(), e)
            return deq.t(), e
        return self.ef.compress_one(g, e)

    def run(self, grads_fn, model, err: dict, compress: bool):
        if self.overlap:
            out, grads, err, ms = self._run_overlapped(grads_fn, model, err,
                                                       compress)
        else:
            out = grads_fn()
            t0 = time.perf_counter()
            grads, err = self._per_leaf(out[1], err, compress)
            ms = (time.perf_counter() - t0) * 1e3
        loss = self.group.mean_(out[0].clone())
        self.reduce_ms.append(ms)
        obs.get_registry().observe("dp.allreduce_ms", ms)
        return (loss, grads, *out[2:]), err

    def _per_leaf(self, grads: dict, err: dict, compress: bool):
        new_err, out = {}, {}
        for n in self.names:
            g = grads[n]
            if compress:
                g, new_err[n] = self.compress_leaf(n, g, err[n])
            out[n] = self.group.mean_(g.contiguous())
        return {n: out[n] for n in grads}, (new_err if compress else err)

    def _run_overlapped(self, grads_fn, model, err: dict, compress: bool):
        ready: dict[str, torch.Tensor] = {}
        new_err: dict[str, torch.Tensor] = {}
        inflight: list = []
        nxt = [len(self.buckets) - 1]

        def issue_ready():
            while nxt[0] >= 0 and all(n in ready
                                      for n in self.buckets[nxt[0]]):
                leaves = [ready[n] for n in self.buckets[nxt[0]]]
                inflight.append((self.buckets[nxt[0]], leaves,
                                 *_issue(leaves, self.group)))
                nxt[0] -= 1

        def hook(name, g):
            if compress:
                g, new_err[name] = self.compress_leaf(name, g, err[name])
            ready[name] = g
            issue_ready()

        named = dict(model.named_parameters())
        handles = [named[n].register_hook(partial(hook, n))
                   for n in self.names]
        try:
            out = grads_fn()
        finally:
            for h in handles:
                h.remove()
        t0 = time.perf_counter()
        if len(ready) != len(self.names):
            missing = sorted(set(self.names) - set(ready))
            raise RuntimeError(f"no gradient hook fired for {missing}")
        reduced: dict[str, torch.Tensor] = {}
        for names, leaves, flat, work in inflight:
            work.wait()
            for n, t in zip(names, _split(flat, leaves,
                                          self.group.world_size)):
                reduced[n] = t
        return (out, {n: reduced[n] for n in out[1]},
                new_err if compress else err,
                (time.perf_counter() - t0) * 1e3)


def make_dp_gnn_steps(module, opt: Adam, dims: dict[str, int], rsc_names,
                      *, dropout: float, backend: str, reducer: GradReducer):
    """Build data-parallel (rsc_step, exact_step, eval_logits).

    Each rank passes its own subgraph's operands and plans and its own
    error-feedback state (by parameter name, the reference's layout):

        rsc_step(model, opt_state, err, ops, plans, gen, compress)
            -> (model, opt_state, loss, norms, err)
        exact_step(model, opt_state, err, ops, gen, compress)
            -> (model, opt_state, loss, err)

    ``compress`` quantizes each leaf (plus its carried error) to int8
    block codes before the all-reduce and keeps the residual in ``err``;
    the engine passes ``compress=False`` and an empty ``err`` for the
    exact tail (§3.3.2 switch-back applied to the compressor: the carried
    error is frozen, not leaked into the updates). ``loss`` is the mean
    over ranks; ``norms`` are this rank's. ``eval_logits`` is the
    single-device evaluator.
    """
    rsc_grads, exact_grads, eval_logits = make_gnn_grads(
        module, dims, rsc_names, dropout=dropout, backend=backend)

    def rsc_step(model, opt_state, err, ops, plans, gen, compress: bool):
        (loss, grads, norms), err = reducer.run(
            lambda: rsc_grads(model, ops, plans, gen), model, err, compress)
        return model, _update(opt, model, opt_state, grads), loss, norms, err

    def exact_step(model, opt_state, err, ops, gen, compress: bool):
        (loss, grads), err = reducer.run(
            lambda: exact_grads(model, ops, gen), model, err, compress)
        return model, _update(opt, model, opt_state, grads), loss, err

    return rsc_step, exact_step, eval_logits
