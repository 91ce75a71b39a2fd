"""RSC training engine: full batch, a subgraph pool, or a sharded pool over
a data-parallel group.

The port of ``repro.train.engine``. The :class:`Engine` owns

* the :class:`~repro_torch.core.schedule.RSCSchedule` (switch-back §3.3.2
  on the global step counter),
* the plan cache and its refresh clock (§3.3.1) behind a planner
  (:class:`FullGraphPlanner`, or :class:`NullPlanner` without RSC),
* the steps behind a runner: :class:`SingleDeviceRunner`
  (:func:`~repro_torch.train.steps.make_gnn_steps`), or with a group
  :class:`DataParallelRunner` (one process per rank, gradients
  all-reduced over the group, optionally through the int8 error-feedback
  compressor, per leaf or in overlapped buckets:
  :func:`~repro_torch.train.steps.make_dp_gnn_steps`),
* the SpMM autotune warmup (``cfg.autotune``: delegated to the source,
  which knows its shape buckets), before the first step,
* the history (loss, step time, mode, kept blocks, subgraph id, whether
  the step's all-reduce was compressed) and
  evaluation: the source's own, or with ``eval_mode="stream"`` the exact
  streaming full-graph forward (``infer.stream.StreamEvaluator``),
* checkpoints (``cfg.ckpt_dir``: every ``ckpt_every`` steps and at the
  end, in the reference's layout) and step-exact ``restore``,
* observability through the process-wide ``repro_torch.obs`` bundle
  (spans, histograms, the approximation ledger, epoch-end error probes),
  one attribute check per site when it is off.

A data source yields ``(tag, operands)`` batches per epoch — the tag is the
plan-cache identity (``None`` for the full graph, a subgraph id for a
pool) — says how many steps an epoch has and how many shape buckets it
holds, and knows how to evaluate; :class:`FullGraphSource` is the whole
graph as one batch resident on the device,
``pipeline.minibatch_loop.PooledSource`` a prefetched GraphSAINT subgraph
pool, and ``pipeline.sharding.ShardedPoolSource`` one rank's shard of it
(its tag: the tuple of every rank's subgraph id).

Data parallel (``group``): every rank runs this loop in its own process,
in step. Rank 0's parameters are broadcast at the start; every rank then
applies the same mean gradient. ``compress`` follows the reference: on
when ``compress_grads`` and, with switching, only on the RSC steps (the
§3.3.2 switch-back applies to the compressor too). Evaluation runs on rank
0 and its ``(val, test)`` is broadcast, so every rank agrees on ``best``.
Rank 0 alone writes checkpoints, traces and metrics; the planner's and
runner's state is gathered to it first (collectives every rank enters at
the same step). Rank ``r``'s dropout generator is seeded ``seed + 1 +
r``.

Device reads per step: the loss (its value ends the step, and the
``device_step`` span). The ∇H row norms stay on the device until a refresh
is due, when the planner reads the previous step's (every
``refresh_every``-th RSC step); with metrics on, every 16th step also
reads their means for the ``rsc.grad_row_norm`` gauges.

A checkpoint holds ``(params, opt_state)`` as the reference's tree
(``convert.gnn_state_tree``) and an aux dict: the step cursor, the
planner's refresh norms and clocks (under data parallelism a list over
shards), the runner's error-feedback state (``(n_shards, ...)`` per
leaf, or None), the source's order-RNG state, and the dropout
``torch.Generator``'s state under ``torch_generator`` (one row per rank
under data parallelism). The
reference's aux carries its PRNG key under ``key``; the port cannot
continue a JAX key stream, so a checkpoint without ``torch_generator``
(one ``repro`` wrote) restores everything else and leaves the generator
as seeded, and the port writes ``key`` as the reference's key as seeded.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.convert import gnn_state_tree, load_gnn_state
from repro_torch.core.cache import PlanCache, host_norms
from repro_torch.core.schedule import RSCSchedule
from repro_torch.device import resolve_device
from repro_torch.models.gnn import MODELS
from repro_torch.models.gnn.common import build_operands, valid_rows
from repro_torch.obs import context as trace_context
from repro_torch.train.metrics import metric_fn
from repro_torch.train.optimizer import Adam
from repro_torch.train.steps import (GradReducer, init_error_feedback,
                                     make_dp_gnn_steps, make_gnn_steps)


@dataclasses.dataclass
class TrainConfig:
    model: str = "gcn"
    n_layers: int = 3
    hidden: int = 256
    dropout: float = 0.5
    batchnorm: bool = True
    lr: float = 0.01
    epochs: int = 400
    seed: int = 0
    metric: str = "accuracy"
    # RSC
    rsc: bool = False
    budget: float = 0.1
    step_frac: float = 0.02
    refresh_every: int = 10
    rsc_fraction: float = 0.8
    caching: bool = True         # False ⇒ refresh every step (Table 4 ablation)
    switching: bool = True       # False ⇒ rsc for 100% of epochs
    strategy: str = "greedy"     # "uniform" for Fig. 6 baseline
    backend: str = "kernel"      # "kernel" (CUDA kernel / plain version) |
                                 # "ref" (CPU streaming) | "dense" (matmul)
    block: int = 128             # bm == bk
    degree_sort: bool = True
    autotune: bool = False       # sweep the SpMM per shape bucket first
    # Evaluation: "auto" keeps the source's evaluator (full graph / pooled
    # with dedup); "stream" runs the exact streaming full-graph forward
    # (repro_torch/infer), an exact measurement under minibatch training.
    eval_mode: str = "auto"
    stream_partitions: int = 0       # 0 = size by stream_budget_mb
    stream_budget_mb: float = 256.0
    stream_resident_mb: float = 0.0  # >0: device partition LRU budget
    stream_overlap: bool = False     # double-buffer partition uploads
    device: str = "cuda"         # "cpu" runs the kernels' plain versions
    # Checkpointing: save (params, opt_state) + engine state every
    # ``ckpt_every`` global steps and at the end; ``Engine.restore``
    # resumes step-exactly.
    ckpt_dir: str | None = None
    ckpt_every: int = 0
    # Approximation ledger: an allocator run whose achieved cost exceeds
    # its budget raises BudgetError at the next epoch boundary.
    strict_budget: bool = False
    # Online error probes (obs.probe): every ``probe_every`` epochs, an
    # exact-vs-sampled comparison on ``probe_rows`` row blocks per RSC op
    # with a ``probe_dim``-wide Gaussian probe matrix, when metrics or the
    # ledger are on. 0 disables.
    probe_every: int = 1
    probe_rows: int = 8
    probe_dim: int = 8


# ---------------------------------------------------------------------------
# Planners: map batch tags to sampling plans, absorb gradient row norms.
# ---------------------------------------------------------------------------

class NullPlanner:
    """RSC off: no plans, no stats."""

    def plans_for(self, tag, step: int, schedule: RSCSchedule):
        raise RuntimeError("NullPlanner has no plans (rsc disabled)")

    def record(self, tag, norms) -> None:
        pass

    def flops_fraction(self) -> float:
        return 1.0

    def hit_rate(self) -> float | None:
        return None

    def stats(self):
        return None

    def k_latest(self):
        return None

    def publish(self, registry) -> None:
        pass

    def probe_entries(self):
        """(name, at, meta, plan, d) tuples for the error probes."""
        return []

    def state_dict(self):
        return None

    def load_state_dict(self, state) -> None:
        pass


class FullGraphPlanner:
    """One :class:`PlanCache` refreshed on the global schedule clock from
    the previous step's gradient row norms (the full-batch loop's §3.3.1
    behaviour). ``record`` keeps the step's norms on the device; a due
    refresh reads them to the host."""

    def __init__(self, cfg: TrainConfig, module, at, meta, fro: float,
                 n_classes: int, device):
        self.cache = PlanCache(budget_frac=cfg.budget,
                               step_frac=cfg.step_frac,
                               strategy=cfg.strategy, device=device)
        names = module.spmm_names(cfg.n_layers)
        dims = module.spmm_dims(cfg.n_layers, cfg.hidden, n_classes)
        for n in names:
            self.cache.register(n, at, meta, dims[n], fro)
        self._last_norms: dict[str, torch.Tensor] | None = None
        self._refresh_norms: dict[str, np.ndarray] | None = None

    def plans_for(self, tag, step: int, schedule: RSCSchedule):
        if self._last_norms is not None and schedule.refresh_due(step):
            tracer = obs.get_tracer()
            with tracer.span("plan.refresh") as sp:
                with tracer.span("plan.norms"):
                    norms = host_norms(self._last_norms)
                self.cache.refresh(norms)
                self._refresh_norms = norms
                if tracer.enabled:   # each op's kept tiles
                    ops = self.cache.ops.items()
                    sp.set(n_active={n: e.plan.n_active for n, e in ops},
                           s_pad={n: e.plan.s_pad for n, e in ops})
        return self.cache.plans()

    def record(self, tag, norms) -> None:
        self._last_norms = norms

    def flops_fraction(self) -> float:
        return self.cache.flops_fraction()

    def hit_rate(self) -> float | None:
        return None

    def stats(self):
        return self.cache.stats

    def k_latest(self):
        kh = self.cache.stats.k_history
        return kh[-1] if kh else None

    def publish(self, registry) -> None:
        """Plan-cache clock stats → registry gauges (epoch-end dump)."""
        s = self.cache.stats
        registry.gauge("plan_cache.refreshes", s.refreshes)
        registry.gauge("plan_cache.host_seconds", s.host_seconds)
        registry.gauge("rsc.flops_fraction", self.flops_fraction())
        k = self.k_latest()
        if k is not None:
            registry.gauge("rsc.k_latest", float(np.sum(k)))

    def probe_entries(self):
        return [(n, e.at, e.meta, e.plan, e.d)
                for n, e in self.cache.ops.items()]

    def state_dict(self):
        """What a resumed run needs to rebuild the current plans: the
        allocator is a pure function of its latest refresh norms, so
        replaying them reproduces the plans exactly (host arrays; reading
        the last step's norms syncs with the card once)."""
        return {"last_norms": (None if self._last_norms is None
                               else host_norms(self._last_norms)),
                "refresh_norms": self._refresh_norms,
                "refreshes": self.cache.stats.refreshes}

    def load_state_dict(self, state) -> None:
        if state is None:
            return
        if state.get("refresh_norms") is not None:
            self.cache.refresh(state["refresh_norms"])
            self._refresh_norms = state["refresh_norms"]
        self.cache.stats.refreshes = state.get("refreshes",
                                               self.cache.stats.refreshes)
        self._last_norms = state.get("last_norms")


# ---------------------------------------------------------------------------
# Runners: execute one optimizer step (single device / data parallel).
# ---------------------------------------------------------------------------

class SingleDeviceRunner:
    """The single-device steps (full batch and minibatch)."""

    supports_compression = False

    def __init__(self, module, opt, dims, names, *, dropout: float,
                 backend: str):
        self._rsc, self._exact, self.eval_logits = make_gnn_steps(
            module, opt, dims, names, dropout=dropout, backend=backend)

    def rsc_step(self, model, opt_state, ops, plans, gen,
                 compress: bool = False):
        return self._rsc(model, opt_state, ops, plans, gen)

    def exact_step(self, model, opt_state, ops, gen, compress: bool = False):
        return self._exact(model, opt_state, ops, gen)

    def state_dict(self):
        return None

    def load_state_dict(self, state) -> None:
        pass


class DataParallelRunner:
    """Data-parallel steps over a ``DPGroup``: this rank's subgraph, the
    gradients all-reduced (optionally int8-compressed with error feedback
    first). Holds this rank's error-feedback accumulators, allocated on
    the first compressed step; uncompressed steps pass an empty dict."""

    supports_compression = True

    def __init__(self, module, opt, dims, names, *, dropout: float,
                 backend: str, group, model, compress_block: int = 128,
                 overlap_allreduce: bool = False, overlap_buckets: int = 4):
        from repro_torch.convert import gnn_param_paths
        self.group = group
        self.reducer = GradReducer(
            model, group, compress_block=compress_block,
            overlap_allreduce=overlap_allreduce,
            overlap_buckets=overlap_buckets)
        self._rsc, self._exact, self.eval_logits = make_dp_gnn_steps(
            module, opt, dims, names, dropout=dropout, backend=backend,
            reducer=self.reducer)
        self._paths = gnn_param_paths(model)
        self._err: dict[str, torch.Tensor] | None = None

    def _err_state(self, model, compress: bool) -> dict:
        if not compress:
            return {}
        if self._err is None:
            self._err = init_error_feedback(model)
        return self._err

    def rsc_step(self, model, opt_state, ops, plans, gen,
                 compress: bool = False):
        compress = bool(compress)
        model, opt_state, loss, norms, err = self._rsc(
            model, opt_state, self._err_state(model, compress), ops, plans,
            gen, compress)
        if compress:
            self._err = err
        return model, opt_state, loss, norms

    def exact_step(self, model, opt_state, ops, gen, compress: bool = False):
        compress = bool(compress)
        model, opt_state, loss, err = self._exact(
            model, opt_state, self._err_state(model, compress), ops, gen,
            compress)
        if compress:
            self._err = err
        return model, opt_state, loss

    def state_dict(self):
        """The error-feedback accumulators in the reference's layout:
        its params tree, each leaf ``(n_shards, ...)`` (host arrays), or
        None before the first compressed step. A collective."""
        if self._err is None:
            return None
        from repro_torch.convert import _nest
        rows = self.group.gather_objects(
            {n: t.cpu().numpy() for n, t in self._err.items()})
        return _nest({self._paths[n][0]: np.stack([r[n] for r in rows])
                      for n in self._err})

    def load_state_dict(self, state) -> None:
        """This rank's row of a saved error-feedback state."""
        if state is None:
            return
        from repro_torch.convert import _get
        self._err = {
            n: torch.tensor(np.asarray(_get(state, path))[self.group.rank],
                            device=self.group.device)
            for n, (path, _) in self._paths.items()}


# ---------------------------------------------------------------------------
# Full-graph data source.
# ---------------------------------------------------------------------------

class FullGraphSource:
    """The whole graph as one batch, resident on the device, every step."""

    n_buckets = 1
    steps_per_epoch = 1

    def __init__(self, graph, cfg: TrainConfig, module):
        self.device = resolve_device(cfg.device)
        with obs.get_tracer().span("operands"):
            self.ops, self.meta = build_operands(
                graph, bm=cfg.block, bk=cfg.block,
                degree_sort=cfg.degree_sort,
                mean_agg=module.uses_mean_agg(), device=self.device)
        self.num_classes = graph.num_classes
        self.feat_dim = graph.features.shape[1]
        self.mean_agg = module.uses_mean_agg()
        # host copies for evaluation, read once
        valid = valid_rows(self.ops).cpu().numpy()
        self._labels = self.ops.labels.cpu().numpy()
        self._val = self.ops.val_mask.cpu().numpy() & valid
        self._test = self.ops.test_mask.cpu().numpy() & valid

    def planner_operand(self):
        """(at, meta, fro) of the backward operand the planner scores:
        (D⁻¹A)ᵀ for a mean-aggregating model (GraphSAGE), Ãᵀ otherwise."""
        if self.mean_agg:
            return self.ops.amt, self.meta.amt_meta, self.meta.am_fro
        return self.ops.at, self.meta.at_meta, self.meta.a_fro

    def warmup(self, cfg, dims, n_classes) -> None:
        pass

    def batches(self, epoch: int, skip: int = 0):
        if skip == 0:
            yield None, self.ops

    def state_dict(self):
        return None

    def load_state_dict(self, state) -> None:
        pass

    def evaluate(self, eval_fn, mfn, model) -> tuple[float, float]:
        tracer = obs.get_tracer()
        with tracer.span("eval.logits"):
            with tracer.device_span("eval", self.device):
                logits = eval_fn(model, self.ops)
            logits = logits.cpu().numpy()
        with tracer.span("eval.score"):
            return (mfn(logits, self._labels, self._val),
                    mfn(logits, self._labels, self._test))


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------

class Engine:
    """The training loop: schedule, planner clock, steps, evaluation.

    ``model`` (an ``nn.Module`` of ``cfg.model`` on the source's device)
    replaces the seeded initial parameters, e.g. with the reference's
    carried across by ``convert.gnn_params_from_numpy``. ``graph`` (the
    full graph) is what ``eval_mode="stream"`` evaluates on. ``group`` (a
    ``distributed.group.DPGroup``) makes this rank's engine data parallel:
    the source must then be a sharded one, and ``compress_grads``,
    ``compress_block``, ``overlap_allreduce`` and ``overlap_buckets``
    shape the all-reduce.
    """

    def __init__(self, cfg: TrainConfig, source, *, planner=None,
                 model=None, graph=None, group=None,
                 compress_grads: bool = False, compress_block: int = 128,
                 overlap_allreduce: bool = False, overlap_buckets: int = 4):
        self.cfg = cfg
        self.source = source
        self.module = MODELS[cfg.model]
        self.planner = planner if planner is not None else NullPlanner()
        self.group = group
        self.rank = group.rank if group is not None else 0
        self.compress_grads = compress_grads
        self.n_classes = source.num_classes
        self.model = model if model is not None else self.module.init(
            source.feat_dim, cfg.hidden, self.n_classes, cfg.n_layers,
            cfg.batchnorm, seed=cfg.seed, device=source.device)
        if group is not None:
            with torch.no_grad():
                for p in self.model.parameters():
                    group.broadcast_(p.data, src=0)
        self.opt = Adam(lr=cfg.lr)
        self.opt_state = self.opt.init(dict(self.model.named_parameters()))

        rsc_frac = cfg.rsc_fraction if cfg.switching else 1.0
        refresh = cfg.refresh_every if cfg.caching else 1
        self.schedule = RSCSchedule(
            total_steps=cfg.epochs * source.steps_per_epoch,
            rsc_fraction=rsc_frac,
            refresh_every=refresh, allocate_every=refresh)

        names = self.module.spmm_names(cfg.n_layers)
        dims = self.module.spmm_dims(cfg.n_layers, cfg.hidden,
                                     self.n_classes)
        # Autotune warmup before the first step: dispatch reads the tuned
        # configs from the process-wide cache at every launch.
        if cfg.autotune:
            source.warmup(cfg, dims, self.n_classes)
        if group is not None:
            self.runner = DataParallelRunner(
                self.module, self.opt, dims, names, dropout=cfg.dropout,
                backend=cfg.backend, group=group, model=self.model,
                compress_block=compress_block,
                overlap_allreduce=overlap_allreduce,
                overlap_buckets=overlap_buckets)
        else:
            self.runner = SingleDeviceRunner(
                self.module, self.opt, dims, names, dropout=cfg.dropout,
                backend=cfg.backend)
        self.rsc_step = self.runner.rsc_step
        self.exact_step = self.runner.exact_step
        self.eval_logits = self.runner.eval_logits

        # Streaming full-graph evaluator: exact accuracy even when the
        # source's own evaluator only covers pooled nodes.
        self.stream_eval = None
        if cfg.eval_mode == "stream":
            if graph is None:
                raise ValueError('eval_mode="stream" needs the full graph '
                                 "(pass graph= to the engine factory)")
            from repro_torch.infer.stream import (StreamConfig,
                                                  StreamEvaluator)
            self.stream_eval = StreamEvaluator(
                graph, cfg.model,
                StreamConfig(
                    block=cfg.block,
                    n_partitions=cfg.stream_partitions or None,
                    memory_budget_mb=(None if cfg.stream_partitions
                                      else cfg.stream_budget_mb),
                    backend=cfg.backend, degree_sort=cfg.degree_sort,
                    resident_mb=cfg.stream_resident_mb or None,
                    overlap=cfg.stream_overlap,
                    device=str(source.device)))
        elif cfg.eval_mode != "auto":
            raise ValueError(f"unknown eval_mode {cfg.eval_mode!r} "
                             "(expected 'auto' or 'stream')")
        self.obs = obs.get_obs()
        # Approximation ledger: per-op hidden dims + tile shape give it the
        # FLOPs/bytes cost model; everything else arrives as events.
        self.ledger = self.obs.ledger
        self.ledger.set_dims(dims, bm=cfg.block, bk=cfg.block)
        self.ckpt = None
        self._ckpt_base = 0   # step offset after restore(): saved step
                              # numbers keep increasing across restarts
        self._resume = None   # aux dict of an exact restore, one-shot
        self._epoch_src_state = None
        if cfg.ckpt_dir:
            from repro_torch.checkpoint import Checkpointer
            self.ckpt = Checkpointer(cfg.ckpt_dir)
        self.history: dict[str, list] = {
            "loss": [], "val": [], "test": [], "step_time": [],
            "mode": [], "k": [], "sub_id": [], "compress": []}

    # ------------------------------------------------------------------
    def _capture_state(self, epoch: int, batch_idx: int, gstep: int, gen,
                       best: tuple[float, float]) -> dict:
        """Engine state beside a (params, opt_state) snapshot: enough to
        make restore step-exact (planner clocks and refresh norms, the
        runner's error feedback, the source's epoch-start order-RNG state,
        the dropout generator). Python and numpy values only, so ``repro``
        can unpickle it. Under data parallelism every rank calls it (the
        planner's, runner's and generators' states are gathered)."""
        gen_state = gen.get_state().numpy().copy()
        if self.group is not None:
            gen_state = np.stack(self.group.gather_objects(gen_state))
        return {
            "gstep": gstep, "epoch": epoch, "batch_idx": batch_idx,
            "key": _seeded_key(self.cfg.seed + 1), "best": best,
            "source": self._epoch_src_state,
            "planner": self.planner.state_dict(),
            "runner": self.runner.state_dict(),
            "torch_generator": gen_state,
        }

    def _save(self, step: int, aux: dict) -> None:
        if self.rank == 0:
            self.ckpt.save(step, gnn_state_tree(self.model, self.opt_state),
                           aux=aux)

    def restore(self, step: int | None = None) -> int | None:
        """Restore (params, opt_state) from a checkpoint (the latest, or
        ``step``), placed on the source's device.

        When the checkpoint carries engine state (this engine's own
        ``train`` loop saved it, or ``repro``'s), the restore is
        step-exact: the next ``train`` call continues mid-epoch at the
        saved cursor with the saved plans and clocks, and with the saved
        dropout generator when the checkpoint has one (the port's own).
        Without aux state it is a warm start. Returns the checkpoint
        step, or None if there is none.
        """
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return None
        step = step if step is not None else self.ckpt.latest_step()
        aux = self.ckpt.load_aux(step)
        world = self.group.world_size if self.group is not None else 1
        saved = saved_shards(aux) if aux is not None else None
        if saved is not None and saved != world:
            raise ValueError(
                f"the checkpoint of step {step} holds the engine state of "
                f"{saved} data-parallel shard(s), this run has {world} "
                f"rank(s): restore it on {saved} (the state is not "
                "re-sharded)")
        step, tree = self.ckpt.restore(
            gnn_state_tree(self.model, self.opt_state), step=step,
            device=self.source.device)
        self.opt_state = load_gnn_state(self.model, self.opt_state, tree)
        if aux is not None:
            self.planner.load_state_dict(aux.get("planner"))
            self.runner.load_state_dict(aux.get("runner"))
            self.source.load_state_dict(aux.get("source"))
            self._resume = aux
            self._ckpt_base = step - aux["gstep"]
        else:
            self._ckpt_base = step
        return step

    # ------------------------------------------------------------------
    def train(self, epochs: int | None = None, eval_every: int = 10,
              verbose: bool = False) -> dict:
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        total = epochs * self.source.steps_per_epoch
        if total != self.schedule.total_steps:
            # keep the switch-back fraction relative to the run actually
            # executed, not the configured one
            self.schedule = dataclasses.replace(
                self.schedule, total_steps=total)
        gen = torch.Generator(device=self.source.device)
        gen.manual_seed(cfg.seed + 1 + self.rank)
        mfn = metric_fn(cfg.metric)
        best_val, best_test = -1.0, -1.0
        gstep = 0
        start_epoch, skip = 0, 0
        self._epoch_src_state = None
        if self._resume is not None:
            # Step-exact continuation from restore(): re-enter the saved
            # epoch at the saved batch cursor. The source re-draws its
            # epoch permutation from the restored epoch-start RNG state,
            # so the skipped prefix is the one the saved run consumed.
            r, self._resume = self._resume, None
            start_epoch, skip = r["epoch"], r["batch_idx"]
            gstep = r["gstep"]
            if r.get("torch_generator") is not None:
                state = np.asarray(r["torch_generator"], np.uint8)
                if state.ndim == 2:          # one row per rank
                    state = state[self.rank]
                gen.set_state(torch.from_numpy(state.copy()))
            best_val, best_test = r["best"]

        reg, tracer = self.obs.registry, self.obs.tracer
        ledger = self.ledger
        for epoch in range(start_epoch, epochs):
            ledger.set_epoch(epoch)
            self._epoch_src_state = self.source.state_dict()
            batch_it = enumerate(self.source.batches(epoch, skip=skip),
                                 start=skip)
            while True:
                if tracer.enabled:
                    trace_context.take_pending()   # drop any stale baton
                try:
                    bidx, (tag, ops) = next(batch_it)
                except StopIteration:
                    break
                # The prefetcher leaves the batch's trace context as this
                # thread's pending baton just before yielding; adopting it
                # links the step span to the upload span that produced
                # its operands.
                step_ctx = (trace_context.take_pending()
                            if tracer.enabled else None)
                approx = self.schedule.use_rsc(gstep)
                use_rsc = cfg.rsc and approx
                compress = (self.compress_grads
                            and self.runner.supports_compression
                            and (approx if cfg.switching else True))
                mode = "rsc" if use_rsc else "exact"
                t0 = time.perf_counter()
                with tracer.span_in(step_ctx, "step", step=gstep,
                                    epoch=epoch, mode=mode):
                    if use_rsc:
                        with tracer.span("plan"):
                            plans = self.planner.plans_for(
                                tag, gstep, self.schedule)
                        with tracer.span("device_step", mode=mode):
                            self.model, self.opt_state, lv, norms = \
                                self.rsc_step(self.model, self.opt_state,
                                              ops, plans, gen, compress)
                            with tracer.span("loss_read"):
                                loss = float(lv)   # the step's one read
                        self.planner.record(tag, norms)
                        if ledger.enabled:
                            tiles = {n: p.n_active for n, p in plans.items()}
                            if self.group is not None:   # every rank's
                                tiles = dict(zip(tiles, self.group.sum_ints(
                                    list(tiles.values()))))
                            ledger.note_step(mode="rsc", tiles_by_op=tiles)
                        # Every 16th step: the gauges are last-write-wins,
                        # and reading the norms' means syncs with the card.
                        if reg.enabled and gstep % 16 == 0:
                            self._record_rsc_gauges(reg, norms)
                    else:
                        with tracer.span("device_step", mode=mode):
                            self.model, self.opt_state, lv = \
                                self.exact_step(self.model, self.opt_state,
                                                ops, gen, compress)
                            with tracer.span("loss_read"):
                                loss = float(lv)
                        if ledger.enabled:
                            ledger.note_step(mode="exact")
                    # the loss read synchronised: anchor the step's device
                    # spans to the host clock
                    tracer.resolve_device()
                    dt = time.perf_counter() - t0
                reg.observe("engine.step_ms", dt * 1e3, mode=mode)

                self.history["step_time"].append(dt)
                self.history["loss"].append(loss)
                self.history["mode"].append(mode)
                self.history["compress"].append(bool(compress))
                if tag is not None:
                    self.history["sub_id"].append(
                        tag if isinstance(tag, int) else tuple(tag))
                if use_rsc:
                    k = self.planner.k_latest()
                    if k is not None:
                        self.history["k"].append(k)
                gstep += 1
                if (self.ckpt is not None and cfg.ckpt_every > 0
                        and gstep % cfg.ckpt_every == 0):
                    self._save(self._ckpt_base + gstep, self._capture_state(
                        epoch, bidx + 1, gstep, gen, (best_val, best_test)))
            skip = 0
            if self.obs.enabled:
                self.planner.publish(reg)
            if (cfg.rsc and cfg.probe_every > 0
                    and epoch % cfg.probe_every == 0
                    and (reg.enabled or ledger.enabled)):
                self._run_probes(epoch, reg)
            if ledger.enabled:
                ledger.end_epoch(epoch, reg)
            ledger.check(f"epoch {epoch}", hard_fail=cfg.strict_budget)

            if epoch % eval_every == 0 or epoch == epochs - 1:
                with tracer.span("eval", epoch=epoch), \
                        reg.timer("engine.eval_ms"):
                    val, test = self.evaluate(mfn)
                tracer.resolve_device()
                reg.gauge("engine.val_metric", val)
                reg.gauge("engine.test_metric", test)
                self.history["val"].append((epoch, val))
                self.history["test"].append((epoch, test))
                if val > best_val:
                    best_val, best_test = val, test
                if verbose and self.rank == 0:
                    # the resumed tail of a finished run has no new steps
                    loss_s = (f"{self.history['loss'][-1]:.4f} "
                              if self.history["loss"] else "---- ")
                    mode_s = (self.history["mode"][-1]
                              if self.history["mode"] else "none")
                    print(f"epoch {epoch:4d} loss {loss_s}"
                          f"val {val:.4f} test {test:.4f} mode={mode_s}")

        if self.ckpt is not None:
            # The final snapshot is "last epoch fully consumed": resuming
            # it replays the last epoch's (empty) batch tail, so the
            # source's RNG stream stays aligned if training continues.
            self._save(self._ckpt_base + gstep, self._capture_state(
                max(epochs - 1, 0), self.source.steps_per_epoch, gstep, gen,
                (best_val, best_test)))
            self.ckpt.wait()

        return {
            "best_val": best_val,
            "best_test": best_test,
            "history": self.history,
            "cache_stats": self.planner.stats(),
            "plan_hit_rate": self.planner.hit_rate(),
            "flops_fraction": (self.planner.flops_fraction()
                               if cfg.rsc else 1.0),
            "n_buckets": self.source.n_buckets,
            "ledger": (self.ledger.summary()
                       if self.ledger.enabled else None),
        }

    # ------------------------------------------------------------------
    def _run_probes(self, epoch: int, reg) -> None:
        """Epoch-end exact-vs-sampled error probes on every RSC op, on the
        host (``obs.probe``; only the probed rows' tiles leave the card).
        Results feed the ledger's epoch row and the per-layer gauges."""
        from repro_torch.obs.probe import probe_plan_error
        cfg = self.cfg
        entries = self.planner.probe_entries()
        if not entries:
            return
        with self.obs.tracer.span("probe", epoch=epoch):
            for name, at, meta, plan, d in entries:
                if plan is None:
                    continue
                res = probe_plan_error(
                    at.blocks, meta, plan,
                    bm=at.bm, bk=at.bk, n_cols=at.n_col_blocks * at.bk,
                    op=name, n_rows=cfg.probe_rows,
                    d_probe=cfg.probe_dim, seed=cfg.seed + epoch)
                if res is None:
                    continue
                self.ledger.note_probe(name, rel_error=res.mean,
                                       ci_lo=res.ci_lo, ci_hi=res.ci_hi,
                                       n_rows=res.n_rows)
                if reg.enabled:
                    reg.gauge("rsc.probe.rel_error", res.mean, layer=name)
                    reg.gauge("rsc.probe.ci_lo", res.ci_lo, layer=name)
                    reg.gauge("rsc.probe.ci_hi", res.ci_hi, layer=name)

    @staticmethod
    def _record_rsc_gauges(reg, norms) -> None:
        """Per-op mean ∇H row norm gauges (one read from the card per op):
        a layer that no block of its backward reaches reads 0."""
        for name, v in norms.items():
            reg.gauge("rsc.grad_row_norm", float(v.float().mean()),
                      op=name)

    def evaluate(self, mfn=None) -> tuple[float, float]:
        """The source's evaluation, or the streamed one; under data
        parallelism rank 0 evaluates and broadcasts ``(val, test)`` (every
        rank calls this)."""
        mfn = mfn or metric_fn(self.cfg.metric)
        if self.group is not None:
            res = self._evaluate(mfn) if self.rank == 0 else None
            return tuple(self.group.broadcast_object(res))
        return self._evaluate(mfn)

    def _evaluate(self, mfn) -> tuple[float, float]:
        if self.stream_eval is not None:
            return self.stream_eval.evaluate(self.model, mfn)
        return self.source.evaluate(self.eval_logits, mfn, self.model)


def saved_shards(aux: dict) -> int | None:
    """The number of data-parallel shards whose engine state a
    checkpoint's ``aux`` holds: the planner's list of shards, the dropout
    generators' rows, the error feedback's leading axis (1 for a
    single-device run's state), or None where it holds no such state."""
    planner, gen = aux.get("planner"), aux.get("torch_generator")
    if isinstance(planner, list):
        return len(planner)
    if gen is not None:
        return len(gen) if np.ndim(gen) == 2 else 1
    runner = aux.get("runner")
    while isinstance(runner, (dict, list, tuple)) and runner:
        runner = next(iter(runner.values())) if isinstance(runner, dict) \
            else runner[0]
    if runner is not None and np.ndim(runner) > 0:
        return int(np.shape(runner)[0])
    return 1 if isinstance(planner, dict) else None


def _seeded_key(seed: int) -> np.ndarray:
    """The reference's ``jax.random.PRNGKey(seed)`` (threefry: the seed's
    high and low 32 bits), written into the aux of the port's checkpoints
    so that ``repro`` can continue one with its key as seeded."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    dtype=np.uint32)


def full_batch_engine(cfg: TrainConfig, graph, *, model=None) -> Engine:
    """The full-batch trainer as an Engine configuration."""
    if cfg.model not in MODELS:
        raise ValueError(f"unknown model {cfg.model!r} (expected one of "
                         f"{sorted(MODELS)})")
    module = MODELS[cfg.model]
    source = FullGraphSource(graph, cfg, module)
    planner = None
    if cfg.rsc:
        at, meta, fro = source.planner_operand()
        planner = FullGraphPlanner(cfg, module, at, meta, fro,
                                   source.num_classes, source.device)
    return Engine(cfg, source, planner=planner, model=model, graph=graph)
