"""RSC training engine (single device): full batch or a subgraph pool.

The port of ``repro.train.engine``'s single-device parts. The
:class:`Engine` owns

* the :class:`~repro_torch.core.schedule.RSCSchedule` (switch-back §3.3.2
  on the global step counter),
* the plan cache and its refresh clock (§3.3.1) behind a planner
  (:class:`FullGraphPlanner`, or :class:`NullPlanner` without RSC),
* the steps (``rsc_step``, ``exact_step``, ``eval_logits`` from
  :func:`~repro_torch.train.steps.make_gnn_steps`; the reference's
  ``SingleDeviceRunner`` holds them, and the port has no other runner yet),
* the SpMM autotune warmup (``cfg.autotune``: delegated to the source,
  which knows its shape buckets), before the first step,
* the history (loss, step time, mode, kept blocks, subgraph id) and
  evaluation: the source's own, or with ``eval_mode="stream"`` the exact
  streaming full-graph forward (``infer.stream.StreamEvaluator``).

A data source yields ``(tag, operands)`` batches per epoch — the tag is the
plan-cache identity (``None`` for the full graph, a subgraph id for a
pool) — says how many steps an epoch has and how many shape buckets it
holds, and knows how to evaluate; :class:`FullGraphSource` is the whole
graph as one batch resident on the device, and
``pipeline.minibatch_loop.PooledSource`` a prefetched GraphSAINT subgraph
pool. Data parallelism, checkpoints and probes are not ported yet
(ROADMAP.md Queue 1 items 5, 6 and 8).

Device reads per step: the loss (its value ends the step). The ∇H row
norms stay on the device until a refresh is due, when the planner reads
the previous step's (every ``refresh_every``-th RSC step).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.cache import PlanCache
from repro_torch.core.schedule import RSCSchedule
from repro_torch.device import resolve_device
from repro_torch.models.gnn import MODELS
from repro_torch.models.gnn.common import build_operands, valid_rows
from repro_torch.train.metrics import metric_fn
from repro_torch.train.optimizer import Adam
from repro_torch.train.steps import make_gnn_steps


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
    device: str = "cuda"         # "cpu" runs the kernels' plain versions


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

    def plans_for(self, tag, step: int, schedule: RSCSchedule):
        if self._last_norms is not None and schedule.refresh_due(step):
            self.cache.refresh({k: v.cpu().numpy()
                                for k, v in self._last_norms.items()})
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


# ---------------------------------------------------------------------------
# Full-graph data source.
# ---------------------------------------------------------------------------

class FullGraphSource:
    """The whole graph as one batch, resident on the device, every step."""

    n_buckets = 1
    steps_per_epoch = 1

    def __init__(self, graph, cfg: TrainConfig, module):
        self.device = resolve_device(cfg.device)
        self.ops, self.meta = build_operands(
            graph, bm=cfg.block, bk=cfg.block, degree_sort=cfg.degree_sort,
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

    def batches(self, epoch: int):
        yield None, self.ops

    def evaluate(self, eval_fn, mfn, model) -> tuple[float, float]:
        logits = eval_fn(model, self.ops).cpu().numpy()
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
    full graph) is what ``eval_mode="stream"`` evaluates on.
    """

    def __init__(self, cfg: TrainConfig, source, *, planner=None,
                 model=None, graph=None):
        self.cfg = cfg
        self.source = source
        self.module = MODELS[cfg.model]
        self.planner = planner if planner is not None else NullPlanner()
        self.n_classes = source.num_classes
        self.model = model if model is not None else self.module.init(
            source.feat_dim, cfg.hidden, self.n_classes, cfg.n_layers,
            cfg.batchnorm, seed=cfg.seed, device=source.device)
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
        self.rsc_step, self.exact_step, self.eval_logits = make_gnn_steps(
            self.module, self.opt, dims, names,
            dropout=cfg.dropout, backend=cfg.backend)

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
                    backend=cfg.backend, device=str(source.device)))
        elif cfg.eval_mode != "auto":
            raise ValueError(f"unknown eval_mode {cfg.eval_mode!r} "
                             "(expected 'auto' or 'stream')")
        self.history: dict[str, list] = {
            "loss": [], "val": [], "test": [], "step_time": [],
            "mode": [], "k": [], "sub_id": []}

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
        gen.manual_seed(cfg.seed + 1)
        mfn = metric_fn(cfg.metric)
        best_val, best_test = -1.0, -1.0
        gstep = 0
        for epoch in range(epochs):
            for tag, ops in self.source.batches(epoch):
                use_rsc = cfg.rsc and self.schedule.use_rsc(gstep)
                t0 = time.perf_counter()
                if use_rsc:
                    plans = self.planner.plans_for(tag, gstep, self.schedule)
                    self.model, self.opt_state, lv, norms = \
                        self.rsc_step(self.model, self.opt_state, ops,
                                      plans, gen)
                    self.planner.record(tag, norms)
                else:
                    self.model, self.opt_state, lv = self.exact_step(
                        self.model, self.opt_state, ops, gen)
                loss = float(lv)   # the step's one read from the device
                self.history["step_time"].append(time.perf_counter() - t0)
                self.history["loss"].append(loss)
                self.history["mode"].append("rsc" if use_rsc else "exact")
                if tag is not None:
                    self.history["sub_id"].append(tag)
                if use_rsc:
                    k = self.planner.k_latest()
                    if k is not None:
                        self.history["k"].append(k)
                gstep += 1

            if epoch % eval_every == 0 or epoch == epochs - 1:
                val, test = self.evaluate(mfn)
                self.history["val"].append((epoch, val))
                self.history["test"].append((epoch, test))
                if val > best_val:
                    best_val, best_test = val, test
                if verbose:
                    print(f"epoch {epoch:4d} loss "
                          f"{self.history['loss'][-1]:.4f} val {val:.4f} "
                          f"test {test:.4f} mode={self.history['mode'][-1]}")

        return {
            "best_val": best_val,
            "best_test": best_test,
            "history": self.history,
            "cache_stats": self.planner.stats(),
            "plan_hit_rate": self.planner.hit_rate(),
            "flops_fraction": (self.planner.flops_fraction()
                               if cfg.rsc else 1.0),
            "n_buckets": self.source.n_buckets,
        }

    def evaluate(self, mfn=None) -> tuple[float, float]:
        mfn = mfn or metric_fn(self.cfg.metric)
        if self.stream_eval is not None:
            return self.stream_eval.evaluate(self.model, mfn)
        return self.source.evaluate(self.eval_logits, mfn,
                                    self.model)


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
