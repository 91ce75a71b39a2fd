"""The ``gnn`` family: full-batch GCN and GraphSAGE training with RSC.

A configuration (``configs/<config>.json``) holds the model, its widths
and the synthetic graph; a traffic mix (``traffic/<traffic>.json``) the
training job: epochs, the RSC schedule, evaluation.

Set-up makes the graph from the seed (``gb_graph``), builds the program's
``FullGraphSource`` once (operands built and uploaded), and warms up with
one short training that runs RSC steps, a plan refresh, exact steps and
evaluations. A job of the window is one whole training: a fresh ``Engine``
over that source (new parameters made on the device from the seed and the
training's index, Adam state, planner, schedule), through
``Engine.train``; the unfinished training stops before its next step. The
followed job keeps its losses, first gradient, parameters after the
followed steps, evaluation logits and plan refreshes as the window
produces them; the check follows them with the plain reference
(``gb_reference.follow``) and compares (``gb_check.compare``).
"""
from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time

import numpy as np
import torch

import gb_check
import gb_graph
import gb_reference
import gb_work

NAMES = gb_check.NAMES
# The warm-up training's index: no training of a window has it.
WARMUP_INDEX = 1 << 32
# The plan refreshes the reference follows. Under GCN's first plan no
# gradient flows (Alg. 1 drops every block of the output layer's
# backward); the later plans give blocks back.
REFRESHES = 3
# The cut of every width, the graph to a few hundred nodes and a training
# to 30 epochs for the CPU tests: the first plan refresh (step 10), the
# switch-back (step 24) and evaluations stay in.
TINY = {"nodes": 640, "feat_dim": 24, "hidden": 16, "block": 32,
        "avg_degree": 12.0}


class WindowClosed(Exception):
    """Raised before a step that would start after the window's end."""


# ------------------------------------------------------------- the cell

def check_config(config: dict) -> None:
    """Raises ``KeyError`` where a key the run takes is missing."""
    model_cfg(config)


def tiny(cell: dict, **traffic) -> dict:
    """The cell cut to the CPU tests' size (in place)."""
    cell["config"].update(TINY)
    cell["traffic"].update({"epochs": 30, **traffic})
    return cell


def model_cfg(config: dict) -> dict:
    """The keys the reference and the work counts take."""
    return {k: config[k] for k in ("model", "n_layers", "hidden", "batchnorm",
                                   "dropout", "lr", "block", "feat_dim",
                                   "classes")}


def follow_steps(traffic: dict) -> list[int]:
    """The steps the reference follows: 0-2; with RSC, for each of the
    first ``REFRESHES`` plan refreshes before the switch-back, the step
    whose gradients it scores, its own step and two more under its plan;
    with the switch-back, its first exact step and the next."""
    if not traffic["rsc"]:
        return [0, 1, 2]
    r = gb_reference.refresh_every(traffic)
    back = (int(traffic["epochs"] * traffic["rsc_fraction"])
            if traffic["switching"] else traffic["epochs"])
    out = [0, 1, 2]
    for k in range(1, REFRESHES + 1):
        if k * r < back:
            out += [k * r - 1, k * r, k * r + 1, k * r + 2]
    if traffic["switching"]:
        out += [back, back + 1]
    return sorted(set(out))


def eval_epochs(traffic: dict) -> list[int]:
    """The evaluations the reference judges: those after a followed
    step."""
    return [e for e in follow_steps(traffic)
            if e % traffic["eval_every"] == 0]


def training_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([seed % 2**63, index])
               .generate_state(1, np.uint64)[0] >> 2)


# ------------------------------------------------------------- inputs

def init_weights(cfg: dict, seed: int, device) -> dict:
    """He-normal weights ``N(0, 2 / d_in)``, zero biases, batchnorm scale 1
    and shift 0, under the reference's leaf names: one draw on the device
    for all weights."""
    shapes = gb_reference.leaf_shapes(cfg, cfg["classes"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ws = [k for k in shapes if k.endswith(".w")]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in ws), generator=gen,
                       device=device)
    out, off = {}, 0
    for k, shp in shapes.items():
        if k.endswith(".w"):
            n = math.prod(shp)
            out[k] = flat[off:off + n].view(shp) * math.sqrt(2.0 / shp[0])
            off += n
        elif k.startswith("bn.") and k.endswith(".g"):
            out[k] = torch.ones(shp, device=device)
        else:
            out[k] = torch.zeros(shp, device=device)
    return out


def program_tree(cfg: dict, w: dict) -> dict:
    """The weights as the program's loader takes them (host arrays)."""
    L = cfg["n_layers"]
    heads = ["lin"] if cfg["model"] == "gcn" else ["self", "neigh"]

    def host(k):
        return w[k].cpu().numpy()
    tree = {h: [{"w": host(f"{h}.{l}.w"), "b": host(f"{h}.{l}.b")}
                for l in range(L)] for h in heads}
    tree["bn"] = [({"g": host(f"bn.{l}.g"), "b": host(f"bn.{l}.b")}
                   if cfg["batchnorm"] and l < L - 1 else None)
                  for l in range(L)]
    return tree


_MODULE_NAMES = {"lin": "lin", "self_lin": "self", "neigh_lin": "neigh",
                 "bn": "bn"}

def leaf_name(prog_name: str) -> str:
    """The reference's name of a program parameter (``lin.0.weight`` ->
    ``lin.0.w``, ``bn.0.weight`` -> ``bn.0.g``)."""
    mod, idx, attr = prog_name.split(".")
    head = _MODULE_NAMES[mod]
    if attr == "weight":
        return f"{head}.{idx}.{'g' if head == 'bn' else 'w'}"
    return f"{head}.{idx}.b"


def program_graph(g: gb_graph.Graph):
    """The generated graph in the program's types."""
    from repro_torch.graphs.synthetic import GraphData
    from repro_torch.sparse.csr import CSR
    adj = CSR(rowptr=g.rowptr, col=g.col,
              val=np.ones(g.nnz, np.float32), shape=(g.n, g.n))
    return GraphData(adj=adj, features=g.features, labels=g.labels,
                     train_mask=g.train_mask, val_mask=g.val_mask,
                     test_mask=g.test_mask, num_classes=g.num_classes)


def train_config(config: dict, traffic: dict, seed: int, device: str):
    from repro_torch.train.engine import TrainConfig
    return TrainConfig(
        model=config["model"], n_layers=config["n_layers"],
        hidden=config["hidden"], dropout=config["dropout"],
        batchnorm=config["batchnorm"], lr=config["lr"],
        epochs=traffic["epochs"], seed=seed, rsc=traffic["rsc"],
        budget=traffic["budget"], step_frac=traffic["step_frac"],
        refresh_every=traffic["refresh_every"],
        rsc_fraction=traffic["rsc_fraction"], caching=traffic["caching"],
        switching=traffic["switching"], strategy=traffic["strategy"],
        backend="kernel", block=config["block"],
        degree_sort=config["degree_sort"], autotune=False, device=device,
        probe_every=0)


# ------------------------------------------------------------- a training

class Tap:
    """Wraps one engine's step, planner and evaluation calls: stops it at
    the window's end, keeps what the reference judges, and (in the
    control tests only) plants a fault.

    Kept for the ``follow`` steps (a list): each one's loss, the state
    (parameters, Adam's moments and count) at its start and after it,
    the logits of the evaluations after the ``evals`` epochs with the
    parameters they evaluated, and every plan refresh up to the last of
    them."""

    def __init__(self, engine, *, deadline=None, follow=(), evals=(),
                 stop_at=None, keep_plans=False, fault=None):
        self.engine, self.deadline = engine, deadline
        self.follow, self.evals = set(follow), set(evals)
        self.at = self.follow | {k + 1 for k in self.follow}
        self.last = max(self.at, default=-1)
        self.stop_at, self.fault = stop_at, fault
        self.steps = 0
        self.loss, self.states = {}, {}
        self.logits, self.eval_params = {}, {}
        self.plans, self.keep_plans = {}, keep_plans
        self._rsc, self._exact = engine.rsc_step, engine.exact_step
        engine.rsc_step = self._rsc_step
        engine.exact_step = self._exact_step
        self._eval = engine.eval_logits
        engine.eval_logits = self._eval_logits
        if hasattr(engine.planner, "plans_for"):
            self._plans_for = engine.planner.plans_for
            engine.planner.plans_for = self._plans_for_step
        self._last_plans = None

    def _state(self, model, opt_state) -> None:
        if self.steps in self.at and self.steps not in self.states:
            self.states[self.steps] = {
                "count": opt_state["count"],
                "params": _clone(dict(model.named_parameters())),
                "m": _clone(opt_state["m"]), "v": _clone(opt_state["v"])}

    def _before(self, model, opt_state):
        self._state(model, opt_state)
        # the followed steps run whatever the window's length
        if (self.deadline is not None and self.steps >= self.last
                and time.perf_counter() >= self.deadline):
            raise WindowClosed
        if self.stop_at is not None and self.steps >= self.stop_at:
            raise WindowClosed
        if self.fault == "frozen":
            return (_clone(dict(model.named_parameters())),
                    {s: _clone(opt_state[s]) for s in ("m", "v")})
        return None

    def _after(self, out, saved):
        model, opt_state, lv = out[0], out[1], out[2]
        if saved is not None:
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(saved[0][k])
                for s in ("m", "v"):
                    for k, v in opt_state[s].items():
                        v.copy_(saved[1][s][k])
        if self.steps in self.follow:
            self.loss[self.steps] = lv.detach()
        self.steps += 1
        if self.steps == self.last:
            self._state(model, opt_state)

    def _rsc_step(self, model, opt_state, *rest):
        saved = self._before(model, opt_state)
        out = self._rsc(model, opt_state, *rest)
        self._after(out, saved)
        return out

    def _exact_step(self, model, opt_state, *rest):
        saved = self._before(model, opt_state)
        out = self._exact(model, opt_state, *rest)
        self._after(out, saved)
        return out

    def _plans_for_step(self, tag, step, schedule):
        plans = self._plans_for(tag, step, schedule)
        changed = (self._last_plans is None or any(
            plans[k] is not self._last_plans.get(k) for k in plans))
        if changed and (self.keep_plans or step < self.last):
            self.plans[step] = plans
        self._last_plans = plans
        return plans

    def _eval_logits(self, model, ops):
        out = self._eval(model, ops)
        epoch = self.steps - 1
        if epoch in self.evals:
            if self.fault == "answer":
                out = out.clone()
                out[0, 0] += 1.0
            self.logits[epoch] = out.detach().clone()
            self.eval_params[epoch] = _ref_names(
                _clone(dict(model.named_parameters())))
        return out

    def keep_masks(self) -> dict:
        """The plans kept, as ``step -> {layer: column-block keep mask}``:
        the column blocks in which a plan holds a real (non-sentinel)
        tile."""
        cache = self.engine.planner.cache
        out = {}
        for step, plans in self.plans.items():
            masks = {}
            for op, plan in plans.items():
                at = cache.ops[op].at
                sel = plan.sel.long()
                cols = plan.col_ids.long()[sel < at.s_total]
                m = np.zeros(at.n_col_blocks, bool)
                m[torch.unique(cols).cpu().numpy()] = True
                masks[int(op.rsplit("spmm", 1)[1])] = m
            out[step] = masks
        return out

    def capture(self) -> dict:
        """What the reference judges, under its leaf names (the format of
        ``gb_reference.follow``'s result)."""
        b1 = gb_reference.ADAM["b1"]
        states = {k: {"count": s["count"],
                      **{n: _ref_names(s[n]) for n in ("params", "m", "v")}}
                  for k, s in self.states.items()}
        update = {}
        for k in sorted(self.follow):
            if k in states and k + 1 in states:
                a, b = states[k]["params"], states[k + 1]["params"]
                update[k] = {n: float(torch.linalg.vector_norm(b[n] - a[n]))
                             for n in a}
        grad1 = ({n: float(torch.linalg.vector_norm(v)) / (1 - b1)
                  for n, v in states[1]["m"].items()} if 1 in states else {})
        return {
            "loss": {s: float(v) for s, v in self.loss.items()},
            "grad1": grad1, "update": update, "states": states,
            "logits": self.logits, "eval_params": self.eval_params,
            "plans": self.keep_masks() if self.plans else {},
        }


def _clone(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


def _ref_names(tensors: dict) -> dict:
    """Program tensors under the reference's names and layout (a linear's
    weight transposed to ``(d_in, d_out)``)."""
    return {leaf_name(k): (v.t() if v.dim() == 2 else v)
            for k, v in tensors.items()}


FAULTS = ("frozen", "half_batch", "answer", "layer0", "plan")


def faults(cell: dict) -> tuple[str, ...]:
    """The faults a cell can have (``plan`` needs the planner)."""
    return FAULTS if cell["traffic"]["rsc"] else FAULTS[:-1]


class _ZeroFirstRows(torch.autograd.Function):
    """The identity; its backward zeroes the first ``rows`` rows."""

    @staticmethod
    def forward(ctx, h, rows):
        ctx.rows = rows
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        g[:ctx.rows] = 0
        return g, None


@contextlib.contextmanager
def planted(fault: str | None, cfg: dict | None = None):
    """A fault in the timed path, for the control tests and readings
    (``frozen`` and ``answer`` are the ``Tap``'s own):

    * ``half_batch``: the loss's mean over every other training node;
    * ``layer0``: the lowest backward SpMM's result (the gradient it hands
      to the layer below) loses its first row block, whatever the plan;
    * ``plan``: the planner allocates half of the budget."""
    if fault == "half_batch":
        from repro_torch.train import steps
        real, name = steps.gnn_loss, "gnn_loss"
        target = steps

        def half(logits, ops):
            valid = torch.arange(logits.shape[0], device=logits.device) \
                < ops.n_valid
            m = (ops.train_mask & valid).float()
            idx = torch.nonzero(m)[:, 0]
            m[idx[1::2]] = 0.0
            logp = torch.log_softmax(logits, dim=-1)
            per = -logp.gather(-1, ops.labels.long()[:, None])[:, 0]
            return torch.sum(per * m) / torch.clamp(torch.sum(m), min=1.0)
        fake = half
    elif fault == "layer0":
        from repro_torch.models.gnn import common as target
        real, name = target.spmm_op, "spmm_op"
        # the SpMMs whose input needs a gradient, in layer order, per
        # training forward: the first of them is the lowest backward SpMM
        per_forward = len(gb_reference.spmm_names(cfg))
        calls = [0]

        def fake(a, at, h, *args, **kw):
            if torch.is_grad_enabled() and h.requires_grad:
                calls[0] += 1
                if calls[0] % per_forward == 1 % per_forward:
                    h = _ZeroFirstRows.apply(h, cfg["block"])
            return real(a, at, h, *args, **kw)
    elif fault == "plan":
        from repro_torch.core import cache as target
        real, name = target.greedy_allocate, "greedy_allocate"

        def fake(layers, budget_frac, *args, **kw):
            return real(layers, budget_frac / 2, *args, **kw)
    else:
        yield
        return
    setattr(target, name, fake)
    try:
        yield
    finally:
        setattr(target, name, real)


# ------------------------------------------------------------- the run

class Run:
    """Set-up state of one cell on one device."""

    def __init__(self, cell: dict, seed: int, device: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.cfg = model_cfg(self.config)
        self.follow = follow_steps(self.traffic)
        self.evals = eval_epochs(self.traffic)
        t0 = time.perf_counter()
        self.graph = gb_graph.graph_of(self.config, seed % 2**63)
        graph_s = time.perf_counter() - t0
        from repro_torch.models.gnn import MODELS
        from repro_torch.train.engine import FullGraphSource
        self.module = MODELS[self.config["model"]]
        tc = train_config(self.config, self.traffic, 0, device)
        t0 = time.perf_counter()
        self.source = FullGraphSource(program_graph(self.graph), tc,
                                      self.module)
        self._sync()
        self.parts = {"graph_s": graph_s,
                      "operands_s": time.perf_counter() - t0}
        self._ops = None

    def _sync(self):
        if self.device == "cuda":
            torch.cuda.synchronize()

    def engine(self, index: int, epochs: int | None = None):
        """A fresh engine over the shared source for training ``index``,
        and its initial weights (the reference's names)."""
        from repro_torch.convert import gnn_params_from_numpy
        from repro_torch.train.engine import Engine, FullGraphPlanner
        seed = training_seed(self.seed, index)
        traffic = dict(self.traffic)
        if epochs is not None:
            traffic["epochs"] = epochs
        tc = train_config(self.config, traffic, seed, self.device)
        w = init_weights(self.cfg, seed, self.device)
        model = gnn_params_from_numpy(self.config["model"],
                                      program_tree(self.cfg, w),
                                      device=self.device)
        planner = None
        if tc.rsc:
            at, meta, fro = self.source.planner_operand()
            planner = FullGraphPlanner(tc, self.module, at, meta, fro,
                                       self.source.num_classes,
                                       self.source.device)
        return Engine(tc, self.source, planner=planner, model=model), w, seed

    def warm_up(self) -> None:
        """One short training: RSC steps, a refresh, exact steps and
        evaluations, on every shape the window uses."""
        eng, _, _ = self.engine(WARMUP_INDEX,
                                epochs=self.traffic["refresh_every"] + 5)
        eng.train(eval_every=self.traffic["eval_every"])
        self._sync()
        del eng
        gc.collect()

    def planted(self, fault: str | None):
        return planted(fault, self.cfg)

    def job(self, index: int, *, deadline=None, follow=False,
            profiled=False, fault=None, followed_only=False) -> "Job":
        return Job(self, index, deadline=deadline, follow=follow,
                   profiled=profiled, fault=fault,
                   followed_only=followed_only)

    def work(self, record: dict) -> dict:
        """The counted work of the profiled training."""
        cfg = self.cfg
        g = self.graph
        row_nnz = np.diff(g.rowptr)[gb_reference.degree_order(g.rowptr)]
        if cfg["model"] == "gcn":
            row_nnz = row_nnz + 1
        gw = gb_work.GraphWork.of(row_nnz, cfg["block"])
        w = gb_work.training(cfg, gw, record["modes"], record["plans"],
                             record["evals"])
        return {"flops": w.flops, "spmm_flops": w.spmm_flops,
                "spmm_least_s": w.spmm_least_s,
                "spmm_launches": w.spmm_launches}

    def release(self) -> None:
        """Frees the program's operands."""
        self.source = None

    def _reference_operands(self):
        if self._ops is None:
            self._ops = gb_reference.build_operands(
                self.graph, self.cfg["model"], self.cfg["block"],
                self.device)
        return self._ops

    def check(self, kept: dict, every_leaf: bool = False):
        """The compared numbers of a followed training (``Job.kept``, or
        the control's) and the notes beside them: the leaves' gaps
        (``where``), the followed plan refreshes and the reference's
        gradient norms."""
        prog = kept["prog"]
        ref = gb_reference.follow(self.cfg, self.traffic,
                                  self._reference_operands(), kept["init"],
                                  kept["seed"], self.follow, self.evals,
                                  states=prog["states"],
                                  eval_params=prog["eval_params"],
                                  prog_plans=prog["plans"])
        where = {}
        numbers = gb_check.compare(prog, ref, self.graph.n, where,
                                   every_leaf=every_leaf)
        plans = {s: {k: v for k, v in r.items() if k != "keep"}
                 for s, r in ref["plans"].items()}
        return numbers, {"where": where, "plans": plans,
                         "grad_norm": ref["grad_norm"]}

    def control(self) -> tuple[str, dict]:
        """The control's name and the control in the program's place, as
        ``Job.kept`` gives it: the plain reference in TF32 (one precision
        below the configuration's float32 with TF32 off) trained from the
        first training's weights, with its own plans."""
        seed = training_seed(self.seed, 0)
        w = init_weights(self.cfg, seed, self.device)
        low = gb_reference.follow(self.cfg, self.traffic,
                                  self._reference_operands(), w, seed,
                                  self.follow, self.evals, precision="tf32")
        plans = {s: r["keep"] for s, r in low["plans"].items()}
        return "control_tf32", {"prog": {**low, "plans": plans}, "init": w,
                                "seed": seed}

    def detail(self, out: dict, notes: dict) -> dict:
        """The family's part of the result line's ``detail``."""
        return {
            "trainings": [{k: t[k] for k in ("done", "steps", "best_test",
                                             "flops_fraction")}
                          for t in out["trainings"]],
            "check_where": notes["where"],
            "graph": {"n": self.graph.n, "nnz": self.graph.nnz},
            "plan_refreshes": notes["plans"],
            "grad_norm": {s: math.sqrt(sum(v * v for v in g.values()))
                          for s, g in notes["grad_norm"].items()}}


class Job:
    """One training of the window over the run's source; its set-up (a
    fresh engine and the ``Tap``) is done on construction."""

    def __init__(self, run: Run, index: int, *, deadline, follow, profiled,
                 fault, followed_only):
        self.profiled = profiled
        self.engine, self.init, self.seed = run.engine(index)
        steps = run.follow if follow else ()
        self.tap = Tap(self.engine, deadline=deadline, follow=steps,
                       evals=run.evals if follow else (),
                       stop_at=max(steps) + 1 if followed_only else None,
                       keep_plans=profiled, fault=fault)
        self.eval_every = run.traffic["eval_every"]
        self.done, self.res = True, None

    def __call__(self) -> None:
        try:
            self.res = self.engine.train(eval_every=self.eval_every)
        except WindowClosed:
            self.done = False

    def record(self) -> dict:
        hist = self.engine.history
        tap = self.tap
        return {
            "done": self.done, "steps": len(hist["loss"]),
            "best_test": (self.res["best_test"] if self.done
                          else _best(hist)),
            "flops_fraction": (self.res["flops_fraction"] if self.done
                               else None),
            "modes": list(hist["mode"]),
            "nonfinite": sum(not math.isfinite(v) for v in hist["loss"]),
            "plans": tap.keep_masks() if self.profiled and tap.plans else {},
            "evals": [e for e, _ in hist["val"]]}

    def kept(self) -> dict:
        """What the check judges of this training."""
        return {"prog": self.tap.capture(), "init": self.init,
                "seed": self.seed}


def _best(hist) -> float | None:
    best_val, best_test = -1.0, None
    for (_, v), (_, t) in zip(hist["val"], hist["test"]):
        if v > best_val:
            best_val, best_test = v, t
    return best_test


# ------------------------------------------------------------- the report

def end_to_end(out: dict) -> dict:
    """``test_acc``: the mean best-validation test accuracy of the
    window's finished trainings (of those with one, where none
    finished)."""
    trs = out["trainings"]
    done = [t["best_test"] for t in trs if t["done"]]
    if not done:                      # no training finished in the window
        done = [t["best_test"] for t in trs if t["best_test"] is not None]
    return {"test_acc": statistics.fmean(done) if done else None}
