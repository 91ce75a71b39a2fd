"""Dry run: one rank's bytes, FLOPs and collectives of any LM cell,
allocating nothing.

The port of ``repro.launch.dryrun`` and ``repro.launch.hlo_stats``. The
reference lowers and compiles each (arch × shape × mesh) cell with XLA and
reads the compiled program's ``memory_analysis``, ``cost_analysis`` and
collective instructions. The port runs one rank's step of the cell once,
eagerly, on ``meta`` tensors (shapes and dtypes, no memory, no data), with
the mesh bound to a fake process group of its size as that rank
(``launch.mesh.fake_world``), under one ``TorchDispatchMode`` that meters
every op (``StepMeter``):

* ``per_rank``: the bytes of the parameters, Adam's state (its moments
  and the reference's int32 count), the batch and the cache (prefill's
  output, decode's input, with the reference's int32 length) one rank
  holds, from the sharding rules of ``launch.shardings`` (the
  reference's ``NamedSharding.shard_shape``);
* ``peak_bytes``: one rank's peak of live tensor bytes over the step,
  its parameters, optimizer state, batch and cache included;
* ``flops``: one rank's, by ``torch.utils.flop_counter``'s formulas
  (matrix products, and the flash kernel's registered one in prefill:
  ``kernels.flash_attention.flops``), as ``FlopCounterMode`` counts;
* ``collectives``: one rank's, from the bound mesh's count
  (``Mesh.collective_bytes``: result bytes in ``hlo_stats``' layout);
* ``op_histogram``: the most frequent aten ops of the run (the
  counterpart of ``hlo_stats.op_histogram``);
* ``fits``: ``peak_bytes`` against one card's memory.

``meta`` and not ``FakeTensorMode``'s fake CUDA tensors: a CPU-only build
of PyTorch runs no autograd on those (it asks for the CUDA device guard).
The ops the step runs are the card's all the same: a ``meta`` tensor
takes the bf16 activations' fused ops (``models.lm.layers``), and flash's
custom op runs its registered fake. ``chip_smoke.py`` holds the peak of
phase 13's qwen3-1.7b step against the card's. The steps are built
without RSC, as the reference's dry run builds them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k --mesh data=16,model=16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Records go to ``build/dryrun/<arch>__<shape>__<mesh>__mb<microbatches>.json``.
To size a run of another batch, call ``lower_step`` with it.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, get_arch, input_specs, \
    shape_applicable
from repro_torch.configs.shapes import microbatches
from repro_torch.convert import lm_cache_shardings, lm_param_shardings, \
    lm_tree
from repro_torch.launch.mesh import Mesh, dp_axes, fake_world, \
    parse_mesh_spec
from repro_torch.launch.shardings import batch_shardings, opt_shardings, \
    param_shardings, tree_leaves_with_path
from repro_torch.models.lm.backbone import LM, ShardedLM
from repro_torch.train.lm_steps import abstract_cache, abstract_state, \
    local_batch, make_decode_step, make_prefill_step, \
    make_sharded_decode_step, make_sharded_prefill_step, \
    make_sharded_train_step, make_train_step
from repro_torch.train.optimizer import Adam

ART = Path(__file__).resolve().parents[3] / "build" / "dryrun"
# One card's memory where no card is present: torch.cuda.get_device_
# properties(0).total_memory of an NVIDIA H100 80GB HBM3 (power limit
# 700.00 W), read on the card by chip_smoke.py.
H100_MEMORY_BYTES = 85_017_493_504
# The meshes of --all: one card, and the two layouts of 4 cards the port
# runs ((data 2, model 2) and (data 1, model 4)).
MESHES = (None, "data=2,model=2", "data=1,model=4")


def card_memory_bytes() -> int:
    """One card's memory: the card's own where one is present, else
    ``H100_MEMORY_BYTES``."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100_MEMORY_BYTES


def _bytes(t) -> int:
    return math.prod(t.shape) * t.dtype.itemsize


def param_bytes_global(cfg) -> int:
    """The bytes of every parameter of ``cfg`` (the reference's
    ``_tree_bytes(abstract_state(cfg, opt)[0])``)."""
    return sum(_bytes(p) for p in LM(cfg, "meta").parameters())


def _sharded_bytes(tree, shardings) -> int:
    sh = dict(tree_leaves_with_path(shardings))
    return sum(math.prod(sh[path].local_shape(tuple(x.shape)))
               * x.dtype.itemsize
               for path, x in tree_leaves_with_path(tree))


def mesh_of(spec) -> Mesh:
    """A mesh from ``None`` (one card) or a ``--mesh`` spec such as
    ``"data=2,model=2"`` (``launch.mesh.parse_mesh_spec``'s syntax, with
    ``=`` or ``:``)."""
    if isinstance(spec, Mesh):
        return spec
    return Mesh((1,), ("data",)) if spec is None else \
        parse_mesh_spec(spec.replace("=", ":"))


def per_rank_bytes(cfg, kind: str, batch: int, seq: int, mesh) -> dict:
    """The bytes one rank of ``mesh`` holds of the parameters, Adam's
    state, the batch and the cache (prefill and decode) of a ``kind``
    step over ``batch`` × ``seq``: the reference's rules
    (``param_shardings`` of the reference's tree, ``opt_shardings``,
    ``batch_shardings`` over ``dp_axes``, the sanitized
    ``cache_shardings`` of ``abstract_cache(cfg, batch, seq)``)."""
    mesh = mesh_of(mesh)
    tree, moments = _state_trees(cfg)
    p_sh = param_shardings(tree, mesh)
    o_sh = opt_shardings(moments, p_sh, mesh)
    out = {"params": _sharded_bytes(tree, p_sh), "opt": 0, "cache": 0}
    if kind == "train":
        out["opt"] = _sharded_bytes(moments, {k: o_sh[k] for k in moments}) \
            + 4                        # the step count, an int32 scalar
    specs = _specs(cfg, kind, batch, seq)
    out["batch"] = _sharded_bytes(
        specs, batch_shardings(specs, mesh, dp_axes(mesh, batch)))
    if kind != "train":
        cache = abstract_cache(cfg, batch, seq)
        out["cache"] = _sharded_bytes(
            cache["layers"], lm_cache_shardings(cfg, mesh, cache)["layers"]) \
            + 4                        # the length, an int32 scalar
    out["total"] = sum(out.values())
    return out


@functools.lru_cache(maxsize=2)
def _state_trees(cfg):
    """The parameters and Adam's moments of ``cfg`` in the reference's
    tree layout, on the ``meta`` device."""
    params, opt = abstract_state(cfg, Adam())
    return (lm_tree(dict(params.named_parameters()), cfg),
            {k: lm_tree(opt[k], cfg) for k in ("m", "v")})


def _specs(cfg, kind: str, batch: int, seq: int) -> dict:
    """``input_specs`` of a ``kind`` step over ``batch`` × ``seq``."""
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    specs = input_specs(cfg, shape, batch)
    if kind == "decode":
        return specs
    return {k: torch.empty((v.shape[0], seq) + tuple(v.shape[2:])
                           if k != "cross_states" else v.shape,
                           dtype=v.dtype, device="meta")
            for k, v in specs.items()}


class StepMeter(TorchDispatchMode):
    """What one run does, counted op by op as it is dispatched: the aten
    ops (``ops``), the FLOPs of those ``torch.utils.flop_counter`` has a
    formula for (``flops``; ``FlopCounterMode``'s registry, flash's
    formula among them), and the bytes of tensor storage alive at once
    and their peak (``live``, ``peak``): each storage an op returns counts
    from then until it is collected, rounded up to the CUDA caching
    allocator's 512-byte blocks (what ``torch.cuda.max_memory_allocated``
    counts). Storage made before the mode was entered is not seen."""

    BLOCK = 512

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()
        self.flops = self.live = self.peak = 0
        self._ids: set[int] = set()
        self._leaves: set = set()         # ops that do not decompose
        self._fresh: dict = {}            # op -> returns new tensors only
        self._memo: dict = {}             # signature -> output layouts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if func not in self._leaves and packet not in flop_registry:
            # a composite op (under inference_mode it reaches the mode
            # whole): count what it decomposes into, as FlopCounterMode
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
            self._leaves.add(func)
        out = self._run(func, args, kwargs)
        self.ops[str(packet)] += 1
        count = flop_registry.get(packet)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t.untyped_storage())
        return out

    def _run(self, func, args, kwargs):
        """``func`` on meta tensors. An op that returns new tensors only
        (no view, nothing written in place) is run once per signature of
        its arguments (shapes, strides, dtypes and the other values); its
        later calls get empty meta tensors of the outputs' layouts, which
        is all a meta kernel computes."""
        if func not in self._fresh:
            s = func._schema
            self._fresh[func] = not (s.is_mutable or any(
                r.alias_info is not None for r in s.returns)) \
                and all(str(r.type) == "Tensor" for r in s.returns)
        key = _signature(func, args, kwargs) if self._fresh[func] else None
        if key is None:
            return func(*args, **kwargs)
        layouts = self._memo.get(key)
        if layouts is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            ins = {t.untyped_storage()._cdata for t in pytree.tree_leaves(
                (args, kwargs)) if isinstance(t, torch.Tensor)}
            if any(t.untyped_storage()._cdata in ins for t in outs):
                self._fresh[func] = False    # aliases unannounced
            else:
                self._memo[key] = (isinstance(out, tuple), [
                    (tuple(t.shape), tuple(t.stride()), t.dtype)
                    for t in outs])
            return out
        many, layouts = layouts
        outs = tuple(torch.empty_strided(sh, st, dtype=dt, device="meta")
                     for sh, st, dt in layouts)
        return outs if many else outs[0]

    def _track(self, st) -> None:
        if id(st) in self._ids:
            return
        n = -(-st.nbytes() // self.BLOCK) * self.BLOCK
        self._ids.add(id(st))
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, id(st), n)

    def _free(self, key: int, n: int) -> None:
        self._ids.discard(key)
        self.live -= n



def _signature(func, args, kwargs):
    """A hashable key of an op's arguments: each tensor's shape, strides,
    dtype and device, every other value as it is; None where a value is
    not hashable."""
    def key(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), tuple(x.stride()), x.dtype,
                    x.device.type)
        if isinstance(x, (list, tuple)):
            return tuple(key(v) for v in x)
        return x
    try:
        k = (func, key(args), tuple(sorted((n, key(v))
                                            for n, v in kwargs.items())))
        hash(k)
    except TypeError:
        return None
    return k


def _layouts(cfg, kind: str, batch: int, seq: int, mesh, n_mb: int):
    """What one rank holds, as ``meta`` tensors made before the meter
    starts (so that they count nothing): the model's skeleton, the
    parameter shardings (None on one rank), and this rank's parameter
    blocks, batch and decode cache."""
    skeleton = LM(cfg, "meta")
    shardings = None if mesh is None else lm_param_shardings(cfg, mesh)
    params = {n: p if mesh is None else torch.empty(
        shardings[n].local_shape(tuple(p.shape)), dtype=p.dtype,
        device="meta") for n, p in skeleton.named_parameters()}
    inputs = _specs(cfg, kind, batch, seq)
    if mesh is not None:
        inputs = local_batch(inputs, mesh, n_mb if kind == "train" else 1)
    cache = None
    if kind == "decode":
        whole = abstract_cache(cfg, batch, seq)
        cache = {"layers": whole["layers"], "len": seq - 1}
        if mesh is not None:
            sh = lm_cache_shardings(cfg, mesh, whole)["layers"]
            cache = {"layers": [
                {k: torch.empty(s[k].local_shape(tuple(t.shape)),
                                dtype=t.dtype, device="meta")
                 for k, t in c.items()} for c, s in zip(whole["layers"], sh)],
                "len": seq - 1, "max_len": seq}
    return skeleton, shardings, params, inputs, cache


def _zeros(t) -> torch.Tensor:
    return torch.zeros(tuple(t.shape), dtype=t.dtype, device="meta")


def _step(cfg, mesh, kind: str, opt: Adam, n_mb: int):
    if kind == "train":
        return make_train_step(cfg, opt, n_mb) if mesh is None else \
            make_sharded_train_step(cfg, opt, mesh, n_mb)
    if kind == "prefill":
        return make_prefill_step(cfg) if mesh is None else \
            make_sharded_prefill_step(cfg, mesh)
    return make_decode_step(cfg) if mesh is None else \
        make_sharded_decode_step(cfg, mesh)


def _run(cfg, kind: str, batch: int, seq: int, mesh: Mesh,
         n_microbatches: int, rank: int) -> dict:
    """One ``kind`` step on meta tensors, metered (see ``lower_step``):
    the rank's parameters, Adam's state, batch and cache are made inside
    the meter, so they count toward the peak."""
    opt = Adam(lr=3e-4)
    world = fake_world(mesh, rank) if mesh.size > 1 else \
        contextlib.nullcontext(None)
    t0 = time.perf_counter()
    with world as bound:
        skeleton, shardings, blocks, specs, cache = _layouts(
            cfg, kind, batch, seq, bound, n_microbatches)
        with StepMeter() as meter:
            if bound is None:
                params = LM(cfg, "meta")
                named = dict(params.named_parameters())
            else:
                with torch.no_grad():
                    shards = {n: torch.empty_like(b)
                              for n, b in blocks.items()}
                params = ShardedLM(cfg, bound, shards, shardings, skeleton)
                named = params.shards
            inputs = {k: _zeros(v) for k, v in specs.items()}
            step = _step(cfg, bound, kind, opt, n_microbatches)
            if kind == "train":
                args = (params, opt.init(named), inputs)
            elif kind == "decode":
                args = (params, {**cache, "layers": [
                    {k: _zeros(t) for k, t in c.items()}
                    for c in cache["layers"]]}, inputs)
            else:
                args = (params, inputs)
            del named
            if bound is not None:
                bound.reset_stats()
            meter.flops = 0
            meter.ops.clear()
            out = step(*args)
            del out, args, params, inputs
        coll = (bound or mesh).collective_bytes()
    return {"peak_bytes": meter.peak, "flops": meter.flops,
            "collectives": coll, "ops": meter.ops,
            "lower_s": time.perf_counter() - t0}


def _batch_bytes(cfg, rows: int, seq: int) -> int:
    """The bytes of a training batch of ``rows`` rows, in 512-byte
    blocks."""
    return sum(-(-_bytes(v) // StepMeter.BLOCK) * StepMeter.BLOCK
               for v in _specs(cfg, "train", rows, seq).values())


def lower_step(cfg, kind: str, *, batch: int, seq: int, mesh=None,
               n_microbatches: int = 1, rank: int = 0) -> dict:
    """Run one ``kind`` step (``train``, ``prefill`` or ``decode``) of
    ``cfg`` over a global ``batch`` × ``seq`` on meta tensors, as global
    ``rank`` of ``mesh`` (None or a one-rank mesh: the one-card steps),
    and measure it: ``peak_bytes``, ``flops``, ``collectives``,
    ``op_histogram`` and ``lower_s`` (the run's seconds).

    A training step of ``M`` > 3 microbatches is measured from the same
    step over its first 2 and first 3 microbatches (``measured_from``):
    every microbatch after the first does the same work on the same live
    state (the f32 gradient sums exist from the first on), so each count
    grows by the third's difference per microbatch, and the peak is the
    3-microbatch step's plus the rest of the batch, which stays on the
    rank throughout. That keeps a 16-microbatch cell of a 64-layer model
    within a minute of one CPU."""
    mesh = mesh_of(mesh)
    if kind != "train" or n_microbatches <= 3:
        a = b = _run(cfg, kind, batch, seq, mesh, n_microbatches, rank)
        more, measured, extra = 0, [n_microbatches], 0
    else:
        per = batch // n_microbatches
        a = _run(cfg, kind, 2 * per, seq, mesh, 2, rank)
        b = _run(cfg, kind, 3 * per, seq, mesh, 3, rank)
        more, measured = n_microbatches - 3, [2, 3]
        dp = mesh.axis_size(mesh.dp_axes)
        extra = _batch_bytes(cfg, batch // dp, seq) \
            - _batch_bytes(cfg, 3 * per // dp, seq)

    def grown(x, y):          # y, and the last microbatch's step each more
        return y + more * (y - x)

    kinds = {k: {"count": grown(a["collectives"][k]["count"], v["count"]),
                 "bytes": grown(a["collectives"][k]["bytes"], v["bytes"])}
             for k, v in b["collectives"].items() if isinstance(v, dict)}
    ops = collections.Counter({k: grown(a["ops"][k], n)
                               for k, n in b["ops"].items()})
    return {"peak_bytes": b["peak_bytes"] + extra,
            "flops": grown(a["flops"], b["flops"]),
            "collectives": {
                **kinds,
                "total_bytes": sum(v["bytes"] for v in kinds.values()),
                "total_count": sum(v["count"] for v in kinds.values())},
            "op_histogram": [(k, n) for k, n in ops.most_common()
                             if k.startswith("aten.")][:15],
            "measured_from": measured,
            "lower_s": round(a["lower_s"] + (b["lower_s"] if more else 0), 2)}


def _mesh_record(mesh: Mesh) -> dict:
    return {a: int(s) for a, s in mesh.shape.items()}


def lower_cell(arch: str, shape: str, *, mesh=None, cfg_override=None,
               microbatch_override: int | None = None) -> dict:
    """The dry-run record of one (arch × shape × mesh) cell, as the
    mesh's rank 0 (``mesh`` None: one card), the reference's keys where
    it has them."""
    cfg = cfg_override if cfg_override is not None else get_arch(arch)
    mesh = mesh_of(mesh)
    sp = SHAPES[shape]
    batch = sp.global_batch
    head = {"arch": arch, "shape": shape, "mesh": _mesh_record(mesh),
            "global_batch": batch}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {**head, "status": "skipped", "reason": why}
    dp = dp_axes(mesh, batch)
    n_mb = microbatch_override if microbatch_override is not None \
        else microbatches(arch, shape)
    if sp.kind == "train" and dp is not None:
        # each microbatch must still divide the dp submesh
        n_mb = max(1, min(n_mb, batch // mesh.axis_size(dp)))
    n_mb = n_mb if sp.kind == "train" else 1
    run = lower_step(cfg, sp.kind, batch=batch, seq=sp.seq_len, mesh=mesh,
                     n_microbatches=n_mb)
    card = card_memory_bytes()
    return {
        **head, "status": "ok", "devices": mesh.size,
        "seq_len": sp.seq_len, "kind": sp.kind, "microbatches": n_mb,
        "param_bytes_global": param_bytes_global(cfg),
        "per_rank": per_rank_bytes(cfg, sp.kind, batch, sp.seq_len, mesh),
        **run,
        "card_memory_bytes": card,
        "fits": run["peak_bytes"] <= card,
    }


def _tag(rec: dict) -> str:
    m = "x".join(f"{a}{s}" for a, s in rec["mesh"].items())
    tag = f"{rec['arch']}__{rec['shape']}__{m}"
    if "microbatches" in rec:
        tag += f"__mb{rec['microbatches']}"
    return tag


def save_record(rec: dict) -> Path:
    ART.mkdir(parents=True, exist_ok=True)
    path = ART / f"{_tag(rec)}.json"
    path.write_text(json.dumps(rec, indent=1))
    return path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", default=None,
                    help="e.g. data=16,model=16 (default: one card)")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--all", action="store_true",
                    help=f"every arch and shape on {MESHES}")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    archs = sorted(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = sorted(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = MESHES if args.all else (args.mesh,)
    failures = 0
    for spec in meshes:
        for arch in archs:
            for shape in shapes:
                try:
                    rec = lower_cell(arch, shape, mesh=spec,
                                     microbatch_override=args.microbatches)
                except Exception as e:  # noqa: BLE001 (one cell's failure)
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": _mesh_record(mesh_of(spec)),
                           "global_batch": SHAPES[shape].global_batch,
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                path = save_record(rec)
                tag = _tag(rec)
                if rec["status"] == "ok":
                    print(f"[dryrun] {tag}: OK {rec['lower_s']} s "
                          f"peak={rec['peak_bytes'] / 2 ** 30:.2f}GiB "
                          f"(fits={rec['fits']}) "
                          f"state={rec['per_rank']['total'] / 2 ** 30:.2f}"
                          f"GiB flops={rec['flops']:.3e} "
                          f"coll={rec['collectives']['total_bytes'] / 2 ** 30:.3f}"
                          f"GiB mb={rec['microbatches']} -> {path.name}",
                          flush=True)
                else:
                    print(f"[dryrun] {tag}: {rec['status']} "
                          f"{rec.get('reason', rec.get('error', ''))[:200]}",
                          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
