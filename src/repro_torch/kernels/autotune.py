"""Per-signature SpMM autotuner with a persisted JSON config cache.

The port of ``repro.kernels.autotune``. The best SpMM configuration is
input-dependent (Qiu et al., *Optimizing Sparse Matrix Multiplications for
GNNs*); this module owns that decision:

* an operand **signature** buckets the dispatch-relevant statics —
  ``(backend, bm, bk, d, s_pad, n_row_blocks)`` rounded to powers of two
  plus a **density band** (``s_pad / (n_row_blocks · n_col_blocks)``
  quantized to coarse bands) — exactly as the reference does, so one sweep
  serves every operand in the bucket (every subgraph of a minibatch shape
  bucket);
* :func:`get_or_tune` sweeps the backend's tunables once per signature and
  caches the winner;
* :func:`get_or_tune_auto` sweeps the same shape across lowerings
  (:func:`auto_backends`) and records the winning *backend*, which
  ``core.rsc_spmm.spmm_apply(backend="auto")`` serves;
* :func:`lookup` is the dispatch-time read of ``kernels.ops`` /
  ``core.rsc_spmm``: the cached winner if the signature was ever tuned
  (this process or an earlier one, through the JSON file), else the
  heuristic default (``ops.default_bd``: today's ``bd``). It NEVER sweeps;
  a miss is counted (``stats.defaults``, ``missed``) and logged once per
  signature.

Backend names map onto the reference's: ``ref`` (the CPU-only chunked
streaming schedule) is ``stream``/``jnp``, ``kernel`` (the CUDA kernel) is
``pallas``, ``kernel_plain`` (the kernel wrapper on a CPU tensor, which
runs its plain version) is ``pallas_interpret``, and ``dense`` is
``dense``. What ``_sweep`` times:

* ``ref``: the ``chunk`` candidates of ``spmm_stream``;
* ``dense``: ``kernels/dense_spmm.py`` (no knob; timed for the ranking);
* ``kernel``: the column tile ``bd``. The kernel's tensor-core variants
  launch 48-, 64- or 128-column CTAs (``bcoo_spmm._tile``), so the
  reference's candidates 128, 256 and 512 all launch the same grid at
  d = 256 (two 128-column tiles, one chunk). The candidates are the
  divisors of d among 512, 256, 128, 64 and 48, and d itself, with one kept
  (the largest) per distinct launch — (``_tile``, ``column_tiles``,
  ``chunks``) — each timed once with CUDA events (one warm-up launch, then
  one event pair over ``KERNEL_REPS`` launches). At d = 256 that leaves
  bd 256 (two 128-column tiles) and 64 (four 64-column tiles, two CTAs per
  SM); at d = 47 (or any d no candidate divides but itself) only d;
* ``kernel_plain``: the plain version once, at the default ``bd`` (it
  ignores ``bd``; the entry is provenance, not a decision).

On the card the candidates are timed at the shape asked for (the first
operand of the signature); on the CPU at the reference's representative
shape (powers of two, clipped to ``SWEEP_MAX_*``).

``auto_backends`` is ``kernel`` + ``dense`` on the card and ``ref`` +
``dense`` on the CPU; ``ref`` never runs on a CUDA tensor.

Cache file (``RSC_TORCH_AUTOTUNE_CACHE``, default
``~/.cache/repro-rsc/spmm_autotune_torch.json``, apart from the
reference's file so entries of the two packages never mix)::

    {"version": 1,
     "entries": {"<signature>": {"bd": 256, "chunk": 32, "us": 412.5,
                                 "backend": "kernel", "platform": "gpu",
                                 "device": "NVIDIA H100 80GB HBM3",
                                 "plain": false,
                                 "candidates": {"256": 431.0,
                                                "64": 412.5}}}}

``us`` is the winner's measured microseconds per call, ``candidates``
every candidate's (by ``bd`` for the kernel, by ``chunk`` otherwise);
``backend`` / ``platform`` / ``device`` / ``plain`` say where that timing
came from (the card's own name from ``torch.cuda.get_device_name``). A
``kernel|...`` dispatch served an entry timed on the plain version warns
once and is counted (``stats.plain_served``). Unknown keys are preserved
on rewrite; writes are atomic (a temporary file, then a rename).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
import uuid
import warnings
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)

ENV_VAR = "RSC_TORCH_AUTOTUNE_CACHE"
CHUNK_CANDIDATES = (8, 16, 32, 64, 128)
BD_CANDIDATES = (512, 256, 128, 64, 48)
KERNEL_REPS = 5
DEFAULT_CHUNK = 32
DEFAULT_BD = 512
# CPU sweeps time the reference's representative shape clipped to these,
# keeping a sweep sub-second while preserving the candidates' ordering.
SWEEP_MAX_S = 1024
SWEEP_MAX_BLOCKS = 64
SWEEP_MAX_D = 512

AUTO_BACKENDS_CPU = ("ref", "dense")
AUTO_BACKENDS_CUDA = ("kernel", "dense")


def canonical_backend(name: str) -> str:
    """Canonical backend names are ``ref`` | ``kernel`` | ``dense``;
    ``kernel_plain`` is the kernel wrapper on a CPU tensor."""
    return {"kernel_plain": "kernel"}.get(name, name)


@dataclasses.dataclass(frozen=True)
class SpmmConfig:
    bd: int       # column tile of the CUDA kernel
    chunk: int    # tiles per step of the streaming ref schedule
    source: str = "default"   # "default" | "swept" | "cache"
    backend: str = "ref"      # chosen lowering: ref | kernel | dense


@dataclasses.dataclass
class TuneStats:
    lookups: int = 0
    hits: int = 0        # lookups / get_or_tune served from the cache
    defaults: int = 0    # lookups answered with the heuristic default
    sweeps: int = 0      # timing sweeps run
    sweep_launches: int = 0   # CUDA kernel launches the sweeps made
    plain_served: int = 0     # plain-timed entries served to the kernel


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _density_band(s_pad: int, n_row_blocks: int, n_col_blocks: int) -> str:
    dens = s_pad / max(1, n_row_blocks * n_col_blocks)
    for edge in (0.02, 0.05, 0.1, 0.25, 0.5, 1.0):
        if dens <= edge:
            return f"{edge:g}"
    return "inf"


def signature(backend: str, *, bm: int, bk: int, d: int, s_pad: int,
              n_row_blocks: int, n_col_blocks: int) -> str:
    """Bucket an operand's dispatch statics into a cache key."""
    return (f"{backend}|bm{bm}|bk{bk}|d{_pow2_ceil(d)}|s{_pow2_ceil(s_pad)}"
            f"|rb{_pow2_ceil(n_row_blocks)}"
            f"|dens{_density_band(s_pad, n_row_blocks, n_col_blocks)}")


def default_cache_path() -> Path:
    return Path(os.environ.get(
        ENV_VAR, str(Path.home() / ".cache" / "repro-rsc"
                     / "spmm_autotune_torch.json")))


class AutotuneCache:
    """In-memory signature→config map, persisted to a JSON file."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = Path(path) if path is not None else default_cache_path()
        self.entries: dict[str, dict] = {}
        self.stats = TuneStats()
        self.missed: set[str] = set()   # signatures a lookup missed
        self._loaded = False
        self._warned: set[str] = set()

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        try:
            raw = json.loads(self.path.read_text())
            if isinstance(raw, dict) and isinstance(raw.get("entries"), dict):
                self.entries.update(raw["entries"])
        except (OSError, ValueError):
            pass

    def save(self) -> None:
        """Atomic persist: re-read and merge the file (ours win on
        conflict), write a temporary file unique to this write, then
        ``os.replace`` it, so a reader sees the old or the new file, never
        a torn one. A read-only file system keeps the cache in memory."""
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            try:
                raw = json.loads(self.path.read_text())
                if isinstance(raw, dict) and isinstance(raw.get("entries"),
                                                        dict):
                    merged = dict(raw["entries"])
                    merged.update(self.entries)
                    self.entries = merged
            except (OSError, ValueError):
                pass
            tmp = self.path.with_name(
                f".{self.path.name}.{os.getpid()}.{uuid.uuid4().hex}.tmp")
            try:
                tmp.write_text(json.dumps(
                    {"version": 1, "entries": self.entries},
                    indent=1, sort_keys=True))
                os.replace(tmp, self.path)
            except BaseException:
                tmp.unlink(missing_ok=True)
                raise
            # writers killed between write and replace leave orphans:
            # sweep old ones (a live concurrent writer's must survive)
            cutoff = time.time() - 3600
            for stale in self.path.parent.glob(f".{self.path.name}.*.tmp"):
                try:
                    if stale.stat().st_mtime < cutoff:
                        stale.unlink()
                except OSError:
                    pass
        except OSError:
            pass

    def get(self, sig: str) -> SpmmConfig | None:
        self._load()
        e = self.entries.get(sig)
        if e is None:
            return None
        if e.get("plain") and sig.split("|", 1)[0] == "kernel":
            self.stats.plain_served += 1
            if sig not in self._warned:
                self._warned.add(sig)
                warnings.warn(
                    f"autotune cache entry for {sig!r} was timed on the "
                    "kernel's plain version, not on the card; re-sweep on "
                    f"the card (delete the entry or point {ENV_VAR} at a "
                    "fresh file)", RuntimeWarning, stacklevel=3)
        backend = canonical_backend(
            str(e.get("backend") or sig.split("|", 1)[0]))
        if backend == "auto":
            backend = "ref"
        return SpmmConfig(bd=int(e.get("bd", DEFAULT_BD)),
                          chunk=int(e.get("chunk", DEFAULT_CHUNK)),
                          source="cache", backend=backend)

    def put(self, sig: str, cfg: SpmmConfig, us: float,
            persist: bool = True, provenance: dict | None = None) -> None:
        self._load()
        entry = {"bd": cfg.bd, "chunk": cfg.chunk, "us": round(us, 2)}
        if provenance:
            entry.update(provenance)
        self.entries[sig] = entry
        if persist:
            self.save()


_cache = AutotuneCache()


def get_cache() -> AutotuneCache:
    return _cache


def reset(path: str | os.PathLike | None = None) -> AutotuneCache:
    """Swap the process-wide cache (tests and ``chip_smoke.py`` point it at
    a scratch file)."""
    global _cache
    _cache = AutotuneCache(path)
    return _cache


def default_config(d: int) -> SpmmConfig:
    from repro_torch.kernels.ops import default_bd
    return SpmmConfig(bd=default_bd(d), chunk=DEFAULT_CHUNK,
                      source="default")


def lookup(sig: str, d: int | None = None) -> SpmmConfig:
    """Dispatch-time config read: cached winner or heuristic default.

    Never sweeps. A miss is answered at once with the default (``bd`` =
    ``ops.default_bd(d)``) and recorded in ``missed``; it is logged once
    per signature."""
    _cache.stats.lookups += 1
    cfg = _cache.get(sig)
    if cfg is not None:
        _cache.stats.hits += 1
        return cfg
    _cache.stats.defaults += 1
    if sig not in _cache.missed:
        _cache.missed.add(sig)
        logger.info(
            "autotune cache miss for signature %s — dispatching the "
            "heuristic default (run get_or_tune/get_or_tune_auto or point "
            "%s at a warmed cache to remove this)", sig, ENV_VAR)
    return default_config(d if d is not None else DEFAULT_BD)


def _sweep_device(backend: str, device) -> torch.device:
    if backend in ("ref", "kernel_plain"):
        return torch.device("cpu")
    if backend == "kernel":
        from repro_torch.device import resolve_device
        dev = resolve_device("cuda" if device is None else device)
        if dev.type != "cuda":
            raise ValueError("backend 'kernel' is timed on the card; on the "
                             "CPU tune 'kernel_plain'")
        return dev
    if backend == "dense":
        from repro_torch.device import resolve_device
        return resolve_device("cuda" if device is None else device)
    raise ValueError(f"unknown SpMM backend {backend!r}")


def get_or_tune(backend: str, *, bm: int, bk: int, d: int, s_pad: int,
                n_row_blocks: int, n_col_blocks: int, persist: bool = True,
                device: str | torch.device | None = None) -> SpmmConfig:
    """Cached config for this signature, sweeping once on a miss.

    The second query for the same signature — from any operand in the
    bucket, or any later process through the JSON file — returns the
    cached winner without sweeping. ``device`` is where ``dense`` is timed
    (the card by default); ``kernel`` runs on the card, ``ref`` and
    ``kernel_plain`` on the CPU.
    """
    sig = signature(backend, bm=bm, bk=bk, d=d, s_pad=s_pad,
                    n_row_blocks=n_row_blocks, n_col_blocks=n_col_blocks)
    cfg = _cache.get(sig)
    if cfg is not None:
        _cache.stats.hits += 1
        return cfg
    cfg, us, prov = _sweep(backend, bm=bm, bk=bk, d=d, s_pad=s_pad,
                           n_row_blocks=n_row_blocks,
                           n_col_blocks=n_col_blocks,
                           device=_sweep_device(backend, device))
    _cache.stats.sweeps += 1
    _cache.put(sig, cfg, us, persist=persist, provenance=prov)
    return cfg


def auto_backends(device: str | torch.device = "cuda") -> tuple[str, ...]:
    """Lowering candidates of the cross-backend sweep on ``device``."""
    return (AUTO_BACKENDS_CUDA if torch.device(device).type == "cuda"
            else AUTO_BACKENDS_CPU)


def get_or_tune_auto(*, bm: int, bk: int, d: int, s_pad: int,
                     n_row_blocks: int, n_col_blocks: int,
                     persist: bool = True,
                     backends: tuple[str, ...] | None = None,
                     device: str | torch.device = "cuda") -> SpmmConfig:
    """Cross-backend winner for this signature, sweeping once on a miss.

    Sweeps every candidate lowering (:func:`auto_backends` of ``device``
    unless ``backends`` overrides) and caches the fastest as an
    ``auto|...`` entry whose ``backend`` field is the dispatch decision of
    ``spmm_apply(backend="auto")``. Per-backend signatures tuned by
    :func:`get_or_tune` are untouched; the two namespaces share the file.
    """
    sig = signature("auto", bm=bm, bk=bk, d=d, s_pad=s_pad,
                    n_row_blocks=n_row_blocks, n_col_blocks=n_col_blocks)
    cfg = _cache.get(sig)
    if cfg is not None:
        _cache.stats.hits += 1
        return cfg
    best: tuple[float, SpmmConfig, dict] | None = None
    for backend in (backends if backends is not None
                    else auto_backends(device)):
        cand, us, prov = _sweep(backend, bm=bm, bk=bk, d=d, s_pad=s_pad,
                                n_row_blocks=n_row_blocks,
                                n_col_blocks=n_col_blocks,
                                device=_sweep_device(backend, device))
        _cache.stats.sweeps += 1
        if best is None or us < best[0]:
            best = (us, cand, prov)
    us, cfg, prov = best
    _cache.put(sig, cfg, us, persist=persist,
               provenance={**prov, "backend": cfg.backend})
    return cfg


def kernel_candidates(d: int, *, n_row_blocks: int, s_pad: int,
                      n_sm: int) -> list[int]:
    """The ``bd`` values whose launches differ at this shape: the
    divisors of ``d`` among ``BD_CANDIDATES`` and ``d`` itself, largest
    first, one per distinct (column tile, column tiles, chunks)."""
    from repro_torch.kernels import bcoo_spmm as kmod
    seen, out = set(), []
    for bd in sorted({b for b in (*BD_CANDIDATES, d)
                      if b <= d and d % b == 0}, reverse=True):
        key = (kmod._tile(bd), kmod.column_tiles(d, bd),
               kmod.chunks(n_row_blocks, s_pad, d, bd, n_sm))
        if key not in seen:
            seen.add(key)
            out.append(bd)
    return out


def _cpu_ms(fn, iters: int = 3) -> float:
    fn()                                  # warm
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def _cuda_ms(fn, reps: int = KERNEL_REPS) -> float:
    fn()                                  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _operands(bm, bk, d, s, rb, cb, device):
    """Synthetic operands of the shape: random tiles plus the zero
    sentinel, sorted random rows, random columns, a random dense h."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    blocks = torch.cat([
        torch.randn((s, bm, bk), generator=gen, device=device),
        torch.zeros((1, bm, bk), device=device)])
    rows = np.sort(rng.integers(0, rb, s)).astype(np.int32)
    cols = rng.integers(0, cb, s).astype(np.int32)
    from repro_torch.sparse.bcoo import host_row_ptr
    up = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    h = torch.randn((cb * bk, d), generator=gen, device=device)
    return (blocks, up(np.arange(s, dtype=np.int32)), up(rows), up(cols), h,
            up(host_row_ptr(rows, rb)))


def _sweep(backend: str, *, bm: int, bk: int, d: int, s_pad: int,
           n_row_blocks: int, n_col_blocks: int, device: torch.device
           ) -> tuple[SpmmConfig, float, dict]:
    """Time each candidate on synthetic operands of the bucket shape;
    returns (winner, its µs per call, provenance)."""
    from repro_torch.core.rsc_spmm import spmm_stream
    from repro_torch.kernels import bcoo_spmm as kmod
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.dense_spmm import dense_spmm

    on_card = device.type == "cuda"
    if on_card:
        s, rb, cb, dd = s_pad, n_row_blocks, n_col_blocks, d
    else:
        s = min(_pow2_ceil(s_pad), SWEEP_MAX_S)
        rb = min(_pow2_ceil(n_row_blocks), SWEEP_MAX_BLOCKS)
        cb = min(_pow2_ceil(n_col_blocks), SWEEP_MAX_BLOCKS)
        dd = min(d, SWEEP_MAX_D)
    blocks, sel, rows, cols, h, rptr = _operands(bm, bk, dd, s, rb, cb,
                                                 device)
    timer = _cuda_ms if on_card else _cpu_ms
    dflt = default_config(d).bd
    cands: list[tuple[float, SpmmConfig]] = []
    plain = False
    before = kmod.launches
    with torch.no_grad():
        if backend == "ref":
            for chunk in CHUNK_CANDIDATES:
                ms = timer(lambda c=chunk: spmm_stream(
                    blocks, sel, rows, cols, h, n_row_blocks=rb, bm=bm,
                    bk=bk, chunk=c))
                cands.append((ms, SpmmConfig(bd=dflt, chunk=chunk,
                                             source="swept", backend="ref")))
        elif backend == "dense":
            ms = timer(lambda: dense_spmm(blocks, sel, rows, cols, h,
                                          n_row_blocks=rb, bm=bm, bk=bk))
            cands.append((ms, SpmmConfig(bd=dflt, chunk=DEFAULT_CHUNK,
                                         source="swept", backend="dense")))
        elif backend == "kernel_plain":
            plain = True
            ms = timer(lambda: kops.bcoo_spmm_in_range(
                blocks, sel, rows, cols, h, n_row_blocks=rb, bm=bm, bk=bk,
                bd=dflt, row_ptr=rptr))
            cands.append((ms, SpmmConfig(bd=dflt, chunk=DEFAULT_CHUNK,
                                         source="swept", backend="kernel")))
        else:   # "kernel", on the card
            n_sm = torch.cuda.get_device_properties(
                device).multi_processor_count
            for bd in kernel_candidates(dd, n_row_blocks=rb, s_pad=s,
                                        n_sm=n_sm):
                ms = timer(lambda b=bd: kops.bcoo_spmm_in_range(
                    blocks, sel, rows, cols, h, n_row_blocks=rb, bm=bm,
                    bk=bk, bd=b, row_ptr=rptr))
                cands.append((ms, SpmmConfig(bd=bd, chunk=DEFAULT_CHUNK,
                                             source="swept",
                                             backend="kernel")))
    _cache.stats.sweep_launches += kmod.launches - before
    ms, cfg = min(cands, key=lambda c: c[0])
    prov = {"backend": backend,
            "platform": "gpu" if on_card else "cpu",
            "device": (torch.cuda.get_device_name(device) if on_card
                       else "cpu"),
            "plain": plain,
            "candidates": {str(c.bd if backend == "kernel" else c.chunk):
                           round(t * 1e3, 2) for t, c in cands}}
    return cfg, ms * 1e3, prov
