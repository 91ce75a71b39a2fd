"""Meshes of ranks over named axes (the port of ``repro.launch.mesh``).

The reference lays JAX devices out on a ``jax.sharding.Mesh``; the port
runs one process per rank and lays the ranks of a ``torch.distributed``
group out on a :class:`Mesh`: a grid with named axes (``data``, ``model``,
``pod``, or any other name), filled row-major, so rank ``ranks[i]`` sits
at the ``i``-th coordinate of ``np.ndindex(shape)``, as
``np.array(devices).reshape(shape)`` places devices in the reference.

A mesh on its own is abstract: its shape and names, which is all the
sharding rules (``launch.shardings``) read. ``Mesh.bind`` attaches it to
the running process group: every rank of the world calls it (creating a
process group is collective), and each gets back a mesh that knows its
own coordinates and one process group per axis line (the ranks that
share every other coordinate: the ``model`` group of a rank holds the
ranks with its ``data`` coordinate, and the reverse). The collectives the
sharded LM step needs (``all_gather``, ``reduce_scatter``, ``all_reduce``)
run over such a line, named by its axes. Under gloo, CUDA tensors go
through the host (gloo gathers no CUDA tensors): that is a functional
path, not a measure of NCCL.

A bound mesh counts its collectives in ``stats`` (``{op: {"calls",
"ms", "bytes", "result_bytes"}}``, host clock, bytes of this rank's input
and of its result: an all-gather's result is n times its input, a
reduce-scatter's 1/n); with ``sync_timing`` set it synchronises the card
around each one, so ``ms`` is the collective's time and not its enqueue
(NCCL returns at once). ``collective_bytes`` gives the count and result
bytes in the layout of the reference's ``launch/hlo_stats.py``.

``fake_world`` binds a mesh to a fake process group (``torch.distributed``'s
``fake`` backend: every collective returns at once, its result
uninitialised) of the mesh's size, as one of its ranks: on ``meta``
tensors a rank's step of any mesh then runs in one process without
memory or data (``launch/dryrun.py``).

``make_production_mesh`` (TPU pod shapes) is not ported.
"""
from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch
import torch.distributed as dist

DP_AXES = ("pod", "data")


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _axes(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Ranks on a grid of named axes (see the module's docstring).

    ``shape`` maps each axis name to its size, in order, as a JAX mesh's
    ``shape`` does; ``ranks`` are the global ranks in row-major order
    (``0 .. size-1`` by default). A bound mesh (``bind``) also has
    ``rank`` (this process's global rank, ``None`` outside the mesh),
    ``device`` and the process groups of its axis lines."""

    def __init__(self, sizes, axis_names, ranks=None):
        self.sizes = tuple(int(s) for s in sizes)
        self.axis_names = tuple(axis_names)
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.sizes} and axes "
                             f"{self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        n = math.prod(self.sizes)
        self.ranks = tuple(range(n)) if ranks is None else tuple(ranks)
        if len(self.ranks) != n:
            raise ValueError(f"a {self.sizes} mesh holds {n} ranks, got "
                             f"{len(self.ranks)}")
        self.rank = None
        self.device = None
        self._groups: dict[tuple[str, ...], object] = {}
        self._bound = False
        self.fake = False        # bound to a fake process group
        self.sync_timing = False
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = {op: {"calls": 0, "ms": 0.0, "bytes": 0,
                           "result_bytes": 0}
                      for op in ("all_gather", "reduce_scatter",
                                 "all_reduce")}

    def collective_bytes(self) -> dict:
        """``stats`` in the reference's ``hlo_stats.collective_bytes``
        layout: ``{kind: {"count", "bytes"}}`` (result bytes),
        ``total_bytes`` and ``total_count``."""
        kinds = {kind: {"count": self.stats[op]["calls"],
                        "bytes": self.stats[op]["result_bytes"]}
                 for op, kind in (("all_gather", "all-gather"),
                                  ("all_reduce", "all-reduce"),
                                  ("reduce_scatter", "reduce-scatter"))}
        return {**kinds,
                "total_bytes": sum(v["bytes"] for v in kinds.values()),
                "total_count": sum(v["count"] for v in kinds.values())}

    def _timed(self, op: str, t: torch.Tensor, fn):
        """Run ``fn()`` (the collective on ``t``) and count it."""
        sync = self.sync_timing and t.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = fn()
        if sync:
            torch.cuda.synchronize(t.device)
        st = self.stats[op]
        st["calls"] += 1
        st["ms"] += (time.perf_counter() - t0) * 1e3
        st["bytes"] += t.numel() * t.element_size()
        st["result_bytes"] += out.numel() * out.element_size()
        return out

    # ------------------------------------------------------------ shape
    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.ranks)

    def axis_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name, a tuple of names
        or None); an axis the mesh lacks counts 1."""
        return math.prod(self.shape.get(a, 1) for a in _axes(axes))

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({dims})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and (
            self.sizes, self.axis_names, self.ranks) == (
            other.sizes, other.axis_names, other.ranks)

    def __hash__(self) -> int:
        return hash((self.sizes, self.axis_names, self.ranks))

    # ------------------------------------------------------------ coordinates
    def coords_of(self, rank: int) -> dict[str, int]:
        """The coordinates of global ``rank`` on the mesh."""
        i = self.ranks.index(rank)
        return {a: int(c) for a, c in
                zip(self.axis_names, np.unravel_index(i, self.sizes))}

    @property
    def member(self) -> bool:
        return self.rank is not None

    @property
    def coords(self) -> dict[str, int]:
        if not self.member:
            raise ValueError(f"this process is not a rank of {self!r}")
        return self.coords_of(self.rank)

    def index(self, axes) -> int:
        """This rank's linear index over ``axes`` (row-major in mesh
        order): its block of a dimension split over them."""
        c = self.coords
        idx = 0
        for a in self.axis_names:
            if a in _axes(axes):
                idx = idx * self.shape[a] + c[a]
        return idx

    @property
    def dp_axes(self) -> tuple[str, ...]:
        """The mesh's batch axes (``pod`` and ``data``, those present)."""
        return tuple(a for a in DP_AXES if a in self.axis_names)

    def _lines(self, axes: tuple[str, ...]) -> list[list[int]]:
        """Every line of the mesh along ``axes``: the global ranks that
        share their coordinates on every other axis, sorted."""
        others = [i for i, a in enumerate(self.axis_names) if a not in axes]
        lines: dict[tuple, list[int]] = {}
        for pos, r in zip(np.ndindex(*self.sizes), self.ranks):
            lines.setdefault(tuple(pos[i] for i in others), []).append(r)
        return [sorted(v) for v in lines.values()]

    # ------------------------------------------------------------ binding
    def bind(self, device: torch.device | str | None = None) -> "Mesh":
        """This mesh attached to the running process group. Every rank of
        the world must call it, in the same order as the others (creating
        a process group is collective). Returns a new mesh with ``rank``
        (``None`` on a rank outside the mesh), ``device`` and a process
        group for each single axis, for the batch axes together and for
        the whole mesh."""
        if not dist.is_initialized():
            raise RuntimeError("Mesh.bind needs an initialised process "
                               "group (distributed.group.launch)")
        world = dist.get_world_size()
        if max(self.ranks) >= world:
            raise ValueError(f"{self!r} needs ranks {self.ranks}, the world "
                             f"has {world}")
        out = Mesh(self.sizes, self.axis_names, self.ranks)
        me = dist.get_rank()
        out.rank = me if me in self.ranks else None
        out.fake = dist.get_backend() == "fake"
        out.device = torch.device(device) if device is not None else None
        subsets = [(a,) for a in self.axis_names]
        if len(self.dp_axes) > 1:
            subsets.append(self.dp_axes)
        subsets.append(self.axis_names)
        for axes in dict.fromkeys(subsets):
            for line in self._lines(axes):
                if len(line) < 2:
                    continue
                g = dist.new_group(ranks=line)
                if me in line:
                    out._groups[axes] = g
        out._bound = True
        return out

    def _group(self, axes):
        axes = tuple(a for a in self.axis_names if a in _axes(axes))
        if self.axis_size(axes) == 1:
            return None
        if not self._bound:
            raise RuntimeError(f"{self!r} is not bound to a process group")
        if axes not in self._groups:
            raise ValueError(f"{self!r} has no process group over {axes}")
        return self._groups[axes]

    # ------------------------------------------------------------ collectives
    @staticmethod
    def _staged(t: torch.Tensor, group) -> bool:
        """Whether ``t`` must go through the host: gloo and a CUDA
        tensor."""
        return t.device.type == "cuda" and dist.get_backend(group) == "gloo"

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The blocks of ``t`` of every rank of this rank's line along
        ``axes``, concatenated along ``dim`` in line order."""
        group = self._group(axes)
        if group is None:
            return t
        return self._timed("all_gather", t,
                           lambda: self._all_gather(t, group, dim))

    def _all_gather(self, t, group, dim):
        n = dist.get_world_size(group)
        if dist.get_backend(group) == "gloo":   # on the host
            src = t.detach().cpu().contiguous()
            parts = [torch.empty_like(src) for _ in range(n)]
            dist.all_gather(parts, src, group=group)
            return torch.cat(parts, dim).to(t.device)
        src = t.detach().movedim(dim, 0).contiguous()
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, axes,
                       dim: int) -> torch.Tensor:
        """The sum of ``t`` over this rank's line along ``axes``, of which
        this rank keeps its block along ``dim`` (its ``index(axes)``)."""
        group = self._group(axes)
        if group is None:
            return t
        if t.shape[dim] % dist.get_world_size(group):
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {dist.get_world_size(group)} ranks")
        return self._timed("reduce_scatter", t,
                           lambda: self._reduce_scatter(t, group, dim))

    def _reduce_scatter(self, t, group, dim):
        n = dist.get_world_size(group)
        if dist.get_backend(group) == "gloo":
            # the sum everywhere, then this rank's block (on the host)
            full = t.detach().cpu().clone().contiguous()
            dist.all_reduce(full, group=group)
            k = t.shape[dim] // n
            i = dist.get_group_rank(group, dist.get_rank())
            return full.narrow(dim, i * k, k).contiguous().to(t.device)
        src = t.detach().movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()

    def all_reduce(self, t: torch.Tensor, axes,
                   op: str = "sum") -> torch.Tensor:
        """The sum (or max) of ``t`` over this rank's line along
        ``axes``, as a new tensor."""
        group = self._group(axes)
        if group is None:
            return t
        return self._timed("all_reduce", t,
                           lambda: self._all_reduce(t, group, op))

    def _all_reduce(self, t, group, op):
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self._staged(t, group):
            buf = t.detach().cpu().contiguous()
            dist.all_reduce(buf, op=red, group=group)
            return buf.to(t.device)
        buf = t.detach().clone().contiguous()
        dist.all_reduce(buf, op=red, group=group)
        return buf


    # ---------------------------------------------------- many at once
    def all_gather_many(self, ts: list[torch.Tensor],
                        axes) -> list[list[torch.Tensor]]:
        """``all_gather`` of several tensors (one dtype) in one
        collective: for each, every rank's block of this rank's line
        along ``axes``, in line order."""
        group = self._group(axes)
        if group is None:
            return [[t] for t in ts]
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        rows = self.all_gather(flat[None], axes, 0)      # (n, total)
        return [[r.view(t.shape) for r in rows[:, a:a + t.numel()]]
                for t, a in zip(ts, _offsets(ts))]

    def reduce_scatter_many(self, parts: list[list[torch.Tensor]],
                            axes) -> list[torch.Tensor]:
        """``reduce_scatter`` of several tensors (one dtype) in one
        collective: ``parts[i][r]`` is rank ``r``'s block of tensor ``i``;
        returns this rank's block of each, summed over the line."""
        group = self._group(axes)
        if group is None:
            return [p[0] for p in parts]
        n = len(parts[0])
        rows = torch.stack([torch.cat([p[r].reshape(-1) for p in parts])
                            for r in range(n)])              # (n, total)
        mine = self.reduce_scatter(rows, axes, 0)[0]
        blocks = [p[0] for p in parts]
        return [mine[a:a + b.numel()].view(b.shape)
                for b, a in zip(blocks, _offsets(blocks))]

    def all_reduce_many(self, ts: list[torch.Tensor],
                        axes) -> list[torch.Tensor]:
        """``all_reduce`` (sum) of several tensors (one dtype) in one
        collective."""
        group = self._group(axes)
        if group is None:
            return list(ts)
        flat = self.all_reduce(torch.cat([t.reshape(-1) for t in ts]), axes)
        return [flat[a:a + t.numel()].view(t.shape)
                for t, a in zip(ts, _offsets(ts))]


@contextlib.contextmanager
def fake_world(mesh: Mesh, rank: int = 0):
    """``mesh`` bound as global ``rank`` of a fake process group of the
    mesh's size (see the module's docstring), torn down on exit. Needs a
    process with no process group (run it in a process of its own, or
    where none exists yet)."""
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a process "
                           "group; this one has one")
    # registers the "fake" backend (no tensor of it touches the store)
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=mesh.size)
    try:
        yield mesh.bind()
    finally:
        dist.destroy_process_group()


def _offsets(ts) -> list[int]:
    out, a = [], 0
    for t in ts:
        out.append(a)
        a += t.numel()
    return out


def make_test_mesh(n_devices: int | None = None, model: int = 2) -> Mesh:
    """A ``(data, model)`` mesh over ``n_devices`` ranks (by default the
    world's size)."""
    n = n_devices or _world()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    return Mesh((n // model, model), ("data", "model"))


def make_dp_mesh(n_devices: int | None = None) -> Mesh:
    """A pure data-parallel ``("data",)`` mesh over the first N ranks of
    the world (all of them by default); N larger than the world raises."""
    avail = _world()
    n = n_devices or avail
    if dist.is_initialized() and n > avail:
        raise ValueError(f"requested data-parallel degree {n} > {avail} "
                         "ranks in the process group")
    return Mesh((n,), ("data",))


def parse_mesh_spec(spec: str) -> Mesh:
    """A ``--mesh`` spec such as ``"4"``, ``"data:4"`` or
    ``"data:2,model:2"``: axes in the spec's order, any names; a bare
    integer is a pure ``("data",)`` mesh of that size."""
    parts = [p for p in spec.split(",") if p]
    if len(parts) == 1 and ":" not in parts[0]:
        return make_dp_mesh(int(parts[0]))
    names, sizes = [], []
    for p in parts:
        name, _, size = p.partition(":")
        if not name or not size:
            raise ValueError(f"--mesh {spec!r}: expected axis:size, got "
                             f"{p!r}")
        names.append(name)
        sizes.append(int(size))
    return Mesh(tuple(sizes), tuple(names))


def dp_axes(mesh: Mesh, global_batch: int):
    """The mesh's batch axes (``pod``, ``data``) whose sizes divide
    ``global_batch``, in order, or None."""
    names = [a for a in DP_AXES if a in mesh.axis_names]
    size = 1
    kept = []
    for a in names:
        s = mesh.shape[a]
        if global_batch % (size * s) == 0:
            kept.append(a)
            size *= s
    return tuple(kept) if kept else None
