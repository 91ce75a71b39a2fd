"""Process groups for data-parallel training on ``torch.distributed``.

The port's counterpart of ``repro.launch.hostdev`` and of how the
reference's GNN training takes its ``("data",)`` mesh of devices
(``launch/mesh.py`` ports the meshes themselves). The reference runs one
process over the mesh; the port runs one process per rank, PyTorch's own
idiom:

* ``parse_mesh_spec`` reads the GNN's ``--mesh`` (``"N"`` or
  ``"data:N"``; another axis raises, naming it) as the data-parallel
  degree;
* ``plan_group`` chooses the backend, with no silent fallback: NCCL with
  one card per rank when the degree fits the visible cards; gloo with
  every rank on the one device ``--device`` names when
  ``force_host_devices`` asks for that many (the CPU in the tests, one
  card for a functional check: NCCL refuses two ranks on one GPU);
  otherwise it raises, as ``make_dp_mesh`` does;
* ``launch`` starts the ranks with ``torch.multiprocessing`` (``spawn``:
  CUDA does not survive ``fork``), meeting at a ``file://`` rendezvous in
  a temporary directory (parallel test workers never fight over a TCP
  port), with a timeout on every collective so one dead rank cannot hang
  the others. A failed rank fails the whole run with its traceback. Each
  rank's return value comes back to the caller, in rank order. Under
  ``torchrun`` (``WORLD_SIZE`` set) the group comes from the environment
  and only this process's rank runs.

:class:`DPGroup` is what a rank's code holds: its rank, the world size,
its device and the collectives the trainer uses. Host statistics travel
as Python objects (``*_object`` collectives), since gloo gathers no CUDA
tensors.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

DEFAULT_TIMEOUT_S = 300.0


def parse_mesh_spec(spec: str) -> int:
    """The data-parallel degree of a GNN ``--mesh`` spec: ``"N"`` or
    ``"data:N"``, parsed by ``launch.mesh.parse_mesh_spec`` (which takes
    any axes). The GNN's data-parallel training has one axis: any other
    raises, naming it."""
    from repro_torch.launch.mesh import parse_mesh_spec as parse
    parts = [p for p in spec.split(",") if p]
    if len(parts) == 1 and ":" not in parts[0]:
        return int(parts[0])
    mesh = parse(spec)
    for name in mesh.axis_names:
        if name != "data":
            raise ValueError(
                f"--mesh {spec!r}: axis {name!r} is not supported (the "
                "port's data-parallel training has one axis, 'data')")
    if "data" not in mesh.shape:
        raise ValueError(f"--mesh {spec!r} lacks a 'data' axis")
    return mesh.shape["data"]


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """How a run's ranks meet: world size, backend, each rank's device."""

    world_size: int
    backend: str                 # "nccl" | "gloo"
    devices: tuple[str, ...]     # one per rank


def plan_group(dp: int, *, force_host_devices: int = 0,
               device: str = "cuda") -> GroupPlan:
    """The group for ``dp`` ranks on ``device`` (``cuda`` raises without
    a card). ``force_host_devices`` N ≥ dp puts every rank on that one
    device over gloo."""
    dev = resolve_device(device)
    if force_host_devices:
        if dp > force_host_devices:
            raise ValueError(
                f"requested data-parallel degree {dp} > "
                f"{force_host_devices} visible devices (--force-host-"
                f"devices {force_host_devices})")
        return GroupPlan(dp, "gloo", (str(dev),) * dp)
    if dev.type != "cuda":
        raise ValueError(
            f"requested data-parallel degree {dp} > 1 visible devices (the "
            f"CPU; pass --force-host-devices {dp} to run {dp} gloo ranks on "
            "it)")
    n = torch.cuda.device_count()
    if dp > n:
        raise ValueError(
            f"requested data-parallel degree {dp} > {n} visible devices "
            f"(pass --force-host-devices {dp} to run {dp} gloo ranks on "
            "one card)")
    return GroupPlan(dp, "nccl", tuple(f"cuda:{r}" for r in range(dp)))


@dataclasses.dataclass
class DPGroup:
    """One rank's view of the data-parallel group."""

    rank: int
    world_size: int
    backend: str
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _host_device(self) -> torch.device:
        """Where small host-side tensors go for a collective (NCCL takes
        only CUDA tensors)."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def all_reduce_sum(self, t: torch.Tensor, async_op: bool = False):
        return dist.all_reduce(t, op=dist.ReduceOp.SUM, async_op=async_op)

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the mean over ranks (a sum, then a divide by the
        world size: gloo has no average)."""
        self.all_reduce_sum(t)
        return t.div_(self.world_size)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src=src)
        return t

    def sum_ints(self, values: list[int]) -> list[int]:
        t = torch.tensor(values, dtype=torch.int64,
                         device=self._host_device())
        self.all_reduce_sum(t)
        return [int(v) for v in t.tolist()]

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        out = [None] * self.world_size
        dist.all_gather_object(out, obj)
        return out

    def broadcast_object(self, obj, src: int = 0):
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def barrier(self) -> None:
        dist.barrier()


def _init(plan: GroupPlan, rank: int, init_method: str,
          timeout_s: float) -> DPGroup:
    device = torch.device(plan.devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # NCCL binds its communicator to the rank's card up front (without
    # device_id it guesses, and warns)
    bind = {"device_id": device} if plan.backend == "nccl" else {}
    dist.init_process_group(
        plan.backend, init_method=init_method, world_size=plan.world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s), **bind)
    return DPGroup(rank, plan.world_size, plan.backend, device)


def _rank_main(rank: int, fn, args: tuple, plan: GroupPlan,
               init_method: str, out_dir: str, threads: int | None,
               timeout_s: float) -> None:
    """A spawned rank: join the group, run ``fn(group, *args)``, leave its
    return value in ``out_dir``."""
    if threads:
        torch.set_num_threads(threads)
    group = _init(plan, rank, init_method, timeout_s)
    try:
        out = fn(group, *args)
        path = Path(out_dir) / f"rank{rank}.pkl"
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, path)
    finally:
        dist.destroy_process_group()


def launch(fn, args: tuple = (), *, plan: GroupPlan,
           threads: int | None = None,
           timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(group, *args)`` on every rank of ``plan``; returns the
    ranks' return values in rank order (under ``torchrun``: this
    process's only). ``fn`` must be importable by name (a module-level
    function): spawned ranks import it afresh. ``threads`` sets each
    rank's intra-op threads (by default the CPU's threads shared among
    CPU ranks)."""
    world = int(os.environ.get("WORLD_SIZE", "0") or 0)
    if world > 1:
        return [_run_from_env(fn, args, plan, world, timeout_s)]
    if threads is None and plan.devices[0] == "cpu":
        threads = max(1, torch.get_num_threads() // plan.world_size)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro-torch-dp-") as tmp:
        mp.start_processes(
            _rank_main, nprocs=plan.world_size, join=True,
            start_method="spawn",
            args=(fn, args, plan, f"file://{Path(tmp) / 'rendezvous'}",
                  tmp, threads, timeout_s))
        outs = []
        for r in range(plan.world_size):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                outs.append(pickle.load(f))
    return outs


def _run_from_env(fn, args: tuple, plan: GroupPlan, world: int,
                  timeout_s: float):
    """Under ``torchrun``: this process is rank ``RANK`` of ``WORLD_SIZE``
    (which must be the plan's), on ``cuda:LOCAL_RANK`` for NCCL."""
    if world != plan.world_size:
        raise ValueError(f"WORLD_SIZE {world} != the requested degree "
                         f"{plan.world_size}")
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    devices = (tuple(f"cuda:{local}" for _ in range(world))
               if plan.backend == "nccl" else plan.devices)
    group = _init(dataclasses.replace(plan, devices=devices), rank,
                  "env://", timeout_s)
    try:
        return fn(group, *args)
    finally:
        dist.destroy_process_group()
