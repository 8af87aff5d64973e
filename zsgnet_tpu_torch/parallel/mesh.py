"""The data mesh — port of ``zsgnet_tpu/parallel/mesh.py`` on
``torch.distributed``.

The JAX package runs data parallelism as one SPMD program over a 1-D
``data`` mesh of devices; here it is one process per device, joined in a
process group: NCCL between CUDA devices, gloo on the CPU. The numbers keep
the JAX semantics, so the number of ranks does not show in them: ``cfg.bs``
is the global batch, rank *r* takes slice *r* of every global batch, losses
are normalized by the global positive count and gradients are summed over
the ranks (``parallel.train_step``), and BatchNorm moments are global
(``models.resnet.BatchNorm2d``).

Launch one process per device with ``torch.distributed.run`` (torchrun),
which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; :func:`init_distributed` reads them, or takes an explicit
store (the tests use a ``FileStore``). A failure to set up the group
raises: nothing switches backend or drops to a single process.

Host-side traffic (the stop flag, the gather of evaluation metadata, the
barrier around checkpoint writes) goes through a gloo group over the same
ranks, so it needs no device and no synchronization with the device
stream under either backend. Every device collective runs under the
profiler label ``dp::all_reduce`` (:func:`all_reduce_`), which is how a
trace shows the data-parallel share of a step.

``cfg.mesh_spatial = S > 1`` makes the mesh 2-D, ``(data, spatial)`` as in
the JAX package, over the same ranks laid out data-major: rank = d·S + s,
so each spatial group is S consecutive ranks with a process group of its
own (``DataMesh.spatial_group``; ``parallel.halo`` exchanges rows in it).
The loaders shard each global batch over the D = world/S data indices, so
the members of a spatial group hold the same samples. After the backbone's
reshard each rank holds its own block of them, so losses, gradients and
BatchNorm moments stay summed over the whole world (``group``), and the
rank order of :func:`all_gather_host` is the global batch's order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist
from torch.profiler import record_function

from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.utils.backend import resolve_device

Tensor = torch.Tensor

# Gradients are all-reduced in buckets of this many bytes (DDP's default).
BUCKET_BYTES = 25 * 2**20


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One process's place in the data mesh: its rank, the world size, its
    device, the process group of the device collectives and a gloo group
    over the same ranks for host objects. Under spatial partitioning
    (``spatial`` S > 1) the rank is d·S + s: ``data_index`` d of
    ``data_size`` and member s (``spatial_index``) of ``spatial_group``."""

    rank: int
    world_size: int
    device: torch.device
    group: Any
    host_group: Any
    spatial: int = 1
    spatial_group: Any = None

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    @property
    def data_size(self) -> int:
        return self.world_size // self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial


_HOST_GROUPS: dict[Any, Any] = {}
_SPATIAL_GROUPS: dict[tuple[Any, int], Any] = {}


def _host_group(group) -> Any:
    """A gloo group over ``group``'s ranks: ``group`` itself under gloo."""
    if dist.get_backend(group) == "gloo":
        return group
    if group not in _HOST_GROUPS:
        _HOST_GROUPS[group] = dist.new_group(backend="gloo")
    return _HOST_GROUPS[group]


def init_distributed(
    device: str | torch.device = "cuda", backend: str | None = None, *,
    store: dist.Store | None = None, rank: int | None = None, world_size: int | None = None,
) -> DataMesh:
    """Join the process group and → this process's :class:`DataMesh`.

    Without ``store`` the rank, the world size and the rendezvous come from
    the environment that ``torch.distributed.run`` sets; a bare ``cuda``
    device becomes ``cuda:LOCAL_RANK``. The backend is NCCL for a CUDA
    device and gloo for the CPU, unless the caller passes ``backend``."""
    dev = torch.device(device)
    if store is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"init_distributed: {missing} not set — launch with "
                               "python -m torch.distributed.run (torchrun), or pass store=")
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    elif rank is None or world_size is None:
        raise ValueError("init_distributed(store=...) needs rank= and world_size=")
    dev = resolve_device(dev)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw: dict[str, Any] = dict(backend=backend, rank=rank, world_size=world_size)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = "env://"
    dist.init_process_group(**kw)
    group = dist.group.WORLD
    return DataMesh(rank, world_size, dev, group, _host_group(group))


def make_mesh(cfg: Config, device: str | torch.device = "cuda") -> DataMesh:
    """The data mesh of the process group that is up, with ``device`` as
    this rank's device. Keeps the JAX checks: the mesh is 1-D, or 2-D
    ``(data, spatial)`` with ``cfg.mesh_spatial`` S > 1, where S must divide
    the ranks (``mesh_shape`` -1) and data·S may not exceed them. The mesh
    spans every rank."""
    if len(cfg.mesh_shape) != 1:
        raise ValueError("zsgnet uses a 1-D data mesh (the model fits one chip)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group — call init_distributed first")
    world = dist.get_world_size()
    n = cfg.mesh_shape[0]
    sp = max(int(cfg.mesh_spatial), 1)
    if sp > 1:
        if n == -1 and world % sp:
            raise ValueError(
                f"mesh_spatial={sp} does not divide the {world} devices; "
                "pick a divisor or set mesh_shape=(n,) explicitly"
            )
        n = n if n != -1 else world // sp
        if n < 1 or n * sp > world:
            raise ValueError(f"mesh (data={n}, spatial={sp}) needs {max(n, 1) * sp} devices, have {world}")
    if n not in (-1, world // sp):
        raise ValueError(f"mesh_shape={tuple(cfg.mesh_shape)} but the process group has {world} "
                         "ranks: the data mesh spans every rank (-1 for all)")
    group = dist.group.WORLD
    rank = dist.get_rank()
    spatial_group = _spatial_group(group, sp, rank) if sp > 1 else None
    return DataMesh(rank, world, resolve_device(device), group, _host_group(group), sp, spatial_group)


def _spatial_group(world_group, sp: int, rank: int) -> Any:
    """This rank's spatial group: ranks [d·S, (d+1)·S). Every rank creates
    every group, in the same order, once per default group."""
    key = (world_group, sp)
    if key not in _SPATIAL_GROUPS:
        groups = [dist.new_group(list(range(d * sp, (d + 1) * sp))) for d in range(dist.get_world_size() // sp)]
        _SPATIAL_GROUPS[key] = groups
    return _SPATIAL_GROUPS[key][rank // sp]


def data_shard(cfg: Config) -> tuple[int, int]:
    """(shard, shards) of the loaders in the process group that is up: the
    data index and data size of the ``(data, spatial)`` grid (rank and
    world for a 1-D mesh), (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    sp = max(int(cfg.mesh_spatial), 1)
    return dist.get_rank() // sp, dist.get_world_size() // sp


def local_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """Every local device of ``device``'s type (the one CPU for ``cpu``):
    where data-parallel serving puts its replicas."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def is_main_process() -> bool:
    """Rank 0, or no process group: the process that logs and writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def all_reduce_(t: Tensor, group=None) -> Tensor:
    """Sum ``t`` over the group's ranks, in place, under the profiler label
    ``dp::all_reduce``."""
    with record_function("dp::all_reduce"):
        dist.all_reduce(t, group=group)
    return t


def all_reduce_sum_(tensors: list[Tensor], group=None) -> None:
    """Sum each tensor over the group's ranks, in place: one collective per
    bucket of at most ``BUCKET_BYTES`` of one dtype."""
    buckets: list[list[Tensor]] = []
    size, key = 0, None
    for t in tensors:
        n = t.numel() * t.element_size()
        if not buckets or t.dtype != key or size + n > BUCKET_BYTES:
            buckets.append([])
            size, key = 0, t.dtype
        buckets[-1].append(t)
        size += n
    for bucket in buckets:
        if len(bucket) == 1:
            all_reduce_(bucket[0], group)
            continue
        flat = all_reduce_(torch.cat([t.reshape(-1) for t in bucket]), group)
        torch._foreach_copy_(bucket, [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in bucket]), bucket)])


def all_reduce_sum(t: Tensor, group=None) -> Tensor:
    """The sum of ``t`` over the group's ranks, as a new tensor."""
    return all_reduce_(t.detach().clone(), group)


def all_gather_host(obj: Any, mesh: DataMesh) -> list[Any]:
    """Every rank's ``obj`` (host values: numpy arrays, lists, numbers), in
    rank order, through the host group."""
    out: list[Any] = [None] * mesh.world_size
    dist.all_gather_object(out, obj, group=mesh.host_group)
    return out


def any_rank(flag: bool, mesh: DataMesh) -> bool:
    """True on every rank when ``flag`` is true on any rank."""
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, group=mesh.host_group)
    return bool(t.item())


def barrier(mesh: DataMesh) -> None:
    """Wait for every rank, on the host."""
    dist.barrier(group=mesh.host_group)
