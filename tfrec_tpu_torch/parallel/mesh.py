"""Process groups and the mesh: the counterpart of
``tfrec_tpu/parallel/mesh.py`` over ``torch.distributed``.

One process a rank, one device a process. The mesh is the reference's two
axes, ``data`` x ``table``, over D * T ranks laid out row-major as its
devices are: rank r is ``(d, t) = (r // T, r % T)``. The batch is split
over ``data`` (ranks that share a d hold the same rows), dense params are
replicated, row-sharded tables give each data index a contiguous block of
rows (the reference's ``P('data', None)``, replicated over ``table``) and
column-sharded tables give each table index D/T of every row's columns
(``P(None, 'table')``, replicated over ``data``).

``init_distributed`` starts the process group. The backend is NCCL where
each rank has a card of its own, gloo on the CPU, and gloo over CUDA
tensors where ranks share one card (NCCL refuses two ranks on one device):
that one is chosen by name, ``backend="gloo"`` with ``device="cuda"``,
never as a fallback, and said on standard output. Gloo's collectives then
take host copies of the tensors (``Mesh`` stages them).

The collectives are ``Mesh`` methods named by axis, each counted in
``Mesh.calls``: an equal-split ``all_to_all`` of an [n, ...] buffer (row j
goes to the axis' j-th rank; row j of the result came from it, the
reference's ``all_to_all(split_axis=0, concat_axis=0, tiled=True)``),
``all_sum``, ``all_mean`` and ``all_gather`` (tiled on a dim). Beside
``calls``, ``Mesh.counters`` keeps what the row exchange moves, cumulative
from the mesh's start (``count``): ``a2a_bytes.<tag>`` the bytes of each
``all_to_all``'s buffer as it goes, padding and this rank's own row included
(``parallel/embedding.py`` tags ``ids``, ``lookup`` and ``update``), and the
exchange's ``lookup_ids``, ``distinct_sent`` and ``lookup_overflow``. An axis that
holds every rank runs over the default group, so with T = 1 the data axis'
calls are those of a one-axis mesh, and at world size 1 each still goes
through the group as an identity; an axis of size 1 on more ranks is local (no call);
any other axis runs over its own group, one a coordinate of the other
axis, which every rank creates in the same order (``make_mesh``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List

import torch
import torch.distributed as dist

BACKENDS = ("auto", "nccl", "gloo")


def _local_ranks(world_size: int) -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` where a launcher sets it,
    else every rank (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))


def local_device(device: torch.device | str, rank: int) -> torch.device:
    """A rank's device: ``cuda:{local rank % cards}`` for "cuda" (ranks
    sharing a card all take it), the given one otherwise."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but CUDA is not available; pass "
                           "device='cpu' to run the ranks on the CPU")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_distributed(init_method: str, world_size: int, rank: int, *,
                     backend: str = "auto", device: torch.device | str = "cuda",
                     timeout_s: float = 600.0) -> torch.device:
    """Start the default process group and return this rank's device.

    ``init_method`` is ``tcp://host:port`` of rank 0 (the reference's
    ``JAX_COORDINATOR``). ``backend="auto"`` takes NCCL on the card, which
    needs a card a rank on this host (it raises otherwise, naming gloo),
    and gloo on the CPU; ``"gloo"`` on the card shares it between ranks
    through host copies, and says so."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    dev = local_device(device, rank)
    if backend == "auto":
        if dev.type == "cuda":
            if _local_ranks(world_size) > torch.cuda.device_count():
                raise ValueError(
                    f"{_local_ranks(world_size)} ranks on this host but {torch.cuda.device_count()} "
                    "card(s): NCCL needs a card a rank; pass backend='gloo' to share the card "
                    "through host copies")
            backend = "nccl"
        else:
            backend = "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' needs device='cuda'")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "gloo" and dev.type == "cuda":
        print(f"rank {rank}: backend gloo over CUDA tensors on {dev} (collectives staged through "
              "host copies; ranks share the card)", flush=True)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def world_size() -> int:
    """The default group's size, 1 without a process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


AXES = ("data", "table")


@dataclasses.dataclass
class Mesh:
    """The ``data`` x ``table`` mesh: ``shape`` ``{"data": D, "table": T}``,
    ``rank`` this process's global rank, ``device`` its device, ``backend``
    the group's; ``groups`` the process group of each axis that neither
    holds every rank nor has size 1 (``make_mesh`` fills it). ``calls``
    counts its collective calls, ``counters`` what the exchange moves: host
    ints, or 0-d device tensors that add up without a synchronize."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    backend: str
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    calls: int = 0
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def count(self, name: str, value) -> None:
        """Adds ``value`` (an int or a 0-d device tensor) to ``counters[name]``."""
        self.counters[name] = self.counters.get(name, 0) + value

    @property
    def size(self) -> int:
        """The data axis' size (the batch's split, row-sharded blocks)."""
        return self.shape["data"]

    @property
    def world(self) -> int:
        return self.shape["data"] * self.shape["table"]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["table"]

    @property
    def table_index(self) -> int:
        return self.rank % self.shape["table"]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.data_index if axis == "data" else self.table_index

    def _local(self, axis: str) -> bool:
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; options: {AXES}")
        return self.shape[axis] == 1 and self.world > 1

    def _group(self, axis: str):
        return None if self.shape[axis] == self.world else self.groups[axis]

    @property
    def _staged(self) -> bool:
        # Gloo over CUDA tensors: the collective runs on host copies.
        return self.backend == "gloo" and self.device.type == "cuda"

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self._staged else t

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self._staged else t

    def all_to_all(self, buf: torch.Tensor, axis: str = "data", tag: str = "other") -> torch.Tensor:
        """[n, ...] -> [n, ...] over ``axis`` (n its size): row j goes to its
        j-th rank, row j of the result came from it. Any dtype: the bytes
        are moved, and counted in ``counters["a2a_bytes.<tag>"]``."""
        n = self.shape[axis]
        if buf.shape[0] != n:
            raise ValueError(f"all_to_all takes [{n}, ...] buffers, got {tuple(buf.shape)}")
        if self._local(axis):
            return buf.clone()
        src = buf.contiguous()
        wire = src.view(torch.uint8) if src.dtype == torch.bfloat16 else src
        wire = self._host(wire)
        out = torch.empty_like(wire)
        self.calls += 1
        self.count(f"a2a_bytes.{tag}", wire.numel() * wire.element_size())
        dist.all_to_all_single(out, wire, group=self._group(axis))
        out = self._back(out)
        return out.view(torch.bfloat16) if src.dtype == torch.bfloat16 else out

    def all_sum(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """The sum over ``axis`` of ``t`` (a new tensor)."""
        if self._local(axis):
            return t.clone()
        out = self._host(t.clone())
        self.calls += 1
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self._group(axis))
        return self._back(out)

    def all_mean(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """The mean over ``axis`` of a float ``t``: the sum, divided by its
        size."""
        return self.all_sum(t, axis) / self.shape[axis]

    def all_gather(self, t: torch.Tensor, axis: str = "data", dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` on ``axis``, concatenated on ``dim`` in the
        axis' order (the reference's tiled ``all_gather``)."""
        if self._local(axis):
            return t.clone()
        src = self._host(t.contiguous())
        parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(self.shape[axis])]
        self.calls += 1
        dist.all_gather(parts, src, group=self._group(axis))
        return self._back(torch.cat(parts, dim=dim))

    def barrier(self) -> None:
        """A barrier of every rank of the mesh."""
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def make_mesh(data_axis_size: int = -1, table_axis_size: int = 1,
              device: torch.device | str = "cuda") -> Mesh:
    """The ``(data, table)`` mesh over the initialized default group:
    ``data_axis_size`` -1 takes world / ``table_axis_size``; D * T must
    equal the world size. Every rank creates every axis group, in the same
    order (data groups by t, then table groups by d)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: call parallel.mesh.init_distributed "
                           "(or torch.distributed.init_process_group) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    t_size = table_axis_size
    if t_size < 1 or world % t_size:
        raise ValueError(f"mesh.table_axis_size={table_axis_size} does not divide the process "
                         f"group's {world} ranks")
    n = world // t_size if data_axis_size == -1 else data_axis_size
    if n * t_size != world:
        raise ValueError(f"a mesh of data_axis_size={data_axis_size} x table_axis_size={t_size} "
                         f"needs {n * t_size} ranks, but the process group has {world}: the axes "
                         "take every rank (data_axis_size=-1)")
    backend = dist.get_backend()
    dev = local_device(device, rank)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group needs CUDA tensors, but the device is {dev}")
    groups = {}
    if 1 < n < world:
        for t in range(t_size):
            g = dist.new_group([d * t_size + t for d in range(n)])
            if rank % t_size == t:
                groups["data"] = g
    if 1 < t_size < world:
        for d in range(n):
            g = dist.new_group([d * t_size + t for t in range(t_size)])
            if rank // t_size == d:
                groups["table"] = g
    return Mesh(shape={"data": n, "table": t_size}, rank=rank, device=dev, backend=str(backend),
                groups=groups)
