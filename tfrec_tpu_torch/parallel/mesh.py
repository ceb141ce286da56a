"""Process groups and the mesh: the counterpart of
``tfrec_tpu/parallel/mesh.py`` over ``torch.distributed``.

One process a rank, one device a process. The ``data`` axis holds every
rank: the batch is split over it, dense params are replicated on it, and
row-sharded tables give each rank a contiguous block of rows (the
reference's ``P('data', None)``). The ``table`` axis (column sharding) is
not ported yet: ``make_mesh`` refuses a size above 1, naming ROADMAP Queue 1
item 11.

``init_distributed`` starts the process group. The backend is NCCL where
each rank has a card of its own, gloo on the CPU, and gloo over CUDA
tensors where ranks share one card (NCCL refuses two ranks on one device):
that one is chosen by name, ``backend="gloo"`` with ``device="cuda"``,
never as a fallback, and said on standard output. Gloo's collectives then
take host copies of the tensors (``Mesh`` stages them).

The collectives the sharded step needs are ``Mesh`` methods, each counted
in ``Mesh.calls``: an equal-split ``all_to_all`` of an [N, ...] buffer
(row j goes to rank j; row j of the result came from rank j, the
reference's ``all_to_all(split_axis=0, concat_axis=0, tiled=True)``),
``all_sum``, ``all_mean`` and ``all_gather``. At world size 1 they still
go through the process group, and each is an identity.
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


@dataclasses.dataclass
class Mesh:
    """The data axis over the default process group: ``shape`` is
    ``{"data": N, "table": 1}``, ``rank`` this process's place on it,
    ``device`` its device, ``backend`` the group's. ``calls`` counts its
    collective calls."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    backend: str
    group: Any = None
    calls: int = 0

    @property
    def size(self) -> int:
        return self.shape["data"]

    @property
    def _staged(self) -> bool:
        # Gloo over CUDA tensors: the collective runs on host copies.
        return self.backend == "gloo" and self.device.type == "cuda"

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self._staged else t

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self._staged else t

    def all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        """[N, ...] -> [N, ...]: row j goes to rank j, row j of the result
        came from rank j. Any dtype: the bytes are moved."""
        if buf.shape[0] != self.size:
            raise ValueError(f"all_to_all takes [{self.size}, ...] buffers, got {tuple(buf.shape)}")
        src = buf.contiguous()
        wire = src.view(torch.uint8) if src.dtype == torch.bfloat16 else src
        wire = self._host(wire)
        out = torch.empty_like(wire)
        self.calls += 1
        dist.all_to_all_single(out, wire, group=self.group)
        out = self._back(out)
        return out.view(torch.bfloat16) if src.dtype == torch.bfloat16 else out

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``t`` (a new tensor)."""
        out = self._host(t.clone())
        self.calls += 1
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return self._back(out)

    def all_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over ranks of a float ``t``: the sum, divided by N."""
        return self.all_sum(t) / self.size

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked on dim 0 in rank order: [N * n, ...]."""
        src = self._host(t.contiguous())
        parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(self.size)]
        self.calls += 1
        dist.all_gather(parts, src, group=self.group)
        return self._back(torch.cat(parts))

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def make_mesh(data_axis_size: int = -1, table_axis_size: int = 1,
              device: torch.device | str = "cuda") -> Mesh:
    """The mesh over the initialized default group: ``data_axis_size`` -1
    takes every rank; it must equal the world size. A table axis above 1
    (column sharding) is refused, naming its ROADMAP item."""
    if table_axis_size > 1:
        raise NotImplementedError(
            f"a table axis of {table_axis_size} (column-sharded tables, ColShardedTable) is not "
            "ported yet: ROADMAP Queue 1 item 11; the port row-shards over the data axis")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: call parallel.mesh.init_distributed "
                           "(or torch.distributed.init_process_group) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if data_axis_size == -1 else data_axis_size
    if n != world:
        raise ValueError(f"mesh.data_axis_size={data_axis_size} but the process group has {world} "
                         "ranks: the data axis takes every rank (-1)")
    backend = dist.get_backend()
    dev = local_device(device, rank)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group needs CUDA tensors, but the device is {dev}")
    return Mesh(shape={"data": n, "table": 1}, rank=rank, device=dev, backend=str(backend))
