"""Row-sharded embedding tables: the all-to-all id exchange and the
gradient combine, the counterpart of ``tfrec_tpu/parallel/embedding.py``.

Every rank owns a contiguous block of ``V_pad / N`` rows of each table
(``pad_vocab``). A lookup, on each rank:

  1. dedups its local ids (``dedup_ids_sorted``) and buckets the distinct ones by
     owning rank into an [N, C] send buffer (``bucket_by_dest``; a static
     capacity C per destination, ``capacity_for``);
  2. ``all_to_all`` sends the id requests to their owners;
  3. each owner gathers its rows (``gather_rows_multi``: every table's
     block in one launch on a card);
  4. a second ``all_to_all`` returns the rows (in ``wire_dtype``: bf16
     halves the bytes; tables and optimizer math stay f32);
  5. the rows are scattered back to the batch's positions.

The update is the transpose: each rank sums its gradient rows by distinct
id (in batch order), sends them with the same plan, and each owner combines
what it received (``combine_duplicate_ids_grouped`` with the sentinel
``rps``: one stable sort) and applies the rowwise optimizer to its rows
(``SparseOptimizer.apply_deduped_many``: rowwise Adagrad as one launch of
``fused_rowwise_adagrad_multi`` for every table on a card). The
reference's ``recv_combine="merge"`` (a merge network over the N sorted
received blocks, cheaper than a sort on a TPU) yields the stable sort's
permutation, so it takes the same sort here.

``exchange_lookup`` and ``exchange_update`` run the steps for many tables
at once with ONE ``all_to_all`` a direction (the tables' buffers side by
side), and the tables whose ids and rows share a shape as one [F, ...]
batch (one sort, bucketing, segmented sum and receive combine for the
group: ``_Group``); each table's arithmetic is the reference's per-table
arithmetic, bit for bit, so ``mesh.fused_tables`` changes nothing here. On a rank there is
no shard_map region: the two functions are the reference's
``local_lookup`` and ``local_update`` bodies, taking this rank's blocks
and ids.

Capacity: ids past C for a destination are dropped for that step (their
activations read 0 and their gradients are not sent), and counted, as are
negative (corrupt) ids; sentinel ids (>= V_pad) are bag padding, never sent
and never counted. ``exchange_lookup`` returns the count summed over ranks. With
``permute`` (``mesh.row_permute``) logical row i lives at physical row
``(i % N) * rps + i // N``, so a frequency-sorted vocab's head spreads over
the ranks.

Lane-packed sharded tables (the reference's lane-sliced wire,
``_lookup_grouped`` / ``local_update_grouped``) and ``ColShardedTable`` are
not ported yet: ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import torch

from tfrec_tpu_torch.ops.embedding import (
    _segment_sums,
    combine_duplicate_ids_grouped,
    dedup_ids_sorted,
    fill_like,
    gather_many,
    run_first_index,
)
from tfrec_tpu_torch.parallel.mesh import Mesh

WIRE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}  # mesh.a2a_dtype -> the wire's


def pad_vocab(vocab: int, num_shards: int, row_align: int = 8) -> int:
    """The vocab rounded up to equal blocks of a multiple of ``row_align``
    rows a shard (the reference's rule, so both pad alike)."""
    chunk = num_shards * row_align
    return math.ceil(vocab / chunk) * chunk


def capacity_for(batch_per_device: int, num_shards: int, factor: float) -> int:
    """Distinct ids a rank may send to one destination in a step:
    ``ceil((mean + 4 sqrt(mean) + 8) * factor / 2)``, mean = ids / N, at
    most the ids themselves."""
    mean = batch_per_device / num_shards
    cap = math.ceil((mean + 4.0 * math.sqrt(mean) + 8.0) * factor / 2.0)
    return min(cap, batch_per_device)


def bucket_by_dest(ids: torch.Tensor, num_shards: int, rows_per_shard, capacity: int, sentinel,
                   ids_sorted: bool = False):
    """Pack ids into an [N, C] send buffer by destination shard -> (send_ids
    [N, C] int32 sentinel-padded, send_pos [N, C] int64 each slot's position
    in ``ids``, ``len(ids)`` where empty, overflow: a 0-d int64 count of
    in-range ids past a destination's capacity plus negative ids). Ids out
    of range (negative, or >= ``sentinel``) are never sent. Within a
    destination the ids keep their order; ``ids_sorted`` skips the sort for
    ascending ids (``dedup_ids_sorted``' output).

    A batch of tables at once: ids [F, n] with ``rows_per_shard`` and
    ``sentinel`` numbers or [F, 1] tensors -> [F, N, C] buffers, each row
    the table's own, and the overflow of them all."""
    n = ids.shape[-1]
    dev = ids.device
    invalid = (ids >= sentinel) | (ids < 0)
    sent = fill_like(ids, sentinel)
    dest = torch.where(invalid, sent, torch.div(ids, rows_per_shard, rounding_mode="floor"))
    clean = torch.where(invalid, sent, ids)
    if ids_sorted:
        order = torch.arange(n, device=dev).expand(ids.shape)
        sd, sids = dest, clean
    else:
        sd, order = torch.sort(dest, dim=-1, stable=True)  # batch order within a destination
        sids = clean.gather(-1, order)
    rank = torch.arange(n, device=dev) - run_first_index(sd)
    real = sids < sentinel
    ok = (rank < capacity) & real
    slots = num_shards * capacity
    # Dropped ids all land on one extra slot, cut off below.
    slot = torch.where(ok, sd.long() * capacity + rank, slots)
    lead = tuple(ids.shape[:-1])
    send_ids = fill_like(torch.empty(lead + (slots + 1,), dtype=torch.int32, device=dev), sentinel)
    send_ids = send_ids.scatter_(-1, slot, sids.to(torch.int32))[..., :slots]
    send_pos = torch.full(lead + (slots + 1,), n, dtype=torch.int64, device=dev).scatter_(
        -1, slot, order)[..., :slots]
    overflow = (~ok & real).sum() + (ids < 0).sum()
    return (send_ids.reshape(lead + (num_shards, capacity)),
            send_pos.reshape(lead + (num_shards, capacity)), overflow)


class Route(NamedTuple):
    """A lookup's exchange plan for one group of tables (``_Group``), which
    the same step's update reuses (``mesh.route_reuse``): the dedup inverse
    and the stable order of the local ids, the send plan and the received
    id requests, one row a table."""

    inv: torch.Tensor       # [F, b] each local id's distinct slot
    order: torch.Tensor     # [F, b] the stable argsort of the local ids
    send_pos: torch.Tensor  # [F, N, C] each sent slot's distinct slot, b where empty
    recv_ids: torch.Tensor  # [F, N, C] the ids rank j asked of this rank


class RowShardedTable:
    """The lookup and update plan of one row-sharded table on a mesh's data
    axis; this rank holds rows [rank * rps, (rank + 1) * rps) of the padded
    (and, with ``permute``, permuted) table."""

    def __init__(self, mesh: Mesh, vocab: int, dim: int, *, capacity_factor: float = 2.0,
                 wire_dtype: torch.dtype | None = None, lane_groups: int = 1,
                 recv_combine: str = "sort", permute: bool = False):
        if lane_groups > 1:
            raise NotImplementedError(
                f"a lane-packed row-sharded table (lane_groups={lane_groups}, the reference's "
                "lane-sliced wire) is not ported yet: ROADMAP Queue 1 item 11; build per-field "
                "tables (model.lane_pack=False)")
        if recv_combine not in ("sort", "merge"):
            raise ValueError(f"unknown recv_combine {recv_combine!r}")
        if wire_dtype not in (None, torch.bfloat16, torch.float32):
            raise ValueError(f"unsupported wire dtype {wire_dtype}")
        self.mesh = mesh
        self.num_shards = mesh.size
        self.vocab = vocab
        self.vocab_padded = pad_vocab(vocab, self.num_shards)
        self.rows_per_shard = self.vocab_padded // self.num_shards
        self.dim = dim
        self.capacity_factor = capacity_factor
        self.wire_dtype = None if wire_dtype == torch.float32 else wire_dtype
        self.lane_groups = lane_groups
        self.permute = permute
        self.sentinel = self.vocab_padded  # one past the padded end
        # Each group led by this plan: its [F, 1] constants on a device.
        self._consts: Dict[tuple, tuple] = {}

    @property
    def base(self) -> int:
        """This rank's first (physical) row."""
        return self.mesh.rank * self.rows_per_shard

    # ---- the row permutation (mesh.row_permute) ----

    def perm_rows(self, device=None) -> torch.Tensor:
        """[V_pad] the physical row of each logical row (int64)."""
        i = torch.arange(self.vocab_padded, device=device)
        if not self.permute:
            return i
        return (i % self.num_shards) * self.rows_per_shard + torch.div(
            i, self.num_shards, rounding_mode="floor")

    def inv_perm_rows(self, device=None) -> torch.Tensor:
        """[V_pad] the logical row each physical row holds (int64)."""
        p = torch.arange(self.vocab_padded, device=device)
        if not self.permute:
            return p
        return (p % self.rows_per_shard) * self.num_shards + torch.div(
            p, self.rows_per_shard, rounding_mode="floor")

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a logical [V, ...] array (a table or a
        per-row optimizer state): padded with zero rows to V_pad, permuted,
        rows [base, base + rps)."""
        if x.shape[0] != self.vocab:
            raise ValueError(f"shard_rows takes [{self.vocab}, ...] arrays, got {tuple(x.shape)}")
        logical = self.inv_perm_rows(x.device)[self.base:self.base + self.rows_per_shard]
        real = logical < self.vocab
        block = torch.zeros((self.rows_per_shard,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        block[real] = x[logical[real]]
        return block

    def unshard_rows(self, block: torch.Tensor) -> torch.Tensor:
        """The logical [V, ...] array from every rank's block (a collective:
        every rank calls it)."""
        physical = self.mesh.all_gather(block)
        return physical.index_select(0, self.perm_rows(block.device))[: self.vocab]


class _Group(NamedTuple):
    """Tables exchanged as one batch: their ids of one length, rows of one
    width, one capacity and layout; ``members`` are their
    places in the call, and the constants one row a table ([F, 1])."""

    members: List[int]
    plans: List["RowShardedTable"]
    capacity: int
    sentinel: torch.Tensor  # V_pad a table
    rps: torch.Tensor       # rows a shard a table
    base: torch.Tensor      # this rank's first row a table


def _groups(plans: Sequence[RowShardedTable], ids, dims) -> List[_Group]:
    """The tables of a call batched by (ids' length, width, capacity
    factor, layout), in the call's order; the same tables and ids give the
    same groups, so a lookup's routes serve its update."""
    keys: Dict[tuple, List[int]] = {}
    for i, (plan, lids, dim) in enumerate(zip(plans, ids, dims)):
        keys.setdefault((lids.shape[0], dim, plan.capacity_factor, plan.permute), []).append(i)
    out = []
    for (length, _, factor, _), members in keys.items():
        group = [plans[i] for i in members]
        # Cached on the group's first plan (the group is held, so the ids
        # stay its members'): a host list copied to the card would sync.
        cache = group[0]._consts
        dev = ids[members[0]].device
        key = tuple(id(p) for p in group) + (str(dev),)
        if key not in cache:
            cache[key] = (group, *(torch.tensor([[getattr(p, a)] for p in group], device=dev)
                                   for a in ("sentinel", "rows_per_shard", "base")))
        _, sentinel, rps, base = cache[key]
        out.append(_Group(members, group, capacity_for(length, group[0].num_shards, factor),
                          sentinel, rps, base))
    return out


def _perm_ids(group: _Group, ids: torch.Tensor) -> torch.Tensor:
    """Logical -> physical ids of a batch [F, b] (``permute``: logical i at
    ``(i % N) * rps + i // N``); ids out of [0, V_pad) pass untouched, so
    the loud-drop accounting is unchanged."""
    if not group.plans[0].permute:
        return ids
    n = group.plans[0].num_shards
    ok = (ids >= 0) & (ids < group.sentinel)
    return torch.where(ok, (ids % n) * group.rps + torch.div(ids, n, rounding_mode="floor"), ids)


def _exchange(mesh: Mesh, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One ``all_to_all`` of many [F, N, ...] buffers of one dtype, side by
    side -> the received buffers, each of its own shape: row j of table f's
    came from rank j."""
    n = mesh.size
    flat = [b.transpose(0, 1).reshape(n, -1) for b in bufs]
    widths = [f.shape[1] for f in flat]
    recv = mesh.all_to_all(torch.cat(flat, dim=1) if len(flat) > 1 else flat[0])
    return [r.reshape((n, b.shape[0]) + tuple(b.shape[2:])).transpose(0, 1)
            for r, b in zip(torch.split(recv, widths, dim=1), bufs)]


def _routes(mesh: Mesh, groups: Sequence[_Group], ids):
    """Each group's route, every id request exchanged in one ``all_to_all``,
    and the local overflow of them all (0-d)."""
    planned = []
    for g in groups:
        lids = _perm_ids(g, torch.stack([ids[i] for i in g.members]))
        uids, inv, order = dedup_ids_sorted(lids, g.sentinel)
        send_ids, send_pos, overflow = bucket_by_dest(
            uids, g.plans[0].num_shards, g.rps, g.capacity, g.sentinel, ids_sorted=True)
        planned.append((send_ids, Route(inv, order, send_pos, None), overflow))
    recv = _exchange(mesh, [send for send, _, _ in planned])
    routes = [r._replace(recv_ids=rv) for (_, r, _), rv in zip(planned, recv)]
    return routes, torch.stack([o for _, _, o in planned]).sum()


def exchange_lookup(mesh: Mesh, plans: Sequence[RowShardedTable], tables, ids):
    """The lookup of many row-sharded tables, one id and one row exchange
    for all -> (rows [b_f, D_f] per table, overflow summed over tables and
    ranks, the routes of their groups). The tables share one wire dtype."""
    wire = plans[0].wire_dtype
    if any(p.wire_dtype != wire for p in plans):
        raise ValueError("tables exchanged together share one wire dtype")
    groups = _groups(plans, ids, [t.shape[1] for t in tables])
    routes, overflow = _routes(mesh, groups, ids)
    # The owner's gather: every table's block in one launch on a card.
    local, valid = {}, {}
    for g, r in zip(groups, routes):
        ok = (r.recv_ids >= g.base[:, :, None]) & (r.recv_ids < (g.base + g.rps)[:, :, None])
        rows = torch.minimum(torch.clamp(r.recv_ids - g.base[:, :, None], min=0),
                             g.rps[:, :, None] - 1).to(torch.int32)
        for j, i in enumerate(g.members):
            local[i], valid[i] = rows[j].reshape(-1), ok[j]
    gathered = gather_many(list(tables), [local[i] for i in range(len(tables))])
    sent = []
    for g in groups:
        rows = torch.stack([gathered[i] for i in g.members])
        mask = torch.stack([valid[i] for i in g.members]).reshape(rows.shape[:2] + (1,))
        rows = torch.where(mask, rows, 0.0).view(len(g.members), mesh.size, g.capacity, -1)
        sent.append(rows.to(wire) if wire is not None else rows)
    outs: List[torch.Tensor] = [None] * len(tables)
    for g, route, back in zip(groups, routes, _exchange(mesh, sent)):
        f, size = route.inv.shape
        dim = back.shape[-1]
        # Row ``size`` takes the empty slots, and is cut off.
        unique = torch.zeros((f, size + 1, dim), dtype=torch.float32, device=back.device)
        pos = route.send_pos.reshape(f, -1, 1).expand(-1, -1, dim)
        unique.scatter_(1, pos, back.reshape(f, -1, dim).to(torch.float32))
        rows = unique[:, :size].gather(1, route.inv[:, :, None].expand(-1, -1, dim))
        for j, i in enumerate(g.members):
            outs[i] = rows[j]
    return outs, mesh.all_sum(overflow), routes


def exchange_update(mesh: Mesh, plans: Sequence[RowShardedTable], tables, states, ids, grads,
                    sparse_opt, lr, routes: Sequence[Route] | None = None):
    """The update of many row-sharded tables, one gradient exchange for all
    (and one id exchange without the lookup's ``routes``) -> (tables,
    states, overflow summed over ranks, 0 with ``routes``). The owners'
    updates are one ``apply_deduped_many`` (one launch for rowwise Adagrad
    on a card)."""
    n = mesh.size
    wire = plans[0].wire_dtype
    groups = _groups(plans, ids, [t.shape[1] for t in tables])
    if routes is None:
        routes, overflow = _routes(mesh, groups, ids)
        overflow = mesh.all_sum(overflow)
    else:
        overflow = torch.zeros((), dtype=torch.int64, device=mesh.device)
    sent = []
    for g, route in zip(groups, routes):
        f, b = route.inv.shape
        g_rows = torch.stack([grads[i] for i in g.members])  # [F, b, D]
        dim = g_rows.shape[-1]
        # One row a distinct id, its rows summed in batch order, each
        # table's segments apart (bit for bit a sum a table).
        seg = route.inv.gather(1, route.order) + torch.arange(f, device=route.inv.device)[:, None] * b
        combined = _segment_sums(seg.reshape(-1), g_rows.gather(
            1, route.order[:, :, None].expand(-1, -1, dim)).reshape(-1, dim)).view(f, b, dim)
        pos = route.send_pos.reshape(f, -1)
        rows = combined.gather(1, pos.clamp(max=b - 1)[:, :, None].expand(-1, -1, dim))
        rows = torch.where((pos < b)[:, :, None], rows, 0.0).view(f, n, g.capacity, dim)
        sent.append(rows.to(wire) if wire is not None else rows)
    uids, combined = [None] * len(plans), [None] * len(plans)
    for g, route, recv in zip(groups, routes, _exchange(mesh, sent)):
        f = len(g.members)
        lrow = route.recv_ids.reshape(f, -1) - g.base
        lrow = torch.where((lrow >= 0) & (lrow < g.rps), lrow, g.rps).to(torch.int32)
        rows = recv.reshape(f, lrow.shape[1], -1).to(torch.float32)
        # One batched sort for the group: bit for bit a combine a table.
        u, c = combine_duplicate_ids_grouped(lrow, rows, [p.rows_per_shard for p in g.plans])
        for j, i in enumerate(g.members):
            uids[i], combined[i] = u[j], c[j]
    new_tables, new_states = sparse_opt.apply_deduped_many(list(tables), list(states), uids, combined, lr)
    return new_tables, new_states, overflow


def wire_dtype(a2a_dtype: str) -> torch.dtype | None:
    """``mesh.a2a_dtype`` as the wire's dtype (None: f32, the tables')."""
    if a2a_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown mesh.a2a_dtype {a2a_dtype!r}; options: float32, bfloat16")
    return WIRE_DTYPES[a2a_dtype]

