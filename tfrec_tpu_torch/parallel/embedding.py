"""Sharded embedding tables, the counterpart of
``tfrec_tpu/parallel/embedding.py``: row-sharded tables with the all-to-all
id exchange and gradient combine, and column-sharded ones.

Row sharding (``RowShardedTable``, the mesh's ``data`` axis of N ranks):
every data index owns a contiguous block of ``V_pad / N`` rows of each
table (``pad_vocab``). A lookup, on each rank:

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

Column sharding (``ColShardedTable``, the mesh's ``table`` axis of T
ranks): every table index holds all V rows of D/T of the columns, as one
[V, D/T] tensor, replicated over ``data``. ``col_lookup`` gathers every col
table's block in one ``gather_rows_multi`` launch (ids >= V clamp, as bag
padding; negative ids read zeros and are counted, summed over ``data``),
then one ``all_gather`` over ``table`` rebuilds the [b, D] rows of them all.
``col_update`` is the reference's signature discipline for every table: it
dedups the local ids, slices this rank's D/T gradient columns before their
segment sum, packs the distinct ids into one destination's capacity
(``capacity_for(b, 1, factor)``, overflow counted), all-gathers ids and
rows over ``data`` (one call each for all tables), combines them and
applies the rowwise optimizer with the column statistic (each row's sum of
g^2 over its columns, summed over ``table`` in one ``all_sum`` for all
tables, over the full width D: the reference's ``_row_stat`` with
``stat_axis``); tables of one shape go through each part as one batch, as
in the row exchange. The reference runs that update through XLA, not its
Pallas kernel, and so does the port (``apply_deduped(..., stat=)``): this
is the reference's route, not a fallback.

``shard`` and ``unshard`` of either plan map a logical [V, ...] leaf (a
table or its optimizer state) to this rank's block and back (a
collective). Lane-packed sharded tables (the reference's lane-sliced wire,
``_lookup_grouped`` / ``local_update_grouped``) are not ported yet: ROADMAP
Queue 1 item 11.
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
        return self.mesh.data_index * self.rows_per_shard

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

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a logical leaf: ``shard_rows`` of a [V, ...]
        leaf, a copy of any other."""
        return self.shard_rows(x) if x.dim() and x.shape[0] == self.vocab else x.clone()

    def unshard(self, block: torch.Tensor) -> torch.Tensor:
        """The logical leaf of a block (a collective)."""
        return self.unshard_rows(block) if self.is_block(block) else block

    def is_block(self, leaf: torch.Tensor) -> bool:
        """Whether a leaf of this table's state is a block of rows."""
        return bool(leaf.dim()) and leaf.shape[0] == self.rows_per_shard

    def logical_shape(self, block_shape) -> tuple:
        return (self.vocab,) + tuple(block_shape[1:])


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


class ColShardedTable:
    """The plan of one column-sharded table on a mesh's ``table`` axis:
    this rank holds columns [t * D/T, (t + 1) * D/T) of all V rows. The
    vocab is not padded."""

    def __init__(self, mesh: Mesh, vocab: int, dim: int, *, capacity_factor: float = 2.0):
        t = mesh.shape["table"]
        if dim % t:
            raise ValueError(f"a column-sharded table's dim {dim} must divide by the table axis {t}")
        self.mesh = mesh
        self.vocab = vocab
        self.dim = dim
        self.dim_local = dim // t
        self.capacity_factor = capacity_factor

    @property
    def col0(self) -> int:
        """This rank's first column."""
        return self.mesh.table_index * self.dim_local

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a logical [V, D] leaf (the table, Adam's
        m); a rowwise [V] leaf is replicated (copied)."""
        if x.dim() == 2:
            return x[:, self.col0:self.col0 + self.dim_local].clone(memory_format=torch.contiguous_format)
        return x.clone()

    def unshard(self, block: torch.Tensor) -> torch.Tensor:
        """The logical leaf of a block (a collective over ``table``)."""
        return self.mesh.all_gather(block, "table", dim=1) if block.dim() == 2 else block

    def is_block(self, leaf: torch.Tensor) -> bool:
        return leaf.dim() == 2

    def logical_shape(self, block_shape) -> tuple:
        return (self.vocab, self.dim) if len(block_shape) == 2 else tuple(block_shape)


def _all_gather_parts(mesh: Mesh, parts: Sequence[torch.Tensor], axis: str) -> List[torch.Tensor]:
    """Every part of every rank on ``axis``, in one ``all_gather`` -> [n,
    *p.shape] a part (n the axis' size, in its order)."""
    n = mesh.shape[axis]
    flat = mesh.all_gather(torch.cat([p.reshape(1, -1) for p in parts], dim=1), axis)
    return [x.reshape((n,) + tuple(p.shape))
            for p, x in zip(parts, torch.split(flat, [p.numel() for p in parts], dim=1))]


def _table_all_gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """[b_f, d_f] column blocks -> [b_f, T * d_f] full rows, every block of
    every table in one ``all_gather`` over ``table`` (rank t's columns at
    [t * d_f, (t + 1) * d_f), the reference's tiled gather on axis 1)."""
    return [x.permute(1, 0, 2).reshape(p.shape[0], -1)
            for p, x in zip(parts, _all_gather_parts(mesh, parts, "table"))]


def col_lookup(mesh: Mesh, plans: Sequence[ColShardedTable], tables, ids):
    """The lookup of many column-sharded tables -> (rows [b_f, D_f] per
    table, the count of negative ids summed over tables and ``data``). One
    gather launch for every block, one ``all_gather`` over ``table``."""
    local = gather_many(list(tables), list(ids))  # ids past V clamp, as bag padding
    neg = [i < 0 for i in ids]
    local = [torch.where(n[:, None], 0.0, r) for n, r in zip(neg, local)]
    overflow = torch.stack([n.sum() for n in neg]).sum()
    return _table_all_gather(mesh, local), mesh.all_sum(overflow)


def col_update(mesh: Mesh, plans: Sequence[ColShardedTable], tables, states, ids, grads,
               sparse_opt, lr):
    """The update of many column-sharded tables from the local ids [b_f]
    and full-width gradient rows [b_f, D_f] -> (tables, states, the ids
    dropped over capacity and the negative ids of this rank, summed over
    tables; the reference's builder discards it). Every data rank's ids
    and column slices are gathered, so the replicas over ``data`` apply the
    same update. Tables whose ids share a length, rows a width and plans a
    capacity go through each part as one [F, ...] batch (one sort,
    segmented sum and bucketing, and one receive combine, for the group),
    each table's arithmetic bit for bit its own; one ``all_gather`` of ids
    and one of rows over ``data``, one ``all_sum`` of the statistics over
    ``table``, for all."""
    keys: Dict[tuple, List[int]] = {}
    for i, (plan, lids) in enumerate(zip(plans, ids)):
        keys.setdefault((lids.shape[0], plan.dim, plan.capacity_factor), []).append(i)
    groups, send_ids, send_rows, overflow = [], [], [], []
    for (b, _, factor), members in keys.items():
        group = [plans[i] for i in members]
        f, p0 = len(members), group[0]
        dl = p0.dim_local
        vocab = torch.tensor([[p.vocab] for p in group], device=ids[members[0]].device)
        uids, inv, order = dedup_ids_sorted(torch.stack([ids[i] for i in members]), vocab)
        # This rank's columns before the sum by id: T-fold less work. Each
        # table's segments apart (bit for bit a sum a table).
        g_cols = torch.stack([grads[i][:, p0.col0:p0.col0 + dl] for i in members])
        seg = inv.gather(1, order) + torch.arange(f, device=inv.device)[:, None] * b
        combined = _segment_sums(seg.reshape(-1), g_cols.gather(
            1, order[:, :, None].expand(-1, -1, dl)).reshape(-1, dl)).view(f, b, dl)
        cap = capacity_for(b, 1, factor)
        sids, pos, ovf = bucket_by_dest(uids, 1, vocab, cap, vocab, ids_sorted=True)
        pos = pos.reshape(f, cap)
        rows = combined.gather(1, pos.clamp(max=b - 1)[:, :, None].expand(-1, -1, dl))
        groups.append((members, group))
        send_ids.append(sids.reshape(f, cap))
        send_rows.append(torch.where((pos < b)[:, :, None], rows, 0.0))
        overflow.append(ovf)
    recv = zip(_data_all_gather(mesh, send_ids), _data_all_gather(mesh, send_rows))
    combined = []
    for (members, group), (all_ids, all_rows) in zip(groups, recv):
        # Every data rank's rows of a table, one batched combine for the group.
        combined.append(combine_duplicate_ids_grouped(all_ids, all_rows, [p.vocab for p in group]))
    stats = [None] * len(groups)
    if sparse_opt.name != "sgd":
        sumsq = [(g * g).sum(dim=-1) for _, g in combined]
        total = mesh.all_sum(torch.cat([s.reshape(-1) for s in sumsq]), "table")
        stats = [t.view(s.shape) / group[0].dim for t, s, (_, group) in
                 zip(torch.split(total, [s.numel() for s in sumsq]), sumsq, groups)]
    new_tables, new_states = list(tables), list(states)
    for (members, _), (uids, g), stat in zip(groups, combined, stats):
        for j, i in enumerate(members):
            new_tables[i], new_states[i] = sparse_opt.apply_deduped(
                tables[i], states[i], uids[j], g[j], lr, stat=None if stat is None else stat[j])
    return new_tables, new_states, torch.stack(overflow).sum()


def _data_all_gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each part [F, c, ...] of every data rank, in one ``all_gather`` over
    ``data`` -> [F, N * c, ...] a part: row f holds table f's slots of
    rank 0, then of rank 1, and so on."""
    return [x.transpose(0, 1).reshape((p.shape[0], -1) + tuple(p.shape[2:]))
            for p, x in zip(parts, _all_gather_parts(mesh, parts, "data"))]


def wire_dtype(a2a_dtype: str) -> torch.dtype | None:
    """``mesh.a2a_dtype`` as the wire's dtype (None: f32, the tables')."""
    if a2a_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown mesh.a2a_dtype {a2a_dtype!r}; options: float32, bfloat16")
    return WIRE_DTYPES[a2a_dtype]

