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

Each call counts into the mesh's ``counters`` (``Mesh.count``): every
``all_to_all`` its buffer's bytes (``a2a_bytes.ids``, ``.lookup``,
``.update``), and ``exchange_lookup`` the ids it was given
(``lookup_ids``), the distinct ids it sent (``distinct_sent``) and its
local overflow (``lookup_overflow``).

``exchange_lookup`` and ``exchange_update`` run the steps for many tables
at once with ONE ``all_to_all`` a direction (the tables' buffers side by
side), and the tables whose rows share a width and whose ids' lengths lie
within ``MERGE_LENGTHS`` of each other as one [F, ...] batch, the shorter
ids padded (one sort, bucketing, segmented sum and receive combine for the
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
collective).

Lane-packed row-sharded tables (``lane_groups`` G > 1: a packed row holds G
logical rows of d = D / G lanes) take the reference's lane-sliced wire
(``_lookup_grouped`` / ``local_update_grouped``): the exchange dedups and
routes ``(id, slot)`` keys ``id * G + slot`` (``_keys``; the key // (rps *
G) is the id's owner, so routing is unchanged) and moves d lanes a key, the
unpacked tables' volume. As views, this rank's [rps, G * d] block is a
[rps * G, d] table whose row ``key - base * G`` is the key's lane group, and
its [rps, G] rowwise statistics are [rps * G] (the kernels' ``_lane_rows``
trick): the owner gathers those view rows in the same ``gather_rows_multi``
launch as every other table (a copy, so the reference's values bit for
bit), and the update combines received keys and applies the one-group
rowwise rule to the view rows, which is the grouped rule (grouped Adam's
touch mask is the received keys themselves). Returned rows are re-expanded
to the packed [b, G * d] interface, the other groups zero.
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
)
from tfrec_tpu_torch.parallel.mesh import Mesh

WIRE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}  # mesh.a2a_dtype -> the wire's
MERGE_LENGTHS = 2  # ids whose lengths lie within this factor are exchanged as one padded batch


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
    # Each id's place in its destination's run: the run's first index by
    # binary search over an ascending key (sorted ids put the negative ones,
    # whose destination is the sentinel's, first: they key -1).
    key = torch.where(ids < 0, -1, sd) if ids_sorted else sd
    rank = torch.arange(n, device=dev) - torch.searchsorted(key, key)
    real = sids < sentinel
    ok = (rank < capacity) & real
    slots = num_shards * capacity
    # Each dropped id lands on an extra slot of its own (no two writes to
    # one place), cut off below.
    slot = torch.where(ok, sd.long() * capacity + rank, slots + torch.arange(n, device=dev))
    lead = tuple(ids.shape[:-1])
    send_ids = fill_like(torch.empty(lead + (slots + n,), dtype=torch.int32, device=dev), sentinel)
    send_ids = send_ids.scatter_(-1, slot, sids.to(torch.int32))[..., :slots]
    send_pos = torch.full(lead + (slots + n,), n, dtype=torch.int64, device=dev).scatter_(
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
        if lane_groups > 1:
            if dim % lane_groups:
                raise ValueError(f"a lane-packed table's dim {dim} must divide by its "
                                 f"{lane_groups} lane groups")
            # (id, slot) keys are id * G + slot; they must fit int32.
            if self.vocab_padded * lane_groups >= 2**31:
                raise ValueError(
                    f"lane-packed sharded table too large for int32 (vocab_padded="
                    f"{self.vocab_padded} * G={lane_groups}); disable lane_pack for this table")
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
    """Tables exchanged as one batch: their ids padded to one length, rows
    of one width, one capacity, layout and lane groups G; ``members`` are
    their places in the call, and the constants one row a table ([F, 1]).
    The exchange runs in key space, ``key_*``: the ids' own where G = 1,
    else the (id, slot) keys' (each constant times G)."""

    members: List[int]
    plans: List["RowShardedTable"]
    length: int             # the ids of each member, padded (sentinels; zero gradient rows)
    capacity: int
    sentinel: torch.Tensor  # V_pad a table
    rps: torch.Tensor       # rows a shard a table
    base: torch.Tensor      # this rank's first row a table
    lanes: int              # G, the lane groups of each member

    @property
    def key_sentinel(self) -> torch.Tensor:
        return self.sentinel * self.lanes

    @property
    def key_rps(self) -> torch.Tensor:
        return self.rps * self.lanes

    @property
    def key_base(self) -> torch.Tensor:
        return self.base * self.lanes


def _length_classes(lengths) -> Dict[int, int]:
    """Each ids' length -> the length it is padded to: ascending, a length
    joins the class of the shortest one still within ``MERGE_LENGTHS`` of
    it, and the class pads to its longest."""
    out: Dict[int, int] = {}
    cls: List[int] = []
    for n in sorted(set(lengths)) + [None]:
        if cls and (n is None or n > MERGE_LENGTHS * cls[0]):
            out.update((m, cls[-1]) for m in cls)
            cls = []
        if n is not None:
            cls.append(n)
    return out


def _groups(plans: Sequence[RowShardedTable], ids, dims) -> List[_Group]:
    """The tables of a call batched by (width, capacity factor, layout,
    lane groups, and the length class of their ids), in the call's order;
    the same tables and ids give the same groups, so a lookup's routes serve
    its update. Ids of lengths within a factor of ``MERGE_LENGTHS`` share a
    batch, the shorter ones padded (multi-hot bags give each field its own
    length; a batch a length would make a dozen launches of every step of
    the exchange); lane-packed tables keep a batch a length."""
    kinds: Dict[tuple, List[int]] = {}
    for i, (plan, dim) in enumerate(zip(plans, dims)):
        kinds.setdefault((dim, plan.capacity_factor, plan.permute, plan.lane_groups), []).append(i)
    keys: Dict[tuple, List[int]] = {}
    for kind, members in kinds.items():
        lengths = [ids[i].shape[0] for i in members]
        padded = ({n: n for n in lengths} if kind[3] > 1 else _length_classes(lengths))
        for i, n in zip(members, lengths):
            keys.setdefault((padded[n],) + kind, []).append(i)
    order = sorted(keys.items(), key=lambda kv: kv[1][0])  # by each batch's first table
    out = []
    for (length, _, factor, _, lanes), members in order:
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
        out.append(_Group(members, group, length, capacity_for(length, group[0].num_shards, factor),
                          sentinel, rps, base, lanes))
    return out


def _padded(group: _Group, parts, fill: torch.Tensor | None = None) -> torch.Tensor:
    """The members' [b_f, ...] tensors stacked [F, length, ...], each
    padded with zeros, or with its row of ``fill`` (the group's [F, 1]
    sentinels)."""
    rows = []
    for j, i in enumerate(group.members):
        x = parts[i]
        short = group.length - x.shape[0]
        if short:
            pad = x.new_zeros((short,) + tuple(x.shape[1:]))
            x = torch.cat([x, pad if fill is None else pad.add_(fill[j, 0])])
        rows.append(x)
    return torch.stack(rows)


def _perm_ids(group: _Group, ids: torch.Tensor) -> torch.Tensor:
    """Logical -> physical ids of a batch [F, b] (``permute``: logical i at
    ``(i % N) * rps + i // N``); ids out of [0, V_pad) pass untouched, so
    the loud-drop accounting is unchanged."""
    if not group.plans[0].permute:
        return ids
    n = group.plans[0].num_shards
    ok = (ids >= 0) & (ids < group.sentinel)
    return torch.where(ok, (ids % n) * group.rps + torch.div(ids, n, rounding_mode="floor"), ids)


def _keys(group: _Group, ids: torch.Tensor, slots: torch.Tensor | None) -> torch.Tensor:
    """The exchange's keys of a batch [F, b] of physical ids: the ids
    where G = 1; else ``id * G + slot`` ([F, b] slots), ids past the padded
    end the key sentinel and negative (corrupt) ids as they are, so the
    exchange counts them (the reference's ``_keys``)."""
    if group.lanes == 1:
        return ids
    keys = torch.where(ids >= group.sentinel, group.key_sentinel, ids * group.lanes + slots)
    return torch.where(ids < 0, ids, keys).to(ids.dtype)


def _lane_view(leaf: torch.Tensor, key: str, lanes: int) -> torch.Tensor:
    """A lane-packed block's leaf as its lane groups' rows: a [rps, G * d]
    table (or Adam's ``m``) as [rps * G, d], a [rps, G] rowwise statistic
    as [rps * G]; unchanged where G = 1."""
    if lanes == 1:
        return leaf
    if key in ("table", "m"):
        return leaf.view(leaf.shape[0] * lanes, leaf.shape[1] // lanes)
    return leaf.view(-1)


def _exchange(mesh: Mesh, bufs: Sequence[torch.Tensor], tag: str) -> List[torch.Tensor]:
    """One ``all_to_all`` of many [F, N, ...] buffers of one dtype, side by
    side -> the received buffers, each of its own shape: row j of table f's
    came from rank j. ``tag`` names its byte counter."""
    n = mesh.size
    flat = [b.transpose(0, 1).reshape(n, -1) for b in bufs]
    widths = [f.shape[1] for f in flat]
    recv = mesh.all_to_all(torch.cat(flat, dim=1) if len(flat) > 1 else flat[0], tag=tag)
    return [r.reshape((n, b.shape[0]) + tuple(b.shape[2:])).transpose(0, 1)
            for r, b in zip(torch.split(recv, widths, dim=1), bufs)]


def _stack_slots(group: _Group, slots) -> torch.Tensor | None:
    if group.lanes == 1:
        return None
    if slots is None or any(slots[i] is None for i in group.members):
        raise ValueError("a lane-packed row-sharded table's exchange needs each id's lane group "
                         "(model.lane_slot_widths)")
    return torch.stack([slots[i] for i in group.members])


def _routes(mesh: Mesh, groups: Sequence[_Group], ids, slots=None, count: bool = False):
    """Each group's route, every id (or key) request exchanged in one
    ``all_to_all``, and the local overflow of them all (0-d). ``count``
    adds the ids and the distinct ids sent to the mesh's counters."""
    planned = []
    for g in groups:
        lids = _perm_ids(g, _padded(g, ids, g.sentinel))
        keys = _keys(g, lids, _stack_slots(g, slots))
        uids, inv, order = dedup_ids_sorted(keys, g.key_sentinel)
        send_ids, send_pos, overflow = bucket_by_dest(
            uids, g.plans[0].num_shards, g.key_rps, g.capacity, g.key_sentinel, ids_sorted=True)
        planned.append((send_ids, Route(inv, order, send_pos, None), overflow))
        if count:
            mesh.count("lookup_ids", sum(ids[i].numel() for i in g.members))
            mesh.count("distinct_sent", (send_ids < g.key_sentinel[:, :, None]).sum())
    recv = _exchange(mesh, [send for send, _, _ in planned], "ids")
    routes = [r._replace(recv_ids=rv) for (_, r, _), rv in zip(planned, recv)]
    return routes, torch.stack([o for _, _, o in planned]).sum()


def exchange_lookup(mesh: Mesh, plans: Sequence[RowShardedTable], tables, ids, slots=None):
    """The lookup of many row-sharded tables, one id and one row exchange
    for all -> (rows [b_f, D_f] per table, overflow summed over tables and
    ranks, the routes of their groups). The tables share one wire dtype.
    ``slots``: each lane-packed table's [b_f] lane groups (None for the
    others), by the tables' places."""
    wire = plans[0].wire_dtype
    if any(p.wire_dtype != wire for p in plans):
        raise ValueError("tables exchanged together share one wire dtype")
    groups = _groups(plans, ids, [t.shape[1] for t in tables])
    routes, overflow = _routes(mesh, groups, ids, slots, count=True)
    mesh.count("lookup_overflow", overflow)
    # The owner's gather: every table's block (a lane-packed one as its
    # [rps * G, d] view) in one launch on a card.
    local, valid, views = {}, {}, list(tables)
    for g, r in zip(groups, routes):
        base, rps = g.key_base[:, :, None], g.key_rps[:, :, None]
        ok = (r.recv_ids >= base) & (r.recv_ids < base + rps)
        rows = torch.minimum(torch.clamp(r.recv_ids - base, min=0), rps - 1).to(torch.int32)
        for j, i in enumerate(g.members):
            local[i], valid[i] = rows[j].reshape(-1), ok[j]
            views[i] = _lane_view(tables[i], "table", g.lanes)
    gathered = gather_many(views, [local[i] for i in range(len(tables))])
    sent = []
    for g in groups:
        rows = torch.stack([gathered[i] for i in g.members])
        mask = torch.stack([valid[i] for i in g.members]).reshape(rows.shape[:2] + (1,))
        rows = torch.where(mask, rows, 0.0).view(len(g.members), mesh.size, g.capacity, -1)
        sent.append(rows.to(wire) if wire is not None else rows)
    outs: List[torch.Tensor] = [None] * len(tables)
    for g, route, back in zip(groups, routes, _exchange(mesh, sent, "lookup")):
        f, size = route.inv.shape
        dim = back.shape[-1]
        # Each distinct id's slot in the returned rows (the one past the
        # last, a zero row, for an id not sent), then each id's row by one
        # gather; an empty slot marks a place of its own past ``size``.
        pos = route.send_pos.reshape(f, -1)
        nc = pos.shape[1]
        every = torch.arange(nc, device=back.device)
        slot_of = torch.full((f, size + nc), nc, dtype=torch.int64, device=back.device).scatter_(
            1, torch.where(pos < size, pos, size + every), every.expand(f, nc))
        src = torch.cat([back.reshape(f, nc, dim).to(torch.float32),
                         back.new_zeros((f, 1, dim), dtype=torch.float32)], dim=1)
        idx = slot_of.gather(1, route.inv)
        rows = src.gather(1, idx[:, :, None].expand(-1, -1, dim))
        if g.lanes > 1:  # back to the packed [b, G * d] rows, each in its slot's lanes
            lanes = _stack_slots(g, slots)[:, :, None, None].expand(-1, -1, 1, dim)
            rows = rows.new_zeros((f, size, g.lanes, dim)).scatter_(
                2, lanes, rows[:, :, None, :]).view(f, size, g.lanes * dim)
        for j, i in enumerate(g.members):
            outs[i] = rows[j, :ids[i].shape[0]]
    return outs, mesh.all_sum(overflow), routes


def exchange_update(mesh: Mesh, plans: Sequence[RowShardedTable], tables, states, ids, grads,
                    sparse_opt, lr, routes: Sequence[Route] | None = None, slots=None):
    """The update of many row-sharded tables, one gradient exchange for all
    (and one id exchange without the lookup's ``routes``) -> (tables,
    states, overflow summed over ranks, 0 with ``routes``). The owners'
    updates are one ``apply_deduped_many`` (one launch for rowwise Adagrad
    on a card), a lane-packed table's on its lane groups' views; its
    gradient rows travel as the d lanes of their ids' ``slots``."""
    n = mesh.size
    wire = plans[0].wire_dtype
    groups = _groups(plans, ids, [t.shape[1] for t in tables])
    if routes is None:
        routes, overflow = _routes(mesh, groups, ids, slots)
        overflow = mesh.all_sum(overflow)
    else:
        overflow = torch.zeros((), dtype=torch.int64, device=mesh.device)
    sent = []
    for g, route in zip(groups, routes):
        f, b = route.inv.shape
        g_rows = _padded(g, grads)  # [F, b, D]
        if g.lanes > 1:
            # A position's gradient lies in its own slot's lanes only (the
            # model reads no other), so its d lanes are all it has.
            d = g_rows.shape[-1] // g.lanes
            lanes = _stack_slots(g, slots)[:, :, None, None].expand(-1, -1, 1, d)
            g_rows = g_rows.view(f, b, g.lanes, d).gather(2, lanes)[:, :, 0]
        dim = g_rows.shape[-1]
        # One row a distinct id, its rows summed in batch order, each
        # table's segments apart (bit for bit a sum a table), a hot id's
        # rows in runs (multi-hot bags repeat an id 10^5 times).
        seg = route.inv.gather(1, route.order) + torch.arange(f, device=route.inv.device)[:, None] * b
        combined = _segment_sums(seg.reshape(-1), g_rows.gather(
            1, route.order[:, :, None].expand(-1, -1, dim)).reshape(-1, dim)).view(f, b, dim)
        pos = route.send_pos.reshape(f, -1)
        rows = combined.gather(1, pos.clamp(max=b - 1)[:, :, None].expand(-1, -1, dim))
        rows = torch.where((pos < b)[:, :, None], rows, 0.0).view(f, n, g.capacity, dim)
        sent.append(rows.to(wire) if wire is not None else rows)
    uids, combined = [None] * len(plans), [None] * len(plans)
    views, view_states = list(tables), list(states)
    for g, route, recv in zip(groups, routes, _exchange(mesh, sent, "update")):
        f = len(g.members)
        lrow = route.recv_ids.reshape(f, -1) - g.key_base
        lrow = torch.where((lrow >= 0) & (lrow < g.key_rps), lrow, g.key_rps).to(torch.int32)
        rows = recv.reshape(f, lrow.shape[1], -1).to(torch.float32)
        # One batched sort for the group: bit for bit a combine a table
        # (the sentinels as the group's cached [F, 1] tensor: no host copy;
        # the capacity's empty slots, one run of the sentinel, in runs).
        u, c = combine_duplicate_ids_grouped(lrow, rows, g.key_rps)
        for j, i in enumerate(g.members):
            uids[i], combined[i] = u[j], c[j]
            views[i] = _lane_view(tables[i], "table", g.lanes)
            view_states[i] = {k: _lane_view(v, k, g.lanes) for k, v in states[i].items()}
    # In place on the views, so on the blocks themselves.
    sparse_opt.apply_deduped_many(views, view_states, uids, combined, lr)
    return list(tables), list(states), overflow


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
        groups.append((members, group, vocab))
        send_ids.append(sids.reshape(f, cap))
        send_rows.append(torch.where((pos < b)[:, :, None], rows, 0.0))
        overflow.append(ovf)
    recv = zip(_data_all_gather(mesh, send_ids), _data_all_gather(mesh, send_rows))
    combined = []
    for (members, group, vocab), (all_ids, all_rows) in zip(groups, recv):
        # Every data rank's rows of a table, one batched combine for the group.
        combined.append(combine_duplicate_ids_grouped(all_ids, all_rows, vocab))
    stats = [None] * len(groups)
    if sparse_opt.name != "sgd":
        sumsq = [(g * g).sum(dim=-1) for _, g in combined]
        total = mesh.all_sum(torch.cat([s.reshape(-1) for s in sumsq]), "table")
        stats = [t.view(s.shape) / group[0].dim for t, s, (_, group, _) in
                 zip(torch.split(total, [s.numel() for s in sumsq]), sumsq, groups)]
    new_tables, new_states = list(tables), list(states)
    for (members, _, _), (uids, g), stat in zip(groups, combined, stats):
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

