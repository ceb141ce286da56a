"""The sharded train step: the counterpart of ``tfrec_tpu/parallel/step.py``
over ``torch.distributed``, one process a rank.

Layout on each rank of the ``data`` x ``table`` mesh (the reference's
shardings; N is the data axis' size):

- batch: this data index's contiguous rows of the global batch (B / N),
  the same on every rank of the index (the batch splits over ``data``
  only);
- dense params and their optimizer state: replicated; each rank's gradient
  is of its local mean, so the dense gradients are averaged over ``data``
  (one ``all_reduce`` that also carries the loss). Under
  ``mesh.dense_sharding="fsdp"`` each data index holds one block of every
  leaf that splits (the reference's ``_dense_sharding``: the first axis
  whose size divides by N and is at least N; scalars and leaves that do
  not divide stay whole), and of its optimizer moments. Before the forward
  one ``all_gather`` rebuilds every split leaf; after the same
  ``all_reduce`` each rank updates its blocks only. The dense optimizers
  are elementwise, so this is the replicated step bit for bit;
  ``dense_params`` and ``logical_state`` give the whole leaves back (a
  collective);
- tables (``mesh.table_sharding="row"``): a block of V_pad / N rows a data
  index, replicated over ``table``, looked up and updated through
  ``parallel/embedding.py``'s all-to-all exchange over ``data`` (all tables
  in one exchange a direction);
- tables under ``"col"``: D/T columns of every row a table index,
  replicated over ``data`` (``ColShardedTable``: a local gather and an
  ``all_gather`` over ``table``; the update gathers every data rank's ids
  and column slices, with the column statistic); a table whose dim does
  not divide by T (a [V, 1] bias) is replicated instead, with the
  reference's warning where its dim is above 1, and col at T = 1 warns as
  the reference does (the machinery without the memory scaling);
- tables under ``"replicated"``: whole on every rank, gathered locally,
  and updated from every data rank's ids and gradient rows
  (``all_gather``), so the replicas stay equal;
- lane-packed tables (``model.lane_pack=True``) under "row": the lane-sliced
  wire of ``parallel/embedding.py``, each position's lane group from
  ``model.lane_slot_widths``;
- every sharded table's gradient rows are scaled by 1/N before they leave
  the rank, so that the combine sums the gradient of the GLOBAL mean, as
  the reference differentiates it;
- sparse optimizer state: sharded like its table (under "col" a [V, D]
  leaf by columns, a rowwise [V] leaf replicated).

``init_state`` draws the global unpadded state from the generator (the
single-device ``init_state``), then pads, permutes and keeps this rank's
block (``convert.shard_state``), so a state is the same at every world
size; ``unpadded_tables`` (a collective) gives the logical tables back. The
step returns ``{"loss": the global mean, "lookup_overflow": the ids dropped
this step, summed over tables and ranks}``.

With ``device_negatives`` the step draws the global batch's negatives from
its generator and takes this data index's rows, so they are the
single-device step's at any mesh shape. A model's forward noise is drawn
the same way, through its ``step_noise`` hook (IRGAN's Gumbel draw), and a
loss that takes a batch mean of its own (``make_loss(batch_mean=)``, IRGAN's
REINFORCE baseline) gets the global batch's, one scalar ``all_sum`` before
the backward, as the reference's step over the global batch computes them.

Refused: lane-packed tables under "col" (the feature split would cut
across lane groups, as the reference refuses),
``mesh.table_sharding="gspmd"`` (an A/B of XLA's partitioner against the
explicit exchange, docs/DESIGN.md:35, which has no PyTorch counterpart: not
ported), and ``train.host_dedup`` (host sorts of local ids mean nothing
after the exchange; the reference refuses it too). As in the reference
(``group_dedup=False``), each table's ids are combined alone.

While a profiler records, each step opens ``tfrec.step`` and, inside it in
this order, ``tfrec.lookup`` (around ``tfrec.exchange.lookup``, the row
exchange), ``tfrec.forward``, ``tfrec.backward``, ``tfrec.dense_allreduce``
(the dense gradients' mean), ``tfrec.dense_update`` and
``tfrec.sparse_update`` (around ``tfrec.exchange.update``); what the
exchange moves is counted in ``Mesh.counters``.
"""

from __future__ import annotations

import warnings
from typing import Dict

import torch

from tfrec_tpu_torch import convert
from tfrec_tpu_torch.configs import MeshConfig, OptimConfig
from tfrec_tpu_torch.models.base import RecModel
from tfrec_tpu_torch.ops.embedding import gather_many
from tfrec_tpu_torch.parallel.embedding import (
    ColShardedTable,
    RowShardedTable,
    col_lookup,
    col_update,
    exchange_lookup,
    exchange_update,
    wire_dtype,
)
from tfrec_tpu_torch.parallel.mesh import Mesh
from tfrec_tpu_torch.train.losses import make_loss
from tfrec_tpu_torch.train.step import (
    State,
    TrainStepBuilder,
    _unflatten,
    apply_updates,
    batch_size_of,
    tree_leaves,
    tree_map,
)
from tfrec_tpu_torch.utils.profile import span

DENSE_SHARDINGS = ("replicated", "fsdp")


def fsdp_axis(shape, n: int) -> int | None:
    """The axis FSDP splits a dense leaf of ``shape`` on over ``n`` data
    ranks (the reference's ``_dense_sharding``): the first whose size
    divides by n and is at least n; None keeps the leaf whole."""
    for axis, size in enumerate(shape):
        if size % n == 0 and size >= n:
            return axis
    return None


class ShardedTrainStepBuilder(TrainStepBuilder):
    """``TrainStepBuilder`` with sharded tables and explicit collective
    lookups, on the mesh's device."""

    def __init__(self, model: RecModel, loss_name: str, optim_cfg: OptimConfig, mesh: Mesh,
                 mesh_cfg: MeshConfig | None = None, *, l2_reg: float = 0.0, seed: int = 0,
                 device_negatives: bool = False, num_items: int = 0):
        super().__init__(model, loss_name, optim_cfg, l2_reg=l2_reg, seed=seed, device=mesh.device,
                         device_negatives=device_negatives, num_items=num_items)
        self.mesh = mesh
        self.loss_fn = make_loss(loss_name, batch_mean=self._global_mean)
        self.mesh_cfg = mesh_cfg = mesh_cfg or MeshConfig()
        mode = mesh_cfg.table_sharding
        if mode not in ("row", "col", "gspmd", "replicated"):
            raise ValueError(f"unknown mesh.table_sharding {mode!r}")
        if mode == "gspmd":
            raise NotImplementedError(
                "mesh.table_sharding='gspmd' is not ported: it is an A/B of XLA's SPMD "
                "partitioner against the explicit exchange (docs/DESIGN.md:35), with no PyTorch "
                "counterpart; use 'row'")
        if mesh_cfg.dense_sharding not in DENSE_SHARDINGS:
            raise ValueError(f"unknown mesh.dense_sharding {mesh_cfg.dense_sharding!r}")
        self.fsdp = mesh_cfg.dense_sharding == "fsdp"
        self._dense_axes: list | None = None  # each dense leaf's FSDP axis, from shard_state
        self._dense_full = None  # (the blocks' tree, its gathered leaves)
        if mesh_cfg.row_permute:
            if mode != "row":
                raise ValueError("mesh.row_permute applies to table_sharding='row' only")
            if model.dot_decomposition() is not None:
                raise ValueError(
                    "mesh.row_permute is for CTR workloads: retrieval models score the live "
                    "sharded item table and would return permuted (physical) item ids from top-k")
        wire = wire_dtype(mesh_cfg.a2a_dtype)
        t_axis = mesh.shape["table"]
        if mode == "col" and t_axis <= 1:
            warnings.warn("table_sharding='col' on a table axis of size 1: all the machinery, none "
                          "of the memory scaling; for benchmarks of the col path only",
                          stacklevel=2)
        self.plans: Dict[str, RowShardedTable | ColShardedTable | None] = {}
        for spec in model.table_specs():
            if mode == "replicated":
                self.plans[spec.name] = None
                continue
            if mode == "col":
                if spec.lane_groups > 1:
                    raise ValueError(
                        f"table {spec.name!r} is lane-packed (lane_groups={spec.lane_groups}); "
                        "column sharding would split across lane groups: use row or replicated "
                        "table_sharding")
                if spec.dim % t_axis:
                    if spec.dim > 1:
                        warnings.warn(
                            f"table {spec.name!r}: dim {spec.dim} not divisible by table axis "
                            f"{t_axis}; REPLICATING instead of column-sharding (memory cost!)",
                            stacklevel=2)
                    self.plans[spec.name] = None
                else:
                    self.plans[spec.name] = ColShardedTable(
                        mesh, spec.vocab, spec.dim, capacity_factor=mesh_cfg.a2a_capacity_factor)
                continue
            self.plans[spec.name] = RowShardedTable(
                mesh, spec.vocab, spec.dim, capacity_factor=mesh_cfg.a2a_capacity_factor,
                wire_dtype=wire, lane_groups=spec.lane_groups,
                recv_combine=mesh_cfg.recv_combine, permute=mesh_cfg.row_permute)

    # ---- state ----

    def init_state(self, generator: torch.Generator) -> State:
        """The single-device state from ``generator`` (the same draws at any
        world size), as this rank's blocks."""
        return self.shard_state(super().init_state(generator))

    def shard_state(self, state: State) -> State:
        """A global logical state -> this rank's: the tables by their plans
        (``convert.shard_state``) and, under FSDP, the blocks of the dense
        leaves and their optimizer moments."""
        out = convert.shard_state(state, self.mesh, self.plans)
        if self.fsdp:
            n = self.mesh.size
            self._dense_axes = [fsdp_axis(tuple(leaf.shape), n) for leaf in tree_leaves(out["dense"])]
            out["dense"] = self._dense_blocks(out["dense"])
            out["dense_opt"] = {k: (v if k == "count" else self._dense_blocks(v))
                                for k, v in out["dense_opt"].items()}
        return out

    def _dense_blocks(self, tree):
        """This data index's block of each leaf of a dense-shaped tree
        (params, gradients or a moment) on its FSDP axis."""
        n, i = self.mesh.size, self.mesh.data_index
        it = iter(self._dense_axes)

        def block(leaf):
            axis = next(it)
            if axis is None:
                return leaf
            size = leaf.shape[axis] // n
            return leaf.narrow(axis, i * size, size).contiguous()

        return tree_map(block, tree)

    def _dense_whole(self, tree):
        """The whole leaves of a tree of FSDP blocks: every split leaf in
        one ``all_gather`` over ``data`` (a collective)."""
        leaves = tree_leaves(tree)
        split = [(leaf, a) for leaf, a in zip(leaves, self._dense_axes) if a is not None]
        if not split:
            return tree
        n = self.mesh.size
        moved = [leaf.movedim(a, 0) for leaf, a in split]
        flat = self.mesh.all_gather(torch.cat([m.reshape(1, -1) for m in moved], dim=1))
        parts = iter(torch.split(flat, [m.numel() for m in moved], dim=1))
        whole = []
        for leaf, a in zip(leaves, self._dense_axes):
            if a is None:
                whole.append(leaf)
                continue
            m = leaf.movedim(a, 0)
            x = next(parts).reshape((n * m.shape[0],) + tuple(m.shape[1:]))
            whole.append(x.movedim(0, a).contiguous())
        return _unflatten(tree, whole)

    def dense_params(self, state: State):
        """The whole dense params (under FSDP gathered from every rank's
        blocks, a collective, once per state)."""
        if not self.fsdp:
            return state["dense"]
        if self._dense_full is None or self._dense_full[0] is not state["dense"]:
            self._dense_full = (state["dense"], self._dense_whole(state["dense"]))
        return self._dense_full[1]

    def unpadded_tables(self, state: State) -> Dict[str, torch.Tensor]:
        """The logical [V, D] tables, de-permuted and unpadded, on every rank
        (a collective: every rank calls it)."""
        return {name: (self.plans[name].unshard(t) if self.plans.get(name) is not None else t)
                for name, t in state["tables"].items()}

    def logical_dense(self, state: State) -> State:
        """``state`` with whole dense params and optimizer moments (under
        FSDP a collective; the state itself otherwise)."""
        if not self.fsdp:
            return state
        opt = {k: (v if k == "count" else self._dense_whole(v)) for k, v in state["dense_opt"].items()}
        return {**state, "dense": self.dense_params(state), "dense_opt": opt}

    def logical_state(self, state: State) -> State:
        """The global logical train state, on every rank (a collective)."""
        tables = self.unpadded_tables(state)
        sparse = {name: {k: (self.plans[name].unshard(v) if self.plans.get(name) is not None else v)
                         for k, v in st.items()} for name, st in state["sparse_opt"].items()}
        return {**self.logical_dense(state), "tables": tables, "sparse_opt": sparse}

    def _slots(self, names, ids):
        """Each lane-packed table's [b] lane groups (None for the others)."""
        return [self._slots_for(n, ids[n].shape[0]) if self.plans[n].lane_groups > 1 else None
                for n in names]

    def _row_names(self, names):
        return [n for n in names if isinstance(self.plans.get(n), RowShardedTable)]

    def _col_names(self, names):
        return [n for n in names if isinstance(self.plans.get(n), ColShardedTable)]

    # ---- seams ----

    def lookup(self, tables, ids, want_route: bool = False):
        """(rows per table, {"lookup_overflow", and with route reuse "_route"}):
        the row-sharded tables through one exchange, the column-sharded ones
        through one local gather and ``all_gather``, replicated ones by the
        local gather."""
        sharded, cols = self._row_names(ids), self._col_names(ids)
        rows: Dict[str, torch.Tensor] = {}
        aux: Dict[str, object] = {}
        overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        if sharded:
            with span("tfrec.exchange.lookup"):
                out, ovf, routes = exchange_lookup(
                    self.mesh, [self.plans[n] for n in sharded], [tables[n] for n in sharded],
                    [ids[n] for n in sharded], self._slots(sharded, ids))
            rows.update(zip(sharded, out))
            overflow = overflow + ovf
            if want_route and self.mesh_cfg.route_reuse:
                aux["_route"] = routes  # the exchange's, a group of tables each
        if cols:
            out, ovf = col_lookup(self.mesh, [self.plans[n] for n in cols], [tables[n] for n in cols],
                                  [ids[n] for n in cols])
            rows.update(zip(cols, out))
            overflow = overflow + ovf
        aux["lookup_overflow"] = overflow
        local = [n for n in ids if n not in rows]
        if local:
            rows.update(zip(local, gather_many([tables[n] for n in local], [ids[n] for n in local])))
        return {n: rows[n] for n in ids}, aux

    def sparse_update_all(self, state: State, ids, gathered_grad, lr, host_sort=None, route=None):
        """The row-sharded tables' update through one exchange (reusing the
        lookup's ``route`` where given), the column-sharded ones' through
        ``col_update``; replicated tables from every data rank's ids and
        rows."""
        if host_sort:
            raise ValueError("train.host_dedup is not supported on the mesh path")
        new_tables = dict(state["tables"])
        new_sparse = dict(state["sparse_opt"])
        sharded, cols = self._row_names(gathered_grad), self._col_names(gathered_grad)
        if cols:
            # The update's own overflow is dropped, as the reference's builder does.
            tables, states, _ = col_update(
                self.mesh, [self.plans[n] for n in cols], [state["tables"][n] for n in cols],
                [state["sparse_opt"][n] for n in cols], [ids[n] for n in cols],
                [gathered_grad[n] for n in cols], self.sparse_opt, lr)
            new_tables.update(zip(cols, tables))
            new_sparse.update(zip(cols, states))
        if sharded:
            with span("tfrec.exchange.update"):
                tables, states, _ = exchange_update(
                    self.mesh, [self.plans[n] for n in sharded], [state["tables"][n] for n in sharded],
                    [state["sparse_opt"][n] for n in sharded], [ids[n] for n in sharded],
                    [gathered_grad[n] for n in sharded], self.sparse_opt, lr, route,
                    self._slots(sharded, ids))
            new_tables.update(zip(sharded, tables))
            new_sparse.update(zip(sharded, states))
        for name in gathered_grad:
            if self.plans.get(name) is not None:
                continue
            all_ids = self.mesh.all_gather(ids[name])
            all_grads = self.mesh.all_gather(gathered_grad[name])
            if self._grouped_adam(name):  # each rank's lane groups beside its ids
                slots = self.mesh.all_gather(self._slots_for(name, ids[name].shape[0]))
                new_tables[name], new_sparse[name] = self.sparse_opt.apply(
                    state["tables"][name], state["sparse_opt"][name], all_ids, all_grads, lr,
                    slots=slots)
                continue
            new_tables[name], new_sparse[name] = self.sparse_update(
                name, state["tables"][name], state["sparse_opt"][name], all_ids, all_grads, lr)
        return new_tables, new_sparse

    def _global_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch's mean of a detached per-row ``t``: one scalar
        all_sum over the data axis."""
        return self.mesh.all_sum(t.sum()) / (t.shape[0] * self.mesh.size)

    def objective(self, logits, batch, gathered, dense_leaves) -> torch.Tensor:
        """The local objective whose gradients, the rows' scaled by 1/N and
        the dense ones averaged over ranks, are the reference's gradients of
        the global one: the local mean loss, the gathered rows' l2 over the
        local batch, the dense params' over the global batch."""
        loss = self.loss_fn(logits, batch)
        if self.l2_reg > 0:
            b = batch_size_of(logits)
            rows = sum((v * v).sum() for v in gathered.values())
            dense = sum((p * p).sum() for p in dense_leaves)
            loss = loss + self.l2_reg * (rows / b + dense / (b * self.mesh.size))
        return loss

    # ---- the step ----

    def _draw_negatives(self, batch, generator):
        """Device negatives: the global batch's draw, this data index's
        rows of it."""
        if not self.device_negatives or "pos" not in batch or "neg" in batch or "negs" in batch:
            return batch
        pos = batch["pos"]
        b, n = pos.shape[0], self.mesh.size
        neg = torch.randint(0, self.num_items, (b * n,) + tuple(pos.shape[1:]), generator=generator,
                            dtype=torch.int32, device=pos.device)
        lo = self.mesh.data_index * b
        return {**batch, "neg": neg[lo:lo + b]}

    def step(self, state: State, batch: Dict[str, torch.Tensor]):
        """One step on this rank's rows of the global batch -> (new state,
        {"loss", "lookup_overflow"}), both global and the same on every
        rank."""
        if any(k.startswith("_sort_") for k in batch):
            raise ValueError("train.host_dedup is not supported on the mesh path")
        with span("tfrec.step"):
            n = self.mesh.size
            generator = self._generator(state["step"])
            batch = self._draw_negatives(batch, generator)
            with span("tfrec.lookup"):
                ids = self.model.lookup_ids(batch)
                gathered, aux = self.lookup(state["tables"], ids, want_route=True)
            forward_kw = self.model.step_noise(batch, generator, self.mesh.size, self.mesh.data_index)
            loss, dense_grad, row_grads = self.grads_at(
                {**state, "dense": self.dense_params(state)}, batch, gathered, generator, forward_kw)
            with span("tfrec.dense_allreduce"):
                # One all_reduce: the dense gradients' mean and the global loss.
                leaves = tree_leaves(dense_grad)
                flat = torch.cat([g.reshape(-1) for g in leaves] + [loss.reshape(1)])
                flat = self.mesh.all_mean(flat)
                sizes = [g.numel() for g in leaves]
                parts = torch.split(flat[:-1], sizes) if sizes else []
                dense_grad = _unflatten(state["dense"], [p.view_as(g) for p, g in zip(parts, leaves)])
            if self.fsdp:  # each rank updates its own blocks
                dense_grad = self._dense_blocks(dense_grad)
            row_grads = {k: g * (1.0 / n) for k, g in row_grads.items()}
            with span("tfrec.dense_update"):
                updates, new_dense_opt = self.dense_tx.update(dense_grad, state["dense_opt"],
                                                              state["dense"])
                new_dense = apply_updates(state["dense"], updates)
            lr = self.sparse_schedule(state["step"])
            with span("tfrec.sparse_update"):
                new_tables, new_sparse = self.sparse_update_all(state, ids, row_grads, lr,
                                                                route=aux.get("_route"))
        new_state = {
            "step": state["step"] + 1,
            "tables": new_tables,
            "dense": new_dense,
            "sparse_opt": new_sparse,
            "dense_opt": new_dense_opt,
        }
        return new_state, {"loss": flat[-1], "lookup_overflow": aux["lookup_overflow"]}

    def multi_step(self, state: State, batches: Dict[str, torch.Tensor]):
        """K steps, as ``TrainStepBuilder.multi_step``, with
        ``lookup_overflow`` summed over them (a loudness counter)."""
        k = next(iter(batches.values())).shape[0]
        losses, overflow = [], []
        for i in range(k):
            state, metrics = self.step(state, {name: v[i] for name, v in batches.items()})
            losses.append(metrics["loss"])
            overflow.append(metrics["lookup_overflow"])
        return state, {**metrics, "loss_mean": torch.stack(losses).mean(),
                       "lookup_overflow": torch.stack(overflow).sum()}
