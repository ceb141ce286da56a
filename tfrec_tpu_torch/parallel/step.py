"""The sharded train step: the counterpart of ``tfrec_tpu/parallel/step.py``
over ``torch.distributed``, one process a rank.

Layout on each rank of the ``data`` x ``table`` mesh (the reference's
shardings; N is the data axis' size):

- batch: this data index's contiguous rows of the global batch (B / N),
  the same on every rank of the index (the batch splits over ``data``
  only);
- dense params and their optimizer state: replicated; each rank's gradient
  is of its local mean, so the dense gradients are averaged over ``data``
  (one ``all_reduce`` that also carries the loss);
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
single-device step's at any mesh shape.

Refused: ``mesh.dense_sharding="fsdp"`` (ROADMAP Queue 1 item 11),
lane-packed tables on the row path (item 11) and under "col" (the feature
split would cut across lane groups, as the reference refuses),
``mesh.table_sharding="gspmd"`` (an A/B of XLA's partitioner against the
explicit exchange, docs/DESIGN.md:35, which has no PyTorch counterpart: not
ported), and ``train.host_dedup`` (host sorts of local ids mean nothing
after the exchange; the reference refuses it too). As in the reference
(``group_dedup=False``), each table's ids are combined alone.
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
from tfrec_tpu_torch.train.step import State, TrainStepBuilder, _unflatten, apply_updates, tree_leaves


class ShardedTrainStepBuilder(TrainStepBuilder):
    """``TrainStepBuilder`` with sharded tables and explicit collective
    lookups, on the mesh's device."""

    def __init__(self, model: RecModel, loss_name: str, optim_cfg: OptimConfig, mesh: Mesh,
                 mesh_cfg: MeshConfig | None = None, *, l2_reg: float = 0.0, seed: int = 0,
                 device_negatives: bool = False, num_items: int = 0):
        super().__init__(model, loss_name, optim_cfg, l2_reg=l2_reg, seed=seed, device=mesh.device,
                         device_negatives=device_negatives, num_items=num_items)
        self.mesh = mesh
        self.mesh_cfg = mesh_cfg = mesh_cfg or MeshConfig()
        mode = mesh_cfg.table_sharding
        if mode not in ("row", "col", "gspmd", "replicated"):
            raise ValueError(f"unknown mesh.table_sharding {mode!r}")
        if mode == "gspmd":
            raise NotImplementedError(
                "mesh.table_sharding='gspmd' is not ported: it is an A/B of XLA's SPMD "
                "partitioner against the explicit exchange (docs/DESIGN.md:35), with no PyTorch "
                "counterpart; use 'row'")
        if mesh_cfg.dense_sharding == "fsdp":
            raise NotImplementedError(
                "mesh.dense_sharding='fsdp' is not ported yet: ROADMAP Queue 1 item 11; dense "
                "params are replicated")
        if mesh_cfg.dense_sharding != "replicated":
            raise ValueError(f"unknown mesh.dense_sharding {mesh_cfg.dense_sharding!r}")
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
        return convert.shard_state(super().init_state(generator), self.mesh, self.plans)

    def unpadded_tables(self, state: State) -> Dict[str, torch.Tensor]:
        """The logical [V, D] tables, de-permuted and unpadded, on every rank
        (a collective: every rank calls it)."""
        return {name: (self.plans[name].unshard(t) if self.plans.get(name) is not None else t)
                for name, t in state["tables"].items()}

    def logical_state(self, state: State) -> State:
        """The global logical train state, on every rank (a collective)."""
        tables = self.unpadded_tables(state)
        sparse = {name: {k: (self.plans[name].unshard(v) if self.plans.get(name) is not None else v)
                         for k, v in st.items()} for name, st in state["sparse_opt"].items()}
        return {**state, "tables": tables, "sparse_opt": sparse}

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
            out, ovf, routes = exchange_lookup(
                self.mesh, [self.plans[n] for n in sharded], [tables[n] for n in sharded],
                [ids[n] for n in sharded])
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
            tables, states, _ = exchange_update(
                self.mesh, [self.plans[n] for n in sharded], [state["tables"][n] for n in sharded],
                [state["sparse_opt"][n] for n in sharded], [ids[n] for n in sharded],
                [gathered_grad[n] for n in sharded], self.sparse_opt, lr, route)
            new_tables.update(zip(sharded, tables))
            new_sparse.update(zip(sharded, states))
        for name in gathered_grad:
            if self.plans.get(name) is not None:
                continue
            all_ids = self.mesh.all_gather(ids[name])
            all_grads = self.mesh.all_gather(gathered_grad[name])
            new_tables[name], new_sparse[name] = self.sparse_update(
                name, state["tables"][name], state["sparse_opt"][name], all_ids, all_grads, lr)
        return new_tables, new_sparse

    def objective(self, logits, batch, gathered, dense_leaves) -> torch.Tensor:
        """The local objective whose gradients, the rows' scaled by 1/N and
        the dense ones averaged over ranks, are the reference's gradients of
        the global one: the local mean loss, the gathered rows' l2 over the
        local batch, the dense params' over the global batch."""
        loss = self.loss_fn(logits, batch)
        if self.l2_reg > 0:
            b = logits.shape[0]
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
        n = self.mesh.size
        generator = self._generator(state["step"])
        batch = self._draw_negatives(batch, generator)
        ids = self.model.lookup_ids(batch)
        gathered, aux = self.lookup(state["tables"], ids, want_route=True)
        loss, dense_grad, row_grads = self.grads_at(state, batch, gathered, generator)
        # One all_reduce: the dense gradients' mean and the global loss.
        leaves = tree_leaves(dense_grad)
        flat = torch.cat([g.reshape(-1) for g in leaves] + [loss.reshape(1)])
        flat = self.mesh.all_mean(flat)
        sizes = [g.numel() for g in leaves]
        parts = torch.split(flat[:-1], sizes) if sizes else []
        dense_grad = _unflatten(state["dense"], [p.view_as(g) for p, g in zip(parts, leaves)])
        row_grads = {k: g * (1.0 / n) for k, g in row_grads.items()}
        updates, new_dense_opt = self.dense_tx.update(dense_grad, state["dense_opt"], state["dense"])
        new_dense = apply_updates(state["dense"], updates)
        lr = self.sparse_schedule(state["step"])
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
