"""Shared plumbing for CTR models over multi-field categorical + dense input.

The counterpart of ``tfrec_tpu/models/ctr_base.py``. Batch convention:
{"dense": [B, Dd] f32 (Dd may be 0), "cat": [B, sum(W_f)] int32}. A
width-W_f multi-hot field occupies W_f columns, padded with the sentinel
``vocab_f`` (clamped by the gather, masked out of the combine). Multi-hot
bags are combined over their valid ids by the model's ``combiner``: their
mean (the default, the reference's rule) or their sum (MLPerf DLRM-DCNv2's
``EmbeddingBag`` pooling); linear terms are summed. While a profiler
records, a model with bags opens the span ``tfrec.bag_pool`` around the
combine of its field embeddings.

Three table layouts, the reference's, each read by the same model code
through ``_all_field_rows``:

- per field (the default): ``field_{f}`` [V_f, d_f], and for models with
  linear terms (FM) ``lin_{f}`` [V_f, 1] (zeros at init), read with the
  field's own ids;
- lane-packed (``enable_lane_packing``, ``model.lane_pack=True``): P = 128
  // d fields side by side in ``pack_{k}`` [max V, P*d], fields sorted by
  descending vocab (a stable sort), and the linear tables 128 a
  ``linpack_{k}``; a field's ids past its vocab become the pack's;
- stacked (``enable_stacked_tables``, ``model.stack_tables=True``): one
  ``fields`` [sum V_f, d] table (and ``lin``), field f's rows from its
  vocab offset; ids past a field's vocab become ``total_vocab``.

``layout_blocks`` says where each per-field table lies in a layout, and
``split_fields`` / ``join_fields`` move tables (and the optimizer's leaves)
between the per-field layout and another. ``init`` draws the per-field
tables in every layout, so a pack holds the per-field layout's tables
exactly (its other rows zero) and the seeded run does not depend on the
layout.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec, RecModel
from tfrec_tpu_torch.ops.embedding import TableSpec, init_tables
from tfrec_tpu_torch.utils.profile import span

LANES = 128  # a pack's width: the TPU's lanes, which the layout was made for
COMBINERS = ("mean", "sum")  # a multi-hot bag's pooling


class CTRBase(RecModel):
    use_linear_tables = False
    # Models whose interaction needs EQUAL field dims set this False;
    # concat-based towers (DCN) accept mixed dims.
    supports_mixed_dims = False

    def __init__(self, data_spec: DataSpec, embed_dim: int, field_dims=None, *, combiner: str = "mean"):
        super().__init__()
        if data_spec.kind != "ctr":
            raise ValueError(f"{type(self).__name__} needs a ctr DataSpec, got {data_spec.kind!r}")
        self.data_spec = data_spec
        self.embed_dim = embed_dim
        nf = len(data_spec.field_vocabs)
        if field_dims:
            field_dims = tuple(field_dims)
            if len(field_dims) != nf:
                raise ValueError(f"{len(field_dims)} field dims for {nf} fields")
            if not self.supports_mixed_dims and len(set(field_dims)) > 1:
                raise ValueError(
                    f"{type(self).__name__} needs equal field dims; mixed "
                    "field_dims work with dcn/dcnv2"
                )
            self.field_dims = field_dims
        else:
            self.field_dims = (embed_dim,) * nf
        self.widths = data_spec.field_widths or (1,) * nf
        self.combiner = combiner
        self._offsets = []
        off = 0
        for w in self.widths:
            self._offsets.append(off)
            off += w
        self.cat_columns = off
        # The stacked layout: field f's row r is row _voffsets[f] + r of one
        # [sum V_f, d] table; its sentinel is total_vocab.
        self._voffsets = []
        voff = 0
        for v in data_spec.field_vocabs:
            self._voffsets.append(voff)
            voff += v
        self.total_vocab = voff
        self.layout = "field"  # or "pack", "stack"
        self._columns = {}  # device -> (vocab, offset) of each cat column

    @property
    def combiner(self) -> str:
        """How a multi-hot bag's rows pool into its field's embedding:
        "mean" or "sum" (settable on any CTR model)."""
        return self._combiner

    @combiner.setter
    def combiner(self, name: str) -> None:
        if name not in COMBINERS:
            raise ValueError(f"unknown bag combiner {name!r}; options: {COMBINERS}")
        self._combiner = name

    @property
    def lane_pack(self) -> bool:
        return self.layout == "pack"

    @property
    def stack_tables(self) -> bool:
        return self.layout == "stack"

    def enable_stacked_tables(self) -> "CTRBase":
        """All fields in ONE [sum V_f, d] table (and one [sum V_f, 1] linear
        table): one gather, one duplicate combine and one sparse update a
        step. Field id spaces are disjoint after the offsets, and the
        rowwise optimizers are row-local, so the math is the per-field
        math. Requires equal field dims."""
        if len(set(self.field_dims)) > 1:
            raise ValueError(f"model.stack_tables requires equal per-field embedding dims, got "
                             f"{self.field_dims}")
        if self.lane_pack:
            raise ValueError("stack_tables and lane_pack are mutually exclusive")
        self.layout = "stack"
        return self

    def enable_lane_packing(self) -> "CTRBase":
        """Pack P = 128 // d fields side by side in one [max V, P*d] table
        (and the linear tables 128 to a pack). The reference packs for the
        TPU's 128-lane rows; each pack keeps per-group rowwise optimizer
        state ([V, P], ``TableSpec.lane_groups``), and a row touched by one
        field gives its pack-mates exactly zero gradient and, under
        Adagrad, zero accumulator gain, so the update is bit for bit the
        per-field rule (rowwise Adam takes each id's group, ``lane_slot_
        widths``). Requires equal field dims d < 128 dividing 128."""
        if self.stack_tables:
            raise ValueError("stack_tables and lane_pack are mutually exclusive")
        self._packs, self._lin_packs = self._pack_groups()
        self.layout = "pack"
        return self

    def _pack_groups(self):
        """(field packs, linear packs) of the lane-packed layout: fields by
        descending vocab (a stable sort), P = 128 // d a pack, 128 a linear
        pack (none without linear tables)."""
        if len(set(self.field_dims)) > 1:
            raise ValueError(f"model.lane_pack requires equal per-field embedding dims, got "
                             f"{self.field_dims}")
        d = self.field_dims[0]
        if d >= LANES or LANES % d != 0:
            raise ValueError(f"model.lane_pack needs embed_dim < {LANES} dividing {LANES} (got {d}); "
                             "at d >= 128 rows already fill their lane lines and packing buys nothing")
        vocabs = self.data_spec.field_vocabs
        order = sorted(range(self.num_fields), key=lambda f: -vocabs[f])

        def groups(per_pack):
            return [order[i : i + per_pack] for i in range(0, len(order), per_pack)]

        return groups(LANES // d), (groups(LANES) if self.use_linear_tables else [])

    def _pack_vocab(self, grp) -> int:
        return max(self.data_spec.field_vocabs[f] for f in grp)

    def lane_slot_widths(self, name: str):
        """A lane-packed table's slots: the bag widths of its fields in the
        order of its id vector (slot s owns lanes [s*d, (s+1)*d), and ids
        [B * sum(W before s), B * sum(W up to s))); None for any other
        table. Grouped rowwise Adam reads which groups a batch touched from
        it."""
        if not self.lane_pack:
            return None
        if name.startswith("pack_"):
            grp = self._packs[int(name[len("pack_"):])]
        elif name.startswith("linpack_"):
            grp = self._lin_packs[int(name[len("linpack_"):])]
        else:
            return None
        return tuple(self.widths[f] for f in grp)

    @property
    def num_fields(self) -> int:
        return len(self.data_spec.field_vocabs)

    def _field_specs(self) -> List[TableSpec]:
        vocabs = self.data_spec.field_vocabs
        specs = [TableSpec(f"field_{f}", v, self.field_dims[f]) for f, v in enumerate(vocabs)]
        if self.use_linear_tables:
            specs += [TableSpec(f"lin_{f}", v, 1, initializer="zeros") for f, v in enumerate(vocabs)]
        return specs

    def table_specs(self) -> Tuple[TableSpec, ...]:
        if self.lane_pack:
            d = self.field_dims[0]
            # The per-field init scale: the default 1/sqrt(dim) would
            # shrink with the packed width.
            specs = [TableSpec(f"pack_{k}", self._pack_vocab(grp), len(grp) * d,
                               lane_groups=len(grp), init_scale=1.0 / d**0.5)
                     for k, grp in enumerate(self._packs)]
            specs += [TableSpec(f"linpack_{k}", self._pack_vocab(grp), len(grp),
                                lane_groups=len(grp), initializer="zeros")
                      for k, grp in enumerate(self._lin_packs)]
            return tuple(specs)
        if self.stack_tables:
            specs = [TableSpec("fields", self.total_vocab, self.field_dims[0])]
            if self.use_linear_tables:
                specs.append(TableSpec("lin", self.total_vocab, 1, initializer="zeros"))
            return tuple(specs)
        return tuple(self._field_specs())

    def layout_blocks(self, layout: str | None = None) -> Dict[str, List[Tuple[str, int, int]]]:
        """Where each per-field table lies in ``layout`` (default: this
        model's): {table: [(per-field table, first row, lane-group slot),
        ...]}, tables in ``table_specs`` order. Per-field table ``field_f``
        covers rows [first, first + V_f) and, in a pack, lanes [slot*d,
        (slot+1)*d) (``lin_f`` one lane)."""
        layout = layout or self.layout
        prefixes = ("field", "lin") if self.use_linear_tables else ("field",)
        nf = self.num_fields
        if layout == "field":
            return {f"{p}_{f}": [(f"{p}_{f}", 0, 0)] for p in prefixes for f in range(nf)}
        if layout == "stack":
            names = {"field": "fields", "lin": "lin"}
            return {names[p]: [(f"{p}_{f}", self._voffsets[f], 0) for f in range(nf)]
                    for p in prefixes}
        if layout != "pack":
            raise ValueError(f"unknown table layout {layout!r}")
        packs, lin_packs = self._pack_groups()
        out = {f"pack_{k}": [(f"field_{f}", 0, slot) for slot, f in enumerate(grp)]
               for k, grp in enumerate(packs)}
        out.update({f"linpack_{k}": [(f"lin_{f}", 0, slot) for slot, f in enumerate(grp)]
                    for k, grp in enumerate(lin_packs)})
        return out

    def _block(self, table, name: str, row: int, slot: int, stat: bool):
        """Per-field table ``name``'s block of ``table`` (a view): its rows
        and lanes, or with ``stat`` its column of a [V, G] statistic."""
        field = int(name.rsplit("_", 1)[1])
        rows = table[row : row + self.data_spec.field_vocabs[field]]
        if stat:
            return rows[:, slot] if rows.ndim == 2 else rows
        width = 1 if name.startswith("lin_") else self.field_dims[field]
        return rows[:, slot * width : (slot + 1) * width]

    def split_fields(self, tables, layout: str | None = None, stat: bool = False) -> Dict[str, torch.Tensor]:
        """The per-field tables held in ``tables`` (laid out in ``layout``,
        default this model's), as views; with ``stat`` the per-field [V_f]
        rowwise statistics held in [V] or [V, G] ones (Adagrad's ``acc``,
        Adam's ``v`` and ``t``)."""
        return {name: self._block(tables[table], name, row, slot, stat)
                for table, blocks in self.layout_blocks(layout).items()
                for name, row, slot in blocks}

    def join_fields(self, fields, template, stat: bool = False) -> Dict[str, torch.Tensor]:
        """This model's tables built from per-field ones (``stat``: from
        per-field rowwise statistics): copies of ``template``'s tables in
        this layout with each field's block replaced; rows no field covers
        keep the template's values."""
        out = {}
        for table, blocks in self.layout_blocks().items():
            out[table] = template[table].clone()
            for name, row, slot in blocks:
                self._block(out[table], name, row, slot, stat).copy_(fields[name])
        return out

    def init(self, generator: torch.Generator, device: torch.device | str):
        """Layout-invariant: the per-field tables are drawn in every layout,
        one after another from ``generator``, then the dense params, so a
        packed or stacked model holds exactly the per-field model's params
        of the same seed (a pack's rows past a field's vocab are zeros)."""
        if self.layout == "field":
            return super().init(generator, device)
        fields = init_tables(generator, self._field_specs(), device)
        zeros = {s.name: torch.zeros(s.shape, device=device) for s in self.table_specs()}
        return {"tables": self.join_fields(fields, zeros), "dense": self.init_dense(generator, device)}

    def _field_ids(self, cat_t: torch.Tensor, f: int) -> torch.Tensor:
        """Field f's flat ids [B * W_f] from the transposed cat [sum W, B]."""
        off, w = self._offsets[f], self.widths[f]
        return cat_t[off] if w == 1 else cat_t[off : off + w].t().reshape(-1)

    def _column_limits(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each cat column's field vocab and vocab offset, [sum W] int32 on
        ``device`` (kept: the stacked layout's ids need them every batch)."""
        key = str(device)
        if key not in self._columns:
            vocab, voff = [], []
            for f, w in enumerate(self.widths):
                vocab += [self.data_spec.field_vocabs[f]] * w
                voff += [self._voffsets[f]] * w
            self._columns[key] = tuple(torch.tensor(x, dtype=torch.int32, device=device)
                                       for x in (vocab, voff))
        return self._columns[key]

    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        """{table: [N] int32}, each contiguous (sentinel-padded for bags):
        per field ``field_f`` [B * W_f]; a pack its fields' ids one after
        another, ids past a field's vocab remapped to the pack's; the
        stacked table ``fields`` [B * sum W], example by example, each id
        offset to its field's rows and ids past a field's vocab (or
        negative ones, which then read the field before's rows, as in the
        reference) remapped to ``total_vocab``. One transpose makes every
        field's column a contiguous row, so single-hot fields need no copy
        of their own."""
        if self.stack_tables:
            cat = batch["cat"]
            vocab, voff = self._column_limits(cat.device)
            gids = torch.where(cat < vocab, cat + voff, self.total_vocab).reshape(-1)
            return {"fields": gids, "lin": gids} if self.use_linear_tables else {"fields": gids}
        cat_t = batch["cat"].t().contiguous()  # [sum(W_f), B]
        field_ids = [self._field_ids(cat_t, f) for f in range(self.num_fields)]
        if self.lane_pack:
            vocabs = self.data_spec.field_vocabs

            def pack_ids(grp):
                vp = self._pack_vocab(grp)
                return torch.cat([torch.where(field_ids[f] < vocabs[f], field_ids[f], vp) for f in grp])

            ids = {f"pack_{k}": pack_ids(grp) for k, grp in enumerate(self._packs)}
            ids.update({f"linpack_{k}": pack_ids(grp) for k, grp in enumerate(self._lin_packs)})
            return ids
        ids = {f"field_{f}": i for f, i in enumerate(field_ids)}
        if self.use_linear_tables:
            ids.update({f"lin_{f}": ids[f"field_{f}"] for f in range(self.num_fields)})
        return ids

    def _combine(self, gathered_rows: torch.Tensor, batch, f: int, mean: bool = True) -> torch.Tensor:
        """[B*W, D] rows -> [B, D] masked mean (or sum) over the bag width."""
        w = self.widths[f]
        if w == 1:
            return gathered_rows
        bsz = batch["cat"].shape[0]
        off = self._offsets[f]
        valid = batch["cat"][:, off : off + w] < self.data_spec.field_vocabs[f]
        # where (not multiply): a masked row must contribute exactly 0.
        rows = torch.where(valid[:, :, None], gathered_rows.reshape(bsz, w, -1), 0.0)
        out = rows.sum(dim=1)
        if not mean:
            return out
        denom = valid.sum(dim=1).to(rows.dtype).clamp_min(1.0)
        return out / denom[:, None]

    def _all_field_rows(self, gathered, batch, prefix: str = "field") -> List[torch.Tensor]:
        """Every field's gathered rows [B * W_f, d_f] (``prefix`` "lin": its
        linear weights [B * W_f, 1]) in this model's layout: the reference's
        ``_field_rows`` for all fields at once. Each table's rows are split
        once into its fields' blocks, so autograd joins their gradients in
        one concatenation a table, where a slice taken field by field would
        write a gradient of the table's whole rows for each field, and add
        them."""
        bsz = batch["cat"].shape[0]
        if self.lane_pack:
            packs, name, d = ((self._packs, "pack", self.field_dims[0]) if prefix == "field"
                              else (self._lin_packs, "linpack", 1))
            out: List[torch.Tensor] = [None] * self.num_fields
            for k, grp in enumerate(packs):
                blocks = gathered[f"{name}_{k}"].split([bsz * self.widths[f] for f in grp])
                for slot, (f, rows) in enumerate(zip(grp, blocks)):
                    out[f] = rows[:, slot * d : (slot + 1) * d]
            return out
        if self.stack_tables:
            rows = gathered["fields" if prefix == "field" else "lin"].reshape(bsz, self.cat_columns, -1)
            return [r.reshape(bsz * w, -1)
                    for r, w in zip(rows.split(list(self.widths), dim=1), self.widths)]
        return [gathered[f"{prefix}_{f}"] for f in range(self.num_fields)]

    def field_list(self, gathered, batch) -> List[torch.Tensor]:
        """Per-field combined embeddings: list of [B, d_f], each bag pooled
        by the model's ``combiner`` (inside ``tfrec.bag_pool`` where the
        model has a bag)."""
        mean = self.combiner == "mean"
        rows = self._all_field_rows(gathered, batch)
        if max(self.widths) == 1:
            return rows
        with span("tfrec.bag_pool"):
            return [self._combine(r, batch, f, mean=mean) for f, r in enumerate(rows)]

    def field_stack(self, gathered, batch) -> torch.Tensor:
        """[B, F, D] combined field embeddings (equal dims required)."""
        return torch.stack(self.field_list(gathered, batch), dim=1)

    def linear_sum(self, gathered, batch) -> torch.Tensor:
        """[B] masked sum of the per-field linear weights."""
        total = 0.0
        for f, rows in enumerate(self._all_field_rows(gathered, batch, prefix="lin")):
            total = total + self._combine(rows, batch, f, mean=False)[:, 0]
        return total

    def flat_input(self, gathered, batch) -> torch.Tensor:
        """[B, sum(d_f) + Dd]: concatenated field embeddings + dense features."""
        parts = self.field_list(gathered, batch)
        if self.data_spec.num_dense > 0:
            parts.append(batch["dense"])
        return torch.cat(parts, dim=-1)


def fm_second_order(field_vecs: torch.Tensor) -> torch.Tensor:
    """0.5 * (||sum_f v_f||^2 - sum_f ||v_f||^2): every pairwise interaction
    in O(F*D), the FM identity. field_vecs [B, F, D] -> [B]."""
    total = field_vecs.sum(dim=1)
    sum_sq = (total * total).sum(dim=-1)
    sq_sum = (field_vecs * field_vecs).sum(dim=(1, 2))
    return 0.5 * (sum_sq - sq_sum)
