"""Shared plumbing for CTR models over multi-field categorical + dense input.

The counterpart of ``tfrec_tpu/models/ctr_base.py`` with per-field tables.
Batch convention: {"dense": [B, Dd] f32 (Dd may be 0), "cat": [B, sum(W_f)]
int32}. A width-W_f multi-hot field occupies W_f columns, padded with the
sentinel ``vocab_f`` (clamped by the gather, masked out of the combine).
One table per field ("field_{f}"), and for models with linear terms (FM)
one [V_f, 1] table per field ("lin_{f}", zeros at init) read with the
field's own ids; multi-hot bags are mean-combined over their valid ids,
linear terms summed. The lane-packed and stacked table layouts of the reference
are not built here yet (ROADMAP Queue 1); ``convert.params_from_jax`` reads
JAX params in those layouts into per-field tables.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from tfrec_tpu_torch.models.base import DataSpec, RecModel
from tfrec_tpu_torch.ops.embedding import TableSpec


class CTRBase(RecModel):
    use_linear_tables = False
    # Models whose interaction needs EQUAL field dims set this False;
    # concat-based towers (DCN) accept mixed dims.
    supports_mixed_dims = False

    def __init__(self, data_spec: DataSpec, embed_dim: int, field_dims=None):
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
        self._offsets = []
        off = 0
        for w in self.widths:
            self._offsets.append(off)
            off += w
        self.cat_columns = off

    @property
    def num_fields(self) -> int:
        return len(self.data_spec.field_vocabs)

    def table_specs(self) -> Tuple[TableSpec, ...]:
        vocabs = self.data_spec.field_vocabs
        specs = [TableSpec(f"field_{f}", v, self.field_dims[f]) for f, v in enumerate(vocabs)]
        if self.use_linear_tables:
            specs += [TableSpec(f"lin_{f}", v, 1, initializer="zeros") for f, v in enumerate(vocabs)]
        return tuple(specs)

    def lookup_ids(self, batch) -> Dict[str, torch.Tensor]:
        """{"field_f": [B * W_f] int32}, each contiguous (sentinel-padded
        for bags). One transpose makes every field's column a contiguous
        row, so single-hot fields need no copy of their own."""
        cat_t = batch["cat"].t().contiguous()  # [sum(W_f), B]
        ids = {}
        for f in range(self.num_fields):
            off, w = self._offsets[f], self.widths[f]
            ids[f"field_{f}"] = (
                cat_t[off] if w == 1 else cat_t[off : off + w].t().reshape(-1)
            )
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

    def field_list(self, gathered, batch) -> List[torch.Tensor]:
        """Per-field combined embeddings: list of [B, d_f]."""
        return [
            self._combine(gathered[f"field_{f}"], batch, f)
            for f in range(self.num_fields)
        ]

    def field_stack(self, gathered, batch) -> torch.Tensor:
        """[B, F, D] combined field embeddings (equal dims required)."""
        return torch.stack(self.field_list(gathered, batch), dim=1)

    def linear_sum(self, gathered, batch) -> torch.Tensor:
        """[B] masked sum of the per-field linear weights."""
        total = 0.0
        for f in range(self.num_fields):
            total = total + self._combine(gathered[f"lin_{f}"], batch, f, mean=False)[:, 0]
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
