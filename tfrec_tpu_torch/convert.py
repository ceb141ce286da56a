"""Parameters written by the JAX package -> the port's parameters.

``params_from_jax`` takes a JAX params tree whose leaves are numpy arrays
(``{"tables": {...}, "dense": {...}}``, e.g. ``jax.tree.map(np.asarray,
params)``) and returns the same tree of CPU float32 tensors with per-field
tables, whichever of the three table layouts the JAX model used:

- per-field tables ``field_{f}`` [V_f, d_f];
- lane-packed tables ``pack_{k}`` [max V, P*d]: fields sorted by descending
  vocab (a stable sort) in groups of P = 128 // d
  (``tfrec_tpu/models/ctr_base.py`` ``enable_lane_packing``); field f is
  ``pack_k[:V_f, slot*d:(slot+1)*d]``;
- one stacked table ``fields`` [sum V_f, d], split at the vocab offsets.

Dense weights keep their layout (MLP weights are ``[in, out]`` in both).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from tfrec_tpu_torch.models.ctr_base import CTRBase


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _tree(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(v) for v in x)
    return _tensor(x)


def _unpack_lanes(tables: Dict[str, Any], model: CTRBase) -> Dict[str, np.ndarray]:
    """Rebuild the reference's grouping: fields sorted by descending vocab,
    P = 128 // d per pack; field f is its slot's d lanes of its pack."""
    vocabs = model.data_spec.field_vocabs
    d = model.field_dims[0]
    if len(set(model.field_dims)) > 1 or 128 % d != 0:
        raise ValueError(f"lane-packed tables need equal field dims dividing 128, got {model.field_dims}")
    p = 128 // d
    order = sorted(range(len(vocabs)), key=lambda f: -vocabs[f])
    groups = [order[i : i + p] for i in range(0, len(order), p)]
    if set(tables) != {f"pack_{k}" for k in range(len(groups))}:
        raise ValueError(f"expected {len(groups)} lane-packed tables, got {sorted(tables)}")
    out = {}
    for k, grp in enumerate(groups):
        pack = np.asarray(tables[f"pack_{k}"])
        for slot, f in enumerate(grp):
            out[f"field_{f}"] = pack[: vocabs[f], slot * d : (slot + 1) * d]
    return out


def _field_tables(tables: Dict[str, Any], model: CTRBase) -> Dict[str, np.ndarray]:
    vocabs = model.data_spec.field_vocabs
    nf = len(vocabs)
    names = set(tables)
    if names == {f"field_{f}" for f in range(nf)}:
        return {f"field_{f}": np.asarray(tables[f"field_{f}"]) for f in range(nf)}
    if names == {"fields"}:
        stacked = np.asarray(tables["fields"])
        out, off = {}, 0
        for f, v in enumerate(vocabs):
            out[f"field_{f}"] = stacked[off : off + v]
            off += v
        return out
    if names and all(n.startswith("pack_") for n in names):
        return _unpack_lanes(tables, model)
    raise ValueError(
        f"unrecognised table layout {sorted(names)} for {nf} fields: expected "
        "per-field field_{f}, lane-packed pack_{k} or stacked 'fields' tables"
    )


def params_from_jax(np_params: Dict[str, Any], model: CTRBase) -> Dict[str, Any]:
    """JAX params tree of numpy arrays -> the port's params (CPU tensors)."""
    tables = _field_tables(np_params["tables"], model)
    for spec in model.table_specs():
        if tables[spec.name].shape != spec.shape:
            raise ValueError(
                f"table {spec.name}: JAX params give {tables[spec.name].shape}, "
                f"the model needs {spec.shape}"
            )
    return {
        "tables": {k: _tensor(np.ascontiguousarray(v)) for k, v in tables.items()},
        "dense": _tree(np_params["dense"]),
    }
