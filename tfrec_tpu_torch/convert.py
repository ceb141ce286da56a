"""Parameters written by the JAX package -> the port's parameters.

``params_from_jax`` takes a JAX params tree whose leaves are numpy arrays
(``{"tables": {...}, "dense": {...}}``, e.g. ``jax.tree.map(np.asarray,
params)``) and returns the same tree of CPU float32 tensors. A retrieval
model's tables (MF: ``user_emb``, ``item_emb``, ``item_bias`` [V, 1]; GMF
and MLP: ``user_emb``, ``item_emb``; NeuMF: ``user_gmf``, ``item_gmf``,
``user_mlp``, ``item_mlp``) are carried by name. A CTR model gets per-field
tables, and FM its per-field linear tables ``lin_{f}`` [V_f, 1] too,
whichever of the three table layouts the JAX model used:

- per-field tables ``field_{f}`` [V_f, d_f] (and ``lin_{f}``);
- lane-packed tables ``pack_{k}`` [max V, P*d]: fields sorted by descending
  vocab (a stable sort) in groups of P = 128 // d
  (``tfrec_tpu/models/ctr_base.py`` ``enable_lane_packing``); field f is
  ``pack_k[:V_f, slot*d:(slot+1)*d]``; the linear tables in the same order
  in groups of 128, one lane a field (``linpack_k[:V_f, slot]``);
- one stacked table ``fields`` [sum V_f, d] (and ``lin`` [sum V_f, 1]),
  split at the vocab offsets.

Dense weights keep their layout (MLP weights are ``[in, out]`` in both).

``train_state_from_jax`` takes a whole JAX train state as numpy (the
``TrainStepBuilder.init_state`` tree after ``jax.tree.map(np.asarray,
...)``) and returns the port's train state, so that a state trained in JAX
carries on training in the port.
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


def _lane_groups(model: CTRBase, per_pack: int):
    """The reference's packing order: fields sorted by descending vocab (a
    stable sort), in groups of ``per_pack``."""
    vocabs = model.data_spec.field_vocabs
    order = sorted(range(len(vocabs)), key=lambda f: -vocabs[f])
    return [order[i : i + per_pack] for i in range(0, len(order), per_pack)]


def _unpack_lanes(tables: Dict[str, Any], model: CTRBase) -> Dict[str, np.ndarray]:
    """Rebuild the reference's grouping: P = 128 // d fields a ``pack_{k}``,
    field f its slot's d lanes; with linear tables, up to 128 fields a
    ``linpack_{k}``, field f its slot's one lane."""
    vocabs = model.data_spec.field_vocabs
    d = model.field_dims[0]
    if len(set(model.field_dims)) > 1 or 128 % d != 0:
        raise ValueError(f"lane-packed tables need equal field dims dividing 128, got {model.field_dims}")
    layouts = [("pack", "field", d, _lane_groups(model, 128 // d))]
    if model.use_linear_tables:
        layouts.append(("linpack", "lin", 1, _lane_groups(model, 128)))
    expected = {f"{pack}_{k}" for pack, _, _, groups in layouts for k in range(len(groups))}
    if set(tables) != expected:
        raise ValueError(f"expected lane-packed tables {sorted(expected)}, got {sorted(tables)}")
    out = {}
    for pack, prefix, width, groups in layouts:
        for k, grp in enumerate(groups):
            packed = np.asarray(tables[f"{pack}_{k}"])
            for slot, f in enumerate(grp):
                out[f"{prefix}_{f}"] = packed[: vocabs[f], slot * width : (slot + 1) * width]
    return out


def _field_tables(tables: Dict[str, Any], model: CTRBase) -> Dict[str, np.ndarray]:
    vocabs = model.data_spec.field_vocabs
    nf = len(vocabs)
    prefixes = ("field", "lin") if model.use_linear_tables else ("field",)
    names = set(tables)
    if names == {f"{p}_{f}" for p in prefixes for f in range(nf)}:
        return {name: np.asarray(tables[name]) for name in names}
    stacked = {"field": "fields", "lin": "lin"}
    if names == {stacked[p] for p in prefixes}:
        out = {}
        for p in prefixes:
            rows, off = np.asarray(tables[stacked[p]]), 0
            for f, v in enumerate(vocabs):
                out[f"{p}_{f}"] = rows[off : off + v]
                off += v
        return out
    if names and all(n.startswith(("pack_", "linpack_")) for n in names):
        return _unpack_lanes(tables, model)
    raise ValueError(
        f"unrecognised table layout {sorted(names)} for {nf} fields: expected "
        "per-field field_{f} (and lin_{f}), lane-packed pack_{k} (and linpack_{k}) "
        "or stacked 'fields' (and 'lin') tables"
    )


def _named_tables(tables: Dict[str, Any], model) -> Dict[str, np.ndarray]:
    names = [spec.name for spec in model.table_specs()]
    if set(tables) != set(names):
        raise ValueError(f"unrecognised table layout {sorted(tables)}: the model has {names}")
    return {name: np.asarray(tables[name]) for name in names}


def params_from_jax(np_params: Dict[str, Any], model) -> Dict[str, Any]:
    """JAX params tree of numpy arrays -> the port's params (CPU tensors)."""
    if isinstance(model, CTRBase):
        tables = _field_tables(np_params["tables"], model)
    else:
        tables = _named_tables(np_params["tables"], model)
    for spec in model.table_specs():
        if tables[spec.name].shape != spec.shape:
            raise ValueError(
                f"table {spec.name}: JAX params give {tables[spec.name].shape}, "
                f"the model needs {spec.shape}"
            )
    return {
        "tables": {spec.name: _tensor(np.ascontiguousarray(tables[spec.name]))
                   for spec in model.table_specs()},
        "dense": _tree(np_params["dense"]),
    }


def _optax_state(tree: Any, field: str):
    """The first optax state in ``tree`` (optax states are NamedTuples,
    nested in tuples by ``optax.chain``) that has ``field``, else None."""
    if hasattr(tree, "_fields"):
        if field in tree._fields:
            return tree
        children = list(tree)
    elif isinstance(tree, (list, tuple)):
        children = list(tree)
    elif isinstance(tree, dict):
        children = list(tree.values())
    else:
        return None
    for child in children:
        found = _optax_state(child, field)
        if found is not None:
            return found
    return None


def train_state_from_jax(np_state: Dict[str, Any], model) -> Dict[str, Any]:
    """A JAX train state of numpy arrays -> the port's train state (CPU
    tensors; ``train.step.copy_state(state, "cuda")`` moves it).

    Reads ``step``, ``tables`` (as ``params_from_jax``), ``dense``, the
    per-table ``sparse_opt`` states (rowwise Adagrad's
    ``acc``, rowwise Adam's ``m``/``v``/``t``, SGD's none) and the optax
    ``dense_opt``: Adam's ``mu``/``nu``/``count``, Adagrad's
    ``sum_of_squares`` and the schedule's ``count``, or SGD's ``count``.
    """
    params = params_from_jax({"tables": np_state["tables"], "dense": np_state["dense"]}, model)
    names = [spec.name for spec in model.table_specs()]
    sparse = np_state["sparse_opt"]
    if set(sparse) != set(names):
        raise NotImplementedError(
            f"sparse optimizer state of tables {sorted(sparse)}: the port reads per-field "
            "state only; lane-packed and stacked state is ROADMAP Queue 1 item 15"
        )
    sparse_opt = {
        name: {k: torch.from_numpy(np.array(v)) for k, v in sparse[name].items()}
        for name in names
    }
    opt = np_state["dense_opt"]
    adam = _optax_state(opt, "mu")
    rss = _optax_state(opt, "sum_of_squares")
    counter = _optax_state(opt, "count")
    if adam is not None:
        dense_opt = {"count": int(adam.count), "mu": _tree(adam.mu), "nu": _tree(adam.nu)}
    elif rss is not None:
        dense_opt = {"count": int(counter.count), "sum_of_squares": _tree(rss.sum_of_squares)}
    elif counter is not None:
        dense_opt = {"count": int(counter.count)}
    else:
        raise ValueError("dense_opt holds no optax state with a count")
    return {
        "step": int(np.asarray(np_state["step"])),
        "tables": params["tables"],
        "dense": params["dense"],
        "sparse_opt": sparse_opt,
        "dense_opt": dense_opt,
    }
