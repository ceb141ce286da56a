"""The JAX package's parameters and train states <-> the port's.

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

Checkpoints (``utils/checkpoint.py``) hold a state as flat keys, the JAX
package's pytree path strings. ``flat_from_state`` writes the port's state
under the keys JAX saves for the same model and optimizer;
``train_state_from_flat`` and ``params_from_flat`` read them back, from the
port or from JAX, by ``params_from_jax``'s table layouts and
``train_state_from_jax``'s optimizer-state rules.

The dense optimizer's keys follow ``make_dense_tx``
(tfrec_tpu/train/step.py:127-142): an optax chain of the optimizer and the
learning-rate schedule's ``ScaleByScheduleState``, itself after
``add_decayed_weights`` (an empty state) when ``weight_decay > 0``. So
under ``P = "dense_opt/"``, or ``"dense_opt/1/"`` with weight decay:

- Adam: ``P0/.count``, ``P0/.mu/<dense path>``, ``P0/.nu/<dense path>`` and
  ``P1/.count``;
- Adagrad: ``P0/.sum_of_squares/<dense path>`` and ``P1/.count``;
- SGD: ``P1/.count``.

Every ``.count`` is an int32 scalar holding the port's one update count.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

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


def _sparse_opt(sparse: Mapping[str, Mapping[str, Any]], model) -> Dict[str, Dict[str, torch.Tensor]]:
    """The per-table sparse optimizer states, ``{table: {"acc": ...}}``;
    lane-packed and stacked state is refused."""
    names = [spec.name for spec in model.table_specs()]
    if set(sparse) != set(names):
        raise NotImplementedError(
            f"sparse optimizer state of tables {sorted(sparse)}: the port reads per-field "
            "state only; lane-packed and stacked state is ROADMAP Queue 1 item 15"
        )
    return {name: {k: torch.from_numpy(np.array(v)) for k, v in sparse[name].items()}
            for name in names}


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
    sparse_opt = _sparse_opt(np_state["sparse_opt"], model)
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


# ---- flat checkpoint keys ----


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _flat_tree(prefix: str, tree: Any, out: Dict[str, np.ndarray], leaf: Callable) -> None:
    """``leaf`` of each tensor of nested dicts, lists and tuples, under its
    path key."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat_tree(f"{prefix}/{k}", v, out, leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat_tree(f"{prefix}/{i}", v, out, leaf)
    else:
        out[prefix] = leaf(tree)


def _unflat_like(template: Any, flat: Mapping[str, np.ndarray], prefix: str) -> Any:
    """The tree of ``template``'s structure read from ``flat`` (CPU float32
    tensors)."""
    if isinstance(template, dict):
        return {k: _unflat_like(v, flat, f"{prefix}/{k}") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflat_like(v, flat, f"{prefix}/{i}") for i, v in enumerate(template))
    return _tensor(flat[prefix])


def _dense_opt_prefix(weight_decay: float) -> str:
    return "dense_opt/1/" if weight_decay > 0 else "dense_opt/"


def flat_from_state(state: Dict[str, Any], dense_optimizer: str, weight_decay: float = 0.0,
                    leaf: Callable = _to_numpy) -> Dict[str, np.ndarray]:
    """The port's train state as the flat keys and dtypes the JAX package
    saves for the same model and optimizer (``dense_optimizer`` and
    ``weight_decay`` of ``OptimConfig``). ``leaf`` maps each tensor (by
    default to a numpy copy on the host)."""
    count = np.asarray(state["dense_opt"]["count"], np.int32)
    out: Dict[str, np.ndarray] = {"step": np.asarray(state["step"], np.int32)}
    _flat_tree("tables", state["tables"], out, leaf)
    _flat_tree("dense", state["dense"], out, leaf)
    _flat_tree("sparse_opt", state["sparse_opt"], out, leaf)
    p = _dense_opt_prefix(weight_decay)
    if dense_optimizer == "adam":
        out[f"{p}0/.count"] = count
        _flat_tree(f"{p}0/.mu", state["dense_opt"]["mu"], out, leaf)
        _flat_tree(f"{p}0/.nu", state["dense_opt"]["nu"], out, leaf)
    elif dense_optimizer == "adagrad":
        _flat_tree(f"{p}0/.sum_of_squares", state["dense_opt"]["sum_of_squares"], out, leaf)
    elif dense_optimizer != "sgd":
        raise ValueError(f"unknown dense optimizer {dense_optimizer!r}")
    out[f"{p}1/.count"] = count
    return out


def _tables_from_flat(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k[len("tables/"):]: v for k, v in flat.items() if k.startswith("tables/")}


def params_from_flat(flat: Mapping[str, np.ndarray], model, dense_template: Any) -> Dict[str, Any]:
    """A checkpoint's params (any of ``params_from_jax``'s table layouts)
    as the port's params; the dense tree takes ``dense_template``'s
    structure (the model's own ``init``)."""
    return params_from_jax({"tables": _tables_from_flat(flat),
                            "dense": _unflat_like(dense_template, flat, "dense")}, model)


def train_state_from_flat(flat: Mapping[str, np.ndarray], model, template: Dict[str, Any]
                          ) -> Dict[str, Any]:
    """A checkpoint's train state (the port's or the JAX package's flat
    keys) as the port's train state of CPU tensors. ``template`` (a state
    of the same model and optimizer, e.g. ``TrainStepBuilder.init_state``)
    gives the dense trees their structure, and its ``dense_opt`` names the
    dense optimizer's leaves: Adam's ``mu``/``nu`` and its ``count``,
    Adagrad's ``sum_of_squares`` and the schedule's ``count``, or SGD's
    ``count`` (``flat_from_state``'s keys, with or without weight decay).
    Only per-table sparse state is read (item 15)."""
    params = params_from_flat(flat, model, template["dense"])
    sparse: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in flat.items():
        if key.startswith("sparse_opt/"):
            table, leaf = key[len("sparse_opt/"):].rsplit("/", 1)
            sparse.setdefault(table, {})[leaf] = v
    sparse_names = {n for n in template["sparse_opt"]} | set(sparse)
    for name in sparse_names - set(sparse):
        sparse[name] = {}  # a stateless sparse optimizer (sgd) saves no leaf
    opt_t = template["dense_opt"]
    # Weight decay puts the chain one level down (``dense_opt/1/...``).
    p = _dense_opt_prefix(1.0 if "dense_opt/1/1/.count" in flat else 0.0)
    count_key = f"{p}0/.count" if "mu" in opt_t else f"{p}1/.count"
    if count_key not in flat:
        raise ValueError(f"dense_opt holds no optax count at {count_key!r}")
    dense_opt = {"count": int(flat[count_key])}
    for leaf in ("mu", "nu", "sum_of_squares"):
        if leaf in opt_t:  # the template's own optimizer, even over an empty dense tree
            dense_opt[leaf] = _unflat_like(opt_t[leaf], flat, f"{p}0/.{leaf}")
    return {
        "step": int(np.asarray(flat["step"])),
        "tables": params["tables"],
        "dense": params["dense"],
        "sparse_opt": _sparse_opt(sparse, model),
        "dense_opt": dense_opt,
    }
