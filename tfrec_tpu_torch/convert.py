"""The JAX package's parameters and train states <-> the port's.

``params_from_jax`` takes a JAX params tree whose leaves are numpy arrays
(``{"tables": {...}, "dense": {...}}``, e.g. ``jax.tree.map(np.asarray,
params)``) and returns the same tree of CPU float32 tensors. A retrieval
model's tables (MF: ``user_emb``, ``item_emb``, ``item_bias`` [V, 1]; GMF
and MLP: ``user_emb``, ``item_emb``; NeuMF: ``user_gmf``, ``item_gmf``,
``user_mlp``, ``item_mlp``; FISM and NAIS: ``item_p``, ``item_q``,
``item_bias``; Mult-VAE: ``enc1``; CDAE: ``enc1``, ``user_node``; SBPR and
APR: MF's; IRGAN: ``user_g``, ``item_g``, ``user_d``, ``item_d``, ``bias_g``,
``bias_d``; Pop: ``item_bias``; ConvNCF: ``user_emb``, ``item_emb``; the
graph models none, their embeddings being dense params) are carried by
name. A CTR model's tables come
in any of the three table layouts (``models/ctr_base.py``), and arrive in
the port model's own: as they are where the two layouts agree, else
through the per-field tables (``CTRBase.split_fields`` / ``join_fields``):

- per-field tables ``field_{f}`` [V_f, d_f] (and FM's ``lin_{f}`` [V_f, 1]);
- lane-packed tables ``pack_{k}`` [max V, P*d]: fields sorted by descending
  vocab (a stable sort) in groups of P = 128 // d; field f is
  ``pack_k[:V_f, slot*d:(slot+1)*d]``; the linear tables in the same order
  in groups of 128, one lane a field (``linpack_k[:V_f, slot]``);
- one stacked table ``fields`` [sum V_f, d] (and ``lin`` [sum V_f, 1]),
  split at the vocab offsets.

Dense weights keep their layout (MLP weights are ``[in, out]`` in both),
except where a model says otherwise: ConvNCF's convolution kernels ``k{l}``
are HWIO in the reference and OIHW in the port, moved by the model's
``dense_from_jax`` / ``dense_to_jax`` on the way in and out (the dense
optimizer's moments with them). The closed-form models' solved tables
(WRMF's ``user_emb``/``item_emb``, EASE's ``ease_bt``/``ease_x``) are
carried by name; their states are ``{"step", "tables", "dense": {}}``, with
no optimizer state, as the reference saves them.

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

A sharded state (``parallel/step.ShardedTrainStepBuilder``) holds on each
rank its block of every table and of its optimizer state: rows of a
row-sharded table, columns of a column-sharded one. ``shard_state`` turns a
global (unpadded, logical) train state, the port's or one read from JAX by
``train_state_from_jax``, into a rank's blocks (padded and permuted rows,
or columns); the plan's ``unshard`` (a collective) gives a leaf back whole.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from tfrec_tpu_torch.models.ctr_base import CTRBase
from tfrec_tpu_torch.train.step import tree_map


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _tree(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(v) for v in x)
    return _tensor(x)


def _source_layout(tables: Dict[str, Any], model: CTRBase) -> str:
    """Which of the three layouts ``tables`` (by their names) is in."""
    names = set(tables)
    for layout in ("field", "stack"):
        if names == set(model.layout_blocks(layout)):
            return layout
    if names and all(n.startswith(("pack_", "linpack_")) for n in names):
        try:
            expected = set(model.layout_blocks("pack"))
        except ValueError as e:
            raise ValueError(f"lane-packed tables {sorted(names)} for this model: {e}") from None
        if names == expected:
            return "pack"
        raise ValueError(f"expected lane-packed tables {sorted(expected)}, got {sorted(names)}")
    raise ValueError(
        f"unrecognised table layout {sorted(names)} for {model.num_fields} fields: expected "
        "per-field field_{f} (and lin_{f}), lane-packed pack_{k} (and linpack_{k}) "
        "or stacked 'fields' (and 'lin') tables"
    )


def _ctr_tables(tables: Dict[str, Any], model: CTRBase) -> Dict[str, torch.Tensor]:
    """A CTR model's tables from any layout into the model's."""
    src = _source_layout(tables, model)
    tensors = {name: _tensor(t) for name, t in tables.items()}
    if src == model.layout:
        return tensors
    zeros = {s.name: torch.zeros(s.shape) for s in model.table_specs()}
    return model.join_fields(model.split_fields(tensors, layout=src), zeros)


def _table_names(model) -> list:
    """The model's table names: its specs', or a closed-form model's solved
    tables (``solved_tables``)."""
    solved = getattr(model, "solved_tables", None)
    return list(solved()) if solved is not None else [spec.name for spec in model.table_specs()]


def _dense_in(model, tree):
    """A dense tree of numpy arrays in the reference's layout -> the
    model's own (ConvNCF's kernels)."""
    fn = getattr(model, "dense_from_jax", None)
    return tree if fn is None else fn(tree)


def _dense_out(model, tree):
    """A dense tree of numpy arrays in the model's layout -> the
    reference's."""
    fn = getattr(model, "dense_to_jax", None)
    return tree if fn is None else fn(tree)


def _named_tables(tables: Dict[str, Any], model) -> Dict[str, np.ndarray]:
    names = _table_names(model)
    if set(tables) != set(names):
        raise ValueError(f"unrecognised table layout {sorted(tables)}: the model has {names}")
    return {name: np.asarray(tables[name]) for name in names}


def params_from_jax(np_params: Dict[str, Any], model) -> Dict[str, Any]:
    """JAX params tree of numpy arrays -> the port's params (CPU tensors)."""
    if isinstance(model, CTRBase):
        tables = _ctr_tables(np_params["tables"], model)
    else:
        tables = {k: _tensor(v) for k, v in _named_tables(np_params["tables"], model).items()}
    for spec in model.table_specs():
        if tuple(tables[spec.name].shape) != spec.shape:
            raise ValueError(
                f"table {spec.name}: JAX params give {tuple(tables[spec.name].shape)}, "
                f"the model needs {spec.shape}"
            )
    return {
        "tables": {name: tables[name].contiguous() for name in _table_names(model)},
        "dense": _tree(_dense_in(model, np_params["dense"])),
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
    """The per-table sparse optimizer states, ``{table: {"acc": ...}}``,
    of the model's own tables (a lane-packed or stacked layout's too)."""
    names = [spec.name for spec in model.table_specs()]
    if set(sparse) != set(names):
        raise ValueError(
            f"sparse optimizer state of tables {sorted(sparse)}, but the model has {names}: the "
            "state is in another table layout; build the model in the saved one "
            "(model.lane_pack / model.stack_tables)"
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
    ``sum_of_squares`` and the schedule's ``count``, or SGD's ``count``. A
    closed-form model's state is its step and solved tables.
    """
    params = params_from_jax({"tables": np_state["tables"], "dense": np_state["dense"]}, model)
    if "dense_opt" not in np_state:
        return {"step": int(np.asarray(np_state["step"])), "tables": params["tables"], "dense": {}}
    sparse_opt = _sparse_opt(np_state["sparse_opt"], model)
    opt = np_state["dense_opt"]
    adam = _optax_state(opt, "mu")
    rss = _optax_state(opt, "sum_of_squares")
    counter = _optax_state(opt, "count")
    if adam is not None:
        dense_opt = {"count": int(adam.count), "mu": _tree(_dense_in(model, adam.mu)),
                     "nu": _tree(_dense_in(model, adam.nu))}
    elif rss is not None:
        dense_opt = {"count": int(counter.count),
                     "sum_of_squares": _tree(_dense_in(model, rss.sum_of_squares))}
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


def _unflat_np(template: Any, flat: Mapping[str, np.ndarray], prefix: str) -> Any:
    """The tree of ``template``'s structure read from ``flat`` (numpy)."""
    if isinstance(template, dict):
        return {k: _unflat_np(v, flat, f"{prefix}/{k}") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflat_np(v, flat, f"{prefix}/{i}") for i, v in enumerate(template))
    return flat[prefix]


def _dense_opt_prefix(weight_decay: float) -> str:
    return "dense_opt/1/" if weight_decay > 0 else "dense_opt/"


def flat_from_state(state: Dict[str, Any], dense_optimizer: str, weight_decay: float = 0.0,
                    leaf: Callable = _to_numpy, model=None) -> Dict[str, np.ndarray]:
    """The port's train state as the flat keys and dtypes the JAX package
    saves for the same model and optimizer (``dense_optimizer`` and
    ``weight_decay`` of ``OptimConfig``). ``leaf`` maps each tensor (by
    default to a numpy copy on the host); ``model`` gives the dense trees
    the reference's layout where the two differ (ConvNCF). A closed-form
    state (no optimizer state) is its step and tables."""
    out: Dict[str, np.ndarray] = {"step": np.asarray(state["step"], np.int32)}
    _flat_tree("tables", state["tables"], out, leaf)

    def dense_tree(prefix: str, tree) -> None:
        _flat_tree(prefix, _dense_out(model, tree_map(leaf, tree)), out, lambda a: a)

    dense_tree("dense", state["dense"])
    if "dense_opt" not in state:
        return out
    count = np.asarray(state["dense_opt"]["count"], np.int32)
    _flat_tree("sparse_opt", state["sparse_opt"], out, leaf)
    p = _dense_opt_prefix(weight_decay)
    if dense_optimizer == "adam":
        out[f"{p}0/.count"] = count
        dense_tree(f"{p}0/.mu", state["dense_opt"]["mu"])
        dense_tree(f"{p}0/.nu", state["dense_opt"]["nu"])
    elif dense_optimizer == "adagrad":
        dense_tree(f"{p}0/.sum_of_squares", state["dense_opt"]["sum_of_squares"])
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
                            "dense": _unflat_np(dense_template, flat, "dense")}, model)


def train_state_from_flat(flat: Mapping[str, np.ndarray], model, template: Dict[str, Any]
                          ) -> Dict[str, Any]:
    """A checkpoint's train state (the port's or the JAX package's flat
    keys) as the port's train state of CPU tensors. ``template`` (a state
    of the same model and optimizer, e.g. ``TrainStepBuilder.init_state``)
    gives the dense trees their structure, and its ``dense_opt`` names the
    dense optimizer's leaves: Adam's ``mu``/``nu`` and its ``count``,
    Adagrad's ``sum_of_squares`` and the schedule's ``count``, or SGD's
    ``count`` (``flat_from_state``'s keys, with or without weight decay).
    The sparse state is read in the model's table layout."""
    params = params_from_flat(flat, model, template["dense"])
    if "dense_opt" not in template:  # a closed-form state
        return {"step": int(np.asarray(flat["step"])), "tables": params["tables"], "dense": {}}
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
            dense_opt[leaf] = _tree(_dense_in(model, _unflat_np(opt_t[leaf], flat, f"{p}0/.{leaf}")))
    return {
        "step": int(np.asarray(flat["step"])),
        "tables": params["tables"],
        "dense": params["dense"],
        "sparse_opt": _sparse_opt(sparse, model),
        "dense_opt": dense_opt,
    }


# ---- row-sharded states ----


def shard_state(state: Dict[str, Any], mesh, plans) -> Dict[str, Any]:
    """A global logical train state -> this rank's state on
    ``mesh.device``: each sharded table (``plans[name]`` a
    ``RowShardedTable`` or ``ColShardedTable``; None replicates) and its
    optimizer state cut to the rank's block by the plan (``plan.shard``:
    rows padded with zero rows, permuted and cut, or columns cut, a rowwise
    leaf of a col table replicated); the rest copied."""
    device = mesh.device

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(move(v) for v in tree)
        return tree.to(device, copy=True) if isinstance(tree, torch.Tensor) else tree

    tables, sparse = {}, {}
    for name, table in state["tables"].items():
        plan = plans.get(name)
        if plan is None:
            tables[name], sparse[name] = move(table), move(state["sparse_opt"][name])
            continue
        tables[name] = plan.shard(table.to(device))
        sparse[name] = {k: plan.shard(v.to(device)) for k, v in state["sparse_opt"][name].items()}
    return {"step": move(state["step"]), "tables": tables, "dense": move(state["dense"]),
            "sparse_opt": sparse, "dense_opt": move(state["dense_opt"])}
