"""The train step: the counterpart of ``tfrec_tpu/train/step.py``.

One step, on the builder's device::

    lookup ids -> gather rows (every table in one launch) -> gradients with
    respect to (dense params, gathered rows) -> dense update (optax's
    rules) -> the duplicate-id combine -> the rowwise sparse update of the
    touched rows of every table (one launch for rowwise Adagrad).

As in the reference, autograd stops at the gathered rows: the tables are
never differentiated, so no [V, D] gradient is ever written, and the sparse
optimizer updates only the rows the batch touched. On a card the gather,
the DCN cross stack (v1 or v2 low-rank, forward and backward) and the
rowwise-Adagrad update are the hand-written CUDA kernels; the rest is plain
PyTorch.

State is a dict ``{"step": int, "tables", "dense", "sparse_opt",
"dense_opt"}``. The step updates the tables and the sparse optimizer state
IN PLACE (as the TPU kernel aliases them) and returns them in the new
state; the dense params and their optimizer state are new tensors.
``copy_state`` makes an independent copy, on any device.

With ``device_negatives`` (bpr and hinge only), a batch of (user, pos)
rows gets its "neg" column drawn uniformly from [0, num_items) on the
device each step, from a generator seeded by (seed, step), with no
train-positive exclusion (the reference's large-catalog approximation).
Its numbers differ from JAX's for the same seed, as every generator does.

The duplicate combine runs over each group of same-shaped tables at once,
one batched sort (``combine_duplicate_ids_grouped``), and per table for a
table alone in its shape, or where a batch carries ``_sort_<table>`` keys
(train.host_dedup, ``host_dedup_sorts``) from the host's stable argsorts.
Both are bit for bit the per-table combine of the reference's default.
Sentinel ids (a history's padding, ``vocab``) are gathered clamped to the
last row, count in the ``l2_reg`` term as the reference's do, and land in
the combine's sentinel tail, which no update touches. A model with no
tables (the graph models) looks nothing up and updates no table.
Lane-packed tables (``TableSpec.lane_groups`` > 1) keep [V, G] optimizer
state: grouped Adagrad goes to the same kernel launch as the others, and
grouped rowwise Adam through the per-table seam with each id's lane group.

While a profiler records, each step opens the spans ``tfrec.step`` and,
inside it in this order, ``tfrec.lookup``, ``tfrec.forward``,
``tfrec.backward``, ``tfrec.dense_update``, ``tfrec.combine`` and
``tfrec.sparse_update`` (``utils/profile.span``); the per-table seams do
their own combine inside ``tfrec.sparse_update``.
"""

from __future__ import annotations

import dataclasses
import math
from concurrent.futures import Executor
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from tfrec_tpu_torch.configs import OptimConfig
from tfrec_tpu_torch.models.base import RecModel
from tfrec_tpu_torch.ops.embedding import (
    combine_duplicate_ids,
    combine_duplicate_ids_grouped,
    gather_many,
)
from tfrec_tpu_torch.ops.sparse_optim import SparseOptimizer, make_sparse_optimizer
from tfrec_tpu_torch.train.losses import make_loss
from tfrec_tpu_torch.utils.profile import span

State = Dict[str, Any]


def host_dedup_sorts(model: RecModel, host_batch: Dict[str, np.ndarray],
                     pool: Executor | None = None) -> Dict[str, np.ndarray]:
    """The stable argsort of each table's ids for this host batch (numpy),
    as ``{"_sort_<table>": [N] int32}`` keys to merge into it
    (train.host_dedup): the step's duplicate combine then takes them in
    place of its device sort, bit for bit the same. Each sorts the key ``id
    * N + position`` (negative ids ranked at the table's sentinel, as the
    combine ranks them) with numpy's quicksort, the stable permutation
    without the stable kind's cost; with a ``pool``, one task a table."""
    ids = model.lookup_ids({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in host_batch.items()})
    vocabs = {spec.name: spec.vocab for spec in model.table_specs()}

    def one(v: np.ndarray, sentinel: int) -> np.ndarray:
        v = np.where(v < 0, sentinel, v)
        key = v.astype(np.int64) * len(v) + np.arange(len(v), dtype=np.int64)
        return np.argsort(key, kind="quicksort").astype(np.int32)

    if pool is None or len(ids) == 1:
        return {f"_sort_{k}": one(v.numpy(), vocabs[k]) for k, v in ids.items()}
    futures = {k: pool.submit(one, v.numpy(), vocabs[k]) for k, v in ids.items()}
    return {f"_sort_{k}": f.result() for k, f in futures.items()}


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples (the dense
    params' layout), with matching trees in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves in ``tree_map``'s order (dict insertion order)."""
    out: list = []
    tree_map(out.append, tree)
    return out


def batch_size_of(logits) -> int:
    """The batch size of a forward's output: its leading dim, or for a dict
    output (the sequential models' {"pos", "neg", "mask"}) that of the
    leaf under the first sorted key, as the reference reads its first
    pytree leaf."""
    if isinstance(logits, dict):
        return batch_size_of(logits[sorted(logits)[0]])
    return logits.shape[0]


def _unflatten(template: Any, leaves) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def copy_state(state: State, device: torch.device | str | None = None) -> State:
    """An independent copy of a train state (every tensor cloned), on
    ``device`` if one is given."""

    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
        return x.clone() if device is None else x.to(device, copy=True)

    return tree_map(copy, state)


def make_schedule(cfg: OptimConfig, base_lr: float) -> Callable[[int], float]:
    """Step -> lr, shared by the dense and the sparse updates. Computed on
    the host in Python floats (the reference traces it in f32): the sparse
    kernel takes its lr by value."""
    if cfg.lr_schedule == "constant" and cfg.warmup_steps == 0:
        return lambda step: base_lr
    if cfg.lr_schedule not in ("constant", "cosine", "linear"):
        raise ValueError(
            f"unknown lr_schedule {cfg.lr_schedule!r}; options: constant, cosine, linear"
        )
    if cfg.lr_schedule in ("cosine", "linear") and cfg.decay_steps <= 0:
        raise ValueError(
            f"lr_schedule={cfg.lr_schedule!r} requires decay_steps > 0 "
            "(with decay_steps=0 the LR would collapse to the floor after one step)"
        )
    end = base_lr * cfg.end_lr_factor
    decay_steps = max(cfg.decay_steps, 1)

    def schedule(step: int) -> float:
        step = float(step)
        warm = min(1.0, (step + 1.0) / max(cfg.warmup_steps, 1))
        if cfg.lr_schedule == "cosine":
            frac = min(max(step / decay_steps, 0.0), 1.0)
            decayed = end + 0.5 * (base_lr - end) * (1 + math.cos(math.pi * frac))
        elif cfg.lr_schedule == "linear":
            frac = min(max(step / decay_steps, 0.0), 1.0)
            decayed = base_lr + (end - base_lr) * frac
        else:  # constant, after warmup
            decayed = base_lr
        return decayed * (warm if cfg.warmup_steps > 0 else 1.0)

    return schedule


@dataclasses.dataclass(frozen=True)
class DenseTx:
    """A dense optimizer with optax's interface: ``init(params) -> state``,
    ``update(grads, state, params) -> (updates, state)``; the new params are
    ``apply_updates(params, updates)``."""

    init: Callable[[Any], Dict]
    update: Callable[[Any, Dict, Any], Tuple[Any, Dict]]


def _bias_correction(decay: float, count: int) -> float:
    # 1 - decay**count in f32, as optax computes it.
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def make_dense_tx(cfg: OptimConfig) -> DenseTx:
    """Adam, Adagrad or SGD written to optax's update rules (optax 0.2.6
    ``adam``, ``adagrad``, ``sgd``, chained after ``add_decayed_weights``
    when ``weight_decay > 0``), not ``torch.optim``'s: ``torch.optim.Adagrad``
    divides by sqrt(acc) + eps where optax multiplies by rsqrt(acc + eps)
    and gives 0 where acc == 0. The lr schedule reads the update count
    before it is incremented, Adam's bias correction after."""
    lr = make_schedule(cfg, cfg.learning_rate)
    name = cfg.dense_optimizer
    if name not in ("adam", "adagrad", "sgd"):
        raise ValueError(f"unknown dense optimizer {name!r}")
    b1, b2, eps, wd = cfg.adam_b1, cfg.adam_b2, cfg.eps, cfg.weight_decay
    adagrad_eps = max(cfg.eps, 1e-10)

    def init(params):
        state: Dict[str, Any] = {"count": 0}
        if name == "adam":
            state["mu"] = tree_map(torch.zeros_like, params)
            state["nu"] = tree_map(torch.zeros_like, params)
        elif name == "adagrad":
            state["sum_of_squares"] = tree_map(
                lambda p: torch.full_like(p, cfg.adagrad_init), params)
        return state

    def update(grads, state, params):
        if wd > 0:
            grads = tree_map(lambda g, p: g + wd * p, grads, params)
        count = state["count"]
        step_size = -lr(count)
        new = {"count": count + 1}
        if name == "adam":
            new["mu"] = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
            new["nu"] = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
            bc1, bc2 = _bias_correction(b1, count + 1), _bias_correction(b2, count + 1)
            updates = tree_map(
                lambda m, v: (m / bc1) / ((v / bc2).sqrt() + eps) * step_size,
                new["mu"], new["nu"])
        elif name == "adagrad":
            new["sum_of_squares"] = tree_map(lambda g, t: g * g + t, grads,
                                             state["sum_of_squares"])
            updates = tree_map(
                lambda g, t: torch.where(t > 0, torch.rsqrt(t + adagrad_eps), 0.0) * g * step_size,
                grads, new["sum_of_squares"])
        else:
            updates = tree_map(lambda g: g * step_size, grads)
        return updates, new

    return DenseTx(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


class TrainStepBuilder:
    """The step for a (model, loss, optimizers) triple on one device.

    ``lookup``, ``sparse_update``, ``sparse_update_deduped``,
    ``sparse_update_deduped_all`` and ``sparse_update_all`` are the seams
    where a sharded embedding subsystem plugs in, as in the reference. The
    default device is the card: without CUDA this raises rather than train
    on the CPU; pass ``device="cpu"`` for that (the kernels' plain
    versions).
    """

    def __init__(
        self,
        model: RecModel,
        loss_name: str,
        optim_cfg: OptimConfig,
        *,
        l2_reg: float = 0.0,
        seed: int = 0,
        device: torch.device | str = "cuda",
        device_negatives: bool = False,
        num_items: int = 0,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TrainStepBuilder trains on device='cuda' by default, but CUDA is "
                "not available; pass device='cpu' to train on the CPU"
            )
        if device_negatives and loss_name not in ("bpr", "hinge"):
            raise ValueError(
                "device_negatives supports single-negative pairwise losses "
                f"(bpr/hinge), not {loss_name!r}"
            )
        self.device_negatives = device_negatives
        self.num_items = num_items
        self.model = model
        self.loss_fn = make_loss(loss_name)
        self.optim_cfg = optim_cfg
        self.l2_reg = l2_reg
        self.seed = seed
        self.dense_tx = make_dense_tx(optim_cfg)
        self.sparse_opt: SparseOptimizer = make_sparse_optimizer(
            optim_cfg.sparse_optimizer,
            adagrad_init=optim_cfg.adagrad_init,
            adam_b1=optim_cfg.adam_b1,
            adam_b2=optim_cfg.adam_b2,
            eps=optim_cfg.eps,
        )
        self.sparse_lr = (
            optim_cfg.sparse_learning_rate
            if optim_cfg.sparse_learning_rate is not None
            else optim_cfg.learning_rate
        )
        self.sparse_schedule = make_schedule(optim_cfg, self.sparse_lr)
        self._groups = {s.name: s.lane_groups for s in model.table_specs()}
        self._sentinels_on_device: Dict[tuple, torch.Tensor] = {}

    def init_state(self, generator: torch.Generator) -> State:
        """A fresh state, params drawn from ``generator`` (on this device);
        a lane-packed table's optimizer state per lane group."""
        params = self.model.init(generator, self.device)
        return {
            "step": 0,
            "tables": params["tables"],
            "dense": params["dense"],
            "sparse_opt": {name: self.sparse_opt.init(t, lane_groups=self._groups.get(name, 1))
                           for name, t in params["tables"].items()},
            "dense_opt": self.dense_tx.init(params["dense"]),
        }

    def _grouped_adam(self, name: str) -> bool:
        """A lane-packed table under rowwise Adam: its update needs each
        id's lane group, so it goes through ``sparse_update`` with them."""
        return self._groups.get(name, 1) > 1 and self.sparse_opt.name == "rowwise_adam"

    def _slots_for(self, name: str, n_ids: int) -> torch.Tensor | None:
        """Each position's lane group in a lane-packed table's id vector
        (a CTR model's), [n_ids] int64 on this device; None for other
        tables."""
        widths = self.model.lane_slot_widths(name)
        if widths is None:
            return None
        b, rem = divmod(n_ids, sum(widths))
        if rem:
            raise ValueError(f"{name}: {n_ids} ids are not a batch of bags of widths {widths}")
        return torch.repeat_interleave(torch.arange(len(widths), device=self.device),
                                       torch.tensor([w * b for w in widths], device=self.device))

    def dense_params(self, state: State):
        """The dense params as the model reads them (the sharded builder
        gathers its FSDP blocks)."""
        return state["dense"]

    def logical_dense(self, state: State) -> State:
        """``state`` with whole dense params and optimizer moments (the
        sharded builder gathers its FSDP blocks)."""
        return state

    # ---- seams a sharded subsystem overrides ----

    def lookup(self, tables: Dict[str, torch.Tensor], ids: Dict[str, torch.Tensor]):
        """(gathered rows per table, aux metrics): the local gather, every
        table in one launch (the counterpart of the reference's
        ``pallas_lookup``); the rows of all tables share one allocation. A
        model with no tables (the graph models) launches nothing."""
        if not ids:
            return {}, {}
        rows = gather_many([tables[name] for name in ids], list(ids.values()))
        return dict(zip(ids, rows)), {}

    def sparse_update(self, name: str, table, opt_state, ids, grads, lr, order=None):
        """One table's duplicate combine and sparse update -> (table, state).
        ``order``: the host's stable argsort of ``ids`` (train.host_dedup),
        which the combine then takes in place of its sort. A lane-packed
        table under rowwise Adam takes its ids' lane groups instead (its
        combine carries a touch channel)."""
        if self._grouped_adam(name):
            return self.sparse_opt.apply(table, opt_state, ids, grads, lr,
                                         slots=self._slots_for(name, ids.shape[0]))
        uids, g = combine_duplicate_ids(ids, grads, sentinel=table.shape[0], order=order)
        return self.sparse_update_deduped(name, table, opt_state, uids, g, lr)

    def sparse_update_deduped(self, name: str, table, opt_state, uids, g, lr):
        """The update after the combine; for rowwise Adagrad the fused kernel."""
        return self.sparse_opt.apply_deduped(table, opt_state, uids, g, lr)

    def sparse_update_deduped_all(self, tables, opt_states, uids, grads, lr):
        """The update after the combine for every table at once (dicts by
        table name) -> (tables, states); for rowwise Adagrad one launch of
        the fused kernel. The reference's grouped path calls
        ``sparse_update_deduped`` per member of a group here."""
        names = list(uids)
        new_tables, new_states = self.sparse_opt.apply_deduped_many(
            [tables[n] for n in names], [opt_states[n] for n in names],
            [uids[n] for n in names], [grads[n] for n in names], lr)
        return dict(zip(names, new_tables)), dict(zip(names, new_states))

    def _sentinels(self, tables: Dict[str, torch.Tensor], members: Sequence[str]) -> torch.Tensor:
        """The [F, 1] pad ids (each table's vocab) of a group of tables for
        ``combine_duplicate_ids_grouped``, made once on their device: a
        tensor made from a list each step would copy from the host, and wait."""
        vocabs = tuple(tables[n].shape[0] for n in members)
        device = tables[members[0]].device
        key = (vocabs, device)
        if key not in self._sentinels_on_device:
            self._sentinels_on_device[key] = torch.tensor(vocabs, device=device)[:, None]
        return self._sentinels_on_device[key]

    def _per_table_seams(self) -> bool:
        """True where ``sparse_update`` or ``sparse_update_deduped`` is
        overridden (by a subclass or on the instance): the update then goes
        through them table by table."""
        return any(getattr(getattr(self, seam), "__func__", None) is not getattr(TrainStepBuilder, seam)
                   for seam in ("sparse_update", "sparse_update_deduped"))

    def sparse_update_all(self, state: State, ids, gathered_grad, lr, host_sort=None):
        """The sparse update of every table: the duplicate combine (one
        batched sort over each group of same-shaped tables; per table for a
        table alone in its shape or with the host's sort in ``host_sort``),
        then ``sparse_update_deduped_all`` over all of them. Through
        ``sparse_update`` table by table instead: a lane-packed table under
        rowwise Adam, a table whose ids are not [N], and every table where
        the per-table seams are overridden."""
        new_tables = dict(state["tables"])
        new_sparse = dict(state["sparse_opt"])
        host_sort = host_sort or {}

        def per_table(name):
            new_tables[name], new_sparse[name] = self.sparse_update(
                name, state["tables"][name], state["sparse_opt"][name],
                ids[name], gathered_grad[name], lr, order=host_sort.get(name))

        if self._per_table_seams():
            with span("tfrec.sparse_update"):
                for name in gathered_grad:
                    per_table(name)
            return new_tables, new_sparse
        uids, grads, groups, alone = {}, {}, {}, []
        with span("tfrec.combine"):
            for name in gathered_grad:
                if ids[name].dim() != 1 or self._grouped_adam(name):
                    alone.append(name)
                    continue
                key = ((tuple(ids[name].shape), ids[name].dtype, tuple(gathered_grad[name].shape))
                       if name not in host_sort else name)
                groups.setdefault(key, []).append(name)
            for members in groups.values():
                if len(members) == 1:
                    name = members[0]
                    uids[name], grads[name] = combine_duplicate_ids(
                        ids[name], gathered_grad[name], sentinel=state["tables"][name].shape[0],
                        order=host_sort.get(name))
                    continue
                u, c = combine_duplicate_ids_grouped(
                    torch.stack([ids[n] for n in members]),
                    torch.stack([gathered_grad[n] for n in members]),
                    self._sentinels(state["tables"], members))
                uids.update(zip(members, u))
                grads.update(zip(members, c))
        with span("tfrec.sparse_update"):
            for name in alone:  # through the per-table seam, its own combine
                per_table(name)
            if uids:
                names = [n for n in gathered_grad if n in uids]  # the tables' order
                tables, states = self.sparse_update_deduped_all(
                    state["tables"], state["sparse_opt"], {n: uids[n] for n in names},
                    {n: grads[n] for n in names}, lr)
                new_tables.update(tables)
                new_sparse.update(states)
        return new_tables, new_sparse

    def _generator(self, step: int) -> torch.Generator | None:
        """The step's generator (from the seed and the step, as the
        reference folds the step into its rng), for the device negatives
        and then the model's noise; None where the step draws neither."""
        if not self.model.draws_noise() and not self.device_negatives:
            return None
        return torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + step) % (1 << 63))

    def _draw_negatives(self, batch: Dict[str, torch.Tensor], generator) -> Dict[str, torch.Tensor]:
        """With device_negatives, a batch of (user, pos) rows gains "neg",
        uniform int32 in [0, num_items); other batches pass unchanged."""
        if not self.device_negatives or "pos" not in batch or "neg" in batch or "negs" in batch:
            return batch
        pos = batch["pos"]
        neg = torch.randint(0, self.num_items, pos.shape, generator=generator,
                            dtype=torch.int32, device=pos.device)
        return {**batch, "neg": neg}

    def loss_and_grads(self, state: State, batch: Dict[str, torch.Tensor],
                       generator: torch.Generator | None = None):
        """(loss, dense grads, gathered-row grads per table, ids per table)
        of one batch. Autograd runs from the dense leaves and the gathered
        rows, never from the tables. ``generator`` (dropout) defaults to
        the step's own."""
        if generator is None:
            generator = self._generator(state["step"])
        with span("tfrec.lookup"):
            ids = self.model.lookup_ids(batch)
            gathered, _ = self.lookup(state["tables"], ids)
        return (*self.grads_at(state, batch, gathered, generator), ids)

    def grads_at(self, state: State, batch, gathered, generator, forward_kw=None):
        """(loss, dense grads, gathered-row grads per table) of ``batch`` at
        its gathered rows; ``forward_kw`` goes to the model's forward (the
        sharded step's IRGAN noise)."""
        dense = tree_map(lambda p: p.detach().requires_grad_(), state["dense"])
        gathered = {k: v.requires_grad_() for k, v in gathered.items()}
        dense_leaves = tree_leaves(dense)
        names = list(gathered)
        with torch.enable_grad():
            with span("tfrec.forward"):
                logits = self.model(dense, gathered, batch, generator=generator, **(forward_kw or {}))
                loss = self.objective(logits, batch, gathered, dense_leaves)
            with span("tfrec.backward"):
                grads = torch.autograd.grad(loss, dense_leaves + [gathered[n] for n in names])
        dense_grad = _unflatten(state["dense"], grads[: len(dense_leaves)])
        return loss.detach(), dense_grad, dict(zip(names, grads[len(dense_leaves):]))

    def objective(self, logits, batch, gathered, dense_leaves) -> torch.Tensor:
        """The loss, plus ``l2_reg`` times the squares of the gathered rows
        and dense params over the batch size (``batch_size_of``)."""
        loss = self.loss_fn(logits, batch)
        if self.l2_reg > 0:
            reg = sum((v * v).sum() for v in gathered.values())
            reg = reg + sum((p * p).sum() for p in dense_leaves)
            loss = loss + self.l2_reg * reg / batch_size_of(logits)
        return loss

    def step(self, state: State, batch: Dict[str, torch.Tensor]) -> Tuple[State, Dict]:
        """One step on a batch of tensors on this device (CTR {"dense",
        "cat", "label"}, pairwise {"user", "pos", "neg" or "negs"},
        pointwise {"user", "item", "label"}; any "_sort_<table>" keys are
        the host's dedup sorts) -> (new state, {"loss"}); the loss stays on
        the device."""
        with span("tfrec.step"):
            # The host's dedup sorts (train.host_dedup) ride the batch as
            # "_sort_<table>" keys; the model never sees them.
            host_sort = {k[len("_sort_"):]: v for k, v in batch.items() if k.startswith("_sort_")}
            if host_sort:
                batch = {k: v for k, v in batch.items() if not k.startswith("_sort_")}
            generator = self._generator(state["step"])
            batch = self._draw_negatives(batch, generator)
            loss, dense_grad, gathered_grad, ids = self.loss_and_grads(state, batch, generator)
            with span("tfrec.dense_update"):
                updates, new_dense_opt = self.dense_tx.update(dense_grad, state["dense_opt"],
                                                              state["dense"])
                new_dense = apply_updates(state["dense"], updates)
            lr = self.sparse_schedule(state["step"])
            new_tables, new_sparse = self.sparse_update_all(state, ids, gathered_grad, lr, host_sort)
        new_state = {
            "step": state["step"] + 1,
            "tables": new_tables,
            "dense": new_dense,
            "sparse_opt": new_sparse,
            "dense_opt": new_dense_opt,
        }
        return new_state, {"loss": loss}

    def multi_step(self, state: State, batches: Dict[str, torch.Tensor]):
        """K steps, one after another: every tensor of ``batches`` has a
        leading [K] axis (train.steps_per_dispatch). Returns the final state
        and the last step's metrics with ``loss_mean`` over the K steps."""
        k = next(iter(batches.values())).shape[0]
        losses = []
        metrics: Dict[str, torch.Tensor] = {}
        for i in range(k):
            state, metrics = self.step(state, {name: v[i] for name, v in batches.items()})
            losses.append(metrics["loss"])
        out = dict(metrics)
        out["loss_mean"] = torch.stack(losses).mean()
        return state, out


def init_state(
    model: RecModel, optim_cfg: OptimConfig, generator: torch.Generator, **kw
) -> Tuple[TrainStepBuilder, State]:
    builder = TrainStepBuilder(model, kw.pop("loss", "bpr"), optim_cfg, **kw)
    return builder, builder.init_state(generator)
