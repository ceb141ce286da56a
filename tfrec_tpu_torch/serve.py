"""Inference surface: the counterpart of ``tfrec_tpu/serve.py``.

``Recommender(model, params, dataset=None, device="cuda")`` holds a model
and its params on one device and serves:

- ``predict(user_ids, item_ids)`` -> scores [N] of (user, item) pairs;
- ``predict_ctr(dense, cat)`` -> CTR logits [N];
- ``score_catalog(user_ids)`` -> [B, num_items] scores of the full catalog;
- ``recommend(user_ids, k, exclude_train=True)`` -> (ids [B, k], scores
  [B, k]), each user's train items excluded where a dataset is given.

Each copies the request to the device, gathers one row per id through
``ops.embedding`` (one launch of the CUDA gather kernel for every table on
a card), runs the model and returns numpy. ``predict`` serves the
retrieval models (MF, GMF, MLP, NeuMF), the sequential ones (SASRec,
GRU4Rec, Caser, FPMC: each user's attached sequence is encoded and its last
hidden state dotted with the items' rows), the history models (FISM, NAIS,
Mult-VAE, Mult-DAE, CDAE: each user's attached train history read for the
request; the autoencoders' reconstruction at the items) and the graph
models (LightGCN, NGCF: the embeddings propagated over the attached graph,
no table gathered), SBPR, APR, IRGAN (its generator), Pop, ConvNCF, WRMF
and EASE (the rows of its transposed solution dotted with each user's train
row, ``pointwise_batch_extras``), ``predict_ctr`` the CTR models
(FM, DCN, DeepFM, NFM, Wide & Deep, DLRM), in the model's own table layout
(per field, lane-packed or stacked). The catalog is scored by the model's
``score_all``: one ``torch.matmul`` for MF (and SBPR, APR, IRGAN's
generator, WRMF), GMF and 2-field FM, item chunks
through the towers for MLP and NeuMF, the sequence encoder then one
``torch.matmul`` for the sequential models, the history for FISM and the
autoencoders, the catalog attended in chunks for NAIS, the propagation for
the graph models, Pop's bias row, ConvNCF's item chunks through its
convolutions, EASE's train rows times its solution (FM with side fields
has none and raises); the
top-k is ``torch.topk`` (``eval.retrieval``; "approx" is exact here, as on
the reference's CPU). Ids out of range clamp, as the reference's
``jnp.take(mode="clip")`` does in ``predict``.

``from_checkpoint(config)`` serves from disk: it rebuilds the model (and
its dataset, and the sequences, histories or graph the model attaches) from
the config
and restores the latest checkpoint, saved by
the port or by the JAX package in any table layout, into the config's
layout (per field under ``model.lane_pack=None``).

On a mesh (``from_trainer`` of a trainer on N ranks, or ``mesh=``,
``state=`` and ``builder=``) it serves the live sharded state in its
training layout, nothing re-replicated for ``recommend``: every rank calls
each method with the same request (a collective) and gets the whole
answer. ``recommend`` of a dot-product scorer gathers the users' rows
(``parallel/eval.gather_rows``: ``sharded_row_gather`` for a row-sharded
table), applies the model's query transform and runs
``parallel/topk.sharded_topk_dot`` against each rank's block of the item
table (``table_rows``). ``predict`` and ``predict_ctr`` gather each table's
rows by its plan the same way; ``score_catalog`` and ``recommend`` of a
scorer without a dot decomposition take the logical tables, gathered once.
A row-permuted state (``mesh.row_permute``, CTR models only) is served from
its logical tables, as in the reference.

While a profiler records, ``predict_ctr`` opens ``tfrec.serve.predict_ctr``
around the call and inside it ``tfrec.serve.inputs`` (the request to the
device), ``tfrec.lookup`` (ids and gather), ``tfrec.forward`` and
``tfrec.serve.outputs`` (the logits to numpy) (``utils/profile.span``).

``quantize=True`` (MF only, as in the reference) scores the catalog
against an int8 copy of the item table (``ops/quantize.py``: rowwise
scales, the values widened a chunk of items at a time); ``predict`` keeps
the f32 rows.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from tfrec_tpu_torch.eval.retrieval import TOPK_METHODS, padded_positives, topk_scores
from tfrec_tpu_torch.models.mf import MF
from tfrec_tpu_torch.ops.embedding import gather_many
from tfrec_tpu_torch.ops.quantize import quantize_table, quantized_scores
from tfrec_tpu_torch.parallel.eval import gather_rows, table_rows
from tfrec_tpu_torch.parallel.topk import sharded_topk_dot
from tfrec_tpu_torch.utils.profile import span


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


class Recommender:
    def __init__(self, model, params, dataset=None, mesh=None, quantize: bool = False,
                 state=None, topk_method: str = "approx", recall_target: float = 0.99,
                 device: torch.device | str = "cuda", builder=None):
        """``params``: the tree ``{"tables": ..., "dense": ...}`` of tensors
        (``model.init`` or ``convert.params_from_jax``); it is moved to
        ``device`` once. ``dataset`` (``data.dataset.Dataset``) gives the
        catalog size and the train items ``recommend`` excludes. The
        default device is the card: without CUDA this raises rather than
        serve on the CPU; pass ``device="cpu"`` for that. On a mesh,
        ``state`` is a live sharded train state, laid out by ``builder``
        (``parallel.step.ShardedTrainStepBuilder``) on ``mesh``, its
        device's; ``params`` is then unused (None)."""
        if quantize and type(model) is not MF:
            raise ValueError("quantize=True supports the MF dot-product scorer only; "
                             f"got {type(model).__name__}")
        if topk_method not in TOPK_METHODS:
            raise ValueError(f"unknown topk method {topk_method!r}")
        self.mesh, self.state, self.builder = mesh, state, builder
        self._logical = None
        if mesh is not None or state is not None:
            if mesh is None or state is None or builder is None or builder.mesh is not mesh:
                raise ValueError("serving a live sharded state takes mesh=, state= and the builder= "
                                 "that lays the state out on that mesh")
            device = mesh.device
            if any(getattr(p, "permute", False) for p in builder.plans.values()):
                # Physical rows: serve the logical tables (CTR models only).
                self._logical = builder.unpadded_tables(state)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Recommender serves on device='cuda' by default, but CUDA is "
                "not available; pass device='cpu' to serve on the CPU"
            )
        self.model = model
        self.params = _to_device(params, self.device) if params is not None else None
        self.dataset = dataset
        self.topk_method = topk_method
        self.recall_target = recall_target
        self._train_padded = None
        # int8 item rows and their scales, on the device (ops/quantize.py).
        self._quant = quantize_table(self._params()["tables"]["item_emb"]) if quantize else None

    @classmethod
    def from_checkpoint(cls, config, checkpoint_dir: str | None = None,
                        device: torch.device | str = "cuda") -> "Recommender":
        """Cold-start serving from disk, the deploy path once the training
        job is gone: rebuild the model and its dataset from ``config``,
        restore the params of the latest checkpoint of ``checkpoint_dir``
        (default: ``config.train.checkpoint_dir``) and serve them on
        ``device``. No step runs, and nothing is appended to the run's
        metric stream. Raises where there is no checkpoint: serving fresh
        random tables would go unnoticed."""
        import dataclasses

        from tfrec_tpu_torch.train.trainer import Trainer
        from tfrec_tpu_torch.utils.checkpoint import latest_step

        ckpt = checkpoint_dir or config.train.checkpoint_dir
        if not ckpt:
            raise ValueError("from_checkpoint needs a checkpoint_dir")
        step = latest_step(ckpt)
        if step is None:
            raise ValueError(f"no checkpoint found under {ckpt!r}")
        cfg = dataclasses.replace(config, train=dataclasses.replace(
            config.train, resume=False, init_from=None, checkpoint_dir=ckpt))
        trainer = Trainer(cfg, quiet=True, device=device, log_metrics=False)
        params = trainer.restore(ckpt, step, params_only=True)
        return cls(trainer.model, params, dataset=trainer.dataset, device=trainer.device)

    @classmethod
    def from_trainer(cls, trainer) -> "Recommender":
        """Serve a trainer's model and params, with its dataset, on its
        device; a trainer on a mesh, from its live sharded state."""
        if getattr(trainer, "mesh", None) is not None:
            return cls(trainer.model, None, dataset=trainer.dataset, mesh=trainer.mesh,
                       state=trainer.state, builder=trainer.builder)
        return cls(trainer.model, trainer.params, dataset=trainer.dataset, device=trainer.device)

    def _sharded(self) -> bool:
        return self.state is not None and self._logical is None

    def _params(self):
        """The params tree: on a mesh the logical tables, gathered once (a
        collective)."""
        if self.state is None:
            return self.params
        if self._logical is None:
            self._logical = self.builder.unpadded_tables(self.state)
        return {"tables": self._logical, "dense": self.builder.dense_params(self.state)}

    def _ids(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

    def _forward(self, batch) -> torch.Tensor:
        sharded = self._sharded()
        with span("tfrec.lookup"):
            ids = self.model.lookup_ids(batch)
            if sharded:
                tables = self.state["tables"]
                gathered = {k: gather_rows(self.builder, tables, k, v) for k, v in ids.items()}
            else:
                params = self._params()
                tables = params["tables"]
                gathered = dict(zip(ids, gather_many([tables[k] for k in ids], list(ids.values()))))
        with span("tfrec.forward"):
            dense = self.builder.dense_params(self.state) if sharded else params["dense"]
            return self.model(dense, gathered, batch)

    # ---- pointwise scoring ----

    @torch.inference_mode()
    def predict(self, user_ids, item_ids) -> np.ndarray:
        """Scores [N] of (user, item) pairs, the reference's ``predict``."""
        users = self._ids(user_ids)
        batch = {"user": users, "item": self._ids(item_ids),
                 "label": torch.zeros(users.shape[0], dtype=torch.float32, device=self.device)}
        # A sequential model takes each user's attached sequence as batch
        # entries (the reference passes them as the jit's arguments).
        extras = getattr(self.model, "pointwise_batch_extras", None)
        if extras is not None:
            batch.update(extras(users))
        return self._forward(batch).cpu().numpy()

    @torch.inference_mode()
    def predict_ctr(self, dense, cat) -> np.ndarray:
        """CTR logits [N] for dense [N, Dd] f32 (may have 0 columns) and
        cat [N, sum(widths)] int32 ids (negative and sentinel ids clamp)."""
        with span("tfrec.serve.predict_ctr"):
            with span("tfrec.serve.inputs"):
                batch = {
                    "dense": torch.from_numpy(np.ascontiguousarray(dense, np.float32)).to(self.device),
                    "cat": self._ids(cat),
                }
            logits = self._forward(batch)
            with span("tfrec.serve.outputs"):
                return logits.cpu().numpy()

    # ---- catalog scoring and top-k ----

    def _num_items(self) -> int:
        if self.dataset is not None:
            return self.dataset.num_items
        return self.model.data_spec.num_items

    def _score_all(self, users: torch.Tensor) -> torch.Tensor:
        """[B, V] scores of every item: the model's ``score_all``, or with
        ``quantize`` the user rows against the int8 item table."""
        if self._quant is None:
            return self.model.score_all(self._params(), users)
        tables = self._params()["tables"]
        (u,) = gather_many([tables["user_emb"]], [users])
        bias = tables["item_bias"][:, 0] if "item_bias" in tables else None
        return quantized_scores(u, self._quant, bias)

    @torch.inference_mode()
    def score_catalog(self, user_ids) -> np.ndarray:
        """[B, num_items] scores of every item for each user."""
        scores = self._score_all(self._ids(user_ids))
        return scores[:, : self._num_items()].cpu().numpy()

    def _train_exclusions(self, user_ids: np.ndarray):
        """Each user's train items (padded, counts) on the device, or
        (None, None) without a dataset."""
        if self.dataset is None:
            return None, None
        if self._train_padded is None:
            padded, counts = padded_positives(self.dataset.train_csr)
            self._train_padded = (torch.from_numpy(padded).to(self.device),
                                  torch.from_numpy(counts).to(self.device))
        users = self._ids(user_ids).long()
        padded, counts = self._train_padded
        return padded[users], counts[users]

    @torch.inference_mode()
    def recommend(self, user_ids, k: int, exclude_train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """The top-k item ids [B, k] int32 and their scores [B, k] for each
        user, best first, each user's train items excluded when
        ``exclude_train`` and a dataset is given. The [B, V] score matrix is
        built once, as in the reference."""
        exc_p, exc_c = self._train_exclusions(user_ids) if exclude_train else (None, None)
        spec = self.model.dot_decomposition()
        if self._sharded() and spec is not None and self._quant is None:
            return self._recommend_sharded(spec, user_ids, k, exc_p, exc_c)
        scores = self._score_all(self._ids(user_ids))[:, : self._num_items()]
        vals, ids = topk_scores(scores, k, exc_p, exc_c, method=self.topk_method,
                                recall_target=self.recall_target)
        return ids.cpu().numpy(), vals.cpu().numpy()

    def _recommend_sharded(self, spec, user_ids, k: int, exc_p, exc_c):
        """``recommend`` of a dot-product scorer on the live sharded state:
        the users' rows, the query transform, the sharded top-k."""
        tables = self.state["tables"]
        users = self._ids(user_ids)
        q = spec.user_vecs(self.builder.dense_params(self.state),
                           gather_rows(self.builder, tables, spec.user_table, users))
        items, _ = table_rows(self.builder, tables, spec.item_table)
        bias = (table_rows(self.builder, tables, spec.bias_table)[0][:, 0]
                if spec.bias_table is not None else None)
        vals, ids = sharded_topk_dot(self.mesh, q, items, k, self._num_items(), item_bias=bias,
                                     exclude_padded=exc_p, exclude_counts=exc_c,
                                     method=self.topk_method, recall_target=self.recall_target)
        return ids.cpu().numpy(), vals.cpu().numpy()
