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
retrieval models (MF, GMF, MLP, NeuMF), ``predict_ctr`` the CTR models (FM,
DCN), in the model's own table layout (per field, lane-packed or
stacked). The catalog is scored by the model's ``score_all``: one
``torch.matmul`` for MF, GMF and 2-field FM, item chunks through the
towers for MLP and NeuMF (FM with side fields has none and raises); the
top-k is ``torch.topk`` (``eval.retrieval``; "approx" is exact here, as on
the reference's CPU). Ids out of range clamp, as the reference's
``jnp.take(mode="clip")`` does in ``predict``.

``from_checkpoint(config)`` serves from disk: it rebuilds the model (and
its dataset) from the config and restores the latest checkpoint, saved by
the port or by the JAX package in any table layout, into the config's
layout (per field under ``model.lane_pack=None``).

Refused by naming the ROADMAP Queue 1 item: int8 serving
(``quantize=True``, item 13) and a mesh or a live sharded train state
(item 11).
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from tfrec_tpu_torch.eval.retrieval import TOPK_METHODS, padded_positives, topk_scores
from tfrec_tpu_torch.ops.embedding import gather_many


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


class Recommender:
    def __init__(self, model, params, dataset=None, mesh=None, quantize: bool = False,
                 state=None, topk_method: str = "approx", recall_target: float = 0.99,
                 device: torch.device | str = "cuda"):
        """``params``: the tree ``{"tables": ..., "dense": ...}`` of tensors
        (``model.init`` or ``convert.params_from_jax``); it is moved to
        ``device`` once. ``dataset`` (``data.dataset.Dataset``) gives the
        catalog size and the train items ``recommend`` excludes. The
        default device is the card: without CUDA this raises rather than
        serve on the CPU; pass ``device="cpu"`` for that."""
        if quantize:
            raise NotImplementedError(
                "Recommender(quantize=True) (int8 item tables, ops/quantize.py) is not ported "
                "yet: ROADMAP Queue 1 item 13")
        if mesh is not None or state is not None:
            raise NotImplementedError(
                "serving from a mesh or a live sharded train state is not ported yet: ROADMAP "
                "Queue 1 item 11; the port serves on one device")
        if topk_method not in TOPK_METHODS:
            raise ValueError(f"unknown topk method {topk_method!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Recommender serves on device='cuda' by default, but CUDA is "
                "not available; pass device='cpu' to serve on the CPU"
            )
        self.model = model
        self.params = _to_device(params, self.device)
        self.dataset = dataset
        self.topk_method = topk_method
        self.recall_target = recall_target
        self._train_padded = None

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
        device."""
        return cls(trainer.model, trainer.params, dataset=trainer.dataset, device=trainer.device)

    def _ids(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

    def _forward(self, batch) -> torch.Tensor:
        tables = self.params["tables"]
        ids = self.model.lookup_ids(batch)
        gathered = dict(zip(ids, gather_many([tables[k] for k in ids], list(ids.values()))))
        return self.model(self.params["dense"], gathered, batch)

    # ---- pointwise scoring ----

    @torch.inference_mode()
    def predict(self, user_ids, item_ids) -> np.ndarray:
        """Scores [N] of (user, item) pairs, the reference's ``predict``."""
        users = self._ids(user_ids)
        batch = {"user": users, "item": self._ids(item_ids),
                 "label": torch.zeros(users.shape[0], dtype=torch.float32, device=self.device)}
        return self._forward(batch).cpu().numpy()

    @torch.inference_mode()
    def predict_ctr(self, dense, cat) -> np.ndarray:
        """CTR logits [N] for dense [N, Dd] f32 (may have 0 columns) and
        cat [N, sum(widths)] int32 ids (negative and sentinel ids clamp)."""
        batch = {
            "dense": torch.from_numpy(np.ascontiguousarray(dense, np.float32)).to(self.device),
            "cat": self._ids(cat),
        }
        return self._forward(batch).cpu().numpy()

    # ---- catalog scoring and top-k ----

    def _num_items(self) -> int:
        if self.dataset is not None:
            return self.dataset.num_items
        return self.model.data_spec.num_items

    @torch.inference_mode()
    def score_catalog(self, user_ids) -> np.ndarray:
        """[B, num_items] scores of every item for each user."""
        scores = self.model.score_all(self.params, self._ids(user_ids))
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
        scores = self.model.score_all(self.params, self._ids(user_ids))[:, : self._num_items()]
        vals, ids = topk_scores(scores, k, exc_p, exc_c, method=self.topk_method,
                                recall_target=self.recall_target)
        return ids.cpu().numpy(), vals.cpu().numpy()
