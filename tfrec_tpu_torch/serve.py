"""Inference surface: the counterpart of ``tfrec_tpu/serve.py``.

``Recommender(model, params, device="cuda")`` holds a model and its params
on one device and serves ``predict_ctr(dense, cat)`` -> logits [N]: it
copies the request to the device, gathers one row per field id through
``ops.embedding.gather_many`` (one launch of the CUDA gather kernel for
every field on a card), runs the
model's forward (the CUDA cross-stack kernel for DCN-v1 and low-rank
DCN-v2) and returns numpy.
``predict``, ``score_catalog``, ``recommend``, ``from_checkpoint`` and
quantized serving come in later slices.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tfrec_tpu_torch.ops.embedding import gather_many


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


class Recommender:
    def __init__(self, model, params, device: torch.device | str = "cuda"):
        """``params``: the tree ``{"tables": ..., "dense": ...}`` of tensors
        (``model.init`` or ``convert.params_from_jax``); it is moved to
        ``device`` once. The default device is the card: without CUDA this
        raises rather than serve on the CPU; pass ``device="cpu"`` for that."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Recommender serves on device='cuda' by default, but CUDA is "
                "not available; pass device='cpu' to serve on the CPU"
            )
        self.model = model
        self.params = _to_device(params, self.device)

    @torch.inference_mode()
    def predict_ctr(self, dense, cat) -> np.ndarray:
        """CTR logits [N] for dense [N, Dd] f32 (may have 0 columns) and
        cat [N, sum(widths)] int32 ids (negative and sentinel ids clamp)."""
        batch = {
            "dense": torch.from_numpy(np.ascontiguousarray(dense, np.float32)).to(self.device),
            "cat": torch.from_numpy(np.ascontiguousarray(cat, np.int32)).to(self.device),
        }
        tables = self.params["tables"]
        ids = self.model.lookup_ids(batch)
        gathered = dict(zip(ids, gather_many([tables[k] for k in ids], list(ids.values()))))
        return self.model(self.params["dense"], gathered, batch).cpu().numpy()
