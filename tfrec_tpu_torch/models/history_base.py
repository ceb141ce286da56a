"""Models over each user's unordered train history: FISM, NAIS, Mult-VAE
(and Mult-DAE) and CDAE.

Training batches carry the history in the batch, "hist" [B, H] item ids
padded with the sentinel ``num_items`` (``data.samplers.build_history``:
``PairwiseSampler(with_history=H)`` for FISM and NAIS,
``UserHistorySampler`` for the autoencoders), so every step has static
shapes, and the history's rows are gathered with the other tables' in one
launch of the gather kernel on a card: sentinel ids clamp to the last row
and the models mask those rows, and the duplicate combine drops their
gradient slots before the Adagrad kernel. Scoring reads the whole [U, H]
history the trainer attaches (``attach_history``), copied to a device once;
the sequential models (``seq_base``) attach their ordered sequences through
the same base.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from tfrec_tpu_torch.models.base import RecModel, copy_once


class HistoryRecModel(RecModel):
    """A model that reads each user's train history: the [U, H] matrix and
    its lengths that the trainer attaches, and their device copies. The
    sequential models share it (``ordered_history``: time-ordered sequences
    from ``build_sequences``, not unordered sets)."""

    ordered_history = False

    def __init__(self):
        super().__init__()
        self._hist = self._hist_len = None  # [U, H] and [U] int32 numpy, sentinel-padded
        self._hist_on: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def needs_history(self) -> bool:
        return True

    def attach_history(self, hist, hist_len) -> None:
        """The [U, H] train histories (and lengths) that scoring reads."""
        self._hist = np.ascontiguousarray(hist, np.int32)
        self._hist_len = np.ascontiguousarray(hist_len, np.int32)
        self._hist_on = {}

    def _history(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The attached (history, lengths) on ``device``, copied once."""
        if self._hist is None:
            raise ValueError(
                f"{type(self).__name__} scoring needs attach_history(hist, hist_len) (the trainer "
                "does this from the train split)")
        return copy_once(self._hist_on, device, lambda d: (torch.from_numpy(self._hist).to(d),
                                                           torch.from_numpy(self._hist_len).to(d)))

    def batch_history(self, batch) -> torch.Tensor:
        """The batch's "hist", or for a batch without one (a served
        (user, item) request) its users' attached histories."""
        if "hist" in batch:
            return batch["hist"]
        return self._history(batch["user"].device)[0][batch["user"].long()]

    def _valid(self, hist: torch.Tensor) -> torch.Tensor:
        return hist < self.data_spec.num_items
