"""Training objectives: the counterpart of ``tfrec_tpu/train/losses.py``.

Ported so far: ``logloss`` (pointwise CTR). ``make_loss`` refuses, by
name, the reference's losses that are not ported yet (ROADMAP Queue 1
items 8 and 12) rather than train with another objective.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def logloss(logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Binary cross-entropy from logits (mean over the batch), in the
    reference's stable form max(x, 0) - x*y + log1p(exp(-|x|))."""
    labels = batch["label"]
    return torch.mean(
        torch.clamp_min(logits, 0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    )


_LOSSES: Dict[str, Callable] = {"logloss": logloss}
# The reference's other losses, refused by name until they are ported.
_NOT_PORTED = ("bpr", "hinge", "mse", "sampled_softmax", "in_batch_softmax", "multvae",
               "cdae", "sasrec", "sbpr", "apr", "irgan")


def make_loss(name: str) -> Callable[[torch.Tensor, Dict], torch.Tensor]:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"loss {name!r} is not ported yet (ROADMAP Queue 1 items 8 and 12); "
            f"ported: {sorted(_LOSSES)}"
        )
    if name not in _LOSSES:
        raise ValueError(f"unknown loss {name!r}; options: {sorted(_LOSSES)}")
    return _LOSSES[name]
