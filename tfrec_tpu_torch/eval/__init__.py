"""Evaluation of the port: CTR metrics."""

from tfrec_tpu_torch.eval.metrics import auc, logloss

__all__ = ["auc", "logloss"]
