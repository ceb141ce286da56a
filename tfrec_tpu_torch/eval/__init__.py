"""Evaluation of the port: ranking metrics and the full-catalog retrieval
evaluator (``retrieval``), and CTR metrics."""

from tfrec_tpu_torch.eval.metrics import auc, logloss, ranking_metrics_from_topk

__all__ = ["auc", "logloss", "ranking_metrics_from_topk"]
