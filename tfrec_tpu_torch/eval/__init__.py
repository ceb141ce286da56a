"""Evaluation of the port: ranking metrics, the full-catalog retrieval
evaluator (``retrieval``), the sampled-candidate evaluator (``sampled``),
the native threaded C++ evaluator on the host (``native``), and CTR
metrics."""

from tfrec_tpu_torch.eval.metrics import auc, logloss, ranking_metrics_from_topk

__all__ = ["auc", "logloss", "ranking_metrics_from_topk"]
