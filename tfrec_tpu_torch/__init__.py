"""tfrec_tpu_torch — the PyTorch/CUDA port of tfrec_tpu for NVIDIA Hopper.

The JAX package ``tfrec_tpu`` stays the reference; this package keeps its
module names so each file's counterpart is easy to find. Plain tensor code
is PyTorch; every Pallas kernel of the reference becomes a CUDA C++ kernel
for ``sm_90a`` under ``kernels/csrc/``, built with ``nvcc`` on first use
and bound with ``ctypes`` (``kernels/_build.py``). Each kernel wrapper runs
its plain PyTorch version only for tensors that lie on the CPU.

Ported so far (serving, training and evaluating ``zoo_configs.dcn_criteo``,
as DCN-v1 and as low-rank DCN-v2; retrieval, ``zoo_configs.mf_bpr_ml100k``,
MF + BPR trained, ranked over the full catalog and served as top-k; FM over
multi-field interaction data, ``fm_ctr_ml1m``; and NeuMF with the
sampled-candidate eval, ``neumf_ml20m``):

- ``configs``, ``zoo_configs.mf_bpr_ml100k``, ``fm_ctr_ml1m``,
  ``neumf_ml20m`` and ``dcn_criteo``;
- ``data``: ``dataset`` (``synthetic_implicit`` split by ratio or leave one
  out), ``synthetic``, the pairwise, pointwise and CTR samplers;
- ``ops.embedding`` (table specs, seeded init, clip-semantics gather, the
  duplicate-id combine) and ``ops.sparse_optim``;
- ``kernels``: the row gather, the DCN-v1 and low-rank DCN-v2 cross stacks
  (forward and backward) and the fused rowwise-Adagrad update;
- ``models``: ``MF``, ``GMF``, ``MLP``, ``NeuMF``, and ``FM`` and ``DCN``
  (v1, v2 full-rank, v2 low-rank) over per-field tables;
- ``convert``: JAX params of the retrieval models and of any CTR table
  layout (FM's linear tables too), and JAX train states;
- ``serve.Recommender`` (``predict``, ``predict_ctr``, ``score_catalog``,
  ``recommend``), ``train.step.TrainStepBuilder`` (with device negatives),
  ``train.losses`` (pairwise and pointwise);
- ``train.trainer.Trainer`` and ``run`` on one device, with ``eval.metrics``
  (ranking metrics, ``auc``, ``logloss``), ``eval.retrieval`` (masking,
  top-k, the full-catalog evaluator), ``eval.sampled`` (the
  sampled-candidate evaluator), ``utils.logging.MetricLogger`` and
  ``utils.prefetch``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
This package never imports ``jax`` or any module of ``tfrec_tpu``.
"""

__version__ = "0.1.0"
