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
multi-field interaction data, ``fm_ctr_ml1m``; NeuMF with the
sampled-candidate eval, ``neumf_ml20m``; config 5's sharded tables and
dense params on N ranks, ``dcn_multihost``; the rest of the CTR zoo, the
sequential, history and graph zoos, and the long tail: every model, zoo
config and module of the reference, but ``table_sharding="gspmd"`` and
the non-ports ROADMAP.md lists with their reasons):

- ``configs`` (with ``with_overrides``), ``zoo_configs.mf_bpr_ml100k``,
  ``fm_ctr_ml1m``, ``neumf_ml20m``, ``dcn_criteo``, ``dcn_multihost``,
  ``sasrec_ml1m``, ``gru4rec_ml1m``, ``caser_ml1m``, ``fism_ml100k``,
  ``nais_ml100k``, ``multvae_ml100k``, ``cdae_ml100k``, ``sbpr_ml100k``,
  ``apr_ml100k``, ``irgan_ml100k``, ``wrmf_ml100k`` and ``ease_ml100k``
  (``ZOO``), and
  ``cli`` (``python -m tfrec_tpu_torch.cli``; N ranks from the reference's
  ``JAX_*`` variables);
- ``data``: ``dataset`` (MovieLens' files or ``synthetic_implicit``, split
  by ratio, leave one out or given train and test files), ``synthetic``,
  ``criteo`` and ``movielens`` (Criteo's TSV and MovieLens' rating and
  ML-1M side-feature files, through the native parsers of ``csrc/``,
  ``criteo_native`` and ``uirt_native``, or the Python ones), the
  pairwise, pointwise, CTR, sequence, history and social samplers
  (``build_sequences``, ``build_history``, ``SBPRSampler``; the trust
  graph on the dataset);
- ``ops.embedding`` (table specs, seeded init, clip-semantics gather, the
  duplicate-id combine per table, batched, flat, or from the host's sorts),
  ``ops.sparse_optim`` (with lane-grouped state), ``ops.quantize`` (int8
  item tables for serving) and ``ops.precision``
  (``train.matmul_precision``);
- ``kernels``: the row gather, the DCN-v1 and low-rank DCN-v2 cross stacks
  (forward and backward) and the fused rowwise-Adagrad update (lane-grouped
  rows too);
- ``models``: ``MF``, ``GMF``, ``MLP``, ``NeuMF``; ``FM``, ``DCN`` (v1, v2
  full-rank, v2 low-rank), ``DeepFM``, ``WideDeep``, ``NFM`` and ``DLRM``
  over per-field, lane-packed or stacked tables; the sequential
  ``SASRec``, ``GRU4Rec``, ``Caser`` and ``FPMC`` (``seq_base``); the
  history ``FISM``, ``NAIS``, ``MultVAE``, ``CDAE``; the graph ``LightGCN``
  and ``NGCF``; ``SBPR``, ``APR``, ``IRGAN``, ``Pop``, ``ConvNCF``, and the
  closed-form ``WRMF`` (``train.als``) and ``EASE``;
- ``convert``: JAX params of the retrieval models and of any CTR table
  layout (FM's linear tables too), JAX train states in any layout, and the
  port's state as the JAX package's checkpoint keys and back;
- ``utils.checkpoint``: checkpoints in the JAX package's on-disk layout
  (save, resume and warm starts in the trainer; serving from disk by
  ``Recommender.from_checkpoint``); ``utils.profile`` (step profiles on
  ``torch.profiler``);
- ``serve.Recommender`` (``predict``, ``predict_ctr``, ``score_catalog``,
  ``recommend``), ``train.step.TrainStepBuilder`` (with device negatives,
  the batched duplicate combine and the host's dedup sorts),
  ``train.losses`` (pairwise, pointwise and every model-specific
  objective);
- ``parallel``: ``mesh`` (process groups: NCCL, gloo, gloo over CUDA
  tensors for ranks sharing a card; the collectives), ``embedding``
  (row-sharded tables: the all-to-all lookup and gradient combine, the
  lane-sliced wire; column-sharded tables), ``step``
  (``ShardedTrainStepBuilder``, FSDP dense params), ``eval`` and ``topk``
  (retrieval on a mesh) and ``dryrun`` (the multi-rank dry run);
- ``train.trainer.Trainer`` and ``run`` on one device or on N ranks (CTR
  data, row-sharded tables), with ``eval.metrics``
  (ranking metrics, ``auc``, ``logloss``), ``eval.retrieval`` (masking,
  top-k, the full-catalog evaluator), ``eval.sampled`` (the
  sampled-candidate evaluator), ``eval.native`` (the host C++ evaluator),
  ``utils.logging.MetricLogger`` and
  ``utils.prefetch``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
This package never imports ``jax`` or any module of ``tfrec_tpu``.
"""

__version__ = "0.1.0"
