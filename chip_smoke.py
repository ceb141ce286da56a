#!/usr/bin/env python3
"""Drive tfrec_tpu_torch's serving, training and retrieval slices, configs 1-5 (config 5's row- and column-sharded tables and retrieval on a mesh), data files, checkpoints and the CLI, every table layout and duplicate combine of the step, the rest of the CTR and the sequential zoo, the history and graph zoos, and the long tail (SBPR, APR, IRGAN, Pop, ConvNCF, WRMF, EASE) and the native evaluator, on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and nvcc (it builds the kernels from kernels/csrc/), and exits
non-zero if any phase fails:

1. environment: CUDA present; the card's name and power limit; TF32 off;
2. build: nvcc compiles every kernel source into build/tfrec_tpu_torch/,
   one process per source, all started together;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at edge cases, and each repeating bit for bit (the
   gather and Adagrad kernels over all 26 tables in one launch, bit for
   bit their plain versions and their one-table launches, and past one
   launch's 64 tables); the duplicate-id combine repeating bit for bit and
   matching the CPU; then
   the cross kernels at widths past the flagship's (v1 at d=2093, L=3,
   and at d=8333, L=4, past what a block's registers hold, on the
   kernels' streaming routes; v2 at d=1885 and 3341, r=64, L=3; and v2 on
   its general route past its tiles: d=4173 and 3565 at L=3, and L=48 at
   d=845, whose backward is past the weight pass's stages; B=8192),
   each through its kernels (launch counters, the general route's own),
   against its plain version, bit for bit on repeat, with its device time
   beside its bound (and the v1 backward's and the general route's time
   by kernel);
4. serving: ``dcn_criteo`` at Criteo's shape (26 fields of 100 000 rows,
   d=32, 13 dense features, 3 cross layers, MLP 512/256/128) from a seeded
   generator, batches of 8192 through ``Recommender.predict_ctr``; the
   logits must be finite, match the same model run through the plain
   versions on the card and, on a small input, on the CPU; launch counters
   prove the gather (one launch a batch for the 26 fields) and the v1
   cross kernels ran, and no other; the route of a launch a field gives
   the same logits bit for bit;
5. serving times with CUDA events: each kernel beside its bound, its plain
   version and the one PyTorch call that computes the same function where
   there is one (the gather's one launch beside 26 launches of one table
   each and 26 ``index_select``, and the host's cost of each); predict_ctr's
   latency and a profile of one request batch, through one launch and
   through a launch a field;
6. training: the same model trained by ``TrainStepBuilder`` on the default
   device (dense Adam, rowwise Adagrad, logloss), ``multi_step`` over
   K = train.steps_per_dispatch batches of 8192 from ``synthetic_ctr``;
   launch counters prove every kernel of the step ran (one gather and one
   Adagrad launch a step for the 26 tables); the loss is finite and falls
   on a held batch; one step repeats bit for bit, matches the same step on
   the CPU (plain versions) from the same state, and is bit for bit the
   step of a launch a table (the per-table seams);
7. training times: the backward cross kernel (and its time by kernel) and
   the Adagrad kernel beside their bounds and plain versions (the Adagrad
   kernel's one launch beside 26 launches of one table, at the step's Zipf
   ids and at uniform ids, and the host's cost of each), the step's median
   and a profile of one step, through one launch and through a launch a
   table;
8. phases 4 and 6 again for the same model as low-rank DCN-v2
   (``model.name="dcnv2"``, ``cross_rank=64``: U and V [3, 845, 64]), whose
   cross stack runs the v2 kernels; then their times beside their bounds
   and plain versions (both bounds count their 3xTF32 products on the
   tensor cores) and the backward's time by kernel, predict_ctr's
   latency, the step's median and a profile of one step; then DLRM's dot
   interaction at the benchmark's DLRM cell (B=32768, 27 vectors, d=128;
   ``interaction.cu``, no Pallas site): both kernels against their plain
   versions, bit for bit on repeat, one launch each way, their device
   times beside their bounds, the plain versions' and the former bmm and
   triangle's with autograd's backward (``dot_interaction_fwd`` and
   ``dot_interaction_bwd`` records);
9. the trainer: ``trainer.run`` on the card at Criteo's shape (dcn_criteo
   from synthetic_ctr at 26 fields of 100 000 rows, 300 000 examples, one
   epoch of 32 steps in dispatches of 8, then the eval pass over the
   15 000 held-out rows); launch counters show the gather, both v1 cross
   kernels and the Adagrad kernel in training, the gather and the cross
   forward in the eval pass; the history is finite with auc and logloss;
   examples_per_s and the eval pass's time;
10. the proxy band of tests/test_golden.py on the card: ``dcn_criteo()``,
    300 000 examples, one epoch, AUC in [0.680, 0.715];
11. the trainer on the card against the CPU (plain versions): the proxy
    configuration, 8 steps from one state, each step's loss and the
    eval's auc and logloss;
12. config 1 (``trainer.run(mf_bpr_ml100k())``: MF + BPR on the
    synthetic_implicit stand-in at 943 x 1682, d=64, batch 2048, 60
    epochs, the full-catalog eval every 10 epochs at ks (10, 20, 50)):
    recall@20 and ndcg@20 in the band of tests/test_golden.py:69-76;
    launch counters show one gather and one Adagrad launch a step for the
    three tables, and one gather a batch of users in each eval pass;
    examples_per_s and the eval passes' times;
13. config 1 on the card against the CPU: 2 epochs from one state, each
    step's loss, recall@20 and ndcg@20;
14. MF at bench.py's shape (1 000 000 users and items, d=64, bpr, rowwise
    Adagrad at lr 0.05, 8 batches of 8192 uniform (user, pos, neg) from
    ``np.random.default_rng(0)``): launch counters; the loss finite and
    falling on a held batch; one step bit for bit on repeat and through the
    plain versions on the card; at 10 000 rows one step against the CPU;
    both kernels' times at this shape (3 tables: 8192, 16 384 and 16 384
    ids; D = 64, 64, 1) beside their bounds, plain versions and, for the
    gather, 3 ``index_select``; the step's median and device-busy share;
15. ``Recommender.recommend(users, k=100)`` for 1024 users over phase 14's
    1 000 000 items: ids and values those of a plain ``torch.matmul`` +
    ``torch.topk`` on the card (ties aside); latency (median, p99) and
    users/s; the product's and the top-k's device times beside their
    bounds; a profile of one call;
16. config 4's full band: ``trainer.run(dcn_criteo())`` whole (2M
    synthetic_ctr examples, 2 epochs), AUC and logloss in the band of
    tests/test_golden.py:109-112;
17. (A) config 2, ``trainer.run(fm_ctr_ml1m())`` (FM over the stand-in at
    ML-1M's shape with synthetic side fields: 6 fields, 12 tables, d=64,
    batch 4096, 20 epochs): AUC in its band (tests/test_golden.py:87-91);
    one gather and one Adagrad launch a step, one gather an eval pass;
    examples_per_s, each eval pass's time, the host's input time a batch,
    a step's median and profile;
18. (B) config 3, ``trainer.run(neumf_ml20m())`` (NeuMF over the stand-in,
    8192 x 4096, rowwise Adam, batch 8192, 20 epochs, the sampled eval of
    100 negatives a case): HR@10 and ndcg_sampled@10 in their band
    (tests/test_golden.py:79-84); one gather a step, one a batch of the
    sampled eval; examples_per_s, the eval passes' times, a step's profile
    and rowwise Adam's device time a step;
19. (C) configs 2 and 3 for 8 steps on the card against the CPU from one
    state: losses, AUC, and for config 3 HR@10, ndcg_sampled@10 and the
    number of cases whose rank differs;
20. (D) the gather kernel at FM's 12 and NeuMF's 4 tables and the Adagrad
    kernel at FM's 12, with a real batch's ids: one launch, bit for bit
    their plain versions and on repeat; a step of each repeats bit for bit
    (FM's also through the plain versions); times beside bounds, plain
    versions and ``index_select``;
21. (E) serving: NeuMF ``predict`` of 8192 pairs and ``recommend(users,
    k=10)`` for 1024 users over its 4096 items, FM ``predict_ctr`` of 8192
    6-field rows, each against a plain run on the card, one gather launch
    a call; latency (median, p99) and rates;
22. (F) Criteo files: a TSV in Criteo's line format of 500 000 lines from
    the seed (``synthetic_ctr``'s rows at Criteo's shape, ids as hex tokens,
    some fields empty, a few malformed lines); the native parser against
    the Python parser on the first 50 000 lines (ids and labels bit for
    bit, dense values each parser's own arithmetic, within 1 ulp) and its
    MB/s; ``dcn_criteo(path)`` trained at Criteo's shape materialized
    (``load_criteo``, the Python parser as in the reference, the file's
    first 200 000 lines) and streamed (``data.streaming``, 100 000 eval
    lines, a checkpoint after each of 2 epochs; the train stream through
    the native parser, asserted), one gather, v1 forward, v1 backward and
    Adagrad launch a step; 8 steps against the CPU;
23. (G) resume: the streamed run resumed from its epoch-1 checkpoint ends
    with its whole run's state bit for bit; the save and the restore of
    the Criteo-shaped state timed;
24. (H) ``Recommender.from_checkpoint`` serves that checkpoint:
    ``predict_ctr`` of 8192 requests bit for bit ``from_trainer``'s, one
    gather and one v1 forward launch;
25. (I) MovieLens files: ML-1M's ratings.dat, users.dat and movies.dat
    from the seed at 6040 users x 3706 items (~1M ratings); the native UIRT
    parser against the Python loop; ``fm_ctr_ml1m(path)`` with the side
    files for 1 epoch (one gather and one Adagrad launch a step, its AUC);
    NeuMF warm started from a 1-epoch GMF checkpoint (``init_from``);
26. (J) ``python -m tfrec_tpu_torch.cli --config dcn_criteo --data_path
    <F's file>`` as a process of its own on the file's first 100 000 lines,
    its last line parsed;
27. (K) the table layouts and duplicate combines: ``dcn_criteo`` at
    Criteo's shape (26 x 100 000, d=32, B=8192, Zipf(1.2) ids), 8
    ``multi_step`` steps from one state in each mode (per field, the 26
    tables' duplicates combined in one batched sort; lane-packed, 7 packs:
    ``gather_rows_multi`` at D = 128 and 64, the Adagrad kernel on the
    packs' lane groups as rows, G = 4 and 2; stacked, one [2 600 000, 32]
    table of 212 992 ids a step; the host's dedup sorts, each table's
    combine alone), each bit for bit the per-field run (losses, tables,
    accumulators), its launches counted; each
    mode's step median (host clock, in turns), device-busy share and
    kernels a step; the host's sorts of a batch; the gather and Adagrad
    kernels at the packed and stacked shapes, bit for bit their plain
    versions and on repeat, beside their bounds, plain versions and
    ``index_select``. Then ``trainer.run(fm_ctr_ml1m())`` with
    ``model.lane_pack=True`` for 2 of its 20 epochs (3 packs of 2 fields and
    ``linpack_0``, G = 2 and 6): each epoch's loss bit for bit phase 17's
    per-field run's, one gather and one Adagrad launch a step, the kernels
    at its shapes; its checkpoint
    resumed under ``lane_pack=None`` (the saved layout taken) bit for bit,
    and served by ``from_checkpoint`` packed and per field;
28. (L) config 5, the row-sharded tables: (L1) ``ShardedTrainStepBuilder``
    for ``dcn_multihost`` at Criteo's shape at world 1 over NCCL (the
    exchange an identity; dedup, bucketing, the collectives, the owner's
    gather and update all real), 8 steps of 8192 Zipf(1.2) ids from the
    single-device init: at the f32 wire within the tolerance of
    tests/test_parallel.py:205-208 of the single-device step on every
    table, accumulator and dense leaf (it reads bit for bit), repeating
    bit for bit, no id dropped, one owner gather, Adagrad, v1 forward and
    backward launch a step and 5 NCCL calls; the bf16 wire's losses
    within 1e-3 of the f32 wire's; host medians in turns and profiles
    beside the single-device step's; the gather and Adagrad kernels at the
    owner's shapes, bit for bit their plain versions and on repeat,
    beside their bounds, plain versions and ``index_select``. (L2)
    ``trainer.run(dcn_multihost())`` whole (2M synthetic examples, 2
    epochs) on 2 ranks sharing the card over gloo, a process each
    (``chip_smoke.py --sharded-rank``, started and stopped by the phase):
    config 4's full band, the ranks' histories the same, a checkpoint an
    epoch, launches counted on each rank; examples/s, which is no scaling
    figure. (L3) ``Recommender.from_checkpoint`` serves the ranks' last
    checkpoint on one card: ``predict_ctr`` bit for bit the restored
    single-device forward, its AUC within 1e-3 of the ranks' last eval.
29. (M) config 5's column-sharded tables and retrieval on a mesh, ranks
    sharing the card over gloo (``chip_smoke.py --mesh-rank``, a process
    each, started and stopped by the phase): (M1) ``dcn_multihost`` at
    Criteo's shape with ``table_sharding="col"`` on a (1, 2) mesh (26
    blocks [100000, 16] a rank), 8 steps of 8192 Zipf(1.2) ids from the
    single-device init: each col step taken from the single-device run's
    state within the tolerance of L1 of the single-device step (tables,
    accumulators, dense leaves, loss), the free run's losses within it
    (its tables and dense leaves reported), one gather launch a step a
    rank for the 26 column blocks, both v1 kernels, no Adagrad kernel (the
    reference's XLA route), no id dropped; host median, busy share and
    collectives a step. (M2) ``trainer.run(mf_bpr_ml100k())`` whole on a
    (2, 1) mesh, its eval through ``ShardedRetrievalEvaluator``: config
    1's band, the owner's gather and Adagrad launch a step and a user
    gather an eval batch on each rank; ``Recommender.from_trainer`` on the
    live state equal to one card's ``recommend``. (M3) ``recommend`` of
    1024 users, k=100, over 1M items at d=64 (build_topk_bench's shape) on
    a (2, 1) mesh from the live sharded state: ids equal to the single
    card's where untied, values within 1e-5; both latencies and each
    rank's ``torch.topk`` of [1024, 500000]. (M4) MF under col sharding on
    a (2, 2) mesh of 4 ranks, 2 epochs: its checkpoint served on one card
    by ``from_checkpoint`` gives the live mesh's top-k.
30. (N) the rest of the CTR zoo and the sequential zoo: (N1) DeepFM, Wide &
    Deep, NFM and DLRM at dcn_criteo's Criteo shape (DeepFM, W&D and NFM
    with 26 linear tables beside the fields: 52 tables), each serving 4
    batches of 8192 through ``predict_ctr`` (one gather launch a batch,
    against the plain versions and the CPU) and training 8 steps of 8192
    Zipf(1.2) ids (one gather and one Adagrad launch a step, the held loss
    falling; one step bit for bit on repeat and against the CPU at
    STEP_RTOL / STEP_ATOL, the linear tables' update held apart from its
    input); the gather and Adagrad kernels at the 52 tables; host medians,
    busy shares, kernels a step; ``trainer.run(dcn_criteo())`` as DLRM and
    as DeepFM at phase 10's proxy size (AUC above 0.5, no band exists).
    (N2) ``trainer.run`` of sasrec_ml1m and caser_ml1m whole (their bands)
    and gru4rec_ml1m for 1 of its 60 epochs (a falling loss), each saving a
    checkpoint; one gather launch a step and one an eval batch; serving
    ``predict`` and ``recommend`` from the trainer and from the checkpoint,
    bit for bit; the first step at dropout 0 against the CPU; the gather at
    each step's shape (51 072 ids of [3706, 64] for SASRec and GRU4Rec);
    examples/s, host medians, busy shares, kernels and copies a step.
31. (O) the history zoo and the graph zoo: (O1) ``trainer.run`` of
    fism_ml100k, nais_ml100k, multvae_ml100k and cdae_ml100k whole and of
    Mult-DAE (multvae_ml100k, ``model.name=multdae``) on the stand-in at
    ML-100K's shape (943 x 1682), each saving a checkpoint: recall@20 in
    the range of the JAX package's own runs at QUALITY_BANDS.json's seeds
    (JAX_RECALL20; no band exists), one gather and one Adagrad launch a
    step and one gather a batch of eval users; ``predict`` and
    ``recommend`` for 256 users from the trainer and from the checkpoint
    bit for bit; one step at dropout 0 against the CPU; the gather and
    Adagrad kernels at FISM's step (65 536 history ids of [1682, 64], pads
    among them) and Mult-VAE's (16 384 of [1682, 256]) against their plain
    versions, with their times. (O2) lightgcn and ngcf (d=64, 3 layers) on
    mf_bpr_ml100k()'s data and protocol: no kernel launched (the embeddings
    are dense params), the propagation and a step bit for bit on repeat,
    one step against the CPU, serving from the checkpoint.
32. (P) the long tail, each saving a checkpoint: (P1) ``trainer.run`` of
    sbpr_ml100k (the taste-overlap trust graph, SBPRSampler's triples),
    apr_ml100k and irgan_ml100k whole at ML-100K's shape: recall@20 in
    IRGAN's band of tests/test_golden.py:164-165 and, for SBPR and APR, in
    the range of QUALITY_BANDS.json's three seeds widened by 5% of their
    mean; one gather and one Adagrad launch a step (IRGAN's six tables, a
    pool of 16 items a row), one gather a batch of eval users; the first
    step against the CPU (IRGAN's Gumbel draw one host draw on both
    devices); the gather and Adagrad kernels at IRGAN's and SBPR's steps.
    (P2) wrmf_ml100k whole (15 ALS sweeps, its exact objective falling at
    each) and ease_ml100k (one Cholesky solve): their bands of
    tests/test_golden.py:166-170; no launch in training; one sweep and the
    solve against the CPU; the gather at EASE's ``predict`` ([1682, 1682]
    rows, the kernel's float route). (P3) Pop and ConvNCF (d=64, 32
    channels, CONVNCF_EPOCHS epochs, no l2) on mf_bpr_ml100k()'s data and
    protocol: recall@20 in the JAX package's range (JAX_RECALL20); Pop's
    catalog gathers nothing. (P4) ``evaluate_dot_native`` over WRMF's
    tables against the device evaluator. Each model served from the trainer
    and from its checkpoint, bit for bit.
33. (Q) the rest of the sharded subsystem, int8 serving, step profiles and
    the matmul precision: (Q1) the lane-sliced step at world 1 over NCCL,
    ``dcn_criteo`` at Criteo's shape with ``model.lane_pack=True`` (7 packs
    of 4 fields), 8 steps of 8192 against the single-device packed step at
    the reference's tolerance, the wire's float buffers d lanes wide, the
    gather and Adagrad kernels at the owner's [rps·G, d] view shapes; in
    phase M4's spawn of 4 ranks sharing the card over gloo, after M4 (so 4
    ranks start once), (Q2) the port's ``dryrun_multichip`` modes (gspmd
    said not ported), (Q3) FSDP bit for bit the replicated dense params at
    ``dcn_criteo``'s full width, with the dense bytes a rank, and (Q4)
    IRGAN's sharded steps against one card's; (Q5) ``recommend`` with
    ``quantize=True`` at 1024 users over 1M items, k=100: the int8 table's
    bytes, its top-k a plain top-k of its own scores, the overlap with the
    f32 top-k, peak memory and latency beside the f32 call's; (Q6) config
    4's proxy run profiled over one dispatch, its trace holding that
    dispatch and its gather kernels; (Q7) the proxy run again at
    ``train.matmul_precision="bfloat16"`` in the proxy band, its step time
    beside "default"'s.

So that the whole script stays inside its time limit with phase O, three
earlier paths are cut in depth, each keeping its checks: phase K's
lane-packed config 2 runs 2 of its 20 epochs (FM_PACKED_EPOCHS: its losses
are held bit for bit to phase 17's per-field run, which PR 13 showed it to
be), phase I's FM over the files 1 epoch (FM_FILES_EPOCHS) and phase J's
CLI 100 000 lines (CLI_LINES). Phase N runs gru4rec_ml1m for 1 of its 60
epochs (SEQ_EPOCHS; PERF.md gives its whole run's time on an H100). With
phase P, two more measurements are cut, their checks whole: the zoo phases'
serving latencies take 10 calls, not 50 (ZOO_LATENCY_CALLS; ConvNCF's
`recommend` takes ~0.24 s a call), and phase N's sequential models meet the
CPU for their first step, not their first 2 (SEQ_CPU_STEPS; GRU4Rec's
199-step loop on the CPU).
The last lines are the kernels' JSON record (the v2 records carry the general route's shapes as ``general_route``, the gather
and Adagrad records their times at MF's shape as ``mf_bench`` and at
FM's and NeuMF's as ``fm`` and ``neumf``, and ``launches_by_path`` the
trainers', MF's and configs 2 and 3's paths: ``trainer_mf`` phase 12,
``train_mf`` phase 13's card run, ``bench_mf`` phase 14's 8 steps,
``serve_mf`` phase 15's first call, ``trainer_fm`` and ``trainer_neumf``
phases 17 and 18, ``serve_neumf`` and ``serve_fm`` phase 21's first
calls, ``trainer_criteo_file`` phase F's streamed run, ``serve_ckpt``
phase H's first call, ``trainer_fm_files`` phase I's FM run, and phase
K's ``layouts_<mode>``, ``trainer_fm_packed`` and ``serve_fm_packed``;
the gather and Adagrad records carry phase K's shapes as ``dcn_packed``,
``dcn_stacked`` and ``fm_packed``, and ``fused_rowwise_adagrad_multi_
grouped`` is the Adagrad kernel on lane-grouped tables, its launches the
Adagrad launches of phase K's packed paths; phase L adds ``train_sharded``
(L1's counted run) and ``trainer_sharded`` (L2, both ranks' launches
summed) to ``launches_by_path``, and its shapes to the gather and Adagrad
records as ``sharded``; phase M adds ``train_col`` (M1), ``trainer_mesh_mf``
(M2), ``serve_mesh_mf`` (M3's first call) and ``trainer_col_mf`` (M4),
every rank's launches summed; phase N adds ``serve_<model>``,
``train_<model>`` and ``trainer_<model>`` for its models (DLRM's among them
the interaction kernels' launches), and its shapes to
the gather record as ``deepfm_52``, ``sasrec_ml1m``, ``caser_ml1m`` and
``gru4rec_ml1m`` and to the Adagrad record as ``deepfm_52``; phase O adds
``trainer_<model>`` and ``serve_<model>`` for its seven models, and its
steps' shapes to the gather and Adagrad records as ``fism_step`` and
``multvae_step``; phase P adds ``trainer_<model>`` and ``serve_<model>``
for its seven models, its steps' shapes to the gather and Adagrad records
as ``irgan_step`` and ``sbpr_step``, and EASE's predict to the gather
record as ``ease_predict``; phase Q adds ``train_lane_sliced`` (Q1, also
among the grouped Adagrad record's paths), ``dryrun_4_ranks``,
``train_fsdp`` and ``train_irgan_sharded`` (Q2-Q4, every rank's launches
summed), ``serve_int8`` (Q5), ``trainer_profiled`` (Q6) and
``trainer_proxy_bf16`` (Q7), and Q1's owner shapes to the gather and
Adagrad records as ``lane_sliced``), the script's whole time, and
``{"ok": true, ...}``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tfrec_tpu_torch import convert, zoo_configs
from tfrec_tpu_torch.data import criteo as criteo_data
from tfrec_tpu_torch.data import criteo_native, movielens
from tfrec_tpu_torch.data.synthetic import _zipf_ids, synthetic_ctr, synthetic_implicit
from tfrec_tpu_torch.kernels import _build
from tfrec_tpu_torch.kernels.adagrad_cuda import (
    fused_rowwise_adagrad,
    fused_rowwise_adagrad_multi,
    fused_rowwise_adagrad_multi_ref,
    fused_rowwise_adagrad_ref,
)
from tfrec_tpu_torch.kernels.cross import cross_stack_ref
from tfrec_tpu_torch.kernels.cross_cuda import (
    cross_v1_bwd,
    cross_v1_bwd_ref,
    cross_v1_fwd,
    cross_v1_fwd_ref,
)
from tfrec_tpu_torch.kernels.cross_v2_cuda import (
    _fwd_route,
    cross_v2_bwd,
    cross_v2_bwd_ref,
    cross_v2_fwd,
    cross_v2_fwd_ref,
)
from tfrec_tpu_torch.kernels.gather_cuda import (
    gather_rows,
    gather_rows_multi,
    gather_rows_multi_ref,
    gather_rows_ref,
)
from tfrec_tpu_torch.kernels.interaction_cuda import (
    dot_interaction_bwd,
    dot_interaction_bwd_ref,
    dot_interaction_fwd,
    dot_interaction_fwd_ref,
)
from tfrec_tpu_torch.configs import MeshConfig, OptimConfig
from tfrec_tpu_torch.eval.native import evaluate_dot_native
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.models.mf import MF
from tfrec_tpu_torch.ops import sparse_optim
from tfrec_tpu_torch.ops.embedding import combine_duplicate_ids
from tfrec_tpu_torch.ops.precision import set_matmul_precision
from tfrec_tpu_torch.parallel import dryrun
from tfrec_tpu_torch.parallel import embedding as sharded_embedding
from tfrec_tpu_torch.parallel.mesh import init_distributed, make_mesh
from tfrec_tpu_torch.parallel.step import ShardedTrainStepBuilder
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train import trainer as trainer_mod
from tfrec_tpu_torch.train.step import TrainStepBuilder, copy_state, host_dedup_sorts, tree_leaves
from tfrec_tpu_torch.train.trainer import Trainer, run
from tfrec_tpu_torch.utils import checkpoint

SEED = 0
DEVICE = "cuda"
BATCH = 8192
NUM_BATCHES = 4
V2_RANK = 64  # the DCN-v2 phases' cross_rank
# H100 SXM peaks (NVIDIA data sheet), at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12  # dense, on the tensor cores
# Reordered f32 row dots and products (the v2 kernels sum over d = 845, and
# over 8192 rows for dU, dV and db, in another fixed order than cuBLAS): the
# error scales with the size of the terms, not of the sum, so the absolute
# tolerance is relative to the largest value.
RTOL = 1e-5
ATOL_REL = 1e-5
# Logits add the cross output's error over a head of d + 128 inputs.
LOGIT_TOL = 1e-4
# One train step on the card against the CPU. Every matmul sums in another
# order (cuBLAS against the CPU's BLAS, over a batch of 8192), so the
# gradients are held to 1e-4 of their largest value. A ReLU input that lies
# within that rounding of 0 can fall on the other side on the other device:
# its example's gradient then differs by a finite amount (2 of 8192
# examples in the measured batch). Such flips are found and checked to lie
# within rounding of 0; the rows the flipped examples touch are reported,
# and every other row is held tightly: a table moves by lr * g / rms(g)
# (up to ~0.1), its error is the rounding of g relative to its row.
GRAD_TOL = 1e-4
FLIP_TOL = 10  # a flipped ReLU input is within 10x the largest input error of 0
MAX_FLIPPED = 0.01  # of the batch's examples
TABLE_TOL = 1e-6
ACC_RTOL = 1e-4
LOSS_RTOL = 1e-5
# The trainer on the card against the CPU over 8 steps from the same state:
# the same sums in other orders, through Adam's normalised first update
# (whose sign a gradient within rounding of 0 can flip) and the ReLU flips
# above, carried through 8 steps. AUC over 15 000 held-out rows. An H100
# read 4.4e-6 on the losses, 6e-7 on AUC and 9e-7 on logloss (PERF.md): the
# limits sit about 20x above that.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_AUC_ATOL = 1e-4
TRAIN_LOGLOSS_RTOL = 1e-4
PROXY_AUC_BAND = (0.680, 0.715)  # tests/test_golden.py:94-108
# Config 1 (MF + BPR on the synthetic_implicit stand-in at ML-100K's shape):
# its band (tests/test_golden.py:69-76), and the card against the CPU over 2
# epochs from one state. Losses: the same sums in other orders through the
# rowwise Adagrad's normalised updates, over 46 steps. recall@20 and
# ndcg@20 over ~943 users: one exchanged rank moves recall@20 by ~1e-4.
CONFIG1_BAND = {"recall@20": (0.118, 0.134), "ndcg@20": (0.102, 0.133)}
CONFIG1_LOSS_RTOL = 1e-4
CONFIG1_METRIC_ATOL = 1e-3
# bench.py's MF shape (build_mf_bench, bench.py:254-279): 1 000 000 users and
# items, d=64, bpr, rowwise Adagrad at lr 0.05, 8 batches of 8192 uniform
# (user, pos, neg); the top-k of build_topk_bench (bench.py:169, :637):
# 1024 users, k=100 over the 1 000 000 items. The card against the CPU at
# 10 000 rows: one step's loss and tables (products of d=64 summed in
# another order, through the normalised update).
MF_ROWS = 1_000_000
MF_DIM = 64
MF_CPU_ROWS = 10_000
MF_CPU_RTOL = 1e-5
TOPK_USERS = 1024
TOPK_K = 100
# Configs 2 and 3 on their seeded stand-ins (tests/test_golden.py:79-91) and
# config 4's full band (2M synthetic_ctr examples, 2 epochs;
# tests/test_golden.py:109-112).
CONFIG2_AUC_BAND = (0.705, 0.735)
CONFIG3_BAND = {"hr@10": (0.265, 0.298), "ndcg_sampled@10": (0.125, 0.157)}
CONFIG4_BAND = {"auc": (0.8424, 0.8492), "logloss": (0.478, 0.492)}
# Configs 2 and 3 on the card against the CPU over 8 steps from one state:
# the same sums in other orders through the normalised rowwise updates
# (Adagrad's for FM, Adam's for NeuMF) and Adam's first dense steps. The
# sampled eval counts strict wins of a negative over the positive, so a
# near-tie that rounds the other way on the other device moves a case's
# rank by one: such cases are counted, bounded, and each moves HR@k and
# NDCG@k by at most 1/cases.
CONFIG23_LOSS_RTOL = 1e-4
CONFIG23_AUC_ATOL = 1e-4
CONFIG3_MAX_RANK_FLIPS = 0.01  # of the eval's cases
SERVE_USERS = 1024  # recommend's users for NeuMF, k=10 over the 4096 items
SERVE_K = 10
# Phases F-J: the data files written from the seed (Criteo's line format at
# its shape; ML-1M's at 6040 users x 3706 items, ~1M ratings), under the
# checkout's build/ (gitignored), removed at the end.
DATA_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_data"
CRITEO_LINES = 500_000
CRITEO_CHECK_LINES = 50_000  # read by both parsers
CRITEO_MALFORMED_EVERY = 10_007
# Materialized runs read the file with the Python parser (``load_criteo``, as
# the reference does; ~82 us a line on the card's host), so they take its
# first lines only; the streamed runs read it all through the native parser.
CRITEO_MATERIALIZED_LINES = 200_000
CRITEO_CARD_VS_CPU_LINES = 100_000  # 8 steps of 8192 and the held-out 5%
# The CLI's process reads the file's first CLI_LINES lines, one dispatch of
# dcn_criteo's 8 steps of 8192 and the held-out 5% (phase F trains on more):
# it checks the process and its last line, not the model.
CLI_LINES = CRITEO_CARD_VS_CPU_LINES
CLI_OVERRIDES = ["train.epochs=1", f"data.num_examples={CLI_LINES}"]
FM_FILES_EPOCHS = 1  # phase I's FM over ML-1M's files
STREAM_EVAL_EXAMPLES = 100_000  # the streamed run's held-out first lines
ML1M_USERS, ML1M_ITEMS, ML1M_PER_USER = 6040, 3706, 165
# Phase L, config 5 (row-sharded tables): the sharded step at world 1 over
# NCCL against the single-device step (f32 wire) at the tolerance of
# tests/test_parallel.py:205-208, and its bf16 wire's losses against the
# f32 run's; then ``trainer.run(dcn_multihost())`` on 2 ranks sharing the
# card over gloo, in config 4's band (QUALITY_BANDS.json gives
# dcn_multihost the same band as dcn_criteo); then its checkpoint served
# on one card, whose AUC (the f32 lookup) lies within 1e-3 of the ranks'
# last eval (through the bf16 wire).
SHARDED_RTOL, SHARDED_ATOL = 2e-4, 1e-5
SHARDED_BF16_LOSS_ATOL = 1e-3
# The collectives of a sharded step: the id and row exchanges, the
# overflow's sum, the dense gradients' and loss's mean, the gradient
# exchange (the update reuses the lookup's route).
SHARDED_CALLS_A_STEP = 5
SHARDED_RANKS = 2
SHARDED_RANK_TIMEOUT_S = 480
SHARDED_SERVE_AUC_ATOL = 1e-3
# Phase M, config 5's column-sharded tables and retrieval on a mesh: the col
# step against the single-device step at phase L1's tolerance; top-k ids
# equal where untied and values within 1e-5 relative (the products of a
# block and of the whole table may round apart); each spawn of ranks within
# its time limit.
MESH_VALUE_RTOL = 1e-5
MESH_RANK_TIMEOUT_S = 420
# Phase Q: the lane-sliced step against the single-device packed step at the
# reference's tolerance (tests/test_lane_pack.py:336-353); 4 ranks sharing
# the card for the dry run, FSDP and IRGAN (3 steps each), IRGAN's sharded
# steps against one card's at the 3-step tolerance of
# tests/test_torch_social_adv_zoo.py (the global batch's sums split over 4
# ranks); int8 serving's top-k against a plain top-k of its own scores
# (the scale applied after the product or before it rounds apart), and its
# least overlap with the f32 top-k (about 0.7% of a score's spread moves
# with the rounding, against gaps of about 2.5% at rank 100 of 1M); the
# profile window, one dispatch of 8 steps.
LANE_RTOL, LANE_ATOL = 1e-5, 1e-6
REST_RANKS = 4
REST_STEPS = 3
IRGAN_RTOL, IRGAN_ATOL = 1e-4, 1e-5
IRGAN_ADAGRAD_INIT = 0.1
QUANT_RTOL = 1e-5
QUANT_MIN_OVERLAP = 0.8
PROFILE_WINDOW = (8, 16)
# Phase N: the rest of the CTR zoo at Criteo's shape (its steps against the
# CPU as phase 6 holds DCN's, at tests/test_torch_layouts.py's step
# tolerance), and the sequential zoo on the card, in the bands of
# tests/test_golden.py:149-150 and :184-186. GRU4Rec runs SEQ_EPOCHS' 1 of
# its 60 epochs, held to a falling loss and to the CPU instead of its band:
# its 199-step loop takes ~165 ms a step (8930 kernels and copies), and the
# whole run, 564 s on the H100 (PERF.md), would take the script past its
# time limit. Their first steps at dropout 0 against the CPU: the same sums
# in other orders through rowwise and dense Adam, at the same tolerance.
CTR_ZOO = ("deepfm", "widedeep", "nfm", "dlrm")
SEQ_BANDS = {"sasrec_ml1m": {"recall@20": (0.045, 0.067), "ndcg@20": (0.019, 0.029)},
             "caser_ml1m": {"recall@20": (0.028, 0.050)},
             "gru4rec_ml1m": {"recall@20": (0.040, 0.060)}}
SEQ_EPOCHS = {"gru4rec_ml1m": 1}
SEQ_CPU_STEPS = 1  # the first step: GRU4Rec's 199-step loop is slow on the CPU
SEQ_SERVE_K = 20
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
# Phase K's config 2 lane-packed run: its first FM_PACKED_EPOCHS of config
# 2's 20 epochs, each loss bit for bit phase 17's per-field run's (the init
# is layout-invariant and every layout's step the per-field step's, PR 13).
FM_PACKED_EPOCHS = 2
# Phase O: the history zoo (its four zoo configs whole, and Mult-DAE as
# multvae_ml100k with model.name=multdae) and the graph zoo (lightgcn and
# ngcf, d=64, 3 layers, on mf_bpr_ml100k's data and protocol). No band
# exists for them (QUALITY_BANDS.json predates them), so recall@20 is held
# to the JAX package's own run() of each on the CPU at QUALITY_BANDS.json's
# seeds (train.seed 42, 143, 244; the card runs the configs' seed, 42):
#   python benchmarks/quality_bands.py --configs fism_ml100k,nais_ml100k --out F
#   python benchmarks/quality_bands.py --configs multvae_ml100k,cdae_ml100k --out F
#   python benchmarks/quality_bands.py --configs multvae_ml100k --override model.name=multdae --out F
#   python benchmarks/quality_bands.py --configs mf_bpr_ml100k --override model.name=lightgcn --out F
#   python benchmarks/quality_bands.py --configs mf_bpr_ml100k --override model.name=ngcf --out F
# The card's value must lie in [min - 5% of the mean, max + 5% of the mean]
# of them and above 3x the random ranking's 20/1682.
JAX_RECALL20 = {
    "fism": (0.1142629864107134, 0.1127606914758935, 0.11390950596345191),
    "nais": (0.04551078153187498, 0.060091906615304794, 0.04498055934400346),
    "multvae": (0.1251325617413, 0.12407211028632026, 0.12142099479602478),
    "cdae": (0.11744432459454016, 0.11709084819255679, 0.11550017202140671),
    "multdae": (0.09756097156447797, 0.09208200845081252, 0.09022622598949445),
    "lightgcn": (0.1147048420263879, 0.11337928731519875, 0.1142629864107134),
    "ngcf": (0.10410038208784506, 0.10560268511322118, 0.10162601693437562),
}
# Phase P's: SBPR's and APR's are QUALITY_BANDS.json's (the same runs); Pop's
# and ConvNCF's from
#   python benchmarks/quality_bands.py --configs mf_bpr_ml100k --override model.name=pop --out F
#   python benchmarks/quality_bands.py --configs mf_bpr_ml100k --override model.name=convncf \
#     --override model.l2_reg=0.0 --override train.epochs=5 --override train.eval_every_epochs=5 \
#     --override train.eval_user_batch=64 --out F
JAX_RECALL20.update({
    "sbpr": (0.11337928326992064, 0.11117002541793872, 0.11267231833011955),
    "apr": (0.11408625023236077, 0.11452810180275716, 0.11329091012414667),
    "pop": (0.11479321517216186, 0.1143513575338483, 0.11479321112688375),
    "convncf": (0.11152350384256114, 0.11567691780729486, 0.10949098469723068),
})
RECALL20_MARGIN = 0.05
RANDOM_RECALL20 = 20 / 1682
HISTORY_ZOO = ("fism", "nais", "multvae", "cdae")
GRAPH_ZOO = ("lightgcn", "ngcf")
ZOO_SERVE_USERS = 256
ZOO_LATENCY_CALLS = 11  # the zoo phases' serving latency: a warm-up and 10 timed calls

# Phase P, the long tail. Golden bands of tests/test_golden.py:164-170
# (recall@20); SBPR's, APR's, Pop's and ConvNCF's recall@20 are held to
# JAX_RECALL20 (SBPR's and APR's runs are QUALITY_BANDS.json's).
TAIL_BANDS = {"irgan": (0.070, 0.087), "wrmf": (0.063, 0.072), "ease": (0.105, 0.116)}
TAIL_SGD = ("sbpr", "apr", "irgan")
TAIL_CLOSED = ("wrmf", "ease")
TAIL_BASELINES = ("pop", "convncf")
# ConvNCF on config 1's protocol but without its l2 of 0.03, under which the
# conv stack collapses to a constant score (loss ln 2, every item tied:
# recall@20 0.0087, in the JAX package too); without it recall@20 peaks
# near epoch 5 and then falls as it overfits (tools/convncf_sweep.py).
CONVNCF_EPOCHS = 5  # of mf_bpr_ml100k's 60, its eval after the last
CONVNCF_EVAL_USERS = 64  # a batch of the eval: [64 * 128, 32, 32, 32] f32 for the first map
ALS_RTOL, ALS_ATOL, ALS_OBJ_RTOL = 1e-4, 1e-6, 1e-5  # tests/test_torch_closed_form.py
EASE_RTOL, EASE_ATOL = 1e-4, 1e-6
NATIVE_RTOL, NATIVE_ATOL = 1e-5, 1e-6  # tests/test_native_eval.py:39-68

# The kernels of the main paths. The gather and Adagrad kernels run there
# as one launch over every table (the ``_multi`` wrappers); their one-table
# wrappers launch the same kernels and are counted, and timed, beside them.
KERNELS = {
    "gather_rows_multi": {
        "source": "tfrec_tpu_torch/kernels/csrc/gather.cu",
        "replaces": "tfrec_tpu/kernels/gather_pallas.py:89",
    },
    "cross_v1_fwd": {
        "source": "tfrec_tpu_torch/kernels/csrc/cross.cu",
        "replaces": "tfrec_tpu/kernels/cross_pallas.py:123",
    },
    "cross_v1_bwd": {
        "source": "tfrec_tpu_torch/kernels/csrc/cross.cu",
        "replaces": "tfrec_tpu/kernels/cross_pallas.py:157",
    },
    "fused_rowwise_adagrad_multi": {
        "source": "tfrec_tpu_torch/kernels/csrc/adagrad.cu",
        "replaces": "tfrec_tpu/kernels/scatter_pallas.py:182",
    },
    "cross_v2_fwd": {
        "source": "tfrec_tpu_torch/kernels/csrc/cross_v2.cu",
        "replaces": "tfrec_tpu/kernels/cross_pallas.py:299",
    },
    "cross_v2_bwd": {
        "source": "tfrec_tpu_torch/kernels/csrc/cross_v2.cu",
        "replaces": "tfrec_tpu/kernels/cross_pallas.py:342",
    },
    # The Adagrad kernel on lane-packed tables ([V, G] accumulators, taken
    # as [V*G, d] rows): fused_rowwise_adagrad_multi's launches on the
    # packed paths (GROUPED_PATHS).
    "fused_rowwise_adagrad_multi_grouped": {
        "source": "tfrec_tpu_torch/kernels/csrc/adagrad.cu",
        "replaces": "tfrec_tpu/kernels/scatter_pallas.py:182",
    },
    # DLRM's dot interaction: no Pallas site (the reference's einsum in
    # tfrec_tpu/models/dlrm.py, left to XLA).
    "dot_interaction_fwd": {
        "source": "tfrec_tpu_torch/kernels/csrc/interaction.cu",
        "replaces": "none (tfrec_tpu/models/dlrm.py's einsum)",
    },
    "dot_interaction_bwd": {
        "source": "tfrec_tpu_torch/kernels/csrc/interaction.cu",
        "replaces": "none (tfrec_tpu/models/dlrm.py's einsum)",
    },
}
GROUPED = "fused_rowwise_adagrad_multi_grouped"
GROUPED_PATHS = ("layouts_lane_packed", "trainer_fm_packed", "train_lane_sliced")
WRAPPERS = {"gather_rows_multi": gather_rows_multi, "gather_rows": gather_rows,
            "cross_v1_fwd": cross_v1_fwd, "cross_v1_bwd": cross_v1_bwd,
            "fused_rowwise_adagrad_multi": fused_rowwise_adagrad_multi,
            "fused_rowwise_adagrad": fused_rowwise_adagrad,
            "cross_v2_fwd": cross_v2_fwd, "cross_v2_bwd": cross_v2_bwd,
            "dot_interaction_fwd": dot_interaction_fwd, "dot_interaction_bwd": dot_interaction_bwd}
# DLRM's dot interaction at the benchmark's DLRM cell (dlrm_criteo_tb): a
# batch of 32 768, the bottom output and 26 fields of d = 128.
INTERACTION_SHAPE = (32768, 27, 128)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item() if a.numel() else 0.0


def states_equal(a, b) -> bool:
    """Two train states (or any trees of tensors and numbers) bit for bit."""
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def within(got: torch.Tensor, want: torch.Tensor, rtol: float, atol_rel: float) -> bool:
    atol = atol_rel * max(want.abs().max().item(), 1.0)
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _per_call_ms(run, calls: int, reps: int) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(fn, calls: int, reps: int = 7) -> float:
    """Device time per call: ``fn`` (``calls`` calls) is captured once in a
    CUDA graph, and the graph is replayed between two CUDA events, so host
    dispatch does not enter the time. Median over ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture: allocator pools, library handles
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return _per_call_ms(graph.replay, calls, reps)


def dispatch_ms(fn, calls: int, reps: int = 7) -> float:
    """Time per call when the host issues the calls one after another:
    where the device waits for the host, this is the host's cost a call."""
    fn()
    torch.cuda.synchronize()
    return _per_call_ms(fn, calls, reps)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gather_bound_ms(tables, field_ids) -> tuple[float, str]:
    """The gather's bound by bytes: each table's distinct rows that its ids
    reach (clamped into the table, as the kernel reads them) read once, each
    gathered row written once and each id read once. Where ids repeat (a
    history's items, Zipf ids), a row read again comes from L2, not HBM."""
    nbytes = 0
    for t, i in zip(tables, field_ids):
        row = t.shape[1] * t.element_size()
        distinct = torch.unique(i.clamp(0, t.shape[0] - 1)).numel()
        nbytes += distinct * row + i.numel() * (row + i.element_size())
    return bound_ms(nbytes, 0)


def tensor_core_bound_ms(nbytes: float, tf32_ops: float, f32_ops: float) -> tuple[float, str]:
    """The bound of a kernel whose products run on the tensor cores in TF32
    and the rest on the CUDA cores in f32: the operations' times add."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = tf32_ops / TF32_OPS_PER_S + f32_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def v1_fwd_bound(bsz: int, dim: int, layers: int) -> tuple[float, str]:
    """x0 read, x_L written, w and b; a row dot and 3 elementwise steps."""
    return bound_ms(bsz * dim * 4 * 2 + 2 * layers * dim * 4, 5 * layers * bsz * dim)


def v1_bwd_bound(bsz: int, dim: int, layers: int) -> tuple[float, str]:
    """x0 and g read, dx0 written, s, w and b read, dw and db written."""
    return bound_ms(3 * bsz * dim * 4 + bsz * layers * 4 + 4 * layers * dim * 4, 12 * layers * bsz * dim)


def v2_fwd_bound(bsz: int, dim: int, rank: int, layers: int, saved: bool) -> tuple[float, str]:
    """x0 read, x_L written, U, V and b read (and, when training, f and xv
    written); per layer two products, each 3xTF32 on the tensor cores
    (three TF32 products for one f32 product), and 3 elementwise operations
    an element (f + b, x0 * f, + x) on the CUDA cores."""
    nbytes = (2 * bsz * dim + 2 * layers * dim * rank + layers * dim) * 4
    if saved:
        nbytes += layers * (bsz * dim + bsz * rank) * 4
    return tensor_core_bound_ms(nbytes, 3 * layers * 4 * bsz * dim * rank, layers * 3 * bsz * dim)


def v2_bwd_bound(bsz: int, dim: int, rank: int, layers: int) -> tuple[float, str]:
    """In: x0, g, f, xv, U, V; out: dx0, dU, dV, db. Per layer: 4 products,
    each 3xTF32 on the tensor cores, and ~7 elementwise operations an
    element (df, db, g*f, dx0, g, x_l) on the CUDA cores."""
    nbytes = ((2 + layers) * bsz * dim + layers * bsz * rank + 2 * layers * dim * rank
              + bsz * dim + 2 * layers * dim * rank + layers * dim) * 4
    return tensor_core_bound_ms(nbytes, 3 * layers * 8 * bsz * dim * rank, layers * 7 * bsz * dim)


def kernel_times_us(fn) -> dict:
    """Device time by kernel name over one call of ``fn`` (the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def edge_case_ids(rng, vocab: int, n: int) -> np.ndarray:
    """Real ids with duplicates, negatives and sentinels (>= vocab)."""
    ids = rng.integers(0, vocab, n).astype(np.int32)
    ids[:8] = [vocab, vocab + 3, -1, -7, 0, vocab - 1, 5, 5]
    return ids


def make_requests(rng, vocabs, num_dense: int):
    """Seeded request batches; ~0.5% sentinel and ~0.5% negative ids."""
    out = []
    for _ in range(NUM_BATCHES):
        dense = rng.normal(size=(BATCH, num_dense)).astype(np.float32)
        cat = np.stack([rng.integers(0, v, BATCH) for v in vocabs], 1).astype(np.int32)
        flip = rng.random(cat.shape)
        cat[flip < 0.005] = np.array(vocabs, np.int32)[np.nonzero(flip < 0.005)[1]]
        cat[(flip >= 0.005) & (flip < 0.01)] = -1
        out.append((dense, cat))
    return out


def plain_predict_ctr(model, params, dense, cat) -> torch.Tensor:
    """The same model through the kernels' plain versions on the card."""
    batch = {"dense": torch.from_numpy(dense).to(DEVICE), "cat": torch.from_numpy(cat).to(DEVICE)}
    gathered = {k: gather_rows_ref(params["tables"][k], ids)
                for k, ids in model.lookup_ids(batch).items()}
    x0 = model.flat_input(gathered, batch)
    return model.head(params["dense"], x0, cross_stack_ref(x0, params["dense"]["cross"]))


def per_table_predict(rec, dense, cat) -> np.ndarray:
    """``Recommender.predict_ctr`` as it was before one launch gathered
    every field: a ``gather_rows`` launch a field."""
    with torch.inference_mode():
        batch = {"dense": torch.from_numpy(dense).to(DEVICE), "cat": torch.from_numpy(cat).to(DEVICE)}
        tables = rec.params["tables"]
        gathered = {k: gather_rows(tables[k], ids) for k, ids in rec.model.lookup_ids(batch).items()}
        return rec.model(rec.params["dense"], gathered, batch).cpu().numpy()


class PerTableSteps(TrainStepBuilder):
    """The step as it was before one launch covered every table: a
    ``gather_rows`` launch a table in ``lookup``, and the per-table seams
    (overriding ``sparse_update_deduped`` keeps them), a
    ``fused_rowwise_adagrad`` launch a table."""

    def lookup(self, tables, ids):
        return {name: gather_rows(tables[name], i) for name, i in ids.items()}, {}

    def sparse_update_deduped(self, name, table, opt_state, uids, g, lr):
        return super().sparse_update_deduped(name, table, opt_state, uids, g, lr)


def phase_environment() -> str:
    check(torch.cuda.is_available(), "CUDA is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    secs = _build.build()
    print(f"build: {secs:.2f} s for {', '.join(_build.sources())} "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")


def phase_kernels(rng) -> dict:
    """Each kernel against its plain version; returns the max errors."""
    errs = {"gather_rows": 0.0, "cross_v1_fwd": 0.0}
    vocab = 100_000
    for dim in (8, 13, 32, 128):
        table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32)).to(DEVICE)
        ids = torch.from_numpy(edge_case_ids(rng, vocab, BATCH)).to(DEVICE)
        got, want = gather_rows(table, ids), gather_rows_ref(table, ids)
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(f"gather_rows D={dim}: max_abs_err {err} bitwise {torch.equal(got, want)}")
        check(torch.equal(got, want), f"gather_rows D={dim} is bitwise the plain version")
        errs["gather_rows"] = max(errs["gather_rows"], err)
    dim, layers = 26 * 32 + 13, 3
    for batch in (BATCH, 1000):
        x0 = torch.from_numpy(rng.normal(size=(batch, dim)).astype(np.float32)).to(DEVICE)
        w = torch.from_numpy((rng.normal(size=(layers, dim)) / dim**0.5).astype(np.float32)).to(DEVICE)
        b = torch.from_numpy((0.1 * rng.normal(size=(layers, dim))).astype(np.float32)).to(DEVICE)
        got, want = cross_v1_fwd(x0, w, b), cross_v1_fwd_ref(x0, w, b)
        again = cross_v1_fwd(x0, w, b)
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(f"cross_v1_fwd B={batch} d={dim} L={layers}: max_abs_err {err:.3e} "
              f"(max |ref| {want.abs().max().item():.3e}, rtol {RTOL}, atol {ATOL_REL} x max|ref|)")
        check(within(got, want, RTOL, ATOL_REL), f"cross_v1_fwd B={batch} within tolerance")
        check(torch.equal(got, again), f"cross_v1_fwd B={batch} repeats bit for bit")
        errs["cross_v1_fwd"] = max(errs["cross_v1_fwd"], err)
    errs["cross_v1_bwd"] = check_cross_v1_bwd(rng, dim, layers)
    errs["fused_rowwise_adagrad"] = check_adagrad(rng)
    errs["cross_v2_fwd"], errs["cross_v2_bwd"] = check_cross_v2(rng, dim, layers)
    errs["gather_rows_multi"] = check_gather_multi()
    errs["fused_rowwise_adagrad_multi"] = check_adagrad_multi()
    return errs


def launches_of(wrapper, fn):
    """(fn()'s result, the launches of ``wrapper``'s kernel it made)."""
    before = wrapper.launches
    out = fn()
    return out, wrapper.launches - before


def check_gather_multi() -> float:
    """The gather over many tables in one launch (counted): bit for bit its
    plain version, one launch of one table a field, and itself on repeat;
    at the serving path's shape (26 tables [100000, 32], 8192 edge-case ids
    each), at mixed widths (D = 8, 13, 128 with a bag of 3 ids an example,
    a short field) and past one launch's 64 tables (70: two launches)."""
    rng = np.random.default_rng(SEED + 2)  # its own: the main paths' inputs do not depend on it
    cases = {"26 tables [100000, 32]": [(100_000, 32, BATCH)] * 26,
             "mixed widths": [(100_000, 8, BATCH), (100_000, 13, BATCH), (1000, 128, 3 * BATCH),
                              (64, 32, 17)],
             "70 tables [1000, 8]": [(1000, 8, 1000)] * 70}
    worst = 0.0
    for name, fields in cases.items():
        tables = [torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(DEVICE)
                  for v, d, _ in fields]
        ids = [torch.from_numpy(edge_case_ids(rng, v, n)).to(DEVICE) for v, _, n in fields]
        got, launches = launches_of(gather_rows_multi, lambda: gather_rows_multi(tables, ids))
        want = gather_rows_multi_ref(tables, ids)
        one = [gather_rows(t, i) for t, i in zip(tables, ids)]
        again = gather_rows_multi(tables, ids)
        torch.cuda.synchronize()
        err = max(max_err(g, w) for g, w in zip(got, want))
        bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"gather_rows_multi {name}: {launches} launch(es), max_abs_err {err} bitwise {bitwise}")
        check(launches == -(-len(fields) // 64), f"gather_rows_multi {name}: one launch a 64 tables")
        check(bitwise, f"gather_rows_multi {name} is bitwise the plain version")
        check(all(torch.equal(g, o) for g, o in zip(got, one)),
              f"gather_rows_multi {name} is bitwise its one-table launches")
        check(all(torch.equal(g, a) for g, a in zip(got, again)), f"gather_rows_multi {name} repeats")
        worst = max(worst, err)
    return worst


def check_adagrad_multi() -> float:
    """The Adagrad update of many tables in one launch (counted): bit for
    bit one launch of one table a table, and itself on repeat; bit for bit
    its plain version at the training path's shape (26 tables [100000, 32],
    8192 Zipf ids each, combined), within tolerance of it at mixed widths
    (D = 8, 13, 100, slots shuffled so sentinels lie among the real ids)
    and past one launch's 64 tables (70: two launches). Rows no real id
    names (0 and V-1, where clamped negatives and sentinels would land,
    among them) stay as they were."""
    rng = np.random.default_rng(SEED + 3)
    cases = {"26 tables [100000, 32]": [(100_000, 32, BATCH)] * 26,
             "mixed widths, shuffled": [(100_000, 8, BATCH), (100_000, 13, BATCH), (5000, 100, 2000)],
             "70 tables [1000, 8]": [(1000, 8, 1000)] * 70}
    lr = 0.02
    worst = 0.0
    for name, shapes in cases.items():
        tables, accs, uids, grads = [], [], [], []
        for vocab, dim, n in shapes:
            tables.append(torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32) / dim**0.5).to(DEVICE))
            accs.append(torch.from_numpy(rng.uniform(0.0, 0.1, vocab).astype(np.float32)).to(DEVICE))
            ids = torch.from_numpy(adagrad_ids(rng, vocab, n)).to(DEVICE)
            g = torch.from_numpy((1e-3 * rng.normal(size=(n, dim))).astype(np.float32)).to(DEVICE)
            u, c = combine_duplicate_ids(ids, g, sentinel=vocab)
            if "shuffled" in name:
                perm = torch.from_numpy(rng.permutation(n)).to(DEVICE)
                u, c = u[perm].contiguous(), c[perm].contiguous()
            uids.append(u)
            grads.append(c)

        def copies():
            return [t.clone() for t in tables], [a.clone() for a in accs]

        (got_t, got_a), launches = launches_of(
            fused_rowwise_adagrad_multi, lambda: fused_rowwise_adagrad_multi(*copies(), uids, grads, lr))
        again_t, again_a = fused_rowwise_adagrad_multi(*copies(), uids, grads, lr)
        one_t, one_a = copies()
        for t, a, u, g in zip(one_t, one_a, uids, grads):
            fused_rowwise_adagrad(t, a, u, g, lr)
        ref_t, ref_a = fused_rowwise_adagrad_multi_ref(*copies(), uids, grads, lr)
        torch.cuda.synchronize()
        err = max(max(max_err(a, e) for a, e in zip(got_t, ref_t)), max(max_err(a, e) for a, e in zip(got_a, ref_a)))
        bitwise = all(torch.equal(a, e) for a, e in zip(got_t + got_a, ref_t + ref_a))
        distinct = sum(int((u < t.shape[0]).sum().item()) for u, t in zip(uids, tables))
        print(f"fused_rowwise_adagrad_multi {name}: {launches} launch(es), {distinct} real ids of "
              f"{sum(u.shape[0] for u in uids)} slots, max_abs_err {err:.3e} (rtol {RTOL}, atol {ATOL_REL} "
              f"x max|ref|), bitwise the plain version {bitwise}")
        check(launches == -(-len(shapes) // 64), f"fused_rowwise_adagrad_multi {name}: one launch a 64 tables")
        check(all(within(a, e, RTOL, ATOL_REL) for a, e in zip(got_t + got_a, ref_t + ref_a)),
              f"fused_rowwise_adagrad_multi {name} within tolerance")
        if name.startswith("26 tables"):
            check(bitwise, f"fused_rowwise_adagrad_multi {name} is bitwise the plain version")
        check(all(torch.equal(a, o) for a, o in zip(got_t + got_a, one_t + one_a)),
              f"fused_rowwise_adagrad_multi {name} is bitwise its one-table launches")
        check(all(torch.equal(a, r) for a, r in zip(got_t + got_a, again_t + again_a)),
              f"fused_rowwise_adagrad_multi {name} repeats bit for bit")
        for t, a, u, t0, a0 in zip(got_t, got_a, uids, tables, accs):
            touched = torch.zeros(t.shape[0], dtype=torch.bool, device=DEVICE)
            touched[u[u < t.shape[0]].long()] = True
            check(not bool(touched[0]) and not bool(touched[-1]), "rows 0 and V-1 are not real ids here")
            check(torch.equal(t[~touched], t0[~touched]) and torch.equal(a[~touched], a0[~touched]),
                  f"fused_rowwise_adagrad_multi {name}: untouched rows unchanged")
        worst = max(worst, err)
    return worst


def check_cross_v2(rng, dim: int, layers: int) -> tuple[float, float]:
    """Both v2 kernels against their plain versions, at the v2 path's shape
    (B=8192, d=845, r=64, L=3), on a ragged tile (B=1000) and at an odd
    small shape; the forward's saved f and xv too; each repeating bit for
    bit. The backward takes the forward kernel's f and xv, as in training."""
    worst_f = worst_b = 0.0
    for batch, d, rank, nl in ((BATCH, dim, V2_RANK, layers), (1000, dim, V2_RANK, layers),
                               (257, 13, 7, 1)):
        def normal(shape, scale):
            return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to(DEVICE)

        x0, g = normal((batch, d), 1.0), normal((batch, d), 1.0)
        u, v = normal((nl, d, rank), d**-0.5), normal((nl, d, rank), d**-0.5)
        b = normal((nl, d), 0.1)
        got = cross_v2_fwd(x0, u, v, b)
        out, f, xv = cross_v2_fwd(x0, u, v, b, want_saved=True)
        want, f_ref, xv_ref = cross_v2_fwd_ref(x0, u, v, b, want_saved=True)
        again = cross_v2_fwd(x0, u, v, b)
        grads = cross_v2_bwd(x0, u, v, f, xv, g)
        grads_ref = cross_v2_bwd_ref(x0, u, v, f, xv, g)
        grads_again = cross_v2_bwd(x0, u, v, f, xv, g)
        torch.cuda.synchronize()
        shape = f"B={batch} d={d} r={rank} L={nl}"
        for name, a, e in (("x_L", got, want), ("f", f, f_ref), ("xv", xv, xv_ref)):
            err = max_err(a, e)
            print(f"cross_v2_fwd {shape} {name}: max_abs_err {err:.3e} (max |ref| "
                  f"{e.abs().max().item():.3e}, rtol {RTOL}, atol {ATOL_REL} x max|ref|)")
            check(within(a, e, RTOL, ATOL_REL), f"cross_v2_fwd {shape} {name} within tolerance")
            worst_f = max(worst_f, err)
        check(torch.equal(got, again) and torch.equal(got, out), f"cross_v2_fwd {shape} repeats bit for bit")
        for name, a, e, r in zip(("dx0", "du", "dv", "db"), grads, grads_ref, grads_again):
            err = max_err(a, e)
            print(f"cross_v2_bwd {shape} {name}: max_abs_err {err:.3e} (max |ref| "
                  f"{e.abs().max().item():.3e}, rtol {RTOL}, atol {ATOL_REL} x max|ref|)")
            check(within(a, e, RTOL, ATOL_REL), f"cross_v2_bwd {shape} {name} within tolerance")
            check(torch.equal(a, r), f"cross_v2_bwd {shape} {name} repeats bit for bit")
            worst_b = max(worst_b, err)
    return worst_f, worst_b


def check_cross_v1_bwd(rng, dim: int, layers: int) -> float:
    """The backward kernel against its plain version, given the same s from
    the forward kernel; each output held to the forward's tolerance."""
    worst = 0.0
    for batch in (BATCH, 1000):
        x0 = torch.from_numpy(rng.normal(size=(batch, dim)).astype(np.float32)).to(DEVICE)
        g = torch.from_numpy(rng.normal(size=(batch, dim)).astype(np.float32)).to(DEVICE)
        w = torch.from_numpy((rng.normal(size=(layers, dim)) / dim**0.5).astype(np.float32)).to(DEVICE)
        b = torch.from_numpy((0.1 * rng.normal(size=(layers, dim))).astype(np.float32)).to(DEVICE)
        _, s = cross_v1_fwd(x0, w, b, want_s=True)
        got = cross_v1_bwd(x0, w, b, s, g)
        want = cross_v1_bwd_ref(x0, w, b, g, s)
        again = cross_v1_bwd(x0, w, b, s, g)
        torch.cuda.synchronize()
        for name, a, e, r in zip(("dx0", "dw", "db"), got, want, again):
            err = max_err(a, e)
            print(f"cross_v1_bwd B={batch} d={dim} L={layers} {name}: max_abs_err {err:.3e} "
                  f"(max |ref| {e.abs().max().item():.3e}, rtol {RTOL}, atol {ATOL_REL} x max|ref|)")
            check(within(a, e, RTOL, ATOL_REL), f"cross_v1_bwd B={batch} {name} within tolerance")
            check(torch.equal(a, r), f"cross_v1_bwd B={batch} {name} repeats bit for bit")
            worst = max(worst, err)
    return worst


def v1_bwd_kernels(parts: dict) -> dict:
    """The v1 backward's kernels, from ``kernel_times_us``, by short name:
    its row kernel (or, on the general route, the row-scalar and column
    kernels) and the sum of the per-block partials."""
    found = ((re.search(r"cross_v1_bwd\w*(<[^>]*>)?|sum_partials_kernel", k), us) for k, us in parts.items())
    return {m.group(0): us for m, us in found if m}


def v1_bwd_split(parts: dict) -> str:
    return ", ".join(f"{name} {us:.1f} us" for name, us in v1_bwd_kernels(parts).items())


def v2_kernels(parts: dict) -> dict:
    """The v2 kernels' device time from ``kernel_times_us``, by kernel and
    template arguments (the general route's row products by prologue, B
    transposed, epilogue: <0, false, 0> x V, <0, true, 1> the forward's x
    update, <1, false, 0> df U, <0, true, 2> the backward's g update; its
    weight products <true> dU with db, <false> dV)."""
    found = ((re.search(r"(cross_v2_\w+|general_\w+|sum_chunks_kernel)(<[^>]*>)?", k), us)
             for k, us in parts.items())
    return {m.group(0): us for m, us in found if m}


def counted(wrapper, fn):
    """fn()'s result, checking that it launched ``wrapper``'s kernel once."""
    out, launches = launches_of(wrapper, fn)
    check(launches == 1, f"{wrapper.__name__} launched its kernel")
    return out


def phase_wide() -> list:
    """The cross kernels past the flagship's width, where the reference's
    ``cross_stack`` still computes: ``dcn_criteo`` with embed_dim 80 and
    320 as DCN-v1 (d = 26 * 80 + 13 = 2093, L = 3; d = 8333, L = 4), and as
    low-rank DCN-v2 (r=64) with embed_dim 72 and 128 (d = 1885 and 3341).
    Each kernel runs on the card (its launch counter moves), is held to its
    plain version at the same tolerances as at the flagship's width and
    repeats bit for bit; its device time is printed beside its bound and
    its plain version's. Then low-rank v2 past the tiles' width and depth,
    on the general route (``wide_v2_general``)."""
    layers = 3
    rng = np.random.default_rng(SEED + 1)  # its own, so the main paths' inputs do not depend on it

    def normal(shape, scale):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to(DEVICE)

    def hold(name, got, want, again):
        for part, a, e, r in zip(name.split(","), got, want, again):
            print(f"  {part}: max_abs_err {max_err(a, e):.3e} (max |ref| {e.abs().max().item():.3e}), "
                  f"bitwise on repeat {torch.equal(a, r)}")
            check(within(a, e, RTOL, ATOL_REL), f"wide {part} within tolerance")
            check(torch.equal(a, r), f"wide {part} repeats bit for bit")

    # embed_dim 80 (d = 2093, L = 3) on the fast routes; embed_dim 320 (d =
    # 8333, L = 4), past the 8192 a block's registers hold in the forward
    # and the 4096 of the backward's fast route: both streaming routes.
    for dim, v1_layers in ((26 * 80 + 13, layers), (26 * 320 + 13, 4)):
        x0, g = normal((BATCH, dim), 1.0), normal((BATCH, dim), 1.0)
        w, b = normal((v1_layers, dim), dim**-0.5), normal((v1_layers, dim), 0.1)
        print(f"wide: cross_v1 B={BATCH} d={dim} L={v1_layers}")
        out, s = counted(cross_v1_fwd, lambda: cross_v1_fwd(x0, w, b, want_s=True))
        want, s_ref = cross_v1_fwd_ref(x0, w, b, want_s=True)
        hold("x_L,s", (out, s), (want, s_ref), cross_v1_fwd(x0, w, b, want_s=True))
        check(torch.equal(cross_v1_fwd(x0, w, b), out), "wide: serving x_L equals training's")
        del want, s_ref
        grads = counted(cross_v1_bwd, lambda: cross_v1_bwd(x0, w, b, s, g))
        hold("dx0,dw,db", grads, cross_v1_bwd_ref(x0, w, b, g, s), cross_v1_bwd(x0, w, b, s, g))
        del out, grads
        f_ms = device_ms(lambda: cross_v1_fwd(x0, w, b), 1)
        f_plain = device_ms(lambda: cross_v1_fwd_ref(x0, w, b), 1)
        b_ms = device_ms(lambda: cross_v1_bwd(x0, w, b, s, g), 1)
        b_plain = device_ms(lambda: cross_v1_bwd_ref(x0, w, b, g, s), 1)
        parts = kernel_times_us(lambda: cross_v1_bwd(x0, w, b, s, g))
        fb, fby = v1_fwd_bound(BATCH, dim, v1_layers)
        bb, bby = v1_bwd_bound(BATCH, dim, v1_layers)
        print(f"  cross_v1_fwd {f_ms:.4f} ms (bound {fb:.4f} ms, {fby}; plain {f_plain:.4f} ms), "
              f"cross_v1_bwd {b_ms:.4f} ms (bound {bb:.4f} ms, {bby}; plain {b_plain:.4f} ms) "
              f"[device time, CUDA graph]; the backward by kernel (profiler): {v1_bwd_split(parts)}")
    for dim in (26 * 72 + 13, 26 * 128 + 13):
        x0, g = normal((BATCH, dim), 1.0), normal((BATCH, dim), 1.0)
        u, v = normal((layers, dim, V2_RANK), dim**-0.5), normal((layers, dim, V2_RANK), dim**-0.5)
        b = normal((layers, dim), 0.1)
        print(f"wide: cross_v2 B={BATCH} d={dim} r={V2_RANK} L={layers}")
        saved = counted(cross_v2_fwd, lambda: cross_v2_fwd(x0, u, v, b, want_saved=True))
        want = cross_v2_fwd_ref(x0, u, v, b, want_saved=True)
        hold("x_L,f,xv", saved, want, cross_v2_fwd(x0, u, v, b, want_saved=True))
        check(torch.equal(cross_v2_fwd(x0, u, v, b), saved[0]), "wide: serving x_L equals training's")
        _, f, xv = saved
        grads = counted(cross_v2_bwd, lambda: cross_v2_bwd(x0, u, v, f, xv, g))
        hold("dx0,du,dv,db", grads, cross_v2_bwd_ref(x0, u, v, f, xv, g), cross_v2_bwd(x0, u, v, f, xv, g))
        f_ms = device_ms(lambda: cross_v2_fwd(x0, u, v, b), 1)
        ft_ms = device_ms(lambda: cross_v2_fwd(x0, u, v, b, want_saved=True), 1)
        b_ms = device_ms(lambda: cross_v2_bwd(x0, u, v, f, xv, g), 1)
        f_plain = device_ms(lambda: cross_v2_fwd_ref(x0, u, v, b), 1)
        ft_plain = device_ms(lambda: cross_v2_fwd_ref(x0, u, v, b, want_saved=True), 1)
        b_plain = device_ms(lambda: cross_v2_bwd_ref(x0, u, v, f, xv, g), 1)
        (fb, fby), (ftb, ftby) = (v2_fwd_bound(BATCH, dim, V2_RANK, layers, saved=t) for t in (False, True))
        bb, bby = v2_bwd_bound(BATCH, dim, V2_RANK, layers)
        print(f"  cross_v2_fwd {f_ms:.4f} ms (bound {fb:.4f} ms, {fby}; plain {f_plain:.4f} ms), "
              f"saving f and xv {ft_ms:.4f} ms (bound {ftb:.4f} ms, {ftby}; plain {ft_plain:.4f} ms), "
              f"cross_v2_bwd {b_ms:.4f} ms (bound {bb:.4f} ms, {bby}; plain {b_plain:.4f} ms) "
              f"[device time, CUDA graph]")
    return wide_v2_general(normal, hold)


def wide_v2_general(normal, hold) -> list:
    """Low-rank v2 (r=64) where the tiles do not fit, on the kernels'
    general route: d = 4173 (dcn_criteo at embed_dim 160) and 3565 (just
    past the tiles' 3560) at L = 3, both kernels; and L = 48 (past the
    weight pass's 47 layers of f) at the flagship's d = 845, the backward
    (the forward's tiles take any depth). Each held to its plain version,
    bit for bit on repeat, its general-route launches counted, and timed
    beside its bound and plain version; returns one record a shape."""
    records = []
    for bsz, dim, layers in ((BATCH, 26 * 160 + 13, 3), (BATCH, 3565, 3), (BATCH, 26 * 32 + 13, 48)):
        x0, g = normal((bsz, dim), 1.0), normal((bsz, dim), 1.0)
        u, v = normal((layers, dim, V2_RANK), dim**-0.5), normal((layers, dim, V2_RANK), dim**-0.5)
        b = normal((layers, dim), 0.1)
        print(f"wide: cross_v2 general route B={bsz} d={dim} r={V2_RANK} L={layers}")
        before = cross_v2_fwd.general_launches, cross_v2_bwd.general_launches
        saved = counted(cross_v2_fwd, lambda: cross_v2_fwd(x0, u, v, b, want_saved=True))
        want = cross_v2_fwd_ref(x0, u, v, b, want_saved=True)
        errs = [max_err(a, e) for a, e in zip(saved, want)]
        hold("x_L,f,xv", saved, want, cross_v2_fwd(x0, u, v, b, want_saved=True))
        del want
        serving = cross_v2_fwd(x0, u, v, b)
        check(torch.equal(serving, saved[0]), "wide: serving x_L equals training's")
        _, f, xv = saved
        grads = counted(cross_v2_bwd, lambda: cross_v2_bwd(x0, u, v, f, xv, g))
        want = cross_v2_bwd_ref(x0, u, v, f, xv, g)
        errs += [max_err(a, e) for a, e in zip(grads, want)]
        hold("dx0,du,dv,db", grads, want, cross_v2_bwd(x0, u, v, f, xv, g))
        del want, grads, serving
        general = (cross_v2_fwd.general_launches - before[0], cross_v2_bwd.general_launches - before[1])
        print(f"  general-route launches: forward {general[0]}, backward {general[1]}")
        # The forward's tiles take any depth: at d = 845, L = 48 only the
        # backward (its weight pass) is past them.
        fwd_general = _fwd_route(dim, V2_RANK) == "general"
        check(general == (3 * fwd_general, 2), "wide: the v2 kernels past their tiles ran the general route")
        f_ms = device_ms(lambda: cross_v2_fwd(x0, u, v, b), 1)
        ft_ms = device_ms(lambda: cross_v2_fwd(x0, u, v, b, want_saved=True), 1)
        b_ms = device_ms(lambda: cross_v2_bwd(x0, u, v, f, xv, g), 1)
        f_plain = device_ms(lambda: cross_v2_fwd_ref(x0, u, v, b), 1)
        b_plain = device_ms(lambda: cross_v2_bwd_ref(x0, u, v, f, xv, g), 1)
        fb, fby = v2_fwd_bound(bsz, dim, V2_RANK, layers, saved=False)
        bb, bby = v2_bwd_bound(bsz, dim, V2_RANK, layers)
        parts = {"fwd": v2_kernels(kernel_times_us(lambda: cross_v2_fwd(x0, u, v, b))),
                 "bwd": v2_kernels(kernel_times_us(lambda: cross_v2_bwd(x0, u, v, f, xv, g)))}
        # The profiled call's kernels added up, to set beside the graph's time.
        sums = {k: sum(us.values()) / 1e3 for k, us in parts.items()}
        print(f"  cross_v2_fwd {f_ms:.4f} ms (saving f and xv {ft_ms:.4f} ms; bound {fb:.4f} ms, {fby}; "
              f"plain {f_plain:.4f} ms), cross_v2_bwd {b_ms:.4f} ms (bound {bb:.4f} ms, {bby}; plain "
              f"{b_plain:.4f} ms) [device time, CUDA graph; B={bsz}]; one call by kernel (profiler, "
              f"us, all layers): {parts}, adding to {sums['fwd']:.4f} ms forward and "
              f"{sums['bwd']:.4f} ms backward")
        records.append({"batch": bsz, "d": dim, "r": V2_RANK, "layers": layers,
                        "fwd_max_abs_err": max(errs[:3]), "bwd_max_abs_err": max(errs[3:]),
                        "fwd_ms": f_ms, "fwd_saved_ms": ft_ms, "fwd_plain_ms": f_plain,
                        "fwd_bound_ms": fb, "fwd_bound_by": fby, "bwd_ms": b_ms,
                        "bwd_plain_ms": b_plain, "bwd_bound_ms": bb, "bwd_bound_by": bby,
                        "by_kernel_us": parts, "by_kernel_sum_ms": sums})
        del x0, g, u, v, b, saved, f, xv
    return records


def adagrad_ids(rng, vocab: int, n: int) -> np.ndarray:
    """Zipf(1.2) ids, as the training data has them (many duplicates), kept
    off rows 0 and vocab-1, where a clamped negative or sentinel id would
    land; then ~1% negative ids and ~1% sentinels (vocab and beyond)."""
    ids = _zipf_ids(rng, vocab, n).astype(np.int32)
    ids = np.clip(ids, 1, vocab - 2)
    flip = rng.random(n)
    ids[flip < 0.01] = vocab + (ids[flip < 0.01] % 3)
    ids[(flip >= 0.01) & (flip < 0.02)] = -1 - (ids[(flip >= 0.01) & (flip < 0.02)] % 5)
    return ids


def check_adagrad(rng) -> float:
    """The duplicate combine (bit for bit on repeat; equal to the CPU's) and
    the fused Adagrad kernel against its plain version, at one field of the
    training path: table [100000, 32], 8192 ids."""
    vocab, dim, lr = 100_000, 32, 0.02
    table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32) / dim**0.5).to(DEVICE)
    acc = torch.from_numpy(rng.uniform(0.0, 0.1, vocab).astype(np.float32)).to(DEVICE)
    ids_np = adagrad_ids(rng, vocab, BATCH)
    grads_np = (1e-3 * rng.normal(size=(BATCH, dim))).astype(np.float32)
    ids, grads = torch.from_numpy(ids_np).to(DEVICE), torch.from_numpy(grads_np).to(DEVICE)

    uids, g = combine_duplicate_ids(ids, grads, sentinel=vocab)
    uids2, g2 = combine_duplicate_ids(ids, grads, sentinel=vocab)
    cpu_u, cpu_g = combine_duplicate_ids(torch.from_numpy(ids_np), torch.from_numpy(grads_np), vocab)
    torch.cuda.synchronize()
    check(torch.equal(uids, uids2) and torch.equal(g, g2), "combine_duplicate_ids repeats bit for bit")
    check(torch.equal(uids.cpu(), cpu_u), "combine_duplicate_ids: uids equal the CPU's")
    comb_err = max_err(g.cpu(), cpu_g)
    check(within(g.cpu(), cpu_g, 1e-6, 1e-6), "combine_duplicate_ids: sums match the CPU's")
    distinct = int((uids < vocab).sum().item())
    print(f"combine_duplicate_ids [{BATCH}] ids, {distinct} distinct real: repeats bit for bit, "
          f"max_abs_err vs CPU {comb_err:.3e}, bitwise {torch.equal(g.cpu(), cpu_g)}")

    t_k, a_k = table.clone(), acc.clone()
    out = fused_rowwise_adagrad(t_k, a_k, uids, g, lr)
    t_r, a_r = fused_rowwise_adagrad_ref(table.clone(), acc.clone(), uids, g, lr)
    t_2, a_2 = fused_rowwise_adagrad(table.clone(), acc.clone(), uids, g, lr)
    torch.cuda.synchronize()
    check(out[0] is t_k and out[1] is a_k, "fused_rowwise_adagrad updates in place")
    err = max(max_err(t_k, t_r), max_err(a_k, a_r))
    print(f"fused_rowwise_adagrad [{vocab}, {dim}], {BATCH} slots: max_abs_err table "
          f"{max_err(t_k, t_r):.3e} acc {max_err(a_k, a_r):.3e} (rtol {RTOL}, atol {ATOL_REL} x max|ref|), "
          f"bitwise table {torch.equal(t_k, t_r)} acc {torch.equal(a_k, a_r)}")
    check(within(t_k, t_r, RTOL, ATOL_REL) and within(a_k, a_r, RTOL, ATOL_REL),
          "fused_rowwise_adagrad within tolerance")
    check(torch.equal(t_k, t_2) and torch.equal(a_k, a_2), "fused_rowwise_adagrad repeats bit for bit")
    touched = torch.zeros(vocab, dtype=torch.bool, device=DEVICE)
    touched[uids[uids < vocab].long()] = True
    check(not bool(touched[0]) and not bool(touched[vocab - 1]), "rows 0 and V-1 are not real ids here")
    check(torch.equal(t_k[~touched], table[~touched]) and torch.equal(a_k[~touched], acc[~touched]),
          "untouched rows (incl. 0 and V-1, where clamped negatives and sentinels would land) unchanged")
    check(bool((t_k[touched] != table[touched]).any(dim=1).all()), "every real id's row moved")
    return err


def configs() -> dict:
    """The two configurations the main paths run: ``dcn_criteo`` at Criteo's
    shape (the data is synthetic), as DCN-v1 and as low-rank DCN-v2."""
    v1 = zoo_configs.dcn_criteo(path="criteo")
    v2 = dataclasses.replace(v1, model=dataclasses.replace(v1.model, name="dcnv2", cross_rank=V2_RANK))
    return {"v1": v1, "v2": v2}


def cross_kernels(cfg) -> tuple[str, str]:
    """The forward and backward cross kernels of ``cfg``'s model."""
    return ("cross_v2_fwd", "cross_v2_bwd") if cfg.model.name == "dcnv2" else ("cross_v1_fwd", "cross_v1_bwd")


def reset_launches() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def read_launches() -> dict:
    """Each wrapper's launches."""
    return {name: wrapper.launches for name, wrapper in WRAPPERS.items()}


def phase_main_path(rng, cfg):
    vocabs = tuple(cfg.data.categorical_vocab_sizes)
    spec = DataSpec.ctr(vocabs, cfg.data.num_dense_features)
    model = build_model(cfg.model, spec)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    table_mb = sum(t.numel() * t.element_size() for t in params["tables"].values()) / 1e6
    cross_shapes = {k: tuple(t.shape) for k, t in params["dense"]["cross"].items()}
    print(f"model: dcn_criteo as {cfg.model.name} (cross_rank {cfg.model.cross_rank}), "
          f"{len(vocabs)} fields x {vocabs[0]} rows, d={cfg.model.embed_dim}, "
          f"input_dim {model.input_dim}, {cfg.model.num_cross_layers} cross layers {cross_shapes}, "
          f"MLP {cfg.model.mlp_dims}; tables {table_mb:.1f} MB")
    rec = Recommender(model, params)  # the default device, the card
    requests = make_requests(rng, vocabs, cfg.data.num_dense_features)

    reset_launches()
    logits = [rec.predict_ctr(dense, cat) for dense, cat in requests]
    torch.cuda.synchronize()
    launches = read_launches()
    fwd = cross_kernels(cfg)[0]
    print(f"main path ({cfg.model.name} serving): {NUM_BATCHES} batches of {BATCH}, launches {launches}")
    check(launches["gather_rows_multi"] == NUM_BATCHES, "gather_rows_multi ran once per batch, for all fields")
    check(launches[fwd] == NUM_BATCHES, f"{fwd} ran once per batch")
    check(all(c == 0 for name, c in launches.items() if name not in ("gather_rows_multi", fwd)),
          "serving launched no other kernel")

    reset_launches()
    old = per_table_predict(rec, *requests[0])
    torch.cuda.synchronize()
    old_launches = read_launches()
    print(f"serving through a gather launch a field (the route before one launch): one batch, "
          f"launches {old_launches}; logits bit for bit those of one launch: {np.array_equal(old, logits[0])}")
    check(old_launches["gather_rows"] == len(vocabs) and old_launches["gather_rows_multi"] == 0,
          "the per-field route launched gather_rows once per field")
    check(np.array_equal(old, logits[0]), "a gather launch a field gives the logits of one launch, bit for bit")

    logit_err = 0.0
    for (dense, cat), got in zip(requests, logits):
        check(got.shape == (BATCH,) and got.dtype == np.float32, f"logits are [{BATCH}] float32")
        check(bool(np.isfinite(got).all()), "logits are finite")
        want = plain_predict_ctr(model, rec.params, dense, cat)
        got_t = torch.from_numpy(got).to(DEVICE)
        check(within(got_t, want, LOGIT_TOL, LOGIT_TOL), "logits match the plain versions on the card")
        logit_err = max(logit_err, max_err(got_t, want))
    n_small = 256
    params_cpu = {"tables": {k: v.cpu() for k, v in params["tables"].items()},
                  "dense": params["dense"]}
    cpu = Recommender(model, params_cpu, device="cpu")
    want_cpu = torch.from_numpy(cpu.predict_ctr(requests[0][0][:n_small], requests[0][1][:n_small]))
    cpu_err = max_err(torch.from_numpy(logits[0][:n_small]), want_cpu)
    check(within(torch.from_numpy(logits[0][:n_small]), want_cpu, LOGIT_TOL, LOGIT_TOL),
          "card logits match the CPU plain path on a small input")
    print(f"logits: finite, max_abs_err vs plain on card {logit_err:.3e}, vs CPU "
          f"({n_small} rows) {cpu_err:.3e}, tolerance rtol {LOGIT_TOL} atol {LOGIT_TOL} x max|ref|")
    return model, rec, requests, launches


def phase_times(model, rec, requests, errs) -> list:
    dense, cat = requests[0]
    batch = {"dense": torch.from_numpy(dense).to(DEVICE), "cat": torch.from_numpy(cat).to(DEVICE)}
    ids = model.lookup_ids(batch)
    tables = rec.params["tables"]
    field_tables, field_ids = [tables[k] for k in ids], list(ids.values())
    pairs = list(zip(field_tables, field_ids))
    clamped = [(t, i.clamp(0, t.shape[0] - 1)) for t, i in pairs]
    f = len(pairs)
    # One rep gathers every field once: 26 tables, 333 MB, so L2 is cold.
    g_ms = device_ms(lambda: gather_rows_multi(field_tables, field_ids), 1)
    g_one = device_ms(lambda: [gather_rows(t, i) for t, i in pairs], 1)
    g_plain = device_ms(lambda: gather_rows_multi_ref(field_tables, field_ids), 1)
    g_lib = device_ms(lambda: [torch.index_select(t, 0, i) for t, i in clamped], 1)
    g_host = dispatch_ms(lambda: gather_rows_multi(field_tables, field_ids), 1)
    g_host_one = dispatch_ms(lambda: [gather_rows(t, i) for t, i in pairs], 1)
    g_host_lib = dispatch_ms(lambda: [torch.index_select(t, 0, i) for t, i in clamped], 1)
    g_bound, g_by = gather_bound_ms(field_tables, field_ids)

    gathered = dict(zip(ids, gather_rows_multi(field_tables, field_ids)))
    x0s = [model.flat_input(gathered, batch)]
    x0s += [torch.randn_like(x0s[0]) for _ in range(2)]  # 3 x 27.7 MB rotate past L2
    cross = rec.params["dense"]["cross"]
    w, b = cross["w"], cross["b"]
    c_ms = device_ms(lambda: [cross_v1_fwd(x, w, b) for x in x0s], len(x0s))
    c_plain = device_ms(lambda: [cross_v1_fwd_ref(x, w, b) for x in x0s], len(x0s))
    bsz, dim = x0s[0].shape
    layers = w.shape[0]
    c_bound, c_by = v1_fwd_bound(bsz, dim, layers)

    n, d = pairs[0][1].shape[0], pairs[0][0].shape[1]
    print(f"gather_rows_multi {f} x [{tables['field_0'].shape[0]}, {d}] x {n} ids [device time, CUDA "
          f"graph]: one launch {g_ms:.4f} ms; {f} launches of gather_rows {g_one:.4f} ms "
          f"({g_one / f:.4f} ms each); plain {g_plain:.4f} ms; {f} index_select {g_lib:.4f} ms; bound "
          f"{g_bound:.4f} ms ({g_by}). Issued eagerly (the host's cost where it exceeds the device's): "
          f"one launch {g_host:.4f} ms, {f} launches {g_host_one:.4f} ms, {f} index_select {g_host_lib:.4f} ms")
    print(f"cross_v1_fwd [{bsz}, {dim}] L={layers}: kernel {c_ms:.4f} ms, plain {c_plain:.4f} ms, "
          f"bound {c_bound:.4f} ms ({c_by}) [device time, CUDA graph]")
    serving_routes(rec, dense, cat)
    return [
        {"name": "gather_rows_multi", "route": "cuda", "max_abs_err": errs["gather_rows_multi"], "ms": g_ms,
         "plain_ms": g_plain, "bound_ms": g_bound, "bound_by": g_by, "library_ms": g_lib, "tables": f,
         "per_table_launches_ms": g_one, "dispatch_ms": g_host, "per_table_dispatch_ms": g_host_one},
        {"name": "cross_v1_fwd", "route": "cuda", "max_abs_err": errs["cross_v1_fwd"], "ms": c_ms,
         "plain_ms": c_plain, "bound_ms": c_bound, "bound_by": c_by, "library_ms": None},
    ]


def medians_in_turns(runs: dict, reps: int = 11) -> dict:
    """Host-clock median of each run (each ended by a synchronize), the runs
    taken in turns; the first round is warm-up."""
    times = {name: [] for name in runs}
    for _ in range(reps):
        for name, run in runs.items():
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t[1:]) for name, t in times.items()}


def latency(fn, calls: int = 51) -> tuple[float, float]:
    """(median, p99) ms of ``fn`` on the host clock over ``calls`` - 1 calls
    after a warm-up; ``fn`` ends in copying its result to the host."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    times = sorted(times[1:])
    return statistics.median(times), times[int(0.99 * (len(times) - 1))]


def serving_routes(rec, dense, cat) -> None:
    """predict_ctr's latency and a profile of one call, through one gather
    launch (the path) and through a launch a field (the route before it),
    in turns."""
    runs = {"one gather launch": lambda: rec.predict_ctr(dense, cat),
            "a gather launch a field": lambda: per_table_predict(rec, dense, cat)}
    latency = medians_in_turns(runs)
    print(f"predict_ctr ({rec.model.__class__.__name__}) batch {BATCH} (host clock, request copy and logits "
          f"included), median over 10 calls in turns: "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in latency.items()))
    for name, run in runs.items():
        profile(run, f"predict_ctr ({name})", latency[name])


def profile(fn, what: str, latency_ms: float) -> float | None:
    """Device time by kernel and copy over one call of ``fn``, and the
    device's busy share of the unprofiled median latency, which it returns
    (None where the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        print("profile: the profiler recorded no device time")
        return None
    busy_us = sum(e.self_device_time_total for e in events)
    share = busy_us / (latency_ms * 1e3)
    print(f"profile of one {what}: device busy {busy_us:.1f} us = "
          f"{100 * share:.1f}% of the median latency, "
          f"{sum(e.count for e in events)} kernels and copies")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total:9.1f} us  x{e.count:<3d} {e.key[:100]}")
    return share


def to_device(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)


def held_loss(builder, state, batch) -> float:
    """The loss of ``state`` on ``batch``, without gradients (the forward
    kernels only)."""
    with torch.no_grad():
        gathered, _ = builder.lookup(state["tables"], builder.model.lookup_ids(batch))
        return builder.loss_fn(builder.model(state["dense"], gathered, batch), batch).item()


def phase_train(cfg):
    """Train ``cfg``'s model at Criteo's shape on the default device: one
    multi_step of K batches, counted; then the loss, repeat and CPU checks."""
    vocabs = tuple(cfg.data.categorical_vocab_sizes)
    model = build_model(cfg.model, DataSpec.ctr(vocabs, cfg.data.num_dense_features))
    builder = TrainStepBuilder(model, cfg.train.loss, cfg.optim)  # the default device, the card
    check(builder.device.type == "cuda", "TrainStepBuilder defaults to the card")
    per_table = PerTableSteps(model, cfg.train.loss, cfg.optim)
    state = builder.init_state(torch.Generator(device=DEVICE).manual_seed(SEED))
    k = cfg.train.steps_per_dispatch
    t0 = time.perf_counter()
    dense, cat, label = synthetic_ctr((k + 1) * BATCH, cfg.data.num_dense_features, vocabs,
                                      seed=SEED + 1)
    n = k * BATCH
    batches = {"dense": to_device(dense[:n].reshape(k, BATCH, -1)),
               "cat": to_device(cat[:n].reshape(k, BATCH, -1)),
               "label": to_device(label[:n].reshape(k, BATCH))}
    held = {"dense": to_device(dense[n:]), "cat": to_device(cat[n:]), "label": to_device(label[n:])}
    print(f"train: dcn_criteo as {cfg.model.name}, {cfg.optim.dense_optimizer} dense lr {cfg.optim.learning_rate}, "
          f"{cfg.optim.sparse_optimizer} lr {cfg.optim.sparse_learning_rate}, {cfg.train.loss}; "
          f"multi_step K={k} x {BATCH} from synthetic_ctr (made in {time.perf_counter() - t0:.1f} s) "
          f"and a held batch of {BATCH}")
    start = copy_state(state)
    before = held_loss(builder, state, held)

    reset_launches()
    state, metrics = builder.multi_step(state, batches)
    torch.cuda.synchronize()
    launches = read_launches()
    expected = dict.fromkeys(WRAPPERS, 0)
    expected.update(dict.fromkeys(cross_kernels(cfg), 1))
    expected["gather_rows_multi"] = expected["fused_rowwise_adagrad_multi"] = 1  # all 26 tables
    print(f"train main path ({cfg.model.name}): {k} steps, launches {launches}, per step "
          f"{ {name: c / k for name, c in launches.items()} }")
    for name, per_step in expected.items():
        check(launches[name] == per_step * k, f"{name} ran {per_step} times a step")

    after = held_loss(builder, state, held)
    loss_mean = metrics["loss_mean"].item()
    print(f"train loss: mean over the {k} steps {loss_mean:.6f}, last {metrics['loss'].item():.6f}; "
          f"held batch {before:.6f} -> {after:.6f}")
    check(bool(np.isfinite([loss_mean, metrics["loss"].item(), after]).all()), "the loss is finite")
    check(after < before, "the loss on the held batch falls")
    check(state["step"] == k, "the state counts K steps")
    check_step(builder, start, {name: v[0] for name, v in batches.items()}, cfg.train.loss)
    step_routes(builder, per_table, start, {name: v[0] for name, v in batches.items()}, len(vocabs))
    return builder, per_table, state, batches, launches


def step_routes(builder, per_table, start, batch, num_tables: int) -> None:
    """One step from ``start`` through one gather and one Adagrad launch for
    every table (the path) and through a launch a table (the per-table
    seams, the route before it): the launches of each, and the same state
    after it, bit for bit."""
    reset_launches()
    new, m_new = builder.step(copy_state(start), batch)
    torch.cuda.synchronize()
    launches = read_launches()
    reset_launches()
    old, m_old = per_table.step(copy_state(start), batch)
    torch.cuda.synchronize()
    old_launches = read_launches()
    same = states_equal(new, old) and torch.equal(m_new["loss"], m_old["loss"])
    print(f"one step's launches: one launch for every table {launches}; a launch a table (the route "
          f"before) {old_launches}; the two states bit for bit equal: {same}")
    check(launches["gather_rows_multi"] == launches["fused_rowwise_adagrad_multi"] == 1
          and launches["gather_rows"] == launches["fused_rowwise_adagrad"] == 0,
          "the step gathers and updates every table in one launch each")
    check(old_launches["gather_rows"] == old_launches["fused_rowwise_adagrad"] == num_tables
          and old_launches["gather_rows_multi"] == old_launches["fused_rowwise_adagrad_multi"] == 0,
          "the per-table route launches a gather and an update a table")
    check(same, "the step of one launch a kernel is bit for bit the step of a launch a table")


def relu_inputs(builder, state, batch) -> list:
    """The inputs of the forward's ReLUs (``torch.relu``, which every model
    of the port calls: DCN's and DeepFM's towers, DLRM's bottom and top
    MLPs), [B, width] a call, on the CPU."""
    bsz = batch["cat"].shape[0]
    out = []
    relu = torch.relu

    def recorded(x):
        out.append(x.detach().reshape(bsz, -1).cpu())
        return relu(x)

    with torch.no_grad():
        gathered, _ = builder.lookup(state["tables"], builder.model.lookup_ids(batch))
        torch.relu = recorded
        try:
            builder.model(state["dense"], gathered, batch)
        finally:
            torch.relu = relu
    return out


def check_step(builder, start, batch, loss: str, step_tol: tuple | None = None) -> None:
    """One step from ``start`` repeats bit for bit on the card, and matches
    the same step on the CPU (the kernels' plain versions): the loss, the
    gradients of the dense leaves and of the gathered rows, and the tables
    and accumulators after the update, apart from the rows of examples
    whose ReLU flipped (see GRAD_TOL). Adam's first update is not compared:
    its size is lr whatever the gradient, so a near-zero gradient flips it.
    ``step_tol`` (rtol, atol) holds the tables and accumulators element by
    element instead (phase N). A [V, 1] linear table's first normalised
    update, lr * g / sqrt(g^2 + eps), turns the rounding of a row's
    cancelling gradient sum into up to lr / sqrt(eps) = 200 times as much,
    so there the update is held apart from its input: the combined
    gradients against the CPU's (GRAD_TOL), and the card's update of the
    CPU's combined gradients against the CPU's update (``step_tol``); the
    whole step's rows past ``step_tol`` are counted and reported."""
    one, m_one = builder.step(copy_state(start), batch)
    two, m_two = builder.step(copy_state(start), batch)
    torch.cuda.synchronize()
    check(states_equal(one, two) and torch.equal(m_one["loss"], m_two["loss"]),
          "one train step repeats bit for bit")

    cpu = TrainStepBuilder(builder.model, loss, builder.optim_cfg, device="cpu")
    cpu_start = copy_state(start, "cpu")
    cpu_batch = {name: v.cpu() for name, v in batch.items()}
    t0 = time.perf_counter()
    flipped = torch.zeros(cpu_batch["label"].shape[0], dtype=torch.bool)
    flip_ok = True
    for got, want in zip(relu_inputs(builder, start, batch), relu_inputs(cpu, cpu_start, cpu_batch)):
        flips = (got > 0) != (want > 0)
        flipped |= flips.any(dim=1)
        if flips.any():
            flip_ok &= want[flips].abs().max().item() <= FLIP_TOL * max_err(got, want)
    n_flipped = int(flipped.sum())

    loss_c, dense_c, rows_c, ids = cpu.loss_and_grads(cpu_start, cpu_batch)
    loss_g, dense_g, rows_g, _ = builder.loss_and_grads(start, batch)
    after_c, _ = cpu.step(cpu_start, cpu_batch)
    errs = {"loss": abs(loss_g.item() - loss_c.item())}
    dense_pairs = [(a.cpu(), e) for a, e in zip(tree_leaves(dense_g), tree_leaves(dense_c))]
    row_pairs = [(rows_g[name].cpu()[~flipped], rows_c[name][~flipped]) for name in rows_c]
    errs["dense grads"] = max(max_err(a, e) for a, e in dense_pairs)
    errs["row grads"] = max(max_err(a, e) for a, e in row_pairs)
    table_ok, acc_ok, flipped_rows, flipped_err = True, True, 0, 0.0
    errs["tables"] = errs["acc (relative)"] = errs["linear tables"] = 0.0
    lin_ok, lin_past, lr = True, 0, cpu.sparse_schedule(cpu_start["step"])
    for name, field_ids in ids.items():
        vocab = after_c["tables"][name].shape[0]
        t_g, t_c = one["tables"][name].cpu(), after_c["tables"][name]
        a_g, a_c = one["sparse_opt"][name]["acc"].cpu(), after_c["sparse_opt"][name]["acc"]
        real = field_ids[(field_ids >= 0) & (field_ids < vocab)].long()
        touched = torch.zeros(vocab, dtype=torch.bool)
        touched[real] = True
        by_flip = torch.zeros(vocab, dtype=torch.bool)
        by_flip[field_ids[flipped.repeat_interleave(field_ids.shape[0] // flipped.shape[0])]
                .clamp(0, vocab - 1).long()] = True
        clean = ~by_flip
        flipped_rows += int((by_flip & touched).sum())
        if (by_flip & touched).any():
            flipped_err = max(flipped_err, max_err(t_g[by_flip], t_c[by_flip]))
        kind = "linear tables" if t_c.shape[1] == 1 else "tables"
        errs[kind] = max(errs[kind], max_err(t_g[clean], t_c[clean]))
        rel = ((a_g[clean & touched] - a_c[clean & touched]).abs()
               / a_c[clean & touched].clamp_min(1e-30))
        errs["acc (relative)"] = max(errs["acc (relative)"], rel.max().item() if rel.numel() else 0.0)
        if step_tol is None:
            table_ok &= within(t_g[clean], t_c[clean], TABLE_TOL, TABLE_TOL)
            acc_ok &= bool((rel <= ACC_RTOL).all()) and torch.equal(a_g[~touched], a_c[~touched])
            continue
        rtol, atol = step_tol
        acc_ok &= torch.allclose(a_g[clean], a_c[clean], rtol=rtol, atol=atol)
        if kind == "tables":
            table_ok &= torch.allclose(t_g[clean], t_c[clean], rtol=rtol, atol=atol)
            continue
        uids_c, g_c = combine_duplicate_ids(field_ids, rows_c[name], sentinel=vocab)
        uids_g, g_g = combine_duplicate_ids(field_ids, rows_g[name].cpu(), sentinel=vocab)
        slots = ~by_flip[uids_c.clamp(0, vocab - 1).long()]
        errs["linear combined grads"] = max(errs.get("linear combined grads", 0.0), max_err(g_g[slots], g_c[slots]))
        same, _ = builder.sparse_opt.apply_deduped(
            start["tables"][name].clone(), copy_state(start["sparse_opt"][name]), uids_c.to(DEVICE),
            g_c.to(DEVICE), lr)
        errs["linear update of the CPU's grads"] = max(errs.get("linear update of the CPU's grads", 0.0),
                                                       max_err(same.cpu()[clean], t_c[clean]))
        lin_ok &= (torch.equal(uids_c, uids_g) and within(g_g[slots], g_c[slots], GRAD_TOL, GRAD_TOL)
                   and torch.allclose(same.cpu()[clean], t_c[clean], rtol=rtol, atol=atol))
        lin_past += int(((t_g - t_c).abs() > atol + rtol * t_c.abs())[clean].sum())
    print(f"one step: repeats bit for bit on the card; against the CPU ({time.perf_counter() - t0:.1f} s): "
          f"{n_flipped} of {flipped.shape[0]} examples have a ReLU input on the other side of 0 "
          f"(within {FLIP_TOL}x the input error of 0: {flip_ok}), their {flipped_rows} table rows differ "
          f"by up to {flipped_err:.3e}; elsewhere max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (loss rtol {LOSS_RTOL}; grads rtol {GRAD_TOL} atol {GRAD_TOL} x max|ref|; "
          + (f"tables rtol {TABLE_TOL} atol {TABLE_TOL} x max|ref|; acc rtol {ACC_RTOL})" if step_tol is None
             else f"tables and acc rtol {step_tol[0]} atol {step_tol[1]}; linear tables after the whole "
                  f"step: {lin_past} rows past it)"))
    check(flip_ok and n_flipped <= MAX_FLIPPED * flipped.shape[0],
          "ReLU flips between card and CPU are few and within rounding of 0")
    check(errs["loss"] <= LOSS_RTOL * abs(loss_c.item()), "card loss matches the CPU's")
    check(all(within(a, e, GRAD_TOL, GRAD_TOL) for a, e in dense_pairs), "card dense grads match the CPU's")
    check(all(within(a, e, GRAD_TOL, GRAD_TOL) for a, e in row_pairs), "card row grads match the CPU's")
    check(table_ok, "card tables match the CPU's (rows of flipped examples aside)")
    check(lin_ok, "card linear tables' combined gradients match the CPU's, and the card's update of the CPU's "
                  "gradients the CPU's update")
    check(acc_ok, "card accumulators match the CPU's (rows of flipped examples aside)")


def phase_train_times(builder, per_table, state, batches, errs) -> list:
    model = builder.model
    batch = {name: v[0] for name, v in batches.items()}
    ids = model.lookup_ids(batch)
    _, _, row_grads, _ = builder.loss_and_grads(state, batch)

    # cross_v1_bwd at the step's shapes: x0 from the batch, 3 sets of
    # x0/g/dx0 (3 x 83 MB) rotate past L2.
    gathered, _ = builder.lookup(state["tables"], ids)
    x0 = model.flat_input(gathered, batch)
    cross = state["dense"]["cross"]
    w, b = cross["w"], cross["b"]
    sets = []
    for x in (x0, torch.randn_like(x0), torch.randn_like(x0)):
        sets.append((x, cross_v1_fwd(x, w, b, want_s=True)[1], torch.randn_like(x0)))
    cb_ms = device_ms(lambda: [cross_v1_bwd(x, w, b, s, g) for x, s, g in sets], len(sets))
    cb_plain = device_ms(lambda: [cross_v1_bwd_ref(x, w, b, g, s) for x, s, g in sets], len(sets))
    bsz, dim = x0.shape
    layers = w.shape[0]
    cb_bound, cb_by = v1_bwd_bound(bsz, dim, layers)
    x, s, g = sets[0]
    parts = kernel_times_us(lambda: cross_v1_bwd(x, w, b, s, g))
    print(f"cross_v1_bwd [{bsz}, {dim}] L={layers}: kernel {cb_ms:.4f} ms, plain {cb_plain:.4f} ms, "
          f"bound {cb_bound:.4f} ms ({cb_by}) [device time, CUDA graph]; one call by kernel "
          f"(profiler): {v1_bwd_split(parts)}")

    # The Adagrad update of all 26 tables (12.8 MB each: L2 is cold) on the
    # step's combined gradients (Zipf ids), then on uniform ids, where
    # nearly every id of a batch is distinct.
    lr = builder.sparse_schedule(state["step"])
    work = []
    for name, field_ids in ids.items():
        table = state["tables"][name]
        uids, g = combine_duplicate_ids(field_ids, row_grads[name], sentinel=table.shape[0])
        work.append((table, state["sparse_opt"][name]["acc"], uids, g))
    zipf = adagrad_times(work, lr, "the step's Zipf ids")
    rng = np.random.default_rng(SEED + 4)
    uniform_work = []
    for table, acc, uids, g in work:
        vocab, d = table.shape
        ids_u = torch.from_numpy(rng.integers(0, vocab, uids.shape[0]).astype(np.int32)).to(DEVICE)
        g_u = torch.from_numpy((1e-3 * rng.normal(size=(uids.shape[0], d))).astype(np.float32)).to(DEVICE)
        uniform_work.append((table, acc, *combine_duplicate_ids(ids_u, g_u, sentinel=vocab)))
    uniform = adagrad_times(uniform_work, lr, "uniform ids")
    step_times(builder, per_table, state, batches)
    return [
        {"name": "cross_v1_bwd", "route": "cuda", "max_abs_err": errs["cross_v1_bwd"], "ms": cb_ms,
         "plain_ms": cb_plain, "bound_ms": cb_bound, "bound_by": cb_by, "library_ms": None,
         "by_kernel_us": v1_bwd_kernels(parts)},
        {"name": "fused_rowwise_adagrad_multi", "route": "cuda",
         "max_abs_err": errs["fused_rowwise_adagrad_multi"], **zipf, "library_ms": None,
         "uniform_ids": uniform},
    ]


def adagrad_times(work, lr: float, what: str) -> dict:
    """The Adagrad update of every (table, acc, uids, g) of ``work``: one
    launch, a launch a table, and the plain version (eagerly: its mask
    syncs, so it cannot be captured), beside the bound for the real ids of
    these uids; and the host's cost of one launch and of a launch a table."""
    tables, accs, uids, grads = (list(x) for x in zip(*work))
    f = len(work)
    ms = device_ms(lambda: fused_rowwise_adagrad_multi(tables, accs, uids, grads, lr), 1)
    one = device_ms(lambda: [fused_rowwise_adagrad(*w, lr) for w in work], 1)
    host = dispatch_ms(lambda: fused_rowwise_adagrad_multi(tables, accs, uids, grads, lr), 1)
    host_one = dispatch_ms(lambda: [fused_rowwise_adagrad(*w, lr) for w in work], 1)
    plain = dispatch_ms(lambda: fused_rowwise_adagrad_multi_ref(tables, accs, uids, grads, lr), 1)
    distinct = [int((u < t.shape[0]).sum().item()) for t, u in zip(tables, uids)]
    # A real id reads its gradient row and reads and writes its table row
    # and its accumulator (G floats for a lane-grouped table); and every id.
    nbytes = sum(k * (3 * t.shape[1] * 4 + 2 * 4 * (a.numel() // max(a.shape[0], 1))) + u.shape[0] * 4
                 for k, t, a, u in zip(distinct, tables, accs, uids))
    bound, by = bound_ms(nbytes, sum(4 * k * t.shape[1] for k, t in zip(distinct, tables)))
    print(f"fused_rowwise_adagrad_multi, {what}: {f} x [{tables[0].shape[0]}, {tables[0].shape[1]}], "
          f"{uids[0].shape[0]} slots a table, distinct real ids a table: mean {sum(distinct) / f:.1f}, "
          f"min {min(distinct)}, max {max(distinct)} ({nbytes / 1e6:.2f} MB) [device time, CUDA graph]: "
          f"one launch {ms:.4f} ms; {f} launches of fused_rowwise_adagrad {one:.4f} ms ({one / f:.4f} ms each); "
          f"bound {bound:.4f} ms ({by}); plain {plain:.4f} ms issued eagerly (its mask syncs). Issued "
          f"eagerly: one launch {host:.4f} ms, {f} launches {host_one:.4f} ms")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, "tables": f,
            "per_table_launches_ms": one, "dispatch_ms": host, "per_table_dispatch_ms": host_one}


def step_times(builder, per_table, state, batches) -> None:
    """The step's median on the host clock (ended by a synchronize) and a
    profile of one step, through one launch for every table and through a
    launch a table, in turns; a multi_step's time a step."""
    batch = {name: v[0] for name, v in batches.items()}
    holder = {"state": state}

    def run(b):
        holder["state"], _ = b.step(holder["state"], batch)

    runs = {"one launch for every table": lambda: run(builder),
            "a launch a table": lambda: run(per_table)}
    medians = medians_in_turns(runs)
    t0 = time.perf_counter()
    state, _ = builder.multi_step(holder["state"], batches)
    torch.cuda.synchronize()
    k = next(iter(batches.values())).shape[0]
    multi_ms = (time.perf_counter() - t0) * 1e3 / k
    print(f"train step ({builder.model.__class__.__name__}, cross {sorted(state['dense']['cross'])}) "
          f"batch {BATCH} (host clock, batch already on the card), median over 10 steps in turns: "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in medians.items())
          + f"; multi_step K={k}: {multi_ms:.3f} ms a step")
    holder["state"] = state
    for name, run_one in runs.items():
        profile(run_one, f"train step ({name})", medians[name])


def phase_v2_times(rec, requests, builder, per_table, state, batches, errs) -> list:
    """Both v2 kernels at the v2 path's shapes beside their bounds (bytes at
    3.35 TB/s, or operations: their 3xTF32 products at 495 TFLOP/s plus
    their elementwise steps at 67) and plain versions; the backward's time
    by kernel (row pass, weight pass, chunk sum); predict_ctr's latency and
    the step's times for the v2 model, through one launch for every table
    and through a launch a table."""
    model = builder.model
    batch = {name: v[0] for name, v in batches.items()}
    gathered, _ = builder.lookup(state["tables"], model.lookup_ids(batch))
    x0 = model.flat_input(gathered, batch)
    cross = state["dense"]["cross"]
    u, v, b = cross["u"], cross["v"], cross["b"]
    layers, dim, rank = u.shape
    bsz = x0.shape[0]
    # 3 sets of x0 (27.7 MB each) rotate past L2; the backward's sets hold
    # x0, g, f (83 MB) and xv each.
    x0s = [x0, torch.randn_like(x0), torch.randn_like(x0)]
    f_ms = device_ms(lambda: [cross_v2_fwd(x, u, v, b) for x in x0s], len(x0s))
    f_train_ms = device_ms(lambda: [cross_v2_fwd(x, u, v, b, want_saved=True) for x in x0s], len(x0s))
    f_plain = device_ms(lambda: [cross_v2_fwd_ref(x, u, v, b) for x in x0s], len(x0s))
    f_bound, f_by = v2_fwd_bound(bsz, dim, rank, layers, saved=False)
    f_train_bound, f_train_by = v2_fwd_bound(bsz, dim, rank, layers, saved=True)
    sets = []
    for x in x0s:
        _, f, xv = cross_v2_fwd(x, u, v, b, want_saved=True)
        sets.append((x, f, xv, torch.randn_like(x)))
    b_ms = device_ms(lambda: [cross_v2_bwd(x, u, v, f, xv, g) for x, f, xv, g in sets], len(sets))
    b_plain = device_ms(lambda: [cross_v2_bwd_ref(x, u, v, f, xv, g) for x, f, xv, g in sets], len(sets))
    b_bound, b_by = v2_bwd_bound(bsz, dim, rank, layers)
    x, f, xv, g = sets[0]
    parts = kernel_times_us(lambda: cross_v2_bwd(x, u, v, f, xv, g))
    print(f"cross_v2_fwd [{bsz}, {dim}] r={rank} L={layers}: kernel {f_ms:.4f} ms (saving f and xv "
          f"for training {f_train_ms:.4f} ms), plain {f_plain:.4f} ms, bound {f_bound:.4f} ms ({f_by}; "
          f"3xTF32 products at {TF32_OPS_PER_S / 1e12:.0f} TFLOP/s; saving f and xv {f_train_bound:.4f} ms, "
          f"{f_train_by}) [device time, CUDA graph]")
    print(f"cross_v2_bwd [{bsz}, {dim}] r={rank} L={layers}: kernel {b_ms:.4f} ms, plain {b_plain:.4f} ms, "
          f"bound {b_bound:.4f} ms ({b_by}; 3xTF32 products at {TF32_OPS_PER_S / 1e12:.0f} TFLOP/s) "
          f"[device time, CUDA graph]; one call by kernel (profiler): "
          + ", ".join(f"{name} {parts[k]:.1f} us" for name in ("bwd_rows", "bwd_weights", "sum_chunks")
                      for k in parts if name in k))
    del sets, x0s

    serving_routes(rec, *requests[0])
    step_times(builder, per_table, state, batches)
    return [
        {"name": "cross_v2_fwd", "route": "cuda", "max_abs_err": errs["cross_v2_fwd"], "ms": f_ms,
         "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by, "library_ms": None},
        {"name": "cross_v2_bwd", "route": "cuda", "max_abs_err": errs["cross_v2_bwd"], "ms": b_ms,
         "plain_ms": b_plain, "bound_ms": b_bound, "bound_by": b_by, "library_ms": None},
    ]


def former_interaction(bottom, fields) -> torch.Tensor:
    """DLRM's interaction as the model computed it before its kernels: the
    library's way (stack, cat, ``bmm``, the triangle by advanced indexing,
    cat), differentiated by autograd."""
    z = torch.cat([bottom[:, None, :], torch.stack(fields, dim=1)], dim=1)
    rows, cols = torch.tril_indices(z.shape[1], z.shape[1], -1, device=z.device)
    return torch.cat([bottom, torch.bmm(z, z.transpose(1, 2))[:, rows, cols]], dim=-1)


def phase_interaction(card: str) -> list:
    """DLRM's dot interaction at the DLRM cell's shape (INTERACTION_SHAPE;
    the fields [B, D] views of one allocation, as the gather lays them
    out): both kernels against their plain versions, bit for bit on
    repeat, one launch a call; their device times beside their bounds
    (each input read once, each output written once, at 3.35 TB/s; the
    products at 67 TFLOP/s), the plain versions' and the library's (the
    former bmm and triangle; its backward is autograd's, timed as its
    forward and backward less its forward, issued eagerly)."""
    bsz, n, dim = INTERACTION_SHAPE
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 25)
    z = torch.randn((n, bsz, dim), generator=g, device=DEVICE)
    bottom, fields = z[0].contiguous(), list(z[1:].unbind(0))
    pairs = n * (n - 1) // 2
    grad = torch.randn((bsz, dim + pairs), generator=g, device=DEVICE)
    f_out, f_launches = launches_of(dot_interaction_fwd, lambda: dot_interaction_fwd(bottom, fields))
    (d_bottom, d_fields), b_launches = launches_of(dot_interaction_bwd,
                                                    lambda: dot_interaction_bwd(bottom, fields, grad))
    f_again = dot_interaction_fwd(bottom, fields)
    b_again = dot_interaction_bwd(bottom, fields, grad)
    f_want = dot_interaction_fwd_ref(bottom, fields)
    want_bottom, want_fields = dot_interaction_bwd_ref(bottom, fields, grad)
    torch.cuda.synchronize()
    check(f_launches == 1 and b_launches == 1, "the interaction launches one kernel each way")
    got, want = torch.stack([d_bottom, *d_fields]), torch.stack([want_bottom, *want_fields])
    f_err, b_err = max_err(f_out, f_want), max_err(got, want)
    check(within(f_out, f_want, RTOL, ATOL_REL), "dot_interaction_fwd within tolerance of its plain version")
    check(within(got, want, RTOL, ATOL_REL), "dot_interaction_bwd within tolerance of its plain version")
    check(torch.equal(f_out, f_again) and torch.equal(d_bottom, b_again[0])
          and all(torch.equal(a, b) for a, b in zip(d_fields, b_again[1])),
          "the interaction's kernels repeat bit for bit")
    del got, want, want_fields, f_again, b_again

    f_ms = device_ms(lambda: dot_interaction_fwd(bottom, fields), 1)
    b_ms = device_ms(lambda: dot_interaction_bwd(bottom, fields, grad), 1)
    f_plain = device_ms(lambda: dot_interaction_fwd_ref(bottom, fields), 1)
    b_plain = device_ms(lambda: dot_interaction_bwd_ref(bottom, fields, grad), 1)
    leaves = [t.clone().requires_grad_() for t in (bottom, *fields)]
    lib_f = dispatch_ms(lambda: former_interaction(leaves[0], leaves[1:]), 1)
    lib_fb = dispatch_ms(lambda: torch.autograd.grad(former_interaction(leaves[0], leaves[1:]), leaves, grad), 1)
    vec_bytes, out_bytes = n * bsz * dim * 4, bsz * (dim + pairs) * 4
    flops = 2 * bsz * pairs * dim
    f_bound, f_by = bound_ms(vec_bytes + out_bytes, flops)
    b_bound, b_by = bound_ms(vec_bytes + out_bytes + vec_bytes, 2 * flops)
    print(f"dot_interaction [B={bsz}, n={n}, D={dim}] ({card}): forward kernel {f_ms:.4f} ms, plain "
          f"{f_plain:.4f} ms, library (stack, bmm, triangle, cat) {lib_f:.4f} ms, bound {f_bound:.4f} ms "
          f"({f_by}); backward kernel {b_ms:.4f} ms, plain {b_plain:.4f} ms, library (autograd of the "
          f"indexing and bmm) {lib_fb - lib_f:.4f} ms, bound {b_bound:.4f} ms ({b_by}); max_abs_err "
          f"{f_err:.3e} / {b_err:.3e} [kernels and plain: device time, CUDA graph; library: issued eagerly]")
    return [
        {"name": "dot_interaction_fwd", "route": "cuda", "max_abs_err": f_err, "ms": f_ms, "plain_ms": f_plain,
         "bound_ms": f_bound, "bound_by": f_by, "library_ms": lib_f, "shape": list(INTERACTION_SHAPE)},
        {"name": "dot_interaction_bwd", "route": "cuda", "max_abs_err": b_err, "ms": b_ms, "plain_ms": b_plain,
         "bound_ms": b_bound, "bound_by": b_by, "library_ms": lib_fb - lib_f, "shape": list(INTERACTION_SHAPE)},
    ]


def trainer_configs() -> dict:
    """The trainer phases' configurations, both ``zoo_configs.dcn_criteo()``
    (synthetic_ctr) for 1 epoch of 300 000 examples: "full" at Criteo's
    shape (26 fields of 100 000 rows; the Criteo files are not in the
    repository, so the synthetic stand-in takes their shape), and "proxy",
    the band of tests/test_golden.py:94-108 (the stand-in's own 8 fields of
    10 000 rows)."""
    base = zoo_configs.dcn_criteo()
    train = dataclasses.replace(base.train, epochs=1)
    proxy = dataclasses.replace(base, data=dataclasses.replace(base.data, num_examples=300_000),
                                train=train)
    full = dataclasses.replace(proxy, data=dataclasses.replace(
        proxy.data, categorical_vocab_sizes=(100_000,) * 26))
    return {"full": full, "proxy": proxy}


def run_counted(cfg):
    """``trainer.run(cfg)`` on the card, its launches split between
    training and the eval passes: (trainer, history, launches in training,
    [(eval pass ms on the host clock, its launches), ...], run's seconds)."""
    evaluate = trainer_mod.Trainer.evaluate
    evals = []

    def counted_evaluate(self):
        torch.cuda.synchronize()
        before, t0 = read_launches(), time.perf_counter()
        out = evaluate(self)  # ends in fetching the metrics' values
        evals.append(((time.perf_counter() - t0) * 1e3,
                      {k: c - before[k] for k, c in read_launches().items()}))
        return out

    trainer_mod.Trainer.evaluate = counted_evaluate
    try:
        reset_launches()
        t0 = time.perf_counter()
        trainer, history = run(cfg, quiet=True)
        torch.cuda.synchronize()
        total = read_launches()
        run_s = time.perf_counter() - t0
    finally:
        trainer_mod.Trainer.evaluate = evaluate
    check(trainer.device.type == "cuda", "run() trains on the card by default")
    train_counts = {k: c - sum(e[1][k] for e in evals) for k, c in total.items()}
    return trainer, history, train_counts, evals, run_s


def whole_run_launches(train_counts: dict, evals: list) -> dict:
    return {k: c + sum(e[1][k] for e in evals) for k, c in train_counts.items()}


def check_launches(counts: dict, expected: dict, what: str) -> None:
    check(all(counts[k] == expected.get(k, 0) for k in counts), what)


def phase_trainer(card: str, paths: dict) -> None:
    """``trainer.run`` on the card at Criteo's shape: launch counters show
    the gather, both v1 cross kernels and the Adagrad kernel in training,
    and the gather and the cross forward in the held-out eval; the history
    is finite and carries AUC and logloss."""
    cfg = trainer_configs()["full"]
    trainer, history, train_counts, evals, run_s = run_counted(cfg)
    check(len(evals) == 1, "one eval pass after the epoch")
    eval_ms, eval_counts = evals[0]
    paths["trainer_train"], paths["trainer_eval"] = train_counts, eval_counts
    steps = trainer.global_step
    n_eval = len(trainer.ctr_arrays["test"][2])
    eval_batches = -(-n_eval // trainer_mod.EVAL_BATCH)
    rec = history[-1]
    vocabs = cfg.data.categorical_vocab_sizes
    print(f"trainer (run, dcn_criteo at Criteo's shape from synthetic_ctr: {len(vocabs)} "
          f"fields x {vocabs[0]} rows, {cfg.data.num_examples} examples, "
          f"batch {cfg.train.batch_size}, K={cfg.train.steps_per_dispatch}): {steps} steps, history {history}; "
          f"launches in training {train_counts}, in the eval pass of {n_eval} rows ({eval_batches} batches) "
          f"{eval_counts}; run() took {run_s:.1f} s (data made included)")
    print(f"trainer: examples_per_s {rec['examples_per_s']:.1f} (host clock over the epoch, fenced by "
          f"the last loss's value; {card}); eval pass {eval_ms:.3f} ms (host clock) for {n_eval} rows")
    check(len(history) == 1 and "auc" in rec and "logloss" in rec, "the history carries auc and logloss")
    check(all(np.isfinite(v) for v in rec.values()), "the history is finite")
    trained = {"gather_rows_multi": steps, "cross_v1_fwd": steps, "cross_v1_bwd": steps,
               "fused_rowwise_adagrad_multi": steps}
    check_launches(train_counts, trained,
                   "training ran one gather, v1 forward, v1 backward and Adagrad launch a step, and no other")
    check_launches(eval_counts, {"gather_rows_multi": eval_batches, "cross_v1_fwd": eval_batches},
                   "the eval pass ran one gather and one v1 forward launch a batch, and no other")


def phase_proxy_band(card: str) -> None:
    """The proxy band of tests/test_golden.py on the card: AUC of
    ``dcn_criteo()`` after 1 epoch of 300 000 examples."""
    _, history = run(trainer_configs()["proxy"], quiet=True)
    rec = history[-1]
    print(f"proxy band (dcn_criteo(), 300000 examples, 1 epoch, on the card): auc {rec['auc']:.6f} "
          f"logloss {rec['logloss']:.6f} examples_per_s {rec['examples_per_s']:.1f} ({card}); band "
          f"{PROXY_AUC_BAND}")
    check(PROXY_AUC_BAND[0] <= rec["auc"] <= PROXY_AUC_BAND[1], "the proxy AUC lies in its band")


def card_and_cpu_runs(cfg):
    """``cfg`` trained on the card and on the CPU (the plain versions) from
    one state, each step's loss logged: (card trainer, cpu trainer, losses
    by device, final records by device, the card run's launches)."""
    card = Trainer(cfg, quiet=True)
    cpu = Trainer(cfg, quiet=True, device="cpu")
    cpu.state = copy_state(card.state, "cpu")
    losses, finals = {}, {}
    for name, trainer in (("card", card), ("cpu", cpu)):
        seen = losses[name] = []
        step = trainer.builder.step

        def logged(state, batch, step=step, seen=seen):
            new, metrics = step(state, batch)
            seen.append(metrics["loss"].item())
            return new, metrics

        trainer.builder.step = logged  # multi_step takes its steps through it
        reset_launches()
        finals[name] = trainer.train()[-1]
        if name == "card":
            torch.cuda.synchronize()
            launches = read_launches()
    return card, cpu, losses, finals, launches


def eight_steps(cfg):
    """``cfg`` cut to one epoch of 8 steps, the eval after it."""
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, epochs=1, steps_per_epoch=8))


def phase_trainer_card_vs_cpu() -> None:
    """The proxy configuration for 8 steps on the card and on the CPU (the
    plain versions) from the same initial state: each step's loss, and the
    eval's AUC and logloss."""
    t0 = time.perf_counter()
    _, _, losses, finals, _ = card_and_cpu_runs(eight_steps(trainer_configs()["proxy"]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"]))
    auc_err = abs(finals["card"]["auc"] - finals["cpu"]["auc"])
    ll_rel = abs(finals["card"]["logloss"] - finals["cpu"]["logloss"]) / finals["cpu"]["logloss"]
    print(f"trainer, card against the CPU ({time.perf_counter() - t0:.1f} s), 8 steps of the proxy "
          f"configuration from one state: losses card {losses['card']}, cpu {losses['cpu']} (max relative "
          f"error {rel:.3e}, rtol {TRAIN_LOSS_RTOL}); auc {finals['card']['auc']:.6f} against "
          f"{finals['cpu']['auc']:.6f} (error {auc_err:.3e}, atol {TRAIN_AUC_ATOL}); logloss "
          f"{finals['card']['logloss']:.6f} against {finals['cpu']['logloss']:.6f} (relative error "
          f"{ll_rel:.3e}, rtol {TRAIN_LOGLOSS_RTOL})")
    check(len(losses["card"]) == len(losses["cpu"]) == 8, "8 steps on each device")
    check(rel <= TRAIN_LOSS_RTOL, "the card's losses match the CPU's")
    check(auc_err <= TRAIN_AUC_ATOL and ll_rel <= TRAIN_LOGLOSS_RTOL,
          "the card's eval auc and logloss match the CPU's")



# ---- retrieval: config 1 (MF + BPR), and MF at bench.py's shape ----

def phase_config1_band(card: str, paths: dict) -> None:
    """``trainer.run(mf_bpr_ml100k())`` on the card: the stand-in at 943 x
    1682, d=64, batch 2048, 60 epochs, the eval every 10 epochs at ks (10,
    20, 50); recall@20 and ndcg@20 in their band; one gather and one
    Adagrad launch a step for the three tables, and one gather a batch of
    users in each eval pass (``score_all``'s user rows), and no other."""
    cfg = zoo_configs.mf_bpr_ml100k()
    trainer, history, train_counts, evals, run_s = run_counted(cfg)
    steps = trainer.global_step
    evaluator = trainer._retrieval_eval
    eval_batches = -(-len(evaluator.users_with_test) // evaluator.user_batch)
    paths["trainer_mf"] = whole_run_launches(train_counts, evals)
    rec = history[-1]
    rates = [r["examples_per_s"] for r in history]
    print(f"config 1 (run, mf_bpr_ml100k: synthetic_implicit {trainer.dataset.num_users} x "
          f"{trainer.dataset.num_items}, {len(trainer.dataset.train)} train interactions, d={cfg.model.embed_dim}, "
          f"batch {cfg.train.batch_size}, {cfg.train.epochs} epochs): {steps} steps; final record {rec}; "
          f"launches in training {train_counts}, in each eval pass ({eval_batches} batches of "
          f"{evaluator.user_batch} users) {evals[0][1]}; run() took {run_s:.1f} s (data made included)")
    print(f"config 1: examples_per_s median over the epochs {statistics.median(rates):.1f} (min {min(rates):.1f}, "
          f"max {max(rates):.1f}; host clock over each epoch, fenced by the last loss's value; {card}); eval "
          f"passes (host clock, {len(evaluator.users_with_test)} users over {trainer.dataset.num_items} items): "
          + ", ".join(f"{ms:.3f} ms" for ms, _ in evals))
    check(len(evals) == cfg.train.epochs // cfg.train.eval_every_epochs, "an eval pass every 10 epochs")
    check(all(np.isfinite(v) for r in history for v in r.values()), "the history is finite")
    check_launches(train_counts, {"gather_rows_multi": steps, "fused_rowwise_adagrad_multi": steps},
                   "config 1 ran one gather and one Adagrad launch a step, and no other")
    for _, counts in evals:
        check_launches(counts, {"gather_rows_multi": eval_batches},
                       "each eval pass ran one gather a batch of users, and no other")
    for name, (lo, hi) in CONFIG1_BAND.items():
        print(f"config 1 band: {name} {rec[name]:.6f} in [{lo}, {hi}]")
        check(lo <= rec[name] <= hi, f"config 1's {name} lies in its band")


def phase_config1_card_vs_cpu(paths: dict) -> None:
    """Config 1 for 2 epochs on the card and on the CPU (the plain versions)
    from one state, the eval at the end: each step's loss, recall@20 and
    ndcg@20."""
    base = zoo_configs.mf_bpr_ml100k()
    cfg = dataclasses.replace(base, train=dataclasses.replace(base.train, epochs=2, eval_every_epochs=2))
    t0 = time.perf_counter()
    card, _, losses, finals, paths["train_mf"] = card_and_cpu_runs(cfg)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"]))
    errs = {k: abs(finals["card"][k] - finals["cpu"][k]) for k in ("recall@20", "ndcg@20")}
    print(f"config 1, card against the CPU ({time.perf_counter() - t0:.1f} s), 2 epochs from one state "
          f"({len(losses['card'])} steps): max relative loss error {rel:.3e} (rtol {CONFIG1_LOSS_RTOL}); "
          + ", ".join(f"{k} {finals['card'][k]:.6f} against {finals['cpu'][k]:.6f} (error {e:.3e})"
                      for k, e in errs.items())
          + f" (atol {CONFIG1_METRIC_ATOL}); launches on the card {paths['train_mf']}")
    check(len(losses["card"]) == len(losses["cpu"]) == 2 * card.sampler.num_batches(), "the same steps on each")
    check(rel <= CONFIG1_LOSS_RTOL, "config 1's losses on the card match the CPU's")
    check(all(e <= CONFIG1_METRIC_ATOL for e in errs.values()), "config 1's recall@20 and ndcg@20 match the CPU's")


class PlainSteps(TrainStepBuilder):
    """The step through the kernels' plain versions on the card: the
    gather's and the Adagrad update's, every table at once."""

    def lookup(self, tables, ids):
        return dict(zip(ids, gather_rows_multi_ref([tables[n] for n in ids], list(ids.values())))), {}

    def sparse_update_deduped_all(self, tables, opt_states, uids, grads, lr):
        names = list(uids)
        new_t, new_a = fused_rowwise_adagrad_multi_ref(
            [tables[n] for n in names], [opt_states[n]["acc"] for n in names],
            [uids[n] for n in names], [grads[n] for n in names], lr, self.optim_cfg.eps)
        return dict(zip(names, new_t)), {n: {"acc": a} for n, a in zip(names, new_a)}


def mf_batches(rows: int, count: int) -> list:
    """bench.py's MF batches: (user, pos, neg) uniform in [0, rows), drawn
    in that order from ``np.random.default_rng(0)``, on the card."""
    rng = np.random.default_rng(0)
    return [{k: to_device(rng.integers(0, rows, BATCH).astype(np.int32)) for k in ("user", "pos", "neg")}
            for _ in range(count)]


def phase_mf_bench(card: str, paths: dict) -> tuple:
    """MF at bench.py's shape on the card: 8 steps counted (one gather and
    one Adagrad launch a step); the loss finite and falling on a held
    batch (the first, whose rows the steps train); one step bit for bit on
    repeat and through the plain versions on the card; at 10 000 rows one
    step against the CPU; the kernels' times at this shape and the step's
    median. Returns (model, trained state, the kernels' records)."""
    model = MF(DataSpec.interaction(MF_ROWS, MF_ROWS), MF_DIM)
    optim = OptimConfig(learning_rate=0.05, sparse_optimizer="rowwise_adagrad")
    builder = TrainStepBuilder(model, "bpr", optim)
    state = builder.init_state(torch.Generator(device=DEVICE).manual_seed(SEED))
    batches = mf_batches(MF_ROWS, 8)
    start = copy_state(state)
    held = batches[0]
    before = held_loss(builder, state, held)
    reset_launches()
    losses = []
    for batch in batches:
        state, metrics = builder.step(state, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    paths["bench_mf"] = launches = read_launches()
    after = held_loss(builder, state, held)
    losses = [x.item() for x in losses]
    mb = sum(t.numel() * 4 for t in state["tables"].values()) / 1e6
    print(f"MF at bench.py's shape: {MF_ROWS} users and items, d={MF_DIM} (tables {mb:.1f} MB), bpr, "
          f"rowwise Adagrad lr {optim.learning_rate}: 8 steps of {BATCH}, launches {launches}; losses {losses}; "
          f"held batch {before:.6f} -> {after:.6f}")
    for name in WRAPPERS:
        want = 8 if name in ("gather_rows_multi", "fused_rowwise_adagrad_multi") else 0
        check(launches[name] == want, f"MF at bench.py's shape: {name} ran {want // 8} times a step")
    check(bool(np.isfinite(losses + [after]).all()), "MF's loss is finite")
    check(after < before, "MF's loss on the held batch falls")

    one, m_one = builder.step(copy_state(start), held)
    two, m_two = builder.step(copy_state(start), held)
    plain, m_plain = PlainSteps(model, "bpr", optim).step(copy_state(start), held)
    torch.cuda.synchronize()
    repeat = states_equal(one, two) and torch.equal(m_one["loss"], m_two["loss"])
    same_plain = states_equal(one, plain) and torch.equal(m_one["loss"], m_plain["loss"])
    print(f"MF step: repeats bit for bit {repeat}; bit for bit the step through the plain versions on "
          f"the card {same_plain}")
    check(repeat, "an MF step repeats bit for bit")
    check(same_plain, "an MF step is bit for bit the step through the plain versions")
    del one, two, plain, start
    mf_card_vs_cpu()
    records = mf_kernel_times(builder, state, held)
    return model, state, records


def mf_card_vs_cpu() -> None:
    """One bpr step of MF at 10 000 users and items, d=64, on the card and
    on the CPU from one state, on a batch of 8192: loss, tables and
    accumulators within MF_CPU_RTOL."""
    model = MF(DataSpec.interaction(MF_CPU_ROWS, MF_CPU_ROWS), MF_DIM)
    optim = OptimConfig(learning_rate=0.05, sparse_optimizer="rowwise_adagrad")
    card = TrainStepBuilder(model, "bpr", optim)
    cpu = TrainStepBuilder(model, "bpr", optim, device="cpu")
    state = card.init_state(torch.Generator(device=DEVICE).manual_seed(SEED + 6))
    cpu_state = copy_state(state, "cpu")
    batch = mf_batches(MF_CPU_ROWS, 1)[0]
    new, m = card.step(state, batch)
    want, m_cpu = cpu.step(cpu_state, {k: v.cpu() for k, v in batch.items()})
    loss_rel = abs(m["loss"].item() - m_cpu["loss"].item()) / abs(m_cpu["loss"].item())
    errs = {name: max_err(new["tables"][name].cpu(), want["tables"][name]) for name in want["tables"]}
    ok = all(within(new["tables"][n].cpu(), want["tables"][n], MF_CPU_RTOL, MF_CPU_RTOL)
             and within(new["sparse_opt"][n]["acc"].cpu(), want["sparse_opt"][n]["acc"], MF_CPU_RTOL,
                        MF_CPU_RTOL) for n in want["tables"])
    print(f"MF at {MF_CPU_ROWS} rows, one step on the card against the CPU: loss relative error "
          f"{loss_rel:.3e}, tables max_abs_err {errs} (rtol {MF_CPU_RTOL}, atol {MF_CPU_RTOL} x max|ref|)")
    check(loss_rel <= MF_CPU_RTOL, "MF's loss on the card matches the CPU's")
    check(ok, "MF's tables and accumulators on the card match the CPU's")


def gather_times(tables, field_ids, what: str) -> dict:
    """The gather of every (table, ids) pair in one launch beside its bound,
    its plain version and one ``index_select`` a table (its ids clamped
    first, outside the timing)."""
    g_ms = device_ms(lambda: gather_rows_multi(tables, field_ids), 1)
    g_plain = device_ms(lambda: gather_rows_multi_ref(tables, field_ids), 1)
    in_range = [i.clamp(0, t.shape[0] - 1) for t, i in zip(tables, field_ids)]  # index_select raises past them
    g_lib = device_ms(lambda: [torch.index_select(t, 0, i) for t, i in zip(tables, in_range)], 1)
    g_bound, g_by = gather_bound_ms(tables, field_ids)
    shapes = [(tuple(t.shape), i.shape[0]) for t, i in zip(tables, field_ids)]
    print(f"gather_rows_multi at {what} {shapes} [device time, CUDA graph]: one launch {g_ms:.4f} ms; "
          f"plain {g_plain:.4f} ms; {len(tables)} index_select {g_lib:.4f} ms; bound {g_bound:.4f} ms ({g_by})")
    return {"ms": g_ms, "plain_ms": g_plain, "library_ms": g_lib, "bound_ms": g_bound, "bound_by": g_by,
            "shapes": shapes}


def mf_kernel_times(builder, state, batch) -> dict:
    """Both kernels at MF's shape (3 tables: B, 2B and 2B ids; D = 64, 64,
    1): the gather beside its bound, its plain version and 3
    ``index_select``; the Adagrad update on the step's combined gradients
    (on copies of the tables); the step's median and device-busy share."""
    model = builder.model
    ids = model.lookup_ids(batch)
    tables = [state["tables"][n] for n in ids]
    gather = gather_times(tables, list(ids.values()), "MF's shape")
    shapes = gather["shapes"]

    _, _, row_grads, _ = builder.loss_and_grads(state, batch)
    lr = builder.sparse_schedule(state["step"])
    work = []
    for name, field in ids.items():
        table = state["tables"][name].clone()
        uids, g = combine_duplicate_ids(field, row_grads[name], sentinel=table.shape[0])
        work.append((table, state["sparse_opt"][name]["acc"].clone(), uids, g))
    adagrad = adagrad_times(work, lr, f"MF's 3 tables {[tuple(w[0].shape) for w in work]}")
    del work

    holder = {"state": state}

    def run_step():
        holder["state"], _ = builder.step(holder["state"], batch)

    median = medians_in_turns({"MF step": run_step})["MF step"]
    print(f"MF step at bench.py's shape, batch {BATCH} (host clock, batch on the card), median over 10 "
          f"steps {median:.3f} ms ({BATCH / median * 1e3:.1f} examples/s)")
    busy = profile(run_step, "MF step at bench.py's shape", median)
    return {"gather_rows_multi": gather,
            "fused_rowwise_adagrad_multi": {**adagrad, "shapes": shapes},
            "step_ms": median, "step_device_busy": busy}


def same_topk(ids, vals, want_ids, want_vals, scores, next_vals) -> bool:
    """Values equal; ids equal wherever a value is not tied with its
    neighbours (nor, at the k-th place, with the (k+1)-th value); every id
    carries its value in ``scores``, once a row."""
    if not torch.equal(vals, want_vals):
        return False
    tied = torch.zeros_like(vals, dtype=torch.bool)
    tied[:, 1:] |= vals[:, 1:] == vals[:, :-1]
    tied[:, :-1] |= vals[:, 1:] == vals[:, :-1]
    tied[:, -1] |= vals[:, -1] == next_vals
    ids_l = ids.long()
    sorted_ids = ids_l.sort(dim=1).values
    return (torch.equal(ids[~tied], want_ids[~tied])
            and torch.equal(torch.gather(scores, 1, ids_l), vals)
            and bool((sorted_ids[:, 1:] != sorted_ids[:, :-1]).all()))


def phase_mf_topk(card: str, paths: dict, model, state) -> None:
    """``Recommender.recommend(users, k=100)`` for 1024 users over the
    1 000 000 items of phase 14's trained model: one gather launch a call;
    ids and values those of a plain ``torch.matmul`` + ``torch.topk`` on the
    card; latency and users/s; the product's and the top-k's device times
    beside their bounds; a profile of one call."""
    rec = Recommender(model, {"tables": state["tables"], "dense": {}})
    users_np = np.random.default_rng(SEED + 5).integers(0, MF_ROWS, TOPK_USERS).astype(np.int32)
    reset_launches()
    ids, vals = rec.recommend(users_np, TOPK_K)
    paths["serve_mf"] = launches = read_launches()
    check(launches["gather_rows_multi"] == 1 and sum(launches.values()) == 1,
          "recommend ran one gather launch, and no other")
    tables = rec.params["tables"]
    users = to_device(users_np)
    u = torch.index_select(tables["user_emb"], 0, users.long())
    scores = torch.matmul(u, tables["item_emb"].T) + tables["item_bias"][:, 0][None, :]
    top = torch.topk(scores, TOPK_K + 1)
    want_vals, want_ids = top.values[:, :TOPK_K], top.indices[:, :TOPK_K]
    got_ids, got_vals = to_device(ids).long(), to_device(vals)
    same = same_topk(got_ids, got_vals, want_ids, want_vals, scores, top.values[:, TOPK_K])
    ties = int((want_vals[:, 1:] == want_vals[:, :-1]).sum())
    print(f"recommend: {TOPK_USERS} users, k={TOPK_K} over {MF_ROWS} items (d={MF_DIM}): ids {ids.dtype} "
          f"{ids.shape}, launches {launches}; equal to a plain matmul + topk on the card (values bit for bit, "
          f"ids where untied; {ties} tied neighbours): {same}")
    check(ids.shape == vals.shape == (TOPK_USERS, TOPK_K) and bool(np.isfinite(vals).all()),
          "recommend gives finite [users, k] ids and scores")
    check(same, "recommend's ids and values are those of the plain top-k")

    median, p99 = latency(lambda: rec.recommend(users_np, TOPK_K))
    prod_ms = device_ms(lambda: torch.matmul(u, tables["item_emb"].T), 1)
    topk_ms = device_ms(lambda: torch.topk(scores, TOPK_K), 1)
    score_bytes = TOPK_USERS * MF_ROWS * 4
    prod_bound, prod_by = bound_ms(u.numel() * 4 + tables["item_emb"].numel() * 4 + score_bytes,
                                   2 * TOPK_USERS * MF_ROWS * MF_DIM)
    topk_bound, topk_by = bound_ms(score_bytes + TOPK_USERS * TOPK_K * 8, TOPK_USERS * MF_ROWS)
    call_bound, call_by = bound_ms(sum(t.numel() * 4 for t in tables.values()) + 2 * score_bytes,
                                   2 * TOPK_USERS * MF_ROWS * MF_DIM + 2 * TOPK_USERS * MF_ROWS)
    print(f"recommend latency (host clock, request copy and results included) over 50 calls: median "
          f"{median:.3f} ms, p99 {p99:.3f} ms, {TOPK_USERS / median * 1e3:.1f} users/s ({card})")
    print(f"recommend's parts [device time, CUDA graph]: the product [{TOPK_USERS}, {MF_DIM}] x [{MF_DIM}, "
          f"{MF_ROWS}] {prod_ms:.4f} ms (bound {prod_bound:.4f} ms, {prod_by}); torch.topk k={TOPK_K} over "
          f"[{TOPK_USERS}, {MF_ROWS}] {topk_ms:.4f} ms (bound {topk_bound:.4f} ms, {topk_by}); the whole "
          f"call's bound {call_bound:.4f} ms ({call_by}: the 4.1 GB score matrix written and read)")
    profile(lambda: rec.recommend(users_np, TOPK_K), "recommend call", median)


# ---- configs 2 and 3 (FM over multi-field interaction data; NeuMF with the
# sampled-candidate eval), and config 4's full band ----

def phase_config4_band(card: str) -> None:
    """``trainer.run(dcn_criteo())`` whole on the card: 2M synthetic_ctr
    examples, 2 epochs of 8 steps a dispatch, the eval after each; AUC and
    logloss in the full band of tests/test_golden.py:109-112."""
    t0 = time.perf_counter()
    _, history = run(zoo_configs.dcn_criteo(), quiet=True)
    rec = history[-1]
    print(f"config 4, full band (dcn_criteo(): 2000000 synthetic_ctr examples, 2 epochs, on the card; "
          f"run() took {time.perf_counter() - t0:.1f} s, data made included): history {history}; "
          f"examples_per_s {[round(r['examples_per_s'], 1) for r in history]} ({card})")
    for name, (lo, hi) in CONFIG4_BAND.items():
        print(f"config 4 band: {name} {rec[name]:.6f} in [{lo}, {hi}]")
        check(lo <= rec[name] <= hi, f"config 4's {name} lies in its full band")


def phase_config2(card: str, paths: dict):
    """``trainer.run(fm_ctr_ml1m())`` on the card: FM over the stand-in at
    ML-1M's shape (6040 x 3706, synthetic side fields: 6 fields, d=64),
    batch 4096, 20 epochs, the eval every 5 (AUC over sampled negatives: FM
    with side fields does not score the catalog); AUC in its band; one
    gather and one Adagrad launch a step for the 12 tables, one gather an
    eval pass; examples_per_s, each eval pass's time, the host's input
    time a batch, and a step's median and device-busy share. Returns the
    trainer and its history."""
    cfg = zoo_configs.fm_ctr_ml1m()
    trainer, history, train_counts, evals, run_s = run_counted(cfg)
    steps = trainer.global_step
    paths["trainer_fm"] = whole_run_launches(train_counts, evals)
    rec = history[-1]
    rates = [r["examples_per_s"] for r in history]
    tables = trainer.model.table_specs()
    print(f"config 2 (run, fm_ctr_ml1m: synthetic_implicit {trainer.dataset.num_users} x "
          f"{trainer.dataset.num_items} with side fields, field vocabs {trainer.data_spec.field_vocabs}, "
          f"{len(trainer.dataset.train)} train and {len(trainer.dataset.test)} test interactions, "
          f"{len(tables)} tables, d={cfg.model.embed_dim}, batch {cfg.train.batch_size}, {cfg.train.epochs} "
          f"epochs): {steps} steps; history {history}; launches in training {train_counts}, in each eval "
          f"pass {evals[0][1]}; run() took {run_s:.1f} s (data made included)")
    print(f"config 2: examples_per_s median over the epochs {statistics.median(rates):.1f} (min "
          f"{min(rates):.1f}, max {max(rates):.1f}; host clock over each epoch, fenced by the last loss's "
          f"value; {card}); eval passes (host clock): " + ", ".join(f"{ms:.3f} ms" for ms, _ in evals))
    check(len(evals) == cfg.train.epochs // cfg.train.eval_every_epochs, "an eval pass every 5 epochs")
    check(all(np.isfinite(v) for r in history for v in r.values()), "the history is finite")
    check(set(rec) == {"epoch", "loss", "examples_per_s", "auc"}, "FM with side fields reports AUC only")
    check_launches(train_counts, {"gather_rows_multi": steps, "fused_rowwise_adagrad_multi": steps},
                   "config 2 ran one gather and one Adagrad launch a step for the 12 tables, and no other")
    for _, counts in evals:
        check_launches(counts, {"gather_rows_multi": 1}, "each eval pass ran one gather (its AUC batch), and no other")
    lo, hi = CONFIG2_AUC_BAND
    print(f"config 2 band: auc {rec['auc']:.6f} in [{lo}, {hi}]")
    check(lo <= rec["auc"] <= hi, "config 2's AUC lies in its band")

    # The host's part: a whole epoch of the sampler (negatives, shuffle) and
    # the adapter to 6-field batches, per batch.
    t0 = time.perf_counter()
    raw = list(trainer.sampler.epoch(0))
    t1 = time.perf_counter()
    host = [trainer._host_batch(b) for b in raw]
    t2 = time.perf_counter()
    n = len(raw)
    print(f"config 2 host input a batch of {cfg.train.batch_size} (host clock over one epoch of {n} batches): "
          f"sampler {(t1 - t0) * 1e3 / n:.3f} ms, _host_batch (side-field gathers, the 6-field cat) "
          f"{(t2 - t1) * 1e3 / n:.3f} ms")
    step_profile(trainer.builder, trainer.state, trainer._to_device_batch(host[0]), "config 2 (FM) step")
    return trainer, history


def step_profile(builder, state, batch, what: str) -> tuple:
    """The step on ``batch`` from a copy of ``state`` (on the card): its
    median over 10 steps (host clock, ended by a synchronize) and a profile
    of one step with its device-busy share, kernels and copies. Returns
    (median ms, busy share)."""
    holder = {"state": copy_state(state)}

    def run_step():
        holder["state"], _ = builder.step(holder["state"], batch)

    median = medians_in_turns({what: run_step})[what]
    rows = next(iter(batch.values())).shape[0]
    print(f"{what}, batch {rows} (host clock, batch on the card), median over 10 steps {median:.3f} ms "
          f"({rows / median * 1e3:.1f} examples/s)")
    return median, profile(run_step, what, median)


def phase_config3(card: str, paths: dict):
    """``trainer.run(neumf_ml20m())`` on the card: NeuMF (gmf 32, mlp 32,
    tower 64-32-16) over the stand-in (8192 x 4096, leave one out), batch
    8192, rowwise Adam, 20 epochs, the sampled eval (100 negatives a case)
    every 5; HR@10 and ndcg_sampled@10 in their band; one gather launch a
    step for the 4 tables, one a batch of the sampled eval and one for its
    AUC batch; examples_per_s, each eval pass's time, a step's median and
    profile, and rowwise Adam's device time a step. Returns the trainer."""
    cfg = zoo_configs.neumf_ml20m()
    trainer, history, train_counts, evals, run_s = run_counted(cfg)
    steps = trainer.global_step
    paths["trainer_neumf"] = whole_run_launches(train_counts, evals)
    evaluator = trainer._retrieval_eval
    eval_batches = -(-len(evaluator.users) // evaluator.user_batch)
    rec = history[-1]
    rates = [r["examples_per_s"] for r in history]
    print(f"config 3 (run, neumf_ml20m: synthetic_implicit {trainer.dataset.num_users} x "
          f"{trainer.dataset.num_items}, {len(trainer.dataset.train)} train interactions, leave one out, "
          f"batch {cfg.train.batch_size}, {cfg.optim.sparse_optimizer}, {cfg.train.epochs} epochs): {steps} "
          f"steps; history {history}; launches in training {train_counts}, in each eval pass "
          f"({len(evaluator.users)} cases x {evaluator.candidates.shape[1]} candidates in {eval_batches} "
          f"batches of {evaluator.user_batch}, and the AUC batch) {evals[0][1]}; run() took {run_s:.1f} s "
          f"(data made included)")
    print(f"config 3: examples_per_s median over the epochs {statistics.median(rates):.1f} (min "
          f"{min(rates):.1f}, max {max(rates):.1f}; host clock over each epoch, fenced by the last loss's "
          f"value; {card}); eval passes (host clock, sampled eval and AUC): "
          + ", ".join(f"{ms:.3f} ms" for ms, _ in evals))
    check(len(evals) == cfg.train.epochs // cfg.train.eval_every_epochs, "an eval pass every 5 epochs")
    check(all(np.isfinite(v) for r in history for v in r.values()), "the history is finite")
    check(rec["eval_cases"] == trainer.dataset.num_users, "the sampled eval ranks one case a user")
    check_launches(train_counts, {"gather_rows_multi": steps},
                   "config 3 ran one gather launch a step for the 4 tables, and no other")
    for _, counts in evals:
        check_launches(counts, {"gather_rows_multi": eval_batches + 1},
                       "each eval pass ran one gather a batch of the sampled eval and one for the AUC")
    for name, (lo, hi) in CONFIG3_BAND.items():
        print(f"config 3 band: {name} {rec[name]:.6f} in [{lo}, {hi}]")
        check(lo <= rec[name] <= hi, f"config 3's {name} lies in its band")

    batch = trainer._to_device_batch(next(trainer.sampler.epoch(0)))
    step_profile(trainer.builder, trainer.state, batch, "config 3 (NeuMF) step")
    # Rowwise Adam (plain PyTorch: the reference has no Pallas site for it)
    # on the step's gradients, apart from the combine before it.
    builder, state = trainer.builder, copy_state(trainer.state)
    _, _, row_grads, ids = builder.loss_and_grads(state, batch)
    lr = builder.sparse_schedule(state["step"])

    def combine():
        return {n: combine_duplicate_ids(ids[n], row_grads[n], sentinel=state["tables"][n].shape[0]) for n in ids}

    combine_us = sum(kernel_times_us(combine).values())
    combined = combine()
    adam = kernel_times_us(lambda: builder.sparse_update_deduped_all(
        state["tables"], state["sparse_opt"], {n: u for n, (u, _) in combined.items()},
        {n: g for n, (_, g) in combined.items()}, lr))
    print(f"config 3 rowwise Adam a step (profiler, device time): the update of the 4 tables "
          f"{sum(adam.values()):.1f} us in {len(adam)} kernels; the duplicate combine before it {combine_us:.1f} us; "
          f"top: " + ", ".join(f"{k[:60]} {v:.1f} us" for k, v in sorted(adam.items(), key=lambda kv: -kv[1])[:5]))
    return trainer


def phase_configs_card_vs_cpu() -> None:
    """Configs 2 and 3 for 8 steps on the card and on the CPU from one state:
    each step's loss, the eval's AUC, and for config 3 HR@10 and
    ndcg_sampled@10 with the number of cases whose rank differs."""
    for name, cfg in (("config 2", zoo_configs.fm_ctr_ml1m()), ("config 3", zoo_configs.neumf_ml20m())):
        t0 = time.perf_counter()
        card, cpu, losses, finals, _ = card_and_cpu_runs(eight_steps(cfg))
        check(len(losses["card"]) == len(losses["cpu"]) == 8, "8 steps on each device")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"]))
        auc_err = abs(finals["card"]["auc"] - finals["cpu"]["auc"])
        line = (f"{name}, card against the CPU ({time.perf_counter() - t0:.1f} s), 8 steps from one state: "
                f"losses card {losses['card']}, cpu {losses['cpu']} (max relative error {rel:.3e}, rtol "
                f"{CONFIG23_LOSS_RTOL}); auc {finals['card']['auc']:.6f} against {finals['cpu']['auc']:.6f} "
                f"(error {auc_err:.3e}, atol {CONFIG23_AUC_ATOL})")
        check(rel <= CONFIG23_LOSS_RTOL, f"{name}'s losses on the card match the CPU's")
        check(auc_err <= CONFIG23_AUC_ATOL, f"{name}'s AUC on the card matches the CPU's")
        if name == "config 3":
            ranks = {k: t._retrieval_eval.ranks(t.params) for k, t in (("card", card), ("cpu", cpu))}
            cases = len(ranks["cpu"])
            flips = int((ranks["card"] != ranks["cpu"]).sum())
            errs = {k: abs(finals["card"][k] - finals["cpu"][k]) for k in CONFIG3_BAND}
            line += (f"; {flips} of {cases} cases rank differently (at most {CONFIG3_MAX_RANK_FLIPS:.0%}); "
                     + ", ".join(f"{k} {finals['card'][k]:.6f} against {finals['cpu'][k]:.6f} (error {e:.3e})"
                                 for k, e in errs.items()))
            check(flips <= CONFIG3_MAX_RANK_FLIPS * cases, "few of config 3's cases rank differently")
            check(all(e <= flips / cases + 1e-12 for e in errs.values()),
                  "config 3's HR@10 and ndcg_sampled@10 differ by no more than the cases that rank differently")
        print(line)


def phase_new_shapes(fm_trainer, neumf_trainer) -> dict:
    """The gather kernel at FM's 12 tables and NeuMF's 4, and the Adagrad
    kernel at FM's 12, with the ids of a real batch of each config: one
    launch each, bit for bit their plain versions and on repeat; a step of
    each repeats bit for bit (FM's also through the plain versions); the
    kernels' times beside their bounds, plain versions and index_select.
    Returns the kernels' records by config."""
    records = {"gather_rows_multi": {}, "fused_rowwise_adagrad_multi": {}}
    for label, trainer in (("fm", fm_trainer), ("neumf", neumf_trainer)):
        builder, state = trainer.builder, trainer.state
        batch = trainer._to_device_batch(trainer._host_batch(next(trainer.sampler.epoch(0))))
        ids = trainer.model.lookup_ids(batch)
        tables, field_ids = [state["tables"][n] for n in ids], list(ids.values())
        got, launches = launches_of(gather_rows_multi, lambda: gather_rows_multi(tables, field_ids))
        again = gather_rows_multi(tables, field_ids)
        want = gather_rows_multi_ref(tables, field_ids)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
        repeat = all(torch.equal(g, a) for g, a in zip(got, again))
        print(f"gather_rows_multi at {label}'s {len(tables)} tables {[tuple(t.shape) for t in tables]}: "
              f"{launches} launch, bit for bit the plain version {bitwise}, on repeat {repeat}")
        check(launches == 1 and bitwise and repeat,
              f"gather_rows_multi at {label}'s shape: one launch, bit for bit its plain version and on repeat")
        records["gather_rows_multi"][label] = gather_times(tables, field_ids, f"{label}'s shape")

        start = copy_state(state)
        one, m_one = builder.step(copy_state(start), batch)
        two, m_two = builder.step(copy_state(start), batch)
        same = states_equal(one, two) and torch.equal(m_one["loss"], m_two["loss"])
        line = f"{label} step: repeats bit for bit {same}"
        check(same, f"a {label} step repeats bit for bit")
        if label == "fm":
            plain, m_plain = PlainSteps(trainer.model, trainer.loss_name, trainer.config.optim).step(
                copy_state(start), batch)
            same_plain = states_equal(one, plain) and torch.equal(m_one["loss"], m_plain["loss"])
            line += f"; bit for bit the step through the plain versions on the card {same_plain}"
            check(same_plain, "an FM step is bit for bit the step through the plain versions")
        print(line)
        del one, two
        if label != "fm":
            continue
        _, _, row_grads, _ = builder.loss_and_grads(start, batch)
        lr = builder.sparse_schedule(start["step"])
        eps = trainer.config.optim.eps
        uids, grads = [], []
        for name, i in ids.items():
            u, g = combine_duplicate_ids(i, row_grads[name], sentinel=start["tables"][name].shape[0])
            uids.append(u)
            grads.append(g)
        accs = [start["sparse_opt"][n]["acc"] for n in ids]

        def copies():
            return [t.clone() for t in tables], [a.clone() for a in accs]

        (got_t, got_a), launches = launches_of(
            fused_rowwise_adagrad_multi, lambda: fused_rowwise_adagrad_multi(*copies(), uids, grads, lr, eps))
        again_t, again_a = fused_rowwise_adagrad_multi(*copies(), uids, grads, lr, eps)
        ref_t, ref_a = fused_rowwise_adagrad_multi_ref(*copies(), uids, grads, lr, eps)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, e) for a, e in zip(got_t + got_a, ref_t + ref_a))
        repeat = all(torch.equal(a, e) for a, e in zip(got_t + got_a, again_t + again_a))
        distinct = {n: int((u < t.shape[0]).sum().item()) for n, u, t in zip(ids, uids, tables)}
        print(f"fused_rowwise_adagrad_multi at FM's 12 tables, a config-2 batch's combined ids (distinct real "
              f"ids a table {distinct}): {launches} launch, bit for bit the plain version {bitwise}, on repeat "
              f"{repeat}")
        check(launches == 1 and bitwise and repeat,
              "fused_rowwise_adagrad_multi at FM's shape: one launch, bit for bit its plain version and on repeat")
        work = [(t, a, u, g) for t, a, u, g in zip(*copies(), uids, grads)]
        records["fused_rowwise_adagrad_multi"]["fm"] = {
            **adagrad_times(work, lr, "FM's 12 tables (a config-2 batch)"),
            "shapes": records["gather_rows_multi"]["fm"]["shapes"], "distinct_ids": distinct}
    return records


def plain_forward(model, params, batch) -> torch.Tensor:
    """``model``'s forward with its rows gathered by the gather's plain
    version, on the card."""
    ids = model.lookup_ids(batch)
    rows = gather_rows_multi_ref([params["tables"][k] for k in ids], list(ids.values()))
    return model(params["dense"], dict(zip(ids, rows)), batch)


def phase_serve_configs(card: str, paths: dict, fm_trainer, neumf_trainer) -> None:
    """Serving the trained models of phases A and B on the card. NeuMF:
    ``predict`` on a batch of (user, item) pairs and ``recommend(users,
    k=10)`` for 1024 users over the 4096 items, train items excluded,
    against a plain run of the same model on the card (the gather's plain
    version; for recommend one product of every pair, the train items
    masked, ``torch.topk``): values to tolerance, ids where untied. FM:
    ``predict_ctr`` on 6-field batches against its plain run. One gather
    launch a call; latency (median, p99) and rates."""
    rng = np.random.default_rng(SEED + 7)
    rec = Recommender.from_trainer(neumf_trainer)
    model, params = rec.model, rec.params
    nu, ni = neumf_trainer.dataset.num_users, neumf_trainer.dataset.num_items
    users, items = rng.integers(0, nu, BATCH).astype(np.int32), rng.integers(0, ni, BATCH).astype(np.int32)
    reset_launches()
    scores = rec.predict(users, items)
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches(launches, {"gather_rows_multi": 1}, "NeuMF's predict ran one gather launch, and no other")
    with torch.inference_mode():
        batch = {"user": to_device(users), "item": to_device(items)}
        want = plain_forward(model, params, batch)
    got = torch.from_numpy(scores).to(DEVICE)
    ok = within(got, want, LOGIT_TOL, LOGIT_TOL)
    predict_ms = latency(lambda: rec.predict(users, items))
    print(f"NeuMF predict, {BATCH} pairs: launches {launches}; max_abs_err against the plain run on the card "
          f"{max_err(got, want):.3e} (rtol {LOGIT_TOL}, atol {LOGIT_TOL} x max|ref|); latency (host clock, "
          f"request copy and scores included) median {predict_ms[0]:.3f} ms, p99 {predict_ms[1]:.3f} ms, "
          f"{BATCH / predict_ms[0] * 1e3:.1f} pairs/s ({card})")
    check(bool(np.isfinite(scores).all()) and ok, "NeuMF's predict is finite and matches its plain run")

    serve_users = rng.choice(nu, SERVE_USERS, replace=False).astype(np.int32)
    reset_launches()
    ids, vals = rec.recommend(serve_users, SERVE_K)
    torch.cuda.synchronize()
    paths["serve_neumf"] = launches = read_launches()
    check_launches(launches, {"gather_rows_multi": 1},
                   "NeuMF's recommend ran one gather launch (users and every item chunk), and no other")
    with torch.inference_mode():
        u = to_device(np.repeat(serve_users, ni))
        i = torch.arange(ni, dtype=torch.int32, device=DEVICE).repeat(SERVE_USERS)
        plain = plain_forward(model, params, {"user": u, "item": i}).reshape(SERVE_USERS, ni)
        train = neumf_trainer.dataset.train_csr[serve_users].toarray() > 0
        plain.masked_fill_(to_device(train), float("-inf"))
        top = torch.topk(plain, SERVE_K + 1)
    want_vals, want_ids = top.values[:, :SERVE_K], top.indices[:, :SERVE_K]
    got_vals, got_ids = to_device(vals), to_device(ids).long()
    tol = LOGIT_TOL * max(want_vals.abs().max().item(), 1.0)
    gaps = top.values[:, :-1] - top.values[:, 1:] > 2 * tol  # [users, k]: each place against the next
    untied = torch.ones_like(want_vals, dtype=torch.bool)
    untied[:, 1:] &= gaps[:, :-1]
    untied &= gaps
    same_ids = torch.equal(got_ids[untied], want_ids[untied])
    close = within(got_vals, want_vals, LOGIT_TOL, LOGIT_TOL)
    excluded = bool(torch.gather(to_device(train), 1, got_ids).any())
    rec_ms = latency(lambda: rec.recommend(serve_users, SERVE_K))
    print(f"NeuMF recommend: {SERVE_USERS} users, k={SERVE_K} over {ni} items: launches {launches}; against the "
          f"plain run on the card: values within rtol {LOGIT_TOL}, atol {LOGIT_TOL} x max|ref| {close} (max_abs_err "
          f"{max_err(got_vals, want_vals):.3e}), ids equal where untied {same_ids} ({int(untied.sum())} of "
          f"{untied.numel()} untied), a train item recommended {excluded}; latency median {rec_ms[0]:.3f} ms, "
          f"p99 {rec_ms[1]:.3f} ms, {SERVE_USERS / rec_ms[0] * 1e3:.1f} users/s ({card})")
    check(ids.shape == (SERVE_USERS, SERVE_K) and bool(np.isfinite(vals).all()), "recommend's shape, finite")
    check(close and same_ids and not excluded, "NeuMF's recommend matches its plain run, train items excluded")
    profile(lambda: rec.recommend(serve_users, SERVE_K), "NeuMF recommend call", rec_ms[0])

    fm = Recommender.from_trainer(fm_trainer)
    host = fm_trainer._host_batch({"user": rng.integers(0, fm_trainer.dataset.num_users, BATCH).astype(np.int32),
                                   "item": rng.integers(0, fm_trainer.dataset.num_items, BATCH).astype(np.int32),
                                   "label": np.zeros(BATCH, np.float32)})
    reset_launches()
    logits = fm.predict_ctr(host["dense"], host["cat"])
    torch.cuda.synchronize()
    paths["serve_fm"] = launches = read_launches()
    check_launches(launches, {"gather_rows_multi": 1}, "FM's predict_ctr ran one gather launch, and no other")
    with torch.inference_mode():
        want = plain_forward(fm.model, fm.params, {"dense": to_device(host["dense"]), "cat": to_device(host["cat"])})
    got = torch.from_numpy(logits).to(DEVICE)
    ok = within(got, want, LOGIT_TOL, LOGIT_TOL)
    fm_ms = latency(lambda: fm.predict_ctr(host["dense"], host["cat"]))
    print(f"FM predict_ctr, {BATCH} rows of {host['cat'].shape[1]} fields: launches {launches}; max_abs_err against "
          f"the plain run on the card {max_err(got, want):.3e}; latency median {fm_ms[0]:.3f} ms, p99 "
          f"{fm_ms[1]:.3f} ms, {BATCH / fm_ms[0] * 1e3:.1f} rows/s ({card})")
    check(bool(np.isfinite(logits).all()) and ok, "FM's predict_ctr is finite and matches its plain run")
    profile(lambda: fm.predict_ctr(host["dense"], host["cat"]), "FM predict_ctr call", fm_ms[0])


# ---- data files, checkpoints, serving from disk and the CLI (phases F-J) ----

def _hex8(values: np.ndarray) -> np.ndarray:
    """uint32 values as 8-character lowercase hex tokens (bytes), as
    Criteo's categorical columns hold them."""
    digits = np.frombuffer(b"0123456789abcdef", np.uint8)
    v = values.astype(np.uint32)
    nibbles = np.stack([(v >> (4 * (7 - k))) & 0xF for k in range(8)], axis=1)
    return np.ascontiguousarray(digits[nibbles]).view("S8").ravel()


def _join_columns(columns, sep: bytes) -> list:
    """Row-wise ``sep.join`` of equal-length bytes arrays."""
    return [sep.join(row) for row in zip(*(col.tolist() for col in columns))]


def _log1pf(values: np.ndarray) -> np.ndarray:
    """The C library's float32 ``log1pf`` of integer values, the native
    Criteo parser's dense transform (csrc/criteo_native.cpp), 0 where the
    value is not positive."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.log1pf.restype, libm.log1pf.argtypes = ctypes.c_float, [ctypes.c_float]
    uniq = np.unique(values)
    table = np.array([libm.log1pf(float(v)) if v > 0 else 0.0 for v in uniq], np.float32)
    return table[np.searchsorted(uniq, values)]


def write_criteo_file(path: Path, lines: int, seed: int) -> dict:
    """A Criteo TSV in the published line format from ``seed``: label, 13
    integer columns and 26 hex tokens. The rows are ``synthetic_ctr``'s at
    Criteo's shape (26 fields of 100 000 ids; the label depends on the
    ids' pairwise interactions and the dense terms), each id written as a
    hex token of its own per field, each dense value as an integer;
    10% of dense and 5% of categorical fields empty, and a malformed line
    every CRITEO_MALFORMED_EVERY lines. Returns the counts written."""
    dense, cat, label = synthetic_ctr(lines, num_dense=13, vocab_sizes=(100_000,) * 26, seed=seed)
    rng = np.random.default_rng(seed + 1)
    cols = [np.where(label > 0.5, b"1", b"0").astype("S1")]
    ints = np.floor(np.exp(dense + 1.5)).astype(np.int64) - 1  # ints from -1 up
    for d in range(13):
        cols.append(np.where(rng.random(lines) < 0.1, b"", ints[:, d].astype("S12")))
    for f in range(26):
        token = _hex8((cat[:, f].astype(np.uint64) * 2654435761 + f * 40503) & 0xFFFFFFFF)
        cols.append(np.where(rng.random(lines) < 0.05, b"", token))
    rows = _join_columns(cols, b"\t")
    malformed = range(CRITEO_MALFORMED_EVERY // 2, lines, CRITEO_MALFORMED_EVERY)
    for i in malformed:
        rows[i] = b"malformed\tline"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"\n".join(rows) + b"\n")
    return {"lines": lines, "malformed": len(malformed), "bytes": path.stat().st_size}


def criteo_file_config(path: str, **train):
    """``zoo_configs.dcn_criteo(path)``: Criteo's shape (26 fields of 100 000
    rows, d=32, 3 cross layers, MLP 512/256/128, batch 8192, 8 steps a
    dispatch), with ``train`` overrides."""
    cfg = zoo_configs.dcn_criteo(path)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


def criteo_file_lines(cfg, lines: int):
    """``cfg`` reading only the file's first ``lines`` lines."""
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, num_examples=lines))


def phase_criteo_files(card: str, paths: dict) -> dict:
    """(F) A Criteo TSV of CRITEO_LINES lines from the seed; the native
    parser's batches against the Python parser's on its first
    CRITEO_CHECK_LINES lines and its MB/s over the file; ``dcn_criteo(path)``
    trained on the card materialized (its first CRITEO_MATERIALIZED_LINES
    lines) and streamed (``data.streaming``, ``eval_examples``
    STREAM_EVAL_EXAMPLES, a checkpoint after each of 2 epochs), the stream's
    parser asserted native, the four kernels' launches in training and
    eval; 8 steps on the card against the CPU from one state. Returns what
    the later phases read."""
    t_phase = time.perf_counter()
    path = DATA_DIR / "criteo.tsv"
    t0 = time.perf_counter()
    written = write_criteo_file(path, CRITEO_LINES, SEED)
    write_s = time.perf_counter() - t0
    vocabs = [100_000] * 26
    # Both parsers on the first lines: categorical ids and labels bit for bit;
    # dense values bit for bit each parser's own arithmetic (the native one's
    # log1pf in float32, the Python one's float64 log1p rounded), so within 1 ulp.
    head = DATA_DIR / "criteo_head.tsv"
    with open(path, "rb") as src:
        head.write_bytes(b"".join(src.readline() for _ in range(CRITEO_CHECK_LINES)))
    t0 = time.perf_counter()
    py = list(criteo_data.iter_criteo_batches(str(head), 8192, vocabs, drop_remainder=False))
    py_s = time.perf_counter() - t0
    native = list(criteo_native.iter_criteo_batches_native(str(head), 8192, vocabs,
                                                           drop_remainder=False))
    py_d, py_c, py_l = (np.concatenate(a) for a in zip(*py))
    nat_d, nat_c, nat_l = (np.concatenate(a) for a in zip(*native))
    ulps = int(np.abs(nat_d.view(np.int32) - py_d.view(np.int32)).max())
    raw = np.maximum(np.expm1(py_d.astype(np.float64)).round(), 0.0)  # the dense ints back
    print(f"criteo file (F): {written['lines']} lines ({written['malformed']} malformed), "
          f"{written['bytes'] / 1e6:.1f} MB written in {write_s:.1f} s; first {CRITEO_CHECK_LINES} lines: "
          f"{len(py_l)} rows; python parser {py_s:.2f} s; cat and label bit for bit "
          f"{np.array_equal(nat_c, py_c) and np.array_equal(nat_l, py_l)}; dense bit for bit "
          f"{np.array_equal(nat_d, py_d)}, max {ulps} ulp apart "
          f"({int((nat_d != py_d).sum())} of {nat_d.size} values)")
    check(len(py_l) == len(nat_l) == CRITEO_CHECK_LINES - len(range(
        CRITEO_MALFORMED_EVERY // 2, CRITEO_CHECK_LINES, CRITEO_MALFORMED_EVERY)),
        "both parsers skip the malformed lines and read every other line once")
    check(np.array_equal(nat_c, py_c) and np.array_equal(nat_l, py_l),
          "the native parser's categorical ids and labels are the Python parser's bit for bit")
    check(np.array_equal(nat_d, _log1pf(raw)) and np.array_equal(py_d, np.log1p(raw).astype(np.float32))
          and ulps <= 1,
          "each parser's dense values are its own arithmetic bit for bit, within 1 ulp of each other")
    t0 = time.perf_counter()
    rows = sum(len(b[2]) for b in criteo_native.iter_criteo_batches_native(str(path), 8192, vocabs))
    parse_s = time.perf_counter() - t0
    print(f"criteo file (F): native parser {written['bytes'] / 1e6 / parse_s:.1f} MB/s "
          f"({rows} rows in full batches, {parse_s:.2f} s, {os.cpu_count()} host cores; host clock)")

    # Materialized: load_criteo (the Python parser) over the first lines, the
    # last 5% held out, 2 epochs.
    cfg = criteo_file_lines(criteo_file_config(str(path)), CRITEO_MATERIALIZED_LINES)
    trainer, history, train_counts, evals, run_s = run_counted(cfg)
    steps, n_eval = trainer.global_step, len(trainer.ctr_arrays["test"][2])
    eval_batches = -(-n_eval // trainer_mod.EVAL_BATCH)
    print(f"criteo file (F), materialized: {len(trainer.ctr_arrays['train'][2])} train and {n_eval} "
          f"held-out rows, {steps} steps; history {history}; launches in training {train_counts}, "
          f"in each eval pass {evals[0][1]}; run() took {run_s:.1f} s (parse included)")
    check(all(np.isfinite(v) for r in history for v in r.values()), "the history is finite")
    trained = {"gather_rows_multi": steps, "cross_v1_fwd": steps, "cross_v1_bwd": steps,
               "fused_rowwise_adagrad_multi": steps}
    check_launches(train_counts, trained, "training from the file ran one gather, v1 forward, v1 "
                   "backward and Adagrad launch a step, and no other")
    for _, counts in evals:
        check_launches(counts, {"gather_rows_multi": eval_batches, "cross_v1_fwd": eval_batches},
                       "each eval pass ran one gather and one v1 forward launch a batch")
    del trainer

    # Streamed past the eval lines, a checkpoint after each epoch.
    whole_dir = DATA_DIR / "ckpt_whole"
    cfg = criteo_file_config(str(path), checkpoint_dir=str(whole_dir), checkpoint_every_epochs=1)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, streaming=True,
                                                            eval_examples=STREAM_EVAL_EXAMPLES))
    trainer, history, train_counts, evals, run_s = run_counted(cfg)
    steps = trainer.global_step
    eval_batches = -(-len(trainer.ctr_arrays["test"][2]) // trainer_mod.EVAL_BATCH)
    paths["trainer_criteo_file"] = whole_run_launches(train_counts, evals)
    print(f"criteo file (F), streamed: {steps} steps over 2 epochs; history {history}; launches in "
          f"training {train_counts}, in each eval pass {evals[0][1]}; the train "
          f"stream's parser {trainer.stream.parser!r}; checkpoints {sorted(os.listdir(whole_dir))}; run() "
          f"took {run_s:.1f} s; examples_per_s {[round(r['examples_per_s'], 1) for r in history]} ({card})")
    check(trainer.stream is not None and trainer.sampler is trainer.stream, "the trainer streamed the file")
    check(trainer.stream.parser == "native", "the native parser read the train stream")
    check(all(np.isfinite(v) for r in history for v in r.values()), "the history is finite")
    check_launches(train_counts, {k: steps for k in trained}, "the streamed training ran one gather, "
                   "v1 forward, v1 backward and Adagrad launch a step, and no other")
    for _, counts in evals:
        check_launches(counts, {"gather_rows_multi": eval_batches, "cross_v1_fwd": eval_batches},
                       "each eval pass ran one gather and one v1 forward launch a batch")
    check({"dcn_criteo.metrics.jsonl", "step_0000000001", "step_0000000002"} <= set(
        os.listdir(whole_dir)), "a checkpoint after each epoch, beside the run's metric stream")

    # 8 steps on the card against the CPU from one state (phase 11's tolerances).
    t0 = time.perf_counter()
    _, _, losses, finals, _ = card_and_cpu_runs(eight_steps(criteo_file_lines(
        criteo_file_config(str(path)), CRITEO_CARD_VS_CPU_LINES)))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"]))
    auc_err = abs(finals["card"]["auc"] - finals["cpu"]["auc"])
    ll_rel = abs(finals["card"]["logloss"] - finals["cpu"]["logloss"]) / finals["cpu"]["logloss"]
    print(f"criteo file (F), card against the CPU ({time.perf_counter() - t0:.1f} s), 8 steps from one "
          f"state: losses card {losses['card']}, cpu {losses['cpu']} (max relative error {rel:.3e}, "
          f"rtol {TRAIN_LOSS_RTOL}); auc error {auc_err:.3e} (atol {TRAIN_AUC_ATOL}); logloss relative "
          f"error {ll_rel:.3e} (rtol {TRAIN_LOGLOSS_RTOL})")
    check(len(losses["card"]) == len(losses["cpu"]) == 8 and rel <= TRAIN_LOSS_RTOL,
          "the card's losses on the file match the CPU's")
    check(auc_err <= TRAIN_AUC_ATOL and ll_rel <= TRAIN_LOGLOSS_RTOL,
          "the card's eval auc and logloss on the file match the CPU's")
    print(f"phase F took {time.perf_counter() - t_phase:.1f} s")
    return {"path": path, "cfg": cfg, "trainer": trainer, "whole_dir": whole_dir}


def phase_resume(card: str, files: dict) -> None:
    """(G) The streamed run resumed from its epoch-1 checkpoint ends with the
    uninterrupted run's state bit for bit (the reference's answer on the
    CPU, tests/test_torch_checkpoint.py: its resumed run ends as its whole
    run); the save and the restore of the Criteo-shaped state timed."""
    t_phase = time.perf_counter()
    whole, cfg = files["trainer"], files["cfg"]
    half_dir = DATA_DIR / "ckpt_half"
    half_dir.mkdir()
    shutil.copytree(files["whole_dir"] / "step_0000000001", half_dir / "step_0000000001")
    resumed = Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(half_dir), resume=True)), quiet=True)
    check(resumed.start_epoch == 1, "resume starts after the checkpoint's epoch")
    history = resumed.train()
    torch.cuda.synchronize()
    same = states_equal(resumed.state, whole.state)
    print(f"resume (G): from step_0000000001, history {history}; final state bit for bit the "
          f"uninterrupted run's: {same}")
    check([r["epoch"] for r in history] == [1] and same,
          "the resumed run ends with the uninterrupted run's state bit for bit")

    flat = whole.checkpoint_state()
    tables = sum(v.nbytes for k, v in flat.items() if k.startswith("tables/"))
    total = sum(v.nbytes for v in flat.values())
    save_dir = DATA_DIR / "ckpt_timed"
    times = {"save": [], "restore": []}
    for step in (1, 2, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(str(save_dir), step, whole.checkpoint_state())
        times["save"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        back = whole.restore(str(save_dir), step)
        torch.cuda.synchronize()
        times["restore"].append((time.perf_counter() - t0) * 1e3)
    check(states_equal(back, whole.state), "a saved and restored state is the trainer's bit for bit")
    print(f"checkpoint (G): {len(flat)} leaves, {tables / 1e6:.1f} MB of tables, {total / 1e6:.1f} MB in "
          f"all (tables, Adagrad and Adam state); save (device to host, .npy files) "
          f"{statistics.median(times['save']):.1f} ms, restore (files to the card) "
          f"{statistics.median(times['restore']):.1f} ms, medians of 3 (host clock; {card})")
    print(f"phase G took {time.perf_counter() - t_phase:.1f} s")


def phase_serve_checkpoint(card: str, paths: dict, files: dict) -> None:
    """(H) ``Recommender.from_checkpoint`` serves the streamed run's last
    checkpoint: ``predict_ctr`` for 8192 held-out requests bit for bit
    ``from_trainer``'s, one gather and one v1 forward launch a call."""
    t_phase = time.perf_counter()
    cfg = files["cfg"]
    t0 = time.perf_counter()
    cold = Recommender.from_checkpoint(cfg)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    live = Recommender.from_trainer(files["trainer"])
    dense, cat, _ = files["trainer"].ctr_arrays["test"]
    dense, cat = dense[:BATCH], cat[:BATCH]
    want = live.predict_ctr(dense, cat)
    reset_launches()
    got = cold.predict_ctr(dense, cat)
    torch.cuda.synchronize()
    paths["serve_ckpt"] = read_launches()
    ms, p99 = latency(lambda: cold.predict_ctr(dense, cat))
    print(f"serve from checkpoint (H): from_checkpoint {cold_s:.2f} s cold start (model, eval slice, "
          f"restore; host clock); predict_ctr of {len(got)} requests bit for bit from_trainer's "
          f"{np.array_equal(got, want)}, launches {paths['serve_ckpt']}; latency median {ms:.3f} ms, "
          f"p99 {p99:.3f} ms (host clock; {card})")
    check(cold.device.type == "cuda" and np.array_equal(got, want) and np.isfinite(got).all(),
          "from_checkpoint serves on the card, bit for bit from_trainer's answers")
    check_launches(paths["serve_ckpt"], {"gather_rows_multi": 1, "cross_v1_fwd": 1},
                   "serving from the checkpoint ran one gather and one v1 forward launch, and no other")
    print(f"phase H took {time.perf_counter() - t_phase:.1f} s")


def write_ml1m_files(root: Path, seed: int) -> dict:
    """ML-1M's ratings.dat, users.dat and movies.dat in its ``::`` format from
    ``seed``, at its shape: the interactions of ``synthetic_implicit`` at
    6040 users x 3706 items (ML1M_PER_USER a user, ~1M ratings), ids 1-based,
    ratings 1-5 and timestamps drawn; each user's gender, age bucket,
    occupation and zip code, each movie's title and 1-3 of ML-1M's 18
    genres."""
    inter = synthetic_implicit(num_users=ML1M_USERS, num_items=ML1M_ITEMS,
                               interactions_per_user=ML1M_PER_USER, seed=seed)
    rng = np.random.default_rng(seed + 2)
    n = len(inter)
    ratings = _join_columns([(inter.users + 1).astype("S8"), (inter.items + 1).astype("S8"),
                             rng.integers(1, 6, n).astype("S1"),
                             rng.integers(956_703_932, 1_046_454_590, n).astype("S10")], b"::")
    genres = ["Action", "Adventure", "Animation", "Children's", "Comedy", "Crime", "Documentary",
              "Drama", "Fantasy", "Film-Noir", "Horror", "Musical", "Mystery", "Romance", "Sci-Fi",
              "Thriller", "War", "Western"]
    users = [f"{u}::{'MF'[rng.integers(0, 2)]}::{rng.choice([1, 18, 25, 35, 45, 50, 56])}::"
             f"{rng.integers(0, 21)}::{rng.integers(10000, 99999)}" for u in range(1, ML1M_USERS + 1)]
    movies = [f"{m}::Movie {m} ({rng.integers(1919, 2001)})::"
              + "|".join(rng.choice(genres, rng.integers(1, 4), replace=False))
              for m in range(1, ML1M_ITEMS + 1)]
    root.mkdir(parents=True, exist_ok=True)
    files = {"ratings": root / "ratings.dat", "users": root / "users.dat", "movies": root / "movies.dat"}
    files["ratings"].write_bytes(b"\n".join(ratings) + b"\n")
    files["users"].write_text("\n".join(users) + "\n", encoding="latin-1")
    files["movies"].write_text("\n".join(movies) + "\n", encoding="latin-1")
    return {k: str(v) for k, v in files.items()}


def phase_movielens_files(card: str, paths: dict) -> None:
    """(I) ML-1M's files from the seed; the native UIRT parser against the
    Python loop; ``fm_ctr_ml1m(path)`` with ML-1M's side-feature files for
    FM_FILES_EPOCHS epoch on the card (one gather and one Adagrad launch a step); NeuMF
    warm started from a 1-epoch GMF checkpoint (``init_from``)."""
    t_phase = time.perf_counter()
    files = write_ml1m_files(DATA_DIR / "ml-1m", SEED)
    t0 = time.perf_counter()
    native = movielens.load_uirt_raw(files["ratings"], native=True)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = movielens.load_uirt_raw(files["ratings"], native=False)
    python_s = time.perf_counter() - t0
    same = all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(native, python))
    print(f"movielens files (I): {len(native[0])} ratings of {len(np.unique(native[0]))} users and "
          f"{len(np.unique(native[1]))} items; native parser {native_s:.2f} s, Python loop {python_s:.2f} s "
          f"(host clock); equal array for array: {same}")
    check(same, "the native UIRT parser reads the Python loop's arrays")

    cfg = zoo_configs.fm_ctr_ml1m(files["ratings"])
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, user_features_path=files["users"],
                                      item_features_path=files["movies"]),
        train=dataclasses.replace(cfg.train, epochs=FM_FILES_EPOCHS, eval_every_epochs=FM_FILES_EPOCHS))
    trainer, history, train_counts, evals, run_s = run_counted(cfg)
    steps = trainer.global_step
    paths["trainer_fm_files"] = whole_run_launches(train_counts, evals)
    print(f"movielens files (I), fm_ctr_ml1m(path) with users.dat and movies.dat: field vocabs "
          f"{trainer.data_spec.field_vocabs}, {len(trainer.dataset.train)} train interactions, {steps} "
          f"steps over {FM_FILES_EPOCHS} epoch; history {history}; auc {history[-1]['auc']:.6f}; launches in training "
          f"{train_counts}, in the eval pass {evals[0][1]}; run() took {run_s:.1f} s ({card})")
    check(len(trainer.data_spec.field_vocabs) == 6 and all(np.isfinite(v) for r in history
                                                           for v in r.values()),
          "FM reads the side fields of the files and its history is finite")
    check_launches(train_counts, {"gather_rows_multi": steps, "fused_rowwise_adagrad_multi": steps},
                   "FM over the files ran one gather and one Adagrad launch a step, and no other")
    del trainer

    gmf_dir = DATA_DIR / "ckpt_gmf"
    base = zoo_configs.neumf_ml20m(files["ratings"])
    gmf = dataclasses.replace(base, run_name="gmf", model=dataclasses.replace(base.model, name="gmf"),
                              train=dataclasses.replace(base.train, epochs=1, eval_every_epochs=0,
                                                        checkpoint_dir=str(gmf_dir),
                                                        checkpoint_every_epochs=1))
    run(gmf, quiet=True)
    neumf_dir = DATA_DIR / "neumf_stream"
    neumf = dataclasses.replace(base, train=dataclasses.replace(
        base.train, epochs=1, eval_every_epochs=0, init_from=str(gmf_dir),
        checkpoint_dir=str(neumf_dir)))
    warm = Trainer(neumf, quiet=True)
    tables = checkpoint.load_table_arrays(str(gmf_dir))
    event = next(json.loads(x) for x in open(neumf_dir / "neumf_ml20m.metrics.jsonl")
                 if '"warm_start"' in x)
    copied = all(np.array_equal(warm.state["tables"][t].cpu().numpy(), tables[s])
                 for t, s in (("user_gmf", "user_emb"), ("item_gmf", "item_emb"),
                              ("user_mlp", "user_emb"), ("item_mlp", "item_emb")))
    loss = warm.train()[-1]["loss"]
    print(f"movielens files (I), neumf warm started from a 1-epoch gmf checkpoint: event {event}; "
          f"the four tables are gmf's {copied}; one epoch after it, loss {loss:.6f}")
    check(event["copied"] == ["item_gmf", "item_mlp", "user_gmf", "user_mlp"] and event["skipped"] == []
          and copied and np.isfinite(loss), "the warm_start event lists the copied tables")
    print(f"phase I took {time.perf_counter() - t_phase:.1f} s")


def phase_cli(card: str, files: dict) -> None:
    """(J) ``python -m tfrec_tpu_torch.cli --config dcn_criteo --data_path
    <F's file>`` as a process of its own on the card, its last line parsed."""
    t_phase = time.perf_counter()
    cmd = [sys.executable, "-m", "tfrec_tpu_torch.cli", "--config", "dcn_criteo", "--data_path",
           str(files["path"]), "--device", DEVICE, *CLI_OVERRIDES]
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=600)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"cli (J): {' '.join(cmd[1:])} exited {proc.returncode}; last line {last}")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0, "the CLI ran")
    rec = json.loads(last)
    check(rec["epoch"] == 0 and all(np.isfinite(rec[k]) for k in ("loss", "auc", "logloss")),
          "the CLI's last line is the epoch's finite record with auc and logloss")
    print(f"phase J took {time.perf_counter() - t_phase:.1f} s")


# ---- every table layout and duplicate combine of the step (phase K) ----

# name: (model overrides, host sorts)
LAYOUT_MODES = {
    "per-field": ({}, False),
    "lane-packed": ({"lane_pack": True}, False),
    "stacked": ({"stack_tables": True}, False),
    "host sorts": ({}, True),
}


def layout_state(model, builder, start):
    """``start``, a per-field train state at step 0, in ``model``'s table
    layout: the per-field tables joined into it, the sparse optimizer's
    step-0 state (its initial values), the dense params and their
    optimizer state copied."""
    zeros = {spec.name: torch.zeros(spec.shape, device=DEVICE) for spec in model.table_specs()}
    tables = model.join_fields(start["tables"], zeros)
    sparse = {spec.name: builder.sparse_opt.init(tables[spec.name], lane_groups=spec.lane_groups)
              for spec in model.table_specs()}
    rest = copy_state({"dense": start["dense"], "dense_opt": start["dense_opt"]})
    return {"step": start["step"], "tables": tables, "sparse_opt": sparse, **rest}


def per_field_view(model, state) -> tuple:
    """(per-field tables, per-field accumulators) of a state in any layout."""
    accs = {name: s["acc"] for name, s in state["sparse_opt"].items()}
    return model.split_fields(state["tables"]), model.split_fields(accs, stat=True)


def sparse_kernel_checks(builder, state, batch, label: str, records: dict) -> None:
    """The gather and the Adagrad kernel at ``builder``'s tables on
    ``batch``'s ids and combined gradients: one launch each, bit for bit
    their plain versions and on repeat; their device times beside their
    bounds, plain versions and (the gather) ``index_select``, into
    ``records`` under ``label``."""
    model = builder.model
    ids = model.lookup_ids(batch)
    tables, field_ids = [state["tables"][n] for n in ids], list(ids.values())
    got, launches = launches_of(gather_rows_multi, lambda: gather_rows_multi(tables, field_ids))
    again = gather_rows_multi(tables, field_ids)
    want = gather_rows_multi_ref(tables, field_ids)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    repeat = all(torch.equal(g, a) for g, a in zip(got, again))
    print(f"gather_rows_multi at {label} {[(tuple(t.shape), i.shape[0]) for t, i in zip(tables, field_ids)]}: "
          f"{launches} launch, bit for bit the plain version {bitwise}, on repeat {repeat}")
    check(launches == 1 and bitwise and repeat,
          f"gather_rows_multi at {label}: one launch, bit for bit its plain version and on repeat")
    del got, again, want
    records["gather_rows_multi"][label] = gather_times(tables, field_ids, label)

    _, _, row_grads, _ = builder.loss_and_grads(state, batch)
    lr, eps = builder.sparse_schedule(state["step"]), builder.optim_cfg.eps
    uids, grads = [], []
    for name, i in ids.items():
        u, g = combine_duplicate_ids(i, row_grads[name], sentinel=state["tables"][name].shape[0])
        uids.append(u)
        grads.append(g)
    accs = [state["sparse_opt"][n]["acc"] for n in ids]

    def copies():
        return [t.clone() for t in tables], [a.clone() for a in accs]

    (got_t, got_a), launches = launches_of(
        fused_rowwise_adagrad_multi, lambda: fused_rowwise_adagrad_multi(*copies(), uids, grads, lr, eps))
    again_t, again_a = fused_rowwise_adagrad_multi(*copies(), uids, grads, lr, eps)
    ref_t, ref_a = fused_rowwise_adagrad_multi_ref(*copies(), uids, grads, lr, eps)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, e) for a, e in zip(got_t + got_a, ref_t + ref_a))
    repeat = all(torch.equal(a, e) for a, e in zip(got_t + got_a, again_t + again_a))
    err = max(max_err(a, e) for a, e in zip(got_t + got_a, ref_t + ref_a))
    groups = [a.shape[1] if a.dim() == 2 else 1 for a in accs]
    distinct = [int((u < t.shape[0]).sum().item()) for u, t in zip(uids, tables)]
    print(f"fused_rowwise_adagrad_multi at {label}, lane groups {groups}, distinct real ids a table "
          f"{distinct}: {launches} launch, bit for bit the plain version {bitwise}, on repeat {repeat}")
    check(launches == 1 and bitwise and repeat,
          f"fused_rowwise_adagrad_multi at {label}: one launch, bit for bit its plain version and on repeat")
    del got_t, got_a, again_t, again_a, ref_t, ref_a
    work = list(zip(*copies(), uids, grads))
    records["fused_rowwise_adagrad_multi"][label] = {
        **adagrad_times(work, lr, label), "groups": groups, "distinct_ids": distinct, "max_abs_err": err}


def phase_layouts(card: str, paths: dict) -> dict:
    """(K) ``dcn_criteo`` at Criteo's shape (26 x 100 000, d=32, B=8192,
    Zipf(1.2) ids) in every table layout and duplicate combine of the step:
    8 ``multi_step`` steps from one state (made per-field, then joined into
    each layout) per mode; every mode's losses, tables and accumulators bit
    for bit the per-field run's, its launches counted; each mode's step median
    (host clock, in turns) and a profile of one step; the gather and Adagrad
    kernels at the packed (7 packs: D = 128 at G = 4, and 64 at G = 2) and
    stacked ([2 600 000, 32], 212 992 ids) shapes beside their bounds, plain
    versions and ``index_select``; the host's sorts of a batch. Returns the
    kernels' records by shape."""
    t_phase = time.perf_counter()
    cfg = configs()["v1"]
    vocabs = tuple(cfg.data.categorical_vocab_sizes)
    spec = DataSpec.ctr(vocabs, cfg.data.num_dense_features)
    k = cfg.train.steps_per_dispatch
    dense, cat, label = synthetic_ctr(k * BATCH, cfg.data.num_dense_features, vocabs, seed=SEED + 5)
    host = [{"dense": dense[i * BATCH:(i + 1) * BATCH], "cat": cat[i * BATCH:(i + 1) * BATCH],
             "label": label[i * BATCH:(i + 1) * BATCH]} for i in range(k)]
    stacked = {key: to_device(np.stack([b[key] for b in host])) for key in host[0]}
    runs, builders, states = {}, {}, {}
    start = None
    for mode, (overrides, host_sorts) in LAYOUT_MODES.items():
        model = build_model(dataclasses.replace(cfg.model, **overrides), spec)
        builder = TrainStepBuilder(model, cfg.train.loss, cfg.optim)
        if start is None:  # the per-field mode, first
            start = builder.init_state(torch.Generator(device=DEVICE).manual_seed(SEED))
            state = copy_state(start)
        else:
            state = layout_state(model, builder, start)
        batches = stacked
        if host_sorts:
            sorts = [host_dedup_sorts(model, b) for b in host]
            batches = {**stacked, **{key: to_device(np.stack([s[key] for s in sorts])) for key in sorts[0]}}
        builders[mode], states[mode] = builder, copy_state(state)
        reset_launches()
        state, metrics = builder.multi_step(state, batches)
        torch.cuda.synchronize()
        launches = {n: c for n, c in read_launches().items() if c}
        paths["layouts_" + re.sub(r"\W+", "_", mode)] = read_launches()
        runs[mode] = (metrics["loss"], metrics["loss_mean"], *per_field_view(model, state))
        ref = runs["per-field"]
        same = (torch.equal(runs[mode][0], ref[0]) and torch.equal(runs[mode][1], ref[1])
                and all(torch.equal(runs[mode][2][n], ref[2][n]) for n in ref[2])
                and all(torch.equal(runs[mode][3][n], ref[3][n]) for n in ref[3]))
        tables = {s.name: (s.shape, s.lane_groups) for s in model.table_specs()}
        print(f"layouts (K) {mode}: {len(tables)} tables {tables if len(tables) < 10 else ''}; {k} steps, "
              f"launches {launches}; loss_mean {runs[mode][1].item():.6f}; losses, tables and accumulators bit "
              f"for bit the per-field run's: {same}")
        check(same, f"{mode}: {k} steps bit for bit the per-field steps")
        check(launches.get("gather_rows_multi") == k and launches.get("fused_rowwise_adagrad_multi") == k
              and launches.get("cross_v1_fwd") == k and launches.get("cross_v1_bwd") == k
              and len(launches) == 4,
              f"{mode}: one gather, Adagrad, v1 forward and backward launch a step, and no other")
        del state, metrics

    # Each mode's step on one batch, in turns, then a profile of one step.
    batch = {key: v[0] for key, v in stacked.items()}
    sorts0 = {key: to_device(v) for key, v in host_dedup_sorts(builders["host sorts"].model, host[0]).items()}

    def stepper(mode):
        b = {**batch, **sorts0} if LAYOUT_MODES[mode][1] else batch

        def run_step():
            states[mode], _ = builders[mode].step(states[mode], b)
        return run_step

    steps = {mode: stepper(mode) for mode in LAYOUT_MODES}
    medians = medians_in_turns(steps)
    print(f"layouts (K): train step of {BATCH} (host clock, batch on the card), median over 10 steps in turns: "
          + ", ".join(f"{mode} {ms:.3f} ms" for mode, ms in medians.items()) + f" ({card})")
    for mode, run_step in steps.items():
        profile(run_step, f"train step ({mode})", medians[mode])
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        sort_ms = []
        for b in host:
            t0 = time.perf_counter()
            host_dedup_sorts(builders["host sorts"].model, b, pool)
            sort_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"layouts (K): host_dedup_sorts of a batch (26 tables of {BATCH} ids, {min(8, os.cpu_count() or 1)} "
          f"threads; host clock, median of {len(sort_ms)}): {statistics.median(sort_ms):.3f} ms")

    records = {"gather_rows_multi": {}, "fused_rowwise_adagrad_multi": {}}
    for mode, label in (("lane-packed", "dcn_packed"), ("stacked", "dcn_stacked")):
        sparse_kernel_checks(builders[mode], layout_state(builders[mode].model, builders[mode], start), batch,
                             label, records)
    del builders, states, stacked, batch
    print(f"phase K (DCN) took {time.perf_counter() - t_phase:.1f} s")
    return records


def phase_fm_packed(card: str, paths: dict, records: dict, per_field: list) -> dict:
    """(K) ``trainer.run(fm_ctr_ml1m())`` with ``model.lane_pack=True`` on
    the card for its first FM_PACKED_EPOCHS epochs: 3 packs of 2 fields
    ([6040, 128], [21, 128], [7, 128], G = 2) and ``linpack_0`` [6040, 6]
    (G = 6); each epoch's loss bit for bit the per-field run's
    (``per_field``, phase 17's history: the same seed's init is
    layout-invariant and the packed step is the per-field step); one gather
    and one Adagrad launch a step; the kernels at its shapes; its
    checkpoint saved after the last epoch, resumed under AUTO (the saved
    layout taken) bit for bit, and served by ``from_checkpoint`` bit for
    bit ``from_trainer``. Returns the record of the Adagrad kernel on
    lane-grouped tables."""
    t_phase = time.perf_counter()
    base = zoo_configs.fm_ctr_ml1m()
    ckpt = DATA_DIR / "fm_packed"
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, lane_pack=True),
        train=dataclasses.replace(base.train, epochs=FM_PACKED_EPOCHS, checkpoint_dir=str(ckpt),
                                  checkpoint_every_epochs=FM_PACKED_EPOCHS))
    trainer, history, train_counts, evals, run_s = run_counted(cfg)
    steps = trainer.global_step
    paths["trainer_fm_packed"] = whole_run_launches(train_counts, evals)
    tables = {s.name: (s.shape, s.lane_groups) for s in trainer.model.table_specs()}
    rec = history[-1]
    rates = [r["examples_per_s"] for r in history]
    print(f"config 2 lane-packed (K): tables {tables}; {steps} steps; history {history}; launches in training "
          f"{train_counts}, in each eval pass {evals[0][1]}; examples_per_s median "
          f"{statistics.median(rates):.1f}; run() took {run_s:.1f} s ({card})")
    check(list(tables) == ["pack_0", "pack_1", "pack_2", "linpack_0"], "config 2 packs as the reference does")
    check_launches(train_counts, {"gather_rows_multi": steps, "fused_rowwise_adagrad_multi": steps},
                   "config 2 packed: one gather and one Adagrad launch a step, and no other")
    packed, want = [r["loss"] for r in history], [r["loss"] for r in per_field[:FM_PACKED_EPOCHS]]
    print(f"config 2 lane-packed: its {FM_PACKED_EPOCHS} epochs' losses {packed}, the per-field run's (phase 17) "
          f"{want}: bit for bit {packed == want}; auc after them {rec['auc']:.6f}")
    check(packed == want, "config 2 lane-packed trains bit for bit the per-field run's epochs")

    batch = trainer._to_device_batch(trainer._host_batch(next(trainer.sampler.epoch(0)), train=False))
    sparse_kernel_checks(trainer.builder, trainer.state, batch, "fm_packed", records)

    auto = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, lane_pack=None),
                               train=dataclasses.replace(cfg.train, resume=True))
    resumed = Trainer(auto, quiet=True, log_metrics=False)
    same = resumed.model.lane_pack and resumed.start_epoch == FM_PACKED_EPOCHS and states_equal(
        resumed.state, trainer.state)
    one, _ = trainer.builder.step(copy_state(trainer.state), batch)
    two, _ = resumed.builder.step(copy_state(resumed.state), batch)
    torch.cuda.synchronize()
    same_step = states_equal(one, two)
    print(f"config 2 lane-packed checkpoint: resumed under lane_pack=None as packed {resumed.model.lane_pack}, "
          f"from epoch {resumed.start_epoch}, its state bit for bit the trainer's {same}, a step from each bit "
          f"for bit {same_step}")
    check(same and same_step, "the packed checkpoint resumes bit for bit")
    del one, two, resumed

    host = trainer._host_batch(next(trainer.sampler.epoch(1)), train=False)
    live = Recommender.from_trainer(trainer).predict_ctr(host["dense"], host["cat"])
    cold = Recommender.from_checkpoint(cfg)
    reset_launches()
    got = cold.predict_ctr(host["dense"], host["cat"])
    torch.cuda.synchronize()
    paths["serve_fm_packed"] = read_launches()
    per_field = Recommender.from_checkpoint(dataclasses.replace(auto, train=dataclasses.replace(
        cfg.train, resume=False)))
    unpacked = per_field.predict_ctr(host["dense"], host["cat"])
    print(f"config 2 lane-packed serving: from_checkpoint ({[n for n in cold.params['tables']]}) bit for bit "
          f"from_trainer {np.array_equal(got, live)}, launches {paths['serve_fm_packed']}; from_checkpoint "
          f"per-field (AUTO, {len(per_field.params['tables'])} tables) bit for bit {np.array_equal(unpacked, live)}")
    check(cold.model.lane_pack and np.array_equal(got, live) and np.isfinite(got).all(),
          "from_checkpoint serves the packed model bit for bit from_trainer's answers")
    check_launches(paths["serve_fm_packed"], {"gather_rows_multi": 1}, "packed serving: one gather launch")
    check(np.allclose(unpacked, live, rtol=LOGIT_TOL, atol=LOGIT_TOL),
          "the packed checkpoint served per-field gives the packed answers")
    print(f"phase K (config 2 lane-packed) took {time.perf_counter() - t_phase:.1f} s")
    fm = records["fused_rowwise_adagrad_multi"]
    return {"name": GROUPED, "route": "cuda", "max_abs_err": max(fm[k]["max_abs_err"] for k in ("dcn_packed",
                                                                                               "fm_packed")),
            **{key: fm["dcn_packed"][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None, "at": "dcn_packed", "groups": fm["dcn_packed"]["groups"],
            "fm_packed": fm["fm_packed"],
            "reference_route": "XLA (tfrec_tpu/ops/sparse_optim.py:365 fused_adagrad_gate leaves lane-grouped "
                               "tables to it)"}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def captured_sparse_calls(builder, state, batch) -> dict:
    """The owner's gather and Adagrad calls of one sharded step, as called:
    {"gather": (tables, request ids), "adagrad": (tables, accs, uids,
    grads, lr, eps)}, each input copied before the call."""
    seen = {}
    gather, adagrad = sharded_embedding.gather_many, sparse_optim.fused_rowwise_adagrad_multi

    def gather_spy(tables, ids):
        seen["gather"] = (list(tables), [i.clone() for i in ids])
        return gather(tables, ids)

    def adagrad_spy(tables, accs, uids, grads, lr, eps):
        seen["adagrad"] = ([t.clone() for t in tables], [a.clone() for a in accs],
                           [u.clone() for u in uids], [g.clone() for g in grads], lr, eps)
        return adagrad(tables, accs, uids, grads, lr, eps)

    sharded_embedding.gather_many, sparse_optim.fused_rowwise_adagrad_multi = gather_spy, adagrad_spy
    try:
        builder.step(state, batch)
        torch.cuda.synchronize()
    finally:
        sharded_embedding.gather_many, sparse_optim.fused_rowwise_adagrad_multi = gather, adagrad
    return seen


def sharded_kernel_checks(builder, state, batch, key: str = "sharded") -> dict:
    """The gather and Adagrad kernels at the sharded step's shapes (the
    owner's gather of the received requests, the owner's update after the
    receive-side combine), on one step's own inputs: one launch each, bit
    for bit their plain versions and on repeat; times beside bounds, plain
    versions and ``index_select``; the records under ``key``."""
    seen = captured_sparse_calls(builder, state, batch)
    tables, ids = seen["gather"]
    got, launches = launches_of(gather_rows_multi, lambda: gather_rows_multi(tables, ids))
    again, want = gather_rows_multi(tables, ids), gather_rows_multi_ref(tables, ids)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    repeat = all(torch.equal(g, a) for g, a in zip(got, again))
    print(f"gather_rows_multi at the sharded step's owner gather ({len(tables)} blocks {tuple(tables[0].shape)}, "
          f"{ids[0].shape[0]} requests each): {launches} launch, bit for bit the plain version {bitwise}, on repeat "
          f"{repeat}")
    check(launches == 1 and bitwise and repeat,
          "gather_rows_multi at the sharded shapes: one launch, bit for bit its plain version and on repeat")
    records = {"gather_rows_multi": {key: {**gather_times(tables, ids, f"the {key} owner gather"),
                                           "max_abs_err": 0.0}}}
    del got, again, want
    tabs, accs, uids, grads, lr, eps = seen["adagrad"]

    def copies():
        return [t.clone() for t in tabs], [a.clone() for a in accs]

    (got_t, got_a), launches = launches_of(
        fused_rowwise_adagrad_multi, lambda: fused_rowwise_adagrad_multi(*copies(), uids, grads, lr, eps))
    again_t, again_a = fused_rowwise_adagrad_multi(*copies(), uids, grads, lr, eps)
    ref_t, ref_a = fused_rowwise_adagrad_multi_ref(*copies(), uids, grads, lr, eps)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, e) for a, e in zip(got_t + got_a, ref_t + ref_a))
    repeat = all(torch.equal(a, e) for a, e in zip(got_t + got_a, again_t + again_a))
    err = max(max_err(a, e) for a, e in zip(got_t + got_a, ref_t + ref_a))
    distinct = [int((u < t.shape[0]).sum().item()) for u, t in zip(uids, tabs)]
    print(f"fused_rowwise_adagrad_multi at the sharded step's owner update ({len(tabs)} blocks, {uids[0].shape[0]} "
          f"combined slots each, distinct real ids {min(distinct)}-{max(distinct)}): {launches} launch, bit for "
          f"bit the plain version {bitwise}, on repeat {repeat}")
    check(launches == 1 and bitwise and repeat,
          "fused_rowwise_adagrad_multi at the sharded shapes: one launch, bit for bit its plain version and on repeat")
    del got_t, got_a, again_t, again_a, ref_t, ref_a
    records["fused_rowwise_adagrad_multi"] = {key: {
        **adagrad_times(list(zip(*copies(), uids, grads)), lr, f"the {key} owner update"),
        "distinct_ids": distinct, "max_abs_err": err}}
    return records


def sharded_config(**train):
    """Config 5 at Criteo's shape (26 fields of 100 000 rows; the data
    synthetic), its train section overridden by ``train``."""
    cfg = zoo_configs.dcn_multihost(path="criteo")
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


def phase_sharded_step(card: str, paths: dict) -> dict:
    """(L1) The sharded step at world 1 over NCCL: ``ShardedTrainStepBuilder``
    for config 5 at Criteo's shape, 8 steps of 8192 (Zipf(1.2) ids) from one
    state, its init the single-device one bit for bit; at the f32 wire within
    tolerance of the single-device step on every table, accumulator and dense
    leaf, repeating bit for bit, no id dropped, its launches and collectives
    counted; at the bf16 wire its losses within 1e-3 of the f32 run's; host
    medians in turns and profiles beside the single-device step's; the
    gather and Adagrad kernels at its shapes. Returns their records."""
    t_phase = time.perf_counter()
    device = init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, backend="nccl", device=DEVICE)
    try:
        mesh = make_mesh(-1, 1, device=DEVICE)
        cfg = sharded_config()
        vocabs = tuple(cfg.data.categorical_vocab_sizes)
        model = build_model(cfg.model, DataSpec.ctr(vocabs, cfg.data.num_dense_features))
        k = cfg.train.steps_per_dispatch
        dense, cat, label = synthetic_ctr(k * BATCH, cfg.data.num_dense_features, vocabs, seed=SEED + 5)
        batches = [{"dense": to_device(dense[i * BATCH:(i + 1) * BATCH]),
                    "cat": to_device(cat[i * BATCH:(i + 1) * BATCH]),
                    "label": to_device(label[i * BATCH:(i + 1) * BATCH])} for i in range(k)]
        single = TrainStepBuilder(model, cfg.train.loss, cfg.optim)
        start = single.init_state(torch.Generator(device=DEVICE).manual_seed(SEED))
        builders = {wire: ShardedTrainStepBuilder(model, cfg.train.loss, cfg.optim, mesh,
                                                  dataclasses.replace(cfg.mesh, a2a_dtype=wire))
                    for wire in ("float32", "bfloat16")}
        sharded_start = builders["float32"].init_state(torch.Generator(device=DEVICE).manual_seed(SEED))
        print(f"sharded (L1): world 1 over {mesh.backend} on {device} ({card}); {len(vocabs)} tables of "
              f"{vocabs[0]} rows, rows a rank {builders['float32'].plans['field_0'].rows_per_shard}; the init "
              f"bit for bit the single-device one: {states_equal(sharded_start, start)}")
        check(states_equal(sharded_start, start), "the sharded init is the single-device init at world 1")

        def run(builder, state):
            losses, overflow = [], 0
            for b in batches:
                state, metrics = builder.step(state, b)
                losses.append(metrics["loss"])
                overflow = overflow + metrics.get("lookup_overflow", 0)
            torch.cuda.synchronize()
            return state, torch.stack(losses), int(overflow)

        want, want_losses, _ = run(single, copy_state(start))
        reset_launches()
        mesh.calls = 0
        got, losses, overflow = run(builders["float32"], copy_state(sharded_start))
        paths["train_sharded"] = read_launches()
        calls = mesh.calls
        launches = {n: c for n, c in paths["train_sharded"].items() if c}
        print(f"sharded (L1): {k} steps, launches {launches}, collectives {calls} ({calls / k:.0f} a step), ids "
              f"dropped {overflow}; losses {[round(x, 6) for x in losses.tolist()]}")
        check(launches == {"gather_rows_multi": k, "cross_v1_fwd": k, "cross_v1_bwd": k,
                           "fused_rowwise_adagrad_multi": k},
              "the sharded step: one owner gather, Adagrad, v1 forward and backward launch a step, and no other")
        check(calls == SHARDED_CALLS_A_STEP * k, f"{SHARDED_CALLS_A_STEP} collectives a sharded step")
        check(overflow == 0, "no id dropped at world 1")
        pairs = [("tables", got["tables"], want["tables"]),
                 ("accumulators", {n: s["acc"] for n, s in got["sparse_opt"].items()},
                  {n: s["acc"] for n, s in want["sparse_opt"].items()}),
                 ("dense", dict(enumerate(tree_leaves(got["dense"]))), dict(enumerate(tree_leaves(want["dense"]))))]
        for what, a, b in pairs:
            err = max(max_err(a[n], b[n]) for n in b)
            close = all(torch.allclose(a[n], b[n], rtol=SHARDED_RTOL, atol=SHARDED_ATOL) for n in b)
            same = all(torch.equal(a[n], b[n]) for n in b)
            print(f"sharded (L1) against the single-device step, {what}: max_abs_err {err:.3e}, bit for bit "
                  f"{same} (rtol {SHARDED_RTOL}, atol {SHARDED_ATOL})")
            check(close, f"the sharded step's {what} match the single-device step's")
        check(torch.allclose(losses, want_losses, rtol=SHARDED_RTOL), "the sharded losses match")
        again, again_losses, _ = run(builders["float32"], copy_state(sharded_start))
        check(states_equal(again, got) and torch.equal(again_losses, losses), "the sharded step repeats bit for bit")
        del want, again
        _, bf16_losses, bf16_overflow = run(builders["bfloat16"], copy_state(sharded_start))
        gap = (bf16_losses - losses).abs().max().item()
        print(f"sharded (L1) bf16 wire: losses {[round(x, 6) for x in bf16_losses.tolist()]}, max gap to the f32 "
              f"wire {gap:.3e} (limit {SHARDED_BF16_LOSS_ATOL}); repeats bit for bit: True; ids dropped {bf16_overflow}")
        check(bool(torch.isfinite(bf16_losses).all()) and gap <= SHARDED_BF16_LOSS_ATOL,
              "the bf16 wire's losses lie within 1e-3 of the f32 wire's")
        del got

        states = {"single-device": copy_state(start), "sharded f32": copy_state(sharded_start),
                  "sharded bf16": copy_state(sharded_start)}
        steppers = {"single-device": single, "sharded f32": builders["float32"],
                    "sharded bf16": builders["bfloat16"]}

        def stepper(name):
            def run_step():
                states[name], _ = steppers[name].step(states[name], batches[0])
            return run_step

        steps = {name: stepper(name) for name in steppers}
        medians = medians_in_turns(steps)
        print(f"sharded (L1): train step of {BATCH} (host clock, batch on the card), median over 10 steps in turns: "
              + ", ".join(f"{name} {ms:.3f} ms" for name, ms in medians.items()) + f" ({card})")
        for name, run_step in steps.items():
            profile(run_step, f"train step ({name})", medians[name])
        mesh.calls = 0
        steps["sharded f32"]()
        print(f"sharded (L1): NCCL calls a step {mesh.calls}")
        del states
        records = sharded_kernel_checks(builders["float32"], copy_state(sharded_start), batches[0])
    finally:
        torch.distributed.destroy_process_group()
    print(f"phase L1 took {time.perf_counter() - t_phase:.1f} s")
    return records


def sharded_rank(rank: int, port: int, ckpt_dir: str) -> int:
    """One of phase L2's ranks (``chip_smoke.py --sharded-rank R PORT DIR``):
    ``trainer.run(dcn_multihost())`` whole, with a checkpoint an epoch,
    over gloo on the one card; its history, launches and time as
    ``DIR/rank<R>.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"tcp://127.0.0.1:{port}", SHARDED_RANKS, rank, backend="gloo", device=DEVICE)
    try:
        cfg = zoo_configs.dcn_multihost()
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=ckpt_dir, checkpoint_every_epochs=1))
        reset_launches()
        t0 = time.perf_counter()
        trainer, history = run(cfg, quiet=True)
        torch.cuda.synchronize()
        out = {"rank": rank, "history": history, "launches": read_launches(), "steps": trainer.global_step,
               "seconds": time.perf_counter() - t0, "device": str(trainer.device), "backend": trainer.mesh.backend,
               "collectives": trainer.mesh.calls}
        with open(os.path.join(ckpt_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def phase_sharded_trainer(card: str, paths: dict) -> dict:
    """(L2) ``trainer.run(dcn_multihost())`` whole (2M synthetic examples, 2
    epochs) on 2 ranks sharing the card over gloo, a process each: both
    ranks' histories the same, config 4's full band, one owner gather and one
    Adagrad launch a step on each rank, a checkpoint an epoch. Returns the
    run's checkpoint directory, config and last record."""
    t_phase = time.perf_counter()
    ckpt = DATA_DIR / "dcn_multihost"
    ckpt.mkdir(parents=True, exist_ok=True)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-rank", str(rank), str(port),
                               str(ckpt)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(SHARDED_RANKS)]
    deadline = time.monotonic() + SHARDED_RANK_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        print(f"sharded (L2) rank {rank} exit {p.returncode}; its output's last lines:\n  "
              + "\n  ".join(out.strip().splitlines()[-6:]))
    check(len(outs) == SHARDED_RANKS and all(p.returncode == 0 for p in procs), "both ranks ran to their end")
    results = [json.loads((ckpt / f"rank{rank}.json").read_text()) for rank in range(SHARDED_RANKS)]
    history = results[0]["history"]
    same = all([{k: v for k, v in r.items() if k != "examples_per_s"} for r in res["history"]]
               == [{k: v for k, v in r.items() if k != "examples_per_s"} for r in history] for res in results)
    rec = history[-1]
    steps = results[0]["steps"]
    print(f"sharded (L2): trainer.run(dcn_multihost()) on {SHARDED_RANKS} ranks over {results[0]['backend']} "
          f"sharing {results[0]['device']} ({card}): {steps} steps a rank, run() took "
          f"{[round(r['seconds'], 1) for r in results]} s (data made included); history {history}; the ranks' "
          f"histories the same: {same}")
    print(f"sharded (L2): examples_per_s {[round(r['examples_per_s'], 1) for r in history]} - two ranks sharing one "
          "card, every collective through host copies: no scaling figure")
    check(same, "every rank reports the same history")
    for name, (lo, hi) in CONFIG4_BAND.items():
        print(f"config 5 band: {name} {rec[name]:.6f} in [{lo}, {hi}]")
        check(lo <= rec[name] <= hi, f"config 5's {name} lies in its full band")
    check("eval_lookup_overflow" not in rec, "the eval dropped no id")
    paths["trainer_sharded"] = {name: sum(r["launches"][name] for r in results) for name in WRAPPERS}
    for r in results:
        lnch = r["launches"]
        print(f"sharded (L2) rank {r['rank']}: launches {{{', '.join(f'{n}: {c}' for n, c in lnch.items() if c)}}}, "
              f"collectives {r['collectives']}")
        check(lnch["fused_rowwise_adagrad_multi"] == steps and lnch["cross_v1_bwd"] == steps
              and lnch["gather_rows_multi"] == lnch["cross_v1_fwd"] > steps,
              "each rank: one Adagrad and v1 backward launch a step, one owner gather a step and an eval batch")
    check(checkpoint.latest_step(str(ckpt)) == len(history), "a checkpoint an epoch")
    tree = checkpoint.read_tree(str(ckpt))
    check(tree.get("process_count") == SHARDED_RANKS, "the checkpoint holds both ranks' blocks")
    print(f"phase L2 took {time.perf_counter() - t_phase:.1f} s")
    cfg = zoo_configs.dcn_multihost()
    return {"ckpt": str(ckpt), "record": rec, "config": dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(ckpt)))}


def phase_sharded_serve(card: str, paths: dict, sharded: dict) -> None:
    """(L3) ``Recommender.from_checkpoint`` serves L2's last checkpoint,
    which 2 ranks saved, on one card: ``predict_ctr`` of 4 held-out batches
    bit for bit the single-device forward of the same checkpoint restored in
    a ``Trainer``, whose AUC (the f32 lookup) lies within 1e-3 of the ranks'
    last eval (through the bf16 wire)."""
    t_phase = time.perf_counter()
    cfg = sharded["config"]
    rec = Recommender.from_checkpoint(cfg)
    trainer = Trainer(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, resume=True)), quiet=True,
                      log_metrics=False)
    check(trainer.mesh is None and trainer.start_epoch == cfg.train.epochs,
          "the 2-rank checkpoint resumes on one card at its last epoch")
    dense, cat, label = trainer.ctr_arrays["test"]
    reset_launches()
    same = True
    for i in range(NUM_BATCHES):
        rows = slice(i * BATCH, (i + 1) * BATCH)
        got = rec.predict_ctr(dense[rows], cat[rows])
        with torch.no_grad():
            want = trainer._forward({"dense": to_device(dense[rows]), "cat": to_device(cat[rows]),
                                     "label": to_device(label[rows])}).cpu().numpy()
        same = same and np.array_equal(got, want)
    auc = trainer.evaluate()["auc"]
    gap = abs(auc - sharded["record"]["auc"])
    print(f"sharded (L3): from_checkpoint of the 2-rank checkpoint on one card ({card}): predict_ctr of "
          f"{NUM_BATCHES} x {BATCH} held-out rows bit for bit the restored Trainer's forward: {same}; its AUC "
          f"{auc:.6f} against the ranks' last eval {sharded['record']['auc']:.6f} (gap {gap:.2e}, limit "
          f"{SHARDED_SERVE_AUC_ATOL})")
    check(same, "from_checkpoint serves the 2-rank checkpoint bit for bit the restored Trainer's forward")
    check(gap <= SHARDED_SERVE_AUC_ATOL, "the served checkpoint's AUC lies within 1e-3 of the ranks' last eval")
    print(f"phase L3 took {time.perf_counter() - t_phase:.1f} s")


# ---- phase M: config 5's column-sharded tables and retrieval on a mesh ----

def mesh_ranks(world: int, work: Path, timeout_s: float) -> list:
    """Start ``world`` ranks of this script (``--mesh-rank R WORLD PORT
    DIR``) sharing the card over gloo, wait for them within ``timeout_s``
    (killing them past it), print rank 0's output and the others' last
    lines, and return each rank's ``DIR/rank<R>.json``."""
    work.mkdir(parents=True, exist_ok=True)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank", str(rank), str(world),
                               str(port), str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        lines = out.strip().splitlines()
        print(f"mesh ranks ({world}): rank {rank} exit {p.returncode}; its output{'' if rank == 0 else chr(39) + 's last lines'}:\n  "
              + "\n  ".join(lines if rank == 0 else lines[-4:]))
    check(len(outs) == world and all(p.returncode == 0 for p in procs), f"all {world} mesh ranks ran to their end")
    return [json.loads((work / f"rank{rank}.json").read_text()) for rank in range(world)]


def untied_equal(ids: np.ndarray, vals: np.ndarray, want_ids: np.ndarray, want_vals: np.ndarray,
                 rtol: float) -> tuple[bool, int]:
    """(values within ``rtol`` and ids equal wherever a wanted value is
    not within ``rtol`` of a neighbour, the count of such near-ties)."""
    if ids.shape != want_ids.shape or not np.allclose(vals, want_vals, rtol=rtol, atol=0.0):
        return False, 0
    near = np.abs(np.diff(want_vals, axis=1)) <= rtol * np.abs(want_vals[:, 1:])
    tied = np.zeros(want_vals.shape, bool)
    tied[:, 1:] |= near
    tied[:, :-1] |= near
    return bool(np.array_equal(ids[~tied], want_ids[~tied])), int(tied.sum())


def mesh_col_step(mesh, out: dict) -> None:
    """(M1, in a rank) ``dcn_multihost`` at Criteo's shape with
    ``table_sharding="col"`` on the (1, 2) mesh: 8 steps of 8192 from the
    single-device init, counted (launches, collectives); each of the 8 col
    steps taken from the single-device run's state at that step, its
    logical state against the single-device step's (rank 0: the gate), and
    the free run's 8 steps against the single-device run's (reported); host
    median and busy share.

    Why each step from the single-device state: the col update's statistic
    sums a row's squares in two halves (one a rank) where the kernel sums
    all 32 in its own order, so the two runs part by an ulp; over steps an
    ulp can move a ReLU input across 0 for one example, whose 26 rows then
    take a different gradient, and where a row's accumulator is tiny (the
    reference's initial accumulator is 0) rowwise Adagrad's normalised
    update turns that into a difference of up to the learning rate."""
    cfg = sharded_config()
    vocabs = tuple(cfg.data.categorical_vocab_sizes)
    model = build_model(cfg.model, DataSpec.ctr(vocabs, cfg.data.num_dense_features))
    k = cfg.train.steps_per_dispatch
    dense, cat, label = synthetic_ctr(k * BATCH, cfg.data.num_dense_features, vocabs, seed=SEED + 5)
    batches = [{"dense": to_device(dense[i * BATCH:(i + 1) * BATCH]), "cat": to_device(cat[i * BATCH:(i + 1) * BATCH]),
                "label": to_device(label[i * BATCH:(i + 1) * BATCH])} for i in range(k)]
    mesh_cfg = dataclasses.replace(cfg.mesh, table_sharding="col", table_axis_size=mesh.shape["table"],
                                   a2a_dtype="float32")
    builder = ShardedTrainStepBuilder(model, cfg.train.loss, cfg.optim, mesh, mesh_cfg)
    start = builder.init_state(torch.Generator(device=DEVICE).manual_seed(SEED))
    blocks = {tuple(t.shape) for t in start["tables"].values()}
    state, losses, overflow = copy_state(start), [], 0
    reset_launches()
    mesh.calls = 0
    for b in batches:
        state, metrics = builder.step(state, b)
        losses.append(metrics["loss"])
        overflow = overflow + metrics["lookup_overflow"]
    torch.cuda.synchronize()
    out["m1"] = {"launches": read_launches(), "collectives": mesh.calls, "steps": k, "blocks": sorted(blocks),
                 "overflow": int(overflow), "losses": torch.stack(losses).tolist(),
                 "kinds": sorted({type(p).__name__ for p in builder.plans.values()})}
    logical = builder.logical_state(state)
    run_state = {"s": copy_state(start)}

    def step():
        run_state["s"], _ = builder.step(run_state["s"], batches[0])

    median = medians_in_turns({"col": step})["col"]
    out["m1"]["host_median_ms"] = median
    out["m1"]["busy_share"] = profile(step, f"col-sharded train step (rank {mesh.rank})", median)
    def parts(state):
        return [("tables", state["tables"]), ("accumulators", {n: s["acc"] for n, s in state["sparse_opt"].items()}),
                ("dense", dict(enumerate(tree_leaves(state["dense"]))))]

    def compare(got, want, into):
        for (what, a), (_, b) in zip(parts(got), parts(want)):
            r = into.setdefault(what, {"max_abs_err": 0.0, "close": True, "rows_past": 0})
            r["max_abs_err"] = max(r["max_abs_err"], max(max_err(a[n], b[n]) for n in b))
            r["close"] = r["close"] and all(torch.allclose(a[n], b[n], rtol=SHARDED_RTOL, atol=SHARDED_ATOL) for n in b)
            if what == "tables":
                r["rows_past"] = sum(int((~torch.isclose(a[n], b[n], rtol=SHARDED_RTOL, atol=SHARDED_ATOL))
                                         .any(dim=1).sum()) for n in b)

    # The single-device run (every rank makes it: the col steps start from
    # its states), each col step from its state at that step.
    single = TrainStepBuilder(model, cfg.train.loss, cfg.optim)
    want = single.init_state(torch.Generator(device=DEVICE).manual_seed(SEED))
    stepwise, want_losses = {}, []
    for b in batches:
        got, metrics = builder.step(convert.shard_state(want, mesh, builder.plans), b)
        got_losses = metrics["loss"]
        got = builder.logical_state(got)
        want, metrics = single.step(copy_state(want), b)
        want_losses.append(metrics["loss"])
        if mesh.rank == 0:
            compare(got, want, stepwise)
            stepwise["losses_close"] = (stepwise.get("losses_close", True)
                                        and bool(torch.allclose(got_losses, metrics["loss"], rtol=SHARDED_RTOL)))
        del got
    torch.cuda.synchronize()
    if mesh.rank == 0:
        free = {}
        compare(logical, want, free)
        free["losses_close"] = bool(torch.allclose(torch.stack(losses), torch.stack(want_losses), rtol=SHARDED_RTOL))
        out["m1"]["stepwise"], out["m1"]["free_run"] = stepwise, free
    mesh.barrier()


def mesh_config1(out: dict) -> None:
    """(M2, in a rank) ``trainer.run(mf_bpr_ml100k())`` whole on the (2, 1)
    mesh, its eval through ``ShardedRetrievalEvaluator``; then
    ``Recommender.from_trainer`` on the live state against the single-card
    ``recommend`` of its logical tables (rank 0)."""
    cfg = zoo_configs.mf_bpr_ml100k()
    reset_launches()
    t0 = time.perf_counter()
    trainer, history = run(cfg, quiet=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    evaluator = trainer._retrieval_eval
    users = np.arange(0, cfg.data.num_users, 7, dtype=np.int32)
    reset_launches()
    ids, vals = Recommender.from_trainer(trainer).recommend(users, 20)
    serve_launches = read_launches()
    params = trainer.params
    out["m2"] = {"history": history, "launches": launches, "steps": trainer.global_step, "seconds": seconds,
                 "eval_batches": -(-len(evaluator.users_with_test) // evaluator.user_batch),
                 "evaluator": type(evaluator).__name__, "collectives": trainer.mesh.calls,
                 "serve_launches": serve_launches}
    if trainer.mesh.rank == 0:
        want_ids, want_vals = Recommender(trainer.model, params, dataset=trainer.dataset).recommend(users, 20)
        same, near = untied_equal(ids, vals, want_ids, want_vals, MESH_VALUE_RTOL)
        out["m2"]["serve_same"], out["m2"]["serve_near_ties"] = same, near
    trainer.mesh.barrier()


def mesh_topk(mesh, out: dict) -> None:
    """(M3, in a rank) ``recommend`` for 1024 users, k=100, over MF's
    1 000 000 items at d=64 (build_topk_bench's shape) on the (2, 1) mesh
    from the live sharded state, the path ``from_trainer`` takes; rank 0
    holds it against the single-card call on the logical tables and times
    both; each rank times its ``torch.topk`` of [1024, 500000], in turns."""
    model = MF(DataSpec.interaction(MF_ROWS, MF_ROWS), MF_DIM)
    builder = ShardedTrainStepBuilder(model, "bpr", OptimConfig(learning_rate=0.05), mesh,
                                      zoo_configs.mf_bpr_ml100k().mesh)
    state = builder.init_state(torch.Generator(device=DEVICE).manual_seed(SEED))
    rec = Recommender(model, None, mesh=mesh, state=state, builder=builder)
    users = np.random.default_rng(SEED + 5).integers(0, MF_ROWS, TOPK_USERS).astype(np.int32)
    reset_launches()
    ids, vals = rec.recommend(users, TOPK_K)
    launches = read_launches()
    median, p99 = latency(lambda: rec.recommend(users, TOPK_K), calls=11)
    tables = builder.unpadded_tables(state)
    items = state["tables"]["item_emb"]
    u = torch.index_select(tables["user_emb"], 0, to_device(users).long())
    block = torch.matmul(u, items.T) + state["tables"]["item_bias"][:, 0][None, :]
    topk = {}
    for r in range(mesh.size):  # one rank at a time on the shared card
        if mesh.rank == r:
            topk[r] = device_ms(lambda: torch.topk(block, TOPK_K), 1)
        mesh.barrier()
    out["m3"] = {"launches": launches, "median_ms": median, "p99_ms": p99, "block": list(block.shape),
                 "topk_ms": topk[mesh.rank]}
    del block
    if mesh.rank == 0:
        single = Recommender(model, {"tables": tables, "dense": {}})
        want_ids, want_vals = single.recommend(users, TOPK_K)
        same, near = untied_equal(ids, vals, want_ids, want_vals, MESH_VALUE_RTOL)
        out["m3"].update(same=same, near_ties=near, shape=list(ids.shape), finite=bool(np.isfinite(vals).all()))
        out["m3"]["single_median_ms"], out["m3"]["single_p99_ms"] = latency(
            lambda: single.recommend(users, TOPK_K), calls=11)
        del single
    del tables
    mesh.barrier()


def mesh_col_mf(work: Path, out: dict) -> None:
    """(M4, in a rank) MF at config 1's shape under col sharding on the
    (2, 2) mesh for 2 epochs, a checkpoint an epoch; the live mesh's
    ``recommend`` of every 7th user, k=20."""
    cfg = mesh_col_mf_config(work)
    reset_launches()
    trainer, history = run(cfg, quiet=True)
    torch.cuda.synchronize()
    launches = read_launches()
    users = np.arange(0, cfg.data.num_users, 7, dtype=np.int32)
    ids, vals = Recommender.from_trainer(trainer).recommend(users, 20)
    out["m4"] = {"history": history, "launches": launches, "steps": trainer.global_step,
                 "mesh": dict(trainer.mesh.shape), "ids": ids.tolist(), "vals": vals.tolist(),
                 "kinds": sorted({type(p).__name__ for p in trainer.builder.plans.values()})}


def mesh_col_mf_config(work: Path, table_axis: int = 2):
    cfg = zoo_configs.mf_bpr_ml100k()
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, epochs=2, checkpoint_dir=str(work / "mf_col"),
                                       checkpoint_every_epochs=1),
        mesh=dataclasses.replace(cfg.mesh, table_axis_size=table_axis,
                                 table_sharding="col" if table_axis > 1 else "row"))


def mesh_rank(rank: int, world: int, port: int, work: str) -> int:
    """One rank of phase M (``chip_smoke.py --mesh-rank R WORLD PORT DIR``),
    sharing the card over gloo: on 2 ranks M1 on a (1, 2) mesh, then M2 and
    M3 on (2, 1); on 4 ranks M4 on (2, 2), then phase Q2-Q4 (``rest_work``:
    one spawn of 4 ranks for both). Its results go to ``DIR/rank<R>.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo", device=DEVICE)
    work = Path(work)
    out = {"rank": rank}
    try:
        if world == 2:
            mesh_col_step(make_mesh(-1, 2, device=DEVICE), out)
            mesh_config1(out)
            mesh_topk(make_mesh(-1, 1, device=DEVICE), out)
        else:
            mesh_col_mf(work, out)
            rest_work(out)
        with open(work / f"rank{rank}.json", "w") as f:
            json.dump(out, f, default=float)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def phase_mesh_two(card: str, paths: dict) -> None:
    """(M1-M3) on 2 ranks sharing the card over gloo (a process each)."""
    t_phase = time.perf_counter()
    res = mesh_ranks(2, DATA_DIR / "mesh2", MESH_RANK_TIMEOUT_S)
    m1 = [r["m1"] for r in res]
    k = m1[0]["steps"]
    print(f"col (M1): dcn_multihost at Criteo's shape, table_sharding=col on a (1, 2) mesh over gloo sharing the "
          f"card ({card}): {m1[0]['kinds']} plans, blocks {m1[0]['blocks']} a rank; {k} steps of {BATCH}; "
          f"losses {[round(x, 6) for x in m1[0]['losses']]}; ids dropped {m1[0]['overflow']}")
    for run_name, what_run in (("stepwise", "each col step from the single-device run's state"),
                               ("free_run", "the free 8-step run against the single-device run")):
        for what, r in m1[0][run_name].items():
            if what == "losses_close":
                print(f"col (M1) {what_run}, losses within rtol {SHARDED_RTOL}: {r}")
                continue
            print(f"col (M1) {what_run}, {what}: max_abs_err {r['max_abs_err']:.3e} (rtol {SHARDED_RTOL}, atol "
                  f"{SHARDED_ATOL}): {r['close']}" + (f"; rows past it {r['rows_past']}" if what == "tables" else ""))
    for what, r in m1[0]["stepwise"].items():
        check(r if what == "losses_close" else r["close"], f"each col step's {what} match the single-device step's")
    check(m1[0]["free_run"]["losses_close"], "the free col run's losses match the single-device run's")
    check(m1[0]["overflow"] == 0, "no id dropped under col")
    for rank, r in enumerate(m1):
        lnch = {n: c for n, c in r["launches"].items() if c}
        print(f"col (M1) rank {rank}: launches {lnch}, collectives {r['collectives']} "
              f"({r['collectives'] / k:.1f} a step), host median {r['host_median_ms']:.3f} ms a step (in turns "
              f"with the other rank's), device busy {100 * (r['busy_share'] or 0):.1f}%")
        check(lnch == {"gather_rows_multi": k, "cross_v1_fwd": k, "cross_v1_bwd": k},
              "each col rank: one gather launch a step for the 26 column blocks, both v1 kernels, no Adagrad kernel")
    paths["train_col"] = {n: sum(r["launches"][n] for r in m1) for n in WRAPPERS}

    m2 = [r["m2"] for r in res]
    rec = m2[0]["history"][-1]
    print(f"config 1 on a (2, 1) mesh (M2): trainer.run(mf_bpr_ml100k()) over gloo sharing the card ({card}): "
          f"{m2[0]['steps']} steps a rank in {[round(r['seconds'], 1) for r in m2]} s, eval by {m2[0]['evaluator']} "
          f"({m2[0]['eval_batches']} user batches an eval), collectives {m2[0]['collectives']}; last record {rec}")
    check(m2[0]["evaluator"] == "ShardedRetrievalEvaluator", "config 1's eval on the mesh is the sharded evaluator")
    def metrics(history):
        return [{k: v for k, v in x.items() if k != "examples_per_s"} for x in history]

    check(all(metrics(r["history"]) == metrics(m2[0]["history"]) for r in m2), "both ranks report the same history")
    for name, (lo, hi) in CONFIG1_BAND.items():
        print(f"config 1 band on the mesh: {name} {rec[name]:.6f} in [{lo}, {hi}]")
        check(lo <= rec[name] <= hi, f"config 1's {name} on the mesh lies in its band")
    evals = sum(1 for r in m2[0]["history"] if "recall@20" in r)
    for r in m2:
        lnch = r["launches"]
        print(f"config 1 (M2) rank: launches {{{', '.join(f'{n}: {c}' for n, c in lnch.items() if c)}}}")
        check(lnch["fused_rowwise_adagrad_multi"] == r["steps"]
              and lnch["gather_rows_multi"] == r["steps"] + evals * r["eval_batches"],
              "each rank: the owner's gather and Adagrad launch a step, one user gather an eval batch")
    print(f"config 1 (M2): Recommender.from_trainer on the live mesh, k=20 for every 7th user, against the "
          f"single-card recommend of its logical tables: {m2[0]['serve_same']} ({m2[0]['serve_near_ties']} near-tied "
          f"places); launches {({n: c for n, c in m2[0]['serve_launches'].items() if c})}")
    check(m2[0]["serve_same"], "from_trainer's mesh recommend is the single-card recommend")
    paths["trainer_mesh_mf"] = {n: sum(r["launches"][n] for r in m2) for n in WRAPPERS}

    m3 = [r["m3"] for r in res]
    print(f"sharded recommend (M3): {TOPK_USERS} users, k={TOPK_K} over {MF_ROWS} items (d={MF_DIM}) on a (2, 1) "
          f"mesh, blocks of {m3[0]['block']} scores a rank: ids equal to the single-card call's where untied, values "
          f"within {MESH_VALUE_RTOL}: {m3[0]['same']} ({m3[0]['near_ties']} near-tied places); launches a call "
          f"{({n: c for n, c in m3[0]['launches'].items() if c})}")
    print(f"sharded recommend (M3) latency (host clock, median and p99 over 10 calls): mesh {m3[0]['median_ms']:.3f} "
          f"/ {m3[0]['p99_ms']:.3f} ms, single card {m3[0]['single_median_ms']:.3f} / {m3[0]['single_p99_ms']:.3f} ms "
          f"({card}; two ranks on one card, the merge's gather through host copies: no scaling figure)")
    print("sharded recommend (M3): torch.topk k=100 of each rank's [1024, 500000] block [device time, CUDA graph]: "
          + ", ".join(f"rank {i} {r['topk_ms']:.4f} ms" for i, r in enumerate(m3)))
    check(m3[0]["shape"] == [TOPK_USERS, TOPK_K] and m3[0]["finite"], "the mesh recommend's [users, k] is finite")
    check(m3[0]["same"], "the mesh recommend is the single-card recommend")
    check(all(r["launches"]["gather_rows_multi"] == 1 and sum(r["launches"].values()) == 1 for r in m3),
          "the mesh recommend: one gather launch a rank (the users' rows), and no other")
    paths["serve_mesh_mf"] = {n: sum(r["launches"][n] for r in m3) for n in WRAPPERS}
    print(f"phase M1-M3 took {time.perf_counter() - t_phase:.1f} s")


def phase_mesh_four(card: str, paths: dict) -> None:
    """(M4) MF under col sharding on a (2, 2) mesh of 4 ranks sharing the
    card, 2 epochs; its checkpoint served on one card by ``from_checkpoint``
    gives the live mesh's top-k. The same ranks then run phase Q2-Q4
    (``rest_checks``), so 4 ranks start once."""
    t_phase = time.perf_counter()
    work = DATA_DIR / "mesh4"
    res = mesh_ranks(4, work, MESH_RANK_TIMEOUT_S)
    m4 = res[0]["m4"]
    print(f"col MF (M4): mf_bpr_ml100k, table_sharding=col on a {m4['mesh']} mesh of 4 ranks over gloo sharing "
          f"the card ({card}), {m4['kinds']} plans: {m4['steps']} steps a rank; last record {m4['history'][-1]}")
    check(m4["mesh"] == {"data": 2, "table": 2}, "M4 ran on a (2, 2) mesh")
    check(all(r["m4"]["ids"] == m4["ids"] for r in res), "every rank's live recommend is the same")
    check(checkpoint.latest_step(str(work / "mf_col")) == 2, "a checkpoint an epoch")
    rec = Recommender.from_checkpoint(mesh_col_mf_config(work, table_axis=1))
    users = np.arange(0, rec.dataset.num_users, 7, dtype=np.int32)
    ids, vals = rec.recommend(users, 20)
    same, near = untied_equal(np.asarray(m4["ids"]), np.asarray(m4["vals"], np.float32), ids, vals, MESH_VALUE_RTOL)
    print(f"col MF (M4): from_checkpoint on one card, k=20 for every 7th user, against the live (2, 2) mesh's "
          f"recommend: {same} ({near} near-tied places)")
    check(same, "the (2, 2) checkpoint served on one card gives the live mesh's top-k")
    for rank, r in enumerate(res):
        lnch = r["m4"]["launches"]
        print(f"col MF (M4) rank {rank}: launches {{{', '.join(f'{n}: {c}' for n, c in lnch.items() if c)}}}")
        # Two gathers a step (the col tables' blocks, the replicated [V, 1]
        # bias), one a user batch of the eval; the bias's one-table Adagrad
        # launch a step, and no Adagrad kernel on the col tables.
        check(lnch["fused_rowwise_adagrad_multi"] == 0 and lnch["fused_rowwise_adagrad"] == r["m4"]["steps"]
              and lnch["gather_rows_multi"] > 2 * r["m4"]["steps"],
              "each col rank: the col blocks' and the bias's gathers a step, the bias's Adagrad launch a step, "
              "none on the col tables")
    paths["trainer_col_mf"] = {n: sum(r["m4"]["launches"][n] for r in res) for n in WRAPPERS}
    rest_checks(card, paths, res)
    print(f"phase M4 (and Q2-Q4 in its ranks) took {time.perf_counter() - t_phase:.1f} s")


# ---- phase N: the rest of the CTR zoo and the sequential zoo ----

def phase_ctr_zoo(card: str, paths: dict) -> dict:
    """(N1) DeepFM, Wide & Deep, NFM and DLRM at Criteo's shape: each
    served (4 batches of 8192 through ``predict_ctr``: one gather launch a
    batch for all tables, DLRM's one interaction launch a batch too, and no
    other kernel; the logits finite, within
    LOGIT_TOL of the plain versions on the card and of the CPU) and trained
    (8 ``multi_step`` steps of 8192 Zipf(1.2) ids: one gather and one
    Adagrad launch a step, and DLRM one interaction launch each way; the
    held loss falls; one step bit for bit on
    repeat and against the CPU as phase 6 holds DCN's, ReLU flips found);
    serving latency, the step's host median, busy share and kernels a step;
    the gather and Adagrad kernels at DeepFM's 52 tables (26 fields and 26
    linear tables: Wide & Deep's and NFM's shape too). Then
    ``trainer.run(dcn_criteo())`` as DLRM and as DeepFM at phase 10's proxy
    size: their AUC and logloss (no band exists: the AUC lies above 0.5).
    Returns the kernels' records."""
    t_phase = time.perf_counter()
    records = {"gather_rows_multi": {}, "fused_rowwise_adagrad_multi": {}}
    rng = np.random.default_rng(SEED + 16)
    for name in CTR_ZOO:
        t_model = time.perf_counter()
        base = configs()["v1"]  # dcn_criteo at Criteo's shape; its tower is their MLP, DLRM's top
        cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, name=name))
        vocabs, nd = tuple(cfg.data.categorical_vocab_sizes), cfg.data.num_dense_features
        model = build_model(cfg.model, DataSpec.ctr(vocabs, nd))
        params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
        rec = Recommender(model, params)
        requests = make_requests(rng, vocabs, nd)
        reset_launches()
        logits = [rec.predict_ctr(dense, cat) for dense, cat in requests]
        torch.cuda.synchronize()
        paths[f"serve_{name}"] = launches = read_launches()
        n_tables = len(model.table_specs())
        dot = name == "dlrm"  # its interaction's kernels
        check_launches(launches, {"gather_rows_multi": NUM_BATCHES, "dot_interaction_fwd": NUM_BATCHES * dot},
                       f"{name} serving ran one gather launch a batch for its {n_tables} tables"
                       + (" and one interaction launch" if dot else "") + ", and no other")
        err = 0.0
        for (dense, cat), got in zip(requests, logits):
            check(got.shape == (BATCH,) and bool(np.isfinite(got).all()), f"{name} logits are finite [{BATCH}]")
            batch = {"dense": to_device(dense), "cat": to_device(cat)}
            want = plain_forward(model, params, batch)
            got_t = to_device(got)
            check(within(got_t, want, LOGIT_TOL, LOGIT_TOL), f"{name} logits match the plain versions on the card")
            err = max(err, max_err(got_t, want))
        cpu = Recommender(model, copy_state(params, "cpu"), device="cpu")
        n_small = 256
        want_cpu = torch.from_numpy(cpu.predict_ctr(requests[0][0][:n_small], requests[0][1][:n_small]))
        cpu_err = max_err(torch.from_numpy(logits[0][:n_small]), want_cpu)
        check(within(torch.from_numpy(logits[0][:n_small]), want_cpu, LOGIT_TOL, LOGIT_TOL),
              f"{name} card logits match the CPU's on a small input")
        lat = medians_in_turns({"predict_ctr": lambda: rec.predict_ctr(*requests[0])})["predict_ctr"]
        print(f"{name} serving (N1): {len(vocabs)} fields x {vocabs[0]} rows, {n_tables} tables, "
              f"{NUM_BATCHES} batches of {BATCH}, launches {launches}; max_abs_err vs plain on the card "
              f"{err:.3e}, vs CPU ({n_small} rows) {cpu_err:.3e} (rtol {LOGIT_TOL}, atol {LOGIT_TOL} x "
              f"max|ref|); predict_ctr median {lat:.3f} ms (host clock, request copy and logits included; {card})")
        profile(lambda: rec.predict_ctr(*requests[0]), f"{name} predict_ctr", lat)
        del rec, cpu, requests, logits

        builder = TrainStepBuilder(model, cfg.train.loss, cfg.optim)
        state = builder.init_state(torch.Generator(device=DEVICE).manual_seed(SEED))
        k = cfg.train.steps_per_dispatch
        dense, cat, label = synthetic_ctr((k + 1) * BATCH, nd, vocabs, seed=SEED + 1)
        n = k * BATCH
        batches = {"dense": to_device(dense[:n].reshape(k, BATCH, -1)),
                   "cat": to_device(cat[:n].reshape(k, BATCH, -1)),
                   "label": to_device(label[:n].reshape(k, BATCH))}
        held = {"dense": to_device(dense[n:]), "cat": to_device(cat[n:]), "label": to_device(label[n:])}
        start = copy_state(state)
        before = held_loss(builder, state, held)
        reset_launches()
        state, metrics = builder.multi_step(state, batches)
        torch.cuda.synchronize()
        paths[f"train_{name}"] = launches = read_launches()
        after = held_loss(builder, state, held)
        print(f"{name} training (N1): multi_step K={k} x {BATCH}, launches {launches}; loss mean "
              f"{metrics['loss_mean'].item():.6f}, held batch {before:.6f} -> {after:.6f}")
        check_launches(launches, {"gather_rows_multi": k, "fused_rowwise_adagrad_multi": k,
                                  "dot_interaction_fwd": k * dot, "dot_interaction_bwd": k * dot},
                       f"{name} training ran one gather and one Adagrad launch a step"
                       + (" and one interaction launch each way" if dot else "") + ", and no other")
        check(bool(np.isfinite([metrics["loss_mean"].item(), after]).all()) and after < before,
              f"{name}'s loss is finite and falls on the held batch")
        batch = {key: v[0] for key, v in batches.items()}
        check_step(builder, start, batch, cfg.train.loss, step_tol=(STEP_RTOL, STEP_ATOL))
        if name == "deepfm":
            sparse_kernel_checks(builder, start, batch, f"deepfm_{n_tables}", records)
        step_profile(builder, state, batch, f"{name} step (N1)")
        del builder, state, start, batches, held, params, model
        print(f"{name} (N1) took {time.perf_counter() - t_model:.1f} s")

    for name in ("dlrm", "deepfm"):
        proxy = trainer_configs()["proxy"]
        cfg = dataclasses.replace(proxy, model=dataclasses.replace(proxy.model, name=name))
        trainer, history, train_counts, evals, run_s = run_counted(cfg)
        steps = trainer.global_step
        eval_batches = -(-len(trainer.ctr_arrays["test"][2]) // trainer_mod.EVAL_BATCH)
        paths[f"trainer_{name}"] = whole_run_launches(train_counts, evals)
        rec = history[-1]
        print(f"{name} trainer (N1, run, dcn_criteo() as {name}: {cfg.data.num_examples} synthetic_ctr "
              f"examples, 1 epoch, {steps} steps): auc {rec['auc']:.6f} logloss {rec['logloss']:.6f} "
              f"examples_per_s {rec['examples_per_s']:.1f} ({card}); run() took {run_s:.1f} s; launches in "
              f"training {train_counts}, in the eval pass {evals[0][1]}")
        check(all(np.isfinite(v) for v in rec.values()) and rec["auc"] > 0.5,
              f"the {name} trainer's history is finite and its AUC above 0.5")
        dot = name == "dlrm"
        check_launches(train_counts, {"gather_rows_multi": steps, "fused_rowwise_adagrad_multi": steps,
                                      "dot_interaction_fwd": steps * dot, "dot_interaction_bwd": steps * dot},
                       f"the {name} trainer ran one gather and one Adagrad launch a step"
                       + (" and one interaction launch each way" if dot else "") + ", and no other")
        check_launches(evals[0][1], {"gather_rows_multi": eval_batches, "dot_interaction_fwd": eval_batches * dot},
                       f"the {name} eval pass ran one gather launch a batch"
                       + (" and one interaction launch" if dot else "") + ", and no other")
        del trainer
    print(f"phase N1 took {time.perf_counter() - t_phase:.1f} s")
    return records


def seq_config(name: str):
    """The zoo config ``name`` with a checkpoint after its last epoch, under
    DATA_DIR, and its epochs cut where SEQ_EPOCHS says."""
    cfg = zoo_configs.ZOO[name]()
    epochs = SEQ_EPOCHS.get(name, cfg.train.epochs)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=epochs, eval_every_epochs=min(cfg.train.eval_every_epochs, epochs),
        checkpoint_dir=str(DATA_DIR / name), checkpoint_every_epochs=epochs))


def seq_card_vs_cpu(cfg) -> None:
    """The config's first SEQ_CPU_STEPS steps at dropout 0 on the card and on
    the CPU (the plain versions) from one initial state: each loss, and the
    tables, rowwise Adam's leaves and the dense params after them, within
    STEP_RTOL and STEP_ATOL."""
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.0),
                              train=dataclasses.replace(cfg.train, checkpoint_dir=None))
    t0 = time.perf_counter()
    card = Trainer(cfg, quiet=True)
    cpu = Trainer(cfg, quiet=True, device="cpu")
    cpu.state = copy_state(card.state, "cpu")
    host = [b for _, b in zip(range(SEQ_CPU_STEPS), card.sampler.epoch(0))]
    losses = {"card": [], "cpu": []}
    for b in host:
        for name, t in (("card", card), ("cpu", cpu)):
            t.state, m = t.builder.step(t.state, t._to_device_batch(b))
            losses[name].append(m["loss"].item())
    pairs = {"tables": (card.state["tables"], cpu.state["tables"]),
             "rowwise Adam": (card.state["sparse_opt"], cpu.state["sparse_opt"]),
             "dense": (card.state["dense"], cpu.state["dense"])}
    errs, ok = {}, True
    for what, (got, want) in pairs.items():
        leaves = list(zip(tree_leaves(got), tree_leaves(want)))
        errs[what] = max((max_err(a.cpu().double(), e.double()) for a, e in leaves), default=0.0)
        ok &= all(torch.allclose(a.cpu().double(), e.double(), rtol=STEP_RTOL, atol=STEP_ATOL) for a, e in leaves)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"]))
    print(f"{cfg.run_name} card against the CPU ({time.perf_counter() - t0:.1f} s), {len(host)} steps at "
          f"dropout 0 from one state: losses card {losses['card']}, cpu {losses['cpu']} (max relative error "
          f"{rel:.3e}); max_abs_err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (rtol {STEP_RTOL}, atol {STEP_ATOL})")
    check(rel <= STEP_RTOL, f"{cfg.run_name}'s losses on the card match the CPU's")
    check(ok, f"{cfg.run_name}'s tables, rowwise Adam state and dense params on the card match the CPU's")


def zoo_serving(card: str, paths: dict, trainer, cfg, short: str, num_users: int = SERVE_USERS,
                k: int = SEQ_SERVE_K, want: dict | None = None, want_recommend: dict | None = None) -> None:
    """``predict`` of ``num_users`` (user, item) pairs and ``recommend(users,
    k)`` for as many users, from the trainer and from its checkpoint (which
    re-attaches the sequences, histories or graph from the config's data):
    bit for bit the same; ``predict`` at ``score_catalog``'s entries (for
    FISM where the item is not in the user's history: its forward leaves
    the item out, its ``score_all`` does not); launches (``want``, by
    default one gather a call; ``want_recommend`` for ``recommend``, by
    default ``want``); latencies."""
    want = {"gather_rows_multi": 1} if want is None else want
    want_recommend = want if want_recommend is None else want_recommend
    rng = np.random.default_rng(SEED + 17)
    users = rng.choice(trainer.dataset.num_users, num_users, replace=False).astype(np.int32)
    items = rng.integers(0, trainer.dataset.num_items, num_users).astype(np.int32)
    live = Recommender.from_trainer(trainer)
    t0 = time.perf_counter()
    cold = Recommender.from_checkpoint(cfg)
    cold_s = time.perf_counter() - t0
    reset_launches()
    got = live.predict(users, items)
    torch.cuda.synchronize()
    paths[f"serve_{short}"] = launches = read_launches()
    reset_launches()
    top_ids, top_vals = live.recommend(users, k)
    torch.cuda.synchronize()
    rec_launches = read_launches()
    cold_ids, cold_vals = cold.recommend(users, k)
    same = (np.array_equal(cold.predict(users, items), got) and np.array_equal(cold_ids, top_ids)
            and np.array_equal(cold_vals, top_vals))
    scores = live.score_catalog(users)[np.arange(num_users), items]
    rows = (~(trainer.model._hist[users] == items[:, None]).any(axis=1) if short == "fism"
            else np.ones(num_users, bool))
    at_items = np.allclose(got[rows], scores[rows], rtol=RTOL, atol=ATOL_REL)
    p_ms, p_99 = latency(lambda: live.predict(users, items), ZOO_LATENCY_CALLS)
    r_ms, r_99 = latency(lambda: live.recommend(users, k), ZOO_LATENCY_CALLS)
    print(f"{cfg.run_name} serving: predict of {num_users} pairs, launches {launches}; recommend k={k} for "
          f"{num_users} users over {trainer.dataset.num_items} items, launches {rec_launches}; from_checkpoint "
          f"({cold_s:.2f} s cold start) bit for bit from_trainer's: {same}; predict is score_catalog's entry: "
          f"{at_items}; latency (host clock over {ZOO_LATENCY_CALLS - 1} calls; {card}) predict median {p_ms:.3f} "
          f"ms p99 {p_99:.3f} ms, recommend "
          f"median {r_ms:.3f} ms p99 {r_99:.3f} ms")
    check(bool(np.isfinite(got).all()) and got.shape == (num_users,), f"{short} predict is finite")
    check(at_items, f"{short} predict gives score_catalog's entries")
    check(same, f"{short} from_checkpoint serves predict and recommend bit for bit as from_trainer")
    check_launches(launches, want, f"{short} predict ran {want or 'no kernel'}, and no other")
    check_launches(rec_launches, want_recommend,
                   f"{short} recommend ran {want_recommend or 'no kernel'}, and no other")


def seq_gather_record(trainer, batch, label: str) -> dict:
    """The gather at a sequential step's shape: one launch, bit for bit its
    plain version and on repeat; its times."""
    ids = trainer.model.lookup_ids(batch)
    tables, field_ids = [trainer.state["tables"][n] for n in ids], list(ids.values())
    got, launches = launches_of(gather_rows_multi, lambda: gather_rows_multi(tables, field_ids))
    again = gather_rows_multi(tables, field_ids)
    want = gather_rows_multi_ref(tables, field_ids)
    torch.cuda.synchronize()
    ok = (launches == 1 and all(torch.equal(g, w) for g, w in zip(got, want))
          and all(torch.equal(g, a) for g, a in zip(got, again)))
    print(f"gather_rows_multi at {label} {[(tuple(t.shape), i.shape[0]) for t, i in zip(tables, field_ids)]}: "
          f"one launch, bit for bit its plain version and on repeat: {ok}")
    check(ok, f"gather_rows_multi at {label}: one launch, bit for bit its plain version and on repeat")
    return gather_times(tables, field_ids, label)


def phase_sequential(card: str, paths: dict) -> dict:
    """(N2) ``trainer.run`` of sasrec_ml1m, caser_ml1m and gru4rec_ml1m on
    the card (the synthetic_implicit stand-in at ML-1M's shape, 60 epochs
    of 47 steps of 128, rowwise Adam, the full-catalog eval every 20;
    gru4rec_ml1m SEQ_EPOCHS' 1 epoch, the eval after it): the bands of
    tests/test_golden.py:149-150 and :186, a falling loss; one gather launch
    a step (item and user rows), one a batch of users in each eval pass;
    examples/s, the step's host median, busy share and kernels a step;
    serving from the trainer and from its checkpoint, bit for bit; the
    first steps at dropout 0 against the CPU; the gather at each step's
    shape. Returns the gather's records."""
    t_phase = time.perf_counter()
    records = {}
    for name, band in SEQ_BANDS.items():
        t_model = time.perf_counter()
        short = name.split("_")[0]
        cfg = seq_config(name)
        # The loss at the initial state (the trainer's seeded init) over a
        # held set of batches, to hold the trained state's against.
        fresh = Trainer(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, checkpoint_dir=None)),
                        quiet=True)
        held = [fresh._to_device_batch(b) for _, b in zip(range(4), fresh.sampler.epoch(cfg.train.epochs))]
        before = statistics.mean(held_loss(fresh.builder, fresh.state, b) for b in held)
        del fresh
        trainer, history, train_counts, evals, run_s = run_counted(cfg)
        steps = trainer.global_step
        evaluator = trainer._retrieval_eval
        eval_batches = -(-len(evaluator.users_with_test) // evaluator.user_batch)
        paths[f"trainer_{short}"] = whole_run_launches(train_counts, evals)
        rec = history[-1]
        rates = [r["examples_per_s"] for r in history]
        print(f"{name} (N2, run: synthetic_implicit {trainer.dataset.num_users} x {trainer.dataset.num_items}, "
              f"{len(trainer.dataset.train)} train interactions, {trainer.sampler.num_batches()} steps of "
              f"{cfg.train.batch_size} an epoch, {cfg.train.epochs} epochs): {steps} steps; final record {rec}; "
              f"losses {[round(r['loss'], 6) for r in history[:: max(len(history) // 6, 1)]]}; launches in "
              f"training {train_counts}, in each eval pass ({eval_batches} batches of {evaluator.user_batch} "
              f"users) {evals[0][1]}; run() took {run_s:.1f} s")
        print(f"{name}: examples_per_s median over the epochs {statistics.median(rates):.1f} (min "
              f"{min(rates):.1f}, max {max(rates):.1f}; host clock over each epoch; {card}); eval passes "
              f"(host clock): " + ", ".join(f"{ms:.3f} ms" for ms, _ in evals))
        check(len(evals) == cfg.train.epochs // cfg.train.eval_every_epochs, f"{name}'s eval cadence")
        check(all(np.isfinite(v) for r in history for v in r.values()), f"{name}'s history is finite")
        after = statistics.mean(held_loss(trainer.builder, trainer.state, b) for b in held)
        print(f"{name}: the loss over 4 held batches (an epoch the run did not draw) {before:.6f} -> {after:.6f}")
        check(after < before, f"{name}'s held loss falls")
        check_launches(train_counts, {"gather_rows_multi": steps},
                       f"{name} ran one gather launch a step, and no other")
        for _, counts in evals:
            check_launches(counts, {"gather_rows_multi": eval_batches},
                           f"each {name} eval pass ran one gather a batch of users, and no other")
        for metric, (lo, hi) in band.items():
            if name in SEQ_EPOCHS:
                print(f"{name}: {metric} {rec[metric]:.6f} after {cfg.train.epochs} of "
                      f"{zoo_configs.ZOO[name]().train.epochs} epochs; its band [{lo}, {hi}] is for the whole run")
                continue
            print(f"{name} band: {metric} {rec[metric]:.6f} in [{lo}, {hi}]")
            check(lo <= rec[metric] <= hi, f"{name}'s {metric} lies in its band")
        zoo_serving(card, paths, trainer, cfg, short)
        batch = trainer._to_device_batch(next(trainer.sampler.epoch(0)))
        records[name] = seq_gather_record(trainer, batch, name)
        median, busy = step_profile(trainer.builder, trainer.state, batch, f"{name} step (N2)")
        records[name].update({"step_ms": median, "step_device_busy": busy})
        del trainer
        seq_card_vs_cpu(cfg)
        print(f"{name} (N2) took {time.perf_counter() - t_model:.1f} s")
    print(f"phase N2 took {time.perf_counter() - t_phase:.1f} s")
    return records


def zoo_o_configs() -> dict:
    """Phase O's configurations by short name, each saving a checkpoint
    after its last epoch under DATA_DIR: the four history zoo configs,
    Mult-DAE (multvae_ml100k with model.name=multdae) and the graph models
    on mf_bpr_ml100k()."""
    cfgs = {short: zoo_configs.ZOO[f"{short}_ml100k"]() for short in HISTORY_ZOO}
    vae = cfgs["multvae"]
    cfgs["multdae"] = vae.replace(run_name="multdae_ml100k", model=dataclasses.replace(vae.model, name="multdae"))
    base = zoo_configs.mf_bpr_ml100k()
    for short in GRAPH_ZOO:
        cfgs[short] = base.replace(run_name=f"{short}_ml100k", model=dataclasses.replace(base.model, name=short))
    return {short: cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(DATA_DIR / short), checkpoint_every_epochs=cfg.train.epochs))
        for short, cfg in cfgs.items()}


def recall_gate(short: str, value: float) -> None:
    """recall@20 within the JAX package's runs' range widened by
    RECALL20_MARGIN of their mean, and above 3x the random ranking's."""
    ref = JAX_RECALL20[short]
    mean = statistics.mean(ref)
    lo, hi = min(ref) - RECALL20_MARGIN * mean, max(ref) + RECALL20_MARGIN * mean
    print(f"{short}: recall@20 {value:.6f} in [{lo:.6f}, {hi:.6f}] (the JAX package's run() on the CPU at "
          f"seeds 42, 143, 244: {', '.join(f'{v:.6f}' for v in ref)}; min - {RECALL20_MARGIN} x mean, max + "
          f"{RECALL20_MARGIN} x mean), above 3 x 20/1682 = {3 * RANDOM_RECALL20:.6f}")
    check(lo <= value <= hi and value >= 3 * RANDOM_RECALL20,
          f"{short}'s recall@20 lies in the JAX package's range and above 3x random")


def no_noise(trainer) -> None:
    """Mult-VAE's reparameterisation eps set to 0, and IRGAN's Gumbel noise
    one draw made on the host from SEED, the same on both devices (a
    card-against-CPU comparison: the two devices' generators draw other
    numbers)."""
    if hasattr(trainer.model, "noise"):
        trainer.model.noise = lambda mu, generator: torch.zeros_like(mu)
    if hasattr(trainer.model, "gumbel"):
        gumbel = trainer.model.gumbel
        trainer.model.gumbel = lambda shape, generator, device: gumbel(
            shape, torch.Generator().manual_seed(SEED), "cpu").to(device)


def zoo_card_vs_cpu(cfg, rel_apart: float | None = None) -> None:
    """One step at dropout 0 (Mult-VAE's eps 0, IRGAN's Gumbel draw one
    host draw) on the card and on the CPU
    (the plain versions) from one initial state: the loss within LOSS_RTOL,
    the dense and gathered-row gradients within GRAD_TOL of the largest;
    after the step every table row, accumulator, dense param and dense
    optimizer leaf within STEP_RTOL / STEP_ATOL, except where the CPU's
    gradient lies within GRAD_TOL of 0 (a table row's combined gradient,
    a dense element): Adagrad's and Adam's first normalised updates are lr
    whatever the gradient's size, so there they turn rounding into up to
    lr. Those are counted. With ``rel_apart``, a table row whose combined
    gradient on the card differs from the CPU's by more than that share of
    the row's own largest entry, and a dense element by more than that
    share of itself, are set apart too (their normalised update moves by
    up to lr times that share): IRGAN's REINFORCE rows span many orders of
    magnitude, far below the largest row but above GRAD_TOL of it, and
    ConvNCF's first step from its init (a score near 0, the outer
    products' ~1/64 entries) sums cancelling terms in another order in
    cuDNN's backward than on the CPU."""
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.0),
                              train=dataclasses.replace(cfg.train, checkpoint_dir=None))
    t0 = time.perf_counter()
    card, cpu = Trainer(cfg, quiet=True), Trainer(cfg, quiet=True, device="cpu")
    cpu.state = copy_state(card.state, "cpu")
    no_noise(card)
    no_noise(cpu)
    host = next(card.sampler.epoch(0))
    b_card, b_cpu = card._to_device_batch(host), cpu._to_device_batch(host)
    loss_g, dense_g, rows_g, ids = card.builder.loss_and_grads(card.state, b_card)
    loss_c, dense_c, rows_c, ids_c = cpu.builder.loss_and_grads(cpu.state, b_cpu)
    after_g, _ = card.builder.step(copy_state(card.state), b_card)
    after_c, _ = cpu.builder.step(copy_state(cpu.state), b_cpu)
    torch.cuda.synchronize()
    errs = {"loss (relative)": abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())}
    dense_pairs = [(a.cpu(), e) for a, e in zip(tree_leaves(dense_g), tree_leaves(dense_c))]
    row_pairs = [(rows_g[n].cpu(), rows_c[n]) for n in rows_c]
    errs["dense grads"] = max((max_err(a, e) for a, e in dense_pairs), default=0.0)
    errs["row grads"] = max((max_err(a, e) for a, e in row_pairs), default=0.0)
    ok, near_zero = True, 0
    errs["tables"] = errs["acc"] = errs["dense"] = 0.0

    def close(got, want, keep):
        nonlocal ok
        ok &= torch.allclose(got[keep].double(), want[keep].double(), rtol=STEP_RTOL, atol=STEP_ATOL)
        return max_err(got[keep].double(), want[keep].double())

    for name, table_ids in ids_c.items():
        vocab = after_c["tables"][name].shape[0]
        uids, g = combine_duplicate_ids(table_ids, rows_c[name], sentinel=vocab)
        real = uids < vocab
        row_max = torch.zeros(vocab)
        row_max[uids[real].long()] = g[real].abs().amax(dim=1)
        keep = ~((row_max > 0) & (row_max <= GRAD_TOL * max(row_max.max().item(), 1e-30)))
        if rel_apart is not None:
            _, g_card = combine_duplicate_ids(ids[name], rows_g[name], sentinel=vocab)
            rel = (g_card.cpu() - g)[real].abs().amax(dim=1) / g[real].abs().amax(dim=1).clamp_min(1e-30)
            keep[uids[real][rel > rel_apart].long()] = False
        near_zero += int((~keep).sum())
        errs["tables"] = max(errs["tables"], close(after_g["tables"][name].cpu(), after_c["tables"][name], keep))
        for leaf, v in after_c["sparse_opt"][name].items():
            errs["acc"] = max(errs["acc"], close(after_g["sparse_opt"][name][leaf].cpu(), v, keep))
    for (got, want), (grad_g, grad) in zip(zip(tree_leaves(after_g["dense"]), tree_leaves(after_c["dense"])),
                                           dense_pairs):
        keep = grad.abs() > GRAD_TOL * max(grad.abs().max().item(), 1e-30)
        if rel_apart is not None:
            keep &= (grad_g - grad).abs() <= rel_apart * grad.abs()
        near_zero += int((~keep).sum())
        errs["dense"] = max(errs["dense"], close(got.cpu(), want, keep))
    opt = [(a, e) for a, e in zip(tree_leaves(after_g["dense_opt"]), tree_leaves(after_c["dense_opt"]))
           if isinstance(a, torch.Tensor)]
    errs["dense optimizer"] = max((max_err(a.cpu().double(), e.double()) for a, e in opt), default=0.0)
    ok &= all(torch.allclose(a.cpu().double(), e.double(), rtol=STEP_RTOL, atol=STEP_ATOL) for a, e in opt)
    print(f"{cfg.run_name} card against the CPU ({time.perf_counter() - t0:.1f} s), one step at dropout 0 from "
          f"one state: loss card {loss_g.item():.9g}, cpu {loss_c.item():.9g}; max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; {near_zero} table rows and dense elements whose CPU gradient lies within {GRAD_TOL} of 0 set "
          f"apart (loss rtol {LOSS_RTOL}; grads {GRAD_TOL} x max|ref|; after the step rtol {STEP_RTOL}, atol "
          f"{STEP_ATOL})")
    check(errs["loss (relative)"] <= LOSS_RTOL, f"{cfg.run_name}'s loss on the card matches the CPU's")
    check(all(within(a, e, GRAD_TOL, GRAD_TOL) for a, e in dense_pairs + row_pairs),
          f"{cfg.run_name}'s gradients on the card match the CPU's")
    check(ok, f"{cfg.run_name}'s state after a step on the card matches the CPU's")


def graph_repeats(trainer, short: str) -> None:
    """The propagation twice on the card, and a step twice from one state:
    bit for bit (sorted sums, no float atomics)."""
    dense = trainer.state["dense"]
    one, two = trainer.model.propagate(dense), trainer.model.propagate(dense)
    batch = trainer._to_device_batch(next(trainer.sampler.epoch(0)))
    s_one, _ = trainer.builder.step(copy_state(trainer.state), batch)
    s_two, _ = trainer.builder.step(copy_state(trainer.state), batch)
    torch.cuda.synchronize()
    prop = all(torch.equal(a, b) for a, b in zip(one, two))
    step = states_equal(s_one, s_two)
    u_side, _ = trainer.model.graph(dense["user_emb"].device)
    print(f"{short}: the propagation over {int(u_side.lengths.sum())} edges x {trainer.model.num_layers} layers "
          f"(users {tuple(one[0].shape)}, items {tuple(one[1].shape)}) repeats bit for bit: {prop}; a step "
          f"repeats bit for bit: {step}")
    check(prop and step, f"{short}'s propagation and step repeat bit for bit on the card")


def phase_zoo_history_graph(card: str, paths: dict) -> dict:
    """(O) the history zoo and the graph zoo on the card: ``trainer.run`` of
    fism_ml100k, nais_ml100k, multvae_ml100k and cdae_ml100k whole, Mult-DAE
    (O1), lightgcn and ngcf on mf_bpr_ml100k() (O2), each saving a
    checkpoint: recall@20 in the JAX package's range; launches (a history
    model one gather and one Adagrad launch a step and one gather a batch
    of eval users, a graph model none); serving from the trainer and from
    the checkpoint bit for bit; one step at dropout 0 against the CPU; a
    graph model's propagation and step bit for bit on repeat; the gather
    and Adagrad kernels at FISM's and Mult-VAE's steps (their records);
    examples/s, step medians, busy shares. Returns the kernels' records."""
    t_phase = time.perf_counter()
    records = {"gather_rows_multi": {}, "fused_rowwise_adagrad_multi": {}}
    for short, cfg in zoo_o_configs().items():
        t_model = time.perf_counter()
        graph = short in GRAPH_ZOO
        trainer, history, train_counts, evals, run_s = run_counted(cfg)
        steps = trainer.global_step
        evaluator = trainer._retrieval_eval
        eval_batches = -(-len(evaluator.users_with_test) // evaluator.user_batch)
        paths[f"trainer_{short}"] = whole_run_launches(train_counts, evals)
        rec = history[-1]
        rates = [r["examples_per_s"] for r in history]
        specs = [(s.name, s.shape) for s in trainer.model.table_specs()]
        print(f"{cfg.run_name} (O, run: synthetic_implicit {trainer.dataset.num_users} x "
              f"{trainer.dataset.num_items}, {len(trainer.dataset.train)} train interactions, loss "
              f"{trainer.loss_name}, {trainer.sampler.num_batches()} steps of {cfg.train.batch_size} an epoch, "
              f"{cfg.train.epochs} epochs, tables {specs}): {steps} steps; final record {rec}; launches in "
              f"training {train_counts}, in each eval pass ({eval_batches} batches of {evaluator.user_batch} "
              f"users) {evals[0][1]}; run() took {run_s:.1f} s")
        print(f"{cfg.run_name}: examples_per_s median over the epochs {statistics.median(rates):.1f} (min "
              f"{min(rates):.1f}, max {max(rates):.1f}; host clock over each epoch; {card}); eval passes "
              f"(host clock): " + ", ".join(f"{ms:.3f} ms" for ms, _ in evals))
        check(len(evals) == cfg.train.epochs // cfg.train.eval_every_epochs, f"{short}'s eval cadence")
        check(all(np.isfinite(v) for r in history for v in r.values()), f"{short}'s history is finite")
        trained = {} if graph else {"gather_rows_multi": steps, "fused_rowwise_adagrad_multi": steps}
        check_launches(train_counts, trained, f"{short} ran {trained or 'no kernel'} in training, and no other")
        for _, counts in evals:
            want = {} if graph else {"gather_rows_multi": eval_batches}
            check_launches(counts, want, f"each {short} eval pass ran {want or 'no kernel'}, and no other")
        recall_gate(short, rec["recall@20"])
        zoo_serving(card, paths, trainer, cfg, short, num_users=ZOO_SERVE_USERS, want={} if graph else None)
        batch = trainer._to_device_batch(next(trainer.sampler.epoch(0)))
        if graph:
            graph_repeats(trainer, short)
        if short in ("fism", "multvae"):
            sparse_kernel_checks(trainer.builder, trainer.state, batch, f"{short}_step", records)
            median, busy = step_profile(trainer.builder, trainer.state, batch, f"{short} step (O)")
            records["gather_rows_multi"][f"{short}_step"].update({"step_ms": median, "step_device_busy": busy})
        elif short in ("nais", "lightgcn"):
            step_profile(trainer.builder, trainer.state, batch, f"{short} step (O)")
        del trainer
        zoo_card_vs_cpu(cfg)
        print(f"{short} (O) took {time.perf_counter() - t_model:.1f} s")
    print(f"phase O took {time.perf_counter() - t_phase:.1f} s")
    return records


def zoo_p_configs() -> dict:
    """Phase P's configurations by short name, each saving a checkpoint
    after its last epoch under DATA_DIR: sbpr_ml100k, apr_ml100k,
    irgan_ml100k, wrmf_ml100k and ease_ml100k whole, and Pop and ConvNCF
    (d=64, 32 channels) on mf_bpr_ml100k()'s data and protocol, ConvNCF for
    CONVNCF_EPOCHS epochs and without l2 (CONVNCF_EPOCHS' note)."""
    cfgs = {short: zoo_configs.ZOO[f"{short}_ml100k"]() for short in TAIL_SGD + TAIL_CLOSED}
    base = zoo_configs.mf_bpr_ml100k()
    for short in TAIL_BASELINES:
        cfgs[short] = base.replace(run_name=f"{short}_ml100k", model=dataclasses.replace(base.model, name=short))
    conv = cfgs["convncf"]
    cfgs["convncf"] = conv.replace(model=dataclasses.replace(conv.model, l2_reg=0.0), train=dataclasses.replace(
        conv.train, epochs=CONVNCF_EPOCHS, eval_every_epochs=CONVNCF_EPOCHS,
        eval_user_batch=CONVNCF_EVAL_USERS))
    return {short: cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(DATA_DIR / short), checkpoint_every_epochs=cfg.train.epochs))
        for short, cfg in cfgs.items()}


def ease_predict_record(trainer) -> dict:
    """The gather at EASE's ``predict``: ``ease_bt`` [V, V] (rows of 6728
    bytes, not a multiple of 16: the kernel's float route) at a request's
    ZOO_SERVE_USERS item ids, one launch, bit for bit its plain version and
    on repeat; its times."""
    bt = trainer.state["tables"]["ease_bt"]
    rng = np.random.default_rng(SEED + 19)
    ids = torch.from_numpy(rng.integers(0, bt.shape[0], ZOO_SERVE_USERS).astype(np.int32)).to(bt.device)
    got, launches = launches_of(gather_rows_multi, lambda: gather_rows_multi([bt], [ids]))
    again = gather_rows_multi([bt], [ids])
    want = gather_rows_multi_ref([bt], [ids])
    torch.cuda.synchronize()
    ok = launches == 1 and torch.equal(got[0], want[0]) and torch.equal(got[0], again[0])
    print(f"gather_rows_multi at ease_predict {tuple(bt.shape)} x {ids.shape[0]} ids: one launch, bit for bit its "
          f"plain version and on repeat: {ok}")
    check(ok, "gather_rows_multi at EASE's predict: one launch, bit for bit its plain version and on repeat")
    return {**gather_times([bt], [ids], "ease_predict"), "max_abs_err": max_err(got[0], want[0])}


def closed_form_card_vs_cpu(cfg) -> None:
    """One ALS sweep (WRMF) or EASE's solve on the card and on the CPU from
    one state: the solved tables within ALS_RTOL / ALS_ATOL (EASE_RTOL /
    EASE_ATOL), the objective within ALS_OBJ_RTOL (EASE_RTOL); EASE's
    diagonal exactly 0 on the card."""
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, checkpoint_dir=None))
    t0 = time.perf_counter()
    card, cpu = Trainer(cfg, quiet=True), Trainer(cfg, quiet=True, device="cpu")
    cpu.solver.load(card.solver.tables())
    loss_g, loss_c = card.solver.epoch()["loss"], cpu.solver.epoch()["loss"]
    rtol, atol, obj_rtol = ((ALS_RTOL, ALS_ATOL, ALS_OBJ_RTOL) if cfg.model.name == "wrmf"
                            else (EASE_RTOL, EASE_ATOL, EASE_RTOL))
    ok, errs = True, {}
    for name, want in cpu.solver.tables().items():
        got = card.solver.tables()[name].cpu()
        ok &= torch.allclose(got, want, rtol=rtol, atol=atol)
        errs[name] = max_err(got, want)
    rel = abs(loss_g - loss_c) / abs(loss_c)
    zero_diag = True
    if cfg.model.name == "ease":
        zero_diag = bool((torch.diagonal(card.solver.tables()["ease_bt"]) == 0).all())
    print(f"{cfg.run_name} card against the CPU ({time.perf_counter() - t0:.1f} s), one "
          f"{'sweep' if cfg.model.name == 'wrmf' else 'solve'} from one state: objective card {loss_g:.9g}, cpu "
          f"{loss_c:.9g} (relative {rel:.3e}); max_abs_err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (rtol {rtol}, atol {atol}); the diagonal exactly 0: {zero_diag}")
    check(ok and rel <= obj_rtol and zero_diag, f"{cfg.run_name}'s solve on the card matches the CPU's")


def native_eval_check(trainer) -> None:
    """(P4) ``evaluate_dot_native`` over WRMF's solved tables (copied to the
    host) against the port's device evaluator on the card, metric for
    metric within NATIVE_RTOL / NATIVE_ATOL; both timed on the host clock."""
    t0 = time.perf_counter()
    device = trainer.evaluate()
    device_s = time.perf_counter() - t0
    t = trainer.state["tables"]
    ds = trainer.dataset
    t0 = time.perf_counter()
    native = evaluate_dot_native(t["user_emb"], t["item_emb"], None, ds.train_csr, ds.test_csr,
                                 trainer.config.train.eval_topk)
    native_s = time.perf_counter() - t0
    errs = {k: abs(v - device[k]) for k, v in native.items()}
    ok = all(abs(v - device[k]) <= NATIVE_ATOL + NATIVE_RTOL * abs(device[k]) for k, v in native.items())
    print(f"native evaluator (P4) on wrmf's tables {tuple(t['user_emb'].shape)} x {tuple(t['item_emb'].shape)}: "
          f"{len(native)} metrics, largest difference from the device evaluator {max(errs.values()):.3e} "
          f"({max(errs, key=errs.get)}; rtol {NATIVE_RTOL}, atol {NATIVE_ATOL}); recall@20 native "
          f"{native['recall@20']:.6f}, device {device['recall@20']:.6f}; host clock: native {native_s * 1e3:.1f} ms "
          f"({os.cpu_count()} host cores), device evaluator {device_s * 1e3:.1f} ms")
    check(ok and set(native) <= set(device), "the native evaluator's metrics are the device evaluator's")


def phase_long_tail(card: str, paths: dict) -> dict:
    """(P) the long tail on the card: ``trainer.run`` of sbpr_ml100k,
    apr_ml100k and irgan_ml100k (P1), wrmf_ml100k and ease_ml100k (P2) whole,
    and Pop and ConvNCF on mf_bpr_ml100k()'s data and protocol (P3), each
    saving a checkpoint: recall@20 in its band; launches (an SGD model one
    gather and one Adagrad launch a step, a closed-form one none in
    training; one gather a batch of eval users, none for Pop's bias row);
    WRMF's objective falling at every sweep; serving from the trainer and
    from the checkpoint bit for bit; the first step (SBPR, APR, IRGAN with
    one Gumbel draw on both devices, Pop, ConvNCF), one ALS sweep and
    EASE's solve against the CPU; the gather and Adagrad kernels at SBPR's
    and IRGAN's steps and the gather at EASE's predict; (P4) the native
    evaluator on WRMF's tables. Returns the kernels' records."""
    t_phase = time.perf_counter()
    records = {"gather_rows_multi": {}, "fused_rowwise_adagrad_multi": {}}
    for short, cfg in zoo_p_configs().items():
        t_model = time.perf_counter()
        closed = short in TAIL_CLOSED
        trainer, history, train_counts, evals, run_s = run_counted(cfg)
        steps = trainer.global_step
        evaluator = trainer._retrieval_eval
        eval_batches = -(-len(evaluator.users_with_test) // evaluator.user_batch)
        paths[f"trainer_{short}"] = whole_run_launches(train_counts, evals)
        rec = history[-1]
        rates = [r["examples_per_s"] for r in history]
        specs = [(n, tuple(t.shape)) for n, t in trainer.state["tables"].items()]
        feed = ("closed form, an epoch a solver sweep" if closed else
                f"{trainer.sampler.num_batches()} steps of {cfg.train.batch_size} an epoch")
        print(f"{cfg.run_name} (P, run: synthetic_implicit {trainer.dataset.num_users} x {trainer.dataset.num_items}, "
              f"{len(trainer.dataset.train)} train interactions, loss {trainer.loss_name}, {feed}, "
              f"{cfg.train.epochs} epochs, tables {specs}): {steps} steps; final record {rec}; losses "
              f"{[round(r['loss'], 6) for r in history]}; launches in training {train_counts}, in each eval pass "
              f"({eval_batches} batches of {evaluator.user_batch} users) {evals[0][1]}; run() took {run_s:.1f} s")
        print(f"{cfg.run_name}: examples_per_s median over the epochs {statistics.median(rates):.1f} (min "
              f"{min(rates):.1f}, max {max(rates):.1f}; host clock over each epoch{', train interactions re-solved' if closed else ''}; "
              f"{card}); eval passes (host clock): " + ", ".join(f"{ms:.3f} ms" for ms, _ in evals))
        check(len(evals) == cfg.train.epochs // cfg.train.eval_every_epochs, f"{short}'s eval cadence")
        check(all(np.isfinite(v) for r in history for v in r.values()), f"{short}'s history is finite")
        trained = {} if closed else {"gather_rows_multi": steps, "fused_rowwise_adagrad_multi": steps}
        check_launches(train_counts, trained, f"{short} ran {trained or 'no kernel'} in training, and no other")
        want_eval = {} if short == "pop" else {"gather_rows_multi": eval_batches}
        for _, counts in evals:
            check_launches(counts, want_eval, f"each {short} eval pass ran {want_eval or 'no kernel'}, and no other")
        if short in TAIL_BANDS:
            lo, hi = TAIL_BANDS[short]
            print(f"{cfg.run_name} band: recall@20 {rec['recall@20']:.6f} in [{lo}, {hi}] (tests/test_golden.py)")
            check(lo <= rec["recall@20"] <= hi, f"{short}'s recall@20 lies in its band")
        else:
            recall_gate(short, rec["recall@20"])
        if short == "wrmf":
            falls = all(b["loss"] < a["loss"] for a, b in zip(history, history[1:]))
            print(f"wrmf: the exact objective falls at every sweep: {falls}")
            check(falls, "wrmf's objective falls at every sweep")
            native_eval_check(trainer)
        zoo_serving(card, paths, trainer, cfg, short, num_users=ZOO_SERVE_USERS,
                    want_recommend={} if short == "pop" else None)
        if short == "ease":
            records["gather_rows_multi"]["ease_predict"] = ease_predict_record(trainer)
        if short in ("sbpr", "irgan"):
            batch = trainer._to_device_batch(next(trainer.sampler.epoch(0)))
            sparse_kernel_checks(trainer.builder, trainer.state, batch, f"{short}_step", records)
            median, busy = step_profile(trainer.builder, trainer.state, batch, f"{short} step (P)")
            records["gather_rows_multi"][f"{short}_step"].update({"step_ms": median, "step_device_busy": busy})
        elif short in ("apr", "convncf"):
            step_profile(trainer.builder, trainer.state, trainer._to_device_batch(next(trainer.sampler.epoch(0))),
                         f"{short} step (P)")
        del trainer
        if closed:
            closed_form_card_vs_cpu(cfg)
        else:
            zoo_card_vs_cpu(cfg, rel_apart=STEP_RTOL if short in ("irgan", "convncf") else None)
        print(f"{short} (P) took {time.perf_counter() - t_model:.1f} s")
    print(f"phase P took {time.perf_counter() - t_phase:.1f} s")
    return records



# ---- phase Q: the rest of the sharded subsystem (the lane-sliced wire,
# FSDP, IRGAN on a mesh, the port's dry run), int8 serving, step profiles
# and the matmul precision ----

def lane_config():
    """``dcn_criteo`` at Criteo's shape (26 fields of 100 000 rows, d=32,
    the data synthetic) with lane-packed tables: 7 packs of 4 fields (the
    last of 2), each [100 000, 128]."""
    cfg = zoo_configs.dcn_criteo(path="criteo")
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, lane_pack=True))


def phase_lane_sliced_step(card: str, paths: dict) -> dict:
    """(Q1) The lane-sliced step at world 1 over NCCL: ``lane_config()``, 8
    steps of 8192 from one state through ``ShardedTrainStepBuilder`` (every
    pack on the lane-sliced wire, f32) against the single-device packed
    step, at the reference's tolerance (tests/test_lane_pack.py:336-353);
    one gather, Adagrad, v1 forward and backward launch a step; the wire's
    float buffers d = 32 lanes wide; repeating bit for bit; the gather and
    Adagrad kernels at the owner's [rps * G, d] view shapes. Returns their
    records."""
    t_phase = time.perf_counter()
    device = init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, backend="nccl", device=DEVICE)
    try:
        mesh = make_mesh(-1, 1, device=DEVICE)
        cfg = lane_config()
        vocabs = tuple(cfg.data.categorical_vocab_sizes)
        model = build_model(cfg.model, DataSpec.ctr(vocabs, cfg.data.num_dense_features))
        k = cfg.train.steps_per_dispatch
        dense, cat, label = synthetic_ctr(k * BATCH, cfg.data.num_dense_features, vocabs, seed=SEED + 6)
        batches = [{"dense": to_device(dense[i * BATCH:(i + 1) * BATCH]),
                    "cat": to_device(cat[i * BATCH:(i + 1) * BATCH]),
                    "label": to_device(label[i * BATCH:(i + 1) * BATCH])} for i in range(k)]
        single = TrainStepBuilder(model, cfg.train.loss, cfg.optim)
        start = single.init_state(torch.Generator(device=DEVICE).manual_seed(SEED))
        builder = ShardedTrainStepBuilder(model, cfg.train.loss, cfg.optim, mesh,
                                          dataclasses.replace(cfg.mesh, a2a_dtype="float32"))
        lanes = {n: p.lane_groups for n, p in builder.plans.items()}
        sharded_start = builder.shard_state(copy_state(start))
        print(f"lane-sliced (Q1): world 1 over {mesh.backend} on {device} ({card}); tables "
              f"{[(n, tuple(t.shape)) for n, t in start['tables'].items()]}, lane groups {lanes}")
        check(model.lane_pack and all(g > 1 for g in lanes.values()), "every table is a lane-packed row plan")

        def run(b, state):
            losses = []
            for batch in batches:
                state, metrics = b.step(state, batch)
                losses.append(metrics["loss"])
            torch.cuda.synchronize()
            return state, torch.stack(losses)

        want, want_losses = run(single, copy_state(start))
        wire = []
        exchange = sharded_embedding._exchange

        def recording(m, bufs):
            wire.extend(tuple(b.shape) for b in bufs if b.is_floating_point())
            return exchange(m, bufs)

        sharded_embedding._exchange = recording
        try:
            reset_launches()
            got, losses = run(builder, copy_state(sharded_start))
            paths["train_lane_sliced"] = read_launches()
        finally:
            sharded_embedding._exchange = exchange
        launches = {n: c for n, c in paths["train_lane_sliced"].items() if c}
        widths = sorted({s[-1] for s in wire})
        print(f"lane-sliced (Q1): {k} steps, launches {launches}; the wire's float buffers {sorted(set(wire))} "
              f"(lanes a key {widths}, the packed row's {cfg.model.embed_dim * 4}); losses "
              f"{[round(x, 6) for x in losses.tolist()]}")
        check(launches == {"gather_rows_multi": k, "cross_v1_fwd": k, "cross_v1_bwd": k,
                           "fused_rowwise_adagrad_multi": k},
              "the lane-sliced step: one owner gather, Adagrad, v1 forward and backward launch a step, and no other")
        check(widths == [cfg.model.embed_dim], "the wire carries d lanes a key, never the packed row")
        pairs = [("tables", got["tables"], want["tables"]),
                 ("accumulators", {n: s["acc"] for n, s in got["sparse_opt"].items()},
                  {n: s["acc"] for n, s in want["sparse_opt"].items()}),
                 ("dense", dict(enumerate(tree_leaves(got["dense"]))), dict(enumerate(tree_leaves(want["dense"]))))]
        for what, a, b in pairs:
            err = max(max_err(a[n], b[n]) for n in b)
            close = all(torch.allclose(a[n], b[n], rtol=LANE_RTOL, atol=LANE_ATOL) for n in b)
            same = all(torch.equal(a[n], b[n]) for n in b)
            print(f"lane-sliced (Q1) against the single-device packed step, {what}: max_abs_err {err:.3e}, bit "
                  f"for bit {same} (rtol {LANE_RTOL}, atol {LANE_ATOL})")
            check(close, f"the lane-sliced step's {what} match the single-device packed step's")
        check(torch.allclose(losses, want_losses, rtol=LANE_RTOL), "the lane-sliced losses match")
        again, again_losses = run(builder, copy_state(sharded_start))
        check(states_equal(again, got) and torch.equal(again_losses, losses),
              "the lane-sliced step repeats bit for bit")
        del want, again, got
        records = sharded_kernel_checks(builder, copy_state(sharded_start), batches[0], key="lane_sliced")
    finally:
        torch.distributed.destroy_process_group()
    print(f"phase Q1 took {time.perf_counter() - t_phase:.1f} s")
    return records


def rest_fsdp(mesh) -> dict:
    """(Q3, in a rank) ``dcn_criteo`` at Criteo's shape on the (4, 1) mesh,
    3 steps of 8192 from the single-device init under replicated and FSDP
    dense params: their losses and logical states, bit for bit; the dense
    bytes a rank; the FSDP run's launches."""
    cfg = configs()["v1"]
    vocabs = tuple(cfg.data.categorical_vocab_sizes)
    model = build_model(cfg.model, DataSpec.ctr(vocabs, cfg.data.num_dense_features))
    start = TrainStepBuilder(model, cfg.train.loss, cfg.optim).init_state(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    dense, cat, label = synthetic_ctr(REST_STEPS * BATCH, cfg.data.num_dense_features, vocabs, seed=SEED + 7)
    b, lo = BATCH // mesh.size, mesh.data_index * (BATCH // mesh.size)
    batches = [{"dense": to_device(dense[i * BATCH + lo:i * BATCH + lo + b]),
                "cat": to_device(cat[i * BATCH + lo:i * BATCH + lo + b]),
                "label": to_device(label[i * BATCH + lo:i * BATCH + lo + b])} for i in range(REST_STEPS)]
    out, logical = {}, {}
    for sharding in ("replicated", "fsdp"):
        builder = ShardedTrainStepBuilder(model, cfg.train.loss, cfg.optim, mesh,
                                          dataclasses.replace(cfg.mesh, dense_sharding=sharding))
        state = builder.shard_state(copy_state(start))
        reset_launches()
        t0 = time.perf_counter()
        losses = []
        for batch in batches:
            state, metrics = builder.step(state, batch)
            losses.append(metrics["loss"].item())
        seconds = time.perf_counter() - t0
        leaves = tree_leaves(state["dense"]) + [x for k, v in state["dense_opt"].items() if k != "count"
                                                for x in tree_leaves(v)]
        out[sharding] = {"losses": losses, "launches": read_launches(), "seconds": seconds,
                         "dense_bytes": sum(x.numel() * x.element_size() for x in leaves),
                         "split": sum(a is not None for a in (builder._dense_axes or [])),
                         "leaves": len(tree_leaves(state["dense"]))}
        logical[sharding] = builder.logical_state(state)
    out["bitwise"] = states_equal(logical["fsdp"], logical["replicated"])
    return out


def rest_irgan(mesh) -> dict:
    """(Q4, in a rank) irgan_ml100k's model (d=64, six tables, a pool of 16)
    on the (4, 1) mesh, 3 steps of 1024 from the single-device init; rank 0
    also takes the 3 steps on one card from the same state (the same step
    generator, so the same Gumbel draw of the global batch): the errors of
    the losses, tables and accumulators. The accumulators start at
    IRGAN_ADAGRAD_INIT, not the config's 0: from 0 Adagrad's first update
    of a row is lr whatever its gradient's size, which turns the rounding
    of a REINFORCE row whose terms cancel (the global baseline summed over
    ranks in another order) into up to lr (phase P sets such rows apart
    instead)."""
    cfg = zoo_configs.irgan_ml100k()
    users, items, k = cfg.data.num_users, cfg.data.num_items, cfg.train.num_negatives
    model = build_model(cfg.model, DataSpec.interaction(users, items))
    kw = dict(l2_reg=cfg.model.l2_reg, seed=cfg.train.seed)
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, adagrad_init=IRGAN_ADAGRAD_INIT))
    single = TrainStepBuilder(model, "irgan", cfg.optim, **kw)
    start = single.init_state(torch.Generator(device=DEVICE).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 8)
    big = cfg.train.batch_size
    batches = [{"user": rng.integers(0, users, big).astype(np.int32),
                "pos": rng.integers(0, items, big).astype(np.int32),
                "negs": rng.integers(0, items, (big, k)).astype(np.int32)} for _ in range(REST_STEPS)]
    b, lo = big // mesh.size, mesh.data_index * (big // mesh.size)
    builder = ShardedTrainStepBuilder(model, "irgan", cfg.optim, mesh, MeshConfig(a2a_dtype="float32"), **kw)
    state = builder.shard_state(copy_state(start))
    reset_launches()
    losses = []
    for batch in batches:
        state, metrics = builder.step(state, {n: to_device(v[lo:lo + b]) for n, v in batch.items()})
        losses.append(metrics["loss"].item())
    out = {"losses": losses, "launches": read_launches(), "tables": len(state["tables"])}
    logical = builder.logical_state(state)
    if mesh.rank == 0:
        want, want_losses = copy_state(start), []
        for batch in batches:
            want, metrics = single.step(want, {n: to_device(v) for n, v in batch.items()})
            want_losses.append(metrics["loss"].item())
        out["want_losses"] = want_losses
        out["table_err"] = max(max_err(logical["tables"][n], t) for n, t in want["tables"].items())
        out["acc_err"] = max(max_err(logical["sparse_opt"][n]["acc"], s["acc"])
                             for n, s in want["sparse_opt"].items())
        out["close"] = all(
            torch.allclose(logical["tables"][n], t, rtol=IRGAN_RTOL, atol=IRGAN_ATOL)
            and torch.allclose(logical["sparse_opt"][n]["acc"], want["sparse_opt"][n]["acc"], rtol=IRGAN_RTOL,
                               atol=IRGAN_ATOL) for n, t in want["tables"].items())
    return out


def rest_work(out: dict) -> None:
    """(Q2-Q4, in one of M4's 4 ranks, after M4) the port's dry run of every
    mode (Q2), FSDP against replicated dense params (Q3) and IRGAN's
    sharded steps (Q4), on the ranks' own meshes: the results under
    ``out["rest"]``."""
    reset_launches()
    t0 = time.perf_counter()
    checks, losses = dryrun.run_modes(REST_RANKS, DEVICE)
    torch.cuda.synchronize()
    rest = {"dryrun": {"checks": checks, "losses": losses, "launches": read_launches(),
                       "seconds": time.perf_counter() - t0}}
    mesh = make_mesh(-1, 1, device=DEVICE)
    t0 = time.perf_counter()
    rest["fsdp"] = rest_fsdp(mesh)
    rest["fsdp"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rest["irgan"] = rest_irgan(mesh)
    rest["irgan"]["phase_s"] = time.perf_counter() - t0
    out["rest"] = rest


def rest_checks(card: str, paths: dict, ranks: list) -> None:
    """(Q2-Q4) the results of M4's spawn of 4 ranks sharing the card over
    gloo: (Q2) the port's ``dryrun_multichip`` modes on a (2, 2) mesh,
    every one ok and gspmd said not ported; (Q3) FSDP bit for bit the
    replicated dense params at ``dcn_criteo``'s full width, at least one
    leaf split, the dense bytes a rank; (Q4) IRGAN's sharded steps against
    the single-card steps. Launches counted a path, every rank's summed."""
    res = [r["rest"] for r in ranks]
    dry = res[0]["dryrun"]
    line = f"dryrun_multichip({REST_RANKS}): " + "; ".join(dry["checks"])
    print(f"dry run (Q2), 4 ranks over gloo sharing the card ({card}), {dry['seconds']:.1f} s: {line}")
    tags = [t for t, *_ in dryrun.modes(2)]
    check(all(f"{t} ok loss=" in line for t in tags) and "gspmd not ported" in line and "gspmd ok" not in line
          and line.endswith("sharded_topk ok"), "the dry run: every mode ok, gspmd not ported, the top-k ok")
    check(all(r["dryrun"]["losses"] == dry["losses"] for r in res), "every rank's dry-run losses are the same")
    paths["dryrun_4_ranks"] = {n: sum(r["dryrun"]["launches"][n] for r in res) for n in WRAPPERS}
    fs = res[0]["fsdp"]
    rep, fsdp = fs["replicated"], fs["fsdp"]
    print(f"FSDP (Q3): dcn_criteo at Criteo's shape on 4 ranks, {REST_STEPS} steps of {BATCH}: {fsdp['split']} of "
          f"{fsdp['leaves']} dense leaves split; dense params and moments a rank {fsdp['dense_bytes']} bytes "
          f"against {rep['dense_bytes']} replicated; losses {fsdp['losses']} (replicated {rep['losses']}); "
          f"bit for bit the replicated run: {fs['bitwise']}; {fsdp['seconds']:.2f} s against {rep['seconds']:.2f} s "
          f"(host clock, gloo staging; {card})")
    check(all(r["fsdp"]["bitwise"] for r in res) and fsdp["losses"] == rep["losses"],
          "FSDP is bit for bit the replicated step")
    check(fsdp["split"] >= 1 and fsdp["dense_bytes"] < rep["dense_bytes"], "FSDP splits dense leaves")
    paths["train_fsdp"] = {n: sum(r["fsdp"]["fsdp"]["launches"][n] for r in res) for n in WRAPPERS}
    check(all(r["fsdp"]["fsdp"]["launches"]["gather_rows_multi"] == REST_STEPS
              and r["fsdp"]["fsdp"]["launches"]["fused_rowwise_adagrad_multi"] == REST_STEPS for r in res),
          "each FSDP rank: one gather and one Adagrad launch a step")
    ir = res[0]["irgan"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(ir["losses"], ir["want_losses"])]
    print(f"IRGAN (Q4): irgan_ml100k's model on 4 ranks, {REST_STEPS} steps of "
          f"{zoo_configs.irgan_ml100k().train.batch_size}: losses {ir['losses']} against one card's "
          f"{ir['want_losses']} (relative gap {max(gaps):.2e}); tables max_abs_err {ir['table_err']:.3e}, "
          f"accumulators {ir['acc_err']:.3e} (rtol {IRGAN_RTOL}, atol {IRGAN_ATOL}); rank 0's launches "
          f"{ {n: c for n, c in ir['launches'].items() if c} }")
    check(ir["close"] and max(gaps) <= IRGAN_RTOL, "IRGAN's sharded steps match the single-card steps")
    check(all(r["irgan"]["launches"]["gather_rows_multi"] == REST_STEPS for r in res),
          "each IRGAN rank: one gather launch a step")
    paths["train_irgan_sharded"] = {n: sum(r["irgan"]["launches"][n] for r in res) for n in WRAPPERS}
    print(f"Q2-Q4 took {dry['seconds'] + res[0]['fsdp']['phase_s'] + res[0]['irgan']['phase_s']:.1f} s in rank 0 "
          f"(Q2 {dry['seconds']:.1f} s, Q3 {res[0]['fsdp']['phase_s']:.1f} s, Q4 {res[0]['irgan']['phase_s']:.1f} s), "
          "inside M4's spawn")


def peak_bytes(fn) -> int:
    """Device memory ``fn`` allocated at its peak, above what was held before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def phase_int8_serving(card: str, paths: dict) -> None:
    """(Q5) ``Recommender(quantize=True)``: MF at bench.py's shape (1M items,
    d=64), ``recommend`` of 1024 users, k=100: one gather launch a call; its
    ids and values a plain top-k of the dequantized scores (ids where
    untied); the int8 table a quarter of the f32 bytes; its overlap with the
    f32 top-k, peak memory and latency beside the f32 call's."""
    t_phase = time.perf_counter()
    model = MF(DataSpec.interaction(MF_ROWS, MF_ROWS), MF_DIM)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED + 9), DEVICE)
    f32 = Recommender(model, params)
    quant = Recommender(model, params, quantize=True)
    qt = quant._quant
    f32_bytes = params["tables"]["item_emb"].numel() * 4
    int8_bytes = qt.values.numel() * qt.values.element_size()
    users = np.random.default_rng(SEED + 10).integers(0, MF_ROWS, TOPK_USERS).astype(np.int32)
    reset_launches()
    ids, vals = quant.recommend(users, TOPK_K)
    paths["serve_int8"] = launches = read_launches()
    check(launches["gather_rows_multi"] == 1 and sum(launches.values()) == 1,
          "the int8 recommend ran one gather launch, and no other")
    f_ids, _ = f32.recommend(users, TOPK_K)
    overlap = float(np.mean([len(set(a) & set(b)) / TOPK_K for a, b in zip(ids, f_ids)]))
    u = params["tables"]["user_emb"][to_device(users).long()]
    deq = qt.values.to(torch.float32) * qt.scales[:, None]
    scores = torch.matmul(u, deq.T) + params["tables"]["item_bias"][:, 0][None, :]
    top = torch.topk(scores, TOPK_K)
    same, near = untied_equal(ids, vals, top.indices.cpu().numpy(), top.values.cpu().numpy(), QUANT_RTOL)
    del deq, scores, top, u
    peaks = {"f32": peak_bytes(lambda: f32.recommend(users, TOPK_K)),
             "int8": peak_bytes(lambda: quant.recommend(users, TOPK_K))}
    medians = medians_in_turns({"f32": lambda: f32.recommend(users, TOPK_K),
                                "int8": lambda: quant.recommend(users, TOPK_K)})
    print(f"int8 serving (Q5): MF {MF_ROWS} items, d={MF_DIM}; item table int8 {int8_bytes} bytes (+ scales "
          f"{qt.scales.numel() * 4}) against f32 {f32_bytes}; recommend {TOPK_USERS} users, k={TOPK_K}: launches "
          f"{ {n: c for n, c in launches.items() if c} }; a plain top-k of the dequantized scores: {same} ({near} "
          f"near-tied places, rtol {QUANT_RTOL}); overlap with the f32 top-k {overlap:.4f}; peak memory of a call "
          f"int8 {peaks['int8']} bytes, f32 {peaks['f32']} bytes; latency (host clock, median in turns) int8 "
          f"{medians['int8']:.3f} ms, f32 {medians['f32']:.3f} ms ({card})")
    check(int8_bytes * 4 == f32_bytes and qt.values.dtype == torch.int8, "the int8 table is a quarter of the f32 bytes")
    check(ids.shape == (TOPK_USERS, TOPK_K) and bool(np.isfinite(vals).all()) and same,
          "the int8 recommend is a top-k of the int8 table's scores")
    check(overlap >= QUANT_MIN_OVERLAP, f"the int8 top-k overlaps the f32 top-k by at least {QUANT_MIN_OVERLAP}")
    print(f"phase Q5 took {time.perf_counter() - t_phase:.1f} s")


def count_window_launches(profiler, name: str) -> dict:
    """Counts ``name``'s wrapper launches while ``profiler``'s trace is
    open: the count at the window's start, taken from the count at its
    close, into the returned dict's "launches" (the wrappers' own counts run
    on for the path)."""
    window = {}
    wrapper, open_step, close = WRAPPERS[name], profiler.step, profiler.close

    def step(step_idx):
        was_open = profiler.active
        open_step(step_idx)
        if profiler.active and not was_open:
            window["start"] = wrapper.launches

    def closing():
        if profiler.active:
            window["launches"] = wrapper.launches - window["start"]
        close()

    profiler.step, profiler.close = step, closing
    return window


def profile_checks(card: str, trainer, cfg, window: dict) -> None:
    """(Q6) the trace of ``train.profile_steps=(8, 16)`` over dispatches of
    8 steps: one ``train_step`` range on the host (the card's copy of it
    aside), the dispatch that starts at step 8, and its launches of the
    gather kernel: exactly 8 by the wrapper's count inside the window
    (``window``, from ``count_window_launches``), and in the trace at least
    one of ``gather_rows_multi``'s ``gather_rows_kernel`` events and no more
    than those 8. The profiler of a long process may lose a short kernel's
    event (PERF.md §7): the lost ones are counted."""
    events = json.loads(Path(trainer.profiler.path).read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    gathers = sum("gather_rows_kernel" in n for n in kernels)
    ranges = sum(e.get("name") == "train_step" and e.get("cat") == "user_annotation" for e in events)
    k = cfg.train.steps_per_dispatch
    print(f"profile window (Q6): profile_steps={PROFILE_WINDOW} over dispatches of {k}: trace "
          f"{os.path.getsize(trainer.profiler.path)} bytes, {ranges} train_step range(s), {len(kernels)} kernel "
          f"events, {gathers} gather_rows_kernel events of the window's {window.get('launches')} "
          f"gather_rows_multi launches by its count ({window.get('launches', 0) - gathers} events lost) ({card})")
    check(window.get("launches") == k, f"the window's dispatch launched gather_rows_multi {k} times, by its count")
    check(ranges == 1 and 1 <= gathers <= k, "the trace holds the window's dispatch only, with its gather kernels")


def phase_profile_and_precision(card: str, paths: dict) -> None:
    """(Q6-Q7) the proxy run at ``train.matmul_precision="default"``, its
    window ``PROFILE_WINDOW`` profiled (Q6, ``profile_checks``), and at
    "bfloat16" in the proxy band (Q7): AUC, examples/s and the step's host
    median in turns (the precision set before each step)."""
    t_phase = time.perf_counter()
    base = trainer_configs()["proxy"]
    trainers, finals = {}, {}
    try:
        for name in ("default", "bfloat16"):
            train = dataclasses.replace(base.train, matmul_precision=name,
                                        profile_steps=PROFILE_WINDOW if name == "default" else None)
            cfg = dataclasses.replace(base, train=train)
            trainers[name] = trainer = Trainer(cfg, quiet=True)
            trainer.profiler.out_dir = str(DATA_DIR / "trace")
            window = count_window_launches(trainer.profiler, "gather_rows_multi")
            reset_launches()
            finals[name] = trainer.train()[-1]
            paths["trainer_profiled" if name == "default" else "trainer_proxy_bf16"] = read_launches()
            if name == "default":
                profile_checks(card, trainer, cfg, window)
        batch = trainers["default"]._to_device_batch(next(trainers["default"].sampler.epoch(0)))

        def stepper(name):
            trainer = trainers[name]

            def step():
                set_matmul_precision(name)
                trainer.builder.step(trainer.state, batch)
            return step

        medians = medians_in_turns({name: stepper(name) for name in trainers})
    finally:
        set_matmul_precision("default")
    print(f"bf16 proxy (Q7): dcn_criteo() proxy, 300000 examples, 1 epoch: bfloat16 auc "
          f"{finals['bfloat16']['auc']:.6f} logloss {finals['bfloat16']['logloss']:.6f} examples_per_s "
          f"{finals['bfloat16']['examples_per_s']:.1f}; default (profiled over its window) auc "
          f"{finals['default']['auc']:.6f} examples_per_s {finals['default']['examples_per_s']:.1f}; band "
          f"{PROXY_AUC_BAND}; train step of {BATCH} (host clock, median in turns) bfloat16 "
          f"{medians['bfloat16']:.3f} ms, default {medians['default']:.3f} ms; launches "
          f"{ {n: c for n, c in paths['trainer_proxy_bf16'].items() if c} } ({card})")
    check(PROXY_AUC_BAND[0] <= finals["bfloat16"]["auc"] <= PROXY_AUC_BAND[1], "the bf16 proxy AUC lies in its band")
    print(f"phase Q6-Q7 took {time.perf_counter() - t_phase:.1f} s")

def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    rng = np.random.default_rng(SEED)
    card = phase_environment()
    phase_build()
    errs = phase_kernels(rng)
    general = phase_wide()
    cfgs = configs()
    paths = {}
    model, rec, requests, paths["serve_v1"] = phase_main_path(rng, cfgs["v1"])
    records = phase_times(model, rec, requests, errs)
    builder, per_table, state, batches, paths["train_v1"] = phase_train(cfgs["v1"])
    records += phase_train_times(builder, per_table, state, batches, errs)
    del model, rec, requests, builder, per_table, state, batches
    _, rec, requests, paths["serve_v2"] = phase_main_path(rng, cfgs["v2"])
    builder, per_table, state, batches, paths["train_v2"] = phase_train(cfgs["v2"])
    records += phase_v2_times(rec, requests, builder, per_table, state, batches, errs)
    del rec, requests, builder, per_table, state, batches
    records += phase_interaction(card)
    phase_trainer(card, paths)
    phase_proxy_band(card)
    phase_trainer_card_vs_cpu()
    phase_config1_band(card, paths)
    phase_config1_card_vs_cpu(paths)
    model, state, mf_records = phase_mf_bench(card, paths)
    phase_mf_topk(card, paths, model, state)
    del model, state
    phase_config4_band(card)
    fm_trainer, fm_history = phase_config2(card, paths)
    neumf_trainer = phase_config3(card, paths)
    phase_configs_card_vs_cpu()
    shapes = phase_new_shapes(fm_trainer, neumf_trainer)
    phase_serve_configs(card, paths, fm_trainer, neumf_trainer)
    del fm_trainer, neumf_trainer
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    try:
        files = phase_criteo_files(card, paths)
        phase_resume(card, files)
        phase_serve_checkpoint(card, paths, files)
        del files["trainer"]
        phase_movielens_files(card, paths)
        phase_cli(card, files)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    try:
        layouts = phase_layouts(card, paths)
        records.append(phase_fm_packed(card, paths, layouts, fm_history))
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    sharded_records = phase_sharded_step(card, paths)
    try:
        phase_sharded_serve(card, paths, phase_sharded_trainer(card, paths))
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    try:
        phase_mesh_two(card, paths)
        phase_mesh_four(card, paths)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    zoo_records = phase_ctr_zoo(card, paths)
    try:
        zoo_records["gather_rows_multi"].update(phase_sequential(card, paths))
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    try:
        history_graph = phase_zoo_history_graph(card, paths)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    try:
        long_tail = phase_long_tail(card, paths)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    t_q = time.perf_counter()
    lane_records = phase_lane_sliced_step(card, paths)
    phase_int8_serving(card, paths)
    try:
        phase_profile_and_precision(card, paths)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    print(f"phase Q took {time.perf_counter() - t_q:.1f} s (Q2-Q4 inside phase M4)")
    for r in records:
        if r["name"] == GROUPED:  # the Adagrad kernel's launches on the packed paths
            by_path = {path: paths[path]["fused_rowwise_adagrad_multi"] for path in GROUPED_PATHS}
        else:
            by_path = {path: launches.get(r["name"], 0) for path, launches in paths.items()}
        r.update({"launches": sum(by_path.values()), "launches_by_path": by_path})
        r.update({k: KERNELS[r["name"]][k] for k in ("source", "replaces")})
        if r["name"].startswith("cross_v2"):
            r["general_route"] = general  # the wide phase's shapes past the tiles
        if r["name"] in mf_records:
            r["mf_bench"] = mf_records[r["name"]]  # MF's 3 tables at bench.py's shape
        r.update(shapes.get(r["name"], {}))  # FM's 12 tables, NeuMF's 4
        r.update(layouts.get(r["name"], {}))  # phase K's packed and stacked shapes
        r.update(sharded_records.get(r["name"], {}))  # phase L's owner gather and update
        r.update(zoo_records.get(r["name"], {}))  # phase N's 52 tables and sequential steps
        r.update(history_graph.get(r["name"], {}))  # phase O's FISM and Mult-VAE steps
        r.update(long_tail.get(r["name"], {}))  # phase P's SBPR and IRGAN steps, EASE's predict
        r.update(lane_records.get(r["name"], {}))  # phase Q1's owner gather and update on the lane views
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s in all (the kernels' build included; {card})")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:  # one of phase L2's ranks
        sys.exit(sharded_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--mesh-rank"]:  # one of phase M's ranks
        sys.exit(mesh_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
