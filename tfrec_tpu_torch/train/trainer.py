"""Config-driven training driver: the counterpart of
``tfrec_tpu/train/trainer.py`` on one device.

One ``Trainer`` wires the data, the model (``models.build_model``), the
step (``step.TrainStepBuilder``: on a card the gather and rowwise-Adagrad
kernels, and for DCN the cross-stack kernels), fixed-shape batches copied
to the device ahead of the step (``prefetch``), the epoch loop with K steps
a dispatch (``multi_step``), the eval cadence, early stopping and the JSONL
metric stream (``MetricLogger``), with the reference's records.
``run(config)`` builds one and trains it. Three data paths:

- interaction data (``synthetic_implicit``) with a retrieval model (mf,
  gmf, mlp, neumf): ``build_dataset`` splits it; ``PairwiseSampler`` feeds
  the pairwise losses (bpr, hinge, sampled_softmax, in_batch_softmax; with
  ``train.device_negatives`` the step draws bpr's and hinge's negatives on
  the device) and ``PointwiseSampler`` logloss and mse; the eval ranks the
  full catalog for every user with test items
  (``eval.retrieval.RetrievalEvaluator``: precision, recall, MAP, NDCG and
  MRR at ``train.eval_topk``, train items masked), or with
  ``train.eval_protocol="sampled"`` each held-out item against sampled
  negatives (``eval.sampled.SampledEvaluator``: HR and NDCG at k), plus an
  AUC over sampled negatives under logloss;
- interaction data with a CTR model (fm, dcn, dcnv2): pointwise samples
  become multi-field batches, cat = [user, item, user side fields..., item
  side fields...] (``_host_batch``; ``data.synthetic_side_features`` draws
  the side fields); the eval adds the AUC over sampled negatives and, where
  the model scores the catalog (2-field FM), the full-catalog metrics;
- CTR data (``synthetic_ctr``, or a Criteo TSV, ``source="criteo"``) with a
  CTR model: shuffled batches (``CTRBatcher``) of the materialized rows
  (``load_criteo``), or with ``data.streaming`` the file streamed in order
  past its first ``data.eval_examples`` lines (``CriteoStreamBatcher``);
  AUC and logloss on the held-out rows.

Interaction data is generated (``synthetic_implicit``) or read from
MovieLens' rating files (``build_dataset``), and a CTR model over it reads
ML-1M's ``users.dat`` and ``movies.dat`` side fields
(``data.user_features_path`` / ``item_features_path``).

Checkpoints are the JAX package's on-disk layout (``utils/checkpoint.py``,
the keys of ``convert.flat_from_state``): ``train.checkpoint_every_epochs``
saves the state after those epochs, ``train.resume`` carries on from the
latest checkpoint of ``train.checkpoint_dir`` (whether the port or JAX
saved it), and ``train.init_from`` copies another run's embedding tables
first (the model's ``warm_start_aliases``, then the same name).

The device is the card unless the caller passes ``device="cpu"`` (the
kernels' plain versions); without CUDA the default raises. What the port
does not take yet it refuses by naming the ROADMAP Queue 1 item, never
passing it over: models other than mf, fm, gmf, mlp, neumf, dcn and dcnv2,
user histories, sequences and the social graph (item 12), step profiles
(item 10), FSDP and lane-packed sharded tables (item 11), and
``train.matmul_precision`` other than "default" (item 5).

On D x T ranks (a ``torch.distributed`` process group, ``parallel.mesh.
init_distributed``; the CLI starts one from the reference's ``JAX_*``
variables), the reference's rule picks the mesh path: ``mesh.data_axis_size
!= 0`` and a world size above 1 or a table axis above 1 (which needs as
many ranks); ``mesh.data_axis_size=0`` on more than one rank is refused.
Then the step is ``parallel.step.ShardedTrainStepBuilder`` on the ``data``
x ``table`` mesh (row- or column-sharded or replicated tables, replicated
dense params). The batch splits over ``data`` only: each rank samples its
B / D rows of every global batch with the seed ``seed * D + d``, d its data
index, so the ranks that share a d (the table axis' replicas) draw the same
rows (a stream takes its data index's round-robin stripe, the evals split
their rows the same way), and an epoch is the sampler's batches over D.
The reference seeds each process by its process index and cuts B over the
process count, which under T > 1 would hand the replicas of one data index
different rows (ROADMAP Queue 3); the port follows the mesh's axes. The
step's loss and overflow are global, and an epoch that dropped ids over
capacity logs a ``lookup_overflow`` event with its drop rate. The evals:
CTR data forwards each data index's contiguous block of every held-out
batch through the builder's lookup and all-gathers the logits over
``data``, so AUC and logloss are the same on every rank
(``eval_lookup_overflow`` where the eval dropped ids), and so does the AUC
over interaction data (its rows padded to a multiple of D by repeating its
first rows, as the reference pads); the full-catalog eval of a dot-product
scorer runs ``parallel/eval.ShardedRetrievalEvaluator`` on the live state,
and the sampled eval (and the full-catalog eval of a scorer without a dot
decomposition) runs on ``Trainer.params``, the logical tables gathered
from every rank. Rank 0 alone writes the metric stream. On a one-axis
row-sharded mesh every rank writes its blocks of a checkpoint; any other
mesh saves the logical state, gathered over both axes, which rank 0 writes.
A checkpoint of any mesh shape (the port's or JAX's) resumes at any other
through the global state (``convert.shard_state``), under the reference's
row-permute guards.

``train.host_dedup`` sorts each train batch's ids on the host, in the
prefetch worker, for the step's duplicate combine (``host_dedup_sorts``).
``model.lane_pack=None`` (AUTO) builds per-field tables, except where a run
resumes from a checkpoint: then it takes the checkpoint's layout, packed or
per-field, as the reference does.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from tfrec_tpu_torch import convert
from tfrec_tpu_torch.configs import Config
from tfrec_tpu_torch.data.criteo import NUM_CATEGORICAL, CriteoStreamBatcher, load_criteo
from tfrec_tpu_torch.data.dataset import build_dataset
from tfrec_tpu_torch.data.samplers import (
    CTRBatcher,
    PairwiseSampler,
    PointwiseSampler,
    popularity_cdf,
)
from tfrec_tpu_torch.data.synthetic import synthetic_ctr
from tfrec_tpu_torch.eval.metrics import auc as auc_metric
from tfrec_tpu_torch.eval.metrics import logloss as logloss_metric
from tfrec_tpu_torch.eval.retrieval import RetrievalEvaluator
from tfrec_tpu_torch.eval.sampled import SampledEvaluator
from tfrec_tpu_torch.models import BUILT, NOT_PORTED, DataSpec, build_model
from tfrec_tpu_torch.parallel.embedding import ColShardedTable
from tfrec_tpu_torch.parallel.eval import ShardedRetrievalEvaluator
from tfrec_tpu_torch.parallel.mesh import make_mesh, world_size
from tfrec_tpu_torch.train.losses import IN_BATCH_LOSSES, MULTI_NEG_LOSSES, PAIRWISE_LOSSES
from tfrec_tpu_torch.train.step import TrainStepBuilder, copy_state, host_dedup_sorts
from tfrec_tpu_torch.utils import checkpoint
from tfrec_tpu_torch.utils.logging import MetricLogger
from tfrec_tpu_torch.utils.prefetch import prefetch

INTERACTION_SOURCES = ("movielens", "synthetic_implicit")
CTR_SOURCES = ("criteo", "synthetic_ctr")
# The reference's CTR models (its trainer's CTR_MODELS); over interaction
# data they train on [user, item, side fields...] batches.
CTR_MODELS = ("fm", "dcn", "dcnv2", "deepfm", "nfm", "widedeep", "dlrm")
EVAL_BATCH = 8192  # rows of a held-out forward, at most


def _criteo_vocabs(sizes) -> tuple:
    """Criteo's 26 per-field vocabs: one size is broadcast, 26 are taken as
    they are, any other count is a config error."""
    sizes = tuple(sizes)
    if len(sizes) == 1:
        return sizes * NUM_CATEGORICAL
    if len(sizes) != NUM_CATEGORICAL:
        raise ValueError(
            f"criteo needs 1 or {NUM_CATEGORICAL} categorical_vocab_sizes, got {len(sizes)}")
    return sizes


def _refuse_unported(c: Config) -> None:
    """Raise on every setting the port does not take yet, naming the
    ROADMAP Queue 1 item that ports it."""
    source, name = c.data.source, c.model.name.lower()
    if source not in INTERACTION_SOURCES + CTR_SOURCES:
        raise ValueError(f"unknown data source {source!r}")
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model {c.model.name!r} is not ported yet: ROADMAP Queue 1 item {NOT_PORTED[name]}; "
            f"the port trains {BUILT}")
    t = c.train
    if t.profile_steps is not None:
        raise NotImplementedError(
            "train.profile_steps (utils/profile.py) is not ported yet: ROADMAP Queue 1 item 10")
    if t.matmul_precision != "default":
        raise NotImplementedError(
            f"train.matmul_precision={t.matmul_precision!r} is not ported yet: ROADMAP Queue 1 "
            "item 5; the port runs f32 matmuls with TF32 off")


class Trainer:
    def __init__(self, config: Config, quiet: bool = False, device: torch.device | str = "cuda",
                 log_metrics: bool = True):
        """``device``: the card by default; without CUDA this raises rather
        than train on the CPU, so pass ``device="cpu"`` for that.
        ``log_metrics=False`` keeps this construction out of the run's
        metric stream on disk (``serve.Recommender.from_checkpoint`` builds a
        Trainer only to restore a state; a second run_config record would
        corrupt the training run's stream)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer trains on device='cuda' by default, but CUDA is not available; "
                "pass device='cpu' to train on the CPU")
        _refuse_unported(config)
        self.config = c = config
        # The reference's rule: the mesh path where the data axis is not
        # forced off and there is more than one rank.
        self.mesh = None
        if world_size() > 1 or c.mesh.table_axis_size > 1:
            if c.mesh.data_axis_size == 0:
                # Every rank would train alone as the lead, each writing the
                # stream and the checkpoints into one directory.
                raise ValueError(
                    f"mesh.data_axis_size=0 (the single-device path) on {world_size()} ranks: "
                    "start one process for a single-device run, or let the ranks share the "
                    "data axis (mesh.data_axis_size=-1)")
            if world_size() % c.mesh.table_axis_size:
                raise ValueError(
                    f"mesh.table_axis_size={c.mesh.table_axis_size} needs a multiple of as many "
                    f"ranks, but the process group has {world_size()}: start data x table ranks "
                    "(JAX_NUM_PROCESSES under the CLI)")
            self.mesh = make_mesh(c.mesh.data_axis_size, c.mesh.table_axis_size, device)
            self.device = self.mesh.device
            n_data = self.mesh.size
            if c.train.batch_size % n_data != 0:
                raise ValueError(
                    f"train.batch_size={c.train.batch_size} must be divisible by the data mesh "
                    f"axis ({n_data} ranks); use e.g. {(c.train.batch_size // n_data + 1) * n_data}")
        elif c.mesh.row_permute:
            raise ValueError(
                "mesh.row_permute requires the sharded (mesh) path; this run resolved to the "
                "single-device builder — drop the flag or run on a mesh")
        # The batch's split: this rank's data index and the data axis' size.
        self.rank, self.num_ranks = (self.mesh.data_index, self.mesh.size) if self.mesh else (0, 1)
        lead = self.mesh is None or self.mesh.rank == 0  # the rank that writes the metric stream
        self.logger = MetricLogger(
            c.run_name, out_dir=c.train.checkpoint_dir if log_metrics and lead else None,
            quiet=quiet or not lead)
        # The full run config as the stream's first record.
        self.logger.log({"event": "run_config", "config": dataclasses.asdict(c)})

        # ---- data ----
        self.is_ctr_model = c.model.name.lower() in CTR_MODELS
        self.dataset = self.ctr_arrays = self.stream = None
        self.user_side = self.item_side = None
        if c.data.source in INTERACTION_SOURCES:
            self.dataset = build_dataset(c.data)
            nu, ni = self.dataset.num_users, self.dataset.num_items
            if self.is_ctr_model:
                side_vocabs = self._load_side_features(nu, ni)
                self.data_spec = DataSpec.ctr((nu, ni) + side_vocabs, num_dense=0)
            else:
                self.data_spec = DataSpec.interaction(nu, ni)
        else:
            if not self.is_ctr_model:
                raise ValueError(
                    f"model {c.model.name!r} needs interaction data, got {c.data.source!r}")
            if c.data.source == "criteo" and c.data.streaming:
                # The file streamed in order past its eval slice; on N ranks
                # each streams its round-robin stripe of B / N batches.
                vocabs = _criteo_vocabs(c.data.categorical_vocab_sizes)
                self.stream = CriteoStreamBatcher(
                    c.data.path, c.train.batch_size // self.num_ranks, vocabs,
                    eval_examples=c.data.eval_examples,
                    max_examples=c.data.num_examples or None,
                    num_shards=self.num_ranks, shard_index=self.rank)
                test = self.stream.eval_arrays()
                self.ctr_arrays = {"train": None, "test": test}
                self.data_spec = DataSpec.ctr(vocabs, num_dense=test[0].shape[1])
            else:
                if c.data.source == "criteo":
                    vocabs = _criteo_vocabs(c.data.categorical_vocab_sizes)
                    dense, cat, label = load_criteo(
                        c.data.path, vocabs, max_examples=c.data.num_examples or None)
                else:  # synthetic CTR examples
                    vocabs = tuple(c.data.categorical_vocab_sizes)
                    dense, cat, label = synthetic_ctr(
                        c.data.num_examples,
                        num_dense=c.data.num_dense_features,
                        vocab_sizes=c.data.categorical_vocab_sizes,
                        seed=c.data.seed,
                        field_widths=c.data.categorical_field_widths or None,
                    )
                # The last test_fraction held out.
                n_test = int(len(label) * c.data.test_fraction)
                if n_test == 0 or n_test >= len(label):
                    raise ValueError(
                        f"test_fraction={c.data.test_fraction} with {len(label)} examples yields "
                        "an empty train or test split; adjust num_examples/test_fraction")
                self.ctr_arrays = {
                    "train": (dense[:-n_test], cat[:-n_test], label[:-n_test]),
                    "test": (dense[-n_test:], cat[-n_test:], label[-n_test:]),
                }
                self.data_spec = DataSpec.ctr(
                    vocabs, num_dense=dense.shape[1],
                    field_widths=c.data.categorical_field_widths or None)

        # ---- model + step ----
        model_cfg = c.model
        if model_cfg.lane_pack is None and c.train.resume and c.train.checkpoint_dir:
            # Checkpoints name their tables by layout: a resume under AUTO
            # takes the saved layout rather than deriving it again.
            saved = checkpoint.checkpoint_table_layout(c.train.checkpoint_dir)
            if saved is not None:
                model_cfg = dataclasses.replace(model_cfg, lane_pack=saved)
                self.logger.log({"event": "lane_pack_from_checkpoint", "lane_pack": saved})
        self.model = build_model(model_cfg, self.data_spec)
        loss = c.train.loss
        if self.is_ctr_model and loss in PAIRWISE_LOSSES:
            self.logger.log({"event": "loss_coerced", "from": loss, "to": "logloss",
                             "reason": "CTR models train pointwise"})
            loss = "logloss"
        self.loss_name = loss
        if self.mesh is not None:
            from tfrec_tpu_torch.parallel.step import ShardedTrainStepBuilder

            self.builder = ShardedTrainStepBuilder(
                self.model, loss, c.optim, self.mesh, c.mesh, l2_reg=c.model.l2_reg,
                seed=c.train.seed, device_negatives=self._use_device_negs(loss),
                num_items=getattr(self.dataset, "num_items", 0))
        else:
            self.builder = TrainStepBuilder(
                self.model, loss, c.optim, l2_reg=c.model.l2_reg, seed=c.train.seed,
                device=self.device, device_negatives=self._use_device_negs(loss),
                num_items=getattr(self.dataset, "num_items", 0))
        self.state = self.builder.init_state(
            torch.Generator(device=self.device).manual_seed(c.train.seed))
        self.start_epoch = 0
        if c.train.resume and c.train.checkpoint_dir:
            step = checkpoint.latest_step(c.train.checkpoint_dir)
            if step is not None:
                self.state = self.restore(c.train.checkpoint_dir, step)
                self.start_epoch = step
                self.logger.log({"event": "resumed", "epoch": step})
        if c.train.init_from:
            if self.start_epoch == 0:
                self._warm_start(c.train.init_from)
            else:
                self.logger.log({
                    "event": "warm_start_skipped",
                    "reason": "resume restored this run's checkpoint (resume wins over init_from)",
                })
        self.sampler = self._make_sampler()
        self._sort_pool = None  # the host dedup sorts' threads, made at their first batch
        self.global_step = 0
        self._es_best = None  # early-stopping monitor state
        self._es_stall = 0
        self._retrieval_eval = None  # built at the first eval
        self._eval_overflow = 0  # the eval exchange's dropped ids (a mesh's)

    # ---- checkpoints ----

    def checkpoint_state(self) -> Dict[str, np.ndarray]:
        """The train state as the flat keys the JAX package saves for the
        same model and optimizer (``convert.flat_from_state``); on a mesh,
        this rank's blocks."""
        o = self.config.optim
        return convert.flat_from_state(self.state, o.dense_optimizer, o.weight_decay)

    def _row_keys(self) -> Dict[str, object]:
        """On a mesh, each sharded leaf's flat key -> its table's plan."""
        if self.mesh is None:
            return {}
        out = {}
        for name, plan in self.builder.plans.items():
            if plan is None:
                continue
            out[f"tables/{name}"] = plan
            for leaf, v in self.state["sparse_opt"][name].items():
                if plan.is_block(v):
                    out[f"sparse_opt/{name}/{leaf}"] = plan
        return out

    def _saves_blocks(self) -> bool:
        """Whether a checkpoint is every rank's blocks (a one-axis mesh of
        row-sharded or replicated tables, the reference's multi-process
        layout), not the logical state that rank 0 writes."""
        return (self.mesh is not None and self.mesh.shape["table"] == 1
                and not any(isinstance(p, ColShardedTable) for p in self.builder.plans.values()))

    def _block_spans(self, flat: Dict[str, np.ndarray]) -> Dict[str, dict]:
        """The reference's ``blocks.p<i>.json`` of this rank's ``flat``:
        a row-sharded leaf its rows of the padded global array, any other
        leaf whole."""
        rows = self._row_keys()
        spans = {}
        for key, arr in flat.items():
            plan = rows.get(key)
            if plan is None:
                spans[key] = {"axis": None, "global_shape": list(np.shape(arr))}
                continue
            spans[key] = {"axis": 0, "spans": [[plan.base, plan.base + plan.rows_per_shard]],
                          "global_shape": [plan.vocab_padded] + list(arr.shape[1:])}
        return spans

    def _row_permute_active(self) -> bool:
        return self.mesh is not None and self.config.mesh.row_permute

    def save(self, epoch: int) -> None:
        """Checkpoint ``epoch`` of ``train.checkpoint_dir`` (every rank its
        blocks on a mesh), with the row layout's facts."""
        c = self.config
        meta = {"row_permute": self._row_permute_active()}
        if meta["row_permute"]:
            meta["row_permute_shards"] = self.mesh.size
        if self._saves_blocks():
            flat = self.checkpoint_state()
            checkpoint.save_checkpoint(c.train.checkpoint_dir, epoch, flat, meta=meta,
                                       mesh=self.mesh, spans=self._block_spans(flat))
        elif self.mesh is None:
            checkpoint.save_checkpoint(c.train.checkpoint_dir, epoch, self.checkpoint_state(), meta=meta)
        else:  # the logical state, gathered over both axes; rank 0 writes it
            o = c.optim
            flat = convert.flat_from_state(self.builder.logical_state(self.state), o.dense_optimizer,
                                           o.weight_decay)
            if self.mesh.rank == 0:
                checkpoint.save_checkpoint(c.train.checkpoint_dir, epoch, flat, meta=meta)
            self.mesh.barrier()  # published before any rank goes on

    def restore(self, ckpt_dir: str, step: int | None = None, params_only: bool = False):
        """The checkpoint at ``step`` (default: the latest) of ``ckpt_dir``,
        saved by the port or by the JAX package on any topology and in any
        table layout, on this trainer's device (on a mesh, as this rank's
        blocks): the whole train state, or with ``params_only`` the params
        ``{"tables", "dense"}``, in this model's layout (the optimizer state
        only from a checkpoint of the same layout)."""
        keys = set(checkpoint.read_tree(ckpt_dir, step).get("keys", []))
        template = {k: np.shape(v) for k, v in convert.flat_from_state(
            self.state, self.config.optim.dense_optimizer, self.config.optim.weight_decay,
            leaf=lambda t: np.broadcast_to(np.float32(0), t.shape)).items()}
        permuted = self._row_permute_active()
        rows = self._row_keys()
        for key, plan in rows.items():  # the global shapes: padded where permuted
            template[key] = plan.logical_shape(template[key])
            if permuted:
                template[key] = (plan.vocab_padded,) + template[key][1:]
        if params_only:
            template = {k: v for k, v in template.items() if k.startswith(("tables/", "dense/"))}
        missing = set(template) - keys
        if any(not k.startswith(("tables/", "sparse_opt/")) for k in missing):
            raise ValueError(
                f"checkpoint {ckpt_dir!r} does not hold this run's model and optimizer: it lacks "
                f"{sorted(k for k in missing if not k.startswith(('tables/', 'sparse_opt/')))}")
        if missing:  # another table layout: convert reads it as saved
            template = None
        flat = checkpoint.restore_checkpoint(
            ckpt_dir, template, step, expect_row_permute=permuted,
            expect_row_permute_shards=self.mesh.size if permuted else None)
        if permuted:  # physical rows -> logical
            for key, plan in rows.items():
                if key in flat:
                    flat[key] = flat[key][plan.perm_rows().numpy()][: plan.vocab]
        if params_only:
            params = convert.params_from_flat(flat, self.model, self.state["dense"])
            if self.mesh is not None:
                params["tables"] = {n: (self.builder.plans[n].shard(t)
                                        if self.builder.plans.get(n) is not None else t)
                                    for n, t in params["tables"].items()}
            return copy_state(params, self.device)
        state = convert.train_state_from_flat(flat, self.model, self.state)
        if self.mesh is not None:
            return convert.shard_state(state, self.mesh, self.builder.plans)
        return copy_state(state, self.device)

    def _warm_start(self, ckpt_dir: str) -> None:
        """Copy matching embedding tables from another run's checkpoint
        (``train.init_from``): the reference family's pretraining, NeuMF
        from GMF or MF. The model's ``warm_start_aliases`` first, then the
        same name; rows past the source's keep their fresh init, extra
        source rows are cut (and the copy says so), and shape mismatches
        and absent sources are skipped, each in the ``warm_start`` event.
        Copying nothing raises."""
        if checkpoint.checkpoint_row_permute(ckpt_dir):
            raise ValueError(
                f"init_from checkpoint {ckpt_dir!r} was saved with mesh.row_permute=True; warm "
                "starting from a permuted physical layout is not supported — export/de-permute "
                "it first (e.g. resume it and save with row_permute off)")
        src_tables = checkpoint.load_table_arrays(ckpt_dir)
        aliases = self.model.warm_start_aliases()
        copied, skipped = [], []
        # The logical tables (on a mesh, gathered from every rank).
        tables = dict(self.builder.unpadded_tables(self.state) if self.mesh else self.state["tables"])
        for name, tbl in tables.items():
            s_name = aliases.get(name, name)
            if s_name not in src_tables:
                skipped.append([name, f"no source table {s_name!r}"])
                continue
            arr = src_tables[s_name]
            if arr.ndim != tbl.ndim or tuple(arr.shape[1:]) != tuple(tbl.shape[1:]):
                skipped.append([name, f"shape {list(arr.shape)} vs {list(tbl.shape)}"])
                continue
            rows = min(arr.shape[0], tbl.shape[0])
            new = tbl.clone()
            new[:rows] = torch.from_numpy(np.ascontiguousarray(arr[:rows], np.float32)).to(tbl.device)
            tables[name] = new
            if rows < arr.shape[0]:
                copied.append([name, f"first {rows} of {arr.shape[0]} source rows"])
            else:
                copied.append(name)
        if self.mesh is not None:
            tables = {n: (self.builder.plans[n].shard(t) if self.builder.plans.get(n) is not None
                          else t) for n, t in tables.items()}
        self.state = {**self.state, "tables": tables}
        self.logger.log({"event": "warm_start", "from": ckpt_dir,
                         "copied": sorted(copied, key=str), "skipped": skipped})
        if not copied:
            raise ValueError(
                f"warm start from {ckpt_dir!r} copied no tables (skipped: {skipped}); check "
                "warm_start_aliases / dims")

    # ---- data ----

    def _load_side_features(self, nu: int, ni: int) -> Tuple[int, ...]:
        """The side fields of a CTR model over interaction data: fills
        ``user_side`` [U, Fu] and ``item_side`` [V, Fi] int32 and returns
        their vocabs, or leaves them None and returns (). ML-1M's
        ``users.dat`` gives gender, age bucket and occupation, ``movies.dat``
        the first genre; their raw ids are 1-based and dense, and a user or
        item the file does not name gets code 0 in each field. Without
        files, ``data.synthetic_side_features`` draws the reference's
        fields from ``data.seed + 11`` (vocabs 2, 7, 21 a user, 18 an
        item)."""
        c = self.config
        vocabs: Tuple[int, ...] = ()
        if c.data.user_features_path:
            from tfrec_tpu_torch.data.movielens import load_ml1m_user_features

            feats, fv = load_ml1m_user_features(c.data.user_features_path)
            arr = np.zeros((nu, len(fv)), np.int32)
            for raw, vec in feats.items():
                if raw - 1 < nu:
                    arr[raw - 1] = vec
            self.user_side = arr
            vocabs += fv
        if c.data.item_features_path:
            from tfrec_tpu_torch.data.movielens import load_ml1m_item_genres

            genres, n_genres = load_ml1m_item_genres(c.data.item_features_path)
            arr = np.zeros((ni, 1), np.int32)
            for raw, g in genres.items():
                if raw - 1 < ni:
                    arr[raw - 1, 0] = g
            self.item_side = arr
            vocabs += (n_genres,)
        if c.data.synthetic_side_features and not vocabs:
            rng = np.random.default_rng(c.data.seed + 11)
            side_vocabs_u = (2, 7, 21)  # gender, age bucket, occupation
            self.user_side = np.stack(
                [rng.integers(0, v, nu) for v in side_vocabs_u], axis=1).astype(np.int32)
            self.item_side = rng.integers(0, 18, (ni, 1)).astype(np.int32)
            vocabs = side_vocabs_u + (18,)
        return vocabs

    def _use_device_negs(self, loss: str) -> bool:
        return (self.config.train.device_negatives and self.dataset is not None
                and loss in ("bpr", "hinge"))

    def _make_sampler(self):
        """The batches of the loss: CTRBatcher for CTR data; for interaction
        data PairwiseSampler under the pairwise losses (K negatives a row
        for sampled softmax, none for in-batch losses and device
        negatives), else PointwiseSampler; uniform or popularity^beta
        negatives, with the reference's refusals."""
        c = self.config
        # On N ranks each samples its B / N rows with its own seed.
        bs = c.train.batch_size // self.num_ranks
        seed = c.train.seed * self.num_ranks + self.rank
        if self.ctr_arrays is not None:
            if c.train.neg_sampling != "uniform":
                raise ValueError(
                    f"train.neg_sampling={c.train.neg_sampling!r} applies to the pairwise/pointwise "
                    "interaction samplers, not the CTR data path")
            if self.stream is not None:
                return self.stream
            dense, cat, label = self.ctr_arrays["train"]
            return CTRBatcher(dense, cat, label, bs, seed=seed)
        neg_cdf = None
        if c.train.neg_sampling == "popularity":
            if self._use_device_negs(self.loss_name):
                raise ValueError(
                    "train.neg_sampling='popularity' is a host-sampler proposal; device_negatives "
                    "draws uniformly on device — disable one of the two")
            if self.loss_name in IN_BATCH_LOSSES:
                raise ValueError(
                    "train.neg_sampling='popularity' has no effect under "
                    f"{self.loss_name!r}: in-batch losses take negatives from the batch's other "
                    "positives, not from a sampler")
            neg_cdf = popularity_cdf(self.dataset, c.train.neg_sampling_beta)
        elif c.train.neg_sampling != "uniform":
            raise ValueError(
                f"unknown train.neg_sampling {c.train.neg_sampling!r}; options: uniform, popularity")
        if self.loss_name in PAIRWISE_LOSSES:
            return PairwiseSampler(
                self.dataset, bs, c.train.num_negatives, seed,
                multi_neg=self.loss_name in MULTI_NEG_LOSSES,
                no_negatives=(self.loss_name in IN_BATCH_LOSSES
                              or self._use_device_negs(self.loss_name)),
                neg_cdf=neg_cdf)
        return PointwiseSampler(self.dataset, bs, max(c.train.num_negatives, 1), seed,
                                neg_cdf=neg_cdf)

    @property
    def _host_dedup_on(self) -> bool:
        # Host sorts of a rank's local ids mean nothing after the exchange:
        # off on a mesh, as in the reference.
        return self.config.train.host_dedup and self.is_ctr_model and self.mesh is None

    def _host_batch(self, batch: Dict[str, np.ndarray], train: bool = True) -> Dict[str, np.ndarray]:
        """The model's host batch: for a CTR model over interaction data a
        pointwise batch becomes {"dense": [B, 0], "cat": [user, item, user
        side fields..., item side fields...], "label"}; other batches pass
        as they are. With train.host_dedup a train batch also carries the
        host's dedup sorts (``host_dedup_sorts``); an eval batch would not
        use them."""
        if self.is_ctr_model and self.ctr_arrays is None:
            cols = [batch["user"][:, None], batch["item"][:, None]]
            if self.user_side is not None:
                cols.append(self.user_side[batch["user"]])
            if self.item_side is not None:
                cols.append(self.item_side[batch["item"]])
            batch = {
                "dense": np.zeros((len(batch["user"]), 0), np.float32),
                "cat": np.concatenate(cols, axis=1).astype(np.int32),
                "label": batch["label"],
            }
        if train and self._host_dedup_on:
            if self._sort_pool is None:
                self._sort_pool = ThreadPoolExecutor(min(8, os.cpu_count() or 1),
                                                     thread_name_prefix="hostdedup")
            batch = {**batch, **host_dedup_sorts(self.model, batch, self._sort_pool)}
        return batch

    def _to_device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The host-to-device copy of a model's host batch (or of K stacked
        ones)."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    @property
    def params(self):
        """``{"tables", "dense"}``; on a mesh the logical tables, gathered
        from every rank (a collective: every rank reads it)."""
        if self.mesh is not None:
            return {"tables": self.builder.unpadded_tables(self.state), "dense": self.state["dense"]}
        return {"tables": self.state["tables"], "dense": self.state["dense"]}

    # ---- evaluation ----

    def evaluate(self) -> Dict[str, float]:
        """CTR data: AUC and logloss on the held-out rows. Interaction data:
        the sampled-candidate metrics (``train.eval_protocol="sampled"``,
        for retrieval models) or the full-catalog ones, where the model
        scores the catalog (FM with side fields does not, and reports AUC
        only, as in the reference); and the AUC over sampled negatives when
        the loss is logloss or the model a CTR model."""
        if self.ctr_arrays is not None:
            dense, cat, label = self.ctr_arrays["test"]
            return self._eval_ctr(dense, cat, label)
        c = self.config
        out: Dict[str, float] = {}
        if c.train.eval_protocol == "sampled" and self.data_spec.kind == "interaction":
            if self._retrieval_eval is None:
                self._retrieval_eval = SampledEvaluator(
                    self.model, self.dataset, ks=tuple(c.train.eval_topk),
                    num_candidates=c.train.eval_num_candidates, seed=c.train.seed + 13,
                    user_batch=c.train.eval_user_batch, device=self.device)
            out.update(self._retrieval_eval(self.params))
        elif self.mesh is not None and self.model.dot_decomposition() is not None:
            # The distributed top-k on the live sharded tables.
            if self._retrieval_eval is None:
                self._retrieval_eval = ShardedRetrievalEvaluator(
                    self.builder, self.model, self.dataset, ks=tuple(c.train.eval_topk),
                    user_batch=c.train.eval_user_batch)
            out.update(self._retrieval_eval(self.state))
        else:
            if self._retrieval_eval is None:
                self._retrieval_eval = RetrievalEvaluator(
                    self.model.score_all, self.dataset, ks=tuple(c.train.eval_topk),
                    user_batch=c.train.eval_user_batch, device=self.device)
            if self._retrieval_eval:
                try:
                    out.update(self._retrieval_eval(self.params))
                except NotImplementedError:  # the model does not score the catalog
                    self._retrieval_eval = False
        if self.loss_name == "logloss" or self.is_ctr_model:
            out.update(self._eval_interaction_auc())
        return out

    def _eval_interaction_auc(self, num_neg: int = 50) -> Dict[str, float]:
        """AUC of held-out positives against ``num_neg`` uniform negatives a
        positive, in one forward of ~20 000 rows (the reference's draws from
        seed + 7). On a mesh the rows are padded to a multiple of the data
        axis by repeating the first ones (trimmed before the AUC), each data
        index forwards its contiguous block, and the logits are gathered."""
        rng = np.random.default_rng(self.config.train.seed + 7)
        test = self.dataset.test
        n = min(len(test), max(20_000 // (1 + num_neg), 1))
        users = np.repeat(test.users[:n], 1 + num_neg)
        neg_items = rng.integers(0, self.dataset.num_items, size=(n, num_neg)).astype(np.int32)
        items = np.concatenate([test.items[:n, None], neg_items], axis=1).reshape(-1)
        labels = np.tile(np.concatenate([[1.0], np.zeros(num_neg)]).astype(np.float32), n)
        batch = {"user": users.astype(np.int32), "item": items, "label": labels}
        real = len(labels)
        pad = (-real) % self.num_ranks
        if pad:
            batch = {k: np.concatenate([v, v[:pad]]) for k, v in batch.items()}
        rows = (real + pad) // self.num_ranks
        lo = self.rank * rows
        batch = self._to_device_batch(self._host_batch(
            {k: v[lo:lo + rows] for k, v in batch.items()}, train=False))
        with torch.no_grad():
            logits = self._forward(batch)
            if self.mesh is not None:
                logits = self.mesh.all_gather(logits)
            return {"auc": float(auc_metric(logits[:real], torch.from_numpy(labels).to(self.device)))}

    def _forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The eval forward (the reference's ``_forward_fn``): the builder's
        lookup seam (on a mesh the exchange, its overflow added to
        ``_eval_overflow``), then the model, without dropout; logits [B]."""
        gathered, aux = self.builder.lookup(self.state["tables"], self.model.lookup_ids(batch))
        if "lookup_overflow" in aux:
            self._eval_overflow += aux["lookup_overflow"]
        return self.model.forward(self.state["dense"], gathered, batch)

    def _eval_ctr(self, dense, cat, label) -> Dict[str, float]:
        max_n = self.config.train.eval_ctr_max_rows
        n = min(len(label), max_n) if max_n > 0 else len(label)
        if n < len(label):
            # The cap truncates this holdout: said in the log stream and in
            # the eval record itself.
            self.logger.log({
                "event": "eval_truncated",
                "eval_rows": n,
                "holdout_rows": len(label),
                "knob": "train.eval_ctr_max_rows",
            })
        # On a mesh a batch splits evenly over the ranks: each forwards its
        # contiguous rows through the exchange, and the logits are gathered.
        mult = self.num_ranks
        bs = -(-min(EVAL_BATCH, -(-n // mult) * mult) // mult) * mult
        rows = bs // mult
        lo = self.rank * rows
        logits_out = []
        self._eval_overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        with torch.no_grad():
            for s in range(0, n, bs):
                take = min(bs, n - s)
                if take < bs:  # pad the tail batch to the static shape
                    pad = bs - take
                    d = np.concatenate([dense[s:n], np.zeros((pad,) + dense.shape[1:], dense.dtype)])
                    ca = np.concatenate([cat[s:n], np.zeros((pad,) + cat.shape[1:], cat.dtype)])
                    la = np.zeros(bs, label.dtype)
                else:
                    d, ca, la = dense[s : s + bs], cat[s : s + bs], label[s : s + bs]
                batch = self._to_device_batch({"dense": d[lo:lo + rows], "cat": ca[lo:lo + rows],
                                               "label": la[lo:lo + rows]})
                logits = self._forward(batch)
                if self.mesh is not None:
                    logits = self.mesh.all_gather(logits)
                logits_out.append(logits[:take])
            logits = torch.cat(logits_out)
            labels = torch.from_numpy(label[:n]).to(self.device)
            out = {"auc": float(auc_metric(logits, labels)),
                   "logloss": float(logloss_metric(logits, labels))}
        if n < len(label):
            out["eval_rows"] = float(n)  # truncated: see the eval_truncated event
        overflow = int(self._eval_overflow)
        if overflow:  # the exchange dropped eval ids over capacity: loud, never silent
            out["eval_lookup_overflow"] = float(overflow)
        return out

    # ---- the epoch loop ----

    def _post_epoch(self, epoch: int, rec: Dict[str, float], history) -> bool:
        """Per-epoch bookkeeping: the eval cadence (always on the final
        epoch), logging, checkpoints, early stopping. True when training
        should stop."""
        c = self.config
        is_last = epoch + 1 == c.train.epochs
        evaluated = False
        if c.train.eval_every_epochs and (
            (epoch + 1) % c.train.eval_every_epochs == 0 or is_last
        ):
            rec.update(self.evaluate())
            evaluated = True
        self.logger.log(rec)
        history.append(rec)
        if (c.train.checkpoint_dir and c.train.checkpoint_every_epochs
                and (epoch + 1) % c.train.checkpoint_every_epochs == 0):
            self.save(epoch + 1)
        if not (c.train.early_stop_patience > 0 and evaluated):
            return False
        name, value, sign = self._early_stop_monitor(rec)
        if value is None:
            # A misspelled or never-emitted monitor would silently disable
            # early stopping: refuse instead.
            raise ValueError(
                f"early_stop_metric {name!r} is not in the eval record; "
                f"available: {sorted(k for k, v in rec.items() if isinstance(v, float))}"
            )
        improved = (
            self._es_best is None
            or sign * (value - self._es_best) > c.train.early_stop_min_delta
        )
        if improved:
            self._es_best = value
            self._es_stall = 0
            return False
        self._es_stall += 1
        if self._es_stall >= c.train.early_stop_patience:
            self.logger.log({
                "event": "early_stopped", "epoch": epoch, "metric": name,
                "best": float(self._es_best), "last": float(value),
                "stalled_evals": self._es_stall,
            })
            return True
        return False

    def _log_overflow(self, epoch: int, dropped: int, n_examples: int, batch) -> None:
        """An epoch that dropped ids over the exchange's capacity says so in
        the stream: the count and its rate over the ids the epoch looked up
        in its sharded tables (``batch``: one of its device batches, or K
        stacked)."""
        if not dropped:
            return
        if max(self.config.train.steps_per_dispatch, 1) > 1:
            batch = {k: v[0] for k, v in batch.items()}
        rows = next(iter(batch.values())).shape[0]
        per_example = sum(v.numel() for k, v in self.model.lookup_ids(batch).items()
                          if self.builder.plans.get(k) is not None) / rows
        self.logger.log({"event": "lookup_overflow", "epoch": epoch, "dropped_ids": dropped,
                         "drop_rate": dropped / max(per_example * n_examples, 1)})

    def _early_stop_monitor(self, rec: Dict[str, float]):
        """(name, value, sign) of the monitored metric in this eval record;
        sign +1 maximizes, -1 minimizes. "auto" picks auc where the eval
        emits it, else recall (or hr) at the largest k, else the loss."""
        want = self.config.train.early_stop_metric
        if want != "auto":
            sign = -1.0 if want in ("loss", "logloss") else 1.0
            return want, rec.get(want), sign
        if "auc" in rec:
            return "auc", rec["auc"], 1.0
        for family in ("recall@", "hr@"):
            ks = [int(k.split("@")[1]) for k in rec
                  if k.startswith(family) and k.split("@")[1].isdigit()]
            if ks:
                name = f"{family}{max(ks)}"
                return name, rec[name], 1.0
        return "loss", rec.get("loss"), -1.0

    def train(self) -> List[Dict[str, float]]:
        c = self.config
        history: List[Dict[str, float]] = []
        if self.stream is None and self.sampler.num_batches() == 0:
            raise ValueError(
                "0 train batches per epoch: the (remainder-dropping) sampler has fewer "
                f"than batch_size={c.train.batch_size} rows — shrink train.batch_size or "
                "supply more data (a silent 0-step epoch would report nan loss)"
            )
        steps_cap = c.train.steps_per_epoch
        if steps_cap <= 0 and self.num_ranks > 1:
            # Each rank samples local batches over the whole train set: an
            # epoch is its batches over N, one pass over the data in all.
            total = self.sampler.num_batches()
            if total > 0:
                steps_cap = max(total // self.num_ranks, 1)
        k_steps = max(c.train.steps_per_dispatch, 1)
        step = self.builder.multi_step if k_steps > 1 else self.builder.step
        for epoch in range(self.start_epoch, c.train.epochs):
            t0 = time.monotonic()
            n_examples = 0

            def grouped(stream):
                """Stack K host batches into one [K, B, ...] dispatch."""
                group = []
                for b in stream:
                    group.append(b)
                    if len(group) == k_steps:
                        yield {key: np.stack([g[key] for g in group]) for key in group[0]}
                        group = []

            batches = map(self._host_batch, self.sampler.epoch(epoch))
            batch_stream = prefetch(grouped(batches) if k_steps > 1 else batches,
                                    self._to_device_batch)
            # With K > 1 the cap rounds DOWN to whole dispatches. Where the
            # step budget is smaller than one dispatch, one dispatch still
            # runs (the least unit of progress), and the log says so.
            cap_dispatch = steps_cap // k_steps if steps_cap > 0 else -1
            if steps_cap > 0 and cap_dispatch == 0:
                self.logger.log({
                    "event": "dispatch_exceeds_step_cap",
                    "steps_per_dispatch": k_steps,
                    "step_cap": steps_cap,
                })
                cap_dispatch = 1
            metrics = None
            dropped = 0  # ids over the exchange's capacity, summed on the device
            for i, dev_batch in enumerate(batch_stream):
                if cap_dispatch > 0 and i >= cap_dispatch:
                    break
                self.state, metrics = step(self.state, dev_batch)
                if "lookup_overflow" in metrics:
                    dropped = dropped + metrics["lookup_overflow"]
                prev_step = self.global_step
                self.global_step += k_steps
                n_examples += c.train.batch_size * k_steps
                log_n = c.train.log_every_steps
                # Intra-epoch loss logging every ~log_every_steps optimizer
                # steps (costs one device sync per log line).
                if log_n > 0 and prev_step // log_n != self.global_step // log_n:
                    self.logger.log({
                        "step": self.global_step,
                        "epoch": epoch,
                        "loss": float(metrics["loss"]),
                    })
            batch_stream.close()  # release the prefetch worker
            # Fetch the last loss's value: the device has then run every step.
            last_loss = float(metrics["loss"]) if n_examples > 0 else float("nan")
            dt = time.monotonic() - t0
            if n_examples == 0:
                # Empty epoch (dataset smaller than one dispatch): nothing to
                # log or learn.
                self.logger.log({"epoch": epoch, "event": "empty_epoch"})
                history.append({"epoch": epoch, "loss": float("nan"), "examples_per_s": 0.0})
                continue
            rec: Dict[str, float] = {
                "epoch": epoch,
                "loss": last_loss,
                "examples_per_s": n_examples / max(dt, 1e-9),
            }
            self._log_overflow(epoch, int(dropped), n_examples, dev_batch)
            if self._post_epoch(epoch, rec, history):
                break
        return history


def run(config: Config, quiet: bool = False,
        device: torch.device | str = "cuda") -> Tuple[Trainer, List[Dict[str, float]]]:
    """Build a ``Trainer`` on ``device`` and train it: (trainer, history)."""
    trainer = Trainer(config, quiet=quiet, device=device)
    history = trainer.train()
    return trainer, history
