"""Config-driven training driver: the counterpart of
``tfrec_tpu/train/trainer.py`` for CTR data and models on one device.

One ``Trainer`` wires the data (``synthetic_ctr``, split into train and
held-out rows), the model (``models.build_model``), the step
(``step.TrainStepBuilder``: on a card the gather, cross-stack and
rowwise-Adagrad kernels), shuffled fixed-shape batches (``CTRBatcher``)
copied to the device ahead of the step (``prefetch``), the epoch loop with
K steps a dispatch (``multi_step``), AUC and logloss on the held-out rows
(the gather and cross-forward kernels), early stopping and the JSONL metric
stream (``MetricLogger``), with the reference's records. ``run(config)``
builds one and trains it.

The device is the card unless the caller passes ``device="cpu"`` (the
kernels' plain versions); without CUDA the default raises. What the port
does not take yet it refuses by naming the ROADMAP item, never passing it
over: data other than ``synthetic_ctr`` (Criteo's files are not in the
repository; interaction data, items 8-9), models other than dcn and dcnv2
(items 8, 9 and 12), checkpoints, resume and warm starts (item 10), step
profiles (item 10), a mesh (item 11), ``train.matmul_precision`` other than
"default" and host-computed dedup sorts (item 5).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from tfrec_tpu_torch.configs import Config
from tfrec_tpu_torch.data.samplers import CTRBatcher
from tfrec_tpu_torch.data.synthetic import synthetic_ctr
from tfrec_tpu_torch.eval.metrics import auc as auc_metric
from tfrec_tpu_torch.eval.metrics import logloss as logloss_metric
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.train.step import TrainStepBuilder
from tfrec_tpu_torch.utils.logging import MetricLogger
from tfrec_tpu_torch.utils.prefetch import prefetch

# The reference's pairwise losses (tfrec_tpu/train/losses.py), which CTR models
# replace with logloss.
PAIRWISE_LOSSES = ("bpr", "hinge", "sampled_softmax", "in_batch_softmax", "apr", "irgan")
INTERACTION_SOURCES = ("movielens", "synthetic_implicit")
CTR_SOURCES = ("criteo", "synthetic_ctr")
EVAL_BATCH = 8192  # rows of a held-out forward, at most


def _refuse_unported(c: Config) -> None:
    """Raise on every setting the port does not take yet, naming the
    ROADMAP Queue 1 item that ports it."""
    if c.data.source not in INTERACTION_SOURCES + CTR_SOURCES:
        raise ValueError(f"unknown data source {c.data.source!r}")
    if c.data.source == "criteo":
        raise NotImplementedError(
            "data.source='criteo' reads Criteo's files, which are not in the repository; "
            "the port trains on data.source='synthetic_ctr' until they are and its loader "
            "is ported (ROADMAP Queue 1 item 10)")
    if c.data.source in INTERACTION_SOURCES:
        raise NotImplementedError(
            f"data.source={c.data.source!r} (interaction data, its samplers and retrieval "
            "eval) is not ported yet: ROADMAP Queue 1 items 8-9")
    name = c.model.name.lower()
    if name not in ("dcn", "dcnv2"):
        item = {"mf": "item 8", "fm": "item 9", "gmf": "item 9", "mlp": "item 9",
                "neumf": "item 9"}.get(name, "item 12")
        raise NotImplementedError(
            f"model {c.model.name!r} is not ported yet: ROADMAP Queue 1 {item}; the port "
            "trains dcn and dcnv2")
    t = c.train
    if t.checkpoint_dir and t.checkpoint_every_epochs > 0:
        raise NotImplementedError(
            "train.checkpoint_every_epochs (checkpoints) is not ported yet: ROADMAP Queue 1 "
            "item 10; train.checkpoint_dir alone holds the metric stream")
    if t.resume and t.checkpoint_dir:
        raise NotImplementedError("train.resume is not ported yet: ROADMAP Queue 1 item 10")
    if t.init_from:
        raise NotImplementedError(
            "train.init_from (warm start from a checkpoint) is not ported yet: ROADMAP Queue 1 item 10")
    if t.profile_steps is not None:
        raise NotImplementedError(
            "train.profile_steps (utils/profile.py) is not ported yet: ROADMAP Queue 1 item 10")
    if t.matmul_precision != "default":
        raise NotImplementedError(
            f"train.matmul_precision={t.matmul_precision!r} is not ported yet: ROADMAP Queue 1 "
            "item 5; the port runs f32 matmuls with TF32 off")
    if t.host_dedup:
        raise NotImplementedError(
            "train.host_dedup (host-computed dedup sorts) is not ported yet: ROADMAP Queue 1 item 5")
    if c.mesh.data_axis_size > 1 or c.mesh.table_axis_size > 1:
        raise NotImplementedError(
            f"a mesh (mesh.data_axis_size={c.mesh.data_axis_size}, "
            f"table_axis_size={c.mesh.table_axis_size}) is not ported yet: ROADMAP Queue 1 "
            "item 11; the port trains on one device")
    if c.mesh.row_permute:
        raise ValueError(
            "mesh.row_permute requires the sharded (mesh) path; the port trains on one "
            "device: drop the flag")
    if t.neg_sampling != "uniform":
        raise ValueError(
            f"train.neg_sampling={t.neg_sampling!r} applies to the pairwise/pointwise "
            "interaction samplers, not the CTR data path")


class Trainer:
    def __init__(self, config: Config, quiet: bool = False, device: torch.device | str = "cuda"):
        """``device``: the card by default; without CUDA this raises rather
        than train on the CPU, so pass ``device="cpu"`` for that."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer trains on device='cuda' by default, but CUDA is not available; "
                "pass device='cpu' to train on the CPU")
        _refuse_unported(config)
        self.config = c = config
        self.logger = MetricLogger(c.run_name, out_dir=c.train.checkpoint_dir, quiet=quiet)
        # The full run config as the stream's first record.
        self.logger.log({"event": "run_config", "config": dataclasses.asdict(c)})

        # ---- data: synthetic CTR examples, the last test_fraction held out ----
        dense, cat, label = synthetic_ctr(
            c.data.num_examples,
            num_dense=c.data.num_dense_features,
            vocab_sizes=c.data.categorical_vocab_sizes,
            seed=c.data.seed,
            field_widths=c.data.categorical_field_widths or None,
        )
        n_test = int(len(label) * c.data.test_fraction)
        if n_test == 0 or n_test >= len(label):
            raise ValueError(
                f"test_fraction={c.data.test_fraction} with {len(label)} examples yields an "
                "empty train or test split; adjust num_examples/test_fraction")
        self.ctr_arrays = {
            "train": (dense[:-n_test], cat[:-n_test], label[:-n_test]),
            "test": (dense[-n_test:], cat[-n_test:], label[-n_test:]),
        }
        self.data_spec = DataSpec.ctr(
            tuple(c.data.categorical_vocab_sizes), num_dense=dense.shape[1],
            field_widths=c.data.categorical_field_widths or None)

        # ---- model + step ----
        self.model = build_model(c.model, self.data_spec)
        loss = c.train.loss
        if loss in PAIRWISE_LOSSES:
            self.logger.log({"event": "loss_coerced", "from": loss, "to": "logloss",
                             "reason": "CTR models train pointwise"})
            loss = "logloss"
        self.loss_name = loss
        self.builder = TrainStepBuilder(self.model, loss, c.optim, l2_reg=c.model.l2_reg,
                                        seed=c.train.seed, device=self.device)
        self.state = self.builder.init_state(
            torch.Generator(device=self.device).manual_seed(c.train.seed))
        self.start_epoch = 0
        dense, cat, label = self.ctr_arrays["train"]
        self.sampler = CTRBatcher(dense, cat, label, c.train.batch_size, seed=c.train.seed)
        self.global_step = 0
        self._es_best = None  # early-stopping monitor state
        self._es_stall = 0

    def _to_device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The host-to-device copy of a batch (or of K stacked batches). CTR
        batches go to the model as the sampler makes them (the reference's
        ``_host_batch`` adapts only interaction batches)."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    @property
    def params(self):
        return {"tables": self.state["tables"], "dense": self.state["dense"]}

    # ---- evaluation ----

    def evaluate(self) -> Dict[str, float]:
        """AUC and logloss on the held-out rows."""
        dense, cat, label = self.ctr_arrays["test"]
        return self._eval_ctr(dense, cat, label)

    def _forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The eval forward (the reference's ``_forward_fn``): the builder's
        lookup seam, then the model, without dropout; logits [B]."""
        gathered, _ = self.builder.lookup(self.state["tables"], self.model.lookup_ids(batch))
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
        bs = min(EVAL_BATCH, n)
        logits_out = []
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
                batch = self._to_device_batch({"dense": d, "cat": ca, "label": la})
                logits_out.append(self._forward(batch)[:take])
            logits = torch.cat(logits_out)
            labels = torch.from_numpy(label[:n]).to(self.device)
            out = {"auc": float(auc_metric(logits, labels)),
                   "logloss": float(logloss_metric(logits, labels))}
        if n < len(label):
            out["eval_rows"] = float(n)  # truncated: see the eval_truncated event
        return out

    # ---- the epoch loop ----

    def _post_epoch(self, epoch: int, rec: Dict[str, float], history) -> bool:
        """Per-epoch bookkeeping: the eval cadence (always on the final
        epoch), logging, early stopping. True when training should stop."""
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

    def _early_stop_monitor(self, rec: Dict[str, float]):
        """(name, value, sign) of the monitored metric in this eval record;
        sign +1 maximizes, -1 minimizes. "auto" picks auc, which the CTR
        eval emits, else the loss (the reference's retrieval metrics come
        with the retrieval eval, ROADMAP Queue 1 item 8)."""
        want = self.config.train.early_stop_metric
        if want != "auto":
            sign = -1.0 if want in ("loss", "logloss") else 1.0
            return want, rec.get(want), sign
        if "auc" in rec:
            return "auc", rec["auc"], 1.0
        return "loss", rec.get("loss"), -1.0

    def train(self) -> List[Dict[str, float]]:
        c = self.config
        history: List[Dict[str, float]] = []
        if self.sampler.num_batches() == 0:
            raise ValueError(
                "0 train batches per epoch: the (remainder-dropping) sampler has fewer "
                f"than batch_size={c.train.batch_size} rows — shrink train.batch_size or "
                "supply more data (a silent 0-step epoch would report nan loss)"
            )
        steps_cap = c.train.steps_per_epoch
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

            batches = self.sampler.epoch(epoch)
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
            for i, dev_batch in enumerate(batch_stream):
                if cap_dispatch > 0 and i >= cap_dispatch:
                    break
                self.state, metrics = step(self.state, dev_batch)
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
            if self._post_epoch(epoch, rec, history):
                break
        return history


def run(config: Config, quiet: bool = False,
        device: torch.device | str = "cuda") -> Tuple[Trainer, List[Dict[str, float]]]:
    trainer = Trainer(config, quiet=quiet, device=device)
    history = trainer.train()
    return trainer, history
