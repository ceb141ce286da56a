"""Training objectives: the counterpart of ``tfrec_tpu/train/losses.py``.

Pairwise losses take the model's pairwise output: s_pos - s_neg [B], or a
[B, 1+K] score matrix whose column 0 is the positive; pointwise losses take
logits [B] and the batch's labels. Each is a mean over the batch, in the
reference's numerically stable form (softplus as ``logaddexp(x, 0)``).
Every objective of the reference is ported: ``bpr``, ``hinge``,
``sampled_softmax``, ``in_batch_softmax``, ``logloss``, ``mse``, the
sequential models' ``sasrec``, the autoencoders' ``multvae`` and ``cdae``,
and the model-specific ``apr``, ``sbpr`` and ``irgan``, whose inputs are
their models' dict outputs.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

# Losses whose batches carry (user, pos) rows and negatives; the trainer's
# samplers key on these, as the reference's do.
PAIRWISE_LOSSES = ("bpr", "hinge", "sampled_softmax", "in_batch_softmax", "apr", "irgan")
MULTI_NEG_LOSSES = ("sampled_softmax", "irgan")
IN_BATCH_LOSSES = ("in_batch_softmax",)


def _as_pair_diff(x: torch.Tensor) -> torch.Tensor:
    """1-D inputs are already s_pos - s_neg; a [B, 1+K] score matrix becomes
    the per-negative differences [B, K]."""
    if x.dim() == 2:
        return x[:, :1] - x[:, 1:]
    return x


def bpr(pair_logits: torch.Tensor, batch: Dict) -> torch.Tensor:
    """BPR: -mean log sigmoid(s_pos - s_neg) = mean log(1 + exp(-diff))."""
    diff = _as_pair_diff(pair_logits)
    return torch.mean(torch.logaddexp(torch.zeros_like(diff), -diff))


def hinge(pair_logits: torch.Tensor, batch: Dict) -> torch.Tensor:
    """Pairwise hinge with unit margin."""
    return torch.mean(torch.clamp_min(1.0 - _as_pair_diff(pair_logits), 0.0))


def sampled_softmax(scores: torch.Tensor, batch: Dict) -> torch.Tensor:
    """Softmax over [B, 1+K] score matrices, column 0 the positive:
    -mean log softmax(scores)[:, 0]."""
    if scores.dim() != 2:
        raise ValueError("sampled_softmax needs multi-negative batches ([B, 1+K] scores)")
    return -torch.mean(torch.log_softmax(scores, dim=-1)[:, 0])


def in_batch_softmax(scores: torch.Tensor, batch: Dict) -> torch.Tensor:
    """Softmax over the [B, B] matrix of every user against every row's
    positive; the diagonal is each user's own positive. A positive that
    another row shares stays a valid target (the duplicate column shares
    the probability)."""
    if scores.dim() != 2 or scores.shape[0] != scores.shape[1]:
        raise ValueError("in_batch_softmax needs the [B, B] user x batch-items score matrix")
    return -torch.mean(torch.diagonal(torch.log_softmax(scores, dim=-1)))


def logloss(logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Binary cross-entropy from logits (mean over the batch), in the
    reference's stable form max(x, 0) - x*y + log1p(exp(-|x|))."""
    labels = batch["label"]
    return torch.mean(
        torch.clamp_min(logits, 0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    )


def mse(logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Squared error against (possibly real-valued) labels."""
    return torch.mean((logits - batch["label"]) ** 2)


def sasrec(out: Dict[str, torch.Tensor], batch: Dict) -> torch.Tensor:
    """The sequential models' per-position next-item BCE: the positive
    target against one sampled negative at every valid position. ``out``
    is their training forward's {"pos", "neg", "mask"} [B, L-1]; the mean
    runs over the valid positions."""
    mask = out["mask"].to(out["pos"].dtype)
    pos, neg = out["pos"], out["neg"]
    # softplus as the reference's logaddexp(x, 0), with no linear cut-off.
    per_pos = torch.logaddexp(-pos, torch.zeros_like(pos)) + torch.logaddexp(neg, torch.zeros_like(neg))
    return (per_pos * mask).sum() / mask.sum().clamp_min(1.0)


def multvae(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mult-VAE's ELBO: the multinomial NLL of each user's history under
    the softmax of the reconstruction, plus the KL term the model scaled by
    its beta. ``out`` is {"logits" [B, V], "kl" [B]}; the target is the
    sentinel-padded batch["hist"] [B, H] (a repeated id counts each time,
    as in the reference)."""
    logits, kl = out["logits"], out["kl"]
    logp = torch.log_softmax(logits, dim=-1)
    hist = batch["hist"]
    v = logits.shape[-1]
    picked = torch.gather(logp, 1, hist.clamp_max(v - 1).long())
    nll = -torch.where(hist < v, picked, 0.0).sum(dim=1)
    return torch.mean(nll + kl)


def cdae(logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """CDAE's reconstruction: the binary cross-entropy of the full-catalog
    logits [B, V] against each user's multi-hot history, softplus(x) - t*x
    summed over the items and averaged over the batch. The target is set
    with an idempotent scatter (``amax``), so a repeated history id counts
    once, as the reference's ``.at[].max`` does; pads set nothing."""
    v = logits.shape[-1]
    hist = batch["hist"]
    target = torch.zeros_like(logits).scatter_reduce_(
        1, hist.clamp_max(v - 1).long(), (hist < v).to(logits.dtype), reduce="amax")
    per_elem = torch.logaddexp(logits, torch.zeros_like(logits)) - target * logits
    return torch.mean(per_elem.sum(dim=-1))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def apr(out: Dict[str, torch.Tensor], batch: Dict) -> torch.Tensor:
    """Adversarial personalized ranking: the clean BPR term plus
    ``adv_weight`` times the BPR term of the perturbed rows. ``out`` is
    APR's training forward, {"diff" [B], "diff_adv" [B], "adv_weight"}."""
    return torch.mean(_softplus(-out["diff"]) + out["adv_weight"] * _softplus(-out["diff_adv"]))


def sbpr(out: Dict[str, torch.Tensor], batch: Dict) -> torch.Tensor:
    """Social BPR: x_pos >= x_soc >= x_neg as two BPR terms, the pos-soc gap
    divided by 1 + suk; rows without social candidates (has == 0) train
    plain BPR. ``out`` is SBPR's forward, {"pos", "soc", "neg", "suk",
    "has"}, all [B]."""
    has = out["has"].to(out["pos"].dtype)
    d_ps = (out["pos"] - out["soc"]) / (1.0 + out["suk"])
    d_sn = out["soc"] - out["neg"]
    social = _softplus(-d_ps) + _softplus(-d_sn)
    plain = _softplus(-(out["pos"] - out["neg"]))
    return torch.mean(has * social + (1.0 - has) * plain)


def irgan(out: Dict[str, torch.Tensor], batch: Dict, batch_mean: Callable = torch.mean) -> torch.Tensor:
    """IRGAN's minimax step: the discriminator's BCE (the true positive up,
    the generator's pick down) plus the generator's REINFORCE term with the
    batch mean of the reward as its baseline. ``out`` is IRGAN's training
    forward, {"d_pos", "d_sel", "logp", "reward"} [B], the reward already
    detached; the two players' gradients never meet. ``batch_mean`` takes
    the baseline (a sharded step's is the global batch's mean)."""
    d_loss = _softplus(-out["d_pos"]) + _softplus(out["d_sel"])
    advantage = out["reward"] - batch_mean(out["reward"])
    return torch.mean(d_loss) + torch.mean(-(advantage * out["logp"]))


_LOSSES: Dict[str, Callable] = {
    "bpr": bpr,
    "hinge": hinge,
    "logloss": logloss,
    "mse": mse,
    "sampled_softmax": sampled_softmax,
    "in_batch_softmax": in_batch_softmax,
    "sasrec": sasrec,
    "multvae": multvae,
    "cdae": cdae,
    "sbpr": sbpr,
    "apr": apr,
    "irgan": irgan,
}


# Losses whose value enters their own gradient through a mean over the
# batch (IRGAN's REINFORCE baseline): a sharded step must take it over the
# global batch, where every other mean may stay local.
_BATCH_MEAN_LOSSES = ("irgan",)


def make_loss(name: str, batch_mean: Callable | None = None) -> Callable[[torch.Tensor, Dict], torch.Tensor]:
    """The loss ``name`` as ``fn(out, batch)``. ``batch_mean``: the mean
    over the whole batch of a detached per-row tensor, for the losses that
    take one (a sharded step passes the global batch's; default the local
    ``torch.mean``)."""
    if name not in _LOSSES:
        raise ValueError(f"unknown loss {name!r}; options: {sorted(_LOSSES)}")
    if batch_mean is not None and name in _BATCH_MEAN_LOSSES:
        return functools.partial(_LOSSES[name], batch_mean=batch_mean)
    return _LOSSES[name]
