"""What the metric readers (``metrics/<name>.py``) share: each takes the
run's ``runners.common.Context`` and returns a number, or None where the
run has nothing to read (another kind of cell, no trace, no such kernel).
A share of a roofline or of the peak is never reported as 0 for want of a
reading, and never clipped."""

from __future__ import annotations

import statistics
from typing import Optional, Sequence

from portbench import roofline

GATHER_KERNELS = (r"\bgather_rows_kernel\b",)  # kernels/csrc/gather.cu
ADAGRAD_KERNELS = (r"\browwise_adagrad_kernel\b",)  # kernels/csrc/adagrad.cu
CROSS_V2_KERNELS = (  # every kernel of kernels/csrc/cross_v2.cu
    r"\bcross_v2_fwd_kernel\b", r"\bcross_v2_bwd_rows_kernel\b", r"\bcross_v2_bwd_weights_kernel\b",
    r"\bgeneral_rows_kernel\b", r"\bgeneral_weights_kernel\b", r"\bsum_chunks_kernel\b")


def traced(ctx, kind: str) -> bool:
    return ctx.kind == kind and ctx.trace is not None and bool(ctx.trace.device_ops)


def _share(ctx, patterns: Sequence[str], nbytes: float, flops: float) -> Optional[float]:
    secs, launches = ctx.trace.kernel_seconds(patterns)
    if launches == 0:
        return None
    bound, _ = roofline.bound_s(nbytes, flops)
    return roofline.share_percent(bound, secs)


def gather_share(ctx, kind: str) -> Optional[float]:
    if not traced(ctx, kind):
        return None
    t = ctx.trace
    nbytes = sum(roofline.gather_bytes(t.distinct[u], t.ids[u], ctx.cfg["embedding_dim"]) for u in t.units)
    return _share(ctx, GATHER_KERNELS, nbytes, 0.0)


def adagrad_share(ctx, kind: str) -> Optional[float]:
    if not traced(ctx, kind):
        return None
    t, dim = ctx.trace, ctx.cfg["embedding_dim"]
    nbytes = sum(roofline.adagrad_bytes(t.distinct[u], t.ids[u], dim) for u in t.units)
    flops = sum(roofline.adagrad_flops(t.distinct[u], dim) for u in t.units)
    return _share(ctx, ADAGRAD_KERNELS, nbytes, flops)


def cross_v2_share(ctx, kind: str) -> Optional[float]:
    shape = ctx.family.cross_shape(ctx.cfg)
    if shape is None or not traced(ctx, kind):
        return None
    d0, rank, layers = shape
    n, train = len(ctx.trace.units), kind == "train"
    return _share(ctx, CROSS_V2_KERNELS, n * roofline.cross_v2_bytes(ctx.rows_per_unit, d0, rank, layers, train),
                  n * roofline.cross_v2_flops(ctx.rows_per_unit, d0, rank, layers, train))


def mfu(ctx, kind: str) -> Optional[float]:
    """Model FLOPs of the window's steps or calls over its time, against
    the peak."""
    if ctx.kind != kind or ctx.units == 0:
        return None
    flops = roofline.model_flops(ctx.family.forward_flops(ctx.cfg, ctx.rows_per_unit), kind == "train")
    return 100.0 * flops * ctx.units / (ctx.window_s * roofline.PEAK_FLOPS)


def idle_share(ctx, kind: str) -> Optional[float]:
    if not traced(ctx, kind):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def percentile_ms(values, q: int) -> Optional[float]:
    """The q-th percentile (statistics.quantiles, inclusive) in ms."""
    if len(values) < 2:
        return None
    return 1e3 * statistics.quantiles(values, n=100, method="inclusive")[q - 1]
