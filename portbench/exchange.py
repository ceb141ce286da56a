"""Readers of the sharded training cells' per-layer metrics (``metrics/<name>.py``
calls them), and what they need of the traced window: the exchange's spans,
the NCCL kernels' time, and the time in which a NCCL kernel runs and no
other device op does. Every reading is rank 0's: its trace, its span table,
and the bytes its ``all_to_all`` calls sent (``Mesh.counters``). Each returns
None where the run has nothing to read (another kind of cell, no trace, no
span or counter of that name: a program without them).

Peak: NVLink 4, 18 links of 25 GB/s a direction, 450 GB/s out of an H100
SXM card (NVIDIA H100 data sheet).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from portbench import readers, trace

NVLINK_BYTES_PER_S = 450e9
NCCL_KERNELS = (r"^nccl",)  # every NCCL kernel: ncclDevKernel_*, ncclKernel_*
A2A_KERNELS = (r"^nccl\w*SendRecv",)  # all_to_all_single runs as grouped send/recv
EXCHANGE_SPANS = ("tfrec.exchange.lookup", "tfrec.exchange.update")
BAG_POOL_SPAN = "tfrec.bag_pool"


def exposed_comm_s(prof) -> float:
    """Seconds of the window (``trace.WINDOW_RANGE``) in which a NCCL kernel
    runs and no other device op (kernel, copy or set) does."""
    events = trace._raw_events(prof)
    windows = [e for e in events if not e[1] and e[0] == trace.WINDOW_RANGE]
    if len(windows) != 1:
        return 0.0
    w0, w1 = windows[0][2], windows[0][3]
    comm, other = [], []
    for name, dev, s, e, _ in events:
        if dev and e > w0 and s < w1 and e > s:
            (comm if name.startswith("nccl") else other).append((max(s, w0), min(e, w1)))
    comm, other = trace._union(comm), trace._union(other)
    exposed, j = 0, 0
    for a, b in comm:
        covered = 0
        while j < len(other) and other[j][1] <= a:
            j += 1
        k = j
        while k < len(other) and other[k][0] < b:
            covered += min(b, other[k][1]) - max(a, other[k][0])
            k += 1
        exposed += (b - a) - covered
    return exposed * 1e-9


def _traced(ctx) -> bool:
    return (ctx.kind == "train" and ctx.trace is not None and bool(ctx.trace.device_ops)
            and bool(ctx.trace.units))


def _span_ms(ctx, names) -> Optional[float]:
    table = getattr(ctx.trace, "spans", None) if _traced(ctx) else None
    if table is None or not any(n in table.rows for n in names):
        return None
    return sum(table.per_unit(n, "self_ns", 1e-6) or 0.0 for n in names)


def exchange_device_ms(ctx) -> Optional[float]:
    """Self device ms a step of the ``tfrec.exchange.*`` spans."""
    return _span_ms(ctx, EXCHANGE_SPANS)


def bag_pool_device_ms(ctx) -> Optional[float]:
    """Self device ms a step of ``tfrec.bag_pool`` (the forward's pooling;
    its backward runs under autograd's ``tfrec.backward``)."""
    return _span_ms(ctx, (BAG_POOL_SPAN,))


def comm_exposed_share(ctx) -> Optional[float]:
    """% of the traced window in which a NCCL kernel runs alone."""
    exposed = getattr(ctx.trace, "exposed_comm_s", None) if _traced(ctx) else None
    if exposed is None or ctx.trace.kernel_seconds(NCCL_KERNELS)[1] == 0:
        return None
    return 100.0 * exposed / ctx.trace.window_s


def a2a_share(ctx) -> Optional[float]:
    """The bytes rank 0's ``all_to_all`` calls of the traced window sent off
    the card (of each [N, ...] buffer, the N - 1 rows not its own), at
    NVLink 4's 450 GB/s a direction, over the time of its all-to-all
    kernels, in %."""
    sent = getattr(ctx.trace, "a2a_bytes", None) if _traced(ctx) else None
    world = getattr(ctx, "world", 1)
    if not sent or world < 2:
        return None
    out = sum(sent.values()) * (world - 1) / world
    secs, launches = ctx.trace.kernel_seconds(A2A_KERNELS)
    if launches == 0 or secs <= 0:
        return None
    return 100.0 * (out / NVLINK_BYTES_PER_S) / secs


def per_card(ctx):
    """``ctx`` as one card of the mesh saw it: each step's rows the global
    batch over the cards, so that a one-card reader (``readers.py``) of rank
    0's trace or clock counts one card's work. None off a mesh."""
    world = getattr(ctx, "world", 1)
    if world < 2:
        return None
    return dataclasses.replace(ctx, rows_per_unit=ctx.rows_per_unit // world)


def cross_v2_share_per_card(ctx) -> Optional[float]:
    """``readers.cross_v2_share`` of rank 0's traced steps at one card's rows."""
    card = per_card(ctx)
    return None if card is None else readers.cross_v2_share(card, "train")


def mfu_per_card(ctx) -> Optional[float]:
    """``readers.mfu`` of one card: its rows' model FLOPs a step over rank 0's
    window, against one card's peak."""
    card = per_card(ctx)
    return None if card is None else readers.mfu(card, "train")
