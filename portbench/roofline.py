"""The yardstick's arithmetic: peaks, and the operations and bytes each
kernel and each whole step needs, counted from shapes and from the batch's
own ids, never from what a kernel happens to do.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the full 700 W power
limit. One rate serves every roofline and every ``mfu``: 495 TFLOP/s, the
dense TF32 tensor-core rate, the highest published rate for products of f32
inputs, so a share stays at or under 100% whatever route computes the
counted f32 work (SIMT f32, 3xTF32 ``mma.sync``, ``wgmma``). Bytes at
3.35 TB/s of HBM3.

The byte counts follow the bound arithmetic the port's bring-up smoke test
used for its kernel table: a table's distinct rows read once (a row read
again comes from L2), every id read once, every output written once.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

PEAK_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4
ID = 4


def bound_s(nbytes: float, flops: float = 0.0) -> Tuple[float, str]:
    """The least time the card could take, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def share_percent(bound: float, measured: float) -> float | None:
    """A roofline share in %, or None where nothing was measured."""
    if measured <= 0:
        return None
    return 100.0 * bound / measured


def gather_bytes(distinct: Sequence[int], ids: Sequence[int], dim: int) -> int:
    """One gather of every table: each table's distinct rows read once, its
    ids read once and one output row an id written once."""
    row = dim * F32
    return sum(k * row + n * (row + ID) for k, n in zip(distinct, ids))


def adagrad_bytes(distinct: Sequence[int], ids: Sequence[int], dim: int) -> int:
    """The fused rowwise-Adagrad update: each distinct row and its
    accumulator read and written once, its combined gradient read once,
    every slot's id read once."""
    row = dim * F32
    return sum(k * (3 * row + 2 * F32) + n * ID for k, n in zip(distinct, ids))


def adagrad_flops(distinct: Sequence[int], dim: int) -> int:
    """g*g, the mean, the scale and the update: 4 operations an element."""
    return sum(4 * k * dim for k in distinct)


def cross_v2_flops(rows: int, d0: int, rank: int, layers: int, train: bool) -> int:
    """The low-rank cross stack's products: 2 a layer forward (x V, then
    (x V) U^T), 4 more backward, each 2 * rows * d0 * rank."""
    fwd = 4 * rows * d0 * rank * layers
    return fwd * 3 if train else fwd


def cross_v2_bytes(rows: int, d0: int, rank: int, layers: int, train: bool) -> int:
    """Forward: x0 read, x_L written, U, V and b read (training also writes
    f [L, rows, d0] and xv [L, rows, r]). Backward: x0, g, f, xv, U, V read;
    dx0, dU, dV and db written."""
    fwd = (2 * rows * d0 + 2 * layers * d0 * rank + layers * d0) * F32
    if not train:
        return fwd
    fwd += layers * (rows * d0 + rows * rank) * F32
    bwd = ((2 + layers) * rows * d0 + layers * rows * rank + 2 * layers * d0 * rank
           + rows * d0 + 2 * layers * d0 * rank + layers * d0) * F32
    return fwd + bwd


def mlp_flops(rows: int, dims: Iterable[int]) -> int:
    """Forward products of an MLP whose layer widths are ``dims`` (input first)."""
    dims = list(dims)
    return sum(2 * rows * a * b for a, b in zip(dims[:-1], dims[1:]))


def model_flops(forward: int, train: bool) -> int:
    """A step's model FLOPs: the forward, and in training the backward at twice it."""
    return 3 * forward if train else forward
