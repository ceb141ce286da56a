"""Fused rowwise Adagrad over deduplicated ids, in place, for one table or
for many in one launch.

The counterpart of ``tfrec_tpu/kernels/scatter_pallas.py``
``fused_rowwise_adagrad`` (built on ``scaled_scatter_sub``); the kernel is
``csrc/adagrad.cu``, which takes every table of a call in one launch
(``fused_rowwise_adagrad_multi``; ``fused_rowwise_adagrad`` is its
one-table case). For each slot whose id is a real row (``0 <= uid < V``;
the sentinel tail of ``combine_duplicate_ids`` is skipped)::

    acc[u]   += mean(g_u ** 2)
    table[u] -= lr * g_u / (sqrt(acc[u]) + eps)

A lane-packed table (``TableSpec.lane_groups`` G > 1) holds G logical
tables side by side, d = D / G lanes each, and its accumulator is [V, G]:
group j of a row takes the rule above on its own lanes [j*d, (j+1)*d) with
``acc[u, j]``, so each logical table follows its per-table update bit for
bit (a group its batch did not touch has a zero gradient and gains
nothing). As views such a table is a [V*G, d] table with a [V*G]
accumulator, id u its rows u*G + j (``_lane_rows``), so the kernel and the
plain version take it as any other table, in the same launch as the
others. The reference sends such tables to XLA.

Tables and accumulators are updated IN PLACE and returned, as the TPU
kernel aliases its table input to its output; a caller that needs the old
values clones them first. On the card one pass does both parts (the TPU
left the accumulator to XLA). The plain version sums each row's squares in
the kernel's order (``_mean_square``) and rounds every step as the kernel
does, so the two agree bit for bit at any width; the kernel repeats bit for
bit, and a table's result is the same whichever tables share its launch.
Real ids must be distinct within a table, as for the TPU kernel, and no
two tables or accumulators may share memory.
"""

from __future__ import annotations

import ctypes
import numbers
from typing import List, Sequence, Tuple

import torch

from tfrec_tpu_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_void_p]


def _mean_square(g: torch.Tensor) -> torch.Tensor:
    """Each row's mean square, summed in the kernel's order: lane j of a
    warp adds the squares of elements j, j + 32, ... in turn (a lane past
    the row adds nothing, as adding 0 here), then a butterfly of pairwise
    adds across the 32 lanes (lane l takes lane l ^ 16, ^ 8, ^ 4, ^ 2, ^ 1),
    then the division by the width. Each add rounds alone, in f32, and the
    division is a true one (on CUDA a tensor divided by a Python number is
    multiplied by its reciprocal)."""
    n, dim = g.shape
    chunks = max(-(-dim // 32), 1)
    sq = torch.nn.functional.pad(g * g, (0, chunks * 32 - dim)).view(n, chunks, 32)
    s = sq[:, 0]
    for c in range(1, chunks):
        s = s + sq[:, c]
    lane = torch.arange(32, device=g.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ off]
    return s[:, 0] / torch.full_like(s[:, 0], dim)


def _lane_rows(table, acc, uids, grads):
    """A lane-grouped table (acc [V, G]) as the views the one-group rule
    takes: table [V*G, d], acc [V*G], each real uid u the G distinct rows
    u*G + j (ascending as the uids do) and any other slot the sentinel
    V*G, grads [n*G, d]. A table with acc [V] passes as it is."""
    if acc.dim() == 1:
        return table, acc, uids, grads
    vocab, dim = table.shape
    groups = acc.shape[1]
    rows = vocab * groups
    if rows >= 2**31:
        raise ValueError(f"a [{vocab}, {dim}] table of {groups} lane groups has {rows} rows of "
                         "its groups, past int32 ids")
    lane = torch.arange(groups, dtype=uids.dtype, device=uids.device)
    real = ((uids >= 0) & (uids < vocab))[:, None]
    group_ids = torch.where(real, uids[:, None] * groups + lane, rows).reshape(-1)
    return table.view(rows, dim // groups), acc.view(rows), group_ids, grads.view(-1, dim // groups)


def fused_rowwise_adagrad_ref(table: torch.Tensor, acc: torch.Tensor, uids: torch.Tensor,
                              grads: torch.Tensor, lr: float, eps: float = 1e-8):
    """Plain PyTorch version of the kernel, in place as well (a lane-grouped
    table through ``_lane_rows``)."""
    t, a, uids, grads = _lane_rows(table, acc, uids, grads)
    vocab = t.shape[0]
    valid = (uids >= 0) & (uids < vocab)
    rows = uids[valid].long()
    g = grads[valid]
    acc_rows = a[rows] + _mean_square(g)
    a[rows] = acc_rows
    # A true division (``lr / tensor`` would multiply by a reciprocal).
    scale = torch.full_like(acc_rows, lr) / (acc_rows.sqrt() + eps)
    t[rows] = t[rows] - scale[:, None] * g
    return table, acc


def fused_rowwise_adagrad_multi_ref(tables: Sequence[torch.Tensor], accs: Sequence[torch.Tensor],
                                    uids: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                                    lr: float, eps: float = 1e-8):
    """Plain PyTorch version of the multi-table kernel: the one-table plain
    version per table, in place as well -> (tables, accs) as lists."""
    for t, a, u, g in zip(tables, accs, uids, grads):
        fused_rowwise_adagrad_ref(t, a, u, g, lr, eps)
    return list(tables), list(accs)


def _check(table, acc, uids, grads, device: torch.device, what: str) -> None:
    if table.dim() != 2 or table.dtype != torch.float32:
        raise TypeError(f"table must be [V, D] float32, got {table.dtype} {tuple(table.shape)}")
    vocab, dim = table.shape
    if acc.dim() not in (1, 2) or acc.shape[0] != vocab or acc.dtype != torch.float32:
        raise TypeError(f"acc must be [{vocab}] or [{vocab}, G] float32, got {acc.dtype} "
                        f"{tuple(acc.shape)}")
    if acc.dim() == 2 and (acc.shape[1] < 1 or dim % acc.shape[1]):
        raise ValueError(f"acc {tuple(acc.shape)}: the groups must divide the table's width {dim}")
    if uids.dim() != 1 or uids.dtype != torch.int32:
        raise TypeError(f"uids must be [N] int32, got {uids.dtype} {tuple(uids.shape)}")
    if grads.shape != (uids.shape[0], dim) or grads.dtype != torch.float32:
        raise TypeError(f"grads must be [{uids.shape[0]}, {dim}] float32, "
                        f"got {grads.dtype} {tuple(grads.shape)}")
    for name, t in (("table", table), ("acc", acc), ("uids", uids), ("grads", grads)):
        if t.device != device:
            raise ValueError(f"{what} takes tensors on one device: {device}, but a {name} on {t.device}")
    if not all(t.is_contiguous() for t in (table, acc, uids, grads)):
        raise ValueError(f"{what} needs contiguous tables, accs, uids and grads")
    if device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{what} runs on cuda or cpu tensors, not {device}")


def _check_disjoint(tensors, what: str) -> None:
    """No two of the tensors updated in place share memory: two launches'
    worth of writes to one row would race on the card."""
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for t in tensors if t.numel())
    for (_, end), (start, _) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError(f"{what}: two tables or accumulators share memory "
                             "(a table appears twice, or overlaps another)")


def _check_numbers(lr, eps) -> None:
    if not isinstance(lr, numbers.Real) or not isinstance(eps, numbers.Real):
        raise TypeError("lr and eps must be numbers (the kernel takes them by value)")


def _launch(tables, accs, uids, grads, lr, eps, what: str) -> int:
    """One kernel launch (one a 64 tables) over the tables with slots to
    update, lane-grouped ones as ``_lane_rows`` views; returns the number
    of launches made."""
    desc, keep = [], []
    for t, a, u, g in zip(tables, accs, uids, grads):
        if u.shape[0] and t.shape[1]:
            t, a, u, g = _lane_rows(t, a, u, g)
            keep.append(u)  # a grouped table's row ids live until the launch
            desc += (t.data_ptr(), a.data_ptr(), u.data_ptr(), g.data_ptr(),
                     u.shape[0], t.shape[0], t.shape[1])
    if not desc:
        return 0
    fn = _build.function("adagrad", "tfrec_rowwise_adagrad_multi", _ARGTYPES)
    launched = ctypes.c_int(0)
    with torch.cuda.device(tables[0].device):
        rc = fn((ctypes.c_longlong * len(desc))(*desc), len(desc) // 7, float(lr), float(eps),
                torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    _build.check_launch(rc, what)
    return launched.value


def fused_rowwise_adagrad(table: torch.Tensor, acc: torch.Tensor, uids: torch.Tensor,
                          grads: torch.Tensor, lr: float, eps: float = 1e-8):
    """table [V, D] f32, acc [V] f32 (or [V, G] for G lane groups of D / G
    lanes), uids [N] int32 (distinct real ids, a sentinel >= V for unused
    slots), grads [N, D] f32 (combined), lr and eps numbers -> (table, acc),
    the same tensors, updated in place.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    """
    _check(table, acc, uids, grads, table.device, "fused_rowwise_adagrad")
    _check_numbers(lr, eps)
    _check_disjoint((table, acc), "fused_rowwise_adagrad")
    if table.device.type == "cpu":
        return fused_rowwise_adagrad_ref(table, acc, uids, grads, lr, eps)
    fused_rowwise_adagrad.launches += _launch(
        [table], [acc], [uids], [grads], lr, eps, "fused_rowwise_adagrad")
    return table, acc


def fused_rowwise_adagrad_multi(tables: Sequence[torch.Tensor], accs: Sequence[torch.Tensor],
                                uids: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                                lr: float, eps: float = 1e-8) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``fused_rowwise_adagrad`` for many tables at once, with one lr and
    eps: table by table, table [V_f, D_f] f32, acc [V_f] or [V_f, G_f] f32
    (G_f may differ between tables), uids [N_f] int32, grads [N_f, D_f]
    f32, all on one device -> (tables, accs) as lists of the same tensors,
    updated in place. No two tables or accumulators may share memory.

    CUDA tensors launch the kernel once for every 64 tables; CPU tensors
    take the plain version.
    """
    tables, accs, uids, grads = list(tables), list(accs), list(uids), list(grads)
    if not len(tables) == len(accs) == len(uids) == len(grads):
        raise ValueError(f"fused_rowwise_adagrad_multi: {len(tables)} tables, {len(accs)} accs, "
                         f"{len(uids)} uids and {len(grads)} grads")
    if not tables:
        return [], []
    device = tables[0].device
    for t, a, u, g in zip(tables, accs, uids, grads):
        _check(t, a, u, g, device, "fused_rowwise_adagrad_multi")
    _check_numbers(lr, eps)
    _check_disjoint(tables + accs, "fused_rowwise_adagrad_multi")
    if device.type == "cpu":
        return fused_rowwise_adagrad_multi_ref(tables, accs, uids, grads, lr, eps)
    fused_rowwise_adagrad_multi.launches += _launch(
        tables, accs, uids, grads, lr, eps, "fused_rowwise_adagrad_multi")
    return tables, accs


fused_rowwise_adagrad.launches = 0  # kernel launches since the last reset
fused_rowwise_adagrad_multi.launches = 0
