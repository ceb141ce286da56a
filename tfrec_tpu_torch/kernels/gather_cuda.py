"""Row gather with clip semantics: ``table[clamp(ids, 0, V-1)]``, for one
table or for many in one launch.

The counterpart of ``tfrec_tpu/kernels/gather_pallas.py`` ``gather_pallas``;
the kernel is ``csrc/gather.cu``, which takes every table of a call in one
launch (``gather_rows_multi``; ``gather_rows`` is its one-table case). Ids
are int32, as in the JAX package (half the bytes of int64); other id types
are refused. Negative ids clamp to row 0 and sentinel ids (>= V) to row
V-1, where plain ``index_select`` would raise. The result is an exact copy
of the rows.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from tfrec_tpu_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
# Each field's rows start on a 128-byte boundary of the shared output, so
# the kernel's 16-byte vectors stay aligned whatever the widths before it.
_ALIGN = 32


def gather_rows_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return table.index_select(0, ids.clamp(0, table.shape[0] - 1))


def _outputs(shapes, device) -> List[torch.Tensor]:
    """One allocation holding an [n, d] f32 output per shape, each a
    contiguous view starting on a 128-byte boundary."""
    offsets, total = [], 0
    for n, d in shapes:
        offsets.append(total)
        total += -(-n * d // _ALIGN) * _ALIGN
    buf = torch.empty(total, dtype=torch.float32, device=device)
    return [buf.narrow(0, off, n * d).view(n, d) for off, (n, d) in zip(offsets, shapes)]


def gather_rows_multi_ref(tables: Sequence[torch.Tensor], ids: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Plain PyTorch version of the multi-table kernel: ``gather_rows_ref``
    per field, into the same layout as the kernel's (one allocation)."""
    device = tables[0].device if len(tables) else "cpu"
    outs = _outputs([(i.shape[0], t.shape[1]) for t, i in zip(tables, ids)], device)
    for t, i, o in zip(tables, ids, outs):
        torch.index_select(t, 0, i.clamp(0, t.shape[0] - 1), out=o)
    return outs


def _check(table: torch.Tensor, ids: torch.Tensor, device: torch.device, what: str) -> None:
    if table.dim() != 2 or table.dtype != torch.float32:
        raise TypeError(f"table must be [V, D] float32, got {table.dtype} {tuple(table.shape)}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise TypeError(f"ids must be [N] int32, got {ids.dtype} {tuple(ids.shape)}")
    if table.device != device or ids.device != device:
        raise ValueError(f"{what} takes tensors on one device: {device}, but a table on "
                         f"{table.device} and its ids on {ids.device}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f"{what} needs contiguous tables and ids")
    if table.shape[0] == 0 and ids.shape[0] > 0:
        raise ValueError("cannot gather from an empty table")
    if device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{what} runs on cuda or cpu tensors, not {device}")


def _launch(tables, ids, outs, what: str) -> int:
    """One kernel launch (one a 64 fields) over the fields with rows to
    copy; returns the number of launches made."""
    desc = []
    for t, i, o in zip(tables, ids, outs):
        if o.numel():
            desc += (t.data_ptr(), i.data_ptr(), o.data_ptr(), t.shape[0], t.shape[1], i.shape[0])
    if not desc:
        return 0
    fn = _build.function("gather", "tfrec_gather_rows_multi", _ARGTYPES)
    launched = ctypes.c_int(0)
    with torch.cuda.device(outs[0].device):
        rc = fn((ctypes.c_longlong * len(desc))(*desc), len(desc) // 6,
                torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    _build.check_launch(rc, what)
    return launched.value


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [V, D] f32, ids [N] int32 -> rows [N, D] f32.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    """
    _check(table, ids, table.device, "gather_rows")
    if table.device.type == "cpu":
        return gather_rows_ref(table, ids)
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    gather_rows.launches += _launch([table], [ids], [out], "gather_rows")
    return out


def gather_rows_multi(tables: Sequence[torch.Tensor], ids: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """tables [V_f, D_f] f32 and ids [N_f] int32, field by field, all on one
    device -> rows [N_f, D_f] f32 per field, each a contiguous view of one
    allocation. The same table may appear more than once.

    CUDA tensors launch the kernel once for every 64 fields (the fields of
    a batch share one grid); CPU tensors take the plain version.
    """
    tables, ids = list(tables), list(ids)
    if len(tables) != len(ids):
        raise ValueError(f"gather_rows_multi: {len(tables)} tables but {len(ids)} id vectors")
    if not tables:
        return []
    device = tables[0].device
    for t, i in zip(tables, ids):
        _check(t, i, device, "gather_rows_multi")
    if device.type == "cpu":
        return gather_rows_multi_ref(tables, ids)
    outs = _outputs([(i.shape[0], t.shape[1]) for t, i in zip(tables, ids)], device)
    gather_rows_multi.launches += _launch(tables, ids, outs, "gather_rows_multi")
    return outs


gather_rows.launches = 0  # kernel launches since the last reset
gather_rows_multi.launches = 0
