"""Row gather with clip semantics: ``table[clamp(ids, 0, V-1)]``.

The counterpart of ``tfrec_tpu/kernels/gather_pallas.py`` ``gather_pallas``;
the kernel is ``csrc/gather.cu``. Ids are int32, as in the JAX package
(half the bytes of int64); other id types are refused. Negative ids clamp
to row 0 and sentinel ids (>= V) to row V-1, where plain ``index_select``
would raise. The result is an exact copy of the rows.
"""

from __future__ import annotations

import ctypes

import torch

from tfrec_tpu_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]


def gather_rows_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return table.index_select(0, ids.clamp(0, table.shape[0] - 1))


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [V, D] f32, ids [N] int32 -> rows [N, D] f32.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    """
    if table.dim() != 2 or table.dtype != torch.float32:
        raise TypeError(f"table must be [V, D] float32, got {table.dtype} {tuple(table.shape)}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise TypeError(f"ids must be [N] int32, got {ids.dtype} {tuple(ids.shape)}")
    if ids.device != table.device:
        raise ValueError(f"table on {table.device} but ids on {ids.device}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("gather_rows needs contiguous table and ids")
    vocab, dim = table.shape
    n = ids.shape[0]
    if vocab == 0 and n > 0:
        raise ValueError("cannot gather from an empty table")
    if table.device.type == "cpu":
        return gather_rows_ref(table, ids)
    if table.device.type != "cuda":
        raise NotImplementedError(f"gather_rows runs on cuda or cpu tensors, not {table.device}")
    out = torch.empty((n, dim), dtype=table.dtype, device=table.device)
    if n == 0 or dim == 0:
        return out
    fn = _build.function("gather", "tfrec_gather_rows", _ARGTYPES)
    with torch.cuda.device(table.device):
        rc = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, vocab, dim,
                torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0  # kernel launches since the last reset
