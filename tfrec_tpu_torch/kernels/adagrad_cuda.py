"""Fused rowwise Adagrad over deduplicated ids, in place.

The counterpart of ``tfrec_tpu/kernels/scatter_pallas.py``
``fused_rowwise_adagrad`` (built on ``scaled_scatter_sub``); the kernel is
``csrc/adagrad.cu``. For each slot whose id is a real row (``0 <= uid <
V``; the sentinel tail of ``combine_duplicate_ids`` is skipped)::

    acc[u]   += mean(g_u ** 2)
    table[u] -= lr * g_u / (sqrt(acc[u]) + eps)

Both tensors are updated IN PLACE and returned, as the TPU kernel aliases
its table input to its output; a caller that needs the old values clones
them first. On the card one pass does both parts (the TPU left the
accumulator to XLA). The kernel sums each row's squares in another order
than the plain version, so the two agree to about 1e-7 relative; the kernel
repeats bit for bit. Real ids must be distinct, as for the TPU kernel.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from tfrec_tpu_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def fused_rowwise_adagrad_ref(table: torch.Tensor, acc: torch.Tensor, uids: torch.Tensor,
                              grads: torch.Tensor, lr: float, eps: float = 1e-8):
    """Plain PyTorch version of the kernel, in place as well."""
    vocab, dim = table.shape
    valid = (uids >= 0) & (uids < vocab)
    rows = uids[valid].long()
    g = grads[valid]
    acc_rows = acc[rows] + (g * g).sum(dim=-1) / dim
    acc[rows] = acc_rows
    # A true division (``lr / tensor`` would multiply by a reciprocal).
    scale = torch.full_like(acc_rows, lr) / (acc_rows.sqrt() + eps)
    table[rows] = table[rows] - scale[:, None] * g
    return table, acc


def fused_rowwise_adagrad(table: torch.Tensor, acc: torch.Tensor, uids: torch.Tensor,
                          grads: torch.Tensor, lr: float, eps: float = 1e-8):
    """table [V, D] f32, acc [V] f32, uids [N] int32 (distinct real ids, a
    sentinel >= V for unused slots), grads [N, D] f32 (combined), lr and eps
    numbers -> (table, acc), the same tensors, updated in place.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    """
    if table.dim() != 2 or table.dtype != torch.float32:
        raise TypeError(f"table must be [V, D] float32, got {table.dtype} {tuple(table.shape)}")
    vocab, dim = table.shape
    if acc.shape != (vocab,) or acc.dtype != torch.float32:
        raise TypeError(f"acc must be [{vocab}] float32, got {acc.dtype} {tuple(acc.shape)}")
    if uids.dim() != 1 or uids.dtype != torch.int32:
        raise TypeError(f"uids must be [N] int32, got {uids.dtype} {tuple(uids.shape)}")
    if grads.shape != (uids.shape[0], dim) or grads.dtype != torch.float32:
        raise TypeError(f"grads must be [{uids.shape[0]}, {dim}] float32, "
                        f"got {grads.dtype} {tuple(grads.shape)}")
    for name, t in (("acc", acc), ("uids", uids), ("grads", grads)):
        if t.device != table.device:
            raise ValueError(f"table on {table.device} but {name} on {t.device}")
    if not all(t.is_contiguous() for t in (table, acc, uids, grads)):
        raise ValueError("fused_rowwise_adagrad needs contiguous table, acc, uids and grads")
    if not isinstance(lr, numbers.Real) or not isinstance(eps, numbers.Real):
        raise TypeError("lr and eps must be numbers (the kernel takes them by value)")
    if table.device.type == "cpu":
        return fused_rowwise_adagrad_ref(table, acc, uids, grads, lr, eps)
    if table.device.type != "cuda":
        raise NotImplementedError(f"fused_rowwise_adagrad runs on cuda or cpu tensors, not {table.device}")
    n = uids.shape[0]
    if n == 0 or dim == 0:
        return table, acc
    fn = _build.function("adagrad", "tfrec_rowwise_adagrad", _ARGTYPES)
    with torch.cuda.device(table.device):
        rc = fn(table.data_ptr(), acc.data_ptr(), uids.data_ptr(), grads.data_ptr(),
                n, vocab, dim, float(lr), float(eps), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "fused_rowwise_adagrad")
    fused_rowwise_adagrad.launches += 1
    return table, acc


fused_rowwise_adagrad.launches = 0  # kernel launches since the last reset
