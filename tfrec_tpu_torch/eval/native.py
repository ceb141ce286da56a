"""The native threaded C++ evaluator: the counterpart of
``tfrec_tpu/eval/native.py``, over the same unmodified source,
``csrc/eval_native.cpp``.

The library is built with g++ on first use into the port's own
``build/tfrec_tpu_torch/`` (``kernels/_build.load_host``) and bound with
``ctypes``; where it cannot be built ``NativeUnavailable`` is raised, and
the caller takes the device evaluator (``eval/retrieval.py``). Both entry
points compute the full-sort ranking metrics (precision, recall, MAP, NDCG
and MRR at each k, averaged over the users with test items) on the host:
``evaluate_scores_native`` from a dense [U, V] score matrix,
``evaluate_dot_native`` from user and item vectors (and an item bias), each
thread scoring its users into its own buffer. Tensors (the port's, on any
device) are copied to the host as f32 numpy arrays first.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from tfrec_tpu_torch.kernels import _build
from tfrec_tpu_torch.kernels._build import NativeUnavailable

__all__ = ["METRIC_NAMES", "NativeUnavailable", "evaluate_dot_native", "evaluate_scores_native", "load"]

METRIC_NAMES = ("precision", "recall", "map", "ndcg", "mrr")
_declared = False


def load() -> ctypes.CDLL:
    """The evaluator's library, built on first use and its entries declared."""
    global _declared
    lib = _build.load_host("eval_native")
    if not _declared:
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.tfrec_eval_topk.argtypes = [
            f32p, ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p, i32p,
            ctypes.c_int32, ctypes.c_int32, f64p,
        ]
        lib.tfrec_eval_topk.restype = None
        lib.tfrec_eval_dot.argtypes = [
            f32p, f32p, f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, i32p, ctypes.c_int32, ctypes.c_int32, f64p,
        ]
        lib.tfrec_eval_dot.restype = None
        _declared = True
    return lib


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float32)


def _csr_parts(csr: sp.csr_matrix):
    indptr = np.ascontiguousarray(csr.indptr, dtype=np.int32)
    # The evaluator binary-searches each row: the indices must be sorted.
    m = csr if csr.has_sorted_indices else csr.sorted_indices()
    return indptr, np.ascontiguousarray(m.indices, dtype=np.int32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _metrics(run, num_users: int, exclude_csr, test_csr, ks: Sequence[int]) -> Dict[str, float]:
    """``run(e_ptr, e_ids, t_ptr, t_ids, k, out)`` for each k -> the mean of
    each metric over the users with test items."""
    e_ptr, e_ids = _csr_parts(exclude_csr)
    t_ptr, t_ids = _csr_parts(test_csr)
    denom = max(int((np.diff(t_ptr) > 0).sum()), 1)
    i32 = ctypes.c_int32
    out_all: Dict[str, float] = {}
    for k in ks:
        out = np.zeros((num_users, 5), dtype=np.float64)
        run(_ptr(e_ptr, i32), _ptr(e_ids, i32), _ptr(t_ptr, i32), _ptr(t_ids, i32), k,
            _ptr(out, ctypes.c_double))
        for name, val in zip(METRIC_NAMES, out.sum(axis=0)):
            out_all[f"{name}@{k}"] = float(val) / denom
    return out_all


def evaluate_scores_native(scores, exclude_csr: sp.csr_matrix, test_csr: sp.csr_matrix,
                           ks: Sequence[int], num_threads: int = 0) -> Dict[str, float]:
    """The full-sort ranking metrics of a dense [U, V] score matrix (a numpy
    array or a tensor on any device); ``num_threads`` 0 takes the
    hardware's."""
    lib = load()
    scores = _host(scores)
    num_users, num_items = scores.shape

    def run(e_ptr, e_ids, t_ptr, t_ids, k, out):
        lib.tfrec_eval_topk(_ptr(scores, ctypes.c_float), num_users, num_items, e_ptr, e_ids, t_ptr,
                            t_ids, k, num_threads, out)

    return _metrics(run, num_users, exclude_csr, test_csr, ks)


def evaluate_dot_native(user_vecs, item_vecs, item_bias, exclude_csr: sp.csr_matrix,
                        test_csr: sp.csr_matrix, ks: Sequence[int], num_threads: int = 0
                        ) -> Dict[str, float]:
    """The ranking metrics of the dot-product scorer ``user_vecs [U, D] @
    item_vecs [V, D].T (+ item_bias [V])``, without a [U, V] matrix (a
    score buffer a thread)."""
    lib = load()
    user_vecs, item_vecs = _host(user_vecs), _host(item_vecs)
    num_users, dim = user_vecs.shape
    num_items = item_vecs.shape[0]
    bias = None if item_bias is None else _host(item_bias).reshape(-1)
    bias_ptr = (_ptr(bias, ctypes.c_float) if bias is not None
                else ctypes.cast(None, ctypes.POINTER(ctypes.c_float)))

    def run(e_ptr, e_ids, t_ptr, t_ids, k, out):
        lib.tfrec_eval_dot(_ptr(user_vecs, ctypes.c_float), _ptr(item_vecs, ctypes.c_float), bias_ptr,
                           num_users, num_items, dim, e_ptr, e_ids, t_ptr, t_ids, k, num_threads, out)

    return _metrics(run, num_users, exclude_csr, test_csr, ks)
