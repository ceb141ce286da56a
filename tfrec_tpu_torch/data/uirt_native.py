"""ctypes bridge to the native UIRT parser (``csrc/uirt_native.cpp``): the
counterpart of ``tfrec_tpu/data/uirt_native.py``.

Parses a whole rating-file buffer through the threaded C++ parser, the
same arrays as the Python loop of ``data/movielens.load_uirt_raw`` (tests
hold the two equal). The library is built with g++ into the port's own
``build/tfrec_tpu_torch/`` (``kernels/_build.py``); without a toolchain
``load`` raises ``NativeUnavailable`` and the caller takes the Python loop.
A malformed numeric field raises ValueError, as the Python loop does.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from tfrec_tpu_torch.kernels import _build
from tfrec_tpu_torch.kernels._build import NativeUnavailable

__all__ = ["NativeUnavailable", "load", "parse_buffer"]

_declared = False


def load() -> ctypes.CDLL:
    """The parser's library, built on first use and its entries declared."""
    global _declared
    lib = _build.load_host("uirt_native")
    if not _declared:
        c = ctypes
        lib.tfrec_uirt_count.argtypes = [c.c_char_p, c.c_int64]
        lib.tfrec_uirt_count.restype = c.c_int64
        lib.tfrec_uirt_parse.argtypes = [
            c.c_char_p, c.c_int64, c.c_char_p, c.c_int32,
            c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.POINTER(c.c_float),
            c.POINTER(c.c_double), c.POINTER(c.c_uint8), c.c_int64, c.c_int32,
        ]
        lib.tfrec_uirt_parse.restype = c.c_int64
        _declared = True
    return lib


def parse_buffer(
    buf: bytes, sep: str, n_threads: int | None = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(raw_users, raw_items, ratings, times) of a header-stripped buffer."""
    lib = load()
    n_threads = n_threads or min(os.cpu_count() or 1, 16)
    n_lines = int(lib.tfrec_uirt_count(buf, len(buf)))
    if n_lines == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float32), np.empty(0, np.float64))
    users = np.empty(n_lines, np.int64)
    items = np.empty(n_lines, np.int64)
    ratings = np.ones(n_lines, np.float32)
    times = np.zeros(n_lines, np.float64)
    valid = np.zeros(n_lines, np.uint8)
    c = ctypes
    sep_b = sep.encode("latin-1")
    seen = int(lib.tfrec_uirt_parse(
        buf, len(buf), sep_b, len(sep_b),
        users.ctypes.data_as(c.POINTER(c.c_int64)),
        items.ctypes.data_as(c.POINTER(c.c_int64)),
        ratings.ctypes.data_as(c.POINTER(c.c_float)),
        times.ctypes.data_as(c.POINTER(c.c_double)),
        valid.ctypes.data_as(c.POINTER(c.c_uint8)),
        n_lines, n_threads,
    ))
    if seen != n_lines:
        raise RuntimeError(f"the UIRT parser read {seen} of {n_lines} lines")
    bad = np.flatnonzero(valid == 2)
    if len(bad):
        raise ValueError(
            f"malformed numeric field on line {int(bad[0])} of the UIRT buffer (after any header)")
    keep = valid == 1
    return users[keep], items[keep], ratings[keep], times[keep]
