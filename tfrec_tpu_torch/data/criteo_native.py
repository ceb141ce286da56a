"""ctypes bridge to the native Criteo parser (``csrc/criteo_native.cpp``):
the counterpart of ``tfrec_tpu/data/criteo_native.py``.

Streams a Criteo TSV through the threaded C++ parser in large chunks and
yields the (dense, cat, label) batches of the Python parser in
``data/criteo.py``: the same FNV-1a field hash, so ids and labels bit for
bit, and dense values 1 ulp apart on some entries (the C library's float32
``log1pf`` against float64 ``log1p`` rounded to float32; tests hold each
to its own arithmetic). The library is built with g++ into the port's
own ``build/tfrec_tpu_torch/`` (``kernels/_build.py``); without a
toolchain ``load`` raises ``NativeUnavailable`` and the callers fall back
to the Python parser.

One fault of the reference is not copied. Where a buffer holds malformed
lines and the row cap was not reached, ``tfrec_criteo_parse`` reports the
bytes consumed as the end of the rows-th line, counting the skipped lines
out, so the reference's iterator parses the buffer's last lines a second
time and yields their rows twice. ``parse_buffer`` takes every complete
line as consumed in that case (the C code has then read them all), so the
rows are the Python parser's.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Sequence, Tuple

import numpy as np

from tfrec_tpu_torch.kernels import _build
from tfrec_tpu_torch.kernels._build import NativeUnavailable
from tfrec_tpu_torch.data.criteo import NUM_CATEGORICAL, NUM_DENSE

__all__ = ["NativeUnavailable", "iter_criteo_batches_native", "load", "parse_buffer"]

_declared = False


def load() -> ctypes.CDLL:
    """The parser's library, built on first use and its entry declared."""
    global _declared
    lib = _build.load_host("criteo_native")
    if not _declared:
        c = ctypes
        lib.tfrec_criteo_parse.argtypes = [
            c.c_char_p, c.c_int64, c.c_int64, c.POINTER(c.c_int32), c.c_int32,
            c.POINTER(c.c_float), c.POINTER(c.c_int32), c.POINTER(c.c_float),
            c.POINTER(c.c_int64),
        ]
        lib.tfrec_criteo_parse.restype = c.c_int64
        _declared = True
    return lib


def parse_buffer(
    buf: bytes,
    vocab_sizes: Sequence[int],
    max_rows: int | None = None,
    num_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Parse the complete lines of ``buf``: (dense, cat, label,
    bytes_consumed), the arrays trimmed to the rows parsed."""
    lib = load()
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, 8)
    cap = max_rows if max_rows is not None else buf.count(b"\n")
    dense = np.zeros((cap, NUM_DENSE), np.float32)
    cat = np.zeros((cap, NUM_CATEGORICAL), np.int32)
    label = np.zeros(cap, np.float32)
    vs = np.ascontiguousarray(vocab_sizes, dtype=np.int32)
    if len(vs) != NUM_CATEGORICAL:
        raise ValueError(f"criteo needs {NUM_CATEGORICAL} vocab sizes, got {len(vs)}")
    consumed = ctypes.c_int64(0)
    c = ctypes
    rows = lib.tfrec_criteo_parse(
        buf, len(buf), cap, vs.ctypes.data_as(c.POINTER(c.c_int32)), num_threads,
        dense.ctypes.data_as(c.POINTER(c.c_float)),
        cat.ctypes.data_as(c.POINTER(c.c_int32)),
        label.ctypes.data_as(c.POINTER(c.c_float)),
        c.byref(consumed),
    )
    if rows < cap:  # every complete line was read, malformed ones too
        consumed.value = buf.rfind(b"\n") + 1
    return dense[:rows], cat[:rows], label[:rows], int(consumed.value)


def iter_criteo_batches_native(
    path: str,
    batch_size: int,
    vocab_sizes: Sequence[int] | int = 100_000,
    max_examples: int | None = None,
    chunk_bytes: int = 64 << 20,
    num_threads: int = 0,
    drop_remainder: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """``data.criteo.iter_criteo_batches`` through the native parser: reads
    ``chunk_bytes`` at a time, parses them in parallel and slices fixed-size
    batches. The final partial batch is dropped, or with
    ``drop_remainder=False`` yielded trimmed, as the Python parser does."""
    if isinstance(vocab_sizes, int):
        vocab_sizes = [vocab_sizes] * NUM_CATEGORICAL
    pend_d, pend_c, pend_l = [], [], []
    pending = 0
    seen = 0
    with open(path, "rb") as f:
        carry = b""
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk and not carry:
                break
            buf = carry + chunk
            limit = None if max_examples is None else max_examples - seen
            if limit is not None and limit <= 0:
                break
            if not chunk and buf and not buf.endswith(b"\n"):
                # A last line without its newline parses, as in the Python parser.
                buf += b"\n"
            dense, cat, label, consumed = parse_buffer(
                buf, vocab_sizes, max_rows=limit, num_threads=num_threads)
            if len(label) == 0 and not chunk:
                break
            carry = buf[consumed:]
            seen += len(label)
            pend_d.append(dense)
            pend_c.append(cat)
            pend_l.append(label)
            pending += len(label)
            while pending >= batch_size:
                d, ca, la = np.concatenate(pend_d), np.concatenate(pend_c), np.concatenate(pend_l)
                yield d[:batch_size], ca[:batch_size], la[:batch_size]
                d, ca, la = d[batch_size:], ca[batch_size:], la[batch_size:]
                pend_d, pend_c, pend_l = [d], [ca], [la]
                pending = len(la)
            if not chunk:
                break
    if pending and not drop_remainder:
        yield np.concatenate(pend_d), np.concatenate(pend_c), np.concatenate(pend_l)
