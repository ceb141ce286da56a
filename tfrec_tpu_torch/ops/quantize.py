"""Int8 item tables for serving: the counterpart of
``tfrec_tpu/ops/quantize.py``.

Rowwise symmetric quantization: ``q_i = round(v_i / s_i)``, ``s_i =
max|v_i| / 127`` (1 for a zero row), rounding half to even as the
reference's ``jnp.round`` does, so values and scales are the reference's
bit for bit. For a dot-product scorer the scale factors out:

    score(u, i) = <u, v_i> + b_i = s_i * <u, q_i> + b_i

``quantized_scores`` keeps the int8 values on the device and widens one
chunk of items at a time into the [B, V] scores (``torch.matmul``, as the
reference's ``jnp.dot`` outside any Pallas kernel), then applies the
rowwise scale and the bias to the result: no f32 copy of the whole table
is held. Top-k orders change only by the rounding (about 0.4% of a row's
range).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

CHUNK_ITEMS = 1 << 16  # items widened to f32 at a time


class QuantizedTable(NamedTuple):
    values: torch.Tensor  # [V, D] int8
    scales: torch.Tensor  # [V] f32


def quantize_table(table: torch.Tensor) -> QuantizedTable:
    """Rowwise symmetric int8 quantization of a [V, D] f32 table."""
    absmax = table.abs().amax(dim=1)
    # True divisions (on a card a tensor over a Python number multiplies
    # by its reciprocal).
    scales = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0), 1.0)
    q = torch.clamp(torch.round(table / scales[:, None]), -127, 127).to(torch.int8)
    return QuantizedTable(q, scales.to(torch.float32))


def dequantize_rows(qt: QuantizedTable, ids: torch.Tensor) -> torch.Tensor:
    """Selected rows back in f32 (for towers that are not dot products);
    ids clamp to the table, as the reference's ``mode="clip"``."""
    ids = ids.long().clamp(0, qt.values.shape[0] - 1)
    return qt.values[ids].to(torch.float32) * qt.scales[ids][:, None]


def quantized_scores(user_vecs: torch.Tensor, qt: QuantizedTable,
                     item_bias: torch.Tensor | None = None, chunk: int = CHUNK_ITEMS) -> torch.Tensor:
    """[B, V] catalog scores of ``user_vecs`` [B, D] against a quantized
    item table: ``<u, q_i>`` a chunk of items at a time, then times
    ``s_i``, plus ``b_i``."""
    vocab = qt.values.shape[0]
    scores = torch.empty((user_vecs.shape[0], vocab), dtype=torch.float32, device=user_vecs.device)
    for lo in range(0, vocab, chunk):
        wide = qt.values[lo:lo + chunk].to(user_vecs.dtype)
        scores[:, lo:lo + chunk] = torch.matmul(user_vecs, wide.T)
    scores.mul_(qt.scales[None, :])
    if item_bias is not None:
        scores.add_(item_bias[None, :])
    return scores
