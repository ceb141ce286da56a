"""Dense building blocks (MLP towers) as plain init/apply functions.

The counterpart of ``tfrec_tpu/models/layers.py``. Weights keep the JAX
package's ``[in, out]`` layout (``x @ w + b``), so parameters convert
without transposes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

MLPParams = List[Tuple[torch.Tensor, torch.Tensor]]


def glorot(
    generator: torch.Generator, shape: Tuple[int, int], device: torch.device | str
) -> torch.Tensor:
    """Glorot-normal: std sqrt(2 / (fan_in + fan_out))."""
    fan_in, fan_out = shape
    scale = (2.0 / (fan_in + fan_out)) ** 0.5
    return torch.randn(shape, generator=generator, device=device).mul_(scale)


def init_mlp(
    generator: torch.Generator, in_dim: int, widths: Sequence[int],
    device: torch.device | str,
) -> MLPParams:
    """Layers of the given widths (weights glorot-normal, biases zero)."""
    dims = [in_dim, *widths]
    return [
        (glorot(generator, (dims[i], dims[i + 1]), device),
         torch.zeros((dims[i + 1],), device=device))
        for i in range(len(dims) - 1)
    ]


def apply_mlp(params: MLPParams, x: torch.Tensor, *, final_linear: bool = True) -> torch.Tensor:
    """ReLU MLP; if final_linear, the last layer has no activation (a head).

    No dropout: the reference applies it only on training steps (when an
    rng is passed), and training comes with a later slice.
    """
    n = len(params)
    for i, (w, b) in enumerate(params):
        x = x @ w + b
        if not (final_linear and i == n - 1):
            x = torch.relu(x)
    return x
