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


def apply_mlp(
    params: MLPParams,
    x: torch.Tensor,
    *,
    final_linear: bool = True,
    dropout: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """ReLU MLP; if final_linear, the last layer has no activation (a head).

    Dropout (inverted scaling: kept units are divided by 1 - dropout) runs
    after each ReLU only when a ``generator`` is passed, as the reference
    runs it only when an rng is; eval paths pass none. The generator must
    live on x's device. Its numbers differ from JAX's for any seed.
    """
    n = len(params)
    for i, (w, b) in enumerate(params):
        x = x @ w + b
        if not (final_linear and i == n - 1):
            x = torch.relu(x)
            if dropout > 0.0 and generator is not None:
                keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - dropout
                x = torch.where(keep, x / (1.0 - dropout), 0.0)
    return x
