"""DCN cross-layer stack: x_{l+1} = x0 * f_l(x_l) + b_l + x_l.

DCN-v1: f_l(x) = (x . w_l), a rank-one cross. DCN-v2: f_l(x) = W_l x, or
low-rank U_l V_l^T x. ``cross_stack_ref`` is the plain PyTorch reference of
all three (the counterpart of ``tfrec_tpu.kernels.cross.cross_stack_xla``);
``cross_stack`` dispatches on the params:

- v1 and v2 low-rank go to their CUDA kernels (``cross_cuda``,
  ``cross_v2_cuda``), whose wrappers take the plain versions themselves for
  a CPU tensor: the autograd Function (``CrossV1``, ``CrossV2``: forward and
  backward kernels) when a gradient is needed, else the forward alone;
- v2 full-rank has no kernel in the reference either (its [L, d, d] stack
  does not fit the TPU's scoped VMEM) and stays ``torch.matmul`` everywhere,
  differentiated by autograd.
"""

from __future__ import annotations

from typing import Dict

import torch

from tfrec_tpu_torch.kernels.cross_cuda import CrossV1, cross_v1_fwd, cross_v1_fwd_ref
from tfrec_tpu_torch.kernels.cross_v2_cuda import CrossV2, cross_v2_fwd, cross_v2_fwd_ref


def cross_stack_ref(x0: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """params: {"w": [L, d] (v1) or [L, d, d] (v2 full), "b": [L, d]} or
    {"u", "v": [L, d, r], "b": [L, d]} (v2 low-rank)."""
    b = params["b"]
    if "u" in params:  # DCN-v2 low-rank
        return cross_v2_fwd_ref(x0, params["u"], params["v"], b)
    w = params["w"]
    if w.dim() == 3:  # DCN-v2 full-rank
        x = x0
        for l in range(b.shape[0]):
            f = x @ w[l].T + b[l]
            x = x0 * f + x
        return x
    return cross_v1_fwd_ref(x0, w, b)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def cross_stack(x0: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """All cross layers; the CUDA kernels for v1 and v2 low-rank on a CUDA
    tensor."""
    b = params["b"]
    if "u" in params:
        u, v = params["u"], params["v"]
        if _needs_grad(x0, u, v, b):
            return CrossV2.apply(x0, u, v, b)
        return cross_v2_fwd(x0, u, v, b)
    w = params["w"]
    if w.dim() == 3:
        return cross_stack_ref(x0, params)
    if _needs_grad(x0, w, b):
        return CrossV1.apply(x0, w, b)
    return cross_v1_fwd(x0, w, b)
