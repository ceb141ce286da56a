"""DCN cross-layer stack: x_{l+1} = x0 * f_l(x_l) + b_l + x_l.

DCN-v1: f_l(x) = (x . w_l), a rank-one cross. DCN-v2: f_l(x) = W_l x, or
low-rank U_l V_l^T x. ``cross_stack_ref`` is the plain PyTorch reference of
all three (the counterpart of ``tfrec_tpu.kernels.cross.cross_stack_xla``);
``cross_stack`` dispatches on the device:

- v1 goes to the CUDA kernels (``cross_cuda``), which take the plain
  versions themselves for a CPU tensor: ``CrossV1`` (forward and backward
  kernels) when a gradient is needed, else ``cross_v1_fwd`` alone;
- v2 full-rank has no kernel in the reference either (its [L, d, d] stack
  does not fit the TPU's scoped VMEM) and stays ``torch.matmul`` everywhere,
  differentiated by autograd;
- v2 low-rank runs plain on the CPU and is refused elsewhere, forward and
  backward, until its kernel is ported (ROADMAP Queue 2 item 3).
"""

from __future__ import annotations

from typing import Dict

import torch

from tfrec_tpu_torch.kernels.cross_cuda import CrossV1, cross_v1_fwd, cross_v1_fwd_ref


def cross_stack_ref(x0: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """params: {"w": [L, d] (v1) or [L, d, d] (v2 full), "b": [L, d]} or
    {"u", "v": [L, d, r], "b": [L, d]} (v2 low-rank)."""
    b = params["b"]
    x = x0
    if "u" in params:  # DCN-v2 low-rank
        u, v = params["u"], params["v"]
        for l in range(b.shape[0]):
            f = (x @ v[l]) @ u[l].T + b[l]
            x = x0 * f + x
        return x
    w = params["w"]
    if w.dim() == 3:  # DCN-v2 full-rank
        for l in range(b.shape[0]):
            f = x @ w[l].T + b[l]
            x = x0 * f + x
        return x
    return cross_v1_fwd_ref(x0, w, b)


def cross_stack(x0: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """All cross layers; the CUDA kernels for v1 on a CUDA tensor."""
    if "u" in params:
        if x0.device.type != "cpu":
            raise NotImplementedError(
                "the DCN-v2 low-rank cross kernel (tfrec_tpu cross_stack_pallas_v2) "
                "is not ported yet: ROADMAP Queue 2 item 3"
            )
        return cross_stack_ref(x0, params)
    w, b = params["w"], params["b"]
    if w.dim() == 3:
        return cross_stack_ref(x0, params)
    if torch.is_grad_enabled() and (x0.requires_grad or w.requires_grad or b.requires_grad):
        return CrossV1.apply(x0, w, b)
    return cross_v1_fwd(x0, w, b)
