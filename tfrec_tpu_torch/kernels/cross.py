"""DCN cross-layer stack: x_{l+1} = x0 * f_l(x_l) + b_l + x_l.

DCN-v1: f_l(x) = (x . w_l), a rank-one cross. DCN-v2: f_l(x) = W_l x, or
low-rank U_l V_l^T x. ``cross_stack_ref`` is the plain PyTorch reference of
all three (the counterpart of ``tfrec_tpu.kernels.cross.cross_stack_xla``);
``cross_stack`` dispatches on the device:

- v1 goes to the CUDA kernel (``cross_cuda.cross_v1_fwd``), which takes the
  plain version itself for a CPU tensor;
- v2 full-rank has no kernel in the reference either (its [L, d, d] stack
  does not fit the TPU's scoped VMEM) and stays ``torch.matmul`` everywhere;
- v2 low-rank runs plain on the CPU and is refused elsewhere until its
  kernel is ported (ROADMAP Queue 2 item 4).
"""

from __future__ import annotations

from typing import Dict

import torch

from tfrec_tpu_torch.kernels.cross_cuda import cross_v1_fwd, cross_v1_fwd_ref


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
    """All cross layers; the CUDA kernel for v1 on a CUDA tensor."""
    if "u" in params:
        if x0.device.type != "cpu":
            raise NotImplementedError(
                "the DCN-v2 low-rank cross kernel (tfrec_tpu cross_stack_pallas_v2) "
                "is not ported yet: ROADMAP Queue 2 item 4"
            )
        return cross_stack_ref(x0, params)
    if params["w"].dim() == 3:
        return cross_stack_ref(x0, params)
    return cross_v1_fwd(x0, params["w"], params["b"])
