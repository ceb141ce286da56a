"""DCN-v1 cross stack, forward: ``x_{l+1} = x0 * (x_l . w_l) + b_l + x_l``.

The counterpart of ``tfrec_tpu/kernels/cross_pallas.py``
``cross_stack_pallas`` (forward, ``_fwd_kernel``); the kernel is
``csrc/cross.cu``. It keeps a row of x0 and of the running x in registers
across all layers and reduces each row dot in f32 in a fixed order, so it
agrees with the plain version up to the order of that sum (about 1e-6
relative at d=845) and repeats bit for bit. The backward kernel comes with
the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from tfrec_tpu_torch.kernels import _build

MAX_DIM = 2048  # 64 register chunks of 32 lanes (csrc/cross.cu)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]


def cross_v1_fwd_ref(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the reference's
    ``cross_stack_xla`` for v1)."""
    x = x0
    for l in range(w.shape[0]):
        x = x0 * (x @ w[l])[:, None] + b[l][None, :] + x
    return x


def cross_v1_fwd(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x0 [B, d], w and b [L, d], all f32 -> x_L [B, d].

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    """
    for name, t in (("x0", x0), ("w", w), ("b", b)):
        if t.dim() != 2 or t.dtype != torch.float32:
            raise TypeError(f"{name} must be 2-D float32, got {t.dtype} {tuple(t.shape)}")
        if t.device != x0.device:
            raise ValueError(f"x0 on {x0.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"cross_v1_fwd needs a contiguous {name}")
    batch, dim = x0.shape
    layers = w.shape[0]
    if w.shape != (layers, dim) or b.shape != (layers, dim):
        raise ValueError(f"w and b must be [L, {dim}], got {tuple(w.shape)} and {tuple(b.shape)}")
    if x0.device.type == "cpu":
        return cross_v1_fwd_ref(x0, w, b)
    if x0.device.type != "cuda":
        raise NotImplementedError(f"cross_v1_fwd runs on cuda or cpu tensors, not {x0.device}")
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"cross_v1_fwd keeps rows in registers and takes 1 <= d <= {MAX_DIM}, got {dim}")
    out = torch.empty_like(x0)
    if batch == 0:
        return out
    fn = _build.function("cross", "tfrec_cross_v1_fwd", _ARGTYPES)
    with torch.cuda.device(x0.device):
        rc = fn(x0.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                batch, dim, layers, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "cross_v1_fwd")
    cross_v1_fwd.launches += 1
    return out


cross_v1_fwd.launches = 0  # kernel launches since the last reset
