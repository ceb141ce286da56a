"""``train.matmul_precision``: the counterpart of the reference's
``jax_default_matmul_precision``, process-global as that flag is.

- "default", "highest", "float32": f32 matmuls and convolutions with TF32
  off (cuBLAS and cuDNN), the port's arithmetic.
- "high", "tensorfloat32": TF32 on for cuBLAS and cuDNN.
- "bfloat16": the operands of every dense matmul and convolution (``@``,
  ``matmul``, ``mm``, ``bmm``, ``einsum``, ``linear``, ``conv1d``,
  ``conv2d``) are rounded to bf16 and the product is accumulated and
  returned in f32 (products of bf16 values are exact in f32), what the
  TPU setting means. A ``TorchFunctionMode`` rounds them, on the thread
  that set it; gradients pass the rounding unchanged. The hand-written
  CUDA kernels keep their own arithmetic (their plain versions, which
  run on the CPU, are rounded with the rest).

``set_matmul_precision`` sets every flag each time, so one setting never
outlives the next call (every ``Trainer`` calls it).
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

PRECISIONS = ("default", "highest", "float32", "high", "tensorfloat32", "bfloat16")

_ROUNDED = {
    torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
    torch.mm, torch.Tensor.mm, torch.bmm, torch.Tensor.bmm, torch.einsum,
    torch.nn.functional.linear, torch.nn.functional.conv1d, torch.nn.functional.conv2d,
}


def round_bf16(x):
    """An f32 tensor's values rounded to bf16 (nearest even), kept in f32;
    the gradient passes unchanged. Anything else is returned as it is."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        r = x.to(torch.bfloat16).to(torch.float32)
        return x + (r - x).detach() if x.requires_grad else r
    if isinstance(x, (list, tuple)):
        return type(x)(round_bf16(v) for v in x)
    return x


class Bfloat16Matmuls(TorchFunctionMode):
    """Rounds the f32 operands of dense matmuls and convolutions to bf16."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _ROUNDED:
            args = round_bf16(tuple(args))
            kwargs = {k: round_bf16(v) if k in ("input", "other", "weight") else v
                      for k, v in kwargs.items()}
        return func(*args, **kwargs)


_mode: Bfloat16Matmuls | None = None


def set_matmul_precision(name: str) -> None:
    """Set the process's matmul precision (see the module's docstring)."""
    global _mode
    if name not in PRECISIONS:
        raise ValueError(f"unknown train.matmul_precision {name!r}; options: {PRECISIONS}")
    tf32 = name in ("high", "tensorfloat32")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if _mode is not None:
        _mode.__exit__(None, None, None)
        _mode = None
    if name == "bfloat16":
        _mode = Bfloat16Matmuls()
        _mode.__enter__()


def current() -> dict:
    """The flags as they stand: {"tf32_matmul", "tf32_conv", "bf16_operands"}."""
    return {"tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "tf32_conv": torch.backends.cudnn.allow_tf32,
            "bf16_operands": _mode is not None}
