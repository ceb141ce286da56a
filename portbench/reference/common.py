"""Plain float32 PyTorch of what every CTR reference shares: the matmul (in
float32, or with its operands rounded to TF32 for the control), a ReLU MLP,
the logloss, Adam and rowwise Adagrad. It imports nothing of the port."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

TF32_DROP = 13  # f32 keeps 23 mantissa bits, TF32 10


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits (half away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (1 << (TF32_DROP - 1))) & -(1 << TF32_DROP)).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b as a TF32 tensor core computes it: operands rounded to TF32,
    products summed in f32; the backward's products alike."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return (torch.matmul(g, round_tf32(b).transpose(-1, -2)),
                torch.matmul(round_tf32(a).transpose(-1, -2), g))


def matmul_for(precision: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``torch.matmul`` in float32 (TF32 off), or with TF32 operands."""
    if precision == "float32":
        return torch.matmul
    if precision == "tf32":
        return _TF32MatMul.apply
    raise ValueError(f"unknown precision {precision!r}")


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mlp(layers: List[Tuple[torch.Tensor, torch.Tensor]], x: torch.Tensor, mm,
        final_linear: bool) -> torch.Tensor:
    """x @ w + b a layer, ReLU after each but (with ``final_linear``) the last."""
    for i, (w, b) in enumerate(layers):
        x = mm(x, w) + b
        if not (final_linear and i == len(layers) - 1):
            x = torch.relu(x)
    return x


def logloss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits."""
    return torch.nn.functional.binary_cross_entropy_with_logits(logits, labels)


def leaves(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{dotted path: tensor} of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def rebuild(tree: Any, flat: Dict[str, torch.Tensor], prefix: str = "") -> Any:
    """``tree``'s structure holding ``flat``'s tensors."""
    if isinstance(tree, dict):
        return {k: rebuild(v, flat, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, flat, f"{prefix}{i}.") for i, v in enumerate(tree))
    return flat[prefix[:-1]]


class Adam:
    """Adam as optax writes it in float32: m and v decay by b1 and b2 (their
    complements applied as float32 scalars), the bias corrections 1 - b^t
    computed in float32, the update lr * m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    def _correction(self, b: float) -> float:
        return float(np.float32(1.0) - np.float32(b) ** np.float32(self.t))

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.t += 1
        c1, c2 = self._correction(self.b1), self._correction(self.b2)
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            out[k] = p - self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps)
        return out


def rowwise_adagrad(rows: torch.Tensor, acc: torch.Tensor, touched: torch.Tensor,
                    g: torch.Tensor, lr: float, eps: float) -> None:
    """In place on the rows a step touched: acc += mean(g^2) over the row;
    row -= lr * g / (sqrt(acc) + eps). ``g`` is each row's summed gradient."""
    g = g[touched]
    acc[touched] += (g * g).mean(dim=1)
    rows[touched] -= lr * g / (acc[touched].sqrt() + eps)[:, None]
