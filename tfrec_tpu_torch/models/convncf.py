"""ConvNCF, outer-product convolutional NCF (He et al. 2018).

The counterpart of ``tfrec_tpu/models/convncf.py``. A (user, item) pair is
scored from the outer product of its factor rows, a [D, D] map whose (a, b)
cell is p_ua * q_ib, through log2(D) 2x2 stride-2 convolutions (each halves
the map; ReLU after each) down to C channels at 1x1 and a linear readout.

The rows come through the gather kernel (``_NCFBase``); the convolutions
are ``torch.nn.functional.conv2d`` in NCHW, as the reference computes its
own with XLA outside any Pallas kernel. Their weights are ``k{l}`` [C,
C_in, 2, 2] (OIHW; ``convert`` moves the reference's HWIO kernels) with
biases ``kb{l}`` [C], then ``w`` [C] and ``b``. On a card each convolution,
forward and backward, runs in f32 with cuDNN's TF32 off and its
deterministic algorithms (``_conv``), as every product of the port runs
without TF32. The catalog is scored in chunks of ``eval_chunk`` = 128
items, the [B * 128, C, D/2, D/2] first feature map being the cost.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from tfrec_tpu_torch.models.base import DataSpec
from tfrec_tpu_torch.models.ncf import _NCFBase
from tfrec_tpu_torch.ops.embedding import TableSpec


def _f32_cudnn():
    return torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class _Conv(torch.autograd.Function):
    """A 2x2 stride-2 VALID convolution whose backward, too, runs under
    ``_f32_cudnn`` (autograd would otherwise run it under the global
    flags)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _f32_cudnn():
            return F.conv2d(x, w, stride=2)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        with _f32_cudnn():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(x.shape, w, g, stride=2)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, g, stride=2)
        return gx, gw


class ConvNCF(_NCFBase):
    eval_chunk = 128

    def __init__(self, data_spec: DataSpec, embed_dim: int = 64, channels: int = 32, dropout: float = 0.0):
        super().__init__(data_spec)
        if embed_dim < 2 or embed_dim & (embed_dim - 1):
            raise ValueError(
                f"ConvNCF halves the {embed_dim}x{embed_dim} map 2x per layer; embed_dim must be a "
                "power of two")
        self.embed_dim = embed_dim
        self.channels = channels
        self.dropout = dropout
        self.num_layers = embed_dim.bit_length() - 1  # log2(D)

    def table_specs(self) -> Tuple[TableSpec, ...]:
        u, v, d = self.data_spec.num_users, self.data_spec.num_items, self.embed_dim
        return (TableSpec("user_emb", u, d), TableSpec("item_emb", v, d))

    def init_dense(self, generator: torch.Generator, device: torch.device | str):
        c = self.channels

        def uniform(shape, lim):
            return (torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0) * lim

        dense = {}
        for l in range(self.num_layers):
            cin = 1 if l == 0 else c
            dense[f"k{l}"] = uniform((c, cin, 2, 2), math.sqrt(6.0 / (4 * cin + 4 * c)))
            dense[f"kb{l}"] = torch.zeros((c,), device=device)
        dense["w"] = uniform((c,), math.sqrt(6.0 / (c + 1)))
        dense["b"] = torch.zeros((), device=device)
        return dense

    def _pair_logit(self, dense, u_g: Dict, i_g: Dict, generator=None) -> torch.Tensor:
        u, i = u_g["user_emb"], i_g["item_emb"]
        x = (u[:, :, None] * i[:, None, :])[:, None]  # [N, 1, D, D]
        for l in range(self.num_layers):
            x = torch.relu(_Conv.apply(x, dense[f"k{l}"]) + dense[f"kb{l}"][None, :, None, None])
        x = x.reshape(x.shape[0], self.channels)  # [N, C] (1x1 spatial)
        if generator is not None and self.dropout > 0.0:
            keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - self.dropout
            x = torch.where(keep, x / (1.0 - self.dropout), 0.0)
        return x @ dense["w"] + dense["b"]

    @staticmethod
    def dense_from_jax(dense):
        """The reference's dense tree (numpy): HWIO kernels -> OIHW."""
        return {k: (v.transpose(3, 2, 0, 1) if k.startswith("k") and not k.startswith("kb") else v)
                for k, v in dense.items()}

    @staticmethod
    def dense_to_jax(dense):
        """The port's dense tree (numpy): OIHW kernels -> HWIO."""
        return {k: (v.transpose(2, 3, 1, 0) if k.startswith("k") and not k.startswith("kb") else v)
                for k, v in dense.items()}
