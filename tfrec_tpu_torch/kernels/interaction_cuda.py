"""DLRM's dot interaction and its VJP: ``top_in = [bottom ; P]``, P the
strict lower triangle of the pairwise dot products of the vectors
z = (bottom, field_0, ..., field_{F-1}), in ``np.tril_indices(n, k=-1)``'s
row-major order (pair p = i(i-1)/2 + j for j < i), which the top MLP's
first weight reads.

No Pallas kernel stands behind it: the reference (``tfrec_tpu/models/
dlrm.py``) leaves the interaction to XLA as an einsum. The kernels are
``csrc/interaction.cu``, one launch each way: the forward reads every
vector where it lies (a pointer and a row stride each) and writes
``top_in`` whole; the backward spreads dP into each example's symmetric
n x n matrix (zero diagonal) on chip and writes dz_i = sum_{j<i} dP_ij z_j
+ sum_{j>i} dP_ji z_j for every vector into one [n, B, D] allocation:
d_bottom (plus d top_in's bottom columns) and the fields' gradients, each a
contiguous [B, D] view as the gather lays out its rows. Both take the
former bmm's sums term for term in its order (a dot one f32 fused
multiply-add a column, in column order; dz's two sums as autograd's two
products of the bmm), with no atomics, so they repeat bit for bit.
Past ``MAX_REGISTER_VECTORS`` vectors the kernels' general route takes the
vectors stacked into [n, B, D] by this wrapper.

``DotInteraction`` is the ``torch.autograd.Function`` that joins the two;
``dot_interaction`` takes it where a gradient is needed, else the forward
alone. A CUDA tensor launches the kernels or raises; a CPU tensor takes the
plain versions, ``dot_interaction_fwd_ref`` (the model's former ``bmm`` and
triangle) and ``dot_interaction_bwd_ref`` (dP's triangle, then the two
``bmm`` of autograd's backward of the former code), which repeat the
kernels' arithmetic.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from tfrec_tpu_torch.kernels import _build

MAX_REGISTER_VECTORS = 32  # csrc/interaction.cu kMaxVectors
_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                 ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                 ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]


def _vectors(bottom: torch.Tensor | None, fields: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return ([] if bottom is None else [bottom]) + list(fields)


def dot_interaction_fwd_ref(bottom: torch.Tensor | None, fields: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: the vectors stacked
    [B, n, D], their products [B, n, n] by ``bmm``, the strict lower
    triangle, and ``bottom`` in front."""
    z = torch.stack(_vectors(bottom, fields), dim=1)
    rows, cols = torch.tril_indices(z.shape[1], z.shape[1], -1, device=z.device)
    pairs = torch.bmm(z, z.transpose(1, 2))[:, rows, cols]
    return pairs if bottom is None else torch.cat([bottom, pairs], dim=-1)


def dot_interaction_bwd_ref(bottom: torch.Tensor | None, fields: Sequence[torch.Tensor],
                            grad: torch.Tensor):
    """Plain PyTorch version of the backward kernel: (d_bottom or None, the
    fields' gradients) for ``grad`` = d top_in. dP goes to the strict lower
    triangle L of a zeroed [B, n, n] (no indexing backward); dz = L z +
    (z^T L)^T, the two products that autograd forms for the former bmm, and
    d_bottom = grad's bottom columns + dz_0; the gradients are views of one
    [n, B, D] allocation, as the kernel writes them."""
    z = torch.stack(_vectors(bottom, fields), dim=1)
    batch, n, dim = z.shape
    head = 0 if bottom is None else dim
    rows, cols = torch.tril_indices(n, n, -1, device=z.device)
    low = z.new_zeros((batch, n, n))
    low[:, rows, cols] = grad[:, head:]
    dz = torch.bmm(low, z) + torch.bmm(z.transpose(1, 2), low).transpose(1, 2)
    dz = dz.transpose(0, 1).contiguous()  # [n, B, D]
    if bottom is None:
        return None, list(dz.unbind(0))
    dz[0] += grad[:, :head]
    return dz[0], list(dz[1:].unbind(0))


def _check(vectors: List[torch.Tensor], what: str) -> None:
    if not vectors:
        raise ValueError(f"{what} takes at least one vector")
    first = vectors[0]
    for t in vectors:
        if t.dim() != 2 or t.dtype != torch.float32:
            raise TypeError(f"{what} takes [B, D] float32 vectors, got {t.dtype} {tuple(t.shape)}")
        if t.shape != first.shape:
            raise ValueError(f"{what} takes vectors of one shape: {tuple(first.shape)} and {tuple(t.shape)}")
        if t.device != first.device:
            raise ValueError(f"{what} takes vectors on one device: {first.device} and {t.device}")
    if first.device.type == "cpu":
        return
    if first.device.type != "cuda":
        raise NotImplementedError(f"{what} runs on cuda or cpu tensors, not {first.device}")
    for t in vectors:
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{what} reads each vector's row as one run: a column stride of "
                             f"{t.stride(1)} is not taken")


def _desc(vectors: List[torch.Tensor]):
    flat = [x for t in vectors for x in (t.data_ptr(), t.stride(0))]
    return (ctypes.c_longlong * len(flat))(*flat)


def dot_interaction_fwd(bottom: torch.Tensor | None, fields: Sequence[torch.Tensor]) -> torch.Tensor:
    """bottom [B, D] or None and the fields, each [B, D] f32 (any row stride)
    -> top_in [B, (D if bottom) + n(n-1)/2], n = the vectors.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    """
    vectors = _vectors(bottom, fields)
    _check(vectors, "dot_interaction_fwd")
    if vectors[0].device.type == "cpu":
        return dot_interaction_fwd_ref(bottom, fields)
    batch, dim = vectors[0].shape
    n = len(vectors)
    head = 0 if bottom is None else dim
    out = torch.empty((batch, head + n * (n - 1) // 2), dtype=torch.float32, device=vectors[0].device)
    if batch == 0 or dim == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        if n <= MAX_REGISTER_VECTORS:
            fn = _build.function("interaction", "tfrec_dot_interaction_fwd", _FWD_ARGTYPES)
            rc = fn(_desc(vectors), n, int(bottom is not None), batch, dim, out.data_ptr(), out.stride(0),
                    stream)
        else:
            z = torch.stack(vectors)  # [n, B, D]
            fn = _build.function("interaction", "tfrec_dot_interaction_fwd_general", _FWD_ARGTYPES)
            rc = fn(z.data_ptr(), n, int(bottom is not None), batch, dim, out.data_ptr(), out.stride(0), stream)
    _build.check_launch(rc, "dot_interaction_fwd")
    dot_interaction_fwd.launches += 1
    return out


dot_interaction_fwd.launches = 0  # kernel launches since the last reset


def dot_interaction_bwd(bottom: torch.Tensor | None, fields: Sequence[torch.Tensor], grad: torch.Tensor):
    """The VJP of ``dot_interaction_fwd`` for ``grad`` = d top_in [B, (D if
    bottom) + n(n-1)/2] -> (d_bottom [B, D] or None, [d_field [B, D], ...]),
    views of one [n, B, D] allocation.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    """
    vectors = _vectors(bottom, fields)
    _check(vectors, "dot_interaction_bwd")
    batch, dim = vectors[0].shape
    n = len(vectors)
    head = 0 if bottom is None else dim
    if grad.shape != (batch, head + n * (n - 1) // 2) or grad.dtype != torch.float32:
        raise ValueError(f"dot_interaction_bwd: grad must be [{batch}, {head + n * (n - 1) // 2}] float32, "
                         f"got {grad.dtype} {tuple(grad.shape)}")
    if grad.device != vectors[0].device:
        raise ValueError(f"dot_interaction_bwd: grad on {grad.device}, the vectors on {vectors[0].device}")
    if vectors[0].device.type == "cpu":
        return dot_interaction_bwd_ref(bottom, fields, grad)
    if grad.shape[1] > 1 and grad.stride(1) != 1:
        grad = grad.contiguous()
    dz = torch.empty((n, batch, dim), dtype=torch.float32, device=grad.device)
    if batch and dim:
        stream = torch.cuda.current_stream(dz.device).cuda_stream
        with torch.cuda.device(dz.device):
            if n <= MAX_REGISTER_VECTORS:
                fn = _build.function("interaction", "tfrec_dot_interaction_bwd", _BWD_ARGTYPES)
                rc = fn(_desc(vectors), n, int(bottom is not None), batch, dim, grad.data_ptr(), grad.stride(0),
                        dz.data_ptr(), stream)
            else:
                z = torch.stack(vectors)
                fn = _build.function("interaction", "tfrec_dot_interaction_bwd_general", _BWD_ARGTYPES)
                rc = fn(z.data_ptr(), n, int(bottom is not None), batch, dim, grad.data_ptr(), grad.stride(0),
                        dz.data_ptr(), stream)
        _build.check_launch(rc, "dot_interaction_bwd")
        dot_interaction_bwd.launches += 1
    if bottom is None:
        return None, list(dz.unbind(0))
    return dz[0], list(dz[1:].unbind(0))


dot_interaction_bwd.launches = 0


class DotInteraction(torch.autograd.Function):
    """The interaction with its hand-written VJP; saves its inputs (no
    intermediate). On CPU tensors both ways are the plain versions, so the
    CPU tests exercise the formula the kernels implement."""

    @staticmethod
    def forward(ctx, bottom, *fields):
        ctx.save_for_backward(bottom, *fields)
        return dot_interaction_fwd(bottom, fields)

    @staticmethod
    def backward(ctx, grad):
        bottom, *fields = ctx.saved_tensors
        d_bottom, d_fields = dot_interaction_bwd(bottom, fields, grad)
        return (d_bottom, *d_fields)


def dot_interaction(bottom: torch.Tensor | None, fields: Sequence[torch.Tensor]) -> torch.Tensor:
    """``dot_interaction_fwd`` under autograd: through ``DotInteraction``
    where a gradient is needed, else the forward alone."""
    vectors = _vectors(bottom, fields)
    if torch.is_grad_enabled() and any(t.requires_grad for t in vectors):
        return DotInteraction.apply(bottom, *fields)
    return dot_interaction_fwd(bottom, fields)
