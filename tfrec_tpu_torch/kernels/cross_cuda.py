"""DCN-v1 cross stack: ``x_{l+1} = x0 * (x_l . w_l) + b_l + x_l``, and its VJP.

The counterpart of ``tfrec_tpu/kernels/cross_pallas.py``
``cross_stack_pallas``: the forward (``_fwd_kernel``) is ``cross_v1_fwd``,
the backward (``_bwd_kernel``) is ``cross_v1_bwd``; both kernels are in
``csrc/cross.cu``. The forward keeps a row of x0 and of the running x in
the registers of a block of 256 threads across all layers (rows past 8192
elements stream through the output row instead) and reduces each row dot
in f32 in a fixed order, so it agrees with the plain version up to the
order of that sum (about 1e-6 relative at d=845) and repeats bit for bit.
For training it also returns the per-row scalars ``s[:, l] = x_l . w_l``
[B, L]. The backward regroups the reference's walk down the layers so
that a row needs only its L row dots with x0, and sums dw and db over the
batch from per-block partials in a fixed order (no atomics), so it too
repeats bit for bit. Both take any depth L and any width d up to
2**31 - 1 (the kernels index a row with a 32-bit int); the C entry points
choose their route by shape. ``CrossV1`` is the
``torch.autograd.Function`` that joins the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tfrec_tpu_torch.kernels import _build

# The kernels index a row with a 32-bit int.
_MAX_ROW = 2**31 - 1
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
_BWD_SCRATCH_ARGTYPES = [ctypes.c_longlong] * 3 + [ctypes.c_void_p]


def _check(names_tensors, what: str) -> None:
    first = names_tensors[0][1]
    for name, t in names_tensors:
        if t.dim() != 2 or t.dtype != torch.float32:
            raise TypeError(f"{name} must be 2-D float32, got {t.dtype} {tuple(t.shape)}")
        if t.device != first.device:
            raise ValueError(f"{names_tensors[0][0]} on {first.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} needs a contiguous {name}")


def _check_weights(x0, w, b) -> None:
    dim = x0.shape[1]
    layers = w.shape[0]
    if w.shape != (layers, dim) or b.shape != (layers, dim):
        raise ValueError(f"w and b must be [L, {dim}], got {tuple(w.shape)} and {tuple(b.shape)}")


def _check_device(x0: torch.Tensor, what: str) -> None:
    if not 1 <= x0.shape[1] <= _MAX_ROW:
        raise ValueError(f"{what} indexes a row with a 32-bit int and takes 1 <= d <= {_MAX_ROW}, "
                         f"got {x0.shape[1]}")
    if x0.device.type != "cuda":
        raise NotImplementedError(f"{what} runs on cuda or cpu tensors, not {x0.device}")


def cross_v1_fwd_ref(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                     want_s: bool = False):
    """Plain PyTorch version of the forward kernel (the reference's
    ``cross_stack_xla`` for v1). ``want_s``: also return s [B, L]."""
    x = x0
    ss = []
    for l in range(w.shape[0]):
        s = x @ w[l]
        ss.append(s)
        x = x0 * s[:, None] + b[l][None, :] + x
    if want_s:
        return x, torch.stack(ss, dim=1) if ss else x0.new_empty((x0.shape[0], 0))
    return x


def cross_v1_fwd(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                 want_s: bool = False):
    """x0 [B, d], w and b [L, d], all f32 -> x_L [B, d], and with
    ``want_s`` also the row scalars s [B, L] that ``cross_v1_bwd`` takes.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    """
    _check([("x0", x0), ("w", w), ("b", b)], "cross_v1_fwd")
    _check_weights(x0, w, b)
    if x0.device.type == "cpu":
        return cross_v1_fwd_ref(x0, w, b, want_s=want_s)
    _check_device(x0, "cross_v1_fwd")
    batch, dim = x0.shape
    layers = w.shape[0]
    out = torch.empty_like(x0)
    s = torch.empty((batch, layers), dtype=x0.dtype, device=x0.device) if want_s else None
    if batch > 0:
        fn = _build.function("cross", "tfrec_cross_v1_fwd", _FWD_ARGTYPES)
        with torch.cuda.device(x0.device):
            rc = fn(x0.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                    s.data_ptr() if want_s else None, batch, dim, layers,
                    torch.cuda.current_stream().cuda_stream)
        _build.check_launch(rc, "cross_v1_fwd")
        cross_v1_fwd.launches += 1
    return (out, s) if want_s else out


cross_v1_fwd.launches = 0  # kernel launches since the last reset


def cross_v1_bwd_ref(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     g: torch.Tensor, s: torch.Tensor | None = None):
    """Plain PyTorch version of the backward kernel: (dx0, dw, db) for the
    output gradient g [B, d]. ``s`` [B, L] are the forward's row scalars;
    without them they are recomputed, as the TPU kernel replays its forward."""
    layers = w.shape[0]
    xs = [x0]
    ss = []
    x = x0
    for l in range(layers):
        sl = x @ w[l] if s is None else s[:, l]
        ss.append(sl)
        x = x0 * sl[:, None] + b[l][None, :] + x
        xs.append(x)
    dx0 = torch.zeros_like(x0)
    dw = torch.empty_like(w)
    db = torch.empty_like(b)
    for l in range(layers - 1, -1, -1):
        ds = (g * x0).sum(dim=1)
        dw[l] = (xs[l] * ds[:, None]).sum(dim=0)
        db[l] = g.sum(dim=0)
        dx0 = dx0 + g * ss[l][:, None]
        g = g + ds[:, None] * w[l][None, :]
    return dx0 + g, dw, db


@functools.lru_cache(maxsize=64)
def _bwd_scratch_floats(batch: int, dim: int, layers: int, device_index: int) -> int:
    """The scratch, in floats, that the backward kernels take at this shape
    on the current device (per-block partials, and on the general route the
    row scalars; it depends on the card's SM count): asked of the C side
    once a shape, so a step makes one call into it."""
    del device_index  # the cache's key: the current device
    floats = ctypes.c_longlong()
    rc = _build.function("cross", "tfrec_cross_v1_bwd_scratch", _BWD_SCRATCH_ARGTYPES)(
        batch, dim, layers, ctypes.addressof(floats))
    _build.check_launch(rc, "cross_v1_bwd scratch")
    return floats.value


def cross_v1_bwd(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 s: torch.Tensor, g: torch.Tensor):
    """x0 and g [B, d], w and b [L, d], s [B, L] (from ``cross_v1_fwd(...,
    want_s=True)``), all f32 -> (dx0 [B, d], dw [L, d], db [L, d]).

    A CUDA tensor launches the kernel (and its fixed-order sum of the
    per-block partials; rows past 4096 elements or stacks past 4 layers
    take the kernel's general route, which computes the row scalars
    first); a CPU tensor takes the plain version.
    """
    _check([("x0", x0), ("w", w), ("b", b), ("s", s), ("g", g)], "cross_v1_bwd")
    _check_weights(x0, w, b)
    batch, dim = x0.shape
    layers = w.shape[0]
    if g.shape != x0.shape or s.shape != (batch, layers):
        raise ValueError(f"g must be [{batch}, {dim}] and s [{batch}, {layers}], "
                         f"got {tuple(g.shape)} and {tuple(s.shape)}")
    if x0.device.type == "cpu":
        return cross_v1_bwd_ref(x0, w, b, g, s)
    _check_device(x0, "cross_v1_bwd")
    dx0 = torch.empty_like(x0)
    if batch == 0 or layers == 0:
        return (g.clone() if layers == 0 else dx0), torch.zeros_like(w), torch.zeros_like(b)
    dw = torch.empty_like(w)  # the kernels write every element
    db = torch.empty_like(b)
    with torch.cuda.device(x0.device):
        floats = _bwd_scratch_floats(batch, dim, layers, x0.device.index)
        scratch = torch.empty(floats, dtype=x0.dtype, device=x0.device)
        fn = _build.function("cross", "tfrec_cross_v1_bwd", _BWD_ARGTYPES)
        rc = fn(x0.data_ptr(), w.data_ptr(), b.data_ptr(), s.data_ptr(), g.data_ptr(),
                dx0.data_ptr(), dw.data_ptr(), db.data_ptr(), scratch.data_ptr(), floats,
                batch, dim, layers, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "cross_v1_bwd")
    cross_v1_bwd.launches += 1
    return dx0, dw, db


cross_v1_bwd.launches = 0  # kernel launches since the last reset


class CrossV1(torch.autograd.Function):
    """The v1 cross stack with its hand-written VJP: the forward kernel saves
    s [B, L], the backward kernel takes it. On CPU tensors both are the plain
    versions, so the CPU tests exercise the formula the kernels implement."""

    @staticmethod
    def forward(ctx, x0, w, b):
        out, s = cross_v1_fwd(x0, w, b, want_s=True)
        ctx.save_for_backward(x0, w, b, s)
        return out

    @staticmethod
    def backward(ctx, g):
        x0, w, b, s = ctx.saved_tensors
        return cross_v1_bwd(x0, w, b, s, g.contiguous())
