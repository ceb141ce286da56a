"""DCN-v2 low-rank cross stack: ``x_{l+1} = x0 * ((x_l V_l) U_l^T + b_l) + x_l``,
and its VJP.

The counterpart of ``tfrec_tpu/kernels/cross_pallas.py``
``cross_stack_pallas_v2``: the forward (``_fwd_kernel_v2``) is
``cross_v2_fwd``, the backward (``_bwd_kernel_v2``) is ``cross_v2_bwd``;
both kernels are in ``csrc/cross_v2.cu``. Both run their products (two a
layer forward, four backward) on the tensor cores as 3xTF32 (``mma.sync``
TF32, each f32 operand split into a TF32 high part and a TF32 remainder,
three products summed in f32), which keeps about f32 accuracy. The TPU
wrapper pads d and r to 128 lanes; here the shapes are used as they are.
Every product is summed in a fixed order, so the kernels agree with the
plain versions up to the order and rounding of those sums and repeat bit
for bit. For training the forward also returns what the backward needs, f
[L, B, d] and xv = x_l V_l [L, B, r]: the backward then replays no product
(it rebuilds x_l elementwise from x0 and f) and sums dU, dV and db over the
batch in fixed-order chunks, with no atomics. Each wrapper hands its kernels
the weights in the order of the mma's B fragments (``_fragments``: one
8-byte load a lane a k-step), V and U^T for the forward, U and V^T for the
backward: one small copy a call (650 KB at the flagship's shape).
``CrossV2`` is the ``torch.autograd.Function`` that joins the two.

These designs hold 16 rows of the products' [B, d] and [B, r] operands in
a block's shared memory, and the backward's weight pass stages L - 1
layers of f there. Where either does not fit (d > 3560 at r=64, d > 3496
at r=128, L >= 48: ``_fwd_route``, ``_bwd_route``, the one owner of the
choice), the wrappers send the C entry points down a general route
instead, with the same contract: any d, r >= 1 and L. It runs each product
as its own launch of 3xTF32 tiled products on the tensor cores (Hopper's
warpgroup mma, ``wgmma``: a 128 x 128 tile of the output a block of two
warpgroups, operands streamed from device memory through a ring of
``cp.async`` stages, B split into TF32 high parts and remainders once a
block, A as it is loaded), with the elementwise steps fused into the
products' prologues and epilogues. Its bound is the tiles': 3 x 4
B d r L TF32 operations forward and twice that backward at 495 TFLOP/s
(4.08 and 8.15 ms at B=32768, d=3341, r=512, L=3), plus the elementwise
steps; the products over d that store [B, r] split d into slices where a
small batch gives them too few tiles (``_splits``). It reads U and V as
they are; its calls are also counted in ``general_launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tfrec_tpu_torch.kernels import _build

_FWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 5
                 + [ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_longlong] * 6
                 + [ctypes.c_int, ctypes.c_void_p])
_SCRATCH_ARGTYPES = [ctypes.c_longlong] * 3
# A block of the forward holds 32 rows (16 where 32 do not fit) of x and xv,
# the A operands of its products, in shared memory, rows padded as
# _frag_stride says (csrc/cross_v2.cu fwd_smem_bytes); a block of the
# backward's row pass holds the same of df and t, and of g where that fits
# (rows_smem_bytes; else g lives in a device-memory scratch whose rows
# tfrec_cross_v2_bwd_scratch_rows gives). Hopper gives a block at most 227 KB;
# past that the general route runs.
_MIN_ROWS = 16
_MAX_SMEM = 227 * 1024
# The weight pass walks the batch in at most 16 chunks of at least 256 rows,
# whose partial sums a second kernel adds in chunk order. Its rows arrive in
# stages of 32 (fewer where many layers would not fit): two stages of df,
# x0, xv, t and f_0..f_{L-2}, [rows, 72] floats each (csrc/cross_v2.cu
# weights_smem_bytes).
_MAX_CHUNKS = 16
_MIN_CHUNK_ROWS = 256
# The general route's products over k = d that store [B, r] (x_l V_l, df
# U_l) have one 128 x 128 tile a block, few at a small B and r, each
# walking all of d: where the tiles fill less than one wave of 132 blocks
# (one of 256 threads on each of the H100's 132 SMs), they split d into
# slices of at least 1024 so that the waves of blocks are as full as they
# can be, and a second kernel adds the slices in order.
_TILE_ROWS, _TILE_COLS = 128, 128
_MIN_SPLIT_K = 1024
_SPLIT_BLOCKS = 132


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def _frag_stride(n: int) -> int:
    """Row stride of the row pass's tiles (csrc/cross_v2.cu frag_stride)."""
    n8 = _round8(n)
    return n8 if n8 % 16 else n8 + 8


def _smem_bytes(dim: int, rank: int) -> int:
    """The least shared memory a block of either tiled kernel takes: 16 rows
    of its products' A operands, [B, d] and [B, r] (the forward's x and xv,
    the row pass's df and t). It sets the widest d the tiles take."""
    return _MIN_ROWS * (_frag_stride(dim) + _frag_stride(rank)) * 4


def _weights_rows(layers: int) -> int:
    """Rows a stage of the weight pass (csrc/cross_v2.cu weights_rows): 32,
    16 or 8, whichever is the most that fits; 0 if none does."""
    for rows in (32, 16, 8):
        if 2 * (3 + layers) * rows * 72 * 4 <= _MAX_SMEM:
            return rows
    return 0


def _fwd_route(dim: int, rank: int) -> str:
    """The forward's route at these widths (csrc/cross_v2.cu tiles_take)."""
    return "tiles" if _smem_bytes(dim, rank) <= _MAX_SMEM else "general"


def _bwd_route(dim: int, rank: int, layers: int) -> str:
    """The backward's route: the tiles where the forward's fit and the
    weight pass stages its L - 1 layers of f, else the general route."""
    return "tiles" if _fwd_route(dim, rank) == "tiles" and _weights_rows(layers) else "general"


def _splits(batch: int, dim: int, rank: int) -> int:
    """Slices of d for the general route's x_l V_l and df U_l: none where
    the tiles fill a wave of blocks, else the count, up to d / 1024, whose
    waves are fullest (the fewest on a tie; 8192 rows at r=64: 64 tiles, 2
    slices fill 128 of 132 blocks)."""
    tiles = -(-batch // _TILE_ROWS) * -(-rank // _TILE_COLS)
    if tiles >= _SPLIT_BLOCKS:
        return 1
    fill = [tiles * s / (-(-tiles * s // _SPLIT_BLOCKS) * _SPLIT_BLOCKS)
            for s in range(1, min(-(-dim // _MIN_SPLIT_K), _SPLIT_BLOCKS) + 1)]
    return 1 + fill.index(max(fill))


def _fragments(w: torch.Tensor) -> torch.Tensor:
    """A stack of B operands [L, K, N] (B[k][n] = w[l, k, n]) as the
    kernels' products read them: zero padded to multiples of 8, in the
    order of the m16n8k8 B fragments, [L, K8/8, N8/8, 32 lanes, 2]. Lane
    4 gid + tid4 of k-step ks and n8 tile nt holds (B[8 ks + 2 tid4][8 nt +
    gid], B[8 ks + 2 tid4 + 1][8 nt + gid]) (the kernels read the A
    fragments' k in the same order)."""
    layers, k, n = w.shape
    k8, n8 = _round8(k), _round8(n)
    w = F.pad(w, (0, n8 - n, 0, k8 - k)).view(layers, k8 // 8, 4, 2, n8 // 8, 8)
    return w.permute(0, 1, 4, 5, 2, 3).reshape(layers, k8 // 8, n8 // 8, 32, 2)


def _check(named, what: str) -> None:
    first_name, first = named[0]
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{what}: {first_name} on {first.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} needs a contiguous {name}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_shapes(x0, u, v, what: str) -> None:
    if x0.dim() != 2 or u.dim() != 3:
        raise ValueError(f"{what}: x0 must be [B, d] and u [L, d, r], got "
                         f"{tuple(x0.shape)} and {tuple(u.shape)}")
    if u.shape[1] != x0.shape[1] or v.shape != u.shape:
        raise ValueError(f"{what}: u and v must be [L, {x0.shape[1]}, r] alike, got "
                         f"{tuple(u.shape)} and {tuple(v.shape)}")


def _check_device(x0: torch.Tensor, rank: int, what: str) -> None:
    if rank < 1:
        raise ValueError(f"{what} is the low-rank cross and takes r >= 1, got r={rank}")
    if x0.device.type != "cuda":
        raise NotImplementedError(f"{what} runs on cuda or cpu tensors, not {x0.device}")


def cross_v2_fwd_ref(x0: torch.Tensor, u: torch.Tensor, v: torch.Tensor, b: torch.Tensor, *,
                     want_saved: bool = False):
    """Plain PyTorch version of the forward kernel (the reference's
    ``cross_stack_xla`` for low-rank v2). ``want_saved``: also return f
    [L, B, d] and xv [L, B, r]."""
    x = x0
    fs, xvs = [], []
    for l in range(b.shape[0]):
        xv = x @ v[l]
        f = xv @ u[l].T + b[l]
        fs.append(f)
        xvs.append(xv)
        x = x0 * f + x
    if not want_saved:
        return x
    if not fs:
        return x, x0.new_empty((0, *x0.shape)), x0.new_empty((0, x0.shape[0], u.shape[2]))
    return x, torch.stack(fs), torch.stack(xvs)


def cross_v2_fwd(x0: torch.Tensor, u: torch.Tensor, v: torch.Tensor, b: torch.Tensor, *,
                 want_saved: bool = False):
    """x0 [B, d], u and v [L, d, r], b [L, d], all f32 -> x_L [B, d], and
    with ``want_saved`` also f [L, B, d] and xv [L, B, r] for ``cross_v2_bwd``.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    """
    _check([("x0", x0), ("u", u), ("v", v), ("b", b)], "cross_v2_fwd")
    _check_shapes(x0, u, v, "cross_v2_fwd")
    layers, dim, rank = u.shape
    if b.shape != (layers, dim):
        raise ValueError(f"cross_v2_fwd: b must be [{layers}, {dim}], got {tuple(b.shape)}")
    if x0.device.type == "cpu":
        return cross_v2_fwd_ref(x0, u, v, b, want_saved=want_saved)
    _check_device(x0, rank, "cross_v2_fwd")
    batch = x0.shape[0]
    out = x0.clone() if layers == 0 else torch.empty_like(x0)
    f = xv = None
    if want_saved:
        f = torch.empty((layers, batch, dim), dtype=x0.dtype, device=x0.device)
        xv = torch.empty((layers, batch, rank), dtype=x0.dtype, device=x0.device)
    if batch == 0 or layers == 0:  # nothing to launch
        return (out, f, xv) if want_saved else out
    fn = _build.function("cross_v2", "tfrec_cross_v2_fwd", _FWD_ARGTYPES)
    general = _fwd_route(dim, rank) == "general"
    vfrag = utfrag = xv_scratch = split_scratch = None
    splits = _splits(batch, dim, rank) if general else 1
    if not general:
        vfrag, utfrag = _fragments(v), _fragments(u.transpose(1, 2))
    elif not want_saved:
        xv_scratch = torch.empty((batch, rank), dtype=x0.dtype, device=x0.device)
    if splits > 1:
        split_scratch = torch.empty((splits, batch, rank), dtype=x0.dtype, device=x0.device)
    with torch.cuda.device(x0.device):
        rc = fn(x0.data_ptr(), _ptr(vfrag), _ptr(utfrag), u.data_ptr(), v.data_ptr(), b.data_ptr(),
                out.data_ptr(), _ptr(f), _ptr(xv), _ptr(xv_scratch), _ptr(split_scratch), batch, dim,
                rank, layers, splits, general, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "cross_v2_fwd")
    cross_v2_fwd.launches += 1
    cross_v2_fwd.general_launches += general
    return (out, f, xv) if want_saved else out


cross_v2_fwd.launches = 0  # kernel launches since the last reset
cross_v2_fwd.general_launches = 0  # of them, those on the general route


def cross_v2_bwd_ref(x0: torch.Tensor, u: torch.Tensor, v: torch.Tensor, f: torch.Tensor,
                     xv: torch.Tensor, g: torch.Tensor):
    """Plain PyTorch version of the backward kernels: (dx0, du, dv, db) for
    the output gradient g [B, d], from the forward's f [L, B, d] and xv
    [L, B, r] (``cross_v2_fwd_ref(..., want_saved=True)``); x_l is rebuilt
    from x0 and f as the forward computed it."""
    layers = u.shape[0]
    xs = [x0]
    for l in range(layers - 1):
        xs.append(x0 * f[l] + xs[-1])
    dx0 = torch.zeros_like(x0)
    du = torch.empty_like(u)
    dv = torch.empty_like(v)
    db = x0.new_empty((layers, x0.shape[1]))
    for l in range(layers - 1, -1, -1):
        df = g * x0
        db[l] = df.sum(dim=0)
        du[l] = df.T @ xv[l]
        t = df @ u[l]
        dv[l] = xs[l].T @ t
        dx0 = dx0 + g * f[l]
        g = g + t @ v[l].T
    return dx0 + g, du, dv, db


def cross_v2_bwd(x0: torch.Tensor, u: torch.Tensor, v: torch.Tensor, f: torch.Tensor,
                 xv: torch.Tensor, g: torch.Tensor):
    """x0 and g [B, d], u and v [L, d, r], f [L, B, d] and xv [L, B, r] (from
    ``cross_v2_fwd(..., want_saved=True)``), all f32 -> (dx0 [B, d], du and
    dv [L, d, r], db [L, d]).

    A CUDA tensor launches the kernels (the row pass, the weight pass and the
    fixed-order sum of its chunks; or the general route's, see the module's
    docstring); a CPU tensor takes the plain version.
    """
    _check([("x0", x0), ("u", u), ("v", v), ("f", f), ("xv", xv), ("g", g)], "cross_v2_bwd")
    _check_shapes(x0, u, v, "cross_v2_bwd")
    layers, dim, rank = u.shape
    batch = x0.shape[0]
    if (g.shape != x0.shape or f.shape != (layers, batch, dim)
            or xv.shape != (layers, batch, rank)):
        raise ValueError(f"cross_v2_bwd: g must be [{batch}, {dim}], f [{layers}, {batch}, {dim}] "
                         f"and xv [{layers}, {batch}, {rank}], got {tuple(g.shape)}, "
                         f"{tuple(f.shape)} and {tuple(xv.shape)}")
    if x0.device.type == "cpu":
        return cross_v2_bwd_ref(x0, u, v, f, xv, g)
    _check_device(x0, rank, "cross_v2_bwd")
    # The kernels write dU, dV and db into one buffer; the results are views.
    width = layers * dim * rank
    grads = torch.zeros(2 * width + layers * dim, dtype=x0.dtype, device=x0.device)
    split = (grads[:width].view(layers, dim, rank), grads[width:2 * width].view(layers, dim, rank),
             grads[2 * width:].view(layers, dim))
    if batch == 0 or layers == 0:  # nothing to launch
        return (g.clone(), *split)
    dx0 = torch.empty_like(x0)
    chunks = min(_MAX_CHUNKS, -(-batch // _MIN_CHUNK_ROWS))
    partial = torch.empty((chunks, grads.numel()), dtype=x0.dtype, device=x0.device)
    general = _bwd_route(dim, rank, layers) == "general"
    splits = _splits(batch, dim, rank) if general else 1
    ufrag = vtfrag = df = x_scratch = split_scratch = None
    if not general:
        # The row pass writes df and t with rows padded to multiples of 8 for
        # the weight pass's 16-byte copies, which also read xv 16 bytes at a time.
        df = torch.empty((layers, batch, _round8(dim)), dtype=x0.dtype, device=x0.device)
        t = torch.empty((layers, batch, _round8(rank)), dtype=x0.dtype, device=x0.device)
        if xv.data_ptr() % 16:
            xv = xv.clone()
        scratch_rows = _build.function("cross_v2", "tfrec_cross_v2_bwd_scratch_rows",
                                       _SCRATCH_ARGTYPES)(batch, dim, rank)
        g_scratch = (torch.empty((scratch_rows, _round8(dim)), dtype=x0.dtype, device=x0.device)
                     if scratch_rows else None)
        ufrag, vtfrag = _fragments(u), _fragments(v.transpose(1, 2))
    else:
        # t_l for every layer, g, and x_l for the next layer's rebuild.
        t = torch.empty((layers, batch, rank), dtype=x0.dtype, device=x0.device)
        g_scratch = torch.empty_like(x0)
        if layers >= 3:
            x_scratch = torch.empty((2, batch, dim), dtype=x0.dtype, device=x0.device)
        if splits > 1:
            split_scratch = torch.empty((splits, batch, rank), dtype=x0.dtype, device=x0.device)
    fn = _build.function("cross_v2", "tfrec_cross_v2_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x0.device):
        rc = fn(x0.data_ptr(), _ptr(ufrag), _ptr(vtfrag), u.data_ptr(), v.data_ptr(), f.data_ptr(),
                xv.data_ptr(), g.data_ptr(), dx0.data_ptr(), grads.data_ptr(), _ptr(df), t.data_ptr(),
                _ptr(g_scratch), _ptr(x_scratch), partial.data_ptr(), _ptr(split_scratch), batch, dim,
                rank, layers, chunks, splits, general, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "cross_v2_bwd")
    cross_v2_bwd.launches += 1
    cross_v2_bwd.general_launches += general
    return (dx0, *split)


cross_v2_bwd.launches = 0  # kernel launches since the last reset
cross_v2_bwd.general_launches = 0  # of them, those on the general route


class CrossV2(torch.autograd.Function):
    """The low-rank v2 cross stack with its hand-written VJP: the forward
    kernel saves f and xv, the backward kernels take them. On CPU tensors
    both are the plain versions, so the CPU tests exercise the formula the
    kernels implement."""

    @staticmethod
    def forward(ctx, x0, u, v, b):
        out, f, xv = cross_v2_fwd(x0, u, v, b, want_saved=True)
        ctx.save_for_backward(x0, u, v, f, xv)
        return out

    @staticmethod
    def backward(ctx, g):
        x0, u, v, f, xv = ctx.saved_tensors
        return cross_v2_bwd(x0, u, v, f, xv, g.contiguous())
