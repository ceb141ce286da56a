"""The port's low-rank DCN-v2 cross stack against the JAX package, on the CPU.

On CPU tensors ``cross_v2_fwd`` and ``cross_v2_bwd`` take their plain
versions; these tests hold them against ``cross_stack_pallas_v2`` (run in
interpret mode, as tests/test_kernels.py runs it), against
``cross_stack_xla`` and its JAX VJP, and against torch autograd, pin the
wrappers' input contract and their width limits, and check the arithmetic
of the kernels' 3xTF32 products, forward and backward, in an emulation. The CUDA kernels are held against
the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfrec_tpu.kernels.cross import cross_stack_xla
from tfrec_tpu.kernels.cross_pallas import cross_stack_pallas_v2
from tfrec_tpu_torch.kernels.cross import cross_stack, cross_stack_ref
from tfrec_tpu_torch.kernels.cross_v2_cuda import (
    CrossV2,
    _bwd_route,
    _fwd_route,
    _smem_bytes,
    _splits,
    _weights_rows,
    cross_v2_bwd,
    cross_v2_bwd_ref,
    cross_v2_fwd,
    cross_v2_fwd_ref,
)

torch.set_num_threads(1)

# (batch, d, r, L): tests/test_kernels.py's two shapes, and one with an odd
# d and r, as the flagship's d = 845.
SHAPES = [(64, 32, 8, 3), (48, 140, 16, 2), (50, 45, 7, 2)]


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(got, want, rtol):
    """Sums in another order: an element's error scales with the terms
    summed, not with the element, so the absolute tolerance is 1e-6 of the
    largest magnitude (the outputs reach ~100 at d=140)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * np.abs(want).max())


def _inputs(seed, batch, dim, rank, layers):
    return (_normal(seed, (batch, dim)), _normal(seed + 1, (layers, dim, rank), 0.2),
            _normal(seed + 2, (layers, dim, rank), 0.2), _normal(seed + 3, (layers, dim), 0.1))


@pytest.mark.parametrize("batch,dim,rank,layers", SHAPES)
def test_cross_v2_fwd_ref_matches_pallas_and_xla(batch, dim, rank, layers):
    x0, u, v, b = _inputs(20, batch, dim, rank, layers)
    jparams = {"u": jnp.asarray(u), "v": jnp.asarray(v), "b": jnp.asarray(b)}
    ref = cross_v2_fwd_ref(*(torch.from_numpy(a) for a in (x0, u, v, b))).numpy()
    # rtol 1e-4 as tests/test_kernels.py: the Pallas kernel sums over the
    # lane-padded d and r, another order than the unpadded products.
    _close(ref, cross_stack_pallas_v2(jnp.asarray(x0), jparams), 1e-4)
    _close(ref, cross_stack_xla(jnp.asarray(x0), jparams), 1e-5)
    # The wrapper, the dispatcher and cross_stack_ref take the same plain
    # version on the CPU; with want_saved it also returns f and xv.
    tparams = {"u": torch.from_numpy(u), "v": torch.from_numpy(v), "b": torch.from_numpy(b)}
    before = cross_v2_fwd.launches
    for fn in (cross_stack, cross_stack_ref):
        np.testing.assert_array_equal(fn(torch.from_numpy(x0), tparams).numpy(), ref)
    out, f, xv = cross_v2_fwd(torch.from_numpy(x0), *tparams.values(), want_saved=True)
    assert cross_v2_fwd.launches == before
    np.testing.assert_array_equal(out.numpy(), ref)
    assert f.shape == (layers, batch, dim) and xv.shape == (layers, batch, rank)
    np.testing.assert_allclose(xv[0].numpy(), x0 @ v[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f[0].numpy(), (x0 @ v[0]) @ u[0].T + b[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch,dim,rank,layers", SHAPES)
def test_cross_v2_bwd_ref_matches_jax_vjp_and_autograd(batch, dim, rank, layers):
    x0, u, v, b = _inputs(30, batch, dim, rank, layers)
    g = _normal(34, (batch, dim))
    tx0, tu, tv, tb, tg = (torch.from_numpy(a) for a in (x0, u, v, b, g))
    _, f, xv = cross_v2_fwd_ref(tx0, tu, tv, tb, want_saved=True)
    got = cross_v2_bwd_ref(tx0, tu, tv, f, xv, tg)
    jparams = {"u": jnp.asarray(u), "v": jnp.asarray(v), "b": jnp.asarray(b)}
    for fn in (cross_stack_pallas_v2, cross_stack_xla):
        _, vjp = jax.vjp(fn, jnp.asarray(x0), jparams)
        jdx0, jgrads = vjp(jnp.asarray(g))
        want = (jdx0, jgrads["u"], jgrads["v"], jgrads["b"])
        for a, e in zip(got, want):
            # The JAX package's own tolerance for its v2 kernel's VJP
            # (tests/test_kernels.py): sums in another order, over the
            # batch and the padded lanes.
            _close(a.numpy(), e, 1e-4)
    # Torch autograd of the plain forward: du, dv and db are batch sums
    # taken in another order, so an element that nearly cancels is held to
    # 1e-6 of the largest magnitude rather than to its own.
    leaves = [t.clone().requires_grad_() for t in (tx0, tu, tv, tb)]
    auto = torch.autograd.grad(cross_v2_fwd_ref(*leaves), leaves, tg)
    for a, e in zip(got, auto):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-6 * e.abs().max().item())
    # The wrapper on CPU tensors and the autograd Function behind
    # cross_stack run the same plain formula and launch nothing.
    before = (cross_v2_fwd.launches, cross_v2_bwd.launches)
    for a, e in zip(cross_v2_bwd(tx0, tu, tv, f, xv, tg), got):
        torch.testing.assert_close(a, e, rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in (tx0, tu, tv, tb)]
    y = cross_stack(leaves[0], {"u": leaves[1], "v": leaves[2], "b": leaves[3]})
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "CrossV2Backward"
    for a, e in zip(torch.autograd.grad(y, leaves, tg), got):
        torch.testing.assert_close(a, e, rtol=0, atol=0)
    assert (cross_v2_fwd.launches, cross_v2_bwd.launches) == before


def test_cross_v2_contract():
    """f32 only, matching shapes, one device, contiguous inputs; cpu or cuda."""
    x0, u, v, b = (torch.from_numpy(a) for a in _inputs(40, 5, 6, 3, 2))
    with pytest.raises(TypeError, match="float32"):
        cross_v2_fwd(x0.double(), u, v, b)
    with pytest.raises(ValueError, match="u and v"):
        cross_v2_fwd(x0, u, v[:, :, :2].contiguous(), b)
    with pytest.raises(ValueError, match=r"b must be \[2, 6\]"):
        cross_v2_fwd(x0, u, v, b[:1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        cross_v2_fwd(x0, u.transpose(1, 2).contiguous().transpose(1, 2), v, b)
    with pytest.raises(ValueError, match="x0 must be"):
        cross_v2_fwd(x0[0].contiguous(), u, v, b)
    with pytest.raises(NotImplementedError, match="cuda or cpu"):
        cross_v2_fwd(*(t.to("meta") for t in (x0, u, v, b)))
    _, f, xv = cross_v2_fwd(x0, u, v, b, want_saved=True)
    with pytest.raises(ValueError, match=r"xv \[2, 5, 3\]"):
        cross_v2_bwd(x0, u, v, f, xv[:, :, :2].contiguous(), x0)
    with pytest.raises(ValueError, match="contiguous"):
        cross_v2_bwd(x0, u, v, f, xv, x0.t().contiguous().t())
    with pytest.raises(NotImplementedError, match="cuda or cpu"):
        cross_v2_bwd(*(t.to("meta") for t in (x0, u, v, f, xv, x0)))
    # No layer: x_L = x0, and the gradient passes through.
    empty = (u[:0].contiguous(), v[:0].contiguous(), b[:0].contiguous())
    assert torch.equal(cross_v2_fwd(x0, *empty), x0)
    out = CrossV2.apply(x0.clone().requires_grad_(), *empty)
    assert torch.equal(out, x0)
    # The least shared memory a block of either kernel takes, at the
    # flagship's shape: 16 rows of the forward's x and xv, or of the row
    # pass's df and t (d = 845 padded to 856 against bank conflicts, r = 64
    # to 72).
    assert _smem_bytes(845, 64) == 16 * (856 + 72) * 4 <= 227 * 1024


def _reach_the_device_check(batch, dim, rank, layers):
    """Both wrappers on meta tensors get past every shape check to the
    device check: no width or depth is refused."""
    x0 = torch.empty((batch, dim), device="meta")
    u = torch.empty((layers, dim, rank), device="meta")
    b = torch.empty((layers, dim), device="meta")
    f = torch.empty((layers, batch, dim), device="meta")
    xv = torch.empty((layers, batch, rank), device="meta")
    for call in (lambda: cross_v2_fwd(x0, u, u, b), lambda: cross_v2_bwd(x0, u, u, f, xv, x0)):
        with pytest.raises(NotImplementedError, match="cuda or cpu"):
            call()


# dcn_criteo's widths as low-rank v2 (r=64) at embed_dim 32, 72 and 128
# (d = 26 e + 13), the widest the tiles take, the first widths past it, and
# embed_dim 160 (d = 4173); at r=128 the widest the tiles take and the next;
# the benchmark's DCN-v2 (d = 3341, r = 512).
@pytest.mark.parametrize("dim,rank", [(845, 64), (1776, 64), (1885, 64), (3341, 64), (3560, 64),
                                      (3561, 64), (3565, 64), (4173, 64), (3496, 128), (3497, 128),
                                      (3341, 512)])
def test_cross_v2_takes_wide_inputs_up_to_its_shared_memory_limit(dim, rank):
    """The kernels' tiles take d while 16 rows of the products' [B, d] and
    [B, r] operands fit 227 KB (d <= 3560 at r=64, 3496 at r=128, 3112 at
    r=512); past that both kernels take the general route. No width is
    refused."""
    limit = {64: 3560, 128: 3496, 512: 3112}[rank]
    assert (_smem_bytes(dim, rank) <= 227 * 1024) == (dim <= limit)
    route = "tiles" if dim <= limit else "general"
    assert _fwd_route(dim, rank) == _bwd_route(dim, rank, 3) == route
    _reach_the_device_check(4, dim, rank, 3)


@pytest.mark.parametrize("layers", [1, 3, 47, 48, 200])
def test_cross_v2_backward_takes_any_depth(layers):
    """The weight pass stages L - 1 layers of f in shared memory up to L =
    47 at 8 rows a stage; past that the backward takes the general route,
    the forward's route does not depend on L. No depth is refused."""
    assert bool(_weights_rows(layers)) == (layers <= 47)
    assert _fwd_route(845, 64) == "tiles"
    assert _bwd_route(845, 64, layers) == ("tiles" if layers <= 47 else "general")
    _reach_the_device_check(4, 845, 64, layers)


# (batch, d, r, slices): the wide phase's general-route shapes (64 tiles
# of the [B, r] product over k = d: 2 slices fill 128 of 132 blocks); a d
# within one slice; a batch of one at the widest d (132 blocks); a rank
# whose tiles alone fill a wave; the benchmark's serving call (128 tiles of
# 132, none) and training step (1024 tiles, none).
@pytest.mark.parametrize("batch,dim,rank,slices", [(8192, 4173, 64, 2), (8192, 3565, 64, 2),
                                                   (8192, 845, 64, 1), (1, 2**31 - 1, 1, 132),
                                                   (8192, 4173, 1024, 1), (4096, 3341, 512, 1),
                                                   (32768, 3341, 512, 1)])
def test_cross_v2_general_route_splits_long_walks_over_d(batch, dim, rank, slices):
    """The general route's x_l V_l and df U_l walk all of d for a [B, r]
    output of few 128 x 128 tiles: where they fill less than a wave of 132
    blocks (one an SM), d splits into slices of at least 1024, as many as
    fill the waves best."""
    assert _splits(batch, dim, rank) == slices


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest, ties
    away from zero, on the bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the backward kernels compute it: each operand split into
    TF32 hi = tf32(x) and lo = tf32(x - hi), and a_lo b_hi + a_hi b_lo +
    a_hi b_hi summed in f32 (the products of two TF32 values are exact)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _tf32(a) @ _tf32(b)


def _fwd_with(mm, x0, u, v, b):
    """cross_v2_fwd_ref(..., want_saved=True) with its two products a layer
    taken by ``mm``."""
    x, fs, xvs = x0, [], []
    for l in range(u.shape[0]):
        xv = mm(x, v[l])
        f = mm(xv, u[l].T) + b[l]
        fs.append(f)
        xvs.append(xv)
        x = x0 * f + x
    return x, torch.stack(fs), torch.stack(xvs)


def _within(got, ref):
    """chip_smoke.py's tolerance, against a float64 reference."""
    atol = 1e-5 * ref.abs().max().item()
    return bool(((got.double() - ref).abs() <= atol + 1e-5 * ref.abs()).all())


def test_3xtf32_forward_keeps_the_f32_tolerance_and_tf32_alone_does_not():
    """At the flagship's width (d=845, r=64, L=3) on 1024 rows, the forward
    with both products a layer taken as 3xTF32, as the forward kernel takes
    them, stays within chip_smoke.py's tolerance (rtol 1e-5, atol 1e-5 x
    max |ref|) of a float64 reference for x_L, f and xv; with plain TF32
    (a_hi b_hi) all three miss it, which is why the kernel splits its
    operands."""
    batch, dim, rank, layers = 1024, 845, 64, 3
    rng = np.random.default_rng(60)
    x0 = torch.from_numpy(rng.normal(size=(batch, dim)).astype(np.float32))
    u, v = (torch.from_numpy((rng.normal(size=(layers, dim, rank)) * dim**-0.5).astype(np.float32))
            for _ in range(2))
    b = torch.from_numpy((0.1 * rng.normal(size=(layers, dim))).astype(np.float32))
    want = cross_v2_fwd_ref(*(t.double() for t in (x0, u, v, b)), want_saved=True)
    split = _fwd_with(_mm_3xtf32, x0, u, v, b)
    assert all(_within(a, e) for a, e in zip(split, want))
    plain = _fwd_with(_mm_1xtf32, x0, u, v, b)
    missed = [name for name, a, e in zip(("x_L", "f", "xv"), plain, want) if not _within(a, e)]
    assert missed == ["x_L", "f", "xv"]


def _bwd_with(mm, x0, u, v, f, xv, g):
    """cross_v2_bwd_ref with its four products a layer taken by ``mm``."""
    layers = u.shape[0]
    xs = [x0]
    for l in range(layers - 1):
        xs.append(x0 * f[l] + xs[-1])
    dx0 = torch.zeros_like(x0)
    du, dv = torch.empty_like(u), torch.empty_like(v)
    db = x0.new_empty((layers, x0.shape[1]))
    for l in range(layers - 1, -1, -1):
        df = g * x0
        db[l] = df.sum(dim=0)
        du[l] = mm(df.T, xv[l])
        t = mm(df, u[l])
        dv[l] = mm(xs[l].T, t)
        dx0 = dx0 + g * f[l]
        g = g + mm(t, v[l].T)
    return dx0 + g, du, dv, db


def test_3xtf32_products_keep_the_f32_tolerance_and_tf32_alone_does_not():
    """At the flagship's width (d=845, r=64, L=3) on 1024 rows, the backward
    with every product taken as 3xTF32 stays within chip_smoke.py's
    tolerance (rtol 1e-5, atol 1e-5 x max |ref|) of a float64 reference for
    dx0, dU, dV and db; with plain TF32 (a_hi b_hi) it does not, which is
    why the kernels split their operands."""
    batch, dim, rank, layers = 1024, 845, 64, 3
    rng = np.random.default_rng(50)
    x0, g = (torch.from_numpy(rng.normal(size=(batch, dim)).astype(np.float32)) for _ in range(2))
    u, v = (torch.from_numpy((rng.normal(size=(layers, dim, rank)) * dim**-0.5).astype(np.float32))
            for _ in range(2))
    b = torch.from_numpy((0.1 * rng.normal(size=(layers, dim))).astype(np.float32))
    _, f, xv = cross_v2_fwd_ref(x0, u, v, b, want_saved=True)
    want = cross_v2_bwd_ref(*(t.double() for t in (x0, u, v, f, xv, g)))
    split = _bwd_with(_mm_3xtf32, x0, u, v, f, xv, g)
    assert all(_within(a, e) for a, e in zip(split, want))
    plain = _bwd_with(_mm_1xtf32, x0, u, v, f, xv, g)
    missed = [name for name, a, e in zip(("dx0", "dU", "dV", "db"), plain, want) if not _within(a, e)]
    # db has no product of its own, but below the top layer its df = g * x0
    # takes g from the products above.
    assert missed == ["dx0", "dU", "dV", "db"]
