#!/usr/bin/env python3
"""Drive tfrec_tpu_torch's serving and training slices on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and nvcc (it builds the kernels from kernels/csrc/), and exits
non-zero if any phase fails:

1. environment: CUDA present; the card's name and power limit; TF32 off;
2. build: nvcc compiles every kernel source into build/tfrec_tpu_torch/,
   one process per source, all started together;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at edge cases, and each repeating bit for bit; the
   duplicate-id combine repeating bit for bit and matching the CPU; then
   the cross kernels at widths past the flagship's (v1 at d=2093, v2 at
   d=1885 and 3341, r=64; B=8192, L=3), each through its kernels (launch
   counters), against its plain version, bit for bit on repeat, with its
   device time beside its bound;
4. serving: ``dcn_criteo`` at Criteo's shape (26 fields of 100 000 rows,
   d=32, 13 dense features, 3 cross layers, MLP 512/256/128) from a seeded
   generator, batches of 8192 through ``Recommender.predict_ctr``; the
   logits must be finite, match the same model run through the plain
   versions on the card and, on a small input, on the CPU; launch counters
   prove the gather and the v1 cross kernels ran, and no other;
5. serving times with CUDA events: each kernel beside its bound, its plain
   version and the one PyTorch call that computes the same function where
   there is one; predict_ctr's latency; a profile of one request batch;
6. training: the same model trained by ``TrainStepBuilder`` on the default
   device (dense Adam, rowwise Adagrad, logloss), ``multi_step`` over
   K = train.steps_per_dispatch batches of 8192 from ``synthetic_ctr``;
   launch counters prove every kernel of the step ran; the loss is finite
   and falls on a held batch; one step repeats bit for bit and matches
   the same step on the CPU (plain versions) from the same state;
7. training times: the backward cross kernel and the Adagrad kernel beside
   their bounds and plain versions, the step's median, a profile of one
   step;
8. phases 4 and 6 again for the same model as low-rank DCN-v2
   (``model.name="dcnv2"``, ``cross_rank=64``: U and V [3, 845, 64]), whose
   cross stack runs the v2 kernels; then their times beside their bounds
   and plain versions (both bounds count their 3xTF32 products on the
   tensor cores) and the backward's time by kernel, predict_ctr's
   latency, the step's median and a profile of one step.

The last lines are the kernels' JSON record and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tfrec_tpu_torch import zoo_configs
from tfrec_tpu_torch.data.synthetic import _zipf_ids, synthetic_ctr
from tfrec_tpu_torch.kernels import _build
from tfrec_tpu_torch.kernels.adagrad_cuda import fused_rowwise_adagrad, fused_rowwise_adagrad_ref
from tfrec_tpu_torch.kernels.cross import cross_stack_ref
from tfrec_tpu_torch.kernels.cross_cuda import (
    cross_v1_bwd,
    cross_v1_bwd_ref,
    cross_v1_fwd,
    cross_v1_fwd_ref,
)
from tfrec_tpu_torch.kernels.cross_v2_cuda import (
    cross_v2_bwd,
    cross_v2_bwd_ref,
    cross_v2_fwd,
    cross_v2_fwd_ref,
)
from tfrec_tpu_torch.kernels.gather_cuda import gather_rows, gather_rows_ref
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.ops.embedding import combine_duplicate_ids
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train.step import TrainStepBuilder, copy_state, tree_leaves

SEED = 0
DEVICE = "cuda"
BATCH = 8192
NUM_BATCHES = 4
V2_RANK = 64  # the DCN-v2 phases' cross_rank
# H100 SXM peaks (NVIDIA data sheet), at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12  # dense, on the tensor cores
# Reordered f32 row dots and products (the v2 kernels sum over d = 845, and
# over 8192 rows for dU, dV and db, in another fixed order than cuBLAS): the
# error scales with the size of the terms, not of the sum, so the absolute
# tolerance is relative to the largest value.
RTOL = 1e-5
ATOL_REL = 1e-5
# Logits add the cross output's error over a head of d + 128 inputs.
LOGIT_TOL = 1e-4
# One train step on the card against the CPU. Every matmul sums in another
# order (cuBLAS against the CPU's BLAS, over a batch of 8192), so the
# gradients are held to 1e-4 of their largest value. A ReLU input that lies
# within that rounding of 0 can fall on the other side on the other device:
# its example's gradient then differs by a finite amount (2 of 8192
# examples in the measured batch). Such flips are found and checked to lie
# within rounding of 0; the rows the flipped examples touch are reported,
# and every other row is held tightly: a table moves by lr * g / rms(g)
# (up to ~0.1), its error is the rounding of g relative to its row.
GRAD_TOL = 1e-4
FLIP_TOL = 10  # a flipped ReLU input is within 10x the largest input error of 0
MAX_FLIPPED = 0.01  # of the batch's examples
TABLE_TOL = 1e-6
ACC_RTOL = 1e-4
LOSS_RTOL = 1e-5

KERNELS = {
    "gather_rows": {
        "source": "tfrec_tpu_torch/kernels/csrc/gather.cu",
        "replaces": "tfrec_tpu/kernels/gather_pallas.py:89",
    },
    "cross_v1_fwd": {
        "source": "tfrec_tpu_torch/kernels/csrc/cross.cu",
        "replaces": "tfrec_tpu/kernels/cross_pallas.py:123",
    },
    "cross_v1_bwd": {
        "source": "tfrec_tpu_torch/kernels/csrc/cross.cu",
        "replaces": "tfrec_tpu/kernels/cross_pallas.py:157",
    },
    "fused_rowwise_adagrad": {
        "source": "tfrec_tpu_torch/kernels/csrc/adagrad.cu",
        "replaces": "tfrec_tpu/kernels/scatter_pallas.py:182",
    },
    "cross_v2_fwd": {
        "source": "tfrec_tpu_torch/kernels/csrc/cross_v2.cu",
        "replaces": "tfrec_tpu/kernels/cross_pallas.py:299",
    },
    "cross_v2_bwd": {
        "source": "tfrec_tpu_torch/kernels/csrc/cross_v2.cu",
        "replaces": "tfrec_tpu/kernels/cross_pallas.py:342",
    },
}
WRAPPERS = {"gather_rows": gather_rows, "cross_v1_fwd": cross_v1_fwd,
            "cross_v1_bwd": cross_v1_bwd, "fused_rowwise_adagrad": fused_rowwise_adagrad,
            "cross_v2_fwd": cross_v2_fwd, "cross_v2_bwd": cross_v2_bwd}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item() if a.numel() else 0.0


def within(got: torch.Tensor, want: torch.Tensor, rtol: float, atol_rel: float) -> bool:
    atol = atol_rel * max(want.abs().max().item(), 1.0)
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _per_call_ms(run, calls: int, reps: int) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(fn, calls: int, reps: int = 7) -> float:
    """Device time per call: ``fn`` (``calls`` calls) is captured once in a
    CUDA graph, and the graph is replayed between two CUDA events, so host
    dispatch does not enter the time. Median over ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture: allocator pools, library handles
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return _per_call_ms(graph.replay, calls, reps)


def dispatch_ms(fn, calls: int, reps: int = 7) -> float:
    """Time per call when the host issues the calls one after another:
    where the device waits for the host, this is the host's cost a call."""
    fn()
    torch.cuda.synchronize()
    return _per_call_ms(fn, calls, reps)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tensor_core_bound_ms(nbytes: float, tf32_ops: float, f32_ops: float) -> tuple[float, str]:
    """The bound of a kernel whose products run on the tensor cores in TF32
    and the rest on the CUDA cores in f32: the operations' times add."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = tf32_ops / TF32_OPS_PER_S + f32_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def v1_fwd_bound(bsz: int, dim: int, layers: int) -> tuple[float, str]:
    """x0 read, x_L written, w and b; a row dot and 3 elementwise steps."""
    return bound_ms(bsz * dim * 4 * 2 + 2 * layers * dim * 4, 5 * layers * bsz * dim)


def v1_bwd_bound(bsz: int, dim: int, layers: int) -> tuple[float, str]:
    """x0 and g read, dx0 written, s, w and b read, dw and db written."""
    return bound_ms(3 * bsz * dim * 4 + bsz * layers * 4 + 4 * layers * dim * 4, 12 * layers * bsz * dim)


def v2_fwd_bound(bsz: int, dim: int, rank: int, layers: int, saved: bool) -> tuple[float, str]:
    """x0 read, x_L written, U, V and b read (and, when training, f and xv
    written); per layer two products, each 3xTF32 on the tensor cores
    (three TF32 products for one f32 product), and 3 elementwise operations
    an element (f + b, x0 * f, + x) on the CUDA cores."""
    nbytes = (2 * bsz * dim + 2 * layers * dim * rank + layers * dim) * 4
    if saved:
        nbytes += layers * (bsz * dim + bsz * rank) * 4
    return tensor_core_bound_ms(nbytes, 3 * layers * 4 * bsz * dim * rank, layers * 3 * bsz * dim)


def v2_bwd_bound(bsz: int, dim: int, rank: int, layers: int) -> tuple[float, str]:
    """In: x0, g, f, xv, U, V; out: dx0, dU, dV, db. Per layer: 4 products,
    each 3xTF32 on the tensor cores, and ~7 elementwise operations an
    element (df, db, g*f, dx0, g, x_l) on the CUDA cores."""
    nbytes = ((2 + layers) * bsz * dim + layers * bsz * rank + 2 * layers * dim * rank
              + bsz * dim + 2 * layers * dim * rank + layers * dim) * 4
    return tensor_core_bound_ms(nbytes, 3 * layers * 8 * bsz * dim * rank, layers * 7 * bsz * dim)


def kernel_times_us(fn) -> dict:
    """Device time by kernel name over one call of ``fn`` (the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def edge_case_ids(rng, vocab: int, n: int) -> np.ndarray:
    """Real ids with duplicates, negatives and sentinels (>= vocab)."""
    ids = rng.integers(0, vocab, n).astype(np.int32)
    ids[:8] = [vocab, vocab + 3, -1, -7, 0, vocab - 1, 5, 5]
    return ids


def make_requests(rng, vocabs, num_dense: int):
    """Seeded request batches; ~0.5% sentinel and ~0.5% negative ids."""
    out = []
    for _ in range(NUM_BATCHES):
        dense = rng.normal(size=(BATCH, num_dense)).astype(np.float32)
        cat = np.stack([rng.integers(0, v, BATCH) for v in vocabs], 1).astype(np.int32)
        flip = rng.random(cat.shape)
        cat[flip < 0.005] = np.array(vocabs, np.int32)[np.nonzero(flip < 0.005)[1]]
        cat[(flip >= 0.005) & (flip < 0.01)] = -1
        out.append((dense, cat))
    return out


def plain_predict_ctr(model, params, dense, cat) -> torch.Tensor:
    """The same model through the kernels' plain versions on the card."""
    batch = {"dense": torch.from_numpy(dense).to(DEVICE), "cat": torch.from_numpy(cat).to(DEVICE)}
    gathered = {k: gather_rows_ref(params["tables"][k], ids)
                for k, ids in model.lookup_ids(batch).items()}
    x0 = model.flat_input(gathered, batch)
    return model.head(params["dense"], x0, cross_stack_ref(x0, params["dense"]["cross"]))


def phase_environment() -> None:
    check(torch.cuda.is_available(), "CUDA is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")


def phase_build() -> None:
    secs = _build.build()
    print(f"build: {secs:.2f} s for {', '.join(_build.sources())} "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")


def phase_kernels(rng) -> dict:
    """Each kernel against its plain version; returns the max errors."""
    errs = {"gather_rows": 0.0, "cross_v1_fwd": 0.0}
    vocab = 100_000
    for dim in (8, 13, 32, 128):
        table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32)).to(DEVICE)
        ids = torch.from_numpy(edge_case_ids(rng, vocab, BATCH)).to(DEVICE)
        got, want = gather_rows(table, ids), gather_rows_ref(table, ids)
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(f"gather_rows D={dim}: max_abs_err {err} bitwise {torch.equal(got, want)}")
        check(torch.equal(got, want), f"gather_rows D={dim} is bitwise the plain version")
        errs["gather_rows"] = max(errs["gather_rows"], err)
    dim, layers = 26 * 32 + 13, 3
    for batch in (BATCH, 1000):
        x0 = torch.from_numpy(rng.normal(size=(batch, dim)).astype(np.float32)).to(DEVICE)
        w = torch.from_numpy((rng.normal(size=(layers, dim)) / dim**0.5).astype(np.float32)).to(DEVICE)
        b = torch.from_numpy((0.1 * rng.normal(size=(layers, dim))).astype(np.float32)).to(DEVICE)
        got, want = cross_v1_fwd(x0, w, b), cross_v1_fwd_ref(x0, w, b)
        again = cross_v1_fwd(x0, w, b)
        torch.cuda.synchronize()
        err = max_err(got, want)
        print(f"cross_v1_fwd B={batch} d={dim} L={layers}: max_abs_err {err:.3e} "
              f"(max |ref| {want.abs().max().item():.3e}, rtol {RTOL}, atol {ATOL_REL} x max|ref|)")
        check(within(got, want, RTOL, ATOL_REL), f"cross_v1_fwd B={batch} within tolerance")
        check(torch.equal(got, again), f"cross_v1_fwd B={batch} repeats bit for bit")
        errs["cross_v1_fwd"] = max(errs["cross_v1_fwd"], err)
    errs["cross_v1_bwd"] = check_cross_v1_bwd(rng, dim, layers)
    errs["fused_rowwise_adagrad"] = check_adagrad(rng)
    errs["cross_v2_fwd"], errs["cross_v2_bwd"] = check_cross_v2(rng, dim, layers)
    return errs


def check_cross_v2(rng, dim: int, layers: int) -> tuple[float, float]:
    """Both v2 kernels against their plain versions, at the v2 path's shape
    (B=8192, d=845, r=64, L=3), on a ragged tile (B=1000) and at an odd
    small shape; the forward's saved f and xv too; each repeating bit for
    bit. The backward takes the forward kernel's f and xv, as in training."""
    worst_f = worst_b = 0.0
    for batch, d, rank, nl in ((BATCH, dim, V2_RANK, layers), (1000, dim, V2_RANK, layers),
                               (257, 13, 7, 1)):
        def normal(shape, scale):
            return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to(DEVICE)

        x0, g = normal((batch, d), 1.0), normal((batch, d), 1.0)
        u, v = normal((nl, d, rank), d**-0.5), normal((nl, d, rank), d**-0.5)
        b = normal((nl, d), 0.1)
        got = cross_v2_fwd(x0, u, v, b)
        out, f, xv = cross_v2_fwd(x0, u, v, b, want_saved=True)
        want, f_ref, xv_ref = cross_v2_fwd_ref(x0, u, v, b, want_saved=True)
        again = cross_v2_fwd(x0, u, v, b)
        grads = cross_v2_bwd(x0, u, v, f, xv, g)
        grads_ref = cross_v2_bwd_ref(x0, u, v, f, xv, g)
        grads_again = cross_v2_bwd(x0, u, v, f, xv, g)
        torch.cuda.synchronize()
        shape = f"B={batch} d={d} r={rank} L={nl}"
        for name, a, e in (("x_L", got, want), ("f", f, f_ref), ("xv", xv, xv_ref)):
            err = max_err(a, e)
            print(f"cross_v2_fwd {shape} {name}: max_abs_err {err:.3e} (max |ref| "
                  f"{e.abs().max().item():.3e}, rtol {RTOL}, atol {ATOL_REL} x max|ref|)")
            check(within(a, e, RTOL, ATOL_REL), f"cross_v2_fwd {shape} {name} within tolerance")
            worst_f = max(worst_f, err)
        check(torch.equal(got, again) and torch.equal(got, out), f"cross_v2_fwd {shape} repeats bit for bit")
        for name, a, e, r in zip(("dx0", "du", "dv", "db"), grads, grads_ref, grads_again):
            err = max_err(a, e)
            print(f"cross_v2_bwd {shape} {name}: max_abs_err {err:.3e} (max |ref| "
                  f"{e.abs().max().item():.3e}, rtol {RTOL}, atol {ATOL_REL} x max|ref|)")
            check(within(a, e, RTOL, ATOL_REL), f"cross_v2_bwd {shape} {name} within tolerance")
            check(torch.equal(a, r), f"cross_v2_bwd {shape} {name} repeats bit for bit")
            worst_b = max(worst_b, err)
    return worst_f, worst_b


def check_cross_v1_bwd(rng, dim: int, layers: int) -> float:
    """The backward kernel against its plain version, given the same s from
    the forward kernel; each output held to the forward's tolerance."""
    worst = 0.0
    for batch in (BATCH, 1000):
        x0 = torch.from_numpy(rng.normal(size=(batch, dim)).astype(np.float32)).to(DEVICE)
        g = torch.from_numpy(rng.normal(size=(batch, dim)).astype(np.float32)).to(DEVICE)
        w = torch.from_numpy((rng.normal(size=(layers, dim)) / dim**0.5).astype(np.float32)).to(DEVICE)
        b = torch.from_numpy((0.1 * rng.normal(size=(layers, dim))).astype(np.float32)).to(DEVICE)
        _, s = cross_v1_fwd(x0, w, b, want_s=True)
        got = cross_v1_bwd(x0, w, b, s, g)
        want = cross_v1_bwd_ref(x0, w, b, g, s)
        again = cross_v1_bwd(x0, w, b, s, g)
        torch.cuda.synchronize()
        for name, a, e, r in zip(("dx0", "dw", "db"), got, want, again):
            err = max_err(a, e)
            print(f"cross_v1_bwd B={batch} d={dim} L={layers} {name}: max_abs_err {err:.3e} "
                  f"(max |ref| {e.abs().max().item():.3e}, rtol {RTOL}, atol {ATOL_REL} x max|ref|)")
            check(within(a, e, RTOL, ATOL_REL), f"cross_v1_bwd B={batch} {name} within tolerance")
            check(torch.equal(a, r), f"cross_v1_bwd B={batch} {name} repeats bit for bit")
            worst = max(worst, err)
    return worst


def counted(wrapper, fn):
    """fn()'s result, checking that it launched ``wrapper``'s kernel once."""
    before = wrapper.launches
    out = fn()
    check(wrapper.launches == before + 1, f"{wrapper.__name__} launched its kernel")
    return out


def phase_wide() -> None:
    """The cross kernels past the flagship's width, where the reference's
    ``cross_stack`` still computes: ``dcn_criteo`` with embed_dim 80 as
    DCN-v1 (d = 26 * 80 + 13 = 2093), and as low-rank DCN-v2 (r=64) with
    embed_dim 72 and 128 (d = 1885 and 3341). Each kernel runs on the card
    (its launch counter moves), is held to its plain version at the same
    tolerances as at the flagship's width and repeats bit for bit; its
    device time is printed beside its bound and its plain version's."""
    layers = 3
    rng = np.random.default_rng(SEED + 1)  # its own, so the main paths' inputs do not depend on it

    def normal(shape, scale):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to(DEVICE)

    def hold(name, got, want, again):
        for part, a, e, r in zip(name.split(","), got, want, again):
            print(f"  {part}: max_abs_err {max_err(a, e):.3e} (max |ref| {e.abs().max().item():.3e}), "
                  f"bitwise on repeat {torch.equal(a, r)}")
            check(within(a, e, RTOL, ATOL_REL), f"wide {part} within tolerance")
            check(torch.equal(a, r), f"wide {part} repeats bit for bit")

    dim = 26 * 80 + 13
    x0, g = normal((BATCH, dim), 1.0), normal((BATCH, dim), 1.0)
    w, b = normal((layers, dim), dim**-0.5), normal((layers, dim), 0.1)
    print(f"wide: cross_v1 B={BATCH} d={dim} L={layers}")
    out, s = counted(cross_v1_fwd, lambda: cross_v1_fwd(x0, w, b, want_s=True))
    want, s_ref = cross_v1_fwd_ref(x0, w, b, want_s=True)
    hold("x_L,s", (out, s), (want, s_ref), cross_v1_fwd(x0, w, b, want_s=True))
    grads = counted(cross_v1_bwd, lambda: cross_v1_bwd(x0, w, b, s, g))
    hold("dx0,dw,db", grads, cross_v1_bwd_ref(x0, w, b, g, s), cross_v1_bwd(x0, w, b, s, g))
    f_ms = device_ms(lambda: cross_v1_fwd(x0, w, b), 1)
    f_plain = device_ms(lambda: cross_v1_fwd_ref(x0, w, b), 1)
    b_ms = device_ms(lambda: cross_v1_bwd(x0, w, b, s, g), 1)
    b_plain = device_ms(lambda: cross_v1_bwd_ref(x0, w, b, g, s), 1)
    (fb, fby), (bb, bby) = v1_fwd_bound(BATCH, dim, layers), v1_bwd_bound(BATCH, dim, layers)
    print(f"  cross_v1_fwd {f_ms:.4f} ms (bound {fb:.4f} ms, {fby}; plain {f_plain:.4f} ms), "
          f"cross_v1_bwd {b_ms:.4f} ms (bound {bb:.4f} ms, {bby}; plain {b_plain:.4f} ms) "
          f"[device time, CUDA graph]")
    for dim in (26 * 72 + 13, 26 * 128 + 13):
        x0, g = normal((BATCH, dim), 1.0), normal((BATCH, dim), 1.0)
        u, v = normal((layers, dim, V2_RANK), dim**-0.5), normal((layers, dim, V2_RANK), dim**-0.5)
        b = normal((layers, dim), 0.1)
        print(f"wide: cross_v2 B={BATCH} d={dim} r={V2_RANK} L={layers}")
        saved = counted(cross_v2_fwd, lambda: cross_v2_fwd(x0, u, v, b, want_saved=True))
        want = cross_v2_fwd_ref(x0, u, v, b, want_saved=True)
        hold("x_L,f,xv", saved, want, cross_v2_fwd(x0, u, v, b, want_saved=True))
        check(torch.equal(cross_v2_fwd(x0, u, v, b), saved[0]), "wide: serving x_L equals training's")
        _, f, xv = saved
        grads = counted(cross_v2_bwd, lambda: cross_v2_bwd(x0, u, v, f, xv, g))
        hold("dx0,du,dv,db", grads, cross_v2_bwd_ref(x0, u, v, f, xv, g), cross_v2_bwd(x0, u, v, f, xv, g))
        f_ms = device_ms(lambda: cross_v2_fwd(x0, u, v, b), 1)
        ft_ms = device_ms(lambda: cross_v2_fwd(x0, u, v, b, want_saved=True), 1)
        b_ms = device_ms(lambda: cross_v2_bwd(x0, u, v, f, xv, g), 1)
        f_plain = device_ms(lambda: cross_v2_fwd_ref(x0, u, v, b), 1)
        ft_plain = device_ms(lambda: cross_v2_fwd_ref(x0, u, v, b, want_saved=True), 1)
        b_plain = device_ms(lambda: cross_v2_bwd_ref(x0, u, v, f, xv, g), 1)
        (fb, fby), (ftb, ftby) = (v2_fwd_bound(BATCH, dim, V2_RANK, layers, saved=t) for t in (False, True))
        bb, bby = v2_bwd_bound(BATCH, dim, V2_RANK, layers)
        print(f"  cross_v2_fwd {f_ms:.4f} ms (bound {fb:.4f} ms, {fby}; plain {f_plain:.4f} ms), "
              f"saving f and xv {ft_ms:.4f} ms (bound {ftb:.4f} ms, {ftby}; plain {ft_plain:.4f} ms), "
              f"cross_v2_bwd {b_ms:.4f} ms (bound {bb:.4f} ms, {bby}; plain {b_plain:.4f} ms) "
              f"[device time, CUDA graph]")


def adagrad_ids(rng, vocab: int, n: int) -> np.ndarray:
    """Zipf(1.2) ids, as the training data has them (many duplicates), kept
    off rows 0 and vocab-1, where a clamped negative or sentinel id would
    land; then ~1% negative ids and ~1% sentinels (vocab and beyond)."""
    ids = _zipf_ids(rng, vocab, n).astype(np.int32)
    ids = np.clip(ids, 1, vocab - 2)
    flip = rng.random(n)
    ids[flip < 0.01] = vocab + (ids[flip < 0.01] % 3)
    ids[(flip >= 0.01) & (flip < 0.02)] = -1 - (ids[(flip >= 0.01) & (flip < 0.02)] % 5)
    return ids


def check_adagrad(rng) -> float:
    """The duplicate combine (bit for bit on repeat; equal to the CPU's) and
    the fused Adagrad kernel against its plain version, at one field of the
    training path: table [100000, 32], 8192 ids."""
    vocab, dim, lr = 100_000, 32, 0.02
    table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32) / dim**0.5).to(DEVICE)
    acc = torch.from_numpy(rng.uniform(0.0, 0.1, vocab).astype(np.float32)).to(DEVICE)
    ids_np = adagrad_ids(rng, vocab, BATCH)
    grads_np = (1e-3 * rng.normal(size=(BATCH, dim))).astype(np.float32)
    ids, grads = torch.from_numpy(ids_np).to(DEVICE), torch.from_numpy(grads_np).to(DEVICE)

    uids, g = combine_duplicate_ids(ids, grads, sentinel=vocab)
    uids2, g2 = combine_duplicate_ids(ids, grads, sentinel=vocab)
    cpu_u, cpu_g = combine_duplicate_ids(torch.from_numpy(ids_np), torch.from_numpy(grads_np), vocab)
    torch.cuda.synchronize()
    check(torch.equal(uids, uids2) and torch.equal(g, g2), "combine_duplicate_ids repeats bit for bit")
    check(torch.equal(uids.cpu(), cpu_u), "combine_duplicate_ids: uids equal the CPU's")
    comb_err = max_err(g.cpu(), cpu_g)
    check(within(g.cpu(), cpu_g, 1e-6, 1e-6), "combine_duplicate_ids: sums match the CPU's")
    distinct = int((uids < vocab).sum().item())
    print(f"combine_duplicate_ids [{BATCH}] ids, {distinct} distinct real: repeats bit for bit, "
          f"max_abs_err vs CPU {comb_err:.3e}, bitwise {torch.equal(g.cpu(), cpu_g)}")

    t_k, a_k = table.clone(), acc.clone()
    out = fused_rowwise_adagrad(t_k, a_k, uids, g, lr)
    t_r, a_r = fused_rowwise_adagrad_ref(table.clone(), acc.clone(), uids, g, lr)
    t_2, a_2 = fused_rowwise_adagrad(table.clone(), acc.clone(), uids, g, lr)
    torch.cuda.synchronize()
    check(out[0] is t_k and out[1] is a_k, "fused_rowwise_adagrad updates in place")
    err = max(max_err(t_k, t_r), max_err(a_k, a_r))
    print(f"fused_rowwise_adagrad [{vocab}, {dim}], {BATCH} slots: max_abs_err table "
          f"{max_err(t_k, t_r):.3e} acc {max_err(a_k, a_r):.3e} (rtol {RTOL}, atol {ATOL_REL} x max|ref|), "
          f"bitwise table {torch.equal(t_k, t_r)} acc {torch.equal(a_k, a_r)}")
    check(within(t_k, t_r, RTOL, ATOL_REL) and within(a_k, a_r, RTOL, ATOL_REL),
          "fused_rowwise_adagrad within tolerance")
    check(torch.equal(t_k, t_2) and torch.equal(a_k, a_2), "fused_rowwise_adagrad repeats bit for bit")
    touched = torch.zeros(vocab, dtype=torch.bool, device=DEVICE)
    touched[uids[uids < vocab].long()] = True
    check(not bool(touched[0]) and not bool(touched[vocab - 1]), "rows 0 and V-1 are not real ids here")
    check(torch.equal(t_k[~touched], table[~touched]) and torch.equal(a_k[~touched], acc[~touched]),
          "untouched rows (incl. 0 and V-1, where clamped negatives and sentinels would land) unchanged")
    check(bool((t_k[touched] != table[touched]).any(dim=1).all()), "every real id's row moved")
    return err


def configs() -> dict:
    """The two configurations the main paths run: ``dcn_criteo`` at Criteo's
    shape (the data is synthetic), as DCN-v1 and as low-rank DCN-v2."""
    v1 = zoo_configs.dcn_criteo(path="criteo")
    v2 = dataclasses.replace(v1, model=dataclasses.replace(v1.model, name="dcnv2", cross_rank=V2_RANK))
    return {"v1": v1, "v2": v2}


def cross_kernels(cfg) -> tuple[str, str]:
    """The forward and backward cross kernels of ``cfg``'s model."""
    return ("cross_v2_fwd", "cross_v2_bwd") if cfg.model.name == "dcnv2" else ("cross_v1_fwd", "cross_v1_bwd")


def reset_launches() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in WRAPPERS.items()}


def phase_main_path(rng, cfg):
    vocabs = tuple(cfg.data.categorical_vocab_sizes)
    spec = DataSpec.ctr(vocabs, cfg.data.num_dense_features)
    model = build_model(cfg.model, spec)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    table_mb = sum(t.numel() * t.element_size() for t in params["tables"].values()) / 1e6
    cross_shapes = {k: tuple(t.shape) for k, t in params["dense"]["cross"].items()}
    print(f"model: dcn_criteo as {cfg.model.name} (cross_rank {cfg.model.cross_rank}), "
          f"{len(vocabs)} fields x {vocabs[0]} rows, d={cfg.model.embed_dim}, "
          f"input_dim {model.input_dim}, {cfg.model.num_cross_layers} cross layers {cross_shapes}, "
          f"MLP {cfg.model.mlp_dims}; tables {table_mb:.1f} MB")
    rec = Recommender(model, params)  # the default device, the card
    requests = make_requests(rng, vocabs, cfg.data.num_dense_features)

    reset_launches()
    logits = [rec.predict_ctr(dense, cat) for dense, cat in requests]
    torch.cuda.synchronize()
    launches = read_launches()
    fwd = cross_kernels(cfg)[0]
    print(f"main path ({cfg.model.name} serving): {NUM_BATCHES} batches of {BATCH}, launches {launches}")
    check(launches["gather_rows"] == len(vocabs) * NUM_BATCHES, "gather_rows ran once per field per batch")
    check(launches[fwd] == NUM_BATCHES, f"{fwd} ran once per batch")
    check(all(c == 0 for name, c in launches.items() if name not in ("gather_rows", fwd)),
          "serving launched no other kernel")

    logit_err = 0.0
    for (dense, cat), got in zip(requests, logits):
        check(got.shape == (BATCH,) and got.dtype == np.float32, f"logits are [{BATCH}] float32")
        check(bool(np.isfinite(got).all()), "logits are finite")
        want = plain_predict_ctr(model, rec.params, dense, cat)
        got_t = torch.from_numpy(got).to(DEVICE)
        check(within(got_t, want, LOGIT_TOL, LOGIT_TOL), "logits match the plain versions on the card")
        logit_err = max(logit_err, max_err(got_t, want))
    n_small = 256
    params_cpu = {"tables": {k: v.cpu() for k, v in params["tables"].items()},
                  "dense": params["dense"]}
    cpu = Recommender(model, params_cpu, device="cpu")
    want_cpu = torch.from_numpy(cpu.predict_ctr(requests[0][0][:n_small], requests[0][1][:n_small]))
    cpu_err = max_err(torch.from_numpy(logits[0][:n_small]), want_cpu)
    check(within(torch.from_numpy(logits[0][:n_small]), want_cpu, LOGIT_TOL, LOGIT_TOL),
          "card logits match the CPU plain path on a small input")
    print(f"logits: finite, max_abs_err vs plain on card {logit_err:.3e}, vs CPU "
          f"({n_small} rows) {cpu_err:.3e}, tolerance rtol {LOGIT_TOL} atol {LOGIT_TOL} x max|ref|")
    return model, rec, requests, launches


def phase_times(model, rec, requests, errs) -> list:
    dense, cat = requests[0]
    batch = {"dense": torch.from_numpy(dense).to(DEVICE), "cat": torch.from_numpy(cat).to(DEVICE)}
    ids = model.lookup_ids(batch)
    tables = rec.params["tables"]
    pairs = [(tables[k], ids[k]) for k in ids]
    clamped = [(t, i.clamp(0, t.shape[0] - 1)) for t, i in pairs]
    f = len(pairs)
    # One rep gathers every field once: 26 tables, 333 MB, so L2 is cold.
    g_ms = device_ms(lambda: [gather_rows(t, i) for t, i in pairs], f)
    g_plain = device_ms(lambda: [gather_rows_ref(t, i) for t, i in pairs], f)
    g_lib = device_ms(lambda: [torch.index_select(t, 0, i) for t, i in clamped], f)
    g_host = dispatch_ms(lambda: [gather_rows(t, i) for t, i in pairs], f)
    g_host_lib = dispatch_ms(lambda: [torch.index_select(t, 0, i) for t, i in clamped], f)
    n, d = pairs[0][1].shape[0], pairs[0][0].shape[1]
    g_bound, g_by = bound_ms(n * d * 4 * 2 + n * 4, 0)

    gathered = {k: gather_rows(tables[k], v) for k, v in ids.items()}
    x0s = [model.flat_input(gathered, batch)]
    x0s += [torch.randn_like(x0s[0]) for _ in range(2)]  # 3 x 27.7 MB rotate past L2
    cross = rec.params["dense"]["cross"]
    w, b = cross["w"], cross["b"]
    c_ms = device_ms(lambda: [cross_v1_fwd(x, w, b) for x in x0s], len(x0s))
    c_plain = device_ms(lambda: [cross_v1_fwd_ref(x, w, b) for x in x0s], len(x0s))
    bsz, dim = x0s[0].shape
    layers = w.shape[0]
    c_bound, c_by = v1_fwd_bound(bsz, dim, layers)

    lat = []
    for _ in range(11):
        t0 = time.perf_counter()
        rec.predict_ctr(dense, cat)
        lat.append((time.perf_counter() - t0) * 1e3)
    print(f"gather_rows [{tables['field_0'].shape[0]}, {d}] x {n} ids: kernel {g_ms:.4f} ms, "
          f"plain {g_plain:.4f} ms, index_select {g_lib:.4f} ms, bound {g_bound:.4f} ms ({g_by}) "
          f"[device time, CUDA graph]; issued eagerly {g_host:.4f} ms a call, "
          f"index_select {g_host_lib:.4f} ms")
    print(f"cross_v1_fwd [{bsz}, {dim}] L={layers}: kernel {c_ms:.4f} ms, plain {c_plain:.4f} ms, "
          f"bound {c_bound:.4f} ms ({c_by}) [device time, CUDA graph]")
    latency = statistics.median(lat[1:])
    print(f"predict_ctr batch {BATCH} (host clock, request copy and logits included): "
          f"median {latency:.3f} ms over {len(lat) - 1} calls")
    profile(lambda: rec.predict_ctr(dense, cat), "predict_ctr", latency)
    return [
        {"name": "gather_rows", "route": "cuda", "max_abs_err": errs["gather_rows"], "ms": g_ms,
         "plain_ms": g_plain, "bound_ms": g_bound, "bound_by": g_by, "library_ms": g_lib},
        {"name": "cross_v1_fwd", "route": "cuda", "max_abs_err": errs["cross_v1_fwd"], "ms": c_ms,
         "plain_ms": c_plain, "bound_ms": c_bound, "bound_by": c_by, "library_ms": None},
    ]


def profile(fn, what: str, latency_ms: float) -> None:
    """Device time by kernel and copy over one call of ``fn``, and the
    device's busy share of the unprofiled median latency."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        print("profile: the profiler recorded no device time")
        return
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"profile of one {what}: device busy {busy_us:.1f} us = "
          f"{100 * busy_us / (latency_ms * 1e3):.1f}% of the median latency, "
          f"{sum(e.count for e in events)} kernels and copies")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total:9.1f} us  x{e.count:<3d} {e.key[:100]}")


def to_device(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)


def held_loss(builder, state, batch) -> float:
    """The loss of ``state`` on ``batch``, without gradients (the forward
    kernels only)."""
    with torch.no_grad():
        gathered, _ = builder.lookup(state["tables"], builder.model.lookup_ids(batch))
        return builder.loss_fn(builder.model(state["dense"], gathered, batch), batch).item()


def phase_train(cfg):
    """Train ``cfg``'s model at Criteo's shape on the default device: one
    multi_step of K batches, counted; then the loss, repeat and CPU checks."""
    vocabs = tuple(cfg.data.categorical_vocab_sizes)
    model = build_model(cfg.model, DataSpec.ctr(vocabs, cfg.data.num_dense_features))
    builder = TrainStepBuilder(model, cfg.train.loss, cfg.optim)  # the default device, the card
    check(builder.device.type == "cuda", "TrainStepBuilder defaults to the card")
    state = builder.init_state(torch.Generator(device=DEVICE).manual_seed(SEED))
    k = cfg.train.steps_per_dispatch
    t0 = time.perf_counter()
    dense, cat, label = synthetic_ctr((k + 1) * BATCH, cfg.data.num_dense_features, vocabs,
                                      seed=SEED + 1)
    n = k * BATCH
    batches = {"dense": to_device(dense[:n].reshape(k, BATCH, -1)),
               "cat": to_device(cat[:n].reshape(k, BATCH, -1)),
               "label": to_device(label[:n].reshape(k, BATCH))}
    held = {"dense": to_device(dense[n:]), "cat": to_device(cat[n:]), "label": to_device(label[n:])}
    print(f"train: dcn_criteo as {cfg.model.name}, {cfg.optim.dense_optimizer} dense lr {cfg.optim.learning_rate}, "
          f"{cfg.optim.sparse_optimizer} lr {cfg.optim.sparse_learning_rate}, {cfg.train.loss}; "
          f"multi_step K={k} x {BATCH} from synthetic_ctr (made in {time.perf_counter() - t0:.1f} s) "
          f"and a held batch of {BATCH}")
    start = copy_state(state)
    before = held_loss(builder, state, held)

    reset_launches()
    state, metrics = builder.multi_step(state, batches)
    torch.cuda.synchronize()
    launches = read_launches()
    expected = dict.fromkeys(WRAPPERS, 0)
    expected.update(dict.fromkeys(cross_kernels(cfg), 1))
    expected["gather_rows"] = expected["fused_rowwise_adagrad"] = len(vocabs)
    print(f"train main path ({cfg.model.name}): {k} steps, launches {launches}, per step "
          f"{ {name: c / k for name, c in launches.items()} }")
    for name, per_step in expected.items():
        check(launches[name] == per_step * k, f"{name} ran {per_step} times a step")

    after = held_loss(builder, state, held)
    loss_mean = metrics["loss_mean"].item()
    print(f"train loss: mean over the {k} steps {loss_mean:.6f}, last {metrics['loss'].item():.6f}; "
          f"held batch {before:.6f} -> {after:.6f}")
    check(bool(np.isfinite([loss_mean, metrics["loss"].item(), after]).all()), "the loss is finite")
    check(after < before, "the loss on the held batch falls")
    check(state["step"] == k, "the state counts K steps")
    check_step(builder, start, {name: v[0] for name, v in batches.items()}, cfg.train.loss)
    return builder, state, batches, launches


def relu_inputs(builder, state, batch) -> list:
    """The inputs of the deep tower's ReLUs, [B, width] a layer, on the CPU."""
    with torch.no_grad():
        gathered, _ = builder.lookup(state["tables"], builder.model.lookup_ids(batch))
        h = builder.model.flat_input(gathered, batch)
        out = []
        for w, b in state["dense"]["mlp"]:
            pre = h @ w + b
            out.append(pre.cpu())
            h = torch.relu(pre)
        return out


def check_step(builder, start, batch, loss: str) -> None:
    """One step from ``start`` repeats bit for bit on the card, and matches
    the same step on the CPU (the kernels' plain versions): the loss, the
    gradients of the dense leaves and of the gathered rows, and the tables
    and accumulators after the update, apart from the rows of examples
    whose ReLU flipped (see GRAD_TOL). Adam's first update is not compared:
    its size is lr whatever the gradient, so a near-zero gradient flips it."""
    one, m_one = builder.step(copy_state(start), batch)
    two, m_two = builder.step(copy_state(start), batch)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(tree_leaves(one), tree_leaves(two)))
    check(same and torch.equal(m_one["loss"], m_two["loss"]), "one train step repeats bit for bit")

    cpu = TrainStepBuilder(builder.model, loss, builder.optim_cfg, device="cpu")
    cpu_start = copy_state(start, "cpu")
    cpu_batch = {name: v.cpu() for name, v in batch.items()}
    t0 = time.perf_counter()
    flipped = torch.zeros(cpu_batch["label"].shape[0], dtype=torch.bool)
    flip_ok = True
    for got, want in zip(relu_inputs(builder, start, batch), relu_inputs(cpu, cpu_start, cpu_batch)):
        flips = (got > 0) != (want > 0)
        flipped |= flips.any(dim=1)
        if flips.any():
            flip_ok &= want[flips].abs().max().item() <= FLIP_TOL * max_err(got, want)
    n_flipped = int(flipped.sum())

    loss_c, dense_c, rows_c, ids = cpu.loss_and_grads(cpu_start, cpu_batch)
    loss_g, dense_g, rows_g, _ = builder.loss_and_grads(start, batch)
    after_c, _ = cpu.step(cpu_start, cpu_batch)
    errs = {"loss": abs(loss_g.item() - loss_c.item())}
    dense_pairs = [(a.cpu(), e) for a, e in zip(tree_leaves(dense_g), tree_leaves(dense_c))]
    row_pairs = [(rows_g[name].cpu()[~flipped], rows_c[name][~flipped]) for name in rows_c]
    errs["dense grads"] = max(max_err(a, e) for a, e in dense_pairs)
    errs["row grads"] = max(max_err(a, e) for a, e in row_pairs)
    table_ok, acc_ok, flipped_rows, flipped_err = True, True, 0, 0.0
    errs["tables"] = errs["acc (relative)"] = 0.0
    for name, field_ids in ids.items():
        vocab = after_c["tables"][name].shape[0]
        t_g, t_c = one["tables"][name].cpu(), after_c["tables"][name]
        a_g, a_c = one["sparse_opt"][name]["acc"].cpu(), after_c["sparse_opt"][name]["acc"]
        real = field_ids[(field_ids >= 0) & (field_ids < vocab)].long()
        touched = torch.zeros(vocab, dtype=torch.bool)
        touched[real] = True
        by_flip = torch.zeros(vocab, dtype=torch.bool)
        by_flip[field_ids[flipped.repeat_interleave(field_ids.shape[0] // flipped.shape[0])]
                .clamp(0, vocab - 1).long()] = True
        clean = ~by_flip
        flipped_rows += int((by_flip & touched).sum())
        if (by_flip & touched).any():
            flipped_err = max(flipped_err, max_err(t_g[by_flip], t_c[by_flip]))
        errs["tables"] = max(errs["tables"], max_err(t_g[clean], t_c[clean]))
        rel = ((a_g[clean & touched] - a_c[clean & touched]).abs()
               / a_c[clean & touched].clamp_min(1e-30))
        errs["acc (relative)"] = max(errs["acc (relative)"], rel.max().item() if rel.numel() else 0.0)
        table_ok &= within(t_g[clean], t_c[clean], TABLE_TOL, TABLE_TOL)
        acc_ok &= bool((rel <= ACC_RTOL).all()) and torch.equal(a_g[~touched], a_c[~touched])
    print(f"one step: repeats bit for bit on the card; against the CPU ({time.perf_counter() - t0:.1f} s): "
          f"{n_flipped} of {flipped.shape[0]} examples have a ReLU input on the other side of 0 "
          f"(within {FLIP_TOL}x the input error of 0: {flip_ok}), their {flipped_rows} table rows differ "
          f"by up to {flipped_err:.3e}; elsewhere max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (loss rtol {LOSS_RTOL}; grads rtol {GRAD_TOL} atol {GRAD_TOL} x max|ref|; tables rtol "
          f"{TABLE_TOL} atol {TABLE_TOL} x max|ref|; acc rtol {ACC_RTOL})")
    check(flip_ok and n_flipped <= MAX_FLIPPED * flipped.shape[0],
          "ReLU flips between card and CPU are few and within rounding of 0")
    check(errs["loss"] <= LOSS_RTOL * abs(loss_c.item()), "card loss matches the CPU's")
    check(all(within(a, e, GRAD_TOL, GRAD_TOL) for a, e in dense_pairs), "card dense grads match the CPU's")
    check(all(within(a, e, GRAD_TOL, GRAD_TOL) for a, e in row_pairs), "card row grads match the CPU's")
    check(table_ok, "card tables match the CPU's (rows of flipped examples aside)")
    check(acc_ok, "card accumulators match the CPU's (rows of flipped examples aside)")


def phase_train_times(builder, state, batches, errs) -> list:
    model = builder.model
    batch = {name: v[0] for name, v in batches.items()}
    ids = model.lookup_ids(batch)
    _, _, row_grads, _ = builder.loss_and_grads(state, batch)

    # cross_v1_bwd at the step's shapes: x0 from the batch, 3 sets of
    # x0/g/dx0 (3 x 83 MB) rotate past L2.
    gathered, _ = builder.lookup(state["tables"], ids)
    x0 = model.flat_input(gathered, batch)
    cross = state["dense"]["cross"]
    w, b = cross["w"], cross["b"]
    sets = []
    for x in (x0, torch.randn_like(x0), torch.randn_like(x0)):
        sets.append((x, cross_v1_fwd(x, w, b, want_s=True)[1], torch.randn_like(x0)))
    cb_ms = device_ms(lambda: [cross_v1_bwd(x, w, b, s, g) for x, s, g in sets], len(sets))
    cb_plain = device_ms(lambda: [cross_v1_bwd_ref(x, w, b, g, s) for x, s, g in sets], len(sets))
    bsz, dim = x0.shape
    layers = w.shape[0]
    cb_bound, cb_by = v1_bwd_bound(bsz, dim, layers)

    # fused_rowwise_adagrad on the step's combined gradients, one launch a
    # field (26 tables of 12.8 MB: L2 is cold). The plain version syncs on
    # its boolean mask, so it cannot be captured: it is timed eagerly.
    lr = builder.sparse_schedule(state["step"])
    work = []
    for name, field_ids in ids.items():
        table = state["tables"][name]
        uids, g = combine_duplicate_ids(field_ids, row_grads[name], sentinel=table.shape[0])
        work.append((table, state["sparse_opt"][name]["acc"], uids, g))
    f = len(work)
    distinct = [int((u < t.shape[0]).sum().item()) for t, _, u, _ in work]
    n_slots, d = work[0][2].shape[0], work[0][0].shape[1]
    a_ms = device_ms(lambda: [fused_rowwise_adagrad(t, a, u, g, lr) for t, a, u, g in work], f)
    a_eager = dispatch_ms(lambda: [fused_rowwise_adagrad(t, a, u, g, lr) for t, a, u, g in work], f)
    a_plain = dispatch_ms(lambda: [fused_rowwise_adagrad_ref(t, a, u, g, lr) for t, a, u, g in work], f)
    mean_distinct = sum(distinct) / f
    a_bound, a_by = bound_ms(mean_distinct * (3 * d * 4 + 2 * 4) + n_slots * 4, 4 * mean_distinct * d)

    print(f"cross_v1_bwd [{bsz}, {dim}] L={layers}: kernel {cb_ms:.4f} ms, plain {cb_plain:.4f} ms, "
          f"bound {cb_bound:.4f} ms ({cb_by}) [device time, CUDA graph]")
    print(f"fused_rowwise_adagrad [{work[0][0].shape[0]}, {d}], {n_slots} slots, distinct real ids a "
          f"field: mean {mean_distinct:.1f}, min {min(distinct)}, max {max(distinct)}: kernel "
          f"{a_ms:.4f} ms [device time, CUDA graph], {a_eager:.4f} ms issued eagerly; plain "
          f"{a_plain:.4f} ms issued eagerly (its mask syncs); bound {a_bound:.4f} ms ({a_by})")
    step_times(builder, state, batches)
    return [
        {"name": "cross_v1_bwd", "route": "cuda", "max_abs_err": errs["cross_v1_bwd"], "ms": cb_ms,
         "plain_ms": cb_plain, "bound_ms": cb_bound, "bound_by": cb_by, "library_ms": None},
        {"name": "fused_rowwise_adagrad", "route": "cuda", "max_abs_err": errs["fused_rowwise_adagrad"],
         "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound, "bound_by": a_by, "library_ms": None},
    ]


def step_times(builder, state, batches) -> None:
    """The step's median on the host clock (ended by a synchronize), a
    multi_step's time a step, and a profile of one step."""
    batch = {name: v[0] for name, v in batches.items()}
    step_ms = []
    for _ in range(11):
        t0 = time.perf_counter()
        state, _ = builder.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    state, _ = builder.multi_step(state, batches)
    torch.cuda.synchronize()
    k = next(iter(batches.values())).shape[0]
    multi_ms = (time.perf_counter() - t0) * 1e3 / k
    median = statistics.median(step_ms[1:])
    print(f"train step ({builder.model.__class__.__name__}, cross {sorted(state['dense']['cross'])}) "
          f"batch {BATCH} (host clock, batch already on the card): median {median:.3f} ms "
          f"over {len(step_ms) - 1} steps; multi_step K={k}: {multi_ms:.3f} ms a step")
    profile(lambda: builder.step(state, batch), "train step", median)


def phase_v2_times(rec, requests, builder, state, batches, errs) -> list:
    """Both v2 kernels at the v2 path's shapes beside their bounds (bytes at
    3.35 TB/s, or operations: their 3xTF32 products at 495 TFLOP/s plus
    their elementwise steps at 67) and plain versions; the backward's time
    by kernel (row pass, weight pass, chunk sum); predict_ctr's latency and
    the step's times for the v2 model."""
    model = builder.model
    batch = {name: v[0] for name, v in batches.items()}
    gathered, _ = builder.lookup(state["tables"], model.lookup_ids(batch))
    x0 = model.flat_input(gathered, batch)
    cross = state["dense"]["cross"]
    u, v, b = cross["u"], cross["v"], cross["b"]
    layers, dim, rank = u.shape
    bsz = x0.shape[0]
    # 3 sets of x0 (27.7 MB each) rotate past L2; the backward's sets hold
    # x0, g, f (83 MB) and xv each.
    x0s = [x0, torch.randn_like(x0), torch.randn_like(x0)]
    f_ms = device_ms(lambda: [cross_v2_fwd(x, u, v, b) for x in x0s], len(x0s))
    f_train_ms = device_ms(lambda: [cross_v2_fwd(x, u, v, b, want_saved=True) for x in x0s], len(x0s))
    f_plain = device_ms(lambda: [cross_v2_fwd_ref(x, u, v, b) for x in x0s], len(x0s))
    f_bound, f_by = v2_fwd_bound(bsz, dim, rank, layers, saved=False)
    f_train_bound, f_train_by = v2_fwd_bound(bsz, dim, rank, layers, saved=True)
    sets = []
    for x in x0s:
        _, f, xv = cross_v2_fwd(x, u, v, b, want_saved=True)
        sets.append((x, f, xv, torch.randn_like(x)))
    b_ms = device_ms(lambda: [cross_v2_bwd(x, u, v, f, xv, g) for x, f, xv, g in sets], len(sets))
    b_plain = device_ms(lambda: [cross_v2_bwd_ref(x, u, v, f, xv, g) for x, f, xv, g in sets], len(sets))
    b_bound, b_by = v2_bwd_bound(bsz, dim, rank, layers)
    x, f, xv, g = sets[0]
    parts = kernel_times_us(lambda: cross_v2_bwd(x, u, v, f, xv, g))
    print(f"cross_v2_fwd [{bsz}, {dim}] r={rank} L={layers}: kernel {f_ms:.4f} ms (saving f and xv "
          f"for training {f_train_ms:.4f} ms), plain {f_plain:.4f} ms, bound {f_bound:.4f} ms ({f_by}; "
          f"3xTF32 products at {TF32_OPS_PER_S / 1e12:.0f} TFLOP/s; saving f and xv {f_train_bound:.4f} ms, "
          f"{f_train_by}) [device time, CUDA graph]")
    print(f"cross_v2_bwd [{bsz}, {dim}] r={rank} L={layers}: kernel {b_ms:.4f} ms, plain {b_plain:.4f} ms, "
          f"bound {b_bound:.4f} ms ({b_by}; 3xTF32 products at {TF32_OPS_PER_S / 1e12:.0f} TFLOP/s) "
          f"[device time, CUDA graph]; one call by kernel (profiler): "
          + ", ".join(f"{name} {parts[k]:.1f} us" for name in ("bwd_rows", "bwd_weights", "sum_chunks")
                      for k in parts if name in k))
    del sets, x0s

    dense, cat = requests[0]
    lat = []
    for _ in range(11):
        t0 = time.perf_counter()
        rec.predict_ctr(dense, cat)
        lat.append((time.perf_counter() - t0) * 1e3)
    latency = statistics.median(lat[1:])
    print(f"predict_ctr ({model.__class__.__name__}, cross {sorted(cross)}) batch {BATCH} (host clock, "
          f"request copy and logits included): median {latency:.3f} ms over {len(lat) - 1} calls")
    profile(lambda: rec.predict_ctr(dense, cat), "predict_ctr", latency)
    step_times(builder, state, batches)
    return [
        {"name": "cross_v2_fwd", "route": "cuda", "max_abs_err": errs["cross_v2_fwd"], "ms": f_ms,
         "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by, "library_ms": None},
        {"name": "cross_v2_bwd", "route": "cuda", "max_abs_err": errs["cross_v2_bwd"], "ms": b_ms,
         "plain_ms": b_plain, "bound_ms": b_bound, "bound_by": b_by, "library_ms": None},
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    rng = np.random.default_rng(SEED)
    phase_environment()
    phase_build()
    errs = phase_kernels(rng)
    phase_wide()
    cfgs = configs()
    paths = {}
    model, rec, requests, paths["serve_v1"] = phase_main_path(rng, cfgs["v1"])
    records = phase_times(model, rec, requests, errs)
    builder, state, batches, paths["train_v1"] = phase_train(cfgs["v1"])
    records += phase_train_times(builder, state, batches, errs)
    del model, rec, requests, builder, state, batches
    _, rec, requests, paths["serve_v2"] = phase_main_path(rng, cfgs["v2"])
    builder, state, batches, paths["train_v2"] = phase_train(cfgs["v2"])
    records += phase_v2_times(rec, requests, builder, state, batches, errs)
    for r in records:
        by_path = {path: launches[r["name"]] for path, launches in paths.items()}
        r.update({"launches": sum(by_path.values()), "launches_by_path": by_path})
        r.update({k: KERNELS[r["name"]][k] for k in ("source", "replaces")})
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
