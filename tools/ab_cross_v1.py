#!/usr/bin/env python3
"""A/B variants of the DCN-v1 cross kernels on one CUDA card.

    python3 tools/ab_cross_v1.py [parent=]DIR ...

Each DIR holds a variant ``cross.cu`` with the C interface of
``tfrec_tpu_torch/kernels/csrc/cross.cu`` (``tfrec_tpu_torch/kernels/csrc``
itself is the current one). ``parent=DIR`` marks the interface of commit
548bcb2's kernels (the backward takes a [blocks, 2, L, d] partial and its
block count; d <= 8192 and 2*L*d floats of shared memory), which this tool
then calls as that commit's wrapper did. For each argument, in order, it
builds the variant into ``build/ab/<n>_<DIR name>/`` and, at each shape
(B=8192: d=845, L=3, the flagship's; d=2093, 4121 and 8192 at L=3,
dcn_criteo's DCN-v1 widths at embed_dim 80 and 158 and the widest row a
block's registers hold; and, past the parent's limits, d=8333, L=4 and
d=845, L=40), holds both kernels to their plain versions (rtol 1e-5, atol
1e-5 x max|ref|) and to themselves on a repeat (bit for bit), and prints
their device times (a CUDA graph of 3 calls on inputs that rotate past
L2, median of 7 replays) beside ``torch.add(x0, g, out=dx0)`` on the same
inputs (the bytes of the backward's bound), the host's time a backward
call (the wrapper and its launches, median of 7 runs of 20 eager calls)
and the backward's time by kernel (the profiler over 3 eager calls).
List a variant twice, first and last, to see the drift of the card.
"""

import ctypes
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tfrec_tpu_torch.kernels import _build  # noqa: E402
from tfrec_tpu_torch.kernels import cross_cuda as m  # noqa: E402

B = 8192
SHAPES = [(845, 3), (2093, 3), (4121, 3), (8192, 3), (8333, 4), (845, 40)]
PARENT_MAX_DIM = 8192
PARENT_MAX_SMEM = 227 * 1024  # its [2, L, d] sums in shared memory
PARENT_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]


def device_ms(fn, calls: int, reps: int = 7) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_us(fn, calls: int = 20, reps: int = 7) -> float:
    """The host's time a call of ``fn``, which only enqueues work."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - start) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def within(got, want) -> bool:
    return bool(((got - want).abs() <= 1e-5 * want.abs().max() + 1e-5 * want.abs()).all())


def parent_bwd(x0, w, b, s, g):
    """``cross_v1_bwd`` as commit 548bcb2's wrapper called its kernels: at
    most 4 blocks an SM of 132, each at least 16 rows, and a [blocks, 2, L,
    d] partial."""
    batch, dim = x0.shape
    layers = w.shape[0]
    dx0, dw, db = torch.empty_like(x0), torch.zeros_like(w), torch.zeros_like(b)
    blocks = min(132 * 4, -(-batch // 16))
    partial = torch.empty((blocks, 2, layers, dim), device=x0.device)
    fn = _build.function("cross", "tfrec_cross_v1_bwd", PARENT_BWD_ARGTYPES)
    rc = fn(x0.data_ptr(), w.data_ptr(), b.data_ptr(), s.data_ptr(), g.data_ptr(), dx0.data_ptr(),
            dw.data_ptr(), db.data_ptr(), partial.data_ptr(), batch, dim, layers, blocks,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "parent cross_v1_bwd")
    return dx0, dw, db


def kernel_split_us(fn) -> dict:
    """Mean device time a launch by kernel over one eager run of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def main() -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for dim, layers in SHAPES:
        inputs[dim, layers] = (
            [torch.randn(B, dim, device="cuda", generator=gen) for _ in range(3)],
            [torch.randn(B, dim, device="cuda", generator=gen) for _ in range(3)],
            torch.randn(layers, dim, device="cuda", generator=gen) / dim**0.5,
            0.1 * torch.randn(layers, dim, device="cuda", generator=gen))
    for n, arg in enumerate(sys.argv[1:]):
        parent = arg.startswith("parent=")
        src = Path(arg.removeprefix("parent=")).resolve()
        _build.CSRC_DIR, _build.BUILD_DIR = src, ROOT / "build" / "ab" / f"{n}_{src.name}"
        _build._loaded.clear()
        _build._functions.clear()
        m._bwd_scratch_floats.cache_clear()
        secs = _build.build(["cross"])
        bwd_fn = parent_bwd if parent else m.cross_v1_bwd
        print(f"{arg}: built in {secs:.1f} s", flush=True)
        for (dim, layers), (x0s, gs, w, b) in inputs.items():
            if parent and (dim > PARENT_MAX_DIM or 2 * layers * dim * 4 > PARENT_MAX_SMEM):
                continue
            ss = [m.cross_v1_fwd(x, w, b, want_s=True)[1] for x in x0s]
            out = m.cross_v1_fwd(x0s[0], w, b)
            grads = bwd_fn(x0s[0], w, b, ss[0], gs[0])
            ref = m.cross_v1_bwd_ref(x0s[0], w, b, gs[0], ss[0])
            ok = within(out, m.cross_v1_fwd_ref(x0s[0], w, b))
            ok &= all(within(a, e) for a, e in zip(grads, ref))
            bitwise = torch.equal(out, m.cross_v1_fwd(x0s[0], w, b))
            bitwise &= all(torch.equal(a, e) for a, e in zip(grads, bwd_fn(x0s[0], w, b, ss[0], gs[0])))
            errs = ", ".join(f"{name} {(a - e).abs().max().item():.3e} (max |ref| {e.abs().max().item():.3e})"
                             for name, a, e in zip(("dx0", "dw", "db"), grads, ref))
            dx0s = [torch.empty_like(x) for x in x0s]
            add = device_ms(lambda: [torch.add(x, g, out=o) for x, g, o in zip(x0s, gs, dx0s)], 3)
            fwd = device_ms(lambda: [m.cross_v1_fwd(x, w, b) for x in x0s], 3)
            bwd = device_ms(lambda: [bwd_fn(x, w, b, s, g) for x, s, g in zip(x0s, ss, gs)], 3)
            host = host_us(lambda: bwd_fn(x0s[0], w, b, ss[0], gs[0]))
            split = kernel_split_us(lambda: [bwd_fn(x, w, b, s, g) for x, s, g in zip(x0s, ss, gs)])
            print(f"  B={B} d={dim} L={layers}: within tolerance {ok}, bit for bit on repeat {bitwise}; "
                  f"cross_v1_fwd {fwd * 1e3:.1f} us, cross_v1_bwd {bwd * 1e3:.1f} us (x0 + g into dx0, the "
                  f"backward's bytes, {add * 1e3:.1f} us); host {host:.1f} us a backward call; "
                  f"backward errors {errs}",
                  flush=True)
            for name, us in split.items():
                print(f"    {us:8.1f} us a launch  {name[:90]}", flush=True)


if __name__ == "__main__":
    main()
