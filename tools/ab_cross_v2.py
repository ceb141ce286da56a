#!/usr/bin/env python3
"""A/B variants of the low-rank DCN-v2 cross kernels on one CUDA card.

    python3 tools/ab_cross_v2.py DIR[:CHUNKS] ...

Each DIR holds a variant ``cross_v2.cu`` with the C interface of
``tfrec_tpu_torch/kernels/csrc/cross_v2.cu`` (``tfrec_tpu_torch/kernels/csrc``
itself is the current one). For each argument, in order, it builds the
variant into ``build/ab/<n>_<DIR name>/``, holds the forward and backward against their plain
versions at the flagship's shape (B=8192, d=845, r=64, L=3; rtol 1e-5, atol
1e-5 x max|ref|), and prints their device times (a CUDA graph of 3 calls on
inputs that rotate past L2, median of 7 replays) and the backward's time by
kernel. CHUNKS caps the weight pass's batch chunks (default: the wrapper's).
List a variant twice, first and last, to see the drift of the card.
"""

import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tfrec_tpu_torch.kernels import _build  # noqa: E402
from tfrec_tpu_torch.kernels import cross_v2_cuda as m  # noqa: E402

B, D, R, L = 8192, 845, 64, 3


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


def within(got, want) -> bool:
    return bool(((got - want).abs() <= 1e-5 * want.abs().max() + 1e-5 * want.abs()).all())


def main() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    x0s = [torch.randn(B, D, device="cuda", generator=gen) for _ in range(3)]
    gs = [torch.randn(B, D, device="cuda", generator=gen) for _ in range(3)]
    u = torch.randn(L, D, R, device="cuda", generator=gen) / D**0.5
    v = torch.randn(L, D, R, device="cuda", generator=gen) / D**0.5
    b = 0.1 * torch.randn(L, D, device="cuda", generator=gen)
    default_chunks = m._MAX_CHUNKS
    for n, arg in enumerate(sys.argv[1:]):
        variant, _, chunks = arg.partition(":")
        m._MAX_CHUNKS = int(chunks) if chunks else default_chunks
        src = Path(variant).resolve()
        _build.CSRC_DIR, _build.BUILD_DIR = src, ROOT / "build" / "ab" / f"{n}_{src.name}"
        _build._loaded.clear()
        _build._functions.clear()
        _build.build(["cross_v2"])
        saved = [m.cross_v2_fwd(x, u, v, b, want_saved=True) for x in x0s]
        out, f, xv = saved[0]
        ok = within(out, m.cross_v2_fwd_ref(x0s[0], u, v, b))
        grads = m.cross_v2_bwd(x0s[0], u, v, f, xv, gs[0])
        ok &= all(within(a, e) for a, e in zip(grads, m.cross_v2_bwd_ref(x0s[0], u, v, f, xv, gs[0])))
        fwd = device_ms(lambda: [m.cross_v2_fwd(x, u, v, b) for x in x0s], 3)
        fwd_saved = device_ms(lambda: [m.cross_v2_fwd(x, u, v, b, want_saved=True) for x in x0s], 3)
        bwd = device_ms(lambda: [m.cross_v2_bwd(x, u, v, f, xv, g)
                                 for (_, f, xv), x, g in zip(saved, x0s, gs)], 3)
        print(f"{src.name} chunks<={m._MAX_CHUNKS}: within tolerance {ok}; forward {fwd * 1e3:.1f} us, "
              f"saving f and xv {fwd_saved * 1e3:.1f} us, backward {bwd * 1e3:.1f} us", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            m.cross_v2_bwd(x0s[0], u, v, f, xv, gs[0])
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                print(f"    {e.self_device_time_total:8.1f} us  {e.key[:70]}")


if __name__ == "__main__":
    main()
