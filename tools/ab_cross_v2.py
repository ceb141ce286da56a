#!/usr/bin/env python3
"""A/B variants of the low-rank DCN-v2 cross kernels on one CUDA card.

    python3 tools/ab_cross_v2.py [f32=]DIR[:CHUNKS] ...

Each DIR holds a variant ``cross_v2.cu`` with the C interface of
``tfrec_tpu_torch/kernels/csrc/cross_v2.cu`` (``tfrec_tpu_torch/kernels/csrc``
itself is the current one). ``f32=DIR`` marks a variant with the backward
interface of the f32 CUDA-core kernels (commit e620197: U zero padded to
[L, d, r4], V transposed and zero padded to [L, r4, d4], df and t
unpadded), which this tool then calls with those layouts. For each
argument, in order, it builds the variant into ``build/ab/<n>_<DIR name>/``,
holds the forward and backward against their plain versions at the
flagship's shape (B=8192, d=845, r=64, L=3; rtol 1e-5, atol 1e-5 x
max|ref|), and prints their device times (a CUDA graph of 3 calls on
inputs that rotate past L2, median of 7 replays) and the backward's time
by kernel. CHUNKS caps the weight pass's batch chunks (default: the wrapper's).
List a variant twice, first and last, to see the drift of the card. It
also counts the tensor-core (HMMA) instructions of each backward kernel in
the built library's SASS (``cuobjdump --dump-sass``).
"""

import re
import statistics
import subprocess
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


def f32_bwd(x0, u, v, f, xv, g):
    """``cross_v2_bwd`` as the f32 CUDA-core kernels' wrapper called them."""
    layers, dim, rank = u.shape
    batch, width = x0.shape[0], layers * dim * rank
    grads = torch.zeros(2 * width + layers * dim, device=x0.device)
    dx0, df, t = torch.empty_like(x0), torch.empty_like(f), torch.empty_like(xv)
    chunks = min(m._MAX_CHUNKS, -(-batch // m._MIN_CHUNK_ROWS))
    partial = torch.empty((chunks, grads.numel()), device=x0.device)
    u4, vt4 = m._layout(u, transpose=False), m._layout(v, transpose=True)
    fn = _build.function("cross_v2", "tfrec_cross_v2_bwd", m._BWD_ARGTYPES)
    rc = fn(x0.data_ptr(), u4.data_ptr(), vt4.data_ptr(), f.data_ptr(), xv.data_ptr(), g.data_ptr(),
            dx0.data_ptr(), grads.data_ptr(), df.data_ptr(), t.data_ptr(), partial.data_ptr(),
            batch, dim, rank, layers, chunks, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "f32 cross_v2_bwd")
    return (dx0, grads[:width].view(layers, dim, rank), grads[width:2 * width].view(layers, dim, rank),
            grads[2 * width:].view(layers, dim))


def hmma_counts(lib: Path) -> dict:
    """HMMA instructions in the SASS of each backward kernel of ``lib``."""
    sass = subprocess.run([str(Path(_build.find_nvcc()).parent / "cuobjdump"), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = next((k for k in ("bwd_rows", "bwd_weights", "fwd_kernel", "sum_chunks")
                         if k in found.group(1)), found.group(1))
            template = re.search(r"ILi(\d+)E", found.group(1))
            name += f"<{template.group(1)}>" if template else ""
            counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


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
        f32 = arg.startswith("f32=")
        variant, _, chunks = arg.removeprefix("f32=").partition(":")
        m._MAX_CHUNKS = int(chunks) if chunks else default_chunks
        src = Path(variant).resolve()
        _build.CSRC_DIR, _build.BUILD_DIR = src, ROOT / "build" / "ab" / f"{n}_{src.name}"
        _build._loaded.clear()
        _build._functions.clear()
        _build.build(["cross_v2"])
        bwd_fn = f32_bwd if f32 else m.cross_v2_bwd
        saved = [m.cross_v2_fwd(x, u, v, b, want_saved=True) for x in x0s]
        out, f, xv = saved[0]
        ok = within(out, m.cross_v2_fwd_ref(x0s[0], u, v, b))
        grads = bwd_fn(x0s[0], u, v, f, xv, gs[0])
        ref = m.cross_v2_bwd_ref(x0s[0], u, v, f, xv, gs[0])
        ok &= all(within(a, e) for a, e in zip(grads, ref))
        again = bwd_fn(x0s[0], u, v, f, xv, gs[0])
        errs = ", ".join(f"{name} {(a - e).abs().max().item():.3e} (max |ref| {e.abs().max().item():.3e})"
                         for name, a, e in zip(("dx0", "dU", "dV", "db"), grads, ref))
        bitwise = all(torch.equal(a, e) for a, e in zip(grads, again))
        fwd = device_ms(lambda: [m.cross_v2_fwd(x, u, v, b) for x in x0s], 3)
        fwd_saved = device_ms(lambda: [m.cross_v2_fwd(x, u, v, b, want_saved=True) for x in x0s], 3)
        bwd = device_ms(lambda: [bwd_fn(x, u, v, f, xv, g)
                                 for (_, f, xv), x, g in zip(saved, x0s, gs)], 3)
        print(f"{'f32=' if f32 else ''}{src.name} chunks<={m._MAX_CHUNKS}: within tolerance {ok}, "
              f"backward repeats bit for bit {bitwise}; forward {fwd * 1e3:.1f} us, saving f and xv "
              f"{fwd_saved * 1e3:.1f} us, backward {bwd * 1e3:.1f} us; backward errors {errs}; "
              f"HMMA in SASS {hmma_counts(_build.library_path('cross_v2'))}", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            bwd_fn(x0s[0], u, v, f, xv, gs[0])
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                print(f"    {e.self_device_time_total:8.1f} us  {e.key[:70]}")


if __name__ == "__main__":
    main()
