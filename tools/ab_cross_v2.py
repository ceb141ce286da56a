#!/usr/bin/env python3
"""A/B variants of the low-rank DCN-v2 cross kernels on one CUDA card.

    python3 tools/ab_cross_v2.py [--dims D,D,...] [pr5=|parent=]DIR[:CHUNKS] ...

Each DIR holds a variant ``cross_v2.cu`` with the C interface of
``tfrec_tpu_torch/kernels/csrc/cross_v2.cu`` (``tfrec_tpu_torch/kernels/csrc``
itself is the current one). ``pr5=DIR`` marks the interface of commit
88036c9's kernels, which this tool then calls with its layouts: the f32
CUDA-core forward (V zero padded to [L, d, r4], U transposed and zero
padded to [L, r4, d4]) beside the tensor-core backward without the g
scratch. ``parent=DIR`` marks the interface of commit 61543c0's kernels
(before the general route: no U, V, scratch, splits or route arguments). For each argument,
in order, it builds the variant into ``build/ab/<n>_<DIR name>/``, holds
the forward and backward against their plain versions at the flagship's
shape (B=8192, d=845, r=64, L=3; rtol 1e-5, atol 1e-5 x max|ref|), and at
each d of ``--dims`` in its place, says whether their outputs are bit for
bit the first variant's, and prints their device times (a CUDA graph of 3
calls on inputs that rotate past L2, median of 7 replays) and the
backward's time by kernel. CHUNKS caps the weight pass's batch chunks
(default: the wrapper's). List a variant twice, first and last, to see the
drift of the card. The DCN-v1 kernels have their own tool,
``tools/ab_cross_v1.py``. It also counts the
tensor-core (HMMA) instructions of each kernel in the built library's SASS
(``cuobjdump --dump-sass``).
"""

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

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


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _layout(w, transpose: bool):
    """A weight stack [L, d, r] as commit 88036c9's f32 CUDA-core forward
    read it: zero padded to [L, d, r4], or transposed and zero padded to
    [L, r4, d4]."""
    layers, dim, rank = w.shape
    if transpose:
        return F.pad(w.transpose(1, 2), (0, _round4(dim) - dim, 0, _round4(rank) - rank)).contiguous()
    return F.pad(w, (0, _round4(rank) - rank)).contiguous()


def pr5_fwd(x0, u, v, b, want_saved=False):
    """``cross_v2_fwd`` as commit 88036c9's wrapper called its f32
    CUDA-core forward."""
    layers, dim, rank = u.shape
    batch = x0.shape[0]
    out = torch.empty_like(x0)
    f = torch.empty((layers, batch, dim), device=x0.device) if want_saved else None
    xv = torch.empty((layers, batch, rank), device=x0.device) if want_saved else None
    fn = _build.function("cross_v2", "tfrec_cross_v2_fwd",
                         [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    v4, ut4 = _layout(v, transpose=False), _layout(u, transpose=True)
    rc = fn(x0.data_ptr(), v4.data_ptr(), ut4.data_ptr(), b.data_ptr(), out.data_ptr(),
            f.data_ptr() if want_saved else None, xv.data_ptr() if want_saved else None,
            batch, dim, rank, layers, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "pr5 cross_v2_fwd")
    return (out, f, xv) if want_saved else out


def pr5_bwd(x0, u, v, f, xv, g):
    """``cross_v2_bwd`` as commit 88036c9's wrapper called its kernels (no g
    scratch)."""
    layers, dim, rank = u.shape
    batch, width = x0.shape[0], layers * dim * rank
    grads = torch.zeros(2 * width + layers * dim, device=x0.device)
    dx0 = torch.empty_like(x0)
    df = torch.empty((layers, batch, m._round8(dim)), device=x0.device)
    t = torch.empty((layers, batch, m._round8(rank)), device=x0.device)
    wu, wv = m._fragments(u), m._fragments(v.transpose(1, 2))
    chunks = min(m._MAX_CHUNKS, -(-batch // m._MIN_CHUNK_ROWS))
    partial = torch.empty((chunks, grads.numel()), device=x0.device)
    fn = _build.function("cross_v2", "tfrec_cross_v2_bwd",
                         [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 5 + [ctypes.c_void_p])
    rc = fn(x0.data_ptr(), wu.data_ptr(), wv.data_ptr(), f.data_ptr(), xv.data_ptr(), g.data_ptr(),
            dx0.data_ptr(), grads.data_ptr(), df.data_ptr(), t.data_ptr(), partial.data_ptr(),
            batch, dim, rank, layers, chunks, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "pr5 cross_v2_bwd")
    return (dx0, grads[:width].view(layers, dim, rank), grads[width:2 * width].view(layers, dim, rank),
            grads[2 * width:].view(layers, dim))


def parent_fwd(x0, u, v, b, want_saved=False):
    """``cross_v2_fwd`` as commit 61543c0's wrapper called its kernels."""
    layers, dim, rank = u.shape
    batch = x0.shape[0]
    out = torch.empty_like(x0)
    f = torch.empty((layers, batch, dim), device=x0.device) if want_saved else None
    xv = torch.empty((layers, batch, rank), device=x0.device) if want_saved else None
    fn = _build.function("cross_v2", "tfrec_cross_v2_fwd",
                         [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    vfrag, utfrag = m._fragments(v), m._fragments(u.transpose(1, 2))
    rc = fn(x0.data_ptr(), vfrag.data_ptr(), utfrag.data_ptr(), b.data_ptr(), out.data_ptr(),
            f.data_ptr() if want_saved else None, xv.data_ptr() if want_saved else None,
            batch, dim, rank, layers, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "parent cross_v2_fwd")
    return (out, f, xv) if want_saved else out


def parent_bwd(x0, u, v, f, xv, g):
    """``cross_v2_bwd`` as commit 61543c0's wrapper called its kernels."""
    layers, dim, rank = u.shape
    batch, width = x0.shape[0], layers * dim * rank
    grads = torch.zeros(2 * width + layers * dim, device=x0.device)
    dx0 = torch.empty_like(x0)
    chunks = min(m._MAX_CHUNKS, -(-batch // m._MIN_CHUNK_ROWS))
    df = torch.empty((layers, batch, m._round8(dim)), device=x0.device)
    t = torch.empty((layers, batch, m._round8(rank)), device=x0.device)
    partial = torch.empty((chunks, grads.numel()), device=x0.device)
    rows = _build.function("cross_v2", "tfrec_cross_v2_bwd_scratch_rows", [ctypes.c_longlong] * 3)(
        batch, dim, rank)
    g_scratch = torch.empty((rows, m._round8(dim)), device=x0.device) if rows else None
    fn = _build.function("cross_v2", "tfrec_cross_v2_bwd",
                         [ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 5 + [ctypes.c_void_p])
    wu, wv = m._fragments(u), m._fragments(v.transpose(1, 2))
    rc = fn(x0.data_ptr(), wu.data_ptr(), wv.data_ptr(), f.data_ptr(), xv.data_ptr(), g.data_ptr(),
            dx0.data_ptr(), grads.data_ptr(), df.data_ptr(), t.data_ptr(),
            None if g_scratch is None else g_scratch.data_ptr(), partial.data_ptr(),
            batch, dim, rank, layers, chunks, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "parent cross_v2_bwd")
    return (dx0, grads[:width].view(layers, dim, rank), grads[width:2 * width].view(layers, dim, rank),
            grads[2 * width:].view(layers, dim))


def hmma_counts(lib: Path) -> dict:
    """HMMA instructions in the SASS of each kernel of ``lib``, by kernel
    and template arguments (``<rows / 16>`` or ``<rows / 16, g in shared
    memory>``; the general route's ``<A, BTrans, Epi>`` and ``<Df>``)."""
    sass = subprocess.run([str(Path(_build.find_nvcc()).parent / "cuobjdump"), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            mangled = found.group(1)
            name = next((k for k in ("bwd_rows", "bwd_weights", "fwd_kernel", "sum_chunks",
                                     "general_rows", "general_weights") if k in mangled), mangled)
            template = re.findall(r"L[ib](\d+)E", mangled.partition(name)[2])
            if template:
                name += "<" + ", ".join(template) + ">"
            counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


def main() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    dims = [D]
    if args[:1] == ["--dims"]:
        dims = [int(d) for d in args[1].split(",")]
        args = args[2:]
    inputs = {}
    for dim in dims:
        gen = torch.Generator(device="cuda").manual_seed(0)
        inputs[dim] = ([torch.randn(B, dim, device="cuda", generator=gen) for _ in range(3)],
                       [torch.randn(B, dim, device="cuda", generator=gen) for _ in range(3)],
                       torch.randn(L, dim, R, device="cuda", generator=gen) / dim**0.5,
                       torch.randn(L, dim, R, device="cuda", generator=gen) / dim**0.5,
                       0.1 * torch.randn(L, dim, device="cuda", generator=gen))
    first = {}  # the first variant's outputs at each d
    default_chunks = m._MAX_CHUNKS
    for arg, dim in ((a, d) for a in args for d in dims):
        x0s, gs, u, v, b = inputs[dim]
        iface, _, rest = arg.rpartition("=")
        variant, _, chunks = rest.partition(":")
        m._MAX_CHUNKS = int(chunks) if chunks else default_chunks
        src = Path(variant).resolve()
        _build.CSRC_DIR, _build.BUILD_DIR = src, ROOT / "build" / "ab" / f"{args.index(arg)}_{src.name}"
        _build._loaded.clear()
        _build._functions.clear()
        _build.build(["cross_v2"])
        fwd_fn = {"pr5": pr5_fwd, "parent": parent_fwd}.get(iface, m.cross_v2_fwd)
        bwd_fn = {"pr5": pr5_bwd, "parent": parent_bwd}.get(iface, m.cross_v2_bwd)
        saved = [fwd_fn(x, u, v, b, want_saved=True) for x in x0s]
        out, f, xv = saved[0]
        want, f_ref, xv_ref = m.cross_v2_fwd_ref(x0s[0], u, v, b, want_saved=True)
        ok = within(out, want) and within(f, f_ref) and within(xv, xv_ref)
        fwd_errs = ", ".join(f"{name} {(a - e).abs().max().item():.3e} (max |ref| {e.abs().max().item():.3e})"
                             for name, a, e in (("x_L", out, want), ("f", f, f_ref), ("xv", xv, xv_ref)))
        grads = bwd_fn(x0s[0], u, v, f, xv, gs[0])
        ref = m.cross_v2_bwd_ref(x0s[0], u, v, f, xv, gs[0])
        ok &= all(within(a, e) for a, e in zip(grads, ref))
        again = bwd_fn(x0s[0], u, v, f, xv, gs[0])
        errs = ", ".join(f"{name} {(a - e).abs().max().item():.3e} (max |ref| {e.abs().max().item():.3e})"
                         for name, a, e in zip(("dx0", "dU", "dV", "db"), grads, ref))
        bitwise = torch.equal(out, fwd_fn(x0s[0], u, v, b))
        bitwise &= all(torch.equal(a, e) for a, e in zip(grads, again))
        outputs = (out, f, xv, *grads)
        same = all(torch.equal(a, e) for a, e in zip(outputs, first.setdefault(dim, outputs)))
        fwd = device_ms(lambda: [fwd_fn(x, u, v, b) for x in x0s], 3)
        fwd_saved = device_ms(lambda: [fwd_fn(x, u, v, b, want_saved=True) for x in x0s], 3)
        bwd = device_ms(lambda: [bwd_fn(x, u, v, f, xv, g)
                                 for (_, f, xv), x, g in zip(saved, x0s, gs)], 3)
        print(f"{arg} d={dim} chunks<={m._MAX_CHUNKS}: within tolerance {ok}, forward and backward repeat "
              f"bit for bit {bitwise}, outputs bit for bit the first variant's {same}; forward "
              f"{fwd * 1e3:.1f} us, saving f and xv {fwd_saved * 1e3:.1f} us, backward {bwd * 1e3:.1f} us; "
              f"forward errors {fwd_errs}; backward errors {errs}; "
              f"HMMA in SASS {hmma_counts(_build.library_path('cross_v2'))}", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            bwd_fn(x0s[0], u, v, f, xv, gs[0])
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                print(f"    {e.self_device_time_total:8.1f} us  {e.key[:70]}")


if __name__ == "__main__":
    main()
