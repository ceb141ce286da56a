#!/usr/bin/env python3
"""A/B variants of the low-rank DCN-v2 cross kernels on one CUDA card.

    python3 tools/ab_cross_v2.py [--dims D,D,... [--layers L] | --bench] [pr5=|tilesonly=|parent=]DIR[:CHUNKS] ...

Each DIR holds a variant ``cross_v2.cu`` with the C interface of
``tfrec_tpu_torch/kernels/csrc/cross_v2.cu`` (``tfrec_tpu_torch/kernels/csrc``
itself is the current one; ``parent=DIR`` labels a parent commit's copy,
which has the same interface). ``pr5=DIR`` marks the interface of commit
88036c9's kernels, which this tool then calls with its layouts: the f32
CUDA-core forward (V zero padded to [L, d, r4], U transposed and zero
padded to [L, r4, d4]) beside the tensor-core backward without the g
scratch. ``tilesonly=DIR`` marks the interface of commit 61543c0's kernels
(before the general route: no U, V, scratch, splits or route arguments).

``--bench`` runs the benchmark's DCN-v2 shapes instead (d0=3341, r=512,
L=3, the general route): a training step's forward saving f and xv and
its backward at B=32768, and a serving call's forward at B=4096. For each
variant it holds them against their plain versions, checks bit-for-bit
repeat, prints their device times beside their 3xTF32 bounds (3 x 2 B d r
TF32 operations a product at 495 TFLOP/s) and each kernel's time and
launches, with the bound of the products it ran. For each argument,
in order, it builds the variant into ``build/ab/<n>_<DIR name>/``, holds
the forward and backward against their plain versions at the flagship's
shape (B=8192, d=845, r=64, L=3; rtol 1e-5, atol 1e-5 x max|ref|), and at
each d of ``--dims`` in its place (with ``--layers``' depth in place of 3), says whether their outputs are bit for
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


def tilesonly_fwd(x0, u, v, b, want_saved=False):
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
    _build.check_launch(rc, "tilesonly cross_v2_fwd")
    return (out, f, xv) if want_saved else out


def tilesonly_bwd(x0, u, v, f, xv, g):
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
    _build.check_launch(rc, "tilesonly cross_v2_bwd")
    return (dx0, grads[:width].view(layers, dim, rank), grads[width:2 * width].view(layers, dim, rank),
            grads[2 * width:].view(layers, dim))


def hmma_counts(lib: Path) -> dict:
    """Tensor-core instructions (HMMA for ``mma.sync``, HGMMA for
    ``wgmma``) in the SASS of each kernel of ``lib``, by kernel and template
    arguments (``<rows / 16>`` or ``<rows / 16, g in shared memory>``; the
    general route's ``<A, BTrans, Epi>`` and ``<A>``)."""
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
        elif name and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    return counts


PEAK_TF32 = 495e12
BENCH_DIM, BENCH_RANK, BENCH_LAYERS = 3341, 512, 3
BENCH_SHAPES = (("train", 32768), ("serve", 4096))  # (what, B): training saves f, xv and runs the backward
KERNEL_NAME = re.compile(r"(cross_v2_\w+_kernel|general_rows_kernel|general_weights_kernel|sum_chunks_kernel)"
                         r"(<[^>]*>)?")


def kernel_times(fn) -> dict:
    """Device time (us) and launches of each kernel of one call of fn, by
    kernel name and template arguments."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            found = KERNEL_NAME.search(e.key)
            name = "".join(found.groups("")) if found else e.key[:60]
            us, n = times.get(name, (0.0, 0))
            times[name] = (us + e.self_device_time_total, n + e.count)
    return times


def bench(arg: str, fwd_fn, bwd_fn) -> None:
    """The benchmark's shapes (``--bench``) for one variant."""
    dim, rank, layers = BENCH_DIM, BENCH_RANK, BENCH_LAYERS
    for what, batch in BENCH_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(batch)
        x0 = torch.randn(batch, dim, device="cuda", generator=gen)
        g = torch.randn(batch, dim, device="cuda", generator=gen)
        u = torch.randn(layers, dim, rank, device="cuda", generator=gen) / dim**0.5
        v = torch.randn(layers, dim, rank, device="cuda", generator=gen) / dim**0.5
        b = 0.1 * torch.randn(layers, dim, device="cuda", generator=gen)
        product = 3 * 2 * batch * dim * rank / PEAK_TF32 * 1e6  # us, 3xTF32
        train = what == "train"
        out, f, xv = fwd_fn(x0, u, v, b, want_saved=True)
        want, f_ref, xv_ref = m.cross_v2_fwd_ref(x0, u, v, b, want_saved=True)
        ok = within(out, want) and (not train or (within(f, f_ref) and within(xv, xv_ref)))
        errs = [f"x_L {(out - want).abs().max().item():.3e} (max |ref| {want.abs().max().item():.3e})"]
        bitwise = torch.equal(out, fwd_fn(x0, u, v, b))
        del want, f_ref, xv_ref
        fwd = device_ms(lambda: fwd_fn(x0, u, v, b, want_saved=train), 1)
        line = (f"{arg} {what} B={batch} d={dim} r={rank} L={layers}: forward{' saving f and xv' if train else ''} "
                f"{fwd * 1e3:.1f} us (bound {2 * layers * product:.1f})")
        calls = [lambda: fwd_fn(x0, u, v, b, want_saved=train)]
        if train:
            grads = bwd_fn(x0, u, v, f, xv, g)
            ref = m.cross_v2_bwd_ref(x0, u, v, f, xv, g)
            ok &= all(within(a, e) for a, e in zip(grads, ref))
            errs += [f"{name} {(a - e).abs().max().item():.3e} (max |ref| {e.abs().max().item():.3e})"
                     for name, a, e in zip(("dx0", "dU", "dV", "db"), grads, ref)]
            bitwise &= all(torch.equal(a, e) for a, e in zip(grads, bwd_fn(x0, u, v, f, xv, g)))
            del grads, ref
            bwd = device_ms(lambda: bwd_fn(x0, u, v, f, xv, g), 1)
            line += f", backward {bwd * 1e3:.1f} us (bound {4 * layers * product:.1f})"
            calls.append(lambda: bwd_fn(x0, u, v, f, xv, g))
        print(f"{line}; within tolerance {ok}, repeats bit for bit {bitwise}; errors {', '.join(errs)}", flush=True)
        for call, label in zip(calls, ("forward", "backward")):
            for name, (us, n) in sorted(kernel_times(call).items(), key=lambda kv: -kv[1][0]):
                products = n if name.startswith(("general_rows", "general_weights")) else 0
                bound = f", bound of its {products} products {products * product:.1f} us" if products else ""
                print(f"    {label} {us:10.1f} us  {n:3d} launches  {name}{bound}", flush=True)
        del x0, g, u, v, b, out, f, xv
        torch.cuda.empty_cache()


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    dims = [D]
    benchmark = args[:1] == ["--bench"]
    if benchmark:
        args = args[1:]
    if args[:1] == ["--dims"]:
        dims = [int(d) for d in args[1].split(",")]
        args = args[2:]
    if args[:1] == ["--layers"]:
        global L
        L = int(args[1])
        args = args[2:]
    inputs = {}
    for dim in ([] if benchmark else dims):
        gen = torch.Generator(device="cuda").manual_seed(0)
        inputs[dim] = ([torch.randn(B, dim, device="cuda", generator=gen) for _ in range(3)],
                       [torch.randn(B, dim, device="cuda", generator=gen) for _ in range(3)],
                       torch.randn(L, dim, R, device="cuda", generator=gen) / dim**0.5,
                       torch.randn(L, dim, R, device="cuda", generator=gen) / dim**0.5,
                       0.1 * torch.randn(L, dim, device="cuda", generator=gen))
    first = {}  # the first variant's outputs at each d
    default_chunks = m._MAX_CHUNKS
    for arg, dim in ((a, d) for a in args for d in ([None] if benchmark else dims)):
        iface, _, rest = arg.rpartition("=")
        variant, _, chunks = rest.partition(":")
        m._MAX_CHUNKS = int(chunks) if chunks else default_chunks
        src = Path(variant).resolve()
        _build.CSRC_DIR, _build.BUILD_DIR = src, ROOT / "build" / "ab" / f"{args.index(arg)}_{src.name}"
        _build._loaded.clear()
        _build._functions.clear()
        _build.build(["cross_v2"])
        fwd_fn = {"pr5": pr5_fwd, "tilesonly": tilesonly_fwd}.get(iface, m.cross_v2_fwd)
        bwd_fn = {"pr5": pr5_bwd, "tilesonly": tilesonly_bwd}.get(iface, m.cross_v2_bwd)
        if benchmark:
            bench(arg, fwd_fn, bwd_fn)
            print(f"    HMMA in SASS {hmma_counts(_build.library_path('cross_v2'))}", flush=True)
            continue
        x0s, gs, u, v, b = inputs[dim]
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
        for name, (us, n) in kernel_times(lambda: bwd_fn(x0s[0], u, v, f, xv, gs[0])).items():
            print(f"    {us:8.1f} us  {n:3d} launches  {name}")


if __name__ == "__main__":
    main()
