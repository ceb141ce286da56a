#!/usr/bin/env python3
"""A/B variants of the gather and rowwise-Adagrad kernels on one CUDA card.

    python3 tools/ab_sparse.py DIR ...

Each DIR holds a variant ``gather.cu`` and ``adagrad.cu``: either with the
C interface of ``tfrec_tpu_torch/kernels/csrc`` (``tfrec_gather_rows_multi``
and ``tfrec_rowwise_adagrad_multi``: every table in one launch;
``tfrec_tpu_torch/kernels/csrc`` itself is the current one), or with the
one-table interface of commit 09a7383 (``tfrec_gather_rows`` and
``tfrec_rowwise_adagrad``), which this tool then launches once a table. For
each argument, in order, it builds the variant into
``build/ab_sparse/<n>_<DIR name>/`` (printing each kernel's registers and
spills from ``nvcc -Xptxas -v``) and times, at dcn_criteo's shape (26 tables
[100000, 32], 8192 ids a table):

- the gather of every table, on uniform ids (as a serving batch has them),
  bit for bit against the plain version;
- the Adagrad update of every table on the combined gradients of Zipf(1.2)
  ids (~1 800 distinct ids a table, as the training data has them) and of
  uniform ids (~7 900), against the plain version (rtol 1e-5, atol 1e-5 x
  max|ref|; bit for bit printed).

Device times are a call's share of a CUDA graph of 10 calls one after
another (a call is one launch, or 26 for the one-table interface), median
of 7 replays. List a variant first and last to see the drift of the card.
"""

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tfrec_tpu_torch.data.synthetic import _zipf_ids  # noqa: E402
from tfrec_tpu_torch.kernels import _build  # noqa: E402
from tfrec_tpu_torch.kernels.adagrad_cuda import fused_rowwise_adagrad_multi_ref  # noqa: E402
from tfrec_tpu_torch.kernels.gather_cuda import _outputs, gather_rows_multi_ref  # noqa: E402
from tfrec_tpu_torch.ops.embedding import combine_duplicate_ids  # noqa: E402

FIELDS, VOCAB, DIM, BATCH, LR, EPS = 26, 100_000, 32, 8192, 0.02, 1e-8
CALLS = 10  # calls a graph replay: one call is too short to time alone
P = ctypes.c_void_p
LL = ctypes.c_longlong


def device_ms(fn, reps: int = 7) -> float:
    """Device time a call: CALLS calls in one CUDA graph, median of reps
    replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
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
        times.append(start.elapsed_time(end) / CALLS)
    return statistics.median(times)


def build(n: int, src: Path) -> dict:
    out = ROOT / "build" / "ab_sparse" / f"{n}_{src.name}"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    libs = {}
    for name in ("gather", "adagrad"):
        lib = out / f"lib{name}.so"
        proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src / f"{name}.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src / name}.cu:\n{proc.stderr}")
        regs = [line.split("ptxas info    :")[-1].strip() for line in proc.stderr.splitlines()
                if "registers" in line or "spill" in line]
        print(f"  {name}.cu: " + "; ".join(regs))
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def gather_fn(libs, tables, ids):
    """A call gathering every table: one launch, or a launch a table."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    lib = libs["gather"]
    if hasattr(lib, "tfrec_gather_rows_multi"):
        fn = lib.tfrec_gather_rows_multi
        fn.argtypes, fn.restype = [P, ctypes.c_int, P, P], ctypes.c_int

        def call():
            outs = _outputs([(i.shape[0], t.shape[1]) for t, i in zip(tables, ids)], tables[0].device)
            desc = [x for t, i, o in zip(tables, ids, outs)
                    for x in (t.data_ptr(), i.data_ptr(), o.data_ptr(), t.shape[0], t.shape[1], i.shape[0])]
            launched = ctypes.c_int(0)
            assert fn((LL * len(desc))(*desc), len(tables), stream(), ctypes.byref(launched)) == 0
            return outs
        return call
    fn = lib.tfrec_gather_rows
    fn.argtypes, fn.restype = [P, P, P, LL, LL, LL, P], ctypes.c_int

    def call_each():
        outs = []
        for t, i in zip(tables, ids):
            o = torch.empty((i.shape[0], t.shape[1]), device=t.device)
            assert fn(t.data_ptr(), i.data_ptr(), o.data_ptr(), i.shape[0], t.shape[0], t.shape[1], stream()) == 0
            outs.append(o)
        return outs
    return call_each


def adagrad_fn(libs, tables, accs, uids, grads):
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    lib = libs["adagrad"]
    if hasattr(lib, "tfrec_rowwise_adagrad_multi"):
        fn = lib.tfrec_rowwise_adagrad_multi
        fn.argtypes, fn.restype = [P, ctypes.c_int, ctypes.c_float, ctypes.c_float, P, P], ctypes.c_int
        desc = [x for t, a, u, g in zip(tables, accs, uids, grads)
                for x in (t.data_ptr(), a.data_ptr(), u.data_ptr(), g.data_ptr(), u.shape[0], t.shape[0], t.shape[1])]

        def call():
            launched = ctypes.c_int(0)
            assert fn((LL * len(desc))(*desc), len(tables), LR, EPS, stream(), ctypes.byref(launched)) == 0
        return call
    fn = lib.tfrec_rowwise_adagrad
    fn.argtypes, fn.restype = [P] * 4 + [LL] * 3 + [ctypes.c_float] * 2 + [P], ctypes.c_int

    def call_each():
        for t, a, u, g in zip(tables, accs, uids, grads):
            assert fn(t.data_ptr(), a.data_ptr(), u.data_ptr(), g.data_ptr(),
                      u.shape[0], t.shape[0], t.shape[1], LR, EPS, stream()) == 0
    return call_each


def main(dirs) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    rng = np.random.default_rng(0)
    dev = "cuda"
    tables = [torch.from_numpy(rng.normal(size=(VOCAB, DIM)).astype(np.float32) / DIM**0.5).to(dev)
              for _ in range(FIELDS)]
    accs = [torch.from_numpy(rng.uniform(0.0, 0.1, VOCAB).astype(np.float32)).to(dev) for _ in range(FIELDS)]
    ids = [torch.from_numpy(rng.integers(0, VOCAB, BATCH).astype(np.int32)).to(dev) for _ in range(FIELDS)]
    deduped = {}
    for mix, draw in (("zipf", lambda: _zipf_ids(rng, VOCAB, BATCH)),
                      ("uniform", lambda: rng.integers(0, VOCAB, BATCH))):
        pairs = [combine_duplicate_ids(torch.from_numpy(draw().astype(np.int32)).to(dev),
                                       torch.from_numpy((1e-3 * rng.normal(size=(BATCH, DIM))).astype(np.float32)).to(dev),
                                       sentinel=VOCAB) for _ in range(FIELDS)]
        deduped[mix] = ([u for u, _ in pairs], [g for _, g in pairs])
    want_rows = gather_rows_multi_ref(tables, ids)
    want_upd = {mix: fused_rowwise_adagrad_multi_ref([t.clone() for t in tables], [a.clone() for a in accs],
                                                     *deduped[mix], LR, EPS) for mix in deduped}
    for n, arg in enumerate(dirs):
        src = Path(arg)
        print(f"variant {n}: {src}")
        libs = build(n, src)
        gather = gather_fn(libs, tables, ids)
        rows = gather()
        torch.cuda.synchronize()
        bitwise = all(torch.equal(r, w) for r, w in zip(rows, want_rows))
        line = f"  gather {FIELDS} x [{VOCAB}, {DIM}] x {BATCH} ids: {device_ms(gather) * 1e3:.1f} us (bitwise {bitwise})"
        for mix, (uids, grads) in deduped.items():
            ts, acs = [t.clone() for t in tables], [a.clone() for a in accs]
            update = adagrad_fn(libs, ts, acs, uids, grads)
            update()
            torch.cuda.synchronize()
            wt, wa = want_upd[mix]
            ok = all(bool(((x - y).abs() <= 1e-5 * y.abs().max() + 1e-5 * y.abs()).all())
                     for x, y in zip(ts + acs, wt + wa))
            same = all(torch.equal(x, y) for x, y in zip(ts + acs, wt + wa))
            real = sum(int((u < VOCAB).sum().item()) for u in uids)
            line += (f"; adagrad {mix} ({real / FIELDS:.0f} real ids a table): {device_ms(update) * 1e3:.1f} us "
                     f"(within tolerance {ok}, bitwise {same})")
        print(line)
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
