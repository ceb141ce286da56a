#!/usr/bin/env python3
"""Drive tfrec_tpu_torch's serving slice on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and nvcc (it builds the kernels from kernels/csrc/), and exits
non-zero if any phase fails:

1. environment: CUDA present; the card's name and power limit; TF32 off;
2. build: nvcc compiles every kernel source into build/tfrec_tpu_torch/;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at edge cases;
4. the main path: ``dcn_criteo`` at Criteo's shape (26 fields of 100 000
   rows, d=32, 13 dense features, 3 cross layers, MLP 512/256/128) from a
   seeded generator, serving batches of 8192 through
   ``Recommender.predict_ctr``; the logits must be finite, match the same
   model run through the plain versions on the card and, on a small input,
   on the CPU; launch counters prove both kernels ran;
5. times with CUDA events: each kernel beside its bound, its plain version
   and the one PyTorch call that computes the same function where there
   is one; predict_ctr's latency; a profile of one request batch.

The last lines are the kernels' JSON record and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tfrec_tpu_torch import zoo_configs
from tfrec_tpu_torch.kernels import _build
from tfrec_tpu_torch.kernels.cross import cross_stack_ref
from tfrec_tpu_torch.kernels.cross_cuda import cross_v1_fwd, cross_v1_fwd_ref
from tfrec_tpu_torch.kernels.gather_cuda import gather_rows, gather_rows_ref
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.serve import Recommender

SEED = 0
DEVICE = "cuda"
BATCH = 8192
NUM_BATCHES = 4
# H100 SXM peaks (NVIDIA data sheet), at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Reordered f32 row dots: the error scales with the size of the terms, not
# of the sum, so the absolute tolerance is relative to the largest value.
RTOL = 1e-5
ATOL_REL = 1e-5
# Logits add the cross output's error over a head of d + 128 inputs.
LOGIT_TOL = 1e-4

KERNELS = {
    "gather_rows": {
        "source": "tfrec_tpu_torch/kernels/csrc/gather.cu",
        "replaces": "tfrec_tpu/kernels/gather_pallas.py:89",
    },
    "cross_v1_fwd": {
        "source": "tfrec_tpu_torch/kernels/csrc/cross.cu",
        "replaces": "tfrec_tpu/kernels/cross_pallas.py:123",
    },
}


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
    return errs


def phase_main_path(rng):
    cfg = zoo_configs.dcn_criteo(path="criteo")  # Criteo's shape; data is synthetic
    vocabs = tuple(cfg.data.categorical_vocab_sizes)
    spec = DataSpec.ctr(vocabs, cfg.data.num_dense_features)
    model = build_model(cfg.model, spec)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    table_mb = sum(t.numel() * t.element_size() for t in params["tables"].values()) / 1e6
    print(f"model: dcn_criteo, {len(vocabs)} fields x {vocabs[0]} rows, d={cfg.model.embed_dim}, "
          f"input_dim {model.input_dim}, {cfg.model.num_cross_layers} cross layers, "
          f"MLP {cfg.model.mlp_dims}; tables {table_mb:.1f} MB")
    rec = Recommender(model, params)  # the default device, the card
    requests = make_requests(rng, vocabs, cfg.data.num_dense_features)

    for wrapper in (gather_rows, cross_v1_fwd):
        wrapper.launches = 0
    logits = [rec.predict_ctr(dense, cat) for dense, cat in requests]
    torch.cuda.synchronize()
    launches = {"gather_rows": gather_rows.launches, "cross_v1_fwd": cross_v1_fwd.launches}
    print(f"main path: {NUM_BATCHES} batches of {BATCH}, launches {launches}")
    check(launches["gather_rows"] == len(vocabs) * NUM_BATCHES, "gather_rows ran once per field per batch")
    check(launches["cross_v1_fwd"] == NUM_BATCHES, "cross_v1_fwd ran once per batch")

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


def phase_times(model, rec, requests, launches, errs) -> list:
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
    c_bound, c_by = bound_ms(bsz * dim * 4 * 2 + 2 * layers * dim * 4, 5 * layers * bsz * dim)

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
    profile(rec, dense, cat, latency)
    return [
        {"name": "gather_rows", "route": "cuda", "launches": launches["gather_rows"],
         "max_abs_err": errs["gather_rows"], "ms": g_ms, "plain_ms": g_plain,
         "bound_ms": g_bound, "bound_by": g_by, "library_ms": g_lib},
        {"name": "cross_v1_fwd", "route": "cuda", "launches": launches["cross_v1_fwd"],
         "max_abs_err": errs["cross_v1_fwd"], "ms": c_ms, "plain_ms": c_plain,
         "bound_ms": c_bound, "bound_by": c_by, "library_ms": None},
    ]


def profile(rec, dense, cat, latency_ms: float) -> None:
    """Device time by kernel and copy over one predict_ctr call, and the
    device's busy share of the unprofiled median latency."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rec.predict_ctr(dense, cat)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        print("profile: the profiler recorded no device time")
        return
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"profile of one predict_ctr: device busy {busy_us:.1f} us = "
          f"{100 * busy_us / (latency_ms * 1e3):.1f}% of the median latency")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total:9.1f} us  x{e.count:<3d} {e.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    rng = np.random.default_rng(SEED)
    phase_environment()
    phase_build()
    errs = phase_kernels(rng)
    model, rec, requests, launches = phase_main_path(rng)
    records = phase_times(model, rec, requests, launches, errs)
    for r in records:
        r.update({k: KERNELS[r["name"]][k] for k in ("source", "replaces")})
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
