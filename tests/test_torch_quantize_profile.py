"""Int8 serving, step profiles and the matmul precision of the port against
the JAX package, on the CPU.

- ``ops/quantize.py``: ``quantize_table`` bit for bit JAX's (values and
  scales, ties rounded half to even, zero rows), ``dequantize_rows``
  exactly, ``quantized_scores`` at the forward tolerance in item chunks;
  ``Recommender(quantize=True)`` recommends JAX's quantized ids where the
  scores are untied, and refuses models other than MF as JAX does.
- ``utils/profile.py``: ``StepProfiler`` starts and stops at the steps
  JAX's does (a recording ``jax.profiler`` in its place), writes its trace
  only for the window, and ``span`` ranges land in it.
- ``ops/precision.py``: each ``train.matmul_precision`` sets its flags, and
  the next Trainer's setting replaces them; "bfloat16" rounds the operands
  of matmuls and convolutions to bf16 and returns f32, gradients unrounded.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfrec_tpu.utils.profile as jax_profile
from tfrec_tpu.models import DataSpec as JaxDataSpec
from tfrec_tpu.models.mf import MF as JaxMF
from tfrec_tpu.ops import quantize as jax_quantize
from tfrec_tpu.serve import Recommender as JaxRecommender
from tfrec_tpu_torch import configs
from tfrec_tpu_torch.convert import params_from_jax
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.ops import precision, quantize
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train.trainer import Trainer
from tfrec_tpu_torch.utils import profile

torch.set_num_threads(1)

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
USERS, ITEMS, DIM = 40, 300, 16


def _table(seed=0, v=ITEMS, d=DIM):
    t = np.random.default_rng(seed).normal(size=(v, d)).astype(np.float32)
    t[3] = 0.0  # a zero row: scale 1
    t[5] = np.arange(d, dtype=np.float32) - d / 2
    t[5, 0] = 127.0  # absmax 127: scale 1, so the ties below round half to even
    t[5, 1:4] = (0.5, 1.5, -2.5)
    return t


def test_quantize_table_is_jaxs_bit_for_bit():
    t = _table()
    got = quantize.quantize_table(torch.from_numpy(t))
    want = jax_quantize.quantize_table(jnp.asarray(t))
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert got.scales[3] == 1.0 and list(got.values[5, 1:4]) == [0, 2, -2]  # half to even
    assert got.values.numel() * got.values.element_size() * 4 == t.nbytes


def test_dequantize_rows_is_jaxs():
    t = _table(1)
    ids = np.array([0, 3, 5, ITEMS - 1, ITEMS + 7, -2], np.int32)
    got = quantize.dequantize_rows(quantize.quantize_table(torch.from_numpy(t)), torch.from_numpy(ids))
    want = jax_quantize.dequantize_rows(jax_quantize.quantize_table(jnp.asarray(t)), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("chunk", [7, 1 << 16])
@pytest.mark.parametrize("with_bias", [False, True])
def test_quantized_scores_match_jax(chunk, with_bias):
    t = _table(2)
    u = np.random.default_rng(3).normal(size=(9, DIM)).astype(np.float32)
    bias = np.random.default_rng(4).normal(size=ITEMS).astype(np.float32) if with_bias else None
    got = quantize.quantized_scores(torch.from_numpy(u), quantize.quantize_table(torch.from_numpy(t)),
                                    None if bias is None else torch.from_numpy(bias), chunk=chunk)
    want = jax_quantize.quantized_scores(jnp.asarray(u), jax_quantize.quantize_table(jnp.asarray(t)),
                                         None if bias is None else jnp.asarray(bias))
    assert got.shape == (9, ITEMS) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_RTOL, atol=FWD_ATOL)
    full = u @ t.T + (0.0 if bias is None else bias)
    assert np.abs(got.numpy() - full).max() < 0.05 * np.abs(full).max()  # rounding error only


def _mf_recommenders():
    jmodel = JaxMF(JaxDataSpec.interaction(USERS, ITEMS), DIM)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda a: (a + 0.3 * rng.normal(size=a.shape)).astype(np.float32), params)
    model = build_model(configs.ModelConfig(name="mf", embed_dim=DIM), DataSpec.interaction(USERS, ITEMS))
    jrec = JaxRecommender(jmodel, jax.tree.map(jnp.asarray, params), quantize=True, topk_method="exact")
    return jrec, Recommender(model, params_from_jax(params, model), device="cpu", quantize=True), model


def test_quantized_recommend_matches_jax_where_untied():
    jrec, rec, _ = _mf_recommenders()
    users = np.arange(USERS, dtype=np.int32)
    got_s, want_s = rec.score_catalog(users), np.asarray(jrec.score_catalog(users))
    np.testing.assert_allclose(got_s, want_s, rtol=FWD_RTOL, atol=FWD_ATOL)
    k = 20
    got_ids, got_vals = rec.recommend(users, k, exclude_train=False)
    want_ids, want_vals = (np.asarray(x) for x in jrec.recommend(users, k, exclude_train=False))
    np.testing.assert_allclose(got_vals, want_vals, rtol=FWD_RTOL, atol=FWD_ATOL)
    # Ranks whose neighbours' scores are apart by more than the rounding.
    srt = np.sort(want_s, axis=1)[:, ::-1][:, : k + 1]
    untied = np.abs(np.diff(srt, axis=1)) > 1e-4
    sure = np.logical_and(untied[:, :k], np.concatenate([np.ones((USERS, 1), bool), untied[:, : k - 1]], 1))
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got_ids[sure], want_ids[sure])


def test_quantize_serves_mf_only_and_predict_keeps_the_f32_rows():
    _, rec, model = _mf_recommenders()
    plain = Recommender(model, rec.params, device="cpu")
    users, items = np.arange(8, dtype=np.int32), np.arange(8, dtype=np.int32)
    np.testing.assert_array_equal(rec.predict(users, items), plain.predict(users, items))
    gmf = build_model(configs.ModelConfig(name="gmf", embed_dim=8), DataSpec.interaction(USERS, ITEMS))
    params = gmf.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="quantize=True supports the MF dot-product scorer only; got GMF"):
        Recommender(gmf, params, device="cpu", quantize=True)


# ---- step profiles ----

WINDOWS = [(0, 1), (1, 2), (2, 6), (3, 4), (5, 100)]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_step_profiler_starts_and_stops_where_jaxs_does(window, stride, monkeypatch, tmp_path):
    """The steps at which a trace starts and stops, against JAX's
    StepProfiler with a recording ``jax.profiler``; a trace file exactly
    for each traced window."""
    calls = []
    monkeypatch.setattr(jax_profile.jax.profiler, "start_trace", lambda d: calls.append("start"))
    monkeypatch.setattr(jax_profile.jax.profiler, "stop_trace", lambda: calls.append("stop"))
    ref, port = jax_profile.StepProfiler(window), profile.StepProfiler(window, out_dir=str(tmp_path))
    got, want = [], []
    for step in range(0, 12, stride):
        n, was = len(calls), port.active
        ref.step(step)
        port.step(step)
        want.append(calls[n] if len(calls) > n else None)
        got.append(None if port.active == was else ("start" if port.active else "stop"))
    ref.close()
    port.close()
    assert got == want
    traced = any(window[0] <= s < window[1] for s in range(0, 12, stride))
    assert (tmp_path / f"trace_{window[0]}_{window[1]}.json").exists() == traced
    assert port.path == (str(tmp_path / f"trace_{window[0]}_{window[1]}.json") if traced else None)


def test_trace_holds_the_window_only_and_annotate_and_timer_work(tmp_path):
    prof = profile.StepProfiler((2, 4), out_dir=str(tmp_path))
    for step in range(6):
        prof.step(step)
        with profile.span(f"step_{step}"):
            torch.ones(8).sum()
    events = json.loads((tmp_path / "trace_2_4.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"step_2", "step_3"} <= names and not names & {"step_0", "step_1", "step_4", "step_5"}
    assert profile.StepProfiler(None).step(0) is None and profile.default_trace_dir().endswith("tfrec_trace")


# ---- matmul precision ----

FLAGS = {"default": (False, False), "highest": (False, False), "float32": (False, False),
         "high": (True, False), "tensorfloat32": (True, False), "bfloat16": (False, True)}


def _tiny(precision_name):
    return configs.Config(
        data=configs.DataConfig(source="synthetic_ctr", num_examples=600, num_dense_features=3,
                                categorical_vocab_sizes=(50,) * 2, test_fraction=0.5, seed=3),
        model=configs.ModelConfig(name="dcn", embed_dim=4, num_cross_layers=1, mlp_dims=(8,)),
        train=configs.TrainConfig(batch_size=64, epochs=1, loss="logloss",
                                  matmul_precision=precision_name),
        mesh=configs.MeshConfig(data_axis_size=0))


@pytest.mark.parametrize("name", list(FLAGS))
def test_each_precision_sets_its_flags_and_the_next_trainer_restores_them(name):
    tf32, bf16 = FLAGS[name]
    Trainer(_tiny(name), quiet=True, device="cpu")
    assert precision.current() == {"tf32_matmul": tf32, "tf32_conv": tf32, "bf16_operands": bf16}
    Trainer(_tiny("default"), quiet=True, device="cpu")
    assert precision.current() == {"tf32_matmul": False, "tf32_conv": False, "bf16_operands": False}
    with pytest.raises(ValueError, match="unknown train.matmul_precision"):
        Trainer(_tiny("fp8"), quiet=True, device="cpu")


def test_bfloat16_rounds_the_operands_and_returns_f32():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(6, 40, generator=g), torch.randn(40, 5, generator=g)
    x, w = torch.randn(2, 3, 9, 9, generator=g), torch.randn(4, 3, 3, 3, generator=g)

    def r(t):
        return t.to(torch.bfloat16).to(torch.float32)

    try:
        precision.set_matmul_precision("bfloat16")
        a.requires_grad_()
        got = [a @ b, torch.matmul(a, b), torch.einsum("ij,jk->ik", a, b),
               torch.nn.functional.linear(a, b.T), torch.nn.functional.conv2d(x, w)]
        (grad,) = torch.autograd.grad((a @ b).sum(), a)
    finally:
        precision.set_matmul_precision("default")
    a = a.detach()
    want = [r(a) @ r(b)] * 4 + [torch.nn.functional.conv2d(r(x), r(w))]
    for gv, wv in zip(got, want):
        assert gv.dtype == torch.float32
        torch.testing.assert_close(gv, wv, rtol=0, atol=1e-6)
    assert not torch.equal(got[0], a @ b)
    torch.testing.assert_close(grad, torch.ones(6, 5) @ r(b).T, rtol=0, atol=1e-6)
