"""The port's native C++ evaluator (``eval/native.py``, over the
unmodified ``csrc/eval_native.cpp``, built into the port's own build
directory) against the port's device evaluator and the JAX package's
binding, on the CPU: its metrics are ``eval/retrieval.py``'s within
rtol 1e-5 and atol 1e-6 (tests/test_native_eval.py:39-68 holds JAX's so),
JAX's bit for bit (the same C++), and the same at 1 and 4 threads."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tfrec_tpu.eval import native as jax_native
from tfrec_tpu_torch.eval import native
from tfrec_tpu_torch.eval.metrics import ranking_metrics_from_topk
from tfrec_tpu_torch.eval.retrieval import padded_positives, topk_scores
from tfrec_tpu_torch.kernels import _build

RTOL, ATOL = 1e-5, 1e-6
KS = (5, 20)


@pytest.fixture(scope="module", autouse=True)
def jax_library_in_tmp(tmp_path_factory):
    """JAX's binding builds its library into a directory of this module's
    own, so that it never races tests/test_native_eval.py's build of
    build/libtfrec_eval.so in another worker."""
    d = tmp_path_factory.mktemp("jax_native")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_BUILD_DIR", str(d))
        mp.setattr(jax_native, "_SO", str(d / "libtfrec_eval.so"))
        mp.setattr(jax_native, "_lib", None)
        yield


def _problem(seed, num_users=40, num_items=120):
    """Scores, a train split and a disjoint test split (some users
    without test items)."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(num_users, num_items)).astype(np.float32)
    train = (rng.random((num_users, num_items)) < 0.10).astype(np.float32)
    test = (rng.random((num_users, num_items)) < 0.05).astype(np.float32)
    test[train > 0] = 0
    test[:3] = 0
    return scores, sp.csr_matrix(train), sp.csr_matrix(test)


def _device_metrics(scores, train, test, ks=KS):
    tr_p, tr_c = padded_positives(train)
    te_p, te_c = padded_positives(test)
    _, top = topk_scores(torch.from_numpy(scores), max(ks), torch.from_numpy(tr_p), torch.from_numpy(tr_c))
    return ranking_metrics_from_topk(top, torch.from_numpy(te_p), torch.from_numpy(te_c), ks)


def test_library_builds_into_the_ports_directory():
    native.load()
    assert _build.library_path("eval_native").exists()
    assert _build.library_path("eval_native").parent.name == "tfrec_tpu_torch"
    assert native.NativeUnavailable is _build.NativeUnavailable


@pytest.mark.parametrize("seed", [0, 1])
def test_scores_native_matches_the_device_evaluator_and_jax(seed):
    scores, train, test = _problem(seed)
    got = native.evaluate_scores_native(scores, train, test, KS)
    want = _device_metrics(scores, train, test)
    assert sorted(got) == sorted(f"{m}@{k}" for m in native.METRIC_NAMES for k in KS)
    for key, v in got.items():
        np.testing.assert_allclose(v, float(want[key]), rtol=RTOL, atol=ATOL, err_msg=key)
    assert got == jax_native.evaluate_scores_native(scores, train, test, KS)
    # A tensor is read from wherever it lies.
    assert native.evaluate_scores_native(torch.from_numpy(scores), train, test, KS) == got


@pytest.mark.parametrize("with_bias", [True, False])
def test_dot_native_matches_the_device_evaluator_and_jax(with_bias):
    """User and item vectors (and a bias) against the scores they make,
    ranked by the device evaluator."""
    rng = np.random.default_rng(2)
    u = rng.normal(size=(30, 8)).astype(np.float32)
    v = rng.normal(size=(90, 8)).astype(np.float32)
    bias = rng.normal(size=(90, 1)).astype(np.float32) if with_bias else None
    _, train, test = _problem(3, 30, 90)
    got = native.evaluate_dot_native(torch.from_numpy(u), torch.from_numpy(v),
                                     None if bias is None else torch.from_numpy(bias), train, test, KS)
    scores = torch.from_numpy(u) @ torch.from_numpy(v).T
    if bias is not None:
        scores = scores + torch.from_numpy(bias)[:, 0][None, :]
    want = _device_metrics(scores.numpy(), train, test)
    for key, val in got.items():
        np.testing.assert_allclose(val, float(want[key]), rtol=RTOL, atol=ATOL, err_msg=key)
    assert got == jax_native.evaluate_dot_native(u, v, None if bias is None else bias[:, 0], train, test, KS)


def test_threads_are_deterministic_and_unsorted_csr_is_read():
    scores, train, test = _problem(4)
    one = native.evaluate_scores_native(scores, train, test, (10,), num_threads=1)
    assert one == native.evaluate_scores_native(scores, train, test, (10,), num_threads=4)
    assert one == native.evaluate_scores_native(scores, train, test, (10,))
    shuffled = train.copy()
    for r in range(shuffled.shape[0]):
        lo, hi = shuffled.indptr[r], shuffled.indptr[r + 1]
        shuffled.indices[lo:hi] = shuffled.indices[lo:hi][::-1]
    shuffled.has_sorted_indices = False
    assert native.evaluate_scores_native(scores, shuffled, test, (10,), num_threads=2) == one


def test_unbuildable_library_raises_native_unavailable(monkeypatch, tmp_path):
    """A missing compiler is ``NativeUnavailable``, never a quiet fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(native.NativeUnavailable, match="failed to build"):
        native.load()
