"""The port's own spans (``utils/profile.span``) on the CPU: one step of
``TrainStepBuilder`` and one ``Recommender.predict_ctr`` call of a tiny DLRM
and a tiny low-rank DCN-v2 open each of their ``tfrec.*`` spans once, nested
in their layers' order, and change nothing they compute; with no profiler
running no ``record_function`` is made at all."""

import numpy as np
import pytest
import torch

from tfrec_tpu_torch.configs import ModelConfig, OptimConfig
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train.step import TrainStepBuilder, copy_state, tree_leaves
from tfrec_tpu_torch.utils import profile

torch.set_num_threads(1)

VOCABS = (37, 52, 45, 60)
NUM_DENSE = 3
BATCH = 32
MODELS = {"dlrm": dict(mlp_dims=(16, 8)), "dcnv2": dict(num_cross_layers=2, cross_rank=4, mlp_dims=(16,))}
TRAIN_SPANS = ["tfrec.step", "tfrec.lookup", "tfrec.forward", "tfrec.backward", "tfrec.dense_update",
               "tfrec.combine", "tfrec.sparse_update"]
SERVE_SPANS = ["tfrec.serve.predict_ctr", "tfrec.serve.inputs", "tfrec.lookup", "tfrec.forward",
               "tfrec.serve.outputs"]


def _model(name):
    return build_model(ModelConfig(name=name, embed_dim=8, **MODELS[name]), DataSpec.ctr(VOCABS, NUM_DENSE))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"dense": rng.normal(size=(BATCH, NUM_DENSE)).astype(np.float32),
            "cat": np.stack([rng.integers(0, v, BATCH) for v in VOCABS], axis=1).astype(np.int32),
            "label": (rng.random(BATCH) < 0.4).astype(np.float32)}


def _builder(name, cls=TrainStepBuilder):
    builder = cls(_model(name), "logloss", OptimConfig(dense_optimizer="adam",
                                                       sparse_optimizer="rowwise_adagrad"), device="cpu")
    return builder, builder.init_state(torch.Generator().manual_seed(3))


def _profiled(fn):
    """fn() under a CPU profiler -> (its result, the tfrec.* ranges as
    (name, start_ns, end_ns) in order of start)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("tfrec.")]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _assert_nested_once(spans, names):
    """Each of ``names`` once; the first holds the rest, which follow one
    another in the order given."""
    assert [n for n, _, _ in spans] == names
    (_, s0, e0), rest = spans[0], spans[1:]
    assert all(s0 <= s and e <= e0 for _, s, e in rest)
    assert all(a[2] <= b[1] for a, b in zip(rest, rest[1:]))


def test_span_makes_no_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    builder, state = _builder("dlrm")
    builder.step(state, {k: torch.from_numpy(v) for k, v in _batch(0).items()})
    Recommender(builder.model, {"tables": state["tables"], "dense": state["dense"]},
                device="cpu").predict_ctr(_batch(1)["dense"], _batch(1)["cat"])
    assert profile.span("a") is profile.span("b")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_step_spans_nest_in_order_and_change_nothing(name):
    builder, state = _builder(name)
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    plain, _ = builder.step(copy_state(state), batch)
    (traced, _), spans = _profiled(lambda: builder.step(copy_state(state), batch))
    _assert_nested_once(spans, TRAIN_SPANS)
    for a, b in zip(tree_leaves(plain), tree_leaves(traced)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_per_table_seams_combine_inside_the_sparse_update():
    class Seams(TrainStepBuilder):
        def sparse_update_deduped(self, name, table, opt_state, uids, g, lr):
            return super().sparse_update_deduped(name, table, opt_state, uids, g, lr)

    builder, state = _builder("dlrm", Seams)
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    _, spans = _profiled(lambda: builder.step(state, batch))
    _assert_nested_once(spans, [n for n in TRAIN_SPANS if n != "tfrec.combine"])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_predict_ctr_spans_nest_in_order_and_change_nothing(name):
    builder, state = _builder(name)
    rec = Recommender(builder.model, {"tables": state["tables"], "dense": state["dense"]}, device="cpu")
    req = _batch(1)
    plain = rec.predict_ctr(req["dense"], req["cat"])
    traced, spans = _profiled(lambda: rec.predict_ctr(req["dense"], req["cat"]))
    _assert_nested_once(spans, SERVE_SPANS)
    np.testing.assert_array_equal(plain, traced)
