"""MLPerf's DLRM-DCNv2 in the port (the port's alone: the JAX package has no
DCN interaction in DLRM and mean-combines every bag): ``DLRM(interaction=
"dcn", combiner="sum")`` against a plain float32 reference written here, on
one device and through the sharded step at world 4 over gloo; the defaults
("dot", "mean") unchanged; the sharded step's spans and exchange counters.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from tfrec_tpu_torch.configs import OptimConfig
from tfrec_tpu_torch.models import DataSpec
from tfrec_tpu_torch.models.ctr_base import CTRBase
from tfrec_tpu_torch.models.dlrm import DLRM
from tfrec_tpu_torch.parallel.embedding import _length_classes, capacity_for
from tfrec_tpu_torch.train.step import TrainStepBuilder

from torch_dist_worker import run_ranks

VOCABS = (50, 7, 300, 32, 20)
WIDTHS = (3, 1, 5, 2, 1)  # uneven bags
NUM_DENSE, DIM, BATCH, STEPS, WORLD = 3, 8, 64, 3, 4
KW = dict(bottom_dims=(16,), top_dims=(32, 16), interaction="dcn", num_cross_layers=2, cross_rank=4,
          combiner="sum")
OPTIM = dict(dense_optimizer="adam", sparse_optimizer="rowwise_adagrad", learning_rate=0.01)
SPANS = ("tfrec.step", "tfrec.lookup", "tfrec.exchange.lookup", "tfrec.forward", "tfrec.bag_pool",
         "tfrec.backward", "tfrec.dense_allreduce", "tfrec.dense_update", "tfrec.sparse_update",
         "tfrec.exchange.update")


def _spec(widths=WIDTHS):
    return DataSpec.ctr(VOCABS, NUM_DENSE, widths)


def _model(**kw):
    return DLRM(_spec(), DIM, **{**KW, **kw})


def _batches(seed, n=STEPS):
    """Global batches; about a tenth of the bag slots padded with the
    field's sentinel (its vocab), which the combine masks out."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cols = []
        for v, w in zip(VOCABS, WIDTHS):
            ids = rng.integers(0, v, (BATCH, w))
            if w > 1:
                ids = np.where(rng.random((BATCH, w)) < 0.1, v, ids)
            cols.append(ids)
        out.append({"cat": np.concatenate(cols, axis=1).astype(np.int32),
                    "dense": rng.random((BATCH, NUM_DENSE)).astype(np.float32),
                    "label": (rng.random(BATCH) < 0.3).astype(np.float32)})
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---- the plain reference ----

def _ref_logits(dense, tables, batch):
    x = batch["dense"]
    for w, b in dense["bottom"]:
        x = torch.relu(x @ w + b)
    parts, off = [x], 0
    for f, (v, w) in enumerate(zip(VOCABS, WIDTHS)):
        ids = batch["cat"][:, off:off + w].long()
        off += w
        rows = tables[f][ids.clamp(max=v - 1)] * (ids < v)[:, :, None]
        parts.append(rows.sum(dim=1))
    x0 = torch.cat(parts, dim=1)
    x, c = x0, dense["cross"]
    for layer in range(c["b"].shape[0]):
        x = x0 * ((x @ c["v"][layer]) @ c["u"][layer].T + c["b"][layer]) + x
    top = dense["top"]
    for i, (w, b) in enumerate(top):
        x = x @ w + b
        if i < len(top) - 1:
            x = torch.relu(x)
    return x[:, 0]


def _flat(dense):
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + (k,))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, path + (i,))
        else:
            out[path] = x

    walk(dense, ())
    return out


def _rebuild(template, flat, path=()):
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, path + (k,)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, flat, path + (i,)) for i, v in enumerate(template))
    return flat[path]


def _ref_steps(dense, tables, batches, lr=0.01, b1=0.9, b2=0.999, eps=1e-8):
    """Adam on the dense params, rowwise Adagrad (from 0) on the rows, each
    row's gradient summed over its ids in the batch."""
    params = {k: v.clone() for k, v in _flat(dense).items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    s = {k: torch.zeros_like(v) for k, v in params.items()}
    tables = [t.clone() for t in tables]
    accs = [torch.zeros(t.shape[0]) for t in tables]
    losses = []
    for step, batch in enumerate(batches, start=1):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        leaves = [t.clone().requires_grad_() for t in tables]
        loss = torch.nn.functional.binary_cross_entropy_with_logits(
            _ref_logits(_rebuild(dense, p), leaves, batch), batch["label"])
        grads = torch.autograd.grad(loss, [*p.values(), *leaves])
        c1, c2 = float(np.float32(1) - np.float32(b1) ** step), float(np.float32(1) - np.float32(b2) ** step)
        for (k, v), g in zip(params.items(), grads):
            m[k] = b1 * m[k] + (1 - b1) * g
            s[k] = b2 * s[k] + (1 - b2) * g * g
            params[k] = v - lr * (m[k] / c1) / ((s[k] / c2).sqrt() + eps)
        for t, acc, g in zip(tables, accs, grads[len(params):]):
            hit = (g != 0).any(dim=1)
            acc[hit] += (g[hit] * g[hit]).mean(dim=1)
            t[hit] -= lr * g[hit] / (acc[hit].sqrt() + eps)[:, None]
        losses.append(float(loss.detach()))
    return _rebuild(dense, params), tables, losses


def _port_steps(model, batches, seed=5):
    builder = TrainStepBuilder(model, "logloss", OptimConfig(**OPTIM), device="cpu")
    state = builder.init_state(torch.Generator().manual_seed(seed))
    start = {"dense": _rebuild(state["dense"], {k: v.clone() for k, v in _flat(state["dense"]).items()}),
             "tables": [state["tables"][f"field_{f}"].clone() for f in range(len(VOCABS))]}
    losses = []
    for b in batches:
        state, metrics = builder.step(state, _t(b))
        losses.append(float(metrics["loss"]))
    return start, state, losses


def _close(got, want, rtol=2e-5, atol=2e-6):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_dcn_interaction_with_summed_bags_matches_the_plain_reference():
    model = _model()
    assert model.input_dim == (len(VOCABS) + 1) * DIM and model.combiner == "sum"
    batches = _batches(11)
    start, state, losses = _port_steps(model, batches)
    dense = start["dense"]
    assert set(dense) == {"top", "bottom", "cross"} and dense["cross"]["u"].shape == (2, model.input_dim, 4)
    assert len(dense["top"]) == 3 and dense["top"][0][0].shape == (model.input_dim, 32)
    gathered = {f"field_{f}": start["tables"][f][torch.from_numpy(b).long().clamp(max=v - 1).reshape(-1)]
                for f, (v, b) in enumerate(zip(VOCABS, _field_ids(batches[0])))}
    _close(model(dense, gathered, _t(batches[0])), _ref_logits(dense, start["tables"], _t(batches[0])))
    ref_dense, ref_tables, ref_losses = _ref_steps(dense, start["tables"], [_t(b) for b in batches])
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for k, v in _flat(ref_dense).items():
        _close(_flat(state["dense"])[k], v)
    for f, t in enumerate(ref_tables):
        _close(state["tables"][f"field_{f}"], t)


def _field_ids(batch):
    """Each field's [B * W] ids, example by example, as the port looks them up."""
    out, off = [], 0
    for w in WIDTHS:
        out.append(batch["cat"][:, off:off + w].reshape(-1))
        off += w
    return out


def test_mean_stays_the_default_and_dot_is_unchanged():
    dot = DLRM(_spec(), DIM, bottom_dims=(16,), top_dims=(32, 16))
    assert (dot.interaction, dot.combiner) == ("dot", "mean")
    assert set(dot.init_dense(torch.Generator().manual_seed(0), "cpu")) == {"top", "bottom"}
    summed = DLRM(_spec(), DIM, bottom_dims=(16,), top_dims=(32, 16), combiner="sum")
    params = dot.init(torch.Generator().manual_seed(3), "cpu")
    batch = _t(_batches(4, 1)[0])
    gathered = {f"field_{f}": params["tables"][f"field_{f}"][torch.from_numpy(i).long().clamp(max=v - 1)]
                for f, (v, i) in enumerate(zip(VOCABS, _field_ids(_batches(4, 1)[0])))}
    # The dot path by hand: bottom (no ReLU on its last layer), bags by
    # their masked mean (or sum), the pairs of the strict lower triangle.
    bottom = batch["dense"]
    for i, (w, b) in enumerate(params["dense"]["bottom"]):
        bottom = bottom @ w + b
        bottom = torch.relu(bottom) if i == 0 else bottom
    for model, mean in ((dot, True), (summed, False)):
        vecs, off = [bottom], 0
        for f, (v, w) in enumerate(zip(VOCABS, WIDTHS)):
            ids = batch["cat"][:, off:off + w]
            off += w
            valid = (ids < v)[:, :, None]
            rows = torch.where(valid, gathered[f"field_{f}"].view(BATCH, w, DIM), 0.0).sum(dim=1)
            vecs.append(rows / valid.sum(dim=1).clamp_min(1) if mean else rows)
        z = torch.stack(vecs, dim=1)
        r, c = torch.tril_indices(len(vecs), len(vecs), -1)
        x = torch.cat([bottom, (z @ z.transpose(1, 2))[:, r, c]], dim=1)
        for i, (w, b) in enumerate(params["dense"]["top"]):
            x = x @ w + b
            x = torch.relu(x) if i < 2 else x
        _close(model(params["dense"], gathered, batch), x[:, 0])
    with pytest.raises(ValueError, match="unknown bag combiner"):
        DLRM(_spec(), DIM, combiner="max")
    with pytest.raises(ValueError, match="unknown DLRM interaction"):
        DLRM(_spec(), DIM, interaction="cat")
    single = DLRM(_spec((1,) * len(VOCABS)), DIM)
    assert isinstance(single, CTRBase) and single.combiner == "mean"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _port_steps(_model(), _batches(2, 1))
        _port_steps(DLRM(_spec((1,) * len(VOCABS)), DIM, **KW), [{**_batches(2, 1)[0], "cat": _batches(2, 1)[0][
            "cat"][:, np.cumsum((0,) + WIDTHS[:-1])]}])
    names = [e.name for e in prof.events()]
    # One bag_pool a step of the model with bags; none for single-hot fields.
    assert names.count("tfrec.bag_pool") == 1 and names.count("tfrec.step") == 2


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    batches = _batches(21)
    model = _model()
    start, state, losses = _port_steps(model, batches, seed=9)
    init = TrainStepBuilder(_model(), "logloss", OptimConfig(**OPTIM), device="cpu").init_state(
        torch.Generator().manual_seed(9))
    spec = {"dlrm": {"vocabs": VOCABS, "widths": WIDTHS, "num_dense": NUM_DENSE, "dim": DIM,
                     "kw": {**KW, "bottom_dims": list(KW["bottom_dims"]), "top_dims": list(KW["top_dims"])}},
            "loss": "logloss", "optim": OPTIM, "batches": batches,
            "state": _np_tree(init),
            "mesh_kw": {"a2a_dtype": "float32", "table_sharding": "row", "row_permute": False}}
    got = run_ranks("multihot", WORLD, spec, tmp_path_factory.mktemp("multihot"), timeout=150.0)
    return batches, start, state, losses, got


def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np_tree(v) for v in x)
    return x.numpy() if isinstance(x, torch.Tensor) else x


def test_sharded_multihot_steps_at_world_4(world4):
    """Rows of one global batch over 4 ranks, each table in 4 contiguous
    blocks: the single-device step's losses and state, to the rounding of
    sums taken in another order (a rank's dense gradient and its ids'
    duplicates are summed before the all_reduce and the owner's combine),
    and the plain reference's; no id dropped."""
    batches, start, state, losses, got = world4
    assert got["overflow"] == [0] * STEPS
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-6)
    for k, v in _flat(state["dense"]).items():
        _close(torch.from_numpy(np.asarray(_flat(got["state"]["dense"])[k])), v, rtol=1e-5, atol=1e-6)
    for f in range(len(VOCABS)):
        _close(torch.from_numpy(got["state"]["tables"][f"field_{f}"]), state["tables"][f"field_{f}"],
               rtol=1e-5, atol=1e-6)
    ref_dense, ref_tables, ref_losses = _ref_steps(start["dense"], start["tables"], [_t(b) for b in batches])
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-5)
    for f, t in enumerate(ref_tables):
        _close(torch.from_numpy(got["state"]["tables"][f"field_{f}"]), t)


def test_sharded_step_opens_each_span_once_and_counts_its_wire(world4):
    """Rank 0's counters after 3 steps: every exchange's bytes are its
    padded [N, C] buffers', each table's capacity C for its ids' length
    class (tables of bags within a factor of two in one padded batch);
    ``lookup_ids`` the bag slots looked up; no overflow."""
    _, _, _, _, got = world4
    assert {n: got["spans"].get(n) for n in SPANS} == {n: 1 for n in SPANS}
    b = BATCH // WORLD
    padded = _length_classes([b * w for w in WIDTHS])
    assert sorted(set(padded.values())) == [2 * b, 5 * b]  # (1, 1, 2) and (3, 5) share batches
    caps = [capacity_for(padded[b * w], WORLD, 2.0) for w in WIDTHS]
    c = got["counters"]
    assert c["a2a_bytes.ids"] == STEPS * WORLD * sum(caps) * 4
    assert c["a2a_bytes.lookup"] == c["a2a_bytes.update"] == STEPS * WORLD * sum(caps) * DIM * 4
    assert c["lookup_ids"] == STEPS * b * sum(WIDTHS) and c["lookup_overflow"] == 0
    assert 0 < c["distinct_sent"] <= STEPS * sum(caps) * WORLD and math.isfinite(c["distinct_sent"])


@pytest.mark.parametrize("runs", ["hot", "short"])
def test_segment_sums_take_a_hot_id_in_runs(runs):
    """The combine's segment sums: a segment longer than ``SUM_RUN`` rows
    sums its runs, then their partial sums, in a fixed order (the same bits
    on repeat, the exact sum to rounding); a segment no longer sums bit for
    bit as in one pass."""
    from tfrec_tpu_torch.ops.embedding import SUM_RUN, _one_pass, _segment_sums

    g = torch.Generator().manual_seed(7)
    m = 3000
    if runs == "hot":  # one id takes half the rows, the rest of Zipf's tail
        ids = torch.cat([torch.zeros(m // 2, dtype=torch.int64), torch.randint(1, 400, (m - m // 2,), generator=g)])
    else:
        ids = torch.randint(0, 10 * m, (m,), generator=g)
    ids = torch.sort(ids).values
    seg = torch.cumsum((torch.cat([ids[:1] * 0 + 1, (ids[1:] != ids[:-1]).long()])), 0) - 1
    rows = torch.randn((m, 6), generator=g)
    runs_of = _segment_sums(seg, rows)
    assert torch.equal(runs_of, _segment_sums(seg, rows))
    exact = torch.zeros((m, 6), dtype=torch.float64).index_add_(0, seg, rows.double())
    torch.testing.assert_close(runs_of.double(), exact, rtol=1e-5, atol=1e-4)
    longest = int(torch.bincount(seg).max())
    assert (longest > SUM_RUN) == (runs == "hot")
    if runs == "short":
        assert torch.equal(runs_of, _one_pass(seg, rows))
