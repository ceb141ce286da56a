"""DLRM's dot interaction (``kernels/interaction_cuda.py``).

On the CPU: the plain versions bit for bit the model's former code, a
``torch.bmm`` of the stacked vectors, their strict lower triangle by
advanced indexing and the ``cat`` with the bottom output, differentiated by
autograd; the pairs in ``np.tril_indices`` order; ``DLRM(interaction=
"dot")``'s logits and gradients in every table layout bit for bit its
former forward's. Marked ``cuda`` (they skip without a card): the kernels
against the plain versions, bit for bit on repeat and bit for bit the
former bmm at the DLRM shapes, one launch each way a DLRM step and none on
the DCN paths, a DLRM step on the card against the CPU, and the inputs the
wrapper refuses. This file imports no JAX, so the card runs it with
``python -m pytest tests/test_torch_interaction.py -q -m cuda
--noconftest``.
"""

import numpy as np
import pytest
import torch

from tfrec_tpu_torch.configs import ModelConfig, OptimConfig
from tfrec_tpu_torch.data.synthetic import synthetic_ctr
from tfrec_tpu_torch.kernels.interaction_cuda import (
    dot_interaction,
    dot_interaction_bwd,
    dot_interaction_bwd_ref,
    dot_interaction_fwd,
    dot_interaction_fwd_ref,
)
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.models.layers import apply_mlp
from tfrec_tpu_torch.ops.embedding import gather_many
from tfrec_tpu_torch.serve import Recommender
from tfrec_tpu_torch.train.step import TrainStepBuilder, copy_state, tree_leaves

torch.set_num_threads(1)

# (batch, vectors n = F', dim D, with a bottom vector): the benchmark's DLRM
# at a small batch; chip_smoke.py's zoo DLRM (dcn_criteo's 26 fields, D 32);
# the zoo tests' (5 fields, D 16); the fewest vectors at D 1 and 129; no
# bottom vector; past the kernels' register route (n > 32).
SHAPES = [(8, 27, 128, True), (8, 27, 32, True), (12, 6, 16, True), (5, 2, 1, True), (5, 2, 129, True),
          (5, 3, 1, True), (5, 3, 129, True), (6, 4, 8, False), (3, 40, 8, True)]
VOCABS = (37, 52, 45, 60, 11)
WIDTHS = (1, 1, 3, 1, 1)  # field 2 a multi-hot bag
LAYOUTS = {"per_field": {}, "lane_packed": {"lane_pack": True}, "stacked": {"stack_tables": True}}


def _former(bottom, fields):
    """The model's former interaction: stack, cat, bmm, the triangle by
    advanced indexing, cat."""
    z = torch.stack(list(fields), dim=1)
    if bottom is not None:
        z = torch.cat([bottom[:, None, :], z], dim=1)
    inter = torch.bmm(z, z.transpose(1, 2))
    nv = z.shape[1]
    rows, cols = torch.tril_indices(nv, nv, -1, device=z.device)
    pairs = inter[:, rows, cols]
    return torch.cat([bottom, pairs], dim=-1) if bottom is not None else pairs


def _vectors(batch, n, dim, has_bottom, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((n, batch, dim), generator=g).to(device)
    return (z[0] if has_bottom else None), list(z[1:] if has_bottom else z)


def _grad(batch, n, dim, has_bottom, seed=1, device="cpu"):
    width = (dim if has_bottom else 0) + n * (n - 1) // 2
    return torch.randn((batch, width), generator=torch.Generator().manual_seed(seed)).to(device)


def _former_grads(bottom, fields, grad):
    leaves = [t.detach().clone().requires_grad_() for t in ([bottom] if bottom is not None else []) + fields]
    b, f = (leaves[0], leaves[1:]) if bottom is not None else (None, leaves)
    out = _former(b, f)
    return out.detach(), torch.autograd.grad(out, leaves, grad)


def _assert_close(got, want, tol=1e-5):
    scale = max(want.abs().max().item(), 1.0) if want.numel() else 1.0
    err = (got - want).abs().max().item() if want.numel() else 0.0
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} x {scale:.3e}"


def _one_allocation(views, batch, dim):
    """The gradients are consecutive [B, D] views of one allocation."""
    base = views[0].data_ptr()
    return all(v.is_contiguous() and v.shape == (batch, dim) and v.data_ptr() == base + 4 * k * batch * dim
               for k, v in enumerate(views))


@pytest.mark.parametrize("batch,n,dim,has_bottom", SHAPES)
def test_plain_forward_is_the_former_stacked_bmm_and_triangle(batch, n, dim, has_bottom):
    bottom, fields = _vectors(batch, n, dim, has_bottom)
    got = dot_interaction_fwd(bottom, fields)  # a CPU tensor: the plain version
    assert got.shape == (batch, (dim if has_bottom else 0) + n * (n - 1) // 2)
    assert torch.equal(got, _former(bottom, fields))
    assert torch.equal(got, dot_interaction_fwd_ref(bottom, fields))


@pytest.mark.parametrize("batch,n,dim,has_bottom", SHAPES)
def test_plain_backward_is_autograd_of_the_former_indexing(batch, n, dim, has_bottom):
    """The plain backward (dP's triangle, no indexing backward, then the two
    products of the bmm's backward) gives autograd's gradients of the
    former code bit for bit."""
    bottom, fields = _vectors(batch, n, dim, has_bottom)
    grad = _grad(batch, n, dim, has_bottom)
    _, want = _former_grads(bottom, fields, grad)
    d_bottom, d_fields = dot_interaction_bwd(bottom, fields, grad)
    got = ([d_bottom] if has_bottom else []) + d_fields
    assert len(got) == len(want) == n
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _one_allocation(got, batch, dim)  # d_bottom first where there is one
    ref = dot_interaction_bwd_ref(bottom, fields, grad)
    assert all(torch.equal(a, b) for a, b in zip(got, ([ref[0]] if has_bottom else []) + ref[1]))


@pytest.mark.parametrize("n", [2, 3, 27])
def test_pairs_follow_np_tril_indices(n):
    """Pair p of the output is z_i . z_j for (i, j) the p-th of
    ``np.tril_indices(n, k=-1)``, after the bottom vector's D columns."""
    dim = 5
    bottom, fields = _vectors(4, n, dim, True, seed=n)
    z = torch.stack([bottom, *fields], dim=1).double()
    got = dot_interaction_fwd(bottom, fields)
    assert torch.equal(got[:, :dim], bottom)
    for p, (i, j) in enumerate(zip(*np.tril_indices(n, k=-1))):
        want = (z[:, i] * z[:, j]).sum(-1)
        torch.testing.assert_close(got[:, dim + p].double(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("has_bottom", [True, False])
def test_autograd_function_is_the_former_code_on_strided_fields(has_bottom):
    """Lane-packed fields are column slices of a [B, 128] pack (row stride
    128): the Function takes them as they lie; output and every gradient
    against autograd of the former code."""
    g = torch.Generator().manual_seed(4)
    pack = torch.randn((10, 128), generator=g)
    fields = [pack[:, k * 32:(k + 1) * 32] for k in range(4)]
    assert not fields[1].is_contiguous() and fields[1].stride() == (128, 1)
    bottom = torch.randn((10, 32), generator=g) if has_bottom else None
    grad = _grad(10, 5 if has_bottom else 4, 32, has_bottom, seed=5)
    want_out, want = _former_grads(bottom, fields, grad)
    leaves = [t.clone().requires_grad_() for t in ([bottom] if has_bottom else []) + [pack]]
    views = [leaves[-1][:, k * 32:(k + 1) * 32] for k in range(4)]
    out = dot_interaction(leaves[0] if has_bottom else None, views)
    assert torch.equal(out.detach(), want_out)
    got = torch.autograd.grad(out, leaves, grad)
    if has_bottom:
        assert torch.equal(got[0], want[0])
    assert torch.equal(got[-1], torch.cat(list(want[-4:]), dim=1))
    with torch.no_grad():  # the forward alone, no graph
        assert not dot_interaction(leaves[0] if has_bottom else None, views).requires_grad


def _dlrm(layout, num_dense=3):
    spec = DataSpec.ctr(VOCABS, num_dense, WIDTHS)
    return build_model(ModelConfig(name="dlrm", embed_dim=16, mlp_dims=(16, 8), **LAYOUTS[layout]), spec)


def _ctr_batch(batch, num_dense, seed):
    dense, cat, label = synthetic_ctr(batch, num_dense, VOCABS, seed=seed, field_widths=WIDTHS)
    return {"dense": torch.from_numpy(dense), "cat": torch.from_numpy(cat), "label": torch.from_numpy(label)}


@pytest.mark.parametrize("layout,num_dense", [("per_field", 3), ("lane_packed", 3), ("stacked", 3),
                                              ("per_field", 0)])
def test_dlrm_dot_logits_and_gradients_match_the_former_forward(layout, num_dense):
    """``DLRM(interaction="dot")`` on the CPU: the same logits and the same
    gradients of the dense params and the gathered rows, bit for bit, as the
    former forward (the bmm and the indexed triangle) under autograd."""
    model = _dlrm(layout, num_dense)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = _ctr_batch(24, num_dense, seed=2)
    ids = model.lookup_ids(batch)
    rows = gather_many([params["tables"][k] for k in ids], list(ids.values()))

    def run(forward):
        dense = {k: [(w.clone().requires_grad_(), b.clone().requires_grad_()) for w, b in v]
                 for k, v in params["dense"].items()}
        gathered = {k: r.clone().requires_grad_() for k, r in zip(ids, rows)}
        logits = forward(dense, gathered)
        leaves = tree_leaves(dense) + list(gathered.values())
        return logits.detach(), torch.autograd.grad(torch.sigmoid(logits).sum(), leaves)

    def former(dense, gathered):
        fields = model.field_list(gathered, batch)
        bottom = apply_mlp(dense["bottom"], batch["dense"]) if model.has_bottom else None
        return apply_mlp(dense["top"], _former(bottom, fields))[:, 0]

    got, got_grads = run(lambda dense, gathered: model(dense, gathered, batch))
    want, want_grads = run(former)
    assert model.has_bottom == (num_dense > 0)
    assert torch.equal(got, want)
    assert len(got_grads) == len(want_grads)
    assert all(torch.equal(g, w) for g, w in zip(got_grads, want_grads))


def test_the_wrapper_refuses_what_it_does_not_take():
    bottom, fields = _vectors(4, 3, 8, True)
    with pytest.raises(TypeError, match="float32"):
        dot_interaction_fwd(bottom.double(), fields)
    with pytest.raises(ValueError, match="one shape"):
        dot_interaction_fwd(bottom, [fields[0], fields[1][:, :4]])
    with pytest.raises(ValueError, match="grad must be"):
        dot_interaction_bwd(bottom, fields, torch.zeros(4, 9))
    with pytest.raises(ValueError, match="at least one vector"):
        dot_interaction_fwd(None, [])


# ---- on the card ----

CARD_SHAPES = [(64, 27, 128, True), (64, 27, 32, True), (64, 6, 16, True), (33, 2, 1, True), (33, 2, 129, True),
               (33, 3, 1, True), (33, 3, 129, True), (50, 5, 64, False), (40, 27, 100, True), (40, 32, 8, True),
               (40, 40, 24, True), (1, 27, 128, True), (32768, 27, 128, True)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launches():
    return dot_interaction_fwd.launches, dot_interaction_bwd.launches


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,dim,has_bottom", CARD_SHAPES)
def test_kernels_match_the_plain_versions_and_repeat(device, batch, n, dim, has_bottom):
    bottom, fields = _vectors(batch, n, dim, has_bottom, seed=batch + n, device=device)
    grad = _grad(batch, n, dim, has_bottom, seed=dim, device=device)
    before = _launches()
    out = dot_interaction_fwd(bottom, fields)
    d_bottom, d_fields = dot_interaction_bwd(bottom, fields, grad)
    again = dot_interaction_fwd(bottom, fields)
    d_again = dot_interaction_bwd(bottom, fields, grad)
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 2, before[1] + 2)
    _assert_close(out, dot_interaction_fwd_ref(bottom, fields))
    want_bottom, want_fields = dot_interaction_bwd_ref(bottom, fields, grad)
    got = ([d_bottom] if has_bottom else []) + d_fields
    for g, w in zip(got, ([want_bottom] if has_bottom else []) + want_fields):
        _assert_close(g, w)
    assert _one_allocation(got, batch, dim)
    assert torch.equal(out, again)
    assert all(torch.equal(a, b) for a, b in zip(got, ([d_again[0]] if has_bottom else []) + d_again[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,dim", [(32768, 27, 128), (8192, 27, 32)])
def test_kernels_sum_in_cublas_order_at_the_dlrm_shapes(device, batch, n, dim):
    """At the benchmark's DLRM cell and the zoo's DLRM the kernels give the
    former bmm's numbers and autograd's gradients of it bit for bit: cuBLAS
    sums these f32 products one multiply-add a column, in column order, and
    the kernels sum in that order (the benchmark's limits hold the step to
    the reference's rounding)."""
    bottom, fields = _vectors(batch, n, dim, True, seed=3, device=device)
    grad = _grad(batch, n, dim, True, seed=4, device=device)
    want_out, want = _former_grads(bottom, fields, grad)
    assert torch.equal(dot_interaction_fwd(bottom, fields), want_out)
    d_bottom, d_fields = dot_interaction_bwd(bottom, fields, grad)
    assert all(torch.equal(g, w) for g, w in zip([d_bottom, *d_fields], want))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_kernels_take_fields_where_they_lie(device, offset):
    """Lane-packed column slices of a pack (row stride 128 + offset; with
    the offset every field's pointer is misaligned for wide loads), against
    the plain versions on their contiguous copies."""
    g = torch.Generator().manual_seed(9)
    pack = torch.randn((300, 128 + offset), generator=g).to(device)
    fields = [pack[:, offset + k * 32:offset + (k + 1) * 32] for k in range(4)]
    bottom = torch.randn((300, 32), generator=g).to(device)
    grad = _grad(300, 5, 32, True, device=device)
    copies = [f.contiguous() for f in fields]
    _assert_close(dot_interaction_fwd(bottom, fields), dot_interaction_fwd_ref(bottom, copies))
    got_b, got_f = dot_interaction_bwd(bottom, fields, grad)
    want_b, want_f = dot_interaction_bwd_ref(bottom, copies, grad)
    for a, b in zip([got_b, *got_f], [want_b, *want_f]):
        _assert_close(a, b)


def _step_model(name, **kw):
    return build_model(ModelConfig(name=name, embed_dim=16, mlp_dims=(16, 8), **kw), DataSpec.ctr(VOCABS, 3, WIDTHS))


@pytest.mark.cuda
def test_dlrm_step_launches_once_each_way_and_matches_the_cpu(device):
    """One DLRM step (dense Adam, rowwise Adagrad) on the card and on the CPU
    from one state: one forward and one backward launch, the loss, tables
    and accumulators within f32 rounding; ``predict_ctr`` launches the
    forward alone."""
    model = _step_model("dlrm")
    optim = OptimConfig(learning_rate=0.01, dense_optimizer="adam", sparse_optimizer="rowwise_adagrad",
                        sparse_learning_rate=0.05)
    card = TrainStepBuilder(model, "logloss", optim)
    cpu = TrainStepBuilder(model, "logloss", optim, device="cpu")
    state = card.init_state(torch.Generator(device="cuda").manual_seed(0))
    cpu_state = copy_state(state, "cpu")
    batch = _ctr_batch(64, 3, seed=1)
    before = _launches()
    new, m = card.step(state, {k: v.to(device) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert _launches() == (before[0] + 1, before[1] + 1)
    want, m_cpu = cpu.step(cpu_state, batch)
    torch.testing.assert_close(m["loss"].cpu(), m_cpu["loss"], rtol=1e-5, atol=0)
    for name in want["tables"]:
        _assert_close(new["tables"][name].cpu(), want["tables"][name], 1e-4)
        _assert_close(new["sparse_opt"][name]["acc"].cpu(), want["sparse_opt"][name]["acc"], 1e-4)
    rec = Recommender(model, {"tables": new["tables"], "dense": new["dense"]})
    before = _launches()
    logits = rec.predict_ctr(batch["dense"].numpy(), batch["cat"].numpy())
    assert _launches() == (before[0] + 1, before[1]) and np.isfinite(logits).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [("dcnv2", dict(num_cross_layers=2, cross_rank=4)), ("dcn", {})])
def test_dcn_paths_launch_no_interaction(device, name, kw):
    model = _step_model(name, **kw)
    builder = TrainStepBuilder(model, "logloss", OptimConfig(sparse_optimizer="rowwise_adagrad"))
    state = builder.init_state(torch.Generator(device="cuda").manual_seed(0))
    before = _launches()
    builder.step(state, {k: v.to(device) for k, v in _ctr_batch(64, 3, seed=2).items()})
    torch.cuda.synchronize()
    assert _launches() == before


@pytest.mark.cuda
def test_the_wrapper_raises_for_cuda_inputs_it_does_not_take(device):
    bottom, fields = _vectors(8, 3, 8, True, device=device)
    with pytest.raises(TypeError, match="float32"):
        dot_interaction_fwd(bottom.double(), [f.double() for f in fields])
    with pytest.raises(ValueError, match="column stride"):
        dot_interaction_fwd(bottom, [fields[0], torch.zeros(8, 16, device=device)[:, ::2]])
    with pytest.raises(ValueError, match="one device"):
        dot_interaction_fwd(bottom, [fields[0], fields[1].cpu()])
