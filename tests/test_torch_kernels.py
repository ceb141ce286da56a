"""The port's kernel wrappers against the JAX package, on the CPU.

On a CPU tensor each wrapper takes its plain PyTorch version; these tests
hold that version against the JAX reference and the Pallas kernel (run in
interpret mode, as tests/test_kernels.py runs it), and pin the wrappers'
input contract. The CUDA kernels themselves are held against the plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfrec_tpu.kernels.cross import cross_stack_xla
from tfrec_tpu.kernels.cross_pallas import cross_stack_pallas
from tfrec_tpu.kernels.gather_pallas import gather_pallas
from tfrec_tpu.ops.embedding import gather as jax_gather
from tfrec_tpu_torch.kernels import _build
from tfrec_tpu_torch.kernels.cross import cross_stack, cross_stack_ref
from tfrec_tpu_torch.kernels.cross_cuda import cross_v1_bwd, cross_v1_fwd
from tfrec_tpu_torch.kernels.gather_cuda import gather_rows, gather_rows_multi, gather_rows_multi_ref
from tfrec_tpu_torch.ops.embedding import gather, gather_many

torch.set_num_threads(1)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _ids_with_edge_cases(seed, vocab, n):
    """Duplicates, negatives and sentinels (>= vocab) among real ids."""
    rng = np.random.default_rng(seed)
    fixed = np.array([3, 3, 3, 0, vocab - 1, vocab, vocab + 7, -1, -5, 7, 7], np.int32)
    return np.concatenate([fixed, rng.integers(-3, vocab + 3, n - fixed.size)]).astype(np.int32)


@pytest.mark.parametrize("dim", [8, 13, 32])
def test_gather_matches_jax_gather_and_pallas_exactly(dim):
    vocab = 40  # a multiple of 128/32, so D=32 takes gather_pallas' packed path
    table = _normal(0, (vocab, dim))
    ids = _ids_with_edge_cases(1, vocab, 37)
    got = gather(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    assert got.shape == (37, dim)
    np.testing.assert_array_equal(got, np.asarray(jax_gather(jnp.asarray(table), jnp.asarray(ids))))
    np.testing.assert_array_equal(got, np.asarray(gather_pallas(jnp.asarray(table), jnp.asarray(ids))))


def test_gather_rows_contract():
    """int32 ids only (the JAX package's id type); 2-D f32 tables; the
    same device; contiguous inputs. A CPU call launches nothing."""
    table = torch.from_numpy(_normal(2, (10, 4)))
    ids = torch.tensor([0, 9, 10, -1], dtype=torch.int32)
    before = gather_rows.launches
    np.testing.assert_array_equal(gather_rows(table, ids).numpy(), table.numpy()[[0, 9, 9, 0]])
    assert gather_rows.launches == before
    assert gather_rows(table, ids[:0]).shape == (0, 4)
    with pytest.raises(TypeError, match="int32"):
        gather_rows(table, ids.long())
    with pytest.raises(TypeError, match="float32"):
        gather_rows(table.double(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows(table.t(), ids)
    with pytest.raises(NotImplementedError, match="cuda or cpu"):
        gather_rows(table.to("meta"), ids.to("meta"))


# (vocab, dim, ids) per field: mixed dims; a multi-hot bag of width 3 (its
# field has 3 ids an example) beside a dim that is no multiple of 4; and more
# tables than one launch's descriptor holds (64), all of one shape so the
# jitted Pallas kernel compiles once.
MULTI_FIELDS = {
    "mixed_dims": [(40, 4, 37), (52, 8, 37), (37, 12, 37)],
    "multi_hot": [(40, 8, 37), (30, 13, 3 * 37)],
    "past_one_launch": [(13, 4, 12)] * 70,
}


@pytest.mark.parametrize("case", sorted(MULTI_FIELDS))
def test_gather_rows_multi_matches_jax_take_and_pallas_per_field(case):
    fields = MULTI_FIELDS[case]
    tables = [_normal(100 + f, (v, d)) for f, (v, d, _) in enumerate(fields)]
    ids = [_ids_with_edge_cases(200 + f, v, n) for f, (v, _, n) in enumerate(fields)]
    tt, ti = [torch.from_numpy(t) for t in tables], [torch.from_numpy(i) for i in ids]
    got = gather_rows_multi_ref(tt, ti)
    before = gather_rows_multi.launches
    wrapped = gather_many(tt, ti)  # the wrapper on CPU tensors: the plain version
    assert gather_rows_multi.launches == before
    pallas = jax.jit(gather_pallas)
    for t, i, g, w in zip(tables, ids, got, wrapped):
        assert g.shape == (i.shape[0], t.shape[1])
        want = np.asarray(jnp.take(jnp.asarray(t), jnp.asarray(i), axis=0, mode="clip"))
        np.testing.assert_array_equal(g.numpy(), want)
        np.testing.assert_array_equal(g.numpy(), np.asarray(pallas(jnp.asarray(t), jnp.asarray(i))))
        assert torch.equal(w, g)
    # The card's layout: one allocation, each field a contiguous view of it
    # starting on a 128-byte boundary.
    for rows in (got, wrapped):
        base = rows[0].untyped_storage().data_ptr()
        for r in rows:
            assert r.is_contiguous() and r.untyped_storage().data_ptr() == base
            assert (r.data_ptr() - base) % 128 == 0


def test_gather_rows_multi_contract():
    """Fields of one call share a device; int32 ids, 2-D f32 tables,
    contiguous inputs. A table may appear twice (a gather only reads it);
    empty fields give [0, D]. A CPU call launches nothing."""
    t1, t2 = torch.from_numpy(_normal(2, (10, 4))), torch.from_numpy(_normal(3, (6, 3)))
    i1, i2 = torch.tensor([0, 9, 10, -1], dtype=torch.int32), torch.tensor([5, 6], dtype=torch.int32)
    before = gather_rows_multi.launches
    out = gather_rows_multi([t1, t2, t1, t2], [i1, i2, i1[:0], i2[:1]])
    assert gather_rows_multi.launches == before
    assert [tuple(o.shape) for o in out] == [(4, 4), (2, 3), (0, 4), (1, 3)]
    np.testing.assert_array_equal(out[0].numpy(), t1.numpy()[[0, 9, 9, 0]])
    np.testing.assert_array_equal(out[1].numpy(), t2.numpy()[[5, 5]])
    np.testing.assert_array_equal(out[3].numpy(), t2.numpy()[[5]])
    assert gather_rows_multi([], []) == []
    with pytest.raises(ValueError, match="2 tables but 1"):
        gather_rows_multi([t1, t2], [i1])
    with pytest.raises(TypeError, match="int32"):
        gather_rows_multi([t1, t2], [i1, i2.long()])
    with pytest.raises(TypeError, match="float32"):
        gather_rows_multi([t1, t2.double()], [i1, i2])
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows_multi([t1, t2.t()], [i1, i2])
    with pytest.raises(ValueError, match="one device"):
        gather_rows_multi([t1, t2.to("meta")], [i1, i2.to("meta")])
    with pytest.raises(ValueError, match="empty table"):
        gather_rows_multi([t1[:0]], [i1])
    with pytest.raises(NotImplementedError, match="cuda or cpu"):
        gather_rows_multi([t1.to("meta"), t2.to("meta")], [i1.to("meta"), i2.to("meta")])


@pytest.mark.parametrize("batch,dim,layers", [(64, 32, 3), (50, 45, 2)])
def test_cross_v1_ref_matches_pallas_and_xla(batch, dim, layers):
    x0 = _normal(3, (batch, dim))
    # w at DCN's own init scale, 1/sqrt(d): each row dot stays O(1).
    w, b = _normal(4, (layers, dim), dim**-0.5), _normal(5, (layers, dim), 0.1)
    jparams = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    tparams = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    ref = cross_stack_ref(torch.from_numpy(x0), tparams).numpy()
    np.testing.assert_allclose(ref, np.asarray(cross_stack_pallas(jnp.asarray(x0), jparams)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ref, np.asarray(cross_stack_xla(jnp.asarray(x0), jparams)),
                               rtol=1e-5, atol=1e-6)
    # On the CPU the dispatcher and the wrapper take the same plain version.
    np.testing.assert_array_equal(cross_stack(torch.from_numpy(x0), tparams).numpy(), ref)


@pytest.mark.parametrize("rank", [0, 4])
def test_cross_v2_ref_matches_xla(rank):
    batch, dim, layers = 48, 24, 3
    x0 = _normal(6, (batch, dim))
    if rank:
        np_params = {"u": _normal(7, (layers, dim, rank), 0.2),
                     "v": _normal(8, (layers, dim, rank), 0.2)}
    else:
        np_params = {"w": _normal(9, (layers, dim, dim), 0.2)}
    np_params["b"] = _normal(10, (layers, dim), 0.1)
    want = np.asarray(cross_stack_xla(jnp.asarray(x0), {k: jnp.asarray(v) for k, v in np_params.items()}))
    tparams = {k: torch.from_numpy(v) for k, v in np_params.items()}
    for fn in (cross_stack_ref, cross_stack):
        np.testing.assert_allclose(fn(torch.from_numpy(x0), tparams).numpy(), want, rtol=1e-5, atol=1e-6)


def test_cross_dispatch_refuses_devices_other_than_cuda_and_cpu():
    """Off cpu/cuda the v2 low-rank and v1 wrappers refuse, never run plain."""
    x0 = torch.empty((4, 8), device="meta")
    lowrank = {k: torch.empty(s, device="meta") for k, s in
               (("u", (2, 8, 2)), ("v", (2, 8, 2)), ("b", (2, 8)))}
    with pytest.raises(NotImplementedError, match="cuda or cpu"):
        cross_stack(x0, lowrank)
    v1 = {"w": torch.empty((2, 8), device="meta"), "b": torch.empty((2, 8), device="meta")}
    with pytest.raises(NotImplementedError, match="cuda or cpu"):
        cross_stack(x0, v1)


# dcn_criteo's widths as DCN-v1 at embed_dim 32, 80, 158 and 320 (d = 26 e
# + 13), the widest row a block's registers hold (8192), and the first
# width past it.
@pytest.mark.parametrize("dim", [845, 2093, 4121, 8192, 8193, 8333])
def test_cross_v1_takes_wide_inputs_to_the_device_check(dim):
    """Both wrappers take any width (past 8192 the kernels stream rows
    instead of holding them in registers) and any depth: a meta tensor
    reaches the device check, never a refusal of its shape."""
    x0 = torch.empty((4, dim), device="meta")
    for layers in (1, 40):
        w = torch.empty((layers, dim), device="meta")
        s = torch.empty((4, layers), device="meta")
        for call in (lambda: cross_v1_fwd(x0, w, w), lambda: cross_v1_bwd(x0, w, w, s, x0)):
            with pytest.raises(NotImplementedError, match="cuda or cpu"):
                call()


def test_cross_v1_refuses_rows_past_a_32_bit_index():
    """The kernels index a row with a 32-bit int: d = 2**31 is refused by
    name (meta tensors allocate nothing)."""
    dim = 2**31
    x0, w, s = (torch.empty(shape, device="meta") for shape in ((1, dim), (1, dim), (1, 1)))
    with pytest.raises(ValueError, match="32-bit"):
        cross_v1_fwd(x0, w, w)
    with pytest.raises(ValueError, match="32-bit"):
        cross_v1_bwd(x0, w, w, s, x0)


def test_cross_v1_fwd_contract():
    x0 = torch.from_numpy(_normal(11, (5, 6)))
    w = torch.from_numpy(_normal(12, (2, 6)))
    before = cross_v1_fwd.launches
    cross_v1_fwd(x0, w, w.clone())
    assert cross_v1_fwd.launches == before
    with pytest.raises(ValueError, match=r"\[L, 6\]"):
        cross_v1_fwd(x0, w, w[:, :5].contiguous())
    with pytest.raises(TypeError, match="float32"):
        cross_v1_fwd(x0.double(), w, w)
    with pytest.raises(ValueError, match="contiguous"):
        cross_v1_fwd(x0, w, torch.from_numpy(_normal(13, (6, 2))).t())


def test_build_targets_hopper_from_repo_sources(tmp_path, monkeypatch):
    assert _build.sources() == ["adagrad", "cross", "cross_v2", "gather", "interaction"]
    assert _build.BUILD_DIR.parts[-2:] == ("build", "tfrec_tpu_torch")
    cmd = _build.nvcc_command("nvcc", "gather", Path("lib.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1] == str(_build.CSRC_DIR / "gather.cu")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
