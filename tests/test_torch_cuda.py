"""The CUDA kernels against their plain versions on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/*.cu for
sm_90a); elsewhere they skip. Run them on the H100 with
``python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest``
(``--noconftest``: tests/conftest.py imports jax, which that machine
need not have).
"""

import numpy as np
import pytest
import torch

from tfrec_tpu_torch.kernels.cross import cross_stack
from tfrec_tpu_torch.kernels.cross_cuda import cross_v1_fwd, cross_v1_fwd_ref
from tfrec_tpu_torch.kernels.gather_cuda import gather_rows, gather_rows_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dim", [1, 8, 13, 32, 128])
def test_gather_rows_is_bitwise_the_plain_version(device, dim):
    rng = np.random.default_rng(dim)
    vocab = 1000
    table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32)).to(device)
    ids = rng.integers(-5, vocab + 5, 4099).astype(np.int32)
    ids[:6] = [vocab, -1, 0, vocab - 1, 7, 7]
    ids = torch.from_numpy(ids).to(device)
    before = gather_rows.launches
    got = gather_rows(table, ids)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_ref(table, ids))
    # A table view that starts off a 16-byte boundary takes the scalar path.
    if dim % 4 == 0:
        shifted = torch.empty(vocab * dim + 1, device=device)[1:].view(vocab, dim)
        shifted.copy_(table)
        assert torch.equal(gather_rows(shifted, ids), gather_rows_ref(table, ids))


@pytest.mark.parametrize("batch,dim,layers", [(1000, 845, 3), (33, 31, 2), (257, 2048, 1)])
def test_cross_v1_fwd_matches_the_plain_version(device, batch, dim, layers):
    rng = np.random.default_rng(batch)
    x0 = torch.from_numpy(rng.normal(size=(batch, dim)).astype(np.float32)).to(device)
    w = torch.from_numpy((rng.normal(size=(layers, dim)) / dim**0.5).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.normal(size=(layers, dim)).astype(np.float32) * 0.1).to(device)
    got = cross_v1_fwd(x0, w, b)
    want = cross_v1_fwd_ref(x0, w, b)
    # f32 row dots summed in another order: errors scale with the terms.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, cross_v1_fwd(x0, w, b))  # fixed order: bit for bit
    assert torch.equal(cross_stack(x0, {"w": w, "b": b}), got)
