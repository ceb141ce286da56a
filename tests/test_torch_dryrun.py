"""The port's ``dryrun_multichip`` (``tfrec_tpu_torch/parallel/dryrun.py``)
against the reference's ``__graft_entry__``, on the CPU.

``dryrun_multichip(4)`` (its own 4 gloo processes, a (2, 2) mesh) runs
every mode of ``MULTICHIP_r05.json`` from JAX's initial state of that mode,
each loss held against JAX's ``_one_step`` on a (2, 2) mesh of virtual
devices; ``gspmd`` is said to be not ported, and a failing rank makes the
run raise with every rank's output.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from tfrec_tpu.configs import MeshConfig as JaxMeshConfig
from tfrec_tpu.configs import ModelConfig as JaxModelConfig
from tfrec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfrec_tpu.parallel.step import ShardedTrainStepBuilder as JaxShardedBuilder
from tfrec_tpu_torch.configs import ModelConfig
from tfrec_tpu_torch.convert import train_state_from_jax
from tfrec_tpu_torch.models import DataSpec, build_model
from tfrec_tpu_torch.parallel import dryrun
from torch_dist_worker import _np

torch.set_num_threads(1)

STEP_RTOL = 2e-4  # tests/test_parallel.py:205-208


def _jax_modes(monkeypatch, jmesh):
    """Each mode's ``_one_step`` on JAX's (2, 2) mesh -> {tag: (its loss,
    its builder's initial state as the port's logical state)}; the state is
    taken as ``_one_step``'s builder makes it (``init_state`` at
    PRNGKey(0)), before the step donates it."""
    seen = []
    init_state = JaxShardedBuilder.init_state

    def recording(self, rng):
        state = init_state(self, rng)
        seen.append((self, jax.device_get(state)))
        return state

    monkeypatch.setattr(JaxShardedBuilder, "init_state", recording)
    out = {}
    for tag, cfg, lane_pack, _, opt, widths in dryrun.modes(2):
        model_cfg = dict(name="dcn", embed_dim=8, num_cross_layers=2, mlp_dims=(16,), lane_pack=lane_pack)
        loss = graft._one_step(jmesh, JaxMeshConfig(**dataclasses.asdict(cfg)), JaxModelConfig(**model_cfg),
                               dryrun.VOCABS, dryrun.NUM_DENSE, 16, sparse_optimizer=opt, field_widths=widths)
        builder, state = seen[-1]
        vocab = {s.name: s.vocab for s in builder.model.table_specs()}
        logical = {**state, "tables": {k: np.asarray(v) for k, v in builder.unpadded_tables(state).items()},
                   "sparse_opt": {k: {leaf: np.asarray(x)[:vocab[k]] for leaf, x in v.items()}
                                  for k, v in state["sparse_opt"].items()}}
        port_model = build_model(ModelConfig(**model_cfg),
                                 DataSpec.ctr(dryrun.VOCABS, dryrun.NUM_DENSE, field_widths=widths))
        out[tag] = loss, _np(train_state_from_jax(jax.tree.map(np.asarray, logical), port_model))
    return out


def test_dryrun_multichip_matches_jax_on_every_mode(monkeypatch):
    """The port's dry run on 4 CPU ranks, a (2, 2) mesh: every mode of
    MULTICHIP_r05.json ok, gspmd said not ported, and each mode's loss
    JAX's ``_one_step`` loss on a (2, 2) mesh from the same initial state."""
    tags = [m[0] for m in dryrun.modes(2)]
    assert tags == ["row+bf16wire", "row+lanepack", "row+auto", "row+f32wire", "row+lanepack+adam",
                    "row+multihot", "row+permute", "row+merge", "col"]
    want = _jax_modes(monkeypatch, jax_make_mesh(2, 2))
    result = dryrun.dryrun_multichip(4, states={t: state for t, (_, state) in want.items()}, timeout=150,
                                     quiet=True, device="cpu")
    line = result["line"]
    assert line.startswith("dryrun_multichip(4): ") and line.endswith("; sharded_topk ok")
    assert "gspmd not ported" in line and "gspmd ok" not in line
    for tag in tags:
        assert f"{tag} ok loss=" in line
        np.testing.assert_allclose(result["losses"][tag], want[tag][0], rtol=STEP_RTOL, err_msg=tag)


def test_dryrun_fails_loudly_with_every_ranks_output():
    """A rank that fails (here on a malformed initial state) makes the run
    raise, with every rank's output."""
    with pytest.raises(RuntimeError, match=r"(?s)rank 0 \(exit [1-9].*rank 1 \(exit"):
        dryrun.dryrun_multichip(2, states={"row+bf16wire": {"tables": None}}, timeout=60, quiet=True,
                                  device="cpu")


@pytest.mark.parametrize("n, device, backend, cards, want", [
    (4, "cpu", "auto", 0, "gloo"),
    (4, "cuda", "auto", 1, "gloo"),
    (4, "cuda", "auto", 4, "nccl"),
    (2, "cuda", "nccl", 2, "nccl"),
])
def test_dryrun_backend_follows_the_cards(monkeypatch, n, device, backend, cards, want):
    """The entry point's backend: gloo on the CPU, NCCL with a card a rank,
    gloo where the ranks share a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert dryrun.resolve_backend(n, device, backend) == want


def test_dryrun_defaults_to_the_card(monkeypatch):
    """Without ``device="cpu"`` the dry run asks for the card, and where
    there is none it raises before starting a rank, naming the CPU option;
    the command line defaults to the card as well."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(2, timeout=5, quiet=True)
    assert dryrun.main(["--n", "2", "--timeout", "5"]) == 1
