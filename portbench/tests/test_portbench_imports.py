"""The end-of-run import check compares whole top-level module names."""

from portbench import harness


def test_refuses_jax_and_the_jax_package():
    assert harness.forbidden_modules(["jax.numpy", "os"]) == ["jax"]
    assert harness.forbidden_modules(["tfrec_tpu", "tfrec_tpu.models.dcn"]) == ["tfrec_tpu"]
    assert harness.forbidden_modules(["jaxlib.xla_client", "flax.linen"]) == ["flax", "jaxlib"]


def test_accepts_the_port_and_lookalikes():
    assert harness.forbidden_modules(["tfrec_tpu_torch", "tfrec_tpu_torch.serve", "jaxtyping", "portbench"]) == []
