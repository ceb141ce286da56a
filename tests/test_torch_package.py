"""The port stands apart from JAX: it imports with jax blocked, no source
of it (nor chip_smoke.py) imports jax or tfrec_tpu, and its copies of the
reference's configs stay equal to the originals."""

import dataclasses
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import tfrec_tpu.configs as jax_configs
import tfrec_tpu.zoo_configs as jax_zoo
import tfrec_tpu_torch
import tfrec_tpu_torch.configs as configs
import tfrec_tpu_torch.zoo_configs as zoo

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tfrec_tpu_torch"


def test_port_imports_with_jax_blocked():
    modules = sorted(
        m.name for m in pkgutil.walk_packages([str(PORT)], prefix="tfrec_tpu_torch.")
    )
    assert "tfrec_tpu_torch.serve" in modules and "tfrec_tpu_torch.kernels.cross_cuda" in modules
    assert {"tfrec_tpu_torch.train.trainer", "tfrec_tpu_torch.eval.metrics", "tfrec_tpu_torch.data.samplers",
            "tfrec_tpu_torch.utils.logging", "tfrec_tpu_torch.utils.prefetch", "tfrec_tpu_torch.models.mf",
            "tfrec_tpu_torch.data.dataset", "tfrec_tpu_torch.eval.retrieval",
            "tfrec_tpu_torch.models.fm", "tfrec_tpu_torch.models.ncf",
            "tfrec_tpu_torch.eval.sampled", "tfrec_tpu_torch.data.criteo",
            "tfrec_tpu_torch.data.criteo_native", "tfrec_tpu_torch.data.movielens",
            "tfrec_tpu_torch.data.uirt_native", "tfrec_tpu_torch.utils.checkpoint",
            "tfrec_tpu_torch.cli", "tfrec_tpu_torch.parallel.mesh",
            "tfrec_tpu_torch.parallel.embedding", "tfrec_tpu_torch.parallel.step",
            "tfrec_tpu_torch.parallel.topk", "tfrec_tpu_torch.parallel.eval"} <= set(modules)
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'tfrec_tpu' or m.startswith('tfrec_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_no_source_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|tfrec_tpu)(\.|\s|$)", re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


@pytest.mark.parametrize(
    "name", ["DataConfig", "ModelConfig", "OptimConfig", "MeshConfig", "TrainConfig", "Config"]
)
def test_config_copies_match_the_reference(name):
    def defaults(cls):
        return {f.name: (f.default if f.default is not dataclasses.MISSING
                         else f.default_factory()) for f in dataclasses.fields(cls)}

    ours, ref = getattr(configs, name), getattr(jax_configs, name)
    assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())
    assert list(defaults(ours)) == list(defaults(ref))


@pytest.mark.parametrize("path", [None, "criteo/train.txt"])
def test_dcn_criteo_copy_matches_the_reference(path):
    assert dataclasses.asdict(zoo.dcn_criteo(path)) == dataclasses.asdict(jax_zoo.dcn_criteo(path))
    assert tfrec_tpu_torch.__version__


@pytest.mark.parametrize("path", [None, "criteo/train.txt"])
def test_dcn_multihost_copy_matches_the_reference(path):
    assert dataclasses.asdict(zoo.dcn_multihost(path)) == \
        dataclasses.asdict(jax_zoo.ZOO["dcn_multihost"](path))


@pytest.mark.parametrize("path", [None, "ml-100k/u.data"])
def test_mf_bpr_ml100k_copy_matches_the_reference(path):
    assert dataclasses.asdict(zoo.mf_bpr_ml100k(path)) == dataclasses.asdict(jax_zoo.mf_bpr_ml100k(path))


@pytest.mark.parametrize("name,path", [("fm_ctr_ml1m", None), ("fm_ctr_ml1m", "ml-1m/ratings.dat"),
                                       ("neumf_ml20m", None), ("neumf_ml20m", "ml-20m/ratings.csv")])
def test_config2_and_config3_copies_match_the_reference(name, path):
    ours, ref = getattr(zoo, name)(path), getattr(jax_zoo, name)(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
