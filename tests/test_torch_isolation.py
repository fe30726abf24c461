"""PyTorch port: it imports nothing of JAX, and its entry points never fall
back to the CPU quietly."""

import ast
import json
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import opticalflowscivis_tpu_torch
from opticalflowscivis_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
PACKAGE = Path(opticalflowscivis_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "opticalflowscivis_tpu")


def _module_names():
    return ["opticalflowscivis_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PACKAGE)], "opticalflowscivis_tpu_torch.")
    ]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for name in {_module_names()!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    names = _module_names()
    assert len(names) >= 29
    for module in ("losses.rife", "training.trainer", "training.checkpoint", "cli.__main__",
                   "ops.pyramid", "scripts.train256", "ops.kernels.correlation",
                   "models.upflow", "losses.upflow", "losses.selfsup",
                   "training.upflow_trainer", "evalsuite.flow_eval", "models.refine",
                   "models.ifnet_hd", "models.ifnet_hd_legacy", "losses.perceptual",
                   "data.device_synthetic", "data.vimeo", "data.lbs", "data.converters",
                   "data.yuv_io", "data.fastprep", "evalsuite.benchmarks", "parallel",
                   "parallel.mesh", "parallel.multihost", "parallel.spatial",
                   "scripts.dryrun_dp"):
        assert f"opticalflowscivis_tpu_torch.{module}" in names


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_source_imports_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_entry_points_raise_without_cuda(monkeypatch):
    from opticalflowscivis_tpu_torch.inference import Interpolator
    from opticalflowscivis_tpu_torch.models import IFNet, ifnet_2d, ifnet_3d

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ifnet_2d()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ifnet_3d()
    for ndim in (2, 3):
        net = IFNet(ndim=ndim, block_channels=(8, 8, 8), teacher_channels=8, device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Interpolator(net)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_trainer_and_cli_raise_without_cuda(monkeypatch, tmp_path):
    """Training and the CLI verbs run on the GPU unless asked for the CPU."""
    from opticalflowscivis_tpu_torch.cli.__main__ import main
    from opticalflowscivis_tpu_torch.training import ModelConfig, TrainConfig, Trainer, build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig(model=ModelConfig(block_channels=(8, 8, 8), teacher_channels=8),
                      data_dir=str(tmp_path), log_dir=str(tmp_path), results_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    assert Trainer(cfg, device="cpu").device == torch.device("cpu")
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    for verb in ("train", "test", "inference_video"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([verb, "--config_json", str(tmp_path / "cfg.json")])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([verb, "--dataset", "rectangle3d", "--data_dir", str(tmp_path)])


def test_train256_module_raises_without_cuda(monkeypatch, tmp_path):
    """``train256`` runs on the GPU unless ``--cpu`` is given; it finds out
    before it generates any data only with ``--eval_only``, so that is the
    cheap way to ask."""
    from opticalflowscivis_tpu_torch.scripts import train256

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train256.main(["--grid", "32", "--eval_only", "--out", str(tmp_path)])


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """Without a CUDA device, and alone in a directory, it exits nonzero and
    prints no result."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for script in (REPO / "chip_smoke.py", alone):
        res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
