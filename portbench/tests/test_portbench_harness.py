"""The harness: a cell, configuration, traffic mix and metric added as new
files are found by name; no run loads JAX or the JAX package; the reference
loads nothing of the program; a checkout without the port gives no result."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import harness
from portbench.tests.conftest import run_tiny, tiny_context

REPO = harness.ROOT


def _copy_benchmark(dst: Path) -> None:
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))


def test_new_files_are_found_by_name(tmp_path):
    _copy_benchmark(tmp_path)
    here = tmp_path / "portbench"
    cfg = json.loads((here / "configs" / "ifnet2d_droplet.json").read_text())
    cfg["model"]["block_channels"] = [24, 16, 8]
    (here / "configs" / "ifnet2d_dummy.json").write_text(json.dumps(cfg))
    traffic = {"driver": "train", "batch": 2, "series_frames": 9, "profile_steps": 1}
    (here / "traffic" / "train_dummy.json").write_text(json.dumps(traffic))
    (here / "metrics" / "dummy_steps.py").write_text(
        "def read(record):\n    return float(record['attempted'])\n")
    (here / "limits" / "dummy_cell.json").write_text(
        (here / "limits" / "rife2d_train_droplet.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ifnet2d_dummy", "source": "https://example.org",
                             "file": "portbench/configs/ifnet2d_dummy.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy_cell", "config": "ifnet2d_dummy",
                               "traffic": "train_dummy", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_steps", "unit": "steps", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["dummy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    ctx = tiny_context("dummy_cell", here=here, root=tmp_path)
    assert ctx.config["model"]["block_channels"] == [16, 12, 8]  # shrunk from the new file
    assert ctx.traffic["driver"] == "train" and ctx.traffic["series_frames"] == 10
    line = run_tiny(ctx, root=tmp_path, here=here)
    assert line["metrics"]["dummy_steps"]["value"] == line["attempted"]
    assert "setup_s" in line["metrics"] and line["correct"]
    assert list(line)[-1] == "checks"


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("opticalflowscivis_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert [m for m in harness.forbidden_modules() if m.startswith(("opticalflowscivis_tpu_torch",
                                                                    "jaxtyping", "flaxen"))] == []
    monkeypatch.setitem(sys.modules, "opticalflowscivis_tpu.ops", sys)
    assert "opticalflowscivis_tpu.ops" in harness.forbidden_modules()


_RUN_ALL = """
import sys
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.tests.conftest import run_tiny, tiny_context
for w in ("rife2d_train_droplet", "rife3d_train_256", "rife2d_interp_droplet", "rife3d_interp_256"):
    assert run_tiny(tiny_context(w, seconds=0.2))["correct"], w
print("LOADED", harness.forbidden_modules())
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _RUN_ALL.format(root=str(REPO))],
                         capture_output=True, text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


_REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import torch
from portbench.reference.ifnet import RefIFNet, losses, train_steps, series
from portbench.reference.flops import count
import json
cfg = json.load(open({cfg!r}))
cfg["model"].update(block_channels=[8, 8, 8], teacher_channels=8)
model = RefIFNet(cfg["model"])
x = [torch.rand(1, 1, 32, 64) for _ in range(3)]
train_steps(model, [x], cfg)
count(cfg, (1, 32, 64), True)
print("TOP", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_the_reference_loads_nothing_of_the_program():
    cfg = REPO / "portbench" / "configs" / "ifnet2d_droplet.json"
    out = subprocess.run([sys.executable, "-c", _REFERENCE.format(root=str(REPO), cfg=str(cfg))],
                         capture_output=True, text=True, cwd="/", timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    top = out.stdout.split("TOP", 1)[1]
    for name in ("opticalflowscivis_tpu_torch", "'opticalflowscivis_tpu'", "'jax'"):
        assert name not in top
    for path in (REPO / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
                assert not any(n.split(".")[0].startswith("opticalflowscivis") for n in names)


def test_a_checkout_without_the_port_prints_no_result(tmp_path):
    _copy_benchmark(tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "rife3d_train_256", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_judge_compares_the_numbers_that_the_limits_name():
    limits = {"a": 1.0, "b": 0.0}
    assert harness.judge({"a": 0.5, "b": 0.0, "c": 9.0}, limits)[0]
    assert not harness.judge({"a": 1.5, "b": 0.0}, limits)[0]
    assert not harness.judge({"a": 0.5}, limits)[0]  # a limit without its number
    assert not harness.judge({"a": float("nan"), "b": 0.0}, limits)[0]
    assert not harness.judge({"a": 0.5}, {})[0]
    assert list(harness.judge({"a": 0.5, "b": 0.0, "c": 9.0}, limits)[1]) == ["a", "b"]
