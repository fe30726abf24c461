"""PyTorch port: the evaluation surface against the JAX package.

Twins of ``tests/test_aux.py``'s selection cases and of
``tests/test_evalsuite.py``'s viz smoke: time-step selection and its curve
equal the reference's; ``check_tensor`` and ``trace`` over
``torch.profiler``; the flow colourings equal the reference's and every panel
writes its file; the ``select`` verb with ``--linear`` (its report equals the
reference CLI's) and with a trained checkpoint; the panels the verbs draw,
and their reports without matplotlib.
"""

import builtins
import json
import os
import pickle

import numpy as np
import pytest
import torch

from opticalflowscivis_tpu.cli.__main__ import main as jcli
from opticalflowscivis_tpu.evalsuite import selection as jselection
from opticalflowscivis_tpu.viz import flow_viz as jflow_viz
from opticalflowscivis_tpu_torch.cli.__main__ import WAITING_VERBS, _viz
from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
from opticalflowscivis_tpu_torch.data import rectangle_2d
from opticalflowscivis_tpu_torch.evalsuite import (
    linear_interpolation_baseline,
    select_timesteps,
    selection_curve,
)
from opticalflowscivis_tpu_torch.losses import RIFELossWeights
from opticalflowscivis_tpu_torch.training import ModelConfig, OptimConfig, TrainConfig
from opticalflowscivis_tpu_torch.utils import check_tensor, trace


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _last_json(capsys):
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


# -- selection ---------------------------------------------------------------------------


def test_select_timesteps_flags_the_bad_frame():
    rng = np.random.default_rng(2)
    orig = rng.uniform(0, 255, (8, 8, 8)).astype(np.float32)
    interp = orig + rng.normal(0, 2.0, orig.shape).astype(np.float32)
    interp[3] += 80.0  # one badly reconstructed frame
    selected, thr = select_timesteps(orig, interp, factor=2)
    assert selected == [3]
    assert (selected, thr) == jselection.select_timesteps(orig, interp, factor=2)


@pytest.mark.parametrize("factor, threshold, data_range", [
    (2, None, 255.0), (3, None, 1.0), (4, 30.0, 255.0), (2, 1e9, 1.0)])
def test_select_timesteps_equals_the_reference(factor, threshold, data_range):
    rng = np.random.default_rng(factor)
    orig = rng.uniform(0, data_range, (13, 6, 7)).astype(np.float32)
    interp = orig + rng.normal(0, 0.05 * data_range, orig.shape).astype(np.float32)
    interp[::5] = orig[::5]  # some frames exact: infinite PSNR is left out of the mean
    got = select_timesteps(orig, interp, factor, threshold, data_range)
    assert got == jselection.select_timesteps(orig, interp, factor, threshold, data_range)


def test_selection_curve_equals_the_reference():
    frames = np.random.default_rng(3).uniform(0, 1, (9, 8, 8)).astype(np.float32)
    curve = selection_curve(frames, linear_interpolation_baseline, factors=(2, 4, 16),
                            data_range=1.0)
    assert set(curve) == {2, 4}  # 16 needs 17 frames
    assert curve[2]["n_kept"] > curve[4]["n_kept"]
    assert curve == jselection.selection_curve(frames, linear_interpolation_baseline,
                                               factors=(2, 4, 16), data_range=1.0)


# -- profiling ---------------------------------------------------------------------------


def test_check_tensor_prints_its_statistics(capsys):
    check_tensor(torch.tensor([[1.0, float("nan")], [-2.0, 4.0]]), "x")
    assert capsys.readouterr().out.startswith("x: shape=(2, 2) min=nan")
    check_tensor(torch.tensor([1.0, -2.0, 4.0], dtype=torch.bfloat16), "y")
    assert capsys.readouterr().out.strip() == (
        "y: shape=(3,) min=-2.00000 max=4.00000 mean=1.00000 nan=False")


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tb")) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert path == str(tmp_path / "tb" / "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# -- plots -------------------------------------------------------------------------------


def test_viz_smoke(tmp_path):
    from opticalflowscivis_tpu_torch.viz import (
        flow2rgb,
        flow_to_hsv,
        flow_to_image,
        plot_factor_comparison,
        plot_loss,
        visualize_3d,
        visualize_large,
        visualize_large_3d,
        visualize_series,
        visualize_series_flow,
    )

    flow = np.random.default_rng(0).normal(0, 3, (8, 8, 2)).astype(np.float32)
    for fn in (flow2rgb, flow_to_hsv, flow_to_image):
        rgb = fn(flow)
        assert rgb.shape == (8, 8, 3)
        assert rgb.min() >= 0 and rgb.max() <= 1
        np.testing.assert_array_equal(rgb, getattr(jflow_viz, fn.__name__)(flow))
    np.testing.assert_array_equal(flow_to_image(flow, max_flow=2.0),
                                  jflow_viz.flow_to_image(flow, max_flow=2.0))

    frames = np.random.default_rng(1).uniform(0, 1, (6, 16, 16)).astype(np.float32)
    flows = np.random.default_rng(2).normal(0, 2, (6, 16, 16, 2)).astype(np.float32)
    d = str(tmp_path)
    visualize_series(frames, d, "series")
    visualize_series_flow(frames, flows, d, "flowq")
    visualize_large(frames, frames, np.abs(frames - frames), frames, flows, flows, d, "panel")
    vol = np.random.default_rng(3).uniform(0, 1, (4, 8, 8, 8)).astype(np.float32)
    visualize_large_3d(vol, vol, np.abs(vol - vol), d, "panel3d")
    visualize_3d(vol[0], d, "vol")
    plot_factor_comparison({2: {"psnr": 30.0, "ssim": 0.9, "psnr_linear_baseline": 28.0,
                                  "ssim_linear_baseline": 0.85}}, d)
    loss_path = tmp_path / "loss.json"
    loss_path.write_text(json.dumps({"val_loss": [[1, 2, 3, 4, 5, 6, 7]] * 3}))
    plot_loss(str(loss_path), d)
    assert sorted(os.listdir(d)) == [
        "factor_comparison.png", "flowq.png", "loss.json", "loss.png", "panel.png",
        "panel3d.png", "series.png", "vol.png"]


# -- the verbs ---------------------------------------------------------------------------


def _write_series(tmp_path, n_frames=65):
    data = tmp_path / "d"
    data.mkdir()
    frames = rectangle_2d(n_frames=n_frames, grid=(32, 48), box=(10, 12), seed=4)
    with open(data / "rectangle2d.pkl", "wb") as f:
        pickle.dump(frames, f, protocol=4)
    return str(data)


def test_select_linear_equals_the_reference_cli(tmp_path, capsys, monkeypatch):
    """``select --linear`` needs no model: its report equals the reference
    verb's on the same series, and is written beside the results."""
    data = _write_series(tmp_path)
    args = ["select", "--linear", "--dataset", "rectangle2d", "--data_dir", data,
            "--factor", "4", "--factors", "2,4,8,32"]
    cli(args + ["--cpu", "--results_dir", str(tmp_path / "r")])
    report = _last_json(capsys)
    monkeypatch.setattr("sys.argv", ["cli"] + args + ["--cpu", "--results_dir",
                                                      str(tmp_path / "jr")])
    jcli()
    assert report == _last_json(capsys)
    assert set(report) == {"dataset", "factor", "psnr_threshold", "selected_timesteps",
                           "n_selected", "curve"}
    assert set(report["curve"]) == {"2", "4", "8"} and report["factor"] == 4
    assert report["n_selected"] == len(report["selected_timesteps"])
    with open(tmp_path / "r" / "selection_rectangle2d.json") as f:
        assert json.load(f) == report
    cli(args + ["--cpu", "--results_dir", str(tmp_path / "r"), "--threshold", "1e9"])
    every = _last_json(capsys)  # every imperfect interpolated frame falls below it
    assert every["psnr_threshold"] == 1e9
    assert set(report["selected_timesteps"]) < set(every["selected_timesteps"])
    assert all(t % 4 for t in every["selected_timesteps"])
    assert "select" not in WAITING_VERBS and set(WAITING_VERBS) == {"bench"}


def test_select_without_a_checkpoint_exits_and_with_one_reports(tmp_path, capsys):
    """Without ``--linear`` the verb needs a trained checkpoint (the
    reference's message); after one epoch of ``train`` on a narrow model it
    reconstructs through the interpolator, and ``test`` draws its panel and
    loss curve."""
    data = _write_series(tmp_path)
    cfg = TrainConfig(
        dataset="rectangle2d", epochs=1, batch_size=4, data_dir=data,
        results_dir=str(tmp_path / "r"), log_dir=str(tmp_path / "l"),
        model=ModelConfig(block_channels=(16, 12, 8), teacher_channels=8, bfloat16=False),
        loss=RIFELossWeights.preset_2d(flow_supervised=True),
        optim=OptimConfig(lr_max=1e-3, warmup_steps=5),
    )
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    common = ["--cpu", "--config_json", str(tmp_path / "cfg.json"), "--dataset", "rectangle2d",
              "--data_dir", data, "--results_dir", str(tmp_path / "r")]
    with pytest.raises(SystemExit, match="select needs a trained checkpoint"):
        cli(["select", *common])
    cli(["train", *common])
    cli(["select", *common, "--factor", "2", "--factors", "2,4"])
    report = _last_json(capsys)
    assert set(report["curve"]) == {"2", "4"}
    assert all(np.isfinite(v) for row in report["curve"].values() for v in row.values())
    assert all(t % 2 == 1 for t in report["selected_timesteps"])
    cli(["test", *common, "--batch_size", "4"])
    run = tmp_path / "r" / "rectangle2d" / "2x" / "flownet"
    assert {"test_panel.png", "loss.png", "test_report.json"} <= set(os.listdir(run))


def test_verbs_report_without_matplotlib(tmp_path, capsys, monkeypatch):
    """Where matplotlib does not import, ``_viz`` says so in one line and the
    verbs write their reports as before; other import errors still raise."""
    import sys

    import opticalflowscivis_tpu_torch

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return real_import(name, *args, **kwargs)

    for mod in [m for m in sys.modules if m.startswith(("opticalflowscivis_tpu_torch.viz",
                                                          "matplotlib"))]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.delattr(opticalflowscivis_tpu_torch, "viz", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert _viz() is None
    assert capsys.readouterr().out == "panels not drawn: matplotlib is missing\n"

    data = _write_series(tmp_path)
    res = tmp_path / "r"
    cli(["inference_video", "--cpu", "--config_json", _narrow_cfg_file(tmp_path, data, res),
         "--factors", "2", "--max_frames", "5"])
    out = capsys.readouterr().out
    assert "panels not drawn: matplotlib is missing" in out
    assert os.listdir(res / "rectangle2d") == ["interp_report.json"]

    def broken(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("matplotlib is broken in another way", name="numpy")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", broken)
    with pytest.raises(ImportError, match="another way"):
        _viz()


def _narrow_cfg_file(tmp_path, data, res):
    cfg = TrainConfig(model=ModelConfig(block_channels=(16, 12, 8), teacher_channels=8,
                                        bfloat16=False), data_dir=data, results_dir=str(res),
                      log_dir=str(tmp_path / "l"))
    path = tmp_path / "narrow.json"
    path.write_text(cfg.to_json())
    return str(path)
