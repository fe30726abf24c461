"""PyTorch port: the CLI verbs end to end on the CPU, in process, in 2-D
(the 3-D twins are in ``test_torch_training3d.py``).

``generate → train → test → inference_video`` in a temporary directory, on a
narrow model given through ``--config_json`` (the flags alone build the
full-width ``ifnet_2d``, which ``chip_smoke.py`` drives on the GPU).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from opticalflowscivis_tpu_torch.cli.__main__ import WAITING_VERBS, main
from opticalflowscivis_tpu_torch.losses import RIFELossWeights
from opticalflowscivis_tpu_torch.training import ModelConfig, OptimConfig, TrainConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small torch ops; with several test workers on one
    machine the intra-op thread pools oversubscribe the cores and such loops
    slow down a hundredfold.  One thread per worker is the fastest setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _last_json(capsys):
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def test_generate_train_test_inference_video(tmp_path, capsys):
    data, res, log = (str(tmp_path / d) for d in ("d", "r", "l"))
    main(["generate", "--dataset", "rectangle2d", "--frames", "99", "--data_dir", data])
    assert os.path.exists(os.path.join(data, "rectangle2d.pkl"))

    cfg = TrainConfig(
        dataset="rectangle2d", epochs=1, batch_size=8, data_dir=data, results_dir=res,
        log_dir=log, device_flip_aug=True,
        model=ModelConfig(block_channels=(16, 12, 8), teacher_channels=8, bfloat16=False),
        loss=RIFELossWeights.preset_2d(flow_supervised=True),
        optim=OptimConfig(lr_max=1e-3, warmup_steps=5),
    )
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    common = ["--cpu", "--config_json", str(cfg_path)]

    main(["train", *common])
    final = _last_json(capsys)["final_val"]
    assert np.isfinite(final["loss_G"]) and final["loss_flow"] > 0
    run_dir = os.path.join(res, "rectangle2d", "2x", "flownet")
    with open(os.path.join(run_dir, "loss.json")) as f:
        assert len(json.load(f)["val_loss"]) == 1
    assert os.path.isfile(os.path.join(log, "rectangle2d", "flownet.ckpt"))

    main(["train", *common, "--resume"])
    with open(os.path.join(run_dir, "loss.json")) as f:
        assert len(json.load(f)["val_loss"]) == 2
    capsys.readouterr()

    main(["test", *common, "--batch_size", "4"])
    report = _last_json(capsys)
    assert set(report) == {"psnr", "ssim", "epe_ft1", "epe_ft0"}
    assert all(np.isfinite(v) for v in report.values())
    with open(os.path.join(run_dir, "test_report.json")) as f:
        assert json.load(f) == report

    main(["inference_video", *common, "--factors", "2,4", "--max_frames", "9"])
    results = _last_json(capsys)
    assert set(results) == {"2", "4"}
    for row in results.values():
        assert set(row) == {"psnr", "ssim", "psnr_linear_baseline", "ssim_linear_baseline"}
        assert all(np.isfinite(v) for v in row.values())
    assert os.path.exists(os.path.join(res, "rectangle2d", "interp_report.json"))


def test_inference_img_writes_frames(tmp_path, capsys):
    """Two ``.npy`` frames in, 2**n_exp + 1 pngs out (fresh weights: no checkpoint)."""
    pytest.importorskip("cv2")
    cfg = TrainConfig(model=ModelConfig(block_channels=(16, 12, 8), teacher_channels=8,
                                        bfloat16=False), log_dir=str(tmp_path / "l"))
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    rng = np.random.default_rng(0)
    for name in ("a", "b"):
        np.save(tmp_path / f"{name}.npy", rng.uniform(0, 1, (40, 48)).astype(np.float32))
    out = tmp_path / "out"
    main(["inference_img", "--cpu", "--config_json", str(tmp_path / "cfg.json"),
          "--img0", str(tmp_path / "a.npy"), "--img1", str(tmp_path / "b.npy"),
          "--out_dir", str(out), "--n_exp", "2"])
    assert sorted(os.listdir(out)) == [f"img{i}.png" for i in range(5)]
    assert "No checkpoint" in capsys.readouterr().out


@pytest.mark.parametrize("verb", sorted(WAITING_VERBS))
def test_verbs_that_wait_exit_with_their_roadmap_item(verb):
    with pytest.raises(SystemExit, match=r"ROADMAP A\.\d+"):
        main([verb])


def test_unknown_verb_prints_usage(capsys):
    with pytest.raises(SystemExit) as exc:
        main(["frobnicate"])
    assert exc.value.code == 2
    assert "train_upflow" in capsys.readouterr().out


def test_flags_build_the_full_width_config():
    """Without ``--config_json`` the verbs build ``ifnet_2d`` at full width,
    flow-supervised on request, with on-device flips for datasets that flip."""
    import argparse

    from opticalflowscivis_tpu_torch.cli.__main__ import _add_common, _build_cfg

    p = argparse.ArgumentParser()
    _add_common(p)
    p.add_argument("--flow_supervised", action="store_true")
    p.add_argument("--distill", type=float, default=None)
    args = p.parse_args(["--flow_supervised", "--distill", "0.1", "--exp", "2"])
    cfg = _build_cfg(args, epochs=7)
    assert cfg.model == ModelConfig() and cfg.epochs == 7 and cfg.exp == 2
    assert cfg.loss == dataclasses.replace(RIFELossWeights.preset_2d(True), distill=0.1)
    assert cfg.device_flip_aug
