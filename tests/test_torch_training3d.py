"""PyTorch port: the 3-D training path against the JAX package, the twin of
``tests/test_training3d.py``, and the 3-D CLI verbs and ``train256`` module.

Narrow model (blocks (12, 8, 8), teacher 8, 4-wide stride-2 convs) on 16^3
``rectangle3d`` tuples, float32, on the CPU, ``r_z = r_yx = 4``.  The JAX model
clips ``flow_z`` only on the CPU; the numpy-drawn weights are scaled so that
all flows stay inside ±4, which each parity case asserts.  Tolerances are
stated at each comparison.
"""

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from opticalflowscivis_tpu.losses.rife import rife_losses as jax_rife_losses
from opticalflowscivis_tpu.training import TrainConfig as JaxTrainConfig
from opticalflowscivis_tpu.training import build_model as jax_build_model
from opticalflowscivis_tpu.training import make_train_step as jax_make_train_step
from opticalflowscivis_tpu.training import warmup_cosine as jax_warmup_cosine
from opticalflowscivis_tpu_torch.bridge import ifnet_params_from_flax
from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
from opticalflowscivis_tpu_torch.data import (
    device_flip_augment,
    flip_augment,
    group_tuples,
    rectangle_3d,
)
from opticalflowscivis_tpu_torch.losses import RIFELossWeights
from opticalflowscivis_tpu_torch.scripts import forward3d, train256
from opticalflowscivis_tpu_torch.training import (
    ModelConfig,
    OptimConfig,
    TrainConfig,
    Trainer,
    make_train_step,
)

R = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small torch ops; with several test workers on one
    machine the intra-op thread pools oversubscribe the cores and such loops
    slow down a hundredfold.  One thread per worker is the fastest setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _narrow(**kw) -> ModelConfig:
    return ModelConfig(ndim=3, block_channels=(12, 8, 8), teacher_channels=8, conv0_kernel=4,
                       bounded_warp_rz=R, fast_warp_r=R, bfloat16=False, **kw)


@pytest.fixture(scope="module")
def tiny_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train3d")
    cfg = TrainConfig(
        dataset="rectangle3d", epochs=2, batch_size=4, model=_narrow(),
        loss=RIFELossWeights.preset_3d(),
        data_dir=str(tmp / "data"), log_dir=str(tmp / "log"), results_dir=str(tmp / "res"),
        optim=OptimConfig(lr_max=1e-3, warmup_steps=5),
    )
    arr = rectangle_3d(n_frames=36, grid=(16, 16, 16), box=(6, 8, 6), seed=4)
    return cfg, group_tuples(arr, 1).astype(np.float32)


def _in_dir(cfg, tmp_path):
    return dataclasses.replace(cfg, log_dir=str(tmp_path / "log"),
                               results_dir=str(tmp_path / "res"))


def _textured(tuples, seed=0):
    """The moving box on a random texture, so that every voxel carries signal."""
    out = tuples.copy()
    out[..., 0] += np.random.default_rng(seed).uniform(0.05, 0.3, out.shape[:-1]).astype(
        np.float32)
    return out


def _numpy_params(jnet, seed, gain=0.7):
    """Params of ``jnet`` drawn with numpy on its abstract shapes (no init)."""
    x = jax.ShapeDtypeStruct((1, 16, 16, 16, 1), jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, x, x)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (gain * rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "slope" in name:
            return rng.uniform(0.1, 0.4, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


# -- losses and gradients through the model -----------------------------------------


@pytest.mark.parametrize("distill", [0.0, 0.1], ids=["preset_3d", "distill_0.1"])
def test_rife_losses_preset_3d_match_jax_values_and_parameter_gradients(tiny_setup, distill):
    """Forward + ``rife_losses`` in both packages from bridged weights: every
    part (rtol 2e-5, float32 convolutions in other orders) and the gradient of
    ``loss_G`` with respect to every parameter (1e-4 of the largest gradient;
    the flax gradient tree goes through the bridge, which only permutes and
    flips)."""
    cfg, tuples = tiny_setup
    weights = RIFELossWeights.preset_3d(distill=distill)
    cfg = dataclasses.replace(cfg, loss=weights)
    jcfg = JaxTrainConfig.from_json(cfg.to_json())
    jmodel = jax_build_model(jcfg)
    params = _numpy_params(jmodel, seed=2)
    batch = _textured(tuples[:2])
    img0, img1, gt = (batch[:, slot, ..., :1] for slot in (0, 1, 2))

    def jax_loss(p):
        out = jmodel.apply(p, img0, img1, gt)
        loss, parts = jax_rife_losses(out, img0, img1, gt, p, jcfg.loss, 3)
        return loss, (parts, out)

    (_, (jparts, jout)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    flows = list(jout["flow_list"]) + [jout["flow_teacher"]]
    assert 0.05 < max(float(jnp.abs(f).max()) for f in flows) < R

    tr = Trainer(cfg, device="cpu")
    tr.model.load_state_dict(ifnet_params_from_flax(params), strict=True)
    tr.init_state(total_steps=4)
    _, ev = make_train_step(tr.model, cfg, has_flow=False)
    parts = tr.train_step(torch.from_numpy(batch))  # lr 0 on the first step: weights stay
    assert set(parts) == set(jparts)
    for key, ref in jparts.items():
        assert float(parts[key]) == pytest.approx(float(ref), rel=2e-5, abs=1e-9), key
    assert (float(parts["loss_distill"]) > 0) == (distill > 0)
    assert float(parts["loss_photo"]) == 0 and float(parts["l1_reg"]) == 0

    ref_grads = ifnet_params_from_flax(jax.tree.map(np.asarray, jgrads))
    largest = max(float(g.abs().max()) for g in ref_grads.values())
    assert largest > 1e-4
    for name, p in tr.model.named_parameters():
        err = float((p.grad - ref_grads[name]).abs().max())
        assert err <= 1e-4 * largest, (name, err, largest)
    assert float(ev(None, torch.from_numpy(batch))[0]["loss_G"]) == pytest.approx(
        float(jparts["loss_G"]), rel=2e-5)


def test_three_train_steps_match_optax_in_3d(tiny_setup):
    """Three updates from bridged weights at 16^3 (the first runs at lr 0 in
    both, so three steps compare two real updates).  ``parts`` each step: rtol
    2e-5.  Parameters after step 3: atol 1e-5 against a movement of up to 6e-4
    per element (Adam moves each element by about lr per step; lr is 0, 2e-4,
    4e-4)."""
    cfg, tuples = tiny_setup
    cfg = dataclasses.replace(cfg, batch_size=2, loss=RIFELossWeights.preset_3d(distill=0.1))
    total_steps = 9
    jcfg = JaxTrainConfig.from_json(cfg.to_json())
    jmodel = jax_build_model(jcfg)
    params = _numpy_params(jmodel, seed=3)
    o = jcfg.optim
    tx = optax.adamw(jax_warmup_cosine(o.lr_max, o.lr_min, o.warmup_steps, total_steps,
                                       o.world_scale), weight_decay=o.weight_decay)
    jstate = train_state.TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx)
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg, has_flow=False)[0])

    tr = Trainer(cfg, device="cpu")
    tr.model.load_state_dict(ifnet_params_from_flax(params), strict=True)
    state = tr.init_state(total_steps)
    step, _ = make_train_step(tr.model, cfg, has_flow=False)

    textured = _textured(tuples[:6])
    for i in range(3):
        batch = textured[2 * i : 2 * i + 2]
        parts = step(state, torch.from_numpy(batch))
        jstate, jparts = jstep(jstate, jnp.asarray(batch))
        assert set(parts) == set(jparts)
        for key, ref in jparts.items():
            assert float(parts[key]) == pytest.approx(float(ref), rel=2e-5, abs=1e-9), (i, key)
    assert state.step == int(jstate.step) == 3

    ref_state = ifnet_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    start = ifnet_params_from_flax(params)
    moved = 0.0
    for name, value in tr.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref_state[name].numpy(), atol=1e-5,
                                   err_msg=name)
        moved = max(moved, float((value - start[name]).abs().max()))
    assert 1e-4 < moved < 1e-3  # the updates are there, and of the expected size


# -- twin of tests/test_training3d.py ---------------------------------------------------


def test_3d_fit_and_best_val_checkpoint(tiny_setup, tmp_path):
    cfg, tuples = tiny_setup
    cfg = dataclasses.replace(
        _in_dir(cfg, tmp_path), keep_best_only=True, early_stop_patience=1000,
        model=dataclasses.replace(cfg.model, conv0_kernel=3),
    )
    # 3-D preset: plain L1 reconstruction, photometric and regularizer off, distill off
    assert not cfg.loss.use_lap and cfg.loss.distill == 0.0
    assert RIFELossWeights.preset_3d(distill=0.1).distill == 0.1
    tr = Trainer(cfg, device="cpu")
    hist = tr.fit(tuples[:8], tuples[8:10], epochs=2, log_every=0)
    assert len(hist) == 2 and tr.steps_per_epoch == 2
    assert np.isfinite(hist[-1]["loss_G"])
    assert os.path.isfile(tr.checkpoint_path())  # best-val mode saves at least the first epoch
    assert tr.results_dir.endswith(os.path.join("rectangle3d", "2x", "flownet"))
    with open(os.path.join(tr.results_dir, "loss.json")) as f:
        rows = json.load(f)["val_loss"]
    assert len(rows) == 2 and len(rows[0]) == 7

    # the checkpoint holds the best epoch; a fresh trainer restores it
    saved = torch.load(tr.checkpoint_path(), weights_only=True)["step"]
    best = int(np.argmin([h["loss_G"] for h in hist]))
    assert saved == 2 * (best + 1)
    fresh = Trainer(cfg, device="cpu")
    fresh.init_state(total_steps=4)
    assert fresh.load_checkpoint() and fresh.state.step == saved
    if best == 1:
        assert fresh.evaluate(tuples[8:10], 2) == tr.evaluate(tuples[8:10], 2)

    parts, extras = tr.predict(tuples[:2])
    assert extras["pred"].shape == (2, 16, 16, 16, 1)
    assert extras["flow"].shape == (2, 16, 16, 16, 6)
    assert extras["mask"].shape == extras["pred_tea"].shape == (2, 16, 16, 16, 1)
    assert np.isfinite(float(parts["loss_G"]))


def test_fit_lowers_the_loss_on_volumes(tiny_setup, tmp_path):
    cfg, tuples = tiny_setup
    tr = Trainer(_in_dir(cfg, tmp_path), device="cpu")
    hist = tr.fit(_textured(tuples[:8]), _textured(tuples[8:10], 1), epochs=3, log_every=0)
    assert hist[-1]["loss_G"] < hist[0]["loss_G"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_flip_augment_equals_host_order_in_3d(tiny_setup, dtype):
    """Two of the three axes flip (z and y), as on the host and in the JAX
    package, and the matching flow components change sign."""
    _, tuples = tiny_setup
    base = tuples[:3]
    hosted = flip_augment(base.reshape((-1,) + base.shape[2:])).reshape((-1,) + base.shape[1:])
    assert hosted.shape[0] == 12
    idx = torch.arange(4 * 3)
    out = device_flip_augment(torch.from_numpy(base).to(dtype)[idx % 3], idx // 3, ndim=3)
    assert out.dtype == dtype
    assert torch.equal(out, torch.from_numpy(hosted).to(dtype))
    assert (base[..., 1] != 0).any()  # there is a z velocity whose sign can flip
    no_flow = device_flip_augment(torch.from_numpy(base[..., :1])[idx % 3], idx // 3, ndim=3)
    assert torch.equal(no_flow, torch.from_numpy(hosted[..., :1]))


def test_bf16_resident_dataset_with_device_flips_trains(tiny_setup, tmp_path):
    """The 3-D recipe of the CLI: the tuples lie on the device in bfloat16, the
    index space is 4x with on-device flips, ``remat`` recomputes the blocks."""
    cfg, tuples = tiny_setup
    cfg = dataclasses.replace(
        _in_dir(cfg, tmp_path), device_flip_aug=True, hbm_dataset_dtype="bfloat16",
        model=dataclasses.replace(cfg.model, remat=True),
    )
    tr = Trainer(cfg, device="cpu")
    hist = tr.fit(tuples[:4], tuples[8:10], epochs=1, log_every=0)
    assert tr.steps_per_epoch == 4 and tr.state.step == 4
    assert np.isfinite(hist[-1]["loss_G"])
    plain = Trainer(dataclasses.replace(cfg, log_dir=str(tmp_path / "l2"),
                                        results_dir=str(tmp_path / "r2"),
                                        model=dataclasses.replace(cfg.model, remat=False)),
                    device="cpu")
    hist_plain = plain.fit(tuples[:4], tuples[8:10], epochs=1, log_every=0)
    # remat changes what is kept, not what is computed
    assert hist[-1]["loss_G"] == pytest.approx(hist_plain[-1]["loss_G"], rel=1e-5)


# -- CLI and train256 ------------------------------------------------------------------


def _last_json(capsys):
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def test_cli_train_test_inference_video_on_rectangle3d(tmp_path, capsys):
    """The verbs on a 16^3 ``rectangle3d.pkl`` with a narrow model given
    through ``--config_json`` (the flags alone build ``ifnet_3d`` at full width)."""
    data, res, log = (str(tmp_path / d) for d in ("d", "r", "l"))
    os.makedirs(data)
    series = rectangle_3d(n_frames=60, grid=(16, 16, 16), box=(6, 8, 6), seed=0)
    with open(os.path.join(data, "rectangle3d.pkl"), "wb") as f:
        pickle.dump(series, f, protocol=4)
    cfg = TrainConfig(
        dataset="rectangle3d", epochs=1, batch_size=4, data_dir=data, results_dir=res,
        log_dir=log, device_flip_aug=True, hbm_dataset_dtype="bfloat16", keep_best_only=True,
        early_stop_patience=1000, model=_narrow(remat=True), loss=RIFELossWeights.preset_3d(),
        optim=OptimConfig(lr_max=1e-3, warmup_steps=5),
    )
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    common = ["--cpu", "--config_json", str(tmp_path / "cfg.json")]

    cli(["train", *common])
    final = _last_json(capsys)["final_val"]
    assert np.isfinite(final["loss_G"]) and final["loss_flow"] == 0
    run_dir = os.path.join(res, "rectangle3d", "2x", "flownet")
    with open(os.path.join(run_dir, "loss.json")) as f:
        assert len(json.load(f)["val_loss"]) == 1
    assert os.path.isfile(os.path.join(log, "rectangle3d", "flownet.ckpt"))

    cli(["test", *common, "--batch_size", "2"])
    report = _last_json(capsys)
    assert set(report) == {"psnr", "ssim", "epe_ft1", "epe_ft0"}
    assert all(np.isfinite(v) for v in report.values())

    cli(["inference_video", *common, "--factors", "2,4", "--max_frames", "9", "--tta"])
    results = _last_json(capsys)
    assert set(results) == {"2", "4"}
    for row in results.values():
        assert set(row) == {"psnr", "ssim", "psnr_linear_baseline", "ssim_linear_baseline"}
        assert all(np.isfinite(v) for v in row.values())


def test_flags_build_the_full_width_3d_config():
    """Without ``--config_json`` a 3-D dataset gets the reference's 3-D recipe."""
    import argparse

    from opticalflowscivis_tpu_torch.cli.__main__ import _add_common, _build_cfg

    p = argparse.ArgumentParser()
    _add_common(p)
    p.add_argument("--distill", type=float, default=None)
    cfg = _build_cfg(p.parse_args(["--dataset", "droplet3d"]), epochs=3)
    assert cfg.model == ModelConfig.preset_3d(remat=True) and cfg.model.ndim == 3
    assert cfg.model.block_channels == (128, 64, 64) and cfg.model.conv0_kernel == 4
    assert (cfg.model.bounded_warp_rz, cfg.model.fast_warp_r) == (8, 8)
    assert cfg.loss == RIFELossWeights.preset_3d()
    assert cfg.keep_best_only and cfg.early_stop_patience == 1000
    assert cfg.hbm_dataset_dtype == "bfloat16" and cfg.device_flip_aug
    cfg = _build_cfg(p.parse_args(["--dataset", "jets3d", "--distill", "0.1"]))
    assert cfg.loss.distill == 0.1 and not cfg.device_flip_aug  # jets3d does not flip
    jcfg = JaxTrainConfig.from_json(cfg.to_json())  # the same recipe loads in the JAX package
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("coarse", [False, True], ids=["scale1", "coarse_final"])
def test_train256_module_runs_at_a_small_grid(tmp_path, capsys, coarse):
    """``train256`` at 32^3 on the CPU: full width, remat, bf16-resident data,
    on-device flips; then ``--eval_only`` restores its checkpoint."""
    argv = ["--grid", "32", "--frames", "5", "--epochs", "1", "--cpu", "--out", str(tmp_path)]
    argv += ["--coarse_final"] if coarse else []
    report = train256.main(argv)
    assert report["steps"] == 4 and report["grid"] == 32 and report["device"] == "cpu"
    assert report["coarse_final"] is coarse
    for key in ("seconds_per_step", "train_step_seconds", "val_loss_final", "val_psnr_model",
                "val_psnr_linear", "val_psnr_copy_frame"):
        assert np.isfinite(report[key]) and report[key] > 0, key
    assert "cuda_peak_bytes" not in report  # a device number: only measured on a card
    with open(tmp_path / "train256_report.json") as f:
        assert json.load(f) == report
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report

    again = train256.main(argv + ["--eval_only", "--val_tuples", "2"])
    assert again["epochs_completed"] == 1 and again["val_set"] == "seed7_positions"
    assert again["val_loss_final"] == report["val_loss_final"]
    assert np.isfinite(again["val_psnr_model"])


def test_train256_eval_only_needs_a_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint"):
        train256.main(["--grid", "32", "--eval_only", "--cpu", "--out", str(tmp_path)])


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_forward3d_module_times_a_forward_at_a_small_grid(capsys, f32):
    report = forward3d.main(["--grid", "32", "--cpu", "--iters", "2"] + (["--f32"] if f32 else []))
    assert report["compute"] == ("float32" if f32 else "bfloat16") and report["device"] == "cpu"
    assert report["forward_ms"] > 0 and np.isfinite(report["volume_pairs_per_sec"])
    assert report["warp3d_launches_per_forward"] == 0  # CPU tensors: the plain version
    assert "cuda_peak_bytes" not in report
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
