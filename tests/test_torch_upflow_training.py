"""PyTorch port: the UPFlow trainer and its CLI verbs against the JAX package.

Three optimizer steps from bridged weights against the reference's own train
step and optax chain; then the twins of ``tests/test_upflow.py``'s trainer
cases (``fit`` lowers the loss, logs ``val_epe``, the ex_runner preset, the
config defaults), resume with ``ckpt_meta.json`` and ``loss.json`` truncation,
the ``STOP`` file, and ``train_upflow`` / ``test_upflow`` with ``--cpu``.

Everything runs at the ``TINY`` widths of ``tests/test_upflow.py`` but the CLI,
whose flags build the full-width model (on 64 x 64 frames, a few steps).
"""

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowscivis_tpu.losses import selfsup as jselfsup
from opticalflowscivis_tpu.losses import UPFlowLossConfig as JaxLossConfig
from opticalflowscivis_tpu.models import UPFlowConfig as JaxUPFlowConfig
from opticalflowscivis_tpu.training import upflow_trainer as jtrainer
from opticalflowscivis_tpu_torch.bridge import upflow_params_from_flax
from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
from opticalflowscivis_tpu_torch.data import rectangle_2d
from opticalflowscivis_tpu_torch.losses import UPFlowLossConfig, selfsup
from opticalflowscivis_tpu_torch.models import UPFlowConfig
from opticalflowscivis_tpu_torch.training import (
    UPFlowTrainConfig,
    UPFlowTrainer,
    frames_to_pairs,
    upflow_trainer,
)

TINY_KW = dict(
    num_chs=(3, 4, 8, 8, 12, 16, 16),
    estimator_f_channels=(16, 16, 12, 8, 8),
    context_f_channels=(16, 16, 16, 12, 8, 8, 2),
    search_range=2,
)
NORM_KW = dict(if_norm_before_cost_volume=True, norm_moments_across_channels=False,
               norm_moments_across_images=False)
TINY = UPFlowConfig(**TINY_KW, **NORM_KW)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _textured_pairs(n, size, seed, shift=(2, -3)):
    """``[n, 2, H, W, 3]``: a smooth random texture (8 x 8 noise upsampled
    linearly, so that every pixel carries signal and the image gradient does
    not jump from pixel to pixel as white noise does) and the same texture
    moved by ``shift`` pixels plus a little noise."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.uniform(0.05, 1.0, (n, 3, 8, 8)).astype(np.float32))
    im1 = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear",
                                          align_corners=True).permute(0, 2, 3, 1).numpy()
    im2 = np.roll(im1, shift, axis=(1, 2)) + rng.uniform(0, 0.02, im1.shape).astype(np.float32)
    return np.stack([im1, im2], axis=1)


def _numpy_params(jnet, shape, seed):
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if "kernel" in jax.tree_util.keystr(path):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


# -- three optimizer steps against optax ------------------------------------------


@pytest.mark.parametrize("recipe", ["simple_clip_decay", "eq_oi"])
def test_three_train_steps_match_optax(recipe, tmp_path, monkeypatch):
    """Three updates from bridged weights through the reference's own
    ``_train_step`` and optimizer chain (``init_state``), on textured pairs.

    ``simple_clip_decay``: census on, a global-norm clip of
    0.5 and ``lr_gamma`` 0.5 over epochs of 2 steps, so the third step runs at
    half the rate.  ``eq_oi``: the second forward on a transformed pair with
    both weights at 0.5; the transform's draws (rotation, zoom, translation,
    noise) are made with numpy and handed to both packages in place of their
    own random generators.

    ``parts`` each step: rel 1e-4 (float32 convolutions in other orders through
    five levels, and from step 2 on weights that already differ in the last
    digits).  Parameters after step 3, against a movement of up to 2.5e-3 per
    element (Adam moves an element by about lr per step): the mean difference
    of every tensor below 1e-5 (0.4 % of the movement) and at most one element
    in a thousand beyond 5e-5 (2 %).  No bound holds for every element: Adam
    divides each gradient by its own running magnitude, so an element whose
    gradient nearly cancels turns a relative 1e-4 into a good part of a step
    (one element of 384 in one kernel differs by 1.3e-3, half its movement).
    A wrong rate, decay, clip or weight-decay term would move every element
    (the weight decay is 0.5 here, so that its share of a step is 5e-5 for a
    weight of 0.1).
    """
    size, batch = 64, 4
    kw = dict(batch_size=batch, lr=1e-3, weight_decay=0.5, bfloat16=False,
              exp_dir=str(tmp_path), pad_multiple=64)
    loss_kw = dict(census_weight=0.5, smooth_order_1_weight=0.1)
    if recipe == "simple_clip_decay":
        kw.update(grad_clip=0.5, lr_gamma=0.5)
    else:
        kw.update(eq_weight=0.5, oi_weight=0.5)
    jcfg = jtrainer.UPFlowTrainConfig(model=JaxUPFlowConfig(**TINY_KW, **NORM_KW),
                                      loss=JaxLossConfig(**loss_kw), **kw)
    cfg = UPFlowTrainConfig(model=TINY, loss=UPFlowLossConfig(**loss_kw), **kw)
    pairs = _textured_pairs(3 * batch, size, seed=1)

    rng = np.random.default_rng(2)
    theta = (rng.uniform(-10, 10, batch) * np.pi / 180).astype(np.float32)
    zoom = rng.uniform(0.9, 1.1, batch).astype(np.float32)
    trans = rng.uniform(-0.1, 0.1, (batch, 2)).astype(np.float32)
    noise = (rng.standard_normal((2, batch, size, size, 3)) * 0.02).astype(np.float32)

    def jax_transform(key, im1, im2, sp_cfg):
        p = (jnp.asarray(theta), jnp.asarray(zoom), jnp.asarray(trans))
        return (jselfsup.apply_affine(im1, *p) + noise[0],
                jselfsup.apply_affine(im2, *p) + noise[1], p)

    def torch_transform(gen, im1, im2, sp_cfg):
        p = (torch.from_numpy(theta), torch.from_numpy(zoom), torch.from_numpy(trans))
        return (selfsup.apply_affine(im1, *p) + torch.from_numpy(noise[0]),
                selfsup.apply_affine(im2, *p) + torch.from_numpy(noise[1]), p)

    monkeypatch.setattr(jselfsup, "sp_transform_pair", jax_transform)
    monkeypatch.setattr(upflow_trainer, "sp_transform_pair", torch_transform)

    jtr = jtrainer.UPFlowTrainer(jcfg)
    params = _numpy_params(jtr.net, (1, size, size, 3), seed=3)
    with monkeypatch.context() as m:
        # init_state builds the optimizer chain around a compiled random init
        # (as long to compile as the train step); hand it the drawn weights
        m.setattr(type(jtr.net), "init", lambda self, *a, **k: params)
        jtr.init_state(pairs[:1], steps_per_epoch=2)
    jstate = jtr.state.replace(params=params, opt_state=jtr.state.tx.init(params), step=0)
    jstep = jax.jit(jtr._train_step)

    tr = UPFlowTrainer(cfg, device="cpu")
    tr.net.load_state_dict(upflow_params_from_flax(params), strict=True)
    state = tr.init_state(steps_per_epoch=2)

    lrs = []
    for i in range(3):
        b = pairs[batch * i : batch * (i + 1)]
        lrs.append(state.optimizer.param_groups[0]["lr"])
        parts = tr.train_step({"im1": torch.from_numpy(b[:, 0]), "im2": torch.from_numpy(b[:, 1])})
        jstate, jparts = jstep(jstate, {"im1": jnp.asarray(b[:, 0]), "im2": jnp.asarray(b[:, 1])},
                               jax.random.PRNGKey(i))
        assert set(parts) == set(jparts)
        for key, ref in jparts.items():
            assert float(parts[key]) == pytest.approx(float(ref), rel=1e-4, abs=1e-7), (i, key)
    assert lrs == pytest.approx([1e-3, 1e-3, 5e-4] if recipe == "simple_clip_decay"
                                else [1e-3] * 3)
    assert ("eq_loss" in parts) == (recipe == "eq_oi")
    assert state.step == int(jstate.step) == 3

    ref_state = upflow_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    start = upflow_params_from_flax(params)
    moved, worst_mean, beyond, count = 0.0, 0.0, 0, 0
    for name, value in tr.net.state_dict().items():
        diff = (value - ref_state[name]).abs()
        worst_mean = max(worst_mean, float(diff.mean()))
        beyond += int((diff > 5e-5).sum())
        count += diff.numel()
        moved = max(moved, float((value - start[name]).abs().max()))
    print(f"{recipe}: worst mean |diff| {worst_mean:.2e}, {beyond} of {count} beyond 5e-5")
    assert worst_mean < 1e-5, worst_mean
    assert beyond <= 1e-3 * count, (beyond, count)
    assert 1e-3 < moved < 5e-3  # the updates are there, and of the expected size


# -- twins of tests/test_upflow.py ------------------------------------------------------


def test_train_config_defaults_equal_the_reference():
    """Every field the port keeps has the reference's default (``scan_chunk``
    is a matter of the TPU's dispatch and has no counterpart), the training
    default turns the cost-volume normalisation on with per-image, per-channel
    moments, and ``UPFlowConfig`` itself keeps it off."""
    ours = dataclasses.asdict(UPFlowTrainConfig())
    theirs = dataclasses.asdict(jtrainer.UPFlowTrainConfig())
    assert set(theirs) - set(ours) == {"scan_chunk"}
    assert ours == {k: v for k, v in theirs.items() if k in ours}
    cfg = UPFlowTrainConfig()
    assert cfg.model.if_norm_before_cost_volume
    assert not cfg.model.norm_moments_across_channels
    assert not cfg.model.norm_moments_across_images
    assert not UPFlowConfig().if_norm_before_cost_volume and cfg.bfloat16


def test_ex_runner_preset_accepts_lr_override():
    cfg = UPFlowTrainConfig.preset_ex_runner(lr=5e-3, batch_size=2)
    assert cfg.lr == 5e-3 and cfg.lr_gamma == 0.95 and cfg.eq_weight == 0.01
    ref = jtrainer.UPFlowTrainConfig.preset_ex_runner()
    ours = UPFlowTrainConfig.preset_ex_runner()
    assert (ours.lr, ours.weight_decay, ours.lr_gamma, ours.eq_weight, ours.oi_weight) == (
        ref.lr, ref.weight_decay, ref.lr_gamma, ref.eq_weight, ref.oi_weight)


def test_frames_to_pairs_equals_the_reference():
    frames = np.random.default_rng(0).uniform(size=(5, 6, 7, 1)).astype(np.float32)
    for channels in (3, 1):
        np.testing.assert_array_equal(frames_to_pairs(frames, channels),
                                      jtrainer.frames_to_pairs(frames, channels))
    assert frames_to_pairs(frames[..., 0], 3).shape == (4, 2, 6, 7, 3)


def test_trainer_loss_decreases(tmp_path):
    arr = rectangle_2d(n_frames=17, grid=(64, 64), box=(20, 24), seed=9)
    pairs = frames_to_pairs(arr[..., :1], in_channels=3)
    cfg = UPFlowTrainConfig(batch_size=8, bfloat16=False, exp_dir=str(tmp_path), model=TINY,
                            loss=UPFlowLossConfig(smooth_order_1_weight=0.1))
    tr = UPFlowTrainer(cfg, device="cpu")
    hist = tr.fit(pairs, epochs=3, log_every=0)
    assert len(hist) == 3 and np.isfinite(hist[-1]["loss_total"])
    assert hist[-1]["loss_total"] <= hist[0]["loss_total"] * 1.05
    parts, extras = tr.predict(pairs[:8])
    assert extras["flow_f"].shape == (8, 64, 64, 2) and extras["flow_b"].shape == (8, 64, 64, 2)
    assert set(parts) == {"photo_loss", "smooth_loss", "census_loss", "msd_loss", "occ_fw_mean",
                          "loss_total"}
    assert tr.state.step == 6
    assert sorted(os.listdir(tmp_path)) == ["ckpt_meta.json", "loss.json", "upflow.ckpt"]


def test_fit_learns_a_translation(tmp_path):
    """One textured 64 x 64 pair moved by 3 px, lr 1e-3: within 60 steps the
    photometric loss falls by a quarter and the mean forward flow leaves zero
    toward the shift (dy = +3: frame 2 is frame 1 rolled down by 3)."""
    pairs = _textured_pairs(1, 64, seed=4, shift=(3, 0))
    pairs = np.repeat(pairs, 4, axis=0)
    cfg = UPFlowTrainConfig(batch_size=4, lr=1e-3, bfloat16=False, exp_dir=str(tmp_path),
                            model=TINY, loss=UPFlowLossConfig(smooth_order_1_weight=0.1),
                            ckpt_every=100)
    tr = UPFlowTrainer(cfg, device="cpu")
    hist = tr.fit(pairs, epochs=60, log_every=0)
    assert hist[-1]["photo_loss"] < 0.75 * hist[0]["photo_loss"]
    _, extras = tr.predict(pairs[:1])
    assert float(extras["flow_f"][0, 8:-8, 8:-8, 0].mean()) > 1.0


def test_ex_runner_preset_trains_one_epoch(tmp_path):
    """float32 like its twin: PyTorch's bf16 convolution backward on the CPU now
    and then returns NaN weight gradients from finite inputs (seen in one run
    of three at these shapes), so bf16 training is exercised on the card."""
    cfg = UPFlowTrainConfig.preset_ex_runner(
        batch_size=2, n_epoch=1, exp_dir=str(tmp_path), pad_multiple=32, bfloat16=False,
        model=UPFlowConfig(**TINY_KW),
    )
    assert cfg.eq_weight == 0.01 and cfg.oi_weight == 0.01
    assert cfg.lr == 1e-2 and cfg.lr_gamma == 0.95
    frames = np.random.default_rng(0).uniform(size=(17, 32, 32, 1)).astype(np.float32)
    tr = UPFlowTrainer(cfg, device="cpu")
    hist = tr.fit(frames_to_pairs(frames, 3), epochs=2, log_every=0)
    assert len(hist) == 2 and np.isfinite(hist[0]["loss_total"])
    assert "eq_loss" in hist[0] and "oi_loss" in hist[0]
    # 8 steps per epoch: the second epoch ran at 0.95 of the rate
    assert tr.state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.95**2)


@pytest.mark.parametrize("hbm_dataset_gb", [0.0, 6.0], ids=["streamed", "resident"])
def test_fit_logs_val_epe(tmp_path, hbm_dataset_gb, capsys):
    cfg = UPFlowTrainConfig(batch_size=8, n_epoch=1, bfloat16=False,
                            hbm_dataset_gb=hbm_dataset_gb, exp_dir=str(tmp_path), model=TINY)
    tr = UPFlowTrainer(cfg, device="cpu")
    rng = np.random.default_rng(0)
    pairs = rng.uniform(size=(8, 2, 64, 64, 3)).astype(np.float32)
    val_flow = np.zeros((3, 60, 62, 2), np.float32)  # cropped ground truth
    val_flow[..., 1] = 2.0
    hist = tr.fit(pairs, epochs=1, val_pairs=pairs[:3, :, :60, :62], val_flow=val_flow,
                  log_every=1)
    assert np.isfinite(hist[0]["val_epe"]) and hist[0]["val_epe_zero_flow"] == 2.0
    with open(tmp_path / "loss.json") as f:
        logged = json.load(f)["loss"][0]
    assert logged["val_epe"] == hist[0]["val_epe"]
    assert tr.val_epe(pairs[:3, :, :60, :62], val_flow) == pytest.approx(hist[0]["val_epe"],
                                                                       rel=1e-6)
    out = capsys.readouterr().out
    assert "epoch 0 step 1 loss" in out and "val_epe" in out


def test_streamed_and_resident_fits_take_the_same_steps(tmp_path):
    pairs = _textured_pairs(8, 64, seed=5)
    finals = []
    for gb in (0.0, 6.0):
        cfg = UPFlowTrainConfig(batch_size=4, bfloat16=False, hbm_dataset_gb=gb, model=TINY,
                                exp_dir=str(tmp_path / f"gb{gb}"))
        tr = UPFlowTrainer(cfg, device="cpu")
        finals.append((tr.fit(pairs, epochs=2, log_every=0), tr.net.state_dict()))
    assert finals[0][0] == finals[1][0]
    assert all(torch.equal(v, finals[1][1][k]) for k, v in finals[0][1].items())


# -- checkpoint, resume, STOP -------------------------------------------------------------


def test_resume_continues_from_the_last_saved_epoch_and_truncates_loss_json(
        tmp_path, capsys, monkeypatch):
    """``ckpt_every=2`` and 3 epochs, the last save lost (as if the run had
    died before it): the checkpoint and ``ckpt_meta.json`` stand at epoch 2,
    ``loss.json`` has 3 entries.  A resumed run cuts ``loss.json`` to 2
    entries, runs epoch 2 again with the shuffle stream and the decayed rate
    where the first run had them, and ends on the first run's weights bit
    for bit."""
    pairs = _textured_pairs(8, 64, seed=6)
    cfg = UPFlowTrainConfig(batch_size=4, bfloat16=False, exp_dir=str(tmp_path), model=TINY,
                            ckpt_every=2, lr_gamma=0.9)
    first = UPFlowTrainer(cfg, device="cpu")
    real_save = first.save_checkpoint
    monkeypatch.setattr(first, "save_checkpoint",
                        lambda epochs_completed=None:
                        None if epochs_completed == 3 else real_save(epochs_completed))
    assert len(first.fit(pairs, epochs=3, log_every=0)) == 3
    with open(tmp_path / "ckpt_meta.json") as f:
        assert json.load(f) == {"epochs_completed": 2}
    with open(tmp_path / "loss.json") as f:
        rows = json.load(f)["loss"]
    assert len(rows) == 3

    fresh = UPFlowTrainer(dataclasses.replace(cfg, seed=0), device="cpu")
    assert fresh._completed_epochs() == 2
    hist = fresh.fit(pairs, epochs=1, resume=True, log_every=1)
    assert len(hist) == 1 and fresh.state.step == 6
    assert "epoch 2 step 5" in capsys.readouterr().out
    with open(tmp_path / "loss.json") as f:
        again = json.load(f)["loss"]
    assert len(again) == 3 and again[:2] == rows[:2]
    assert again[2]["loss_total"] == pytest.approx(rows[2]["loss_total"], rel=1e-6)
    with open(tmp_path / "ckpt_meta.json") as f:
        assert json.load(f) == {"epochs_completed": 3}
    assert fresh.state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4 * 0.9**3)
    assert all(torch.equal(v, fresh.net.state_dict()[k])
               for k, v in first.net.state_dict().items())


def test_resume_without_a_checkpoint_starts_from_scratch(tmp_path, capsys):
    cfg = UPFlowTrainConfig(batch_size=4, bfloat16=False, exp_dir=str(tmp_path), model=TINY)
    tr = UPFlowTrainer(cfg, device="cpu")
    hist = tr.fit(_textured_pairs(4, 64, seed=7), epochs=1, resume=True, log_every=0)
    out = capsys.readouterr().out
    assert "No checkpoint" in out and "starting from epoch 0" in out
    assert len(hist) == 1 and tr.state.step == 1


def test_checkpoint_round_trip_and_foreign_files(tmp_path):
    cfg = UPFlowTrainConfig(batch_size=4, bfloat16=False, exp_dir=str(tmp_path), model=TINY)
    pairs = _textured_pairs(4, 64, seed=8)
    tr = UPFlowTrainer(cfg, device="cpu")
    tr.fit(pairs, epochs=1, log_every=0)
    other = UPFlowTrainer(dataclasses.replace(cfg, seed=5), device="cpu")
    other.init_state()
    assert other.load_checkpoint() and other.state.step == 1
    assert all(torch.equal(v, other.net.state_dict()[k]) for k, v in tr.net.state_dict().items())
    a, b = tr.predict(pairs)[1]["flow_f"], other.predict(pairs)[1]["flow_f"]
    assert torch.equal(a, b)
    os.remove(tr.checkpoint_path())
    os.makedirs(tr.checkpoint_path())  # an Orbax directory of the JAX package
    with pytest.raises(IsADirectoryError, match="Orbax"):
        other.load_checkpoint()


def test_stop_file_ends_the_run_after_its_epoch_and_a_stale_one_is_removed(tmp_path, monkeypatch):
    cfg = UPFlowTrainConfig(batch_size=4, bfloat16=False, exp_dir=str(tmp_path), model=TINY,
                            ckpt_every=10)
    (tmp_path / "STOP").write_text("")  # stale: must not end the new run
    tr = UPFlowTrainer(cfg, device="cpu")
    real_append = tr._append_loss_json

    def append_and_ask_to_stop(parts):
        real_append(parts)
        with open(tmp_path / "loss.json") as f:
            if len(json.load(f)["loss"]) == 2:
                (tmp_path / "STOP").write_text("")

    monkeypatch.setattr(tr, "_append_loss_json", append_and_ask_to_stop)
    hist = tr.fit(_textured_pairs(4, 64, seed=9), epochs=5, log_every=0)
    assert len(hist) == 2
    with open(tmp_path / "ckpt_meta.json") as f:  # saved though ckpt_every is 10
        assert json.load(f) == {"epochs_completed": 2}
    assert os.path.isfile(tr.checkpoint_path())


def test_what_waits_raises_with_its_roadmap_item(tmp_path):
    """``n_data`` above 1 trains data-parallel only over a process group of
    that size; without one it raises and says how to launch."""
    cfg = UPFlowTrainConfig(exp_dir=str(tmp_path), model=TINY)
    with pytest.raises(RuntimeError, match=r"none is initialised: launch with `torchrun"):
        UPFlowTrainer(dataclasses.replace(cfg, n_data=2), device="cpu")


def test_trainer_and_verbs_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UPFlowTrainer(UPFlowTrainConfig(exp_dir=str(tmp_path), model=TINY))
    for verb in ("train_upflow", "test_upflow"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli([verb, "--dataset", "rectangle2d", "--data_dir", str(tmp_path)])


# -- the CLI verbs -------------------------------------------------------------------------


def test_cli_train_upflow_then_test_upflow(tmp_path, capsys):
    """``train_upflow --cpu`` (one epoch, resumed for a second, SGU and census
    on) then ``test_upflow --cpu`` on a small written ``rectangle2d.pkl``, at
    the full width the flags build: ``loss.json`` with ``val_epe``, the
    checkpoint and the report with its EPE beside the zero-flow baseline."""
    data = tmp_path / "d"
    data.mkdir()
    frames = rectangle_2d(n_frames=24, grid=(64, 64), box=(20, 24), seed=1)
    with open(data / "rectangle2d.pkl", "wb") as f:
        pickle.dump(frames, f, protocol=4)
    common = ["--dataset", "rectangle2d", "--data_dir", str(data), "--results_dir",
              str(tmp_path / "r"), "--cpu"]
    train = ["train_upflow", "--epochs", "1", "--batch_size", "8", "--sgu", "--census_weight",
             "1.0", "--smooth1_weight", "0.1", "--lr", "1e-3", "--grad_clip", "1.0", *common]
    cli(train)
    cli(train + ["--resume"])
    run = tmp_path / "r" / "rectangle2d" / "upflow"
    with open(run / "loss.json") as f:
        rows = json.load(f)["loss"]
    assert len(rows) == 2 and all(np.isfinite(v) for row in rows for v in row.values())
    assert rows[0]["census_loss"] > 0 and "val_epe" in rows[0] and "val_epe_zero_flow" in rows[0]
    with open(run / "ckpt_meta.json") as f:
        assert json.load(f) == {"epochs_completed": 2}
    assert (run / "upflow.ckpt").is_file()
    out = capsys.readouterr().out
    assert '"final"' in out and "val_epe" in out

    # test_upflow builds the default model: a checkpoint trained with --sgu does not fit it
    with pytest.raises(RuntimeError, match="sgi_model"):
        cli(["test_upflow", *common])
    cli(["train_upflow", "--epochs", "1", "--batch_size", "8", "--exp_name", "ab", *common])
    assert (tmp_path / "r" / "rectangle2d" / "upflow_ab" / "upflow.ckpt").is_file()
    os.replace(tmp_path / "r" / "rectangle2d" / "upflow_ab" / "upflow.ckpt", run / "upflow.ckpt")
    capsys.readouterr()
    cli(["test_upflow", "--max_frames", "4", *common])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(run / "test_report.json") as f:
        assert json.load(f) == report
    assert set(report["scivis"]) == {"mean_flow_mag", "frames", "epe", "epe_zero_flow_baseline"}
    assert report["scivis"]["frames"] == 4
    assert all(np.isfinite(v) for v in report["scivis"].values())
