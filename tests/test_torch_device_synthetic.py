"""PyTorch port: the on-device generators and ``fit_device_gen`` against the
JAX package, the twins of ``tests/test_device_synthetic.py``.

The device functions run here on CPU tensors.  They are held bit for bit
against the reference's (``jax.vmap`` of ``dynamic_update_slice`` /
``dynamic_slice``, corners out of range included) and against the numpy
generators; one epoch of each ``fit_device_gen`` takes bit for bit the steps
of ``train_step`` driven by hand on the numpy generator's batches.  The
reference's ``test_fit_device_gen_scan_chunk_equivalence`` has no twin: the
port has no epoch scan.  Its ``test_fit_hbm_stop_resume_continues_epochs`` is
covered by ``tests/test_torch_upflow_training.py::
test_resume_continues_from_the_last_saved_epoch_and_truncates_loss_json``.
"""

import dataclasses
import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowscivis_tpu.data import device_synthetic as jds
from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
from opticalflowscivis_tpu_torch.data import device_synthetic as tds
from opticalflowscivis_tpu_torch.data import group_tuples, rectangle_2d, rectangle_3d, rectangles_2d
from opticalflowscivis_tpu_torch.data.synthetic import _box_trajectory
from opticalflowscivis_tpu_torch.losses import RIFELossWeights, UPFlowLossConfig
from opticalflowscivis_tpu_torch.models import UPFlowConfig
from opticalflowscivis_tpu_torch.scripts import train256
from opticalflowscivis_tpu_torch.training import (
    ModelConfig,
    OptimConfig,
    TrainConfig,
    Trainer,
    UPFlowTrainConfig,
    UPFlowTrainer,
    frames_to_pairs,
)

GRID3, BOX3 = (8, 10, 12), (2, 3, 4)
GRID2, BOX2 = (64, 64), (20, 24)
# the UPFlow widths of tests/test_torch_upflow_training.py
TINY = UPFlowConfig(num_chs=(3, 4, 8, 8, 12, 16, 16), estimator_f_channels=(16, 16, 12, 8, 8),
                    context_f_channels=(16, 16, 16, 12, 8, 8, 2), search_range=2,
                    if_norm_before_cost_volume=True, norm_moments_across_channels=False,
                    norm_moments_across_images=False)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- the generators ----------------------------------------------------------------------


def test_box_density_matches_numpy_generator_and_the_reference():
    # rectangle_3d(with_flow=False) draws only the trajectory, so a fresh rng
    # with its seed gives its positions
    arr = rectangle_3d(n_frames=9, grid=GRID3, box=BOX3, seed=3, with_flow=False)
    pos = _box_trajectory(np.random.default_rng(3), 9, GRID3, BOX3, vel_max=8,
                          max_seq=10)[:9].astype(np.int32)
    dev = tds.box_density_device(_t(pos), GRID3, BOX3)
    assert dev.dtype == torch.float32 and dev.shape == (9,) + GRID3 + (1,)
    np.testing.assert_array_equal(dev.numpy(), arr)
    # leading axes broadcast; corners on and past the edges
    edges = np.array([[[0, 0, 0], [6, 7, 8]], [[-1, 9, 11], [8, -3, 20]]], np.int32)
    np.testing.assert_array_equal(
        tds.box_density_device(_t(edges), GRID3, BOX3).numpy(),
        np.asarray(jds.box_density_device(jnp.asarray(edges), GRID3, BOX3)))


def test_tuple_positions_match_group_tuples_order():
    n = 4
    arr = rectangle_3d(n_frames=3 * n, grid=GRID3, box=BOX3, seed=5, with_flow=False)
    pos = tds.tuple_positions(np.random.default_rng(5), n, GRID3, BOX3)
    assert pos.dtype == np.int32 and pos.shape == (n, 3, 3)
    np.testing.assert_array_equal(pos, jds.tuple_positions(np.random.default_rng(5), n,
                                                           GRID3, BOX3))
    np.testing.assert_array_equal(tds.box_density_device(_t(pos), GRID3, BOX3).numpy(),
                                  group_tuples(arr, 1))


# box and camera corners on and past the edges, negative ones included: JAX
# counts a negative start from the end, then clamps it into range
EDGE_BOX = np.array([[[0, 0], [44, 40]], [[-5, 70], [100, -3]], [[-64, 63], [-1, -30]]],
                    np.int32)
EDGE_CAM = np.array([[[0, 96], [96, 0]], [[-5, 200], [97, -1]], [[-160, 5], [-97, 300]]],
                    np.int32)


@pytest.mark.parametrize("in_channels", [1, 3])
def test_pan_pairs_match_rectangle_2d_pan_and_the_reference(in_channels):
    n = 7
    arr = rectangle_2d(n_frames=n, grid=GRID2, box=BOX2, seed=9, background="pan",
                       pan_vel_max=3)
    scene = tds.pan_scene_host(np.random.default_rng(9), n, GRID2, BOX2, pan_vel_max=3)
    for got, want in zip(scene, jds.pan_scene_host(np.random.default_rng(9), n, GRID2, BOX2,
                                                   pan_vel_max=3)):
        np.testing.assert_array_equal(got, want)
    tex, big, bt, ct = scene
    bp, cp = tds.pan_pair_positions(bt, ct, np.arange(n - 1))
    im1, im2, flow = (x.numpy() for x in tds.pan_pairs_device(
        _t(tex), _t(big), _t(bp), _t(cp), GRID2, in_channels))
    assert im1.shape == (n - 1,) + GRID2 + (in_channels,) and flow.shape == (n - 1,) + GRID2 + (2,)
    for c in range(in_channels):
        np.testing.assert_array_equal(im1[..., c], arr[:-1, ..., 0])
        np.testing.assert_array_equal(im2[..., c], arr[1:, ..., 0])
    np.testing.assert_array_equal(flow, arr[:-1, ..., 1:])
    # the flow's sign: the box's step on the box, the negated camera step elsewhere
    y0, x0 = bt[0]
    np.testing.assert_array_equal(flow[0, y0, x0], bt[1] - bt[0])
    background = np.ones(GRID2, bool)
    background[y0 : y0 + BOX2[0], x0 : x0 + BOX2[1]] = False
    assert (flow[0][background] == -(ct[1] - ct[0])).all()

    bp, cp = np.concatenate([bp, EDGE_BOX]), np.concatenate([cp, EDGE_CAM])
    got = tds.pan_pairs_device(_t(tex), _t(big), _t(bp), _t(cp), GRID2, in_channels)
    want = jds.pan_pairs_device(jnp.asarray(tex), jnp.asarray(big), jnp.asarray(bp),
                                jnp.asarray(cp), GRID2, in_channels)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_multibox_pan_pairs_match_rectangles_2d_and_the_reference():
    """Boxes that overlap: the later box overwrites pixels and flow."""
    boxes = ((20, 24), (14, 12))
    n = 7
    ref = rectangles_2d(n_frames=n, grid=GRID2, boxes=boxes, vel_max=4, max_seq=15, seed=5,
                        background="pan", pan_vel_max=6)
    scene = tds.multibox_pan_scene_host(np.random.default_rng(5), n, GRID2, boxes, vel_max=4,
                                        max_seq=15, pan_vel_max=6)
    jscene = jds.multibox_pan_scene_host(np.random.default_rng(5), n, GRID2, boxes, vel_max=4,
                                         max_seq=15, pan_vel_max=6)
    for got, want in zip(scene[0] + list(scene[1:]), jscene[0] + list(jscene[1:])):
        np.testing.assert_array_equal(got, want)
    texs, big, bts, ct = scene
    bp, cp = tds.multibox_pan_pair_positions(bts, ct, np.arange(n - 1))
    np.testing.assert_array_equal(bp, jds.multibox_pan_pair_positions(bts, ct,
                                                                      np.arange(n - 1))[0])
    im1, im2, flow = (x.numpy() for x in tds.multibox_pan_pairs_device(
        [_t(t) for t in texs], _t(big), _t(bp), _t(cp), GRID2))
    np.testing.assert_array_equal(im1[..., 0], ref[:-1, ..., 0])
    np.testing.assert_array_equal(im2[..., 0], ref[1:, ..., 0])
    np.testing.assert_array_equal(flow, ref[:-1, ..., 1:])

    # both boxes at one corner: box 1 lies on box 0 and its step wins there
    stacked = np.array([[[[10, 10], [12, 13]], [[10, 10], [9, 8]]]], np.int32)
    bp = np.concatenate([bp, stacked, np.stack([EDGE_BOX, EDGE_BOX[::-1]], axis=1)])
    cp = np.concatenate([cp, EDGE_CAM[:1], EDGE_CAM])
    got = tds.multibox_pan_pairs_device([_t(t) for t in texs], _t(big), _t(bp), _t(cp), GRID2, 3)
    want = jds.multibox_pan_pairs_device([jnp.asarray(t) for t in texs], jnp.asarray(big),
                                         jnp.asarray(bp), jnp.asarray(cp), GRID2, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[2][n - 1, 10, 10] == torch.tensor([-1.0, -2.0])).all()


def test_train256_held_out_tuples_are_the_references_seed7_positions():
    grid, box = (16, 16, 16), (4, 4, 4)
    val_pos = jds.tuple_positions(np.random.default_rng(7), 3, grid, box)
    # the reference's eval_only / device_gen stamping (scripts/train256.py)
    want = np.zeros((3, 3) + grid + (1,), np.float32)
    for i in range(3):
        for s in range(3):
            want[(i, s) + tuple(slice(p, p + b) for p, b in zip(val_pos[i, s], box)) + (0,)] = 1
    np.testing.assert_array_equal(train256.held_out_tuples(val_pos, grid, box), want)


# -- fit_device_gen ---------------------------------------------------------------------


def _rife_cfg(tmp_path, **kw):
    model = ModelConfig(ndim=3, block_channels=(8, 8, 8), teacher_channels=8, conv0_kernel=4,
                        bounded_warp_rz=4, fast_warp_r=4, bfloat16=False)
    return TrainConfig(**dict(
        dataset="rectangle3d", batch_size=4, epochs=2, model=model,
        loss=RIFELossWeights.preset_3d(), pad_multiple=16,
        optim=OptimConfig(lr_max=1e-3, warmup_steps=2), data_dir=str(tmp_path / "d"),
        log_dir=str(tmp_path / "log"), results_dir=str(tmp_path / "res")) | kw)


G16, B16 = (16, 16, 16), (4, 4, 4)


def _box_gen(pos):
    return tds.box_density_device(pos, G16, B16)


def test_fit_device_gen_trains_on_fresh_tuples_and_resume_offsets_the_seed(tmp_path):
    cfg = _rife_cfg(tmp_path)
    seen = []

    def pos_sampler(epoch):
        seen.append(epoch)
        return tds.tuple_positions(np.random.default_rng(100 + epoch), 4, G16, B16, vel_max=3)

    val_pos = tds.tuple_positions(np.random.default_rng(7), 4, G16, B16)
    tr = Trainer(cfg, device="cpu")
    hist = tr.fit_device_gen(_box_gen, pos_sampler, val_pos, steps_per_epoch=1, log_every=1)
    assert len(hist) == 2 and np.isfinite(hist[-1]["loss_G"])
    assert seen == [0, 1]  # a fresh trajectory every epoch
    assert os.path.exists(os.path.join(tr.results_dir, "loss.json"))

    # resume does not replay epochs 0 and 1: it starts at the epoch count of
    # loss.json, so the sampler sees fresh epoch numbers
    seen.clear()
    tr2 = Trainer(cfg, device="cpu")
    hist2 = tr2.fit_device_gen(_box_gen, pos_sampler, val_pos, steps_per_epoch=1, epochs=1,
                               log_every=0, resume=True)
    assert seen == [2] and len(hist2) == 1

    with pytest.raises(ValueError, match="do not divide"):
        Trainer(cfg, device="cpu").fit_device_gen(_box_gen, pos_sampler, val_pos, 3)
    with pytest.raises(ValueError, match="pad_multiple"):
        Trainer(dataclasses.replace(cfg, pad_multiple=32), device="cpu").fit_device_gen(
            _box_gen, pos_sampler, val_pos, 1)


def test_rife_fit_device_gen_epoch_equals_hand_driven_train_steps(tmp_path):
    """One epoch of 2 steps at batch 2 from the device generator, against
    ``train_step`` on ``group_tuples(rectangle_3d(...))`` of the same seed, in
    the same order: the same parameters and loss.json, bit for bit."""
    cfg = _rife_cfg(tmp_path / "gen", batch_size=2, epochs=1)
    tr = Trainer(cfg, device="cpu")
    hist = tr.fit_device_gen(
        _box_gen, lambda e: tds.tuple_positions(np.random.default_rng(30 + e), 4, G16, B16),
        tds.tuple_positions(np.random.default_rng(7), 2, G16, B16), steps_per_epoch=2,
        log_every=0)

    host = group_tuples(rectangle_3d(n_frames=12, grid=G16, box=B16, seed=30,
                                     with_flow=False), 1)
    val = group_tuples(rectangle_3d(n_frames=6, grid=G16, box=B16, seed=7, with_flow=False), 1)
    ref = Trainer(dataclasses.replace(cfg, results_dir=str(tmp_path / "ref")), device="cpu")
    ref.init_state(total_steps=2)
    for s in range(2):
        ref.train_step(ref.upload(host[2 * s : 2 * s + 2]))
    for (name, p), q in zip(tr.model.named_parameters(), ref.model.parameters()):
        assert torch.equal(p, q), name
    assert hist[0] == ref.evaluate(val, 2)


def _upflow_cfg(tmp_path, **kw):
    return UPFlowTrainConfig(**dict(
        batch_size=8, bfloat16=False, exp_dir=str(tmp_path), model=TINY, pad_multiple=64,
        loss=UPFlowLossConfig(smooth_order_1_weight=0.1)) | kw)


def _pan_sampler(record=None, n=8, seed0=100):
    def pos_sampler(epoch):
        if record is not None:
            record.append(epoch)
        tex, big, bt, ct = tds.pan_scene_host(np.random.default_rng(seed0 + epoch), n + 1,
                                              GRID2, BOX2, pan_vel_max=3)
        bp, cp = tds.pan_pair_positions(bt, ct, np.arange(n))
        return {"tex": tex, "big": big}, {"box": bp, "cam": cp}
    return pos_sampler


def _pan_gen(const, pos):
    return tds.pan_pairs_device(const["tex"], const["big"], pos["box"], pos["cam"], GRID2,
                                in_channels=3)


def test_upflow_fit_device_gen_fresh_scene_per_epoch(tmp_path):
    v = rectangle_2d(n_frames=9, grid=GRID2, box=BOX2, seed=7, background="pan", pan_vel_max=3)
    seen = []
    tr = UPFlowTrainer(_upflow_cfg(tmp_path), device="cpu")
    hist = tr.fit_device_gen(_pan_gen, _pan_sampler(seen), steps_per_epoch=1, epochs=2,
                             log_every=0, val_pairs=frames_to_pairs(v[..., :1], in_channels=3),
                             val_flow=v[:-1, ..., 1:])
    assert len(hist) == 2 and np.isfinite(hist[-1]["loss_total"])
    assert "val_epe" in hist[-1] and np.isfinite(hist[-1]["val_epe"])
    assert seen == [0, 1] and tr.state.step == 2


def test_upflow_fit_device_gen_resume_offsets_epoch_seed(tmp_path):
    first = []
    UPFlowTrainer(_upflow_cfg(tmp_path), device="cpu").fit_device_gen(
        _pan_gen, _pan_sampler(first), steps_per_epoch=1, epochs=2, log_every=0)
    assert first == [0, 1]
    resumed = []
    tr = UPFlowTrainer(_upflow_cfg(tmp_path), device="cpu")
    hist = tr.fit_device_gen(_pan_gen, _pan_sampler(resumed), steps_per_epoch=1, epochs=1,
                             log_every=0, resume=True)
    assert resumed == [2] and len(hist) == 1
    assert tr.state.step == 3  # the step count, which seeds the spatial transform, goes on
    with open(tmp_path / "ckpt_meta.json") as f:
        assert json.load(f) == {"epochs_completed": 3}


def test_fit_device_gen_failed_restore_does_not_offset(tmp_path):
    """Resume with a lost checkpoint applies no epoch offset and does not cut
    loss.json: the run starts at epoch 0, in the open."""
    stale = [{"loss_total": 1.0}, {"loss_total": 0.9}]
    (tmp_path / "loss.json").write_text(json.dumps({"loss": stale}))
    (tmp_path / "ckpt_meta.json").write_text(json.dumps({"epochs_completed": 2}))
    trained = []
    tr = UPFlowTrainer(_upflow_cfg(tmp_path), device="cpu")
    hist = tr.fit_device_gen(_pan_gen, _pan_sampler(trained), steps_per_epoch=1, epochs=1,
                             log_every=0, resume=True)
    # the probe samples the guessed epoch 2; training runs epoch 0
    assert trained == [2, 0] and len(hist) == 1
    log = json.loads((tmp_path / "loss.json").read_text())["loss"]
    assert log[:2] == stale and len(log) == 3
    assert os.path.exists(tmp_path / "upflow.ckpt")


def test_upflow_fit_device_gen_epoch_equals_hand_driven_train_steps(tmp_path):
    """One epoch of 2 steps at batch 4 from generated pan pairs, against
    ``train_step`` on ``rectangle_2d(background="pan")``'s pairs of the same
    seed, in the same order: the same parameters and loss parts, bit for bit."""
    cfg = _upflow_cfg(tmp_path / "gen", batch_size=4)
    tr = UPFlowTrainer(cfg, device="cpu")
    hist = tr.fit_device_gen(_pan_gen, _pan_sampler(n=8, seed0=40), steps_per_epoch=2,
                             epochs=1, log_every=0)
    arr = rectangle_2d(n_frames=9, grid=GRID2, box=BOX2, seed=40, background="pan",
                       pan_vel_max=3)
    pairs = frames_to_pairs(arr[..., :1], in_channels=3)
    ref = UPFlowTrainer(dataclasses.replace(cfg, exp_dir=str(tmp_path / "ref")), device="cpu")
    ref.init_state(steps_per_epoch=2)
    meter = {}
    for s in range(2):
        p = pairs[4 * s : 4 * s + 4]
        parts = ref.train_step({"im1": ref.upload(p[:, 0]), "im2": ref.upload(p[:, 1])})
        for k, v in parts.items():
            meter[k] = meter[k] + v if k in meter else v
    for (name, p), q in zip(tr.net.named_parameters(), ref.net.parameters()):
        assert torch.equal(p, q), name
    assert hist[0] == {k: float(v) / 2 for k, v in meter.items()}


# -- the CLI and train256 -----------------------------------------------------------------


@pytest.mark.parametrize("dataset", ["rectangle2d_tex_pan", "rectangles2d_tex_pan8"])
def test_cli_train_upflow_device_gen(tmp_path, dataset, capsys):
    """``train_upflow --device_gen --cpu`` at the full width the flags build:
    one step of 2 generated 128 x 128 pairs, validated on the registry's split
    of a small written series."""
    series = rectangle_2d(n_frames=12, grid=(64, 64), box=(20, 24), seed=0, background="pan")
    with open(tmp_path / f"{dataset}.pkl", "wb") as f:
        pickle.dump(series, f, protocol=4)
    cli(["train_upflow", "--cpu", "--dataset", dataset, "--device_gen", "2", "--batch_size", "2",
         "--epochs", "1", "--data_dir", str(tmp_path), "--results_dir", str(tmp_path / "r")])
    out = capsys.readouterr().out
    assert "device-gen: 2 fresh pan pairs/epoch" in out
    final = json.loads(out.strip().splitlines()[-1])["final"]
    assert np.isfinite(final["loss_total"]) and np.isfinite(final["val_epe"])
    run = tmp_path / "r" / dataset / "upflow"
    assert (run / "upflow.ckpt").is_file()
    assert json.loads((run / "ckpt_meta.json").read_text()) == {"epochs_completed": 1}


def test_cli_device_gen_needs_a_pan_dataset(tmp_path):
    with pytest.raises(SystemExit, match="requires a pan dataset"):
        cli(["train_upflow", "--cpu", "--dataset", "rectangle2d", "--device_gen", "8",
             "--data_dir", str(tmp_path)])


def test_train256_device_gen_then_eval_only(tmp_path):
    """``train256 --device_gen`` at 32^3 on the CPU, then ``--eval_only`` on
    its checkpoint: both score the seed-7 positions."""
    argv = ["--grid", "32", "--epochs", "1", "--val_tuples", "1", "--cpu", "--out", str(tmp_path)]
    report = train256.main(argv + ["--device_gen", "1"])
    assert report["device_gen"] and report["steps"] == 1
    assert report["val_set"] == "seed7_positions" and np.isfinite(report["val_psnr_model"])
    again = train256.main(argv + ["--eval_only"])
    assert again["val_set"] == "seed7_positions" and again["epochs_completed"] == 1
    assert again["val_psnr_model"] == report["val_psnr_model"]


def test_device_gen_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli(["train_upflow", "--dataset", "rectangle2d_tex_pan", "--device_gen", "8",
             "--data_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train256.main(["--grid", "32", "--device_gen", "1", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UPFlowTrainer(_upflow_cfg(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_rife_cfg(tmp_path))
