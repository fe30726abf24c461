"""PyTorch port: the training runtime against the JAX package, and the twins
of ``tests/test_training.py``'s cases.

Narrow model (blocks (16, 12, 8), teacher 8) on 32x32 ``rectangle2d`` tuples,
batch 8, float32, on the CPU.  The parity cases warp unbounded on both sides
(``fast_warp_r=0``): on the CPU the JAX model never bounds its warps.
Tolerances are stated at each comparison.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from opticalflowscivis_tpu.data.pipeline import TupleDataset as JaxTupleDataset
from opticalflowscivis_tpu.training import TrainConfig as JaxTrainConfig
from opticalflowscivis_tpu.training import build_model as jax_build_model
from opticalflowscivis_tpu.training import make_train_step as jax_make_train_step
from opticalflowscivis_tpu.training import warmup_cosine as jax_warmup_cosine
from opticalflowscivis_tpu_torch.bridge import ifnet_params_from_flax
from opticalflowscivis_tpu_torch.data import (
    TupleDataset,
    device_flip_augment,
    flip_augment,
    group_tuples,
    rectangle_2d,
)
from opticalflowscivis_tpu_torch.losses import RIFELossWeights
from opticalflowscivis_tpu_torch.training import (
    ModelConfig,
    OptimConfig,
    TrainConfig,
    Trainer,
    build_model,
    make_train_step,
    warmup_cosine,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small torch ops; with several test workers on one
    machine the intra-op thread pools oversubscribe the cores and such loops
    slow down a hundredfold.  One thread per worker is the fastest setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    cfg = TrainConfig(
        dataset="rectangle2d", epochs=3, batch_size=8,
        model=ModelConfig(block_channels=(16, 12, 8), teacher_channels=8, bfloat16=False),
        loss=RIFELossWeights.preset_2d(flow_supervised=True),
        data_dir=str(tmp / "data"), log_dir=str(tmp / "log"), results_dir=str(tmp / "res"),
        optim=OptimConfig(lr_max=1e-3, warmup_steps=5),
    )
    tuples = group_tuples(rectangle_2d(n_frames=99, grid=(32, 32), box=(10, 14), seed=5), 1)
    return cfg, tuples


def _in_dir(cfg, tmp_path):
    return dataclasses.replace(cfg, log_dir=str(tmp_path / "log"),
                               results_dir=str(tmp_path / "res"))


def _params_equal(a: Trainer, b: Trainer, atol):
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=atol, err_msg=name)


# -- schedule -------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"lr_max": 3e-4, "lr_min": 3e-6, "warmup_steps": 2000, "total_steps": 100_000},
    {"lr_max": 1e-3, "lr_min": 1e-5, "warmup_steps": 5, "total_steps": 9, "world_scale": 2.0},
    {"lr_max": 1e-3, "lr_min": 1e-5, "warmup_steps": 0, "total_steps": 1},
])
def test_warmup_cosine_matches_jax(kw):
    """rtol 1e-6: the JAX schedule computes in float32, this one in Python floats."""
    ours, theirs = warmup_cosine(**kw), jax_warmup_cosine(**kw)
    w, t = kw["warmup_steps"], kw["total_steps"]
    for step in (0, 1, w - 1, w, w + 1, (w + t) // 2, t, t + 1, 3 * t):
        if step < 0:
            continue
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6, abs=1e-12), step
    assert ours(0) == (0.0 if w else kw["lr_max"] * kw.get("world_scale", 1.0))
    assert ours(3 * t) == pytest.approx(kw["lr_min"] * kw.get("world_scale", 1.0))


# -- three optimizer steps against optax --------------------------------------------


def _numpy_params(jnet, seed):
    """Params of ``jnet`` drawn with numpy on its abstract shapes (no init)."""
    x = jax.ShapeDtypeStruct((1, 32, 32, 1), jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, x, x)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "slope" in name:
            return rng.uniform(0.1, 0.4, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("grad_clip", [0.0, 0.5], ids=["noclip", "clip"])
def test_three_train_steps_match_optax(tiny_setup, grad_clip):
    """Three updates from bridged weights: the first runs at lr 0 in both (the
    schedule is read at the count before the update), so only three steps
    compare two real updates.

    The frames get a random texture on top of the moving box: on the box
    data's exactly flat background the photometric term compares zero with
    zero, and ``(x² + ε²)^0.25`` with ε = 1e-9 turns a float32 rounding of
    1e-8 in ``x`` into a gradient of order 1e3, so there both packages'
    gradients follow their own rounding (a property of the reference's loss,
    not of either implementation).

    ``parts`` each step: rtol 2e-5 (float32 convolutions in other orders).
    Parameters after step 3: atol 1e-5, against a total movement of up to
    6e-4 per element (Adam moves each element by about lr per step; lr is 0,
    2e-4, 4e-4), i.e. 2 % of the movement.  With clipping the same: torch's
    ``clip_grad_norm_`` divides by norm + 1e-6 where optax divides by the
    norm, a relative 1e-6 / norm on every gradient, which Adam's
    normalization then cancels.
    """
    cfg, tuples = tiny_setup
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, fast_warp_r=0),
        optim=dataclasses.replace(cfg.optim, grad_clip=grad_clip),
    )
    total_steps = 9
    jcfg = JaxTrainConfig.from_json(cfg.to_json())  # the port's json loads there
    jmodel = jax_build_model(jcfg)
    params = _numpy_params(jmodel, seed=3)
    o = jcfg.optim
    tx = optax.adamw(jax_warmup_cosine(o.lr_max, o.lr_min, o.warmup_steps, total_steps,
                                       o.world_scale), weight_decay=o.weight_decay)
    if grad_clip:
        tx = optax.chain(optax.clip_by_global_norm(grad_clip), tx)
    jstate = train_state.TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx)
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg, has_flow=True)[0])

    tr = Trainer(cfg, device="cpu")
    tr.model.load_state_dict(ifnet_params_from_flax(params), strict=True)
    state = tr.init_state(total_steps)
    step, _ = make_train_step(tr.model, cfg, has_flow=True)

    textured = tuples[:24].copy()
    textured[..., 0] += np.random.default_rng(0).uniform(0.05, 0.3, textured.shape[:-1]).astype(
        np.float32)
    lrs = []
    for i in range(3):
        batch = textured[8 * i : 8 * i + 8]
        lrs.append(state.optimizer.param_groups[0]["lr"])
        parts = step(state, torch.from_numpy(batch))
        jstate, jparts = jstep(jstate, jnp.asarray(batch))
        assert set(parts) == set(jparts)
        for key, ref in jparts.items():
            assert float(parts[key]) == pytest.approx(float(ref), rel=2e-5, abs=1e-9), (i, key)
    assert lrs == pytest.approx([0.0, 2e-4, 4e-4])
    assert state.step == int(jstate.step) == 3

    ref_state = ifnet_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    start = ifnet_params_from_flax(params)
    moved = 0.0
    for name, value in tr.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref_state[name].numpy(), atol=1e-5,
                                   err_msg=name)
        moved = max(moved, float((value - start[name]).abs().max()))
    assert 1e-4 < moved < 1e-3  # the updates are there, and of the expected size


# -- twins of tests/test_training.py ------------------------------------------------


def test_fit_decreases_loss_writes_loss_json_and_checkpoints(tiny_setup, tmp_path):
    cfg, tuples = tiny_setup
    tr = Trainer(_in_dir(cfg, tmp_path), device="cpu")
    hist = tr.fit(tuples[:24], tuples[24:32], epochs=3, log_every=0)
    assert len(hist) == 3 and tr.steps_per_epoch == 3
    assert hist[-1]["loss_G"] < hist[0]["loss_G"]
    assert np.isfinite(hist[-1]["loss_G"])

    # loss.json: one 7-tuple per epoch, (G, l1, tea, distill, reg, photo, flow)
    with open(os.path.join(tr.results_dir, "loss.json")) as f:
        data = json.load(f)
    assert len(data["val_loss"]) == 3 and len(data["val_loss"][0]) == 7
    keys = ["loss_G", "loss_l1", "loss_tea", "loss_distill", "l1_reg", "loss_photo", "loss_flow"]
    assert data["val_loss"][-1] == [hist[-1][k] for k in keys]
    assert tr._completed_epochs() == 3
    assert tr.results_dir.endswith(os.path.join("rectangle2d", "2x", "flownet"))

    # checkpoint round trip: step, parameters and optimizer state come back
    assert tr.state.step == 9
    kept = {k: v.clone() for k, v in tr.model.state_dict().items()}
    kept_opt = [{k: torch.as_tensor(v).clone() for k, v in s.items()}
                for s in tr.state.optimizer.state_dict()["state"].values()]
    lr = tr.state.optimizer.param_groups[0]["lr"]
    with torch.no_grad():
        for p in tr.model.parameters():
            p.add_(1.0)
    for s in tr.state.optimizer.state.values():
        s["exp_avg"].zero_()
    tr.state.step = 0
    tr.state.scheduler.step()
    assert tr.load_checkpoint()
    assert tr.state.step == 9 and tr.state.optimizer.param_groups[0]["lr"] == lr
    assert tr.state.scheduler.last_epoch == 9
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, kept[k]), k
    for s, ref in zip(tr.state.optimizer.state_dict()["state"].values(), kept_opt):
        assert ref["exp_avg"].abs().sum() > 0
        for k in ref:
            assert torch.equal(torch.as_tensor(s[k]), ref[k]), k

    # a fresh trainer restores it and evaluates the same
    fresh = Trainer(_in_dir(cfg, tmp_path), device="cpu")
    fresh.init_state(total_steps=9)
    assert fresh.load_checkpoint()
    assert fresh.evaluate(tuples[24:32], 8) == tr.evaluate(tuples[24:32], 8)

    # eval-mode predict returns extras
    parts, extras = tr.predict(tuples[:8])
    assert extras["pred"].shape == (8, 32, 32, 1)
    assert extras["flow"].shape == (8, 32, 32, 4)
    assert extras["mask"].shape == (8, 32, 32, 1) and extras["pred_tea"].shape == (8, 32, 32, 1)
    assert np.isfinite(float(parts["loss_G"]))


def test_resume_continues_the_run(tiny_setup, tmp_path):
    cfg, tuples = tiny_setup
    cfg = _in_dir(cfg, tmp_path)
    first = Trainer(cfg, device="cpu")
    first.fit(tuples[:24], tuples[24:32], epochs=1, log_every=0)
    again = Trainer(cfg, device="cpu")
    again.fit(tuples[:24], tuples[24:32], epochs=1, log_every=0, resume=True)
    assert again.state.step == 6 and again._completed_epochs() == 2
    scratch = Trainer(_in_dir(cfg, tmp_path / "other"), device="cpu")
    scratch.init_state(total_steps=3)
    assert not scratch.load_checkpoint()  # nothing there: says so, keeps the fresh state


def test_checkpoint_refuses_an_orbax_directory(tiny_setup, tmp_path):
    cfg, _ = tiny_setup
    tr = Trainer(_in_dir(cfg, tmp_path), device="cpu")
    tr.init_state(total_steps=3)
    os.makedirs(tr.checkpoint_path())
    with pytest.raises(IsADirectoryError, match="Orbax"):
        tr.load_checkpoint()
    with pytest.raises(IsADirectoryError, match="Orbax"):
        tr.save_checkpoint()


def test_resident_path_matches_streaming(tiny_setup, tmp_path):
    """The device-resident dataset (bulk upload + per-step index gather) gives
    the streaming path's run: same shuffle stream, same batches, same updates
    (identical arithmetic on the CPU, so 1e-6 is generous)."""
    cfg, tuples = tiny_setup
    tr_res = Trainer(_in_dir(cfg, tmp_path / "a"), device="cpu")
    tr_str = Trainer(dataclasses.replace(_in_dir(cfg, tmp_path / "b"), hbm_dataset_gb=0.0),
                     device="cpu")
    h1 = tr_res.fit(tuples[:24], tuples[24:32], epochs=2, log_every=0)
    h2 = tr_str.fit(tuples[:24], tuples[24:32], epochs=2, log_every=0)
    np.testing.assert_allclose(h1[-1]["loss_G"], h2[-1]["loss_G"], rtol=1e-6)
    _params_equal(tr_res, tr_str, atol=1e-6)


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "streaming_fallback"])
def test_device_flip_aug_matches_host_flip(tiny_setup, tmp_path, resident):
    """Training over the virtual 4x index space with on-device flips (or, when
    the dataset does not stay resident, the materialized fallback) equals
    training on the host-flip-augmented array."""
    cfg, tuples = tiny_setup
    gb = 6.0 if resident else 0.0
    base = tuples[:8]
    hosted = flip_augment(base.reshape((-1,) + base.shape[2:])).reshape((-1,) + base.shape[1:])
    tr_dev = Trainer(dataclasses.replace(_in_dir(cfg, tmp_path / "a"), device_flip_aug=True,
                                         hbm_dataset_gb=gb), device="cpu")
    tr_host = Trainer(dataclasses.replace(_in_dir(cfg, tmp_path / "b"), hbm_dataset_gb=gb),
                      device="cpu")
    h1 = tr_dev.fit(base, tuples[24:32], epochs=1, log_every=0)
    h2 = tr_host.fit(hosted, tuples[24:32], epochs=1, log_every=0)
    assert tr_dev.steps_per_epoch == tr_host.steps_per_epoch == 4
    np.testing.assert_allclose(h1[-1]["loss_G"], h2[-1]["loss_G"], rtol=1e-6)
    _params_equal(tr_dev, tr_host, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_flip_augment_equals_host_order(tiny_setup, dtype):
    _, tuples = tiny_setup
    base = tuples[:5]
    hosted = flip_augment(base.reshape((-1,) + base.shape[2:])).reshape((-1,) + base.shape[1:])
    idx = torch.arange(4 * 5)
    out = device_flip_augment(torch.from_numpy(base).to(dtype)[idx % 5], idx // 5, ndim=2)
    assert out.dtype == dtype
    assert torch.equal(out, torch.from_numpy(hosted).to(dtype))
    no_flow = device_flip_augment(torch.from_numpy(base[..., :1])[idx % 5], idx // 5, ndim=2)
    assert torch.equal(no_flow, torch.from_numpy(hosted[..., :1]))


def test_tuple_dataset_shuffle_stream_equals_the_jax_package(tiny_setup):
    _, tuples = tiny_setup
    ours, theirs = TupleDataset(tuples, 8, seed=7), JaxTupleDataset(tuples, 8, seed=7)
    assert len(ours) == len(theirs) == 4
    for _ in range(2):
        for a, b in zip(ours.epoch(), theirs.epoch()):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.epoch_indices(n_virtual=4 * 33), theirs.epoch_indices(n_virtual=4 * 33)):
        np.testing.assert_array_equal(a, b)


def test_empty_val_split_falls_back_to_train_batch(tiny_setup, tmp_path):
    cfg, tuples = tiny_setup
    tr = Trainer(_in_dir(cfg, tmp_path), device="cpu")
    hist = tr.fit(tuples[:16], tuples[:0], epochs=1, log_every=0)
    assert hist and np.isfinite(hist[-1]["loss_G"])


def test_keep_best_and_early_stop(tiny_setup, tmp_path):
    """With lr 0 the validation loss never improves after the first epoch:
    the run stops once the patience is used up and keeps the first checkpoint."""
    cfg, tuples = tiny_setup
    cfg = dataclasses.replace(_in_dir(cfg, tmp_path), keep_best_only=True, early_stop_patience=2,
                              optim=OptimConfig(lr_max=0.0, lr_min=0.0, warmup_steps=0))
    tr = Trainer(cfg, device="cpu")
    seen = []
    hist = tr.fit(tuples[:8], tuples[24:32], epochs=6, log_every=0,
                  on_epoch_end=lambda epoch, parts: seen.append(epoch))
    assert len(hist) == 3 and seen == [0, 1]
    assert torch.load(tr.checkpoint_path(), weights_only=True)["step"] == 1


def test_gt_flow_scale_threads_into_supervision(tiny_setup):
    cfg, tuples = tiny_setup
    model = build_model(cfg, device="cpu")
    batch = torch.from_numpy(tuples[:2])

    def eval_parts(scale):
        _, ev = make_train_step(model, cfg, has_flow=True, gt_flow_scale=scale)
        return ev(None, batch)[0]

    p1, p10 = eval_parts(1.0), eval_parts(10.0)
    assert float(p10["loss_flow"]) != float(p1["loss_flow"])
    np.testing.assert_allclose(float(p10["loss_l1"]), float(p1["loss_l1"]), rtol=1e-6)
    _, no_flow = make_train_step(model, cfg, has_flow=False)
    assert float(no_flow(None, batch)[0]["loss_flow"]) == 0


def test_evaluate_covers_tail_batch(tiny_setup):
    """n_val not divisible by the batch: the tail samples contribute."""
    cfg, tuples = tiny_setup
    tr = Trainer(cfg, device="cpu")
    tr.init_state(total_steps=4)
    val = tuples[:12].copy()  # 8 + 4 tail with batch 8 (4 | 8: cycle-pad exact)
    full = tr.evaluate(val, 8)
    head_only = tr.evaluate(val[:8], 8)
    tail_only = tr.evaluate(val[8:], 8)
    for k in full:
        np.testing.assert_allclose(full[k], (8 * head_only[k] + 4 * tail_only[k]) / 12,
                                   rtol=1e-4, err_msg=k)
    assert any(not np.isclose(full[k], head_only[k], rtol=1e-6) for k in full)
    on_device = tr.evaluate(torch.from_numpy(val), 8)  # a tensor already on the device
    assert on_device == full


# -- config ---------------------------------------------------------------------


def test_train_config_json_round_trip_and_jax_json_loads(tiny_setup):
    cfg, _ = tiny_setup
    assert TrainConfig.from_json(cfg.to_json()) == cfg
    theirs = JaxTrainConfig(dataset="rectangle2d", batch_size=64, n_data=1)
    ours = TrainConfig.from_json(theirs.to_json())
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JaxTrainConfig())
    back = JaxTrainConfig.from_json(cfg.to_json())
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("kw, error, match", [
    ({"n_space": 2}, NotImplementedError, r"A\.12b"),
    ({"spatial_shard": True}, NotImplementedError, r"A\.12b"),
    ({"compiler_options": {"xla_flag": "1"}}, ValueError, "XLA overrides"),
    ({"hbm_dataset_dtype": "float16"}, ValueError, "hbm_dataset_dtype"),
    ({"dataset": "rectangle3d"}, ValueError, "ndim"),
    ({"model": ModelConfig.preset_3d()}, ValueError, "ndim"),
])
def test_trainer_refuses_what_is_not_ported(kw, error, match):
    with pytest.raises(error, match=match):
        Trainer(TrainConfig(**kw), device="cpu")


@pytest.mark.parametrize("kw", [{"remat": True}, {"teacher_scale": 2, "scales": (4, 2, 2)},
                                {"conv0_kernel": 4}],
                         ids=["remat", "teacher_scale", "conv0_kernel"])
def test_model_options_of_the_3d_recipe_also_build_in_2d(tiny_setup, kw):
    """``remat``, ``teacher_scale`` and ``conv0_kernel`` reach the model from
    the config; a train step runs with each and moves the parameters."""
    cfg, tuples = tiny_setup
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **kw))
    tr = Trainer(cfg, device="cpu")
    for name, value in kw.items():
        if name == "conv0_kernel":
            assert tr.model.block0.conv0[0].conv.kernel_size == (4, 4)
            assert tr.model.block0.convblock[0].convs[0].conv.kernel_size == (3, 3)
        else:
            assert getattr(tr.model, name) == value
    tr.init_state(total_steps=4)
    batch = tr.upload(tuples[:4])
    tr.train_step(batch)  # the first update runs at lr 0
    before = [p.detach().clone() for p in tr.model.parameters()]
    parts = tr.train_step(batch)
    assert np.isfinite(float(parts["loss_G"]))
    assert any(not torch.equal(p, q) for p, q in zip(tr.model.parameters(), before))


def test_bfloat16_compute_keeps_float32_parameters(tiny_setup, tmp_path):
    cfg, tuples = tiny_setup
    cfg = dataclasses.replace(_in_dir(cfg, tmp_path),
                              model=dataclasses.replace(cfg.model, bfloat16=True))
    tr = Trainer(cfg, device="cpu")
    hist = tr.fit(tuples[:8], tuples[24:32], epochs=1, log_every=0)
    assert np.isfinite(hist[-1]["loss_G"])
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    assert all(s["exp_avg"].dtype == torch.float32 for s in tr.state.optimizer.state.values())
    _, extras = tr.predict(tuples[:2])
    assert extras["pred"].dtype == torch.bfloat16
