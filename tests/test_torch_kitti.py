"""PyTorch port: the KITTI data paths against the JAX package.

Twins of ``tests/test_vimeo_kitti.py``'s KITTI cases and of
``tests/test_data_io.py``'s flow-IO cases:

- the copied readers, writers and samplers (``.flo``, KITTI's uint16 PNG,
  ``KittiPairDataset``, ``KittiHBMCache``, ``PrefetchSampler``) equal the
  reference's on files written here, from fixed seeds;
- the batch that ``fit_kitti_hbm`` cuts out of the frame store on the device
  equals the reference's ``dynamic_slice`` / flip / swap semantics exactly, in
  float32 and from a bfloat16 store;
- one UPFlow train step with raw windows and ``start`` (boundary-dilated
  warping) against the reference's loss and gradients, from bridged weights;
- ``fit_kitti`` and ``fit_kitti_hbm`` for two steps on a narrow model (the
  latter's batches are ``kitti_batch``'s, the draws of ``default_rng(seed +
  2)`` cut by ``device_batch`` as the loop cut them before), and
  the CLI's ``train_upflow --dataset kitti`` (both ``--hbm_cache`` paths) and
  ``test_upflow --kitti_root``, whose ``kitti2015`` report is the reference's
  ``evaluate_flow`` of the same predicted flows.

No KITTI images are in the repository: the tests write KITTI-layout trees of
small random frames.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from opticalflowscivis_tpu.data import kitti as jkitti  # noqa: E402
from opticalflowscivis_tpu.data import pipeline as jpipeline  # noqa: E402
from opticalflowscivis_tpu.evalsuite import evaluate_flow as j_evaluate_flow  # noqa: E402
from opticalflowscivis_tpu.losses import UPFlowLossConfig as JaxLossConfig  # noqa: E402
from opticalflowscivis_tpu.losses.upflow import upflow_losses as j_upflow_losses  # noqa: E402
from opticalflowscivis_tpu.models import UPFlowConfig as JaxUPFlowConfig  # noqa: E402
from opticalflowscivis_tpu.models import UPFlowNet as JaxUPFlowNet  # noqa: E402
from opticalflowscivis_tpu_torch import data as tdata  # noqa: E402
from opticalflowscivis_tpu_torch.bridge import upflow_params_from_flax  # noqa: E402
from opticalflowscivis_tpu_torch.cli.__main__ import evaluate_kitti  # noqa: E402
from opticalflowscivis_tpu_torch.cli.__main__ import main as cli  # noqa: E402
from opticalflowscivis_tpu_torch.data import kitti  # noqa: E402
from opticalflowscivis_tpu_torch.data.pipeline import PrefetchSampler  # noqa: E402
from opticalflowscivis_tpu_torch.losses import UPFlowLossConfig  # noqa: E402
from opticalflowscivis_tpu_torch.models import UPFlowConfig  # noqa: E402
from opticalflowscivis_tpu_torch.training import UPFlowTrainConfig, UPFlowTrainer  # noqa: E402

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


def _make_kitti_multiview(tmp_path, n_seq=2, n_frames=3, size=(96, 160)):
    """``<seq>_<frame>.png`` multiview frames: random colour frames, each
    sequence's rolled by 2 px a frame."""
    d = tmp_path / "mv"
    os.makedirs(d)
    rng = np.random.default_rng(3)
    for s in range(n_seq):
        base = rng.uniform(0, 255, size + (3,)).astype(np.uint8)
        for f in range(n_frames):
            img = np.roll(base, shift=2 * f, axis=1)
            cv2.imwrite(str(d / f"{s:06d}_{10 + f:02d}.png"), img)
    return str(d)


def _make_kitti_eval_root(tmp_path, n=2, size=(40, 72), shift=(1, -2)):
    """A KITTI-2015 ``training`` tree of ``n`` pairs: frame 11 is frame 10
    moved by ``shift`` px, ``flow_occ`` that shift everywhere, ``flow_noc``
    the same but invalid where the shift leaves the frame."""
    root = tmp_path / "kitti2015"
    dirs = {k: root / "training" / k for k in ("image_2", "flow_occ", "flow_noc")}
    for d in dirs.values():
        os.makedirs(d)
    rng = np.random.default_rng(5)
    h, w = size
    flow = np.broadcast_to(np.asarray(shift, np.float32), (h, w, 2)).copy()
    noc = np.ones((h, w, 1), np.float32)
    dy, dx = shift
    ys, xs = np.mgrid[0:h, 0:w]
    noc[..., 0] = ((ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w))
    for i in range(n):
        im1 = rng.uniform(0, 255, size + (3,)).astype(np.uint8)
        im2 = np.roll(im1, shift, axis=(0, 1))
        cv2.imwrite(str(dirs["image_2"] / f"{i:06d}_10.png"), im1)
        cv2.imwrite(str(dirs["image_2"] / f"{i:06d}_11.png"), im2)
        kitti.write_kitti_flow_png(flow, None, str(dirs["flow_occ"] / f"{i:06d}_10.png"))
        kitti.write_kitti_flow_png(flow * noc, noc, str(dirs["flow_noc"] / f"{i:06d}_10.png"))
    return str(root)


def _last_json(capsys):
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


# -- the copied readers, writers and samplers ------------------------------------------


def test_flo_files_equal_the_reference(tmp_path):
    flow = np.random.default_rng(0).normal(0, 4, (12, 20, 2)).astype(np.float32)
    ours, theirs = str(tmp_path / "a.flo"), str(tmp_path / "b.flo")
    kitti.write_flo(flow, ours)
    jkitti.write_flo(flow, theirs)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_array_equal(kitti.read_flo(ours), jkitti.read_flo(ours))
    np.testing.assert_allclose(kitti.read_flo(ours), flow, atol=1e-6)
    (tmp_path / "bad.flo").write_bytes(np.asarray([1.0, 0, 0], np.float32).tobytes())
    with pytest.raises(ValueError, match="magic"):
        kitti.read_flo(str(tmp_path / "bad.flo"))


def test_kitti_png_files_equal_the_reference(tmp_path):
    """KITTI stores (u, v) with the validity in cv2's B channel; the readers
    return (dy, dx) times the validity."""
    rng = np.random.default_rng(1)
    flow = rng.normal(0, 10, (16, 24, 2)).astype(np.float32)
    flow = np.round(flow * 64) / 64  # representable in the uint16 encoding
    valid = (rng.random((16, 24, 1)) > 0.3).astype(np.float32)
    ours, theirs = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    kitti.write_kitti_flow_png(flow * valid, valid, ours)
    jkitti.write_kitti_flow_png(flow * valid, valid, theirs)
    np.testing.assert_array_equal(cv2.imread(ours, cv2.IMREAD_UNCHANGED),
                                  cv2.imread(theirs, cv2.IMREAD_UNCHANGED))
    back, vback = kitti.read_kitti_flow_png(ours)
    jback, jvback = jkitti.read_kitti_flow_png(ours)
    np.testing.assert_array_equal(back, jback)
    np.testing.assert_array_equal(vback, jvback)
    np.testing.assert_allclose(vback, valid)
    np.testing.assert_allclose(back, flow * valid, atol=1 / 64)
    raw = cv2.imread(ours, cv2.IMREAD_UNCHANGED).astype(np.float64)
    np.testing.assert_allclose((raw[..., 2] - 2**15) / 64 * valid[..., 0], back[..., 1])  # u = dx
    kitti.write_kitti_flow_png(flow, None, ours)  # no mask: every pixel valid
    assert kitti.read_kitti_flow_png(ours)[1].min() == 1.0
    with pytest.raises(FileNotFoundError):
        kitti.read_kitti_flow_png(str(tmp_path / "missing.png"))


def test_read_gray_and_normalize_equal_the_reference(tmp_path):
    d = _make_kitti_multiview(tmp_path, n_seq=1, n_frames=1)
    path = os.path.join(d, "000000_10.png")
    img = kitti._read_gray(path)
    np.testing.assert_array_equal(img, jkitti._read_gray(path))
    assert img.shape == (96, 160, 3) and img.dtype == np.float32  # RGB in [0, 1]
    np.testing.assert_array_equal(img[..., ::-1] * 255, cv2.imread(path).astype(np.float32))
    np.testing.assert_array_equal(kitti.kitti_photometric_normalize(img),
                                  jkitti.kitti_photometric_normalize(img))
    out = kitti.kitti_photometric_normalize(np.full((4, 4, 3), 0.5, np.float32))
    np.testing.assert_allclose(
        out[0, 0], 0.5 - np.asarray([114.785955, 110.1753, 104.920005]) / 255.0, atol=1e-6)


@pytest.mark.parametrize("seed, normalize", [(0, True), (7, False)])
def test_pair_dataset_samples_equal_the_reference(tmp_path, seed, normalize):
    """The same files and seed give the same pairs and the same batches: the
    draws of pair, offsets, flip and swap in the reference's order."""
    d = _make_kitti_multiview(tmp_path)
    ours = kitti.KittiPairDataset(d, crop=(64, 64), rho=8, seed=seed, normalize=normalize)
    theirs = jkitti.KittiPairDataset(d, crop=(64, 64), rho=8, seed=seed, normalize=normalize)
    assert len(ours) == len(theirs) == 4  # 2 sequences x (3 frames -> 2 pairs)
    assert ours.pairs == theirs.pairs
    for batch in (3, 5):
        a, b = ours.sample(batch), theirs.sample(batch)
        assert set(a) == set(b) == {"im1", "im2", "im1_raw", "im2_raw", "start"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert a["im1"].shape == (5, 64, 64, 3) and a["im1_raw"].shape == (5, 80, 80, 3)
    np.testing.assert_array_equal(a["start"], np.full((5, 2), 8.0))
    np.testing.assert_array_equal(a["im1"], a["im1_raw"][:, 8:-8, 8:-8])


@pytest.mark.parametrize("max_pairs", [None, 2, 3])
def test_hbm_cache_equals_the_reference(tmp_path, max_pairs):
    d = _make_kitti_multiview(tmp_path)
    ours = kitti.KittiHBMCache(d, max_pairs=max_pairs, crop=(64, 64), rho=8, seed=1)
    theirs = jkitti.KittiHBMCache(d, max_pairs=max_pairs, crop=(64, 64), rho=8, seed=1)
    np.testing.assert_array_equal(ours.frames, theirs.frames)
    np.testing.assert_array_equal(ours.pair_idx, theirs.pair_idx)
    assert ours.pair_idx.dtype == np.int32 and len(ours) == len(theirs)
    assert (ours.crop, ours.rho) == ((64, 64), 8)
    if max_pairs is None:
        assert ours.frames.shape == (6, 96, 160, 3)  # 2 sequences x 3 frames, deduped


def test_from_frames_keeps_the_frames_pairs_use_at_the_smallest_size():
    rng = np.random.default_rng(2)
    frames = [rng.uniform(size=(h, w, 3)).astype(np.float32)
              for h, w in ((30, 40), (28, 44), (31, 41), (25, 20))]
    cache = kitti.KittiHBMCache.from_frames(frames, [(2, 0), (0, 1)], crop=(8, 16), rho=2)
    assert cache.frames.shape == (3, 28, 40, 3)  # frame 3 unused; min H 28, min W 40
    np.testing.assert_array_equal(cache.frames[1], frames[1][:28, :40])
    np.testing.assert_array_equal(cache.pair_idx, [[2, 0], [0, 1]])
    assert (len(cache), cache.crop, cache.rho) == (2, (8, 16), 2)


def test_prefetch_sampler_equals_the_reference_and_slices(tmp_path):
    """One worker keeps the batches in the dataset's order: the port's first
    batches are the reference sampler's; a smaller ask is the next batch cut
    to size; more workers need one dataset each."""
    d = _make_kitti_multiview(tmp_path)

    def make(module):
        return lambda w: module.KittiPairDataset(d, crop=(64, 64), seed=10 + w)

    ours = PrefetchSampler(batch_size=4, workers=1, depth=2, make_dataset=make(kitti))
    theirs = jpipeline.PrefetchSampler(batch_size=4, workers=1, depth=2,
                                       make_dataset=make(jkitti))
    try:
        for size in (4, 2):
            a, b = ours.sample(size), theirs.sample(size)
            assert a["im1"].shape == (size, 64, 64, 3)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        with pytest.raises(ValueError, match="batch 4"):
            ours.sample(5)
    finally:
        ours.close()
        theirs.close()
    pf = PrefetchSampler(batch_size=2, workers=2, depth=2, make_dataset=make(kitti))
    try:
        assert pf.sample(2)["im2_raw"].shape == (2, 80, 80, 3)
    finally:
        pf.close()
    with pytest.raises(ValueError, match="make_dataset"):
        PrefetchSampler(kitti.KittiPairDataset(d), workers=2)
    assert tdata.PrefetchSampler is PrefetchSampler and tdata.KittiHBMCache is kitti.KittiHBMCache


# -- the batch cut on the device -------------------------------------------------------


def _reference_draw(cache, rng, batch):
    """The draws of the reference's ``fit_kitti_hbm`` loop, in its order."""
    ch, cw = cache.crop
    rho = cache.rho
    fh, fw = cache.frames.shape[1:3]
    pid = cache.pair_idx[rng.integers(len(cache.pair_idx), size=batch)]
    offs = np.stack([rng.integers(rho, max(fh - ch - rho, rho) + 1, size=batch),
                     rng.integers(rho, max(fw - cw - rho, rho) + 1, size=batch)],
                    axis=1).astype(np.int32)
    flip = rng.random(batch) < 0.5
    swap = rng.random(batch) < 0.5
    return pid, offs, flip, swap


def _reference_batch(frames, pid, offs, flip, swap, crop, rho):
    """The reference's on-device batch: ``take`` of the two frames, vmapped
    ``dynamic_slice`` crops and raw windows, ``where`` flips and swaps."""
    ch, cw = crop
    fc = frames.shape[-1]

    def crop_at(img, oy, ox, h, w):
        return jax.lax.dynamic_slice(img, (oy, ox, 0), (h, w, fc))

    i1 = jnp.take(frames, pid[:, 0], axis=0)
    i2 = jnp.take(frames, pid[:, 1], axis=0)
    c1 = jax.vmap(lambda im, o: crop_at(im, o[0], o[1], ch, cw))(i1, offs)
    c2 = jax.vmap(lambda im, o: crop_at(im, o[0], o[1], ch, cw))(i2, offs)
    r1 = jax.vmap(lambda im, o: crop_at(im, o[0] - rho, o[1] - rho,
                                        ch + 2 * rho, cw + 2 * rho))(i1, offs)
    r2 = jax.vmap(lambda im, o: crop_at(im, o[0] - rho, o[1] - rho,
                                        ch + 2 * rho, cw + 2 * rho))(i2, offs)
    fl = flip[:, None, None, None]
    c1, c2, r1, r2 = (jnp.where(fl, t[:, :, ::-1], t) for t in (c1, c2, r1, r2))
    sw = swap[:, None, None, None]
    c1, c2 = jnp.where(sw, c2, c1), jnp.where(sw, c1, c2)
    r1, r2 = jnp.where(sw, r2, r1), jnp.where(sw, r1, r2)
    return {"im1": c1, "im2": c2, "im1_raw": r1, "im2_raw": r2}


@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16"])
def test_device_batch_equals_the_reference_semantics(store_dtype):
    """Several batches drawn from ``default_rng(seed + 2)``: the draws equal
    the reference loop's, and the batch cut from the store equals its crops,
    windows, flips and swaps exactly (from a bf16 store: of the bf16-rounded
    frames, cast to float32)."""
    rng = np.random.default_rng(4)
    frames = [rng.uniform(-0.5, 0.5, (37, 61, 3)).astype(np.float32) for _ in range(7)]
    pairs = [(0, 1), (1, 2), (3, 4), (4, 5), (5, 6), (6, 0)]
    cache = kitti.KittiHBMCache.from_frames(frames, pairs, crop=(16, 24), rho=4)
    dtype = getattr(torch, store_dtype)
    store = torch.from_numpy(cache.frames).to(dtype)
    ref_frames = jnp.asarray(store.float().numpy())
    ours_rng, ref_rng = np.random.default_rng(2), np.random.default_rng(2)
    seen = set()
    for _ in range(4):
        drawn = cache.draw(ours_rng, 8)
        for a, b in zip(drawn, _reference_draw(cache, ref_rng, 8)):
            np.testing.assert_array_equal(a, b)
        pid, offs, flip, swap = drawn
        seen |= {(bool(f), bool(s)) for f, s in zip(flip, swap)}
        got = kitti.device_batch(store, *(torch.from_numpy(np.asarray(x)) for x in drawn),
                                 cache.crop, cache.rho)
        want = _reference_batch(ref_frames, jnp.asarray(pid), jnp.asarray(offs),
                                jnp.asarray(flip), jnp.asarray(swap), cache.crop, cache.rho)
        for k, v in want.items():
            assert got[k].dtype == torch.float32 and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(got["start"].numpy(), np.full((8, 2), 4.0))
    assert len(seen) == 4  # every flip and swap combination was cut


def test_a_cache_for_a_device_store_draws_as_the_cache_of_its_frames():
    """``KittiHBMCache.for_store`` holds no frames, only their shape and the
    pairs: its draws and the batches ``kitti_batch`` cuts with them equal
    those of ``from_frames`` over the same frames."""
    from opticalflowscivis_tpu_torch.training import UPFlowTrainConfig, UPFlowTrainer

    rng = np.random.default_rng(5)
    frames = [rng.uniform(-0.5, 0.5, (37, 61, 3)).astype(np.float32) for _ in range(5)]
    full = kitti.KittiHBMCache.from_frames(frames, [(0, 1), (1, 2), (3, 4)], (16, 24), 4)
    store = torch.from_numpy(full.frames)
    bare = kitti.KittiHBMCache.for_store(store.shape, full.pair_idx, (16, 24), 4)
    assert bare.frames is None and len(bare) == len(full) == 3
    assert bare.frame_shape == full.frame_shape == (5, 37, 61, 3)
    tr = UPFlowTrainer(UPFlowTrainConfig(batch_size=4), device="cpu")
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        a, b = tr.kitti_batch(full, store, rng_a), tr.kitti_batch(bare, store, rng_b)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_device_batch_refuses_frames_smaller_than_crop_and_margin():
    store = torch.zeros((2, 20, 30, 3))
    args = [torch.zeros((1, 2), dtype=torch.int64), torch.full((1, 2), 2),
            torch.zeros(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool)]
    with pytest.raises(ValueError, match="margin"):
        kitti.device_batch(store, *args, (16, 24), 4)


# -- one train step with raw windows ---------------------------------------------------


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


def _raw_batch(batch, size, rho, seed):
    """Raw windows ``[B, size + 2 rho, ...]`` of a smooth texture and of the
    same texture moved by (2, -3) px, their interiors as the crops, and
    ``start`` = (rho, rho)."""
    rng = np.random.default_rng(seed)
    full = size + 2 * rho
    coarse = torch.from_numpy(rng.uniform(0.05, 1.0, (batch, 3, 8, 8)).astype(np.float32))
    r1 = torch.nn.functional.interpolate(coarse, size=(full, full), mode="bilinear",
                                         align_corners=True).permute(0, 2, 3, 1).numpy()
    r2 = np.roll(r1, (2, -3), axis=(1, 2)) + rng.uniform(0, 0.02, r1.shape).astype(np.float32)
    return {"im1": r1[:, rho:-rho, rho:-rho].copy(), "im2": r2[:, rho:-rho, rho:-rho].copy(),
            "im1_raw": r1, "im2_raw": r2,
            "start": np.full((batch, 2), float(rho), np.float32)}


def test_train_step_with_raw_windows_matches_the_reference():
    """The loss parts and every parameter gradient of one step with
    ``im1_raw``, ``im2_raw`` and ``start`` from bridged weights, against
    ``jax.value_and_grad`` of the reference's model and ``upflow_losses``:
    each part within 1e-5 relative, the gradients within 1e-4 of the largest.
    The raw path must reach the loss: without it the photometric term
    differs."""
    size, batch, rho = 64, 2, 8
    loss_kw = dict(census_weight=0.5, smooth_order_1_weight=0.1)
    b = _raw_batch(batch, size, rho, seed=6)
    jnet = JaxUPFlowNet(cfg=JaxUPFlowConfig(**TINY_KW, **NORM_KW), dtype=None)
    params = _numpy_params(jnet, (1, size, size, 3), seed=3)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jcfg = JaxLossConfig(**loss_kw)

    def loss_fn(p):
        out = jnet.apply(p, jb["im1"], jb["im2"])
        return j_upflow_losses(out, jb["im1"], jb["im2"], jcfg,
                               raw=(jb["im1_raw"], jb["im2_raw"], jb["start"]))

    (_, jparts), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    cfg = UPFlowTrainConfig(batch_size=batch, bfloat16=False, model=TINY,
                            loss=UPFlowLossConfig(**loss_kw))
    tr = UPFlowTrainer(cfg, device="cpu")
    tr.net.load_state_dict(upflow_params_from_flax(params), strict=True)
    tr.init_state()
    total, parts = tr.losses({k: torch.from_numpy(v) for k, v in b.items()})
    total.backward()
    assert set(parts) == set(jparts)
    for key, ref in jparts.items():
        assert float(parts[key].detach()) == pytest.approx(float(ref), rel=1e-5, abs=1e-8), key

    want = upflow_params_from_flax(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in tr.net.named_parameters()}
    assert set(got) == set(want)
    largest = max(float(g.abs().max()) for g in want.values())
    worst = max(float((got[n] - want[n]).abs().max()) for n in want)
    assert largest > 0 and worst <= 1e-4 * largest, (worst, largest)

    _, plain = tr.losses({k: torch.from_numpy(b[k]) for k in ("im1", "im2")})
    assert abs(float(plain["photo_loss"].detach()) - float(parts["photo_loss"].detach())) > 1e-6


# -- the training loops ----------------------------------------------------------------


def _narrow_cfg(tmp_path, name, bfloat16=False):
    return UPFlowTrainConfig(batch_size=4, bfloat16=bfloat16, exp_dir=str(tmp_path / name),
                             model=TINY, loss=UPFlowLossConfig(smooth_order_1_weight=0.1))


def test_fit_kitti_streams_two_steps(tmp_path):
    """Two steps from a ``KittiPairDataset`` (crop 64 x 64): finite losses,
    ``loss.json`` and the checkpoint; ``resume`` on a fresh trainer restores
    the step."""
    d = _make_kitti_multiview(tmp_path)
    ds = kitti.KittiPairDataset(d, crop=(64, 64), rho=8, seed=1)
    cfg = _narrow_cfg(tmp_path, "stream")
    tr = UPFlowTrainer(cfg, device="cpu")
    hist = tr.fit_kitti(ds, steps_per_epoch=2, epochs=1, log_every=1)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss_total"]) and tr.state.step == 2
    assert sorted(os.listdir(cfg.exp_dir)) == ["ckpt_meta.json", "loss.json", "upflow.ckpt"]
    with open(os.path.join(cfg.exp_dir, "loss.json")) as f:
        assert len(json.load(f)["loss"]) == 1
    again = UPFlowTrainer(cfg, device="cpu")
    again.fit_kitti(ds, steps_per_epoch=1, epochs=1, log_every=0, resume=True)
    assert again.state.step == 3
    with open(os.path.join(cfg.exp_dir, "loss.json")) as f:
        assert len(json.load(f)["loss"]) == 2


def test_fit_kitti_hbm_two_steps_uploads_once(tmp_path):
    """Two steps from the frame store (float32 here, bf16 with
    ``cfg.bfloat16``); a second call reuses the same store tensor, another
    cache gets its own."""
    d = _make_kitti_multiview(tmp_path)
    cache = kitti.KittiHBMCache(d, max_pairs=None, crop=(64, 64), rho=8)
    cfg = _narrow_cfg(tmp_path, "hbm")
    tr = UPFlowTrainer(cfg, device="cpu")
    hist = tr.fit_kitti_hbm(cache, steps_per_epoch=2, epochs=1, log_every=0)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss_total"])
    assert os.path.isfile(os.path.join(cfg.exp_dir, "upflow.ckpt"))
    store = tr.kitti_store(cache)
    assert store.dtype == torch.float32 and store.shape == cache.frames.shape
    np.testing.assert_array_equal(store.numpy(), cache.frames)
    tr.fit_kitti_hbm(cache, steps_per_epoch=1, epochs=1, log_every=0)
    assert tr.kitti_store(cache) is store and tr.state.step == 3
    with open(os.path.join(cfg.exp_dir, "loss.json")) as f:
        assert len(json.load(f)["loss"]) == 2
    other = kitti.KittiHBMCache.from_frames(list(cache.frames), [(0, 1)], (64, 64), 8)
    assert tr.kitti_store(other) is not store
    bf16 = UPFlowTrainer(_narrow_cfg(tmp_path, "hbm16", bfloat16=True), device="cpu")
    assert bf16.kitti_store(cache).dtype == torch.bfloat16


def test_fit_kitti_hbm_trains_on_kitti_batch_s_batches(tmp_path, monkeypatch):
    """Three steps of ``fit_kitti_hbm``: each batch ``train_step`` gets is
    the one ``kitti_batch`` returned, and equals the draw of
    ``default_rng(cfg.seed + 2)`` cut out of the store by ``device_batch``,
    step by step."""
    d = _make_kitti_multiview(tmp_path)
    cache = kitti.KittiHBMCache(d, max_pairs=None, crop=(64, 64), rho=8)
    cfg = _narrow_cfg(tmp_path, "kb")
    tr = UPFlowTrainer(cfg, device="cpu")
    cut, trained = [], []
    batch_of = UPFlowTrainer.kitti_batch
    monkeypatch.setattr(UPFlowTrainer, "kitti_batch",
                        lambda self, *a: cut.append(batch_of(self, *a)) or cut[-1])
    monkeypatch.setattr(UPFlowTrainer, "train_step",
                        lambda self, b: trained.append(b) or {"loss_total": torch.zeros(())})
    tr.fit_kitti_hbm(cache, steps_per_epoch=3, epochs=1, log_every=0)
    assert len(trained) == 3 and all(a is b for a, b in zip(cut, trained))
    rng, store = np.random.default_rng(cfg.seed + 2), tr.kitti_store(cache)
    for got in trained:
        drawn = [torch.from_numpy(np.asarray(a)) for a in cache.draw(rng, cfg.batch_size)]
        want = kitti.device_batch(store, *drawn, cache.crop, cache.rho)
        assert set(got) == set(want)
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)


# -- the CLI ---------------------------------------------------------------------------


@pytest.fixture
def small_kitti_crops(monkeypatch):
    """The CLI's KITTI samplers crop 256 x 832 as upstream does; on the CPU a
    64 x 64 crop of the full-width model keeps a step to seconds."""
    for name in ("KittiPairDataset", "KittiHBMCache"):
        cls = getattr(tdata, name)
        monkeypatch.setattr(tdata, name, type(name, (cls,), {
            "__init__": lambda self, *a, _cls=cls, **kw: _cls.__init__(
                self, *a, **{**kw, "crop": (64, 64)})}))


@pytest.mark.parametrize("hbm_cache", ["4", "0"])
def test_cli_train_upflow_kitti(tmp_path, capsys, small_kitti_crops, hbm_cache):
    """``train_upflow --dataset kitti`` at full width, one step of batch 2:
    from the device store (``--hbm_cache 4``) or through two prefetch threads
    (``--hbm_cache 0``); the report, ``loss.json`` and the checkpoint."""
    d = _make_kitti_multiview(tmp_path)
    res = tmp_path / "r"
    cli(["train_upflow", "--cpu", "--dataset", "kitti", "--kitti_image_dir", d,
         "--results_dir", str(res), "--epochs", "1", "--batch_size", "2",
         "--steps_per_epoch", "1", "--hbm_cache", hbm_cache, "--prefetch_workers", "2"])
    out = capsys.readouterr().out
    assert ("4 pairs kept on the device" if hbm_cache == "4" else "4 multiview pairs") in out
    final = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])["final"]
    assert np.isfinite(final["loss_total"])
    run = res / "kitti" / "upflow"
    assert sorted(os.listdir(run)) == ["ckpt_meta.json", "loss.json", "upflow.ckpt"]
    with pytest.raises(SystemExit, match="requires --kitti_image_dir"):
        cli(["train_upflow", "--cpu", "--dataset", "kitti"])


def test_cli_test_upflow_kitti_root_equals_the_reference_scores(tmp_path, capsys):
    """``test_upflow --kitti_root`` on a written KITTI-2015 tree (full width,
    fresh weights): ``kitti2015`` holds the mean of each score, equal to the
    reference's ``evaluate_flow`` of the flows the same trainer predicts
    pair by pair; ``evaluate_kitti`` gives it from in-memory samples."""
    root = _make_kitti_eval_root(tmp_path)
    res = str(tmp_path / "r")
    cli(["test_upflow", "--cpu", "--dataset", "kitti", "--kitti_root", root,
         "--results_dir", res])
    report = _last_json(capsys)
    with open(os.path.join(res, "kitti", "upflow", "test_report.json")) as f:
        assert json.load(f) == report
    scores = report["kitti2015"]
    tr = UPFlowTrainer(UPFlowTrainConfig(exp_dir=os.path.join(res, "kitti", "upflow"),
                                         bfloat16=False), device="cpu")
    tr.init_state()
    samples = list(kitti.load_kitti_eval_pairs(root))
    assert [s[0] for s in samples] == ["000000", "000001"]
    assert samples[0][6].min() == 0.0 and samples[0][4].min() == 1.0  # noc masks the edge
    ref = []
    for _, im1, im2, f_occ, m_occ, f_noc, m_noc in samples:
        flow = tr.predict(np.stack([im1, im2])[None])[1]["flow_f"][0].numpy()
        assert flow.shape == (64, 128, 2)  # padded to the multiple of 64
        ref.append(j_evaluate_flow(flow[None, :40, :72], f_occ[None], m_occ[None],
                                   f_noc[None], m_noc[None]))
    assert set(scores) == set(ref[0])
    for k, v in scores.items():
        assert v == pytest.approx(float(np.mean([r[k] for r in ref])), rel=1e-6, abs=1e-6), k
        assert np.isfinite(v)
    assert evaluate_kitti(tr, samples) == pytest.approx(scores, rel=1e-6, abs=1e-6)
    with pytest.raises(ValueError, match="no KITTI"):
        evaluate_kitti(tr, [])
