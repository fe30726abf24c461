"""PyTorch port: the inference engine and the metrics against the JAX package.

One narrow IFNet (blocks (16, 12, 8), teacher 8) with numpy-drawn weights runs
in both packages (the port through the bridge, on the CPU).  Frames are
50x70 so the /32 edge pad and the crop back are exercised.  Tolerances:
- one forward 2e-5 (float32 convs in other orders, see test_torch_ifnet);
- bisection series 1e-4: predicted frames feed the next level's forwards;
- metrics 1e-4 on SSIM (float32 variance terms cancel at 255 range), exact
  for the numpy-only functions.

The series job's staging ring is held bit for bit to the plain pageable
download of the same device tensors: on the CPU through slots smaller than a
frame, and on a card (``cuda``; on a host without JAX run
``python -m pytest --noconftest tests/test_torch_inference.py -m cuda``).
"""

import contextlib
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from opticalflowscivis_tpu import inference as jinf
    from opticalflowscivis_tpu.evalsuite import metrics as jmetrics
    from opticalflowscivis_tpu.models import IFNet as JaxIFNet
except ModuleNotFoundError:  # a host without JAX runs the ``cuda`` test alone
    jax = None

from opticalflowscivis_tpu_torch import inference as tinf
from opticalflowscivis_tpu_torch.bridge import ifnet_params_from_flax
from opticalflowscivis_tpu_torch.evalsuite import metrics as tmetrics
from opticalflowscivis_tpu_torch.models import IFNet

NARROW = {"block_channels": (16, 12, 8), "teacher_channels": 8}
H, W = 50, 70
PAIR_TOL = 2e-5
SERIES_TOL = 1e-4


def _numpy_params(jnet, seed):
    """Params of ``jnet`` (teacher included) drawn with numpy."""
    x = jax.ShapeDtypeStruct((1, 64, 96, 1), jnp.float32)
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


@pytest.fixture(scope="module")
def interps():
    """{tta: (JAX Interpolator, port Interpolator)} over the same weights."""
    jnet = JaxIFNet(ndim=2, **NARROW)
    params = _numpy_params(jnet, seed=7)
    net = IFNet(fast_warp_r=16, device="cpu", **NARROW)
    net.load_state_dict(ifnet_params_from_flax(params), strict=True)
    return {
        tta: (jinf.Interpolator(jnet, params, pad_multiple=32, tta=tta),
              tinf.Interpolator(net, pad_multiple=32, tta=tta, device="cpu"))
        for tta in (False, True)
    }


def _frames(seed, n):
    return np.random.default_rng(seed).uniform(0, 1, (n, H, W, 1)).astype(np.float32)


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_pair_matches_jax(interps, tta):
    ref_interp, interp = interps[tta]
    a, b = _frames(0, 2), _frames(1, 2)
    ref = ref_interp.pair(a, b)
    out = interp.pair(a, b)
    for name, r, o, c in zip(("merged", "flow", "mask"), ref, out, (1, 4, 1)):
        assert o.shape == (2, H, W, c) and o.dtype == np.float32
        np.testing.assert_allclose(o, r, atol=PAIR_TOL, err_msg=name)
    assert np.abs(out[1]).max() < 16  # the port's ±16 clip is inactive here


def test_series_device_path_matches_jax(interps):
    ref_interp, interp = interps[False]
    frames = _frames(2, 9)
    ref, ref_flows = jinf.interpolate_series(ref_interp, frames, factor=4, collect_flow=True)
    out, flows = tinf.interpolate_series(interp, frames, factor=4, collect_flow=True)
    assert out.shape == (9, H, W, 1) and flows.shape == (2, H, W, 4)
    np.testing.assert_allclose(out, ref, atol=SERIES_TOL)
    np.testing.assert_allclose(flows, ref_flows, atol=SERIES_TOL)
    np.testing.assert_array_equal(out[::4], frames[::4])


def _pageable_series(interp, frames, factor):
    """The series job as it downloaded before the staging ring: the same
    forwards on the device, then ``_to_numpy`` of the reconstruction and the
    flows, cropped."""
    kept = np.asarray(frames[::factor], np.float32)
    padded, orig_shape = interp._pad(kept)
    n_out = (kept.shape[0] - 1) * factor + 1
    with torch.inference_mode():
        src = interp._to_tensor(padded)
        recon = torch.zeros((n_out,) + tuple(src.shape[1:]), device=interp.device)
        recon[::factor] = src
        gap = factor
        while gap > 1:
            starts = torch.arange(0, n_out - 1, gap, device=interp.device)
            merged, _, _ = interp.forward(recon[starts], recon[starts + gap], 0.5)
            recon[starts + gap // 2] = merged.float()
            gap //= 2
        _, flow, _ = interp.forward(src[:-1], src[1:], 0.5)
        crop = interp._crop(orig_shape)
        return interp._to_numpy(recon)[crop], interp._to_numpy(flow)[crop]


# a 64x96 padded frame is 24576 bytes: 1000 and 24000 put chunk boundaries
# inside frames and wrap the ring within a level; the default moves a level
# in one chunk
@pytest.mark.parametrize("slot_bytes,slots", [(1000, 3), (24000, 2),
                                               (tinf.STAGE_SLOT_BYTES, tinf.STAGE_SLOTS)],
                         ids=["1000x3", "24000x2", "default"])
def test_series_staging_ring_matches_the_pageable_download(interps, slot_bytes, slots):
    """Factor 4 on 9 frames of 50x70 (padded to 64x96): each level's rows
    ``starts + gap // 2``, the kept frames and the flows equal the plain
    download bit for bit, through slots smaller than a frame."""
    _, interp = interps[False]
    interp = tinf.Interpolator(interp.model, pad_multiple=32, device="cpu")
    interp._ring = tinf._StagingRing(interp.device, slot_bytes, slots)
    frames = _frames(13, 9)
    recon, flows = tinf.interpolate_series_device(interp, frames, 4, collect_flow=True)
    ref, ref_flows = _pageable_series(interp, frames, 4)
    assert recon.shape == ref.shape == (9, H, W, 1) and flows.shape == (2, H, W, 4)
    for gap in (4, 2):
        np.testing.assert_array_equal(recon[gap // 2:-1:gap], ref[gap // 2:-1:gap])
    np.testing.assert_array_equal(recon[::4], frames[::4])
    np.testing.assert_array_equal(flows, ref_flows)
    assert recon.flags.owndata and flows.flags.owndata
    assert interp._ring.slots.shape == (slots, slot_bytes)


@pytest.mark.parametrize("shape,crop,slot_bytes,layout", [
    ((5, 3, 8, 12), (5, 3, 7, 9), 40, "apart"),
    ((4, 2, 6, 8, 10), (4, 2, 5, 8, 7), 136, "apart"),
    ((3, 4, 6, 10), (3, 4, 6, 10), 1 << 12, "apart"),
    ((4, 4, 6, 10), (4, 4, 5, 7), 56, "channels_last"),
], ids=["2d-c3", "3d-c2", "whole", "channels-last"])
def test_staging_ring_moves_rows_into_cropped_destinations(shape, crop, slot_bytes, layout):
    """The ring on the CPU: a bf16 tensor whose rows lie apart (every other
    row of a larger one) or whose channels are innermost lands widened into
    a cropped float32 destination, and a host array uploads unchanged,
    through slots of a few lines."""
    ring = tinf._StagingRing(torch.device("cpu"), slot_bytes, 3)
    if layout == "apart":
        rows = torch.randn((2 * shape[0],) + shape[1:]).to(torch.bfloat16)[1::2]
    else:
        rows = torch.randn(shape).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dst = torch.empty(crop)
    ring.download(rows, dst)
    ring.drain()
    index = tuple(slice(0, c) for c in crop)
    torch.testing.assert_close(dst, rows[index].float(), rtol=0, atol=0)
    host = np.random.default_rng(3).uniform(0, 1, shape).astype(np.float32)
    np.testing.assert_array_equal(ring.upload(host).numpy(), host)


def test_staging_ring_thread_lands_every_chunk_under_contention(monkeypatch):
    """The ring's thread on the CPU (CUDA's events and stream stood in for by
    no-ops; the copies are synchronous): rounds of three downloads through 3
    slots of a few lines, with the interpreter switching threads every
    microsecond, land every element where it belongs, after the page
    reservation and before the next round, and hand every slot back."""

    class Event:
        def record(self, stream=None):
            pass

        def synchronize(self):
            pass

    class Stream:
        def wait_event(self, event):
            pass

    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    ring = tinf._StagingRing(torch.device("cpu"), 136, 3)
    ring.stream, ring.events = Stream(), [Event() for _ in range(3)]
    ring.worker = ThreadPoolExecutor(1)
    gen = torch.Generator().manual_seed(0)
    failures = []

    def rounds():
        try:
            for _ in range(20):
                rows = [torch.randn((8, 3, 6, 10), generator=gen)[1::2] for _ in range(3)]
                dsts = [torch.empty(4, 3, 5, 9) for _ in rows]
                host = np.full(40, 7.0, np.float32)
                ring.reserve(host)  # zeroes what the copy below then overwrites
                ring.host_copy(torch.from_numpy(host)[:5], torch.ones(5))
                for r, d in zip(rows, dsts):
                    ring.download(r, d)
                ring.drain()
                for r, d in zip(rows, dsts):
                    assert torch.equal(d, r[:, :, :5, :9])
                assert (host[:5] == 1).all() and ring.free.qsize() == 3
        except Exception as e:  # reported by the test's thread
            failures.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=rounds)
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        ring.worker.shutdown(wait=False)
    assert not t.is_alive() and failures == []


@pytest.mark.cuda
def test_series_staging_ring_on_the_card_matches_the_pageable_download():
    """On the card, factor 8 with the flows on 33 frames of 50x70, bf16
    compute, through 3 slots of 24000 bytes (under a 64x96 frame: the ring
    wraps within every level): each level's rows and the flows equal
    ``_to_numpy`` of the very device tensors the call queued (cuDNN's
    kernels need not repeat a forward bit for bit), the results own their
    memory, and a second call leaves the first call's arrays as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.manual_seed(0)
    net = IFNet(fast_warp_r=16, dtype=torch.bfloat16, device="cuda", **NARROW)
    interp = tinf.Interpolator(net, pad_multiple=32, device="cuda")
    ring = interp._ring = tinf._StagingRing(interp.device, 24000, 3)
    queued = []
    download = ring.download

    def spy(rows, dst):
        queued.append(rows.clone())
        download(rows, dst)

    ring.download = spy
    frames, other = _frames(14, 33), _frames(15, 33)
    recon, flows = tinf.interpolate_series_device(interp, frames, 8, collect_flow=True)
    assert recon.shape == (33, H, W, 1) and flows.shape == (4, H, W, 4)
    crop = (slice(None), slice(0, H), slice(0, W))
    assert len(queued) == 4  # the levels at gaps 8, 4, 2, then the flows
    for gap, rows in zip((8, 4, 2), queued):
        np.testing.assert_array_equal(recon[gap // 2:-1:gap], interp._to_numpy(rows)[crop])
    np.testing.assert_array_equal(recon[::8], frames[::8])
    np.testing.assert_array_equal(flows, interp._to_numpy(queued[3])[crop])
    kept = recon.copy(), flows.copy()
    recon2, flows2 = tinf.interpolate_series_device(interp, other, 8, collect_flow=True)
    np.testing.assert_array_equal(recon2[::8], other[::8])
    np.testing.assert_array_equal(flows2, interp._to_numpy(queued[7])[crop])
    np.testing.assert_array_equal(recon, kept[0])
    np.testing.assert_array_equal(flows, kept[1])
    assert ring.stream is not None and ring.slots.is_pinned()
    pinned = ring.slots.numpy()
    for a in (recon, flows):
        for b in (recon2, flows2, pinned):
            assert not np.shares_memory(a, b)
    assert not np.shares_memory(recon2, pinned) and not np.shares_memory(flows2, pinned)


def test_series_host_path_with_ssim_gate_matches_jax(interps):
    """Factor 2 with a duplicate-frame gate: the host path, where a repeated
    kept frame is copied and the other pairs are interpolated."""
    ref_interp, interp = interps[False]
    frames = _frames(3, 7)
    frames[2] = frames[0]  # kept frames 0 and 2 are identical: SSIM 1 > gate
    ref, _ = jinf.interpolate_series(ref_interp, frames, 2, dup_ssim_gate=0.99)
    out, _ = tinf.interpolate_series(interp, frames, 2, dup_ssim_gate=0.99)
    assert out.shape == (7, H, W, 1)
    np.testing.assert_array_equal(out[1], frames[0])
    assert not np.allclose(out[3], frames[2])
    np.testing.assert_allclose(out, ref, atol=SERIES_TOL)


def test_recursive_and_ratio_match_jax(interps):
    ref_interp, interp = interps[False]
    a, b = _frames(4, 1), _frames(5, 1)
    ref = jinf.interpolate_recursive(ref_interp, a, b, 3)
    out = tinf.interpolate_recursive(interp, a, b, 3)
    assert len(out) == 3
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o, r, atol=SERIES_TOL)
    np.testing.assert_allclose(
        tinf.interpolate_ratio(interp, a, b, 0.3),
        jinf.interpolate_ratio(ref_interp, a, b, 0.3),
        atol=SERIES_TOL,
    )
    np.testing.assert_array_equal(tinf.interpolate_ratio(interp, a, b, 0.01), a)


def test_batched_pair_inference_matches_jax(interps):
    ref_interp, interp = interps[False]
    tuples = np.random.default_rng(6).uniform(0, 1, (3, 3, H, W, 2)).astype(np.float32)
    ref = jinf.batched_pair_inference(ref_interp, tuples, batch_size=2)
    out = tinf.batched_pair_inference(interp, tuples, batch_size=2)
    assert out["pred"].shape == (3, H, W, 1) and out["flow"].shape == (3, H, W, 4)
    for key in ("pred", "flow", "mask", "gt"):
        np.testing.assert_allclose(out[key], ref[key], atol=PAIR_TOL, err_msg=key)


def _series(seed, n=9):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (n, 24, 28)).astype(np.float32)
    return base, np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.float32)


def test_psnr_and_diff_match_jax():
    a, b = _series(10)
    assert tmetrics.calculate_psnr(a, b) == jmetrics.calculate_psnr(a, b)
    assert tmetrics.calculate_psnr(a, a) == float("inf")
    np.testing.assert_array_equal(tmetrics.calculate_diff(a, b), jmetrics.calculate_diff(a, b))


@pytest.mark.parametrize("layout", ["hw", "hwc", "bhw", "bhwc"])
def test_calculate_ssim_matches_jax(layout):
    a, b = _series(11, n=2)
    shaped = {
        "hw": (a[0], b[0]), "hwc": (a[0, ..., None], b[0, ..., None]),
        "bhw": (a, b), "bhwc": (a[..., None], b[..., None]),
    }[layout]
    ref = jmetrics.calculate_ssim(*shaped)
    assert tmetrics.calculate_ssim(*shaped) == pytest.approx(ref, abs=1e-4)


@pytest.mark.parametrize("factor", [2, 4])
def test_calculate_metrics_and_linear_baseline_match_jax(factor):
    orig, recon = _series(12)
    base = tmetrics.linear_interpolation_baseline(orig, factor)
    np.testing.assert_array_equal(base, jmetrics.linear_interpolation_baseline(orig, factor))
    for interp in (recon, base):
        psnr, ssim_v = tmetrics.calculate_metrics(orig, interp, factor)
        ref_psnr, ref_ssim = jmetrics.calculate_metrics(orig, interp, factor)
        assert psnr == pytest.approx(ref_psnr, rel=1e-12)
        assert ssim_v == pytest.approx(ref_ssim, abs=1e-4)
