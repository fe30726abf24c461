"""PyTorch port: the evaluation protocols (``evalsuite/benchmarks.py``) against
the JAX package's, the twins of ``tests/test_misc.py``'s protocol cases and
``tests/test_evalsuite.py``'s HD yuv case.

One narrow RGB IFNet (blocks (8, 8, 8), teacher 8) with numpy-drawn weights
runs in both packages (the port through ``bridge.py``, on the CPU, its warps
unbounded as the JAX model's are on the CPU), on PNG trees and a YUV
sequence written from a seed.  The forwards agree within 2e-5; the
protocols round the prediction to uint8 before scoring, where a value on a
level's edge may round the other way, so the scores are compared within:
PSNR 0.01 dB, SSIM 1e-4, interpolation error 2e-3 (its report keeps 3
decimals), Y-PSNR 0.01 dB.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowscivis_tpu import inference as jinf
from opticalflowscivis_tpu.data.yuv_io import YUVWriter
from opticalflowscivis_tpu.evalsuite import benchmarks as jbench
from opticalflowscivis_tpu.models import IFNet as JaxIFNet
from opticalflowscivis_tpu_torch import inference as tinf
from opticalflowscivis_tpu_torch.bridge import ifnet_params_from_flax
from opticalflowscivis_tpu_torch.evalsuite import benchmarks as tbench
from opticalflowscivis_tpu_torch.models import IFNet
from opticalflowscivis_tpu_torch.models.ifnet_hd import IFNetHDv3

cv2 = pytest.importorskip("cv2")

NARROW = {"in_channels": 3, "block_channels": (8, 8, 8), "teacher_channels": 8}
PSNR_TOL = 1e-2
SSIM_TOL = 1e-4
IE_TOL = 2e-3
H, W = 40, 56  # padded to 64 x 64 by the interpolators


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _numpy_params(jnet, seed):
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
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
    """(JAX Interpolator, port Interpolator) over the same weights."""
    jnet = JaxIFNet(ndim=2, **NARROW)
    params = _numpy_params(jnet, seed=3)
    net = IFNet(fast_warp_r=0, device="cpu", **NARROW)
    net.load_state_dict(ifnet_params_from_flax(params), strict=True)
    return (jinf.Interpolator(jnet, params, pad_multiple=32),
            tinf.Interpolator(net, pad_multiple=32, device="cpu"))


def _triplet(rng, h=H, w=W):
    """Two smooth textured frames and their mean, uint8 BGR."""
    base = cv2.resize(rng.uniform(0, 255, (h // 8, w // 8, 3)).astype(np.float32), (w, h))
    f0 = np.clip(base + rng.normal(0, 4, base.shape), 0, 255).astype(np.uint8)
    f2 = np.clip(np.roll(base, (1, 2), (0, 1)), 0, 255).astype(np.uint8)
    mid = ((f0.astype(np.float32) + f2) / 2).astype(np.uint8)
    return f0, f2, mid


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A triplet-dir tree, a Vimeo90K test tree and a Middlebury Other tree."""
    root = tmp_path_factory.mktemp("protocols")
    rng = np.random.default_rng(0)
    for i in range(2):
        d = root / "triplets" / f"seq{i}"
        d.mkdir(parents=True)
        for name, img in zip(("frame_00.png", "frame_02.png", "frame_01_gt.png"), _triplet(rng)):
            cv2.imwrite(str(d / name), img)
    vimeo = root / "vimeo"
    names = ["00001/0001", "00002/0007"]
    for tri in names:
        d = vimeo / "sequences" / tri
        d.mkdir(parents=True)
        for name, img in zip(("im1.png", "im3.png", "im2.png"), _triplet(rng)):
            cv2.imwrite(str(d / name), img)
    (vimeo / "tri_testlist.txt").write_text("\n".join(names) + "\n")
    for name in tbench._MIDDLEBURY:
        f0, f2, mid = _triplet(rng, 24, 32)
        for sub, fname, img in (("other-data", "frame10.png", f0),
                                ("other-data", "frame11.png", f2),
                                ("other-gt-interp", "frame10i11.png", mid)):
            (root / sub / name).mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(root / sub / name / fname), img)
    return root


def _close_scores(got: dict, want: dict) -> None:
    assert got["n"] == want["n"]
    assert np.isfinite(got["psnr"]) and 0 <= got["ssim"] <= 1
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_TOL
    assert abs(got["ssim"] - want["ssim"]) <= SSIM_TOL


def test_bench_triplet_dirs(interps, trees):
    jint, tint = interps
    root = str(trees / "triplets")
    res = tbench.bench_triplet_dirs(tint, root)
    assert res["n"] == 2
    _close_scores(res, jbench.bench_triplet_dirs(jint, root))


def test_bench_vimeo90k(interps, trees):
    jint, tint = interps
    res = tbench.bench_vimeo90k(tint, str(trees / "vimeo"))
    assert res["n"] == 2
    _close_scores(res, jbench.bench_vimeo90k(jint, str(trees / "vimeo")))
    assert tbench.bench_vimeo90k(tint, str(trees / "vimeo"), limit=1)["n"] == 1


def test_bench_middlebury(interps, trees):
    jint, tint = interps
    args = (str(trees / "other-data"), str(trees / "other-gt-interp"))
    res, want = tbench.bench_middlebury(tint, *args), jbench.bench_middlebury(jint, *args)
    assert set(res) == set(want) == set(tbench._MIDDLEBURY) | {"mean"}
    for k in want:
        assert abs(res[k] - want[k]) <= IE_TOL, k


def test_bench_latency_protocol(interps):
    """On the CPU the host's clock times the forward (no CUDA events)."""
    _, tint = interps
    res = tbench.bench_latency(tint, shape=(32, 32, 3), warmup=1, iters=3)
    assert set(res) == {"mean_latency_ms", "pairs_per_sec"}
    assert res["pairs_per_sec"] > 0 and res["mean_latency_ms"] > 0


def _write_yuv(path: str, h: int, w: int, n: int = 8) -> None:
    t = np.linspace(0, 1, w, dtype=np.float32)
    with YUVWriter(path) as wr:
        for i in range(n):
            # No wrap: a clipped ramp is piecewise-linear in time, so the
            # midpoint-lerp stub below reconstructs it almost exactly.
            ramp = np.clip(t[None, :] * 0.5 + i * 0.05, 0, 1)
            frame = np.repeat(ramp[..., None], 3, -1)
            wr.write(np.repeat(frame, h, 0).reshape(h, w, 3) * 255)


class _LerpInterp:
    pad_multiple = 32

    def pair(self, a, b, timestep=0.5):
        m = (a + b) / 2
        return m, np.zeros(a.shape[:-1] + (2,), np.float32), m


@pytest.mark.parametrize("multi", [1, 2])
def test_bench_hd_yuv_protocol(tmp_path, multi):
    """bench_hd_yuv runs the HD.py loop on a synthetic yuv with a stub
    interpolator; a perfect midpoint predictor scores very high Y-PSNR, and
    the report equals the reference's."""
    h, w = 64, 64
    name = "HD_dataset/HD544p_GT/toy.yuv"
    os.makedirs(tmp_path / "HD_dataset" / "HD544p_GT", exist_ok=True)
    _write_yuv(str(tmp_path / name), h, w)
    kw = dict(multi=multi, max_index=6, name_list=[(name, h, w)])
    res = tbench.bench_hd_yuv(_LerpInterp(), str(tmp_path), **kw)
    assert name in res["per_sequence"]
    assert res["mean"] > 20.0
    assert res == jbench.bench_hd_yuv(_LerpInterp(), str(tmp_path), **kw)


def test_bench_hd_yuv_through_the_model(interps, tmp_path):
    """The model's 4x recursion (``multi`` 2) on a 64 x 96 sequence: the
    port's Y-PSNR report against the JAX package's."""
    jint, tint = interps
    h, w = 64, 96
    name = "HD_dataset/HD544p_GT/toy.yuv"
    os.makedirs(tmp_path / "HD_dataset" / "HD544p_GT", exist_ok=True)
    _write_yuv(str(tmp_path / name), h, w, n=5)
    kw = dict(multi=2, max_index=4, name_list=[(name, h, w)])
    res = tbench.bench_hd_yuv(tint, str(tmp_path), **kw)
    want = jbench.bench_hd_yuv(jint, str(tmp_path), **kw)
    assert set(res) == set(want) == {"per_sequence", f"{h}p", "mean"}
    assert abs(res["mean"] - want["mean"]) <= PSNR_TOL


def test_protocols_take_a_zoo_interpolator(trees):
    """A ``ZooInterpolator`` (random HDv3 weights from a seed) goes through
    the same protocol: finite scores over both triplets."""
    torch.manual_seed(0)
    zoo = tinf.ZooInterpolator("hdv3", IFNetHDv3(), 32, device="cpu")
    res = tbench.bench_triplet_dirs(zoo, str(trees / "triplets"))
    assert res["n"] == 2 and np.isfinite(res["psnr"]) and 0 <= res["ssim"] <= 1
