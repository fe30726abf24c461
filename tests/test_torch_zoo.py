"""PyTorch port: the pretrained RIFE zoo models (HDv3, HD v1 and v2), their
loaders, ``load_pretrained_zoo`` / ``ZooInterpolator`` and ``--zoo_dir``.

Twins of ``tests/test_hdv3_import.py`` and ``tests/test_hd_legacy_import.py``:
their torch harness of the upstream networks is copied below.  A random
harness is saved in the upstream layout, and the port and the JAX package load
the **same** files.  Both carry the flow row-major, so their outputs compare
directly (1e-4: float32 convolutions in other orders); against the harness,
which carries the upstream (dx, dy) flow, the port's flow is permuted back,
at the reference tests' tolerances.  v1's BatchNorm: the port keeps
``BatchNorm2d`` in eval mode, the JAX package folds it into the convs.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as tF

from opticalflowscivis_tpu import inference as jinf
from opticalflowscivis_tpu.models.ifnet_hd import IFNetHDv3 as JaxIFNetHDv3
from opticalflowscivis_tpu.models.ifnet_hd import load_torch_rife_hdv3 as jax_load_hdv3
from opticalflowscivis_tpu.models.ifnet_hd_legacy import RIFEHDLegacy as JaxRIFEHDLegacy
from opticalflowscivis_tpu.models.ifnet_hd_legacy import (
    load_torch_rife_hd_legacy as jax_load_legacy,
)
from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
from opticalflowscivis_tpu_torch.inference import (
    ZooInterpolator,
    interpolate_series,
    load_pretrained_zoo,
)
from opticalflowscivis_tpu_torch.models.ifnet_hd import load_torch_rife_hdv3
from opticalflowscivis_tpu_torch.models.ifnet_hd_legacy import (
    RIFEHDLegacy,
    load_torch_rife_hd_legacy,
)
from opticalflowscivis_tpu_torch.ops.kernels import warp as kernels_warp

TOL = 1e-4  # the port against the JAX package on the same checkpoint


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers side by side: a few threads each keep
    the many small ops of these tests from fighting over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---- the upstream torch harness (tests/test_hdv3_import.py) ----------------------


def _tconv(i, o, k=3, s=1, p=1):
    return tnn.Sequential(tnn.Conv2d(i, o, k, s, p), tnn.PReLU(o))


class _TorchIFBlock(tnn.Module):
    def __init__(self, in_planes, c=90):
        super().__init__()
        self.conv0 = tnn.Sequential(_tconv(in_planes, c // 2, 3, 2, 1),
                                    _tconv(c // 2, c, 3, 2, 1))
        for b in range(4):
            setattr(self, f"convblock{b}",
                    tnn.Sequential(_tconv(c, c), _tconv(c, c)))
        self.conv1 = tnn.Sequential(tnn.ConvTranspose2d(c, c // 2, 4, 2, 1),
                                    tnn.PReLU(c // 2),
                                    tnn.ConvTranspose2d(c // 2, 4, 4, 2, 1))
        self.conv2 = tnn.Sequential(tnn.ConvTranspose2d(c, c // 2, 4, 2, 1),
                                    tnn.PReLU(c // 2),
                                    tnn.ConvTranspose2d(c // 2, 1, 4, 2, 1))

    def forward(self, x, flow, scale=1):
        if scale != 1:
            x = tF.interpolate(x, scale_factor=1.0 / scale, mode="bilinear",
                               align_corners=False)
            flow = tF.interpolate(flow, scale_factor=1.0 / scale, mode="bilinear",
                                  align_corners=False) / scale
        feat = self.conv0(torch.cat((x, flow), 1))
        for b in range(4):
            feat = getattr(self, f"convblock{b}")(feat) + feat
        f = self.conv1(feat)
        m = self.conv2(feat)
        if scale != 1:
            f = tF.interpolate(f, scale_factor=scale, mode="bilinear",
                               align_corners=False) * scale
            m = tF.interpolate(m, scale_factor=scale, mode="bilinear",
                               align_corners=False)
        return f, m


def _torch_warp(img, flow):
    """grid_sample border/align_corners=True warp, torch (dx,dy) flow channels."""
    _, _, H, W = img.shape
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32),
        torch.arange(W, dtype=torch.float32), indexing="ij")
    x = gx[None] + flow[:, 0]
    y = gy[None] + flow[:, 1]
    grid = torch.stack([2 * x / (W - 1) - 1, 2 * y / (H - 1) - 1], dim=-1)
    return tF.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                          align_corners=True)


class _TorchIFNetHDv3(tnn.Module):
    """Minimal re-typing of the upstream v3.6 forward (IFNet_HDv3.py:84-110)."""

    def __init__(self, c=12):
        super().__init__()
        for b in range(3):
            setattr(self, f"block{b}", _TorchIFBlock(11, c=c))

    def forward(self, img0, img1, scales=(4, 2, 1)):
        flow = torch.zeros(img0.shape[0], 4, *img0.shape[2:])
        mask = torch.zeros(img0.shape[0], 1, *img0.shape[2:])
        w0, w1 = img0, img1
        for i in range(3):
            blk = getattr(self, f"block{i}")
            f0, m0 = blk(torch.cat((w0, w1, mask), 1), flow, scales[i])
            f1, m1 = blk(torch.cat((w1, w0, -mask), 1),
                         torch.cat((flow[:, 2:4], flow[:, :2]), 1), scales[i])
            flow = flow + (f0 + torch.cat((f1[:, 2:4], f1[:, :2]), 1)) / 2
            mask = mask + (m0 + (-m1)) / 2
            w0 = _torch_warp(img0, flow[:, :2])
            w1 = _torch_warp(img1, flow[:, 2:4])
        s = torch.sigmoid(mask)
        return flow, w0 * s + w1 * (1 - s)


# ---- the upstream torch harness (tests/test_hd_legacy_import.py) -----------------


_twarp = _torch_warp


def _interp(x, factor):
    return tF.interpolate(x, scale_factor=factor, mode="bilinear",
                          align_corners=False)


def _conv_bn(i, o, k=3, s=1, p=1):
    return tnn.Sequential(tnn.Conv2d(i, o, k, s, p, bias=False),
                          tnn.BatchNorm2d(o), tnn.PReLU(o))


def _conv_bn_wo(i, o, k=3, s=1, p=1):
    return tnn.Sequential(tnn.Conv2d(i, o, k, s, p, bias=False),
                          tnn.BatchNorm2d(o))


def _conv_b(i, o, k=3, s=1, p=1):
    return tnn.Sequential(tnn.Conv2d(i, o, k, s, p, bias=True), tnn.PReLU(o))


class _TResV1(tnn.Module):  # IFNet_HD.ResBlock (BN, k5)
    def __init__(self, i, o, stride=1):
        super().__init__()
        self.conv0 = (tnn.Identity() if i == o and stride == 1
                      else tnn.Conv2d(i, o, 3, stride, 1, bias=False))
        self.conv1 = _conv_bn(i, o, 5, stride, 2)
        self.conv2 = _conv_bn_wo(o, o, 3, 1, 1)
        self.relu1 = tnn.PReLU(1)
        self.relu2 = tnn.PReLU(o)
        self.fc1 = tnn.Conv2d(o, 16, 1, bias=False)
        self.fc2 = tnn.Conv2d(16, o, 1, bias=False)

    def forward(self, x):
        y = self.conv0(x)
        x = self.conv2(self.conv1(x))
        w = x.mean(3, True).mean(2, True)
        w = torch.sigmoid(self.fc2(self.relu1(self.fc1(w))))
        return self.relu2(x * w + y)


class _TResHD(tnn.Module):  # RIFE_HD.ResBlock (bias convs, k3)
    def __init__(self, i, o, stride=2):
        super().__init__()
        self.conv0 = (tnn.Identity() if i == o and stride == 1
                      else tnn.Conv2d(i, o, 3, stride, 1, bias=False))
        self.conv1 = _conv_b(i, o, 3, stride, 1)
        self.conv2 = tnn.Sequential(tnn.Conv2d(o, o, 3, 1, 1, bias=True))
        self.relu1 = tnn.PReLU(1)
        self.relu2 = tnn.PReLU(o)
        self.fc1 = tnn.Conv2d(o, 16, 1, bias=False)
        self.fc2 = tnn.Conv2d(16, o, 1, bias=False)

    forward = _TResV1.forward


class _TIFBlockV1(tnn.Module):
    def __init__(self, i, scale, c):
        super().__init__()
        self.scale = scale
        self.conv0 = _conv_bn(i, c, 5, 2, 2)
        for r in range(6):
            setattr(self, f"res{r}", _TResV1(c, c))
        self.conv1 = tnn.Conv2d(c, 8, 3, 1, 1)
        self.up = tnn.PixelShuffle(2)

    def forward(self, x):
        if self.scale != 1:
            x = _interp(x, 1.0 / self.scale)
        x = self.conv0(x)
        for r in range(6):
            x = getattr(self, f"res{r}")(x)
        flow = self.up(self.conv1(x))
        if self.scale != 1:
            flow = _interp(flow, self.scale)
        return flow


class _TIFNetV1(tnn.Module):
    def __init__(self, cs):
        super().__init__()
        self.block0 = _TIFBlockV1(6, 8, cs[0])
        self.block1 = _TIFBlockV1(8, 4, cs[1])
        self.block2 = _TIFBlockV1(8, 2, cs[2])
        self.block3 = _TIFBlockV1(8, 1, cs[3])

    def forward(self, x, scale=1.0):
        x = _interp(x, 0.5 * scale)
        flow0 = self.block0(x)
        F1 = flow0
        w0, w1 = _twarp(x[:, :3], F1), _twarp(x[:, 3:], -F1)
        flow1 = self.block1(torch.cat((w0, w1, F1), 1))
        F2 = flow0 + flow1
        w0, w1 = _twarp(x[:, :3], F2), _twarp(x[:, 3:], -F2)
        flow2 = self.block2(torch.cat((w0, w1, F2), 1))
        F3 = F2 + flow2
        w0, w1 = _twarp(x[:, :3], F3), _twarp(x[:, 3:], -F3)
        flow3 = self.block3(torch.cat((w0, w1, F3), 1))
        F4 = F3 + flow3
        if scale != 1.0:
            F4 = _interp(F4, 1.0 / scale) / scale
        return F4


class _TContextV1(tnn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv0 = _conv_b(3, c, 3, 2, 1)
        self.conv1 = _TResHD(c, c)
        self.conv2 = _TResHD(c, 2 * c)
        self.conv3 = _TResHD(2 * c, 4 * c)
        self.conv4 = _TResHD(4 * c, 8 * c)

    def forward(self, x, flow):
        x = self.conv0(x)
        feats = []
        for i in range(1, 5):
            x = getattr(self, f"conv{i}")(x)
            flow = _interp(flow, 0.5) * 0.5
            feats.append(_twarp(x, flow))
        return feats


class _TFusionV1(tnn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv0 = _conv_b(8, c, 3, 2, 1)
        self.down0 = _TResHD(c, 2 * c)
        self.down1 = _TResHD(4 * c, 4 * c)
        self.down2 = _TResHD(8 * c, 8 * c)
        self.down3 = _TResHD(16 * c, 16 * c)
        self.up0 = tnn.Sequential(tnn.ConvTranspose2d(32 * c, 8 * c, 4, 2, 1),
                                  tnn.PReLU(8 * c))
        self.up1 = tnn.Sequential(tnn.ConvTranspose2d(16 * c, 4 * c, 4, 2, 1),
                                  tnn.PReLU(4 * c))
        self.up2 = tnn.Sequential(tnn.ConvTranspose2d(8 * c, 2 * c, 4, 2, 1),
                                  tnn.PReLU(2 * c))
        self.up3 = tnn.Sequential(tnn.ConvTranspose2d(4 * c, c, 4, 2, 1),
                                  tnn.PReLU(c))
        self.conv = tnn.Conv2d(c, 16, 3, 1, 1)
        self.up4 = tnn.PixelShuffle(2)

    def forward(self, img0, img1, flow, c0, c1):
        w0, w1 = _twarp(img0, flow), _twarp(img1, -flow)
        x = self.conv0(torch.cat((w0, w1, flow), 1))
        s0 = self.down0(x)
        s1 = self.down1(torch.cat((s0, c0[0], c1[0]), 1))
        s2 = self.down2(torch.cat((s1, c0[1], c1[1]), 1))
        s3 = self.down3(torch.cat((s2, c0[2], c1[2]), 1))
        x = self.up0(torch.cat((s3, c0[3], c1[3]), 1))
        x = self.up1(torch.cat((x, s2), 1))
        x = self.up2(torch.cat((x, s1), 1))
        x = self.up3(torch.cat((x, s0), 1))
        return self.up4(self.conv(x)), w0, w1


class _TConv2(tnn.Module):
    def __init__(self, i, o, stride=2):
        super().__init__()
        self.conv1 = _conv_b(i, o, 3, stride, 1)
        self.conv2 = _conv_b(o, o, 3, 1, 1)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class _TIFBlockV2(tnn.Module):
    def __init__(self, i, scale, c):
        super().__init__()
        self.scale = scale
        self.conv0 = tnn.Sequential(_conv_b(i, c, 3, 2, 1),
                                    _conv_b(c, 2 * c, 3, 2, 1))
        self.convblock = tnn.Sequential(*[_conv_b(2 * c, 2 * c) for _ in range(6)])
        self.conv1 = tnn.ConvTranspose2d(2 * c, 4, 4, 2, 1)

    def forward(self, x):
        if self.scale != 1:
            x = _interp(x, 1.0 / self.scale)
        x = self.conv1(self.convblock(self.conv0(x)))
        if self.scale != 1:
            x = _interp(x, self.scale)
        return x


class _TIFNetV2(tnn.Module):
    def __init__(self, cs):
        super().__init__()
        self.block0 = _TIFBlockV2(6, 8, cs[0])
        self.block1 = _TIFBlockV2(10, 4, cs[1])
        self.block2 = _TIFBlockV2(10, 2, cs[2])
        self.block3 = _TIFBlockV2(10, 1, cs[3])

    def forward(self, x, scale=1.0):
        if scale != 1.0:
            x = _interp(x, scale)
        flow = self.block0(x)
        for i in range(1, 4):
            large = _interp(flow, 2.0) * 2.0
            w0 = _twarp(x[:, :3], large[:, :2])
            w1 = _twarp(x[:, 3:], large[:, 2:4])
            flow = flow + getattr(self, f"block{i}")(
                torch.cat((w0, w1, large), 1))
        if scale != 1.0:
            flow = _interp(flow, 1.0 / scale) / scale
        return flow


class _TContextV2(tnn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv0 = _TConv2(3, c)
        self.conv1 = _TConv2(c, c)
        self.conv2 = _TConv2(c, 2 * c)
        self.conv3 = _TConv2(2 * c, 4 * c)
        self.conv4 = _TConv2(4 * c, 8 * c)

    forward = _TContextV1.forward


class _TFusionV2(tnn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv0 = _TConv2(10, c)
        self.down0 = _TConv2(c, 2 * c)
        self.down1 = _TConv2(4 * c, 4 * c)
        self.down2 = _TConv2(8 * c, 8 * c)
        self.down3 = _TConv2(16 * c, 16 * c)
        self.up0 = tnn.Sequential(tnn.ConvTranspose2d(32 * c, 8 * c, 4, 2, 1),
                                  tnn.PReLU(8 * c))
        self.up1 = tnn.Sequential(tnn.ConvTranspose2d(16 * c, 4 * c, 4, 2, 1),
                                  tnn.PReLU(4 * c))
        self.up2 = tnn.Sequential(tnn.ConvTranspose2d(8 * c, 2 * c, 4, 2, 1),
                                  tnn.PReLU(2 * c))
        self.up3 = tnn.Sequential(tnn.ConvTranspose2d(4 * c, c, 4, 2, 1),
                                  tnn.PReLU(c))
        self.conv = tnn.ConvTranspose2d(c, 4, 4, 2, 1)

    def forward(self, img0, img1, flow, c0, c1):
        w0, w1 = _twarp(img0, flow[:, :2]), _twarp(img1, flow[:, 2:4])
        x = self.conv0(torch.cat((w0, w1, flow), 1))
        s0 = self.down0(x)
        s1 = self.down1(torch.cat((s0, c0[0], c1[0]), 1))
        s2 = self.down2(torch.cat((s1, c0[1], c1[1]), 1))
        s3 = self.down3(torch.cat((s2, c0[2], c1[2]), 1))
        x = self.up0(torch.cat((s3, c0[3], c1[3]), 1))
        x = self.up1(torch.cat((x, s2), 1))
        x = self.up2(torch.cat((x, s1), 1))
        x = self.up3(torch.cat((x, s0), 1))
        return self.conv(x), w0, w1


def _randomize_bn(module):
    for m in module.modules():
        if isinstance(m, tnn.BatchNorm2d):
            with torch.no_grad():
                m.running_mean.normal_(0, 0.3)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.normal_(1.0, 0.2)
                m.bias.normal_(0, 0.2)


def _torch_predict(version, ctx, fus, img0, img1, flow):
    if version == 1:
        c0, c1 = ctx(img0, flow), ctx(img1, -flow)
    else:
        c0, c1 = ctx(img0, flow[:, :2]), ctx(img1, flow[:, 2:4])
    flow = _interp(flow, 2.0) * 2.0
    out, w0, w1 = fus(img0, img1, flow, c0, c1)
    res = torch.sigmoid(out[:, :3]) * 2 - 1
    mask = torch.sigmoid(out[:, 3:4])
    return torch.clamp(w0 * mask + w1 * (1 - mask) + res, 0, 1)


CS = (16, 12, 10, 8)
CF = 8


# ---- helpers ---------------------------------------------------------------------


def _save_legacy(tmp_path, version, seed, cs=CS, cf=CF):
    """A random harness trio in the upstream layout; returns the harness."""
    torch.manual_seed(seed)
    tflow = (_TIFNetV1 if version == 1 else _TIFNetV2)(cs)
    tctx = (_TContextV1 if version == 1 else _TContextV2)(cf)
    tfus = (_TFusionV1 if version == 1 else _TFusionV2)(cf)
    for m in (tflow, tctx, tfus):
        _randomize_bn(m)
        m.eval()
    torch.save(tflow.state_dict(), tmp_path / "flownet.pkl")
    torch.save(tctx.state_dict(), tmp_path / "contextnet.pkl")
    torch.save(tfus.state_dict(), tmp_path / "unet.pkl")
    return tflow, tctx, tfus


def _save_hdv3(tmp_path, seed, c=12):
    torch.manual_seed(seed)
    tnet = _TorchIFNetHDv3(c=c).eval()
    torch.save(tnet.state_dict(), tmp_path / "flownet.pkl")
    return tnet


def _rgb_pair(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=shape).astype(np.float32) for _ in range(2)]


def _nhwc(x):
    return np.asarray(x).transpose(0, 2, 3, 1)


@pytest.fixture
def count_warps(monkeypatch):
    """The warps each call hands ``warp2d`` (the kernel's launches on the card)."""
    calls = []
    original = kernels_warp.warp2d_plain

    def spy(img, flow, r, padding):
        calls.append((tuple(img.shape), r, padding))
        return original(img, flow, r, padding)

    monkeypatch.setattr(kernels_warp, "warp2d_plain", spy)
    return calls


# ---- HDv3 --------------------------------------------------------------------------


def test_hdv3_block_matches_the_upstream_block(tmp_path):
    """One loaded block against the harness block (2e-4, the reference's):
    the flow goes in and comes out row-major, the harness's (dx, dy)."""
    torch.manual_seed(0)
    tb = _TorchIFBlock(11, c=12).eval()
    state = {}
    for b in range(3):
        state.update({f"module.block{b}.{k}": v.clone() for k, v in tb.state_dict().items()})
    torch.save(state, tmp_path / "flownet.pkl")
    block = load_torch_rife_hdv3(str(tmp_path / "flownet.pkl")).block0

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 7, 32, 32)).astype(np.float32))
    fl = torch.from_numpy(rng.normal(size=(1, 4, 32, 32)).astype(np.float32))
    perm = [1, 0, 3, 2]
    with torch.no_grad():
        want_f, want_m = tb(x, fl, scale=1)
        got_f, got_m = block(x, fl[:, perm], 1)
        np.testing.assert_allclose(got_f[:, perm].numpy(), want_f.numpy(), atol=2e-4)
        np.testing.assert_allclose(got_m.numpy(), want_m.numpy(), atol=2e-4)
        # at scale 2 too: the flow's values rescale per axis
        want_f, want_m = tb(x, fl, scale=2)
        got_f, got_m = block(x, fl[:, perm], 2)
    np.testing.assert_allclose(got_f[:, perm].numpy(), want_f.numpy(), atol=2e-4)
    np.testing.assert_allclose(got_m.numpy(), want_m.numpy(), atol=2e-4)


def test_hdv3_network_matches_the_upstream_network_and_jax(tmp_path, count_warps):
    """The port and the JAX package load the same ``flownet.pkl``: 1e-4
    between them, 5e-4 (the reference's) against the harness; 6 warps a pair."""
    tnet = _save_hdv3(tmp_path, seed=7)
    path = str(tmp_path / "flownet.pkl")
    net = load_torch_rife_hdv3(path)
    i0, i1 = _rgb_pair(3, (2, 3, 32, 48))
    with torch.no_grad():
        t_flow, t_merged = tnet(torch.from_numpy(i0), torch.from_numpy(i1))
        out = net(torch.from_numpy(i0), torch.from_numpy(i1))
    assert len(count_warps) == 6
    assert all(r == 0 and p == "border" for _, r, p in count_warps)
    perm = [1, 0, 3, 2]
    np.testing.assert_allclose(out["flow_list"][-1][:, perm].numpy(), t_flow.numpy(), atol=5e-4)
    np.testing.assert_allclose(out["merged"][-1].numpy(), t_merged.numpy(), atol=5e-4)

    jout = jax.jit(JaxIFNetHDv3(c=12).apply)(jax_load_hdv3(path), _nhwc(i0), _nhwc(i1))
    for key in ("flow_list", "merged"):
        for o, r in zip(out[key], jout[key]):
            np.testing.assert_allclose(_nhwc(o), np.asarray(r), atol=TOL, err_msg=key)
    np.testing.assert_allclose(_nhwc(out["mask"]), np.asarray(jout["mask"]), atol=TOL)


def test_hdv3_loader_drops_the_teacher_and_refuses_unknown_keys(tmp_path):
    torch.manual_seed(1)
    state = {}
    for b in range(3):
        blk = _TorchIFBlock(11, c=12)
        state.update({f"block{b}.{k}": v for k, v in blk.state_dict().items()})
    state.update({f"block_tea.{k}": v for k, v in _TorchIFBlock(14, c=12).state_dict().items()})
    torch.save(state, tmp_path / "flownet.pkl")
    net = load_torch_rife_hdv3(str(tmp_path / "flownet.pkl"))
    assert not any(k.startswith("block_tea") for k in net.state_dict())
    assert net.block0.conv0[1][0].out_channels == 12 and not net.training

    state["block0.mystery.weight"] = torch.zeros(3)
    torch.save(state, tmp_path / "flownet.pkl")
    with pytest.raises(RuntimeError, match="mystery"):
        load_torch_rife_hdv3(str(tmp_path / "flownet.pkl"))


# ---- HD v1 / v2 ----------------------------------------------------------------


@pytest.mark.parametrize("version", [1, 2])
def test_legacy_pipeline_matches_upstream_and_jax(tmp_path, version, count_warps):
    """flownet + contextnet + fusionnet from the same trio: the port against
    the harness (2e-3, the reference's) and against the JAX package (1e-4);
    16 warps a pair."""
    tflow, tctx, tfus = _save_legacy(tmp_path, version, seed=version)
    model = load_torch_rife_hd_legacy(str(tmp_path), version)
    i0, i1 = _rgb_pair(version, (1, 3, 64, 64))
    t0, t1 = torch.from_numpy(i0), torch.from_numpy(i1)
    with torch.no_grad():
        t_half_flow = tflow(torch.cat((t0, t1), 1))
        t_pred = _torch_predict(version, tctx, tfus, t0, t1, t_half_flow)
        pred, flow, mask = model.inference(t0, t1)
    assert len(count_warps) == 16
    assert sorted({s[1] for s, _, _ in count_warps}) == sorted({3, CF, 2 * CF, 4 * CF, 8 * CF})
    np.testing.assert_allclose(pred.numpy(), t_pred.numpy(), atol=2e-3)
    perm = [1, 0] if version == 1 else [1, 0, 3, 2]
    t_full = (_interp(t_half_flow, 2.0) * 2.0).numpy()
    np.testing.assert_allclose(flow[:, perm].numpy(), t_full, atol=2e-3)

    jmodel = JaxRIFEHDLegacy(version=version, c_fusion=CF, cs=CS)
    jpred, jflow, jmask = jax.jit(jmodel.inference)(jax_load_legacy(str(tmp_path), version),
                                                    _nhwc(i0), _nhwc(i1))
    for name, got, want in (("pred", pred, jpred), ("flow", flow, jflow), ("mask", mask, jmask)):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=TOL, err_msg=name)


def test_legacy_loader_refuses_the_wrong_version(tmp_path):
    _save_legacy(tmp_path, 2, seed=4)
    with pytest.raises(ValueError, match="v2"):
        load_torch_rife_hd_legacy(str(tmp_path), version=1)


def test_legacy_init_draws_from_its_seed():
    a = RIFEHDLegacy(1, CF, CS).init(3)
    b = RIFEHDLegacy(1, CF, CS).init(3)
    c = RIFEHDLegacy(1, CF, CS).init(4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["fusionnet.conv.weight"], sc["fusionnet.conv.weight"])
    assert float(sa["flownet.block0.conv0.1.running_var"].min()) >= 0.5


# ---- load_pretrained_zoo and ZooInterpolator --------------------------------------


@pytest.mark.parametrize("kind", ["hdv1", "hdv2", "hdv3"])
def test_load_pretrained_zoo_detects_the_kind_and_its_widths(tmp_path, kind):
    if kind == "hdv3":
        _save_hdv3(tmp_path, seed=2, c=20)
    else:
        _save_legacy(tmp_path, int(kind[-1]), seed=2, cs=(24, 16, 12, 8), cf=12)
    zoo = load_pretrained_zoo(str(tmp_path), device="cpu")
    assert zoo.kind == kind and zoo.device.type == "cpu"
    if kind == "hdv3":
        assert zoo.pad_multiple == 32
        assert zoo.model.block2.conv0[1][0].out_channels == 20
    else:
        assert zoo.pad_multiple == 64 and zoo.model.version == int(kind[-1])
        first = "conv0.0" if kind == "hdv1" else "conv0.0.0"
        assert [zoo.model.flownet.get_submodule(f"block{i}.{first}").out_channels
                for i in range(4)] == [24, 16, 12, 8]
        assert zoo.model.fusionnet.conv.in_channels == 12


@pytest.mark.parametrize("kind", ["hdv2", "hdv3"])
def test_zoo_pair_matches_jax_on_the_same_checkpoint(tmp_path, kind):
    """``ZooInterpolator.pair`` against the JAX package's on one checkpoint
    directory (HDv3 at the width the JAX loader builds, c = 90): mono frames
    tiled to RGB and averaged back, the crop of the padding, a full-resolution
    flow, and the midpoint-only refusal."""
    if kind == "hdv3":
        _save_hdv3(tmp_path, seed=5, c=90)
    else:
        _save_legacy(tmp_path, 2, seed=5)
    zoo = load_pretrained_zoo(str(tmp_path), device="cpu")
    jzoo = jinf.load_pretrained_zoo(str(tmp_path))
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(1, 60, 60, 1)).astype(np.float32)  # pads to 64
    b = rng.uniform(size=(1, 60, 60, 1)).astype(np.float32)
    pred, flow, mask = zoo.pair(a, b)
    jpred, jflow, jmask = jzoo.pair(a, b)
    assert pred.shape == (1, 60, 60, 1) and flow.shape == (1, 60, 60, 4)
    assert mask.shape == (1, 60, 60, 1)
    for name, got, want in (("pred", pred, jpred), ("flow", flow, jflow), ("mask", mask, jmask)):
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=name)
    # a mono frame is the mean of the RGB prediction of the tiled frame
    rgb, _, _ = zoo.pair(np.repeat(a, 3, -1), np.repeat(b, 3, -1))
    np.testing.assert_allclose(pred, rgb.mean(-1, keepdims=True), atol=1e-6)
    with pytest.raises(ValueError, match="midpoint"):
        zoo.pair(a, b, timestep=0.25)


def test_zoo_interpolator_serves_a_series(tmp_path):
    _save_legacy(tmp_path, 1, seed=6)
    zoo = load_pretrained_zoo(str(tmp_path), device="cpu")
    frames = np.random.default_rng(1).uniform(size=(5, 40, 40, 1)).astype(np.float32)
    recon, flows = interpolate_series(zoo, frames, 2, collect_flow=True)
    assert recon.shape == (5, 40, 40, 1) and np.isfinite(recon).all()
    assert flows.shape == (2, 40, 40, 2)
    np.testing.assert_array_equal(recon[::2], frames[::2])
    with pytest.raises(ValueError, match="kind"):
        ZooInterpolator("hdv4", zoo.model, 64, device="cpu")


def test_inference_img_and_video_with_zoo_dir(tmp_path, capsys):
    """``inference_img --cpu --zoo_dir`` writes its frames, and
    ``inference_video --cpu --zoo_dir`` reports its factors, with no
    framework checkpoint anywhere."""
    zoo_dir = tmp_path / "zoo"
    zoo_dir.mkdir()
    _save_hdv3(zoo_dir, seed=8)
    rng = np.random.default_rng(0)
    for name in ("a", "b"):
        np.save(tmp_path / f"{name}.npy", rng.uniform(0, 1, (40, 48)).astype(np.float32))
    out = tmp_path / "out"
    cli(["inference_img", "--cpu", "--zoo_dir", str(zoo_dir), "--img0", str(tmp_path / "a.npy"),
         "--img1", str(tmp_path / "b.npy"), "--out_dir", str(out), "--n_exp", "2"])
    assert sorted(p.name for p in out.iterdir()) == [f"img{i}.png" for i in range(5)]
    assert "No checkpoint" not in capsys.readouterr().out

    data = str(tmp_path / "d")
    cli(["generate", "--dataset", "rectangle2d", "--frames", "30", "--data_dir", data])
    cli(["inference_video", "--cpu", "--zoo_dir", str(zoo_dir), "--dataset", "rectangle2d",
         "--data_dir", data, "--results_dir", str(tmp_path / "r"), "--factors", "2,4",
         "--max_frames", "9"])
    text = capsys.readouterr().out
    assert "factor 2x" in text and "factor 4x" in text and "No checkpoint" not in text


def test_zoo_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """The zoo and the perceptual loss's params run on the GPU unless asked
    for the CPU."""
    from opticalflowscivis_tpu_torch.losses.perceptual import init_params

    _save_hdv3(tmp_path, seed=9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_pretrained_zoo(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params()
    assert load_pretrained_zoo(str(tmp_path), device="cpu").device.type == "cpu"
