"""Plain float32 reference of UPFlow, its unsupervised losses and AdamW.

Written from the published equations (Luo et al., "UPFlow: Upsampling
Pyramid for Unsupervised Optical Flow Learning", CVPR 2021,
arXiv:2012.00212; the authors' code, github.com/coolbeam/UPFlow_pytorch:
``model/upflow.py``, ``model/pwc_modules.py``, ``utils/loss.py``,
``utils/tools.py``):

- a PWC pyramid of stride-2 and stride-1 3x3 convolutions with
  LeakyReLU(0.1) (channels ``num_chs``), coarsest level first;
- coarse-to-fine decoding of the ``output_level + 1`` coarsest levels, each
  direction on its own (the program stacks the two along the batch axis:
  every operation is per sample, so the numbers are the same): the flow
  upsampled x2 (endpoint-aligned, values rescaled), refined by SGU, the
  target features warped by it (zeros outside, times the validity mask),
  both feature maps normalised by their own per-image, per-channel moments,
  a (2 md + 1)^2 cost volume (the channel mean of the products), LeakyReLU,
  the dense estimator (each layer's output put before its input) and the
  dilated context network, each adding a residual to the flow;
- SGU: the coarse flow upsampled, the target guidance warped by it, a small
  dense estimator giving an interpolation flow and a blend mask; the
  upsampled flow resampled at the interpolation flow (border) and blended;
  at full resolution on guidance features from four convolutions of the
  frames;
- the loss block: the forward-backward occlusion check, an abs-robust
  photometric term through boundary-dilated warping, the census term,
  edge-aware first-order smoothness on the final flows and the pyramid
  distillation (``upup``, occlusion-masked) of the detached final flows into
  every level;
- AdamW (``ifnet.AdamW``) at a constant learning rate.

Departures from the published code, as the program pins them:

- boundary-dilated warping samples a fixed window of ``rho`` pixels around
  each crop (``im1_raw``, ``im2_raw``, the crop at ``start``) and clamps at
  the window's border, where the published code samples the whole uncropped
  image;
- the validity mask of a feature warp is the warped ones ``> 0.9999``
  compared in float32 (the published code compares in the features' type,
  where in bfloat16 the threshold rounds to 1 and nothing is valid);
- an endpoint-aligned resize from an axis of size 1 keeps the value at
  index 0 and zero beyond, and one to size 1 gives zero (what
  ``jax.image.scale_and_translate`` computes, which the JAX package follows);
- the census term without an occlusion mask divides the batch's sum by one
  image's area, as the published ``census_loss_torch`` does;
- with ``across_images`` the shared normalisation's variance is the
  variance of the two variances, as the published ``normalize_features``
  computes it.

Tensors are channels-first: frames ``[B, 3, H, W]``, flows ``[B, 2, H, W]``
in row-major (dy, dx).  Parameters carry the program's names
(``UPFlowNet``'s), so one seeded state dict loads into both.  Nothing here
imports the program or JAX.

The frames enter the network as the configuration's compute type holds them
(``bfloat16``: rounded to bfloat16 at the entry); the losses read the
float32 frames.  ``precision="fp8"`` is the control: every convolution on
float8 e4m3 operands (``ifnet.fp8_round``; the output gradient rounded too)
and every tensor the program holds in its compute type after the entry (the
feature maps, the warped and normalised features, the cost volume, the
estimators' outputs, SGU's mask) rounded to e4m3; the flows, the warps'
coordinates and the losses stay float32, as in the program.

``record`` collects each call that the program sends to a kernel: the
warps (``site``, ``shape``, the image's and the flow's element bytes,
``mask``, ``image_grad``, and ``backward`` once autograd's backward reached
it) and the cost volumes (``site``, ``shape``, ``grads``: how many of the
two feature maps take a gradient, ``backward``).  The photometric gathers
take no kernel and are not recorded.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.ifnet import AdamW, _Fp8Grad, fp8_round

DILATIONS = (1, 2, 4, 8, 16, 1)


class ConvLeaky(nn.Module):
    def __init__(self, cin, cout, kernel=3, stride=1, dilation=1, relu=True, device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, dilation * (kernel - 1) // 2, dilation,
                              device=device)
        self.relu = relu


class Stack(nn.Module):
    """A list of ``ConvLeaky`` under the program's name ``convs``."""

    def __init__(self, convs):
        super().__init__()
        self.convs = nn.ModuleList(convs)


def dense(cin, f_channels, out, device=None) -> tuple[Stack, int]:
    """The dense estimator: each layer reads all before it; a linear head."""
    convs = []
    for f in f_channels:
        convs.append(ConvLeaky(cin, f, device=device))
        cin += f
    convs.append(ConvLeaky(cin, out, relu=False, device=device))
    return Stack(convs), cin


class SGU(nn.Module):
    def __init__(self, feat_channels=32, device=None):
        super().__init__()
        self.dense_estimator_mask, _ = dense(2 * feat_channels, (32, 32, 32, 16, 8), 3, device)


class _Mark(torch.autograd.Function):
    """The identity; its backward marks a recorded call as reached."""

    @staticmethod
    def forward(ctx, x, call):
        ctx.call = call
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.call["backward"] = True
        return g, None


class RefUPFlow(nn.Module):
    """UPFlow from a configuration's ``model`` group (``UPFlowConfig``'s
    fields); ``bfloat16``: the frames enter rounded to bfloat16, and the
    recorded warps' and cost volumes' feature maps are counted at 2 bytes."""

    def __init__(self, model: dict, device=None, precision: str | None = None,
                 bfloat16: bool = False):
        super().__init__()
        if precision not in (None, "fp8"):
            raise ValueError(f"precision is None (float32) or 'fp8', got {precision!r}")
        self.cfg = model
        self.precision = precision
        self.bfloat16 = bfloat16
        self.record: list | None = None
        chs = tuple(model["num_chs"])
        self.n_levels = model["output_level"] + 1
        convs = []
        for cin, cout in zip(chs[:-1], chs[1:]):
            convs += [ConvLeaky(cin, cout, stride=2, device=device),
                      ConvLeaky(cout, cout, device=device)]
        self.feature_extractor = Stack(convs)
        self.conv_1x1 = nn.ModuleList([ConvLeaky(ch, 32, kernel=1, device=device)
                                       for ch in chs[::-1][: self.n_levels]])
        corr = (2 * model["search_range"] + 1) ** 2
        self.flow_estimators, feat = dense(corr + 32 + 2, model["estimator_f_channels"], 2,
                                           device)
        ctx = tuple(model["context_f_channels"])
        convs, cin = [], feat + 2
        for f, d in zip(ctx[:-1], DILATIONS):
            convs.append(ConvLeaky(cin, f, dilation=d, device=device))
            cin = f
        convs.append(ConvLeaky(cin, ctx[-1], relu=False, device=device))
        self.context_networks = Stack(convs)
        self.sgu_on = bool(model["if_sgu_upsample"])
        if self.sgu_on:
            self.sgi_model = SGU(device=device)
            self.sgu_output_conv = Stack([
                ConvLeaky(chs[0], 16, device=device), ConvLeaky(16, 16, stride=2, device=device),
                ConvLeaky(16, 32, device=device), ConvLeaky(32, 32, stride=2, device=device)])

    # -- layers -------------------------------------------------------------------
    def _r(self, t):
        """A tensor as the program's compute type holds it: float32 here,
        e4m3 in the control."""
        return fp8_round(t) if self.precision == "fp8" else t

    def conv(self, m: ConvLeaky, x):
        c = m.conv
        if self.precision is None:
            y = F.conv2d(x, c.weight, c.bias, c.stride, c.padding, c.dilation)
        else:
            y = _Fp8Grad.apply(F.conv2d(fp8_round(x), fp8_round(c.weight), c.bias, c.stride,
                                        c.padding, c.dilation))
        return self._r(F.leaky_relu(y, 0.1) if m.relu else y)

    def dense(self, stack: Stack, x):
        for m in stack.convs[:-1]:
            x = torch.cat([self.conv(m, x), x], 1)
        return x, self.conv(stack.convs[-1], x)

    def _note(self, call: dict, out):
        """Record ``call``; its ``backward`` turns True when autograd reaches it."""
        if self.record is None:
            return out
        call["backward"] = False
        self.record.append(call)
        return _Mark.apply(out, call) if out.requires_grad else out

    def warp(self, img, flow, padding: str, site: str, masked: bool = False, feature=False):
        """``img`` sampled at (identity + ``flow``); ``masked``: times the
        validity mask (warped ones > 0.9999, zeros padding)."""
        h, w = img.shape[2:]
        ys = torch.arange(h, dtype=torch.float32, device=img.device).view(1, h, 1)
        xs = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w)
        out, weight = sample(img, ys + flow[:, 0], xs + flow[:, 1], padding)
        if masked:
            out = out * (weight > 0.9999).float()
        call = {"site": site, "shape": list(img.shape),
                "image_bytes": 2 if feature and self.bfloat16 else 4, "flow_bytes": 4,
                "mask": masked, "image_grad": img.requires_grad}
        return self._note(call, out)

    def cost_volume(self, f1, f2, site: str):
        md = self.cfg["search_range"]
        h, w = f1.shape[2:]
        f2p = F.pad(f2, (md, md, md, md))
        out = torch.stack([(f1 * f2p[:, :, dy:dy + h, dx:dx + w]).mean(1)
                           for dy in range(2 * md + 1) for dx in range(2 * md + 1)], 1)
        call = {"site": site, "shape": list(f1.shape), "bytes": 2 if self.bfloat16 else 4,
                "grads": int(f1.requires_grad) + int(f2.requires_grad)}
        return self._note(call, out)

    def sgu(self, flow, f1, f2, site: str, full=None):
        """SGU on guidance ``f1`` / ``f2``; ``full``: the flow upsampled to
        the output's size, the one that is resampled then."""
        if flow.shape[2:] != f1.shape[2:]:
            flow = upsample_flow(flow, tuple(f1.shape[2:]))
        f2w = self._r(self.warp(f2, flow, "zeros", f"{site}.sgu.mask", masked=True,
                                feature=True))
        _, out = self.dense(self.sgi_model.dense_estimator_mask, torch.cat([f1, f2w], 1))
        inter_flow, inter_mask = out[:, :2], self._r(torch.sigmoid(out[:, 2:3]))
        if full is not None:
            size = tuple(full.shape[2:])
            inter_flow = self._r(upsample_flow(inter_flow, size))
            inter_mask = self._r(resize(inter_mask, size))
            flow = full
        resampled = self.warp(flow, inter_flow, "border", f"{site}.sgu.flow")
        return resampled * (1 - inter_mask) + flow * inter_mask

    def decode(self, level: int, xa, xb, a1, b1, flow):
        up = flow if flow.shape[2:] == xa.shape[2:] else upsample_flow(flow, tuple(xa.shape[2:]))
        site = f"level{level}"
        if level == 0:
            xbw = xb
        else:
            if self.sgu_on:
                up = self.sgu(up, a1, b1, site)
            xbw = self._r(self.warp(xb, up, "zeros", f"{site}.feature", masked=True,
                                    feature=True))
        ca, cb = xa, xbw
        if self.cfg["if_norm_before_cost_volume"]:
            ca, cb = normalize(ca, cb, self.cfg["norm_moments_across_channels"],
                               self.cfg["norm_moments_across_images"])
            ca, cb = self._r(ca), self._r(cb)
        corr = self._r(F.leaky_relu(self.cost_volume(ca, cb, site), 0.1))
        feat, res = self.dense(self.flow_estimators, torch.cat([corr, a1, self._r(up)], 1))
        mid = up + res
        x = torch.cat([feat, self._r(mid)], 1)
        for m in self.context_networks.convs:
            x = self.conv(m, x)
        return mid + x

    # -- the network ----------------------------------------------------------------
    def pyramid(self, x):
        out = []
        convs = self.feature_extractor.convs
        for i in range(0, len(convs), 2):
            x = self.conv(convs[i + 1], self.conv(convs[i], x))
            out.append(x)
        return out[::-1]

    def forward(self, im1, im2) -> dict:
        if self.bfloat16:
            im1, im2 = (t.to(torch.bfloat16).float() for t in (im1, im2))
        p1, p2 = self.pyramid(im1), self.pyramid(im2)
        ff = im1.new_zeros((im1.shape[0], 2) + tuple(p1[0].shape[2:]))
        fb = torch.zeros_like(ff)
        flows = []
        for level in range(self.n_levels):
            a1 = self.conv(self.conv_1x1[level], p1[level])
            a2 = self.conv(self.conv_1x1[level], p2[level])
            ff = self.decode(level, p1[level], p2[level], a1, a2, ff)
            fb = self.decode(level, p2[level], p1[level], a2, a1, fb)
            flows.append((ff, fb))
        size = tuple(im1.shape[2:])
        ff_out, fb_out = upsample_flow(ff, size), upsample_flow(fb, size)
        if self.sgu_on:
            g1, g2 = im1, im2
            for m in self.sgu_output_conv.convs:
                g1, g2 = self.conv(m, g1), self.conv(m, g2)
            ff_out = self.sgu(ff, g1, g2, "final", full=ff_out)
            fb_out = self.sgu(fb, g2, g1, "final", full=fb_out)
        return {"flow_f": ff_out, "flow_b": fb_out, "flows": flows[::-1]}

    # -- the losses -----------------------------------------------------------------
    def occlusion(self, fa, fb, loss: dict):
        """1 where ``fa``'s pixel passes the forward-backward check."""
        fbw = self.warp(fb, fa, "zeros", "occ")
        sq = lambda t: (t * t).sum(1, keepdim=True)  # noqa: E731
        thresh = loss["occ_alpha_1"] * (sq(fa) + sq(fbw)) + loss["occ_alpha_2"]
        return (sq(fa + fbw) <= thresh).float()

    def losses(self, out: dict, im1, im2, raw, loss: dict):
        """``(total, parts)`` with the program's part names; ``raw``:
        ``(im1_raw, im2_raw, start)``, the frames' rho-dilated windows."""
        _check_loss(loss)
        ff, fb = out["flow_f"], out["flow_b"]
        occ_f, occ_b = self.occlusion(ff, fb, loss), self.occlusion(fb, ff, loss)
        zero = ff.new_zeros(())
        smooth = zero
        if loss["smooth_order_1_weight"] > 0:
            smooth = loss["smooth_order_1_weight"] * (edge_smoothness(im1, ff)
                                                      + edge_smoothness(im2, fb))
        im1_raw, im2_raw, start = raw
        w1 = dilated_warp(im2_raw, ff, start)
        w2 = dilated_warp(im1_raw, fb, start)
        occ = loss["photo_loss_use_occ"]
        photo = loss["photo_weight"] * (
            robust(im1, w1, occ_f if occ else None, loss["photo_loss_delta"])
            + robust(im2, w2, occ_b if occ else None, loss["photo_loss_delta"]))
        census_term = zero
        if loss["census_weight"] > 0:
            census_term = loss["census_weight"] * (census(im1, w1, occ_f if occ else None)
                                                   + census(im2, w2, occ_b if occ else None))
        msd = zero
        if loss["msd_weight"] > 0:
            lf, lb = ff.detach(), fb.detach()
            of, ob = (occ_f, occ_b) if loss["msd_use_occ"] else (None, None)
            size = tuple(ff.shape[2:])
            for sf, sb in out["flows"]:
                msd = (msd + robust(upsample_flow(sf, size), lf, of, 0.4)
                       + robust(upsample_flow(sb, size), lb, ob, 0.4))
            msd = loss["msd_weight"] * msd
        total = photo + smooth + census_term + msd
        return total, {"photo_loss": photo, "smooth_loss": smooth, "census_loss": census_term,
                       "msd_loss": msd, "occ_fw_mean": occ_f.mean(), "loss_total": total}


def _check_loss(loss: dict) -> None:
    if loss["photo_loss_type"] != "abs_robust" or loss["smooth_level"] != "final" \
            or loss["smooth_type"] != "edge" or loss["smooth_order_2_weight"] > 0 \
            or loss["msd_style"] != "upup":
        raise ValueError("the reference has the abs-robust photometric term, first-order "
                         "edge-aware smoothness at the final level and upup distillation only")


# -- the operations ---------------------------------------------------------------------


def sample(img, ys, xs, padding: str):
    """Bilinear samples of ``img [B, C, H, W]`` at ``ys``, ``xs [B, Ho, Wo]``
    and the weight that fell inside the image; ``border`` clamps each
    corner's index, ``zeros`` drops the corners outside."""
    b, c, h, w = img.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y0, xs - x0
    y0, x0 = y0.long(), x0.long()
    flat = img.reshape(b, c, h * w)
    out, inside = 0, 0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yi, xi = y0 + dy, x0 + dx
            ok = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).float()
            weight = wy * wx
            inside = inside + weight * ok
            if padding == "zeros":
                weight = weight * ok
            index = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, 1, -1)
            g = torch.gather(flat, 2, index.expand(b, c, -1)).reshape((b, c) + ys.shape[1:])
            out = out + g * weight.unsqueeze(1)
    return out, inside.unsqueeze(1)


def resize(x, size):
    """The endpoint-aligned bilinear resize, with the size-1 rules of the
    module docstring."""
    src = tuple(x.shape[2:])
    out = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
    if any(s > 1 and d == 1 for s, d in zip(src, size)):
        return torch.zeros_like(out)
    for axis, (s, d) in enumerate(zip(src, size)):
        if s == 1 and d > 1:
            keep = torch.zeros(d, dtype=out.dtype, device=out.device)
            keep[0] = 1
            shape = [1, 1, 1, 1]
            shape[2 + axis] = d
            out = out * keep.view(shape)
    return out


def upsample_flow(flow, size):
    """A flow resized to ``size`` with each component scaled by its axis's ratio."""
    src = tuple(flow.shape[2:])
    ratio = torch.tensor([size[0] / src[0], size[1] / src[1]], dtype=flow.dtype,
                         device=flow.device)
    return resize(flow, size) * ratio.view(1, 2, 1, 1)


def normalize(f1, f2, across_channels: bool, across_images: bool):
    dims = (1, 2, 3) if across_channels else (2, 3)
    stats = [(f.mean(dims, keepdim=True), f.var(dims, unbiased=False, keepdim=True))
             for f in (f1, f2)]
    if across_images:
        mean = (stats[0][0] + stats[1][0]) / 2
        var = torch.stack([stats[0][1], stats[1][1]]).var(0, unbiased=False)
        stats = [(mean, var)] * 2
    return tuple((f - m) / torch.sqrt(v + 1e-16) for f, (m, v) in zip((f1, f2), stats))


def dilated_warp(raw, flow, start):
    """Boundary-dilated warping: ``raw [B, C, H + 2 rho, W + 2 rho]`` sampled
    at (crop grid + ``start [B, 2]`` + ``flow``), clamped at its border."""
    h, w = flow.shape[2:]
    ys = torch.arange(h, dtype=torch.float32, device=flow.device).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.float32, device=flow.device).view(1, 1, w)
    st = start.float().view(-1, 2, 1, 1)
    return sample(raw, ys + st[:, 0] + flow[:, 0], xs + st[:, 1] + flow[:, 1], "border")[0]


def robust(x, y, mask, delta: float):
    """The abs-robust penalty ``(|x - y| + 0.01)^delta``: its mean, or its sum
    inside ``mask`` over the mask's area."""
    d = ((x - y).abs() + 0.01) ** delta
    if mask is None:
        return d.mean()
    return (d * mask).sum() / (mask.sum() + 1e-6)


def edge_smoothness(img, flow):
    """First-order flow gradients weighted by exp(-|image gradient|), both axes."""
    total = 0
    for axis in (2, 3):
        n = flow.shape[axis] - 1
        pg = flow.narrow(axis, 0, n) - flow.narrow(axis, 1, n)
        ig = img.narrow(axis, 0, n) - img.narrow(axis, 1, n)
        total = total + (pg.abs() * torch.exp(-ig.abs().mean(1, keepdim=True))).mean()
    return total


def _ternary(img, radius: int = 3):
    """The soft ternary transform of the channel mean over (2r + 1)^2 patches."""
    g = img.mean(1, keepdim=True)
    h, w = g.shape[2:]
    p = F.pad(g, (radius,) * 4)
    k = 2 * radius + 1
    t = torch.cat([p[:, :, i:i + h, j:j + w] for i in range(k) for j in range(k)], 1) - g
    return t / torch.sqrt(0.81 + t * t)


def census(a, b, mask=None):
    """The census term: the robust penalty of the soft Hamming distance of
    the ternary transforms inside the 1-pixel border (and ``mask``), over
    the area (one image's without a mask)."""
    d = (_ternary(a) - _ternary(b)) ** 2
    dist = ((d / (0.1 + d)).mean(1, keepdim=True).abs() + 0.01) ** 0.4
    h, w = a.shape[2:]
    valid = F.pad(a.new_ones((1, 1, h - 2, w - 2)), (1, 1, 1, 1))
    m = valid if mask is None else valid * mask
    return (dist * m).sum() / (m.sum() + 1e-6)


# -- the steps --------------------------------------------------------------------------


def channels_first(batch: dict, device, rows: int | None = None) -> dict:
    """A program batch (channels-last ``im1``, ``im2``, ``im1_raw``,
    ``im2_raw``, ``start``) channels-first on ``device``; ``rows``: the first
    rows alone."""
    return {k: (v[:rows].to(device) if k == "start" else v[:rows].to(device).movedim(-1, 1))
            for k, v in batch.items()}


def host_flows(out: dict) -> dict:
    """A forward's flows on the host in float32: ``final`` (``flow_f``,
    ``flow_b``) and ``levels`` (the decoded levels' pairs, finest first)."""
    pair = lambda f, b: (f.detach().float().cpu(), b.detach().float().cpu())  # noqa: E731
    return {"final": pair(out["flow_f"], out["flow_b"]),
            "levels": [pair(f, b) for f, b in out["flows"]]}


def train_steps(model: RefUPFlow, batches, config: dict) -> dict:
    """Training steps on ``batches`` (``channels_first`` dicts) at the
    configuration's ``optim`` group: ``losses`` (each step's total),
    ``grads`` (the first step's, ``{name: tensor}``), ``grads_unmasked`` (the
    first step's of the photometric, census and smoothness terms alone),
    ``params`` (after the steps), and the first forward's ``parts`` (floats)
    and ``flows`` (``host_flows``)."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    optim = config["optim"]
    if optim["lr_gamma"] != 1.0 or optim["grad_clip"]:
        raise ValueError("the reference's AdamW runs at a constant rate without a clip")
    opt = AdamW(params, optim["weight_decay"])
    out: dict = {"losses": []}
    for b in batches:
        fwd = model(b["im1"], b["im2"])
        total, parts = model.losses(fwd, b["im1"], b["im2"],
                                    (b["im1_raw"], b["im2_raw"], b["start"]), config["loss"])
        first = "grads" not in out
        if first:  # the terms through no hard mask: all but the distillation
            unmasked = parts["photo_loss"] + parts["census_loss"] + parts["smooth_loss"]
            out["grads_unmasked"] = dict(zip(names, torch.autograd.grad(unmasked, params,
                                                                         retain_graph=True)))
        grads = torch.autograd.grad(total, params)
        out["losses"].append(float(total.detach()))
        if first:
            out["grads"] = {n: g.clone() for n, g in zip(names, grads)}
            out["parts"] = {k: float(v.detach()) for k, v in parts.items()}
            out["flows"] = host_flows(fwd)
        del fwd
        opt.step(grads, optim["lr"])
        del grads
    out["params"] = {n: p.detach().clone() for n, p in zip(names, params)}
    return out
