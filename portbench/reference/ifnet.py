"""Plain float32 reference of RIFE's IFNet, its training losses and AdamW.

One parameterised file for 2-D frames and 3-D volumes, written from the
reference code's equations (Flow-2D/model/IFNet.py, Flow-3D/model/IFNet.py,
the RIFE losses) and from the semantics the port pins:

- an IFBlock is two stride-2 conv+PReLU (kernel 3 in 2-D, 4 in 3-D), four
  residual double 3-wide convs, and two heads (transposed conv k4 s2 p1 +
  PReLU, then a transposed conv to the flow's ``2 * ndim`` channels or the
  mask's one), around a linear half-pixel resize by ``scale``;
- the student blocks refine a flow (F_t->0, F_t->1) and a mask; after each
  block both frames are warped; the teacher block also sees the middle frame;
- warps sample at (identity + flow) with multilinear weights; ``border``
  clamps each corner index, ``zeros`` drops the corners outside; a bounded
  warp clips each flow component to +-r and passes no gradient at or beyond r.

Tensors are channels-first: ``[B, C, *S]``, flows ``[B, 2 * ndim, *S]``.
Nothing here imports the program: the benchmark hands this file the same
seeded state dict and inputs it hands the program, and this file works out
everything else again.

The inputs enter the network as the configuration's compute type holds them:
with ``bfloat16`` the frames are rounded to bfloat16 at the network's entry,
as the program casts them (its losses read the float32 frames, and so do
this file's); everything after the entry is float32.

``precision="fp8"`` is the control of the comparison, the step below the
program's bfloat16, and ``"fp8_conv"`` the part of it that a faster
convolution would tempt one to take alone.  Under both, every convolution
and transposed convolution runs on float8 e4m3 operands, each under one
scale a tensor: the input activation and the weight forward, and the
gradient of the output backward, so that the data and weight gradients are
products of e4m3 operands too.  Under ``"fp8"`` every tensor that the
program holds in its compute type after the entry (each layer's output, the
resized inputs, flows and masks, the warped and merged frames) is rounded to
e4m3 as well, with a straight-through gradient; the frames enter at the
configuration's type.  The arithmetic inside a layer, the warps'
coordinates and the losses stay float32, as they do in the program.

``record`` collects each warp call's shape, for the benchmark's own count of
the warps' bytes and operations.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F
from torch import nn

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_DECONV = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_MODE = {2: "bilinear", 3: "trilinear"}
_FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), back in ``x``'s dtype; the gradient passes straight through."""
    d = x.detach()
    scale = _FP8_MAX / d.abs().amax().clamp_min(1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).to(d.dtype) / scale
    return x + (q - d)


class _Fp8Grad(torch.autograd.Function):
    """The identity forward; the gradient rounded by ``fp8_round`` backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


class Slope(nn.Module):
    """Per-channel PReLU slope."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.slope = nn.Parameter(torch.full((channels,), 0.25, device=device))


class ConvAct(nn.Module):
    def __init__(self, cin, cout, ndim, kernel=3, stride=1, device=None):
        super().__init__()
        self.conv = _CONV[ndim](cin, cout, kernel, stride, (kernel - 1) // 2, device=device)
        self.prelu = Slope(cout, device)


class DeconvAct(nn.Module):
    def __init__(self, cin, cout, ndim, device=None):
        super().__init__()
        self.deconv = _DECONV[ndim](cin, cout, 4, 2, 1, device=device)
        self.prelu = Slope(cout, device)


class Res(nn.Module):
    def __init__(self, c, ndim, device=None):
        super().__init__()
        self.convs = nn.Sequential(ConvAct(c, c, ndim, device=device),
                                   ConvAct(c, c, ndim, device=device))


class Head(nn.Module):
    def __init__(self, c, out, ndim, device=None):
        super().__init__()
        self.up = DeconvAct(c, c // 2, ndim, device)
        self.out = _DECONV[ndim](c // 2, out, 4, 2, 1, device=device)


class Block(nn.Module):
    def __init__(self, cin, c, ndim, kernel, device=None):
        super().__init__()
        self.conv0 = nn.Sequential(ConvAct(cin, c // 2, ndim, kernel, 2, device),
                                   ConvAct(c // 2, c, ndim, kernel, 2, device))
        self.convblock = nn.Sequential(*[Res(c, ndim, device) for _ in range(4)])
        self.flow_head = Head(c, 2 * ndim, ndim, device)
        self.mask_head = Head(c, 1, ndim, device)


class RefIFNet(nn.Module):
    """IFNet from a configuration's ``model`` group (``ndim``, ``in_channels``,
    ``block_channels``, ``scales``, ``teacher_channels``, ``teacher_scale``,
    ``conv0_kernel``, ``fast_warp_r``, ``bounded_warp_rz``)."""

    def __init__(self, model: dict, device=None, precision: str | None = None):
        super().__init__()
        if model.get("refine") or model.get("arbitrary_timestep"):
            raise ValueError("the reference has no refinement and no timestep channel")
        nd, c = model["ndim"], model["in_channels"]
        self.ndim = nd
        self.scales = tuple(model["scales"])
        self.teacher_scale = model["teacher_scale"]
        k = model["conv0_kernel"]
        r, rz = model["fast_warp_r"], model["bounded_warp_rz"]
        if nd == 2:
            self.radii = (r, r)
        else:  # in-plane radius r (or r_z); both 0 when the z warp is unbounded
            self.radii = (rz, r or rz, r or rz) if rz else (0, 0, 0)
        self.n_blocks = len(model["block_channels"])
        for i, width in enumerate(model["block_channels"]):
            cin = 2 * c if i == 0 else 4 * c + 1 + 2 * nd
            self.add_module(f"block{i}", Block(cin, width, nd, k, device))
        self.block_tea = Block(5 * c + 1 + 2 * nd, model["teacher_channels"], nd, k, device)
        if precision not in (None, "fp8", "fp8_conv"):
            raise ValueError(f"precision is None (float32), 'fp8' or 'fp8_conv', got {precision!r}")
        self.precision = precision
        self.input_dtype = torch.bfloat16 if model.get("bfloat16") else None
        self.record: list | None = None

    # -- layers ---------------------------------------------------------------
    def _entry(self, t):
        """A frame as the network's entry holds it: the compute type's value."""
        return t if self.input_dtype is None else t.to(self.input_dtype).to(t.dtype)

    def _r(self, t):
        """A tensor as the program's compute type holds it after the entry:
        float32 here, e4m3 in the control."""
        return fp8_round(t) if self.precision == "fp8" else t

    def _op(self, fn, x, layer):
        """A convolution or transposed convolution; on e4m3 operands in the
        control."""
        w = layer.weight
        if self.precision is None:
            return fn(x, w, layer.bias, layer.stride, layer.padding)
        y = fn(fp8_round(x), fp8_round(w), layer.bias, layer.stride, layer.padding)
        return _Fp8Grad.apply(y)

    def _conv(self, m: ConvAct, x):
        fn = F.conv2d if self.ndim == 2 else F.conv3d
        return self._r(F.prelu(self._op(fn, x, m.conv), m.prelu.slope))

    def _deconv(self, d: nn.Module, x):
        fn = F.conv_transpose2d if self.ndim == 2 else F.conv_transpose3d
        return self._r(self._op(fn, x, d))

    def _resize(self, x, size, flow: bool):
        src = x.shape[2:]
        y = F.interpolate(x, size=size, mode=_MODE[self.ndim], align_corners=False)
        if not flow:
            return self._r(y)
        ratio = torch.tensor([t / s for t, s in zip(size, src)] * (x.shape[1] // self.ndim),
                             dtype=y.dtype, device=y.device)
        return self._r(y * ratio.view((1, -1) + (1,) * self.ndim))

    def block(self, b: Block, x, flow, scale):
        full = tuple(x.shape[2:])
        if scale != 1:
            small = tuple(s // scale for s in full)
            x = self._resize(x, small, False)
            if flow is not None:
                flow = self._resize(flow, small, True)
        if flow is not None:
            x = torch.cat([x, flow], 1)
        for m in b.conv0:
            x = self._conv(m, x)
        for res in b.convblock:
            y = x
            for m in res.convs:
                y = self._conv(m, y)
            x = self._r(x + y)
        outs = []
        for head in (b.flow_head, b.mask_head):
            y = self._r(F.prelu(self._deconv(head.up.deconv, x), head.up.prelu.slope))
            outs.append(self._deconv(head.out, y))
        f, m = outs
        if scale != 1:
            f = self._resize(f, full, True)
            m = self._resize(m, full, False)
        return f, m

    def warp(self, img, flow, padding="border", radii=None):
        return self._r(warp(img, flow, self.radii if radii is None else radii, padding,
                            self.record))

    # -- the network ----------------------------------------------------------
    def forward(self, img0, img1, gt=None) -> dict:
        nd = self.ndim
        img0, img1 = self._entry(img0), self._entry(img1)
        flow = mask = None
        w0, w1 = img0, img1
        flows, masks, warped = [], [], []
        for i in range(self.n_blocks):
            inp = [img0, img1] if flow is None else [img0, img1, w0, w1, mask]
            fd, md = self.block(getattr(self, f"block{i}"), torch.cat(inp, 1), flow,
                                self.scales[i])
            flow = fd if flow is None else self._r(flow + fd)
            mask = md if mask is None else self._r(mask + md)
            flows.append(flow)
            masks.append(self._r(torch.sigmoid(mask)))
            w0 = self.warp(img0, flow[:, :nd])
            w1 = self.warp(img1, flow[:, nd:])
            warped.append((w0, w1))
        merged = [self._r(a * m + b * (1 - m)) for (a, b), m in zip(warped, masks)]
        out = {"flow_list": flows, "mask_list": masks, "merged": merged,
               "flow_teacher": None, "merged_teacher": None,
               "loss_distill": img0.new_zeros(())}
        if gt is None:
            return out
        gt = self._entry(gt)
        fd, md = self.block(self.block_tea, torch.cat([img0, img1, w0, w1, mask, gt], 1), flow,
                            self.teacher_scale)
        flow_t = self._r(flow + fd)
        mask_t = self._r(torch.sigmoid(self._r(mask + md)))
        merged_t = self._r(self.warp(img0, flow_t[:, :nd]) * mask_t
                           + self.warp(img1, flow_t[:, nd:]) * (1 - mask_t))
        distill = img0.new_zeros(())
        for m, f in zip(merged, flows):
            # distil toward the teacher's flow where the student is worse by > 0.01
            worse = ((m - gt).abs().mean(1, keepdim=True)
                     > (merged_t - gt).abs().mean(1, keepdim=True) + 0.01).float().detach()
            rmse = torch.sqrt(((flow_t.detach() - f) ** 2).mean(1, keepdim=True) + 1e-12)
            distill = distill + (rmse * worse).mean()
        out.update(flow_teacher=flow_t, merged_teacher=merged_t, loss_distill=distill)
        return out


def warp(img, flow, radii, padding, record=None):
    """Sample ``img [B, C, *S]`` at (identity + ``flow [B, ndim, *S]``), each
    component clipped to its radius (0: none); ``border`` or ``zeros``."""
    nd = img.dim() - 2
    if record is not None:
        record.append({"shape": tuple(img.shape), "padding": padding,
                       "image_grad": img.requires_grad})
    b, c = img.shape[:2]
    spatial = tuple(img.shape[2:])
    lows, fracs = [], []
    for a, size in enumerate(spatial):
        f = flow[:, a].float()
        r = radii[a]
        if r:
            f = torch.where(f.abs() < r, f, torch.sign(f.detach()) * r)
        shape = [1] * (nd + 1)
        shape[a + 1] = size
        pos = torch.arange(size, dtype=torch.float32, device=img.device).view(shape) + f
        low = torch.floor(pos)
        lows.append(low.long())
        fracs.append(pos - low)
    flat = img.float().reshape(b, c, -1)
    out = None
    for corner in itertools.product((0, 1), repeat=nd):
        weight, index, inside = None, None, None
        for a, size in enumerate(spatial):
            i = lows[a] + corner[a]
            w = fracs[a] if corner[a] else 1 - fracs[a]
            ok = (i >= 0) & (i < size)
            i = i.clamp(0, size - 1)
            weight = w if weight is None else weight * w
            index = i if index is None else index * size + i
            inside = ok if inside is None else inside & ok
        if padding == "zeros":
            weight = weight * inside
        g = torch.gather(flat, 2, index.reshape(b, 1, -1).expand(b, c, -1))
        term = g.reshape((b, c) + spatial) * weight.unsqueeze(1)
        out = term if out is None else out + term
    return out


# -- losses ------------------------------------------------------------------------

_BINOMIAL = (1.0, 4.0, 6.0, 4.0, 1.0)


def _reflect(n: int, pad: int, device) -> torch.Tensor:
    """Indices of an axis of ``n`` reflect-padded by ``pad`` a side, the edge
    not repeated, reflecting again where ``pad >= n``."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _blur(x, gain: float = 1.0):
    """The 5-tap binomial filter along every spatial axis of ``[N, *S]``,
    reflect-padded."""
    for axis in range(1, x.dim()):
        n = x.shape[axis]
        xp = x.index_select(axis, _reflect(n, 2, x.device))
        x = sum(xp.narrow(axis, k, n) * (w / 16.0 * gain) for k, w in enumerate(_BINOMIAL))
    return x


def _pyramid(x, levels: int = 5):
    nd = x.dim() - 1
    every_other = (slice(None),) + (slice(None, None, 2),) * nd
    out = []
    for _ in range(levels):
        down = _blur(x)[every_other]
        up = x.new_zeros((x.shape[0],) + tuple(2 * s for s in down.shape[1:]))
        up[every_other] = down
        up = _blur(up, 2.0)[(slice(None),) + tuple(slice(0, s) for s in x.shape[1:])]
        out.append(x - up)
        x = down
    return out


def lap_loss(pred, target, levels: int = 5):
    """Sum over 5 Laplacian levels of the mean absolute difference."""
    planes = lambda t: t.float().reshape((-1,) + tuple(t.shape[2:]))  # noqa: E731
    return sum((p - q).abs().mean()
               for p, q in zip(_pyramid(planes(pred), levels), _pyramid(planes(target), levels)))


def photometric(model: RefIFNet, merged, flow, img0, img1):
    """The prediction warped by each half of the flow (zeros padding, the
    model's 2-D radius; unbounded in 3-D) against the other frame, under
    the Charbonnier penalty (x^2 + 1e-18)^0.25; batch sum over 3B, halved."""
    nd = model.ndim
    radii = model.radii if nd == 2 else (0,) * nd
    denom = merged.shape[0] * 3

    def side(f, target):
        d = model.warp(merged, f, "zeros", radii) - target
        return ((d * d + 1e-18) ** 0.25).sum() / denom

    return (side(flow[:, nd:], img0) + side(flow[:, :nd], img1)) / 2


def losses(model: RefIFNet, out: dict, img0, img1, gt, weights: dict):
    """``(total, parts)`` of the RIFE loss under a configuration's ``loss`` group."""
    if weights.get("smooth") or weights.get("flow") or weights.get("flow_leash"):
        raise ValueError("the reference has no smoothness, flow or leash term")
    recon = lap_loss if weights["use_lap"] else (lambda p, t: (p - t).abs().mean())
    zero = gt.new_zeros(())
    distill = out["loss_distill"]
    distill = torch.where(torch.isnan(distill) | (distill > 10.0), zero, distill)
    reg = zero
    if weights["reg"]:
        reg = sum(p.abs().sum() for n, p in model.named_parameters()
                  if "block2" in n or "block_tea" in n)
    photo = zero
    if weights["photo"]:
        photo = photometric(model, out["merged"][-1], out["flow_list"][-1], img0, img1)
    parts = {
        "loss_l1": recon(out["merged"][-1], gt) * weights["l1"],
        "loss_tea": recon(out["merged_teacher"], gt) * weights["tea"],
        "loss_distill": distill * weights["distill"],
        "l1_reg": reg * weights["reg"],
        "loss_photo": photo * weights["photo"],
    }
    return sum(parts.values()), parts


# -- the optimizer -----------------------------------------------------------------

def learning_rate(optim: dict, updates_done: int) -> float:
    """Linear warm-up then cosine, at the count of updates already made."""
    warm, scale = optim["warmup_steps"], optim["world_scale"]
    if updates_done < warm:
        return optim["lr_max"] * updates_done / max(warm, 1) * scale
    frac = min(max((updates_done - warm) / max(optim["total_steps"] - warm, 1), 0.0), 1.0)
    lo, hi = optim["lr_min"], optim["lr_max"]
    return (lo + (hi - lo) * (math.cos(frac * math.pi) + 1) / 2) * scale


class AdamW:
    """Decoupled weight decay Adam (betas 0.9 / 0.999, eps 1e-8) over a list
    of float32 tensors."""

    def __init__(self, params, weight_decay: float):
        self.params = list(params)
        self.wd = weight_decay
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads, lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - lr * self.wd)
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.addcdiv_(m, v.sqrt() / math.sqrt(c2) + 1e-8, value=-lr / c1)


def train_steps(model: RefIFNet, batches, config: dict):
    """Run the training steps on ``batches`` (each ``(img0, img1, gt)``,
    channels-first): ``(losses, first gradients, parameters after)``, the
    gradients and parameters as ``{name: tensor}``."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    opt = AdamW(params, config["optim"]["weight_decay"])
    seen, first = [], None
    for k, (i0, i1, gt) in enumerate(batches):
        out = model(i0, i1, gt)
        total, _ = losses(model, out, i0, i1, gt, config["loss"])
        grads = torch.autograd.grad(total, params)
        del out
        seen.append(float(total.detach()))
        if first is None:
            first = {n: g.clone() for n, g in zip(names, grads)}
        opt.step(grads, learning_rate(config["optim"], k))
        del grads
    return seen, first, {n: p.detach().clone() for n, p in zip(names, params)}


@torch.no_grad()
def series(model: RefIFNet, frames: torch.Tensor, factor: int, pad_multiple: int,
           rows: int):
    """Reconstruct ``frames [T, *S, C]`` decimated by ``factor`` (a power of
    two) by midpoint bisection: each frame at the middle of two known ones,
    coarsest gap first.  Edge-padded to ``pad_multiple`` and cropped back;
    the forwards run ``rows`` pairs at a time.  ``(reconstruction, flows)``:
    the flows ``[P, *S, 2 * ndim]`` are those between the kept frames."""
    kept = frames[::factor].float()
    spatial = tuple(kept.shape[1:-1])
    x = kept.movedim(-1, 1)
    for a, s in enumerate(spatial):  # edge padding, axis by axis
        extra = (-s) % pad_multiple
        if extra:
            edge = x.narrow(2 + a, s - 1, 1)
            x = torch.cat([x] + [edge] * extra, 2 + a)
    n = (kept.shape[0] - 1) * factor + 1
    recon = x.new_zeros((n,) + tuple(x.shape[1:]))
    recon[::factor] = x
    flows = []
    gap = factor
    while gap > 1:
        starts = list(range(0, n - 1, gap))
        for j in range(0, len(starts), rows):
            s = torch.tensor(starts[j:j + rows], device=x.device)
            out = model(recon[s], recon[s + gap])
            recon[s + gap // 2] = out["merged"][-1]
            if gap == factor:
                flows.append(out["flow_list"][-1])
        gap //= 2
    crop = (slice(None), slice(None)) + tuple(slice(0, s) for s in spatial)
    return recon[crop].movedim(1, -1), torch.cat(flows)[crop].movedim(1, -1)
