"""What the drivers share: the port's objects built from a configuration
file, the seeded weights, the plain reference beside them, and the
bookkeeping of a run."""

from __future__ import annotations

import contextlib
import gc
import math
import statistics

import numpy as np
import torch

from portbench import roofline
from portbench.reference import flops
from portbench.reference.ifnet import RefIFNet
from portbench.weights import seeded_state


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_config(cfg: dict):
    from opticalflowscivis_tpu_torch.training import ModelConfig

    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg["model"].items()})


def port_model(cfg: dict, seed: int, device: torch.device):
    """The port's IFNet at the configuration, holding the seeded weights."""
    from opticalflowscivis_tpu_torch.training import TrainConfig
    from opticalflowscivis_tpu_torch.training.trainer import build_model

    model = build_model(TrainConfig(model=model_config(cfg)), device)
    load_seeded(model, cfg, seed, device)
    return model


def load_seeded(model: torch.nn.Module, cfg: dict, seed: int, device: torch.device) -> None:
    state = seeded_state(RefIFNet(cfg["model"], device="meta"), seed, device)
    model.load_state_dict(state)


def reference_model(cfg: dict, seed: int, device: torch.device,
                    precision: str | None = None) -> RefIFNet:
    """The plain reference holding the same seeded weights; ``precision``
    ``"fp8"``: the control, ``"fp8_conv"``: its convolutions alone."""
    model = RefIFNet(cfg["model"], device=device, precision=precision)
    model.load_state_dict(seeded_state(RefIFNet(cfg["model"], device="meta"), seed, device))
    return model


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the reference's float32 convolutions and products."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def work(cfg: dict, train: bool) -> dict:
    """The reference's count for one sample of the configuration's size:
    FLOPs and the warps' least seconds at the model's element size."""
    sample = (cfg["channels"],) + tuple(cfg["size"])
    counted = flops.count(cfg, sample, train)
    size = 2 if cfg["model"]["bfloat16"] else 4
    return {"flops_per_sample": counted["flops"],
            "warp_bound_s_per_sample": roofline.warp_bound_s(counted["warps"], size)}


def device_record(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak)}


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


class Phases:
    """Host seconds of the steps of set-up, for the run's notes."""

    def __init__(self, t0: float):
        self.last, self.spent = t0, []

    def mark(self, name: str) -> None:
        now = __import__("time").perf_counter()
        self.spent.append(f"{name} {now - self.last:.3f}")
        self.last = now

    def note(self) -> str:
        return "set-up seconds: " + ", ".join(self.spent)


class Reservoir:
    """A sample of ``k`` items of a stream, drawn from a seed: every item
    seen has the same chance to be in it."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, np.random.default_rng(seed), 0, []

    def slot(self) -> int | None:
        """The slot the next item goes to, or None."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.k else None


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """RMS of ``a - b`` over the RMS of ``b``."""
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean().sqrt() / (b ** 2).mean().sqrt().clamp_min(1e-30))


def median(values) -> float:
    return float(statistics.median(values))


def finite(x: float) -> float:
    return x if math.isfinite(x) else float("inf")
