"""The benchmark's own count of a cell's work: the floating-point operations
of the plain reference's convolutions and matrix products (forward, and
backward when training; no recomputation), and the shape of every warp call,
taken at one sample of the cell's shapes on the meta device."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.ifnet import RefIFNet, losses


def count(config: dict, sample: tuple[int, ...], train: bool) -> dict:
    """``{"flops": per sample, "warps": [call, ...]}`` for one sample of
    ``sample`` (``(C, *S)``) through the student (``train=False``) or the
    whole train step (``train=True``: the teacher, the losses and the
    backward).  A warp call is ``{"shape", "padding", "image_grad",
    "backward"}``."""
    model = RefIFNet(config["model"], device="meta")
    record: list = []
    model.record = record
    frames = [torch.empty((1,) + tuple(sample), device="meta") for _ in range(3)]
    with FlopCounterMode(display=False) as counter:
        if train:
            out = model(frames[0], frames[1], frames[2])
            total, _ = losses(model, out, frames[0], frames[1], frames[2], config["loss"])
            total.backward()
        else:
            with torch.no_grad():
                model(frames[0], frames[1])
    for call in record:
        call["backward"] = train
    return {"flops": counter.get_total_flops(), "warps": record}
