"""Checkpointing: model, optimizer, scheduler and step in one ``torch.save`` file.

Counterpart of ``opticalflowscivis_tpu/training/checkpoint.py``, in this
port's own format: a dict of ``state_dict``s, written to a temporary file and
renamed into place, and read back with ``weights_only=True`` (tensors and
plain containers only; nothing in the file is executed).  The JAX package
writes Orbax directories; this port cannot read them, and says so.
``restore_params`` loads the parameters alone, and with ``relax`` keeps what
the file lacks (UPFlow ``tools.py``'s ``if_relax``).
"""

from __future__ import annotations

import os
from typing import Any

import torch

FORMAT = "opticalflowscivis_tpu_torch/1"


def save_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               scheduler: Any, step: int) -> None:
    if os.path.isdir(path):
        raise IsADirectoryError(
            f"{path} is a directory (an Orbax checkpoint of the JAX package?); "
            "this port writes a single file and will not replace it"
        )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "format": FORMAT,
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "scheduler": scheduler.state_dict(),
        "step": int(step),
    }
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load(path: str) -> dict:
    if os.path.isdir(path):
        raise IsADirectoryError(
            f"{path} is a directory: an Orbax checkpoint of the JAX package, "
            "which this port cannot read (it has neither Orbax nor flax); "
            "train again with this package"
        )
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this package ({FORMAT})")
    return payload


def restore_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                  scheduler: Any) -> int:
    """Load ``path`` into the given objects in place; returns the step.

    Raises ``FileNotFoundError`` when there is no checkpoint, and
    ``IsADirectoryError`` for an Orbax directory.
    """
    payload = _load(path)
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    scheduler.load_state_dict(payload["scheduler"])
    return int(payload["step"])


def restore_params(path: str, target: torch.nn.Module, relax: bool = False) -> list[str]:
    """Load the parameters and buffers of checkpoint ``path`` into ``target``
    in place; returns the names kept from ``target``.

    Strict without ``relax``, as ``restore_state``: a name on one side only
    raises.  With ``relax``, the target's entries that the file lacks keep
    their values (and are returned), and the file's entries that the target
    lacks are dropped.
    """
    saved = _load(path)["model"]
    if not relax:
        target.load_state_dict(saved, strict=True)
        return []
    own = target.state_dict()
    kept = [k for k in own if k not in saved]
    target.load_state_dict({k: saved.get(k, v) for k, v in own.items()}, strict=True)
    return kept
