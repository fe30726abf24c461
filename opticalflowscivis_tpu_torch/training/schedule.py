"""LR schedule: linear warmup, then cosine decay.

Counterpart of ``opticalflowscivis_tpu/training/schedule.py``:
``lr = lr_max * step / warmup_steps`` while ``step < warmup_steps``, then a
cosine from ``lr_max`` down to ``lr_min`` over the remaining steps, all times
``world_scale``.  The returned function maps a step count to the learning
rate itself, so it serves ``torch.optim.lr_scheduler.LambdaLR`` on an
optimizer whose base lr is 1.  The step it is given is the number of updates
already made, so the first update runs at ``schedule(0) = 0``, as with optax.
"""

from __future__ import annotations

import math
from collections.abc import Callable


def warmup_cosine(
    lr_max: float = 3e-4,
    lr_min: float = 3e-6,
    warmup_steps: int = 2000,
    total_steps: int = 100_000,
    world_scale: float = 1.0,
) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr_max * step / max(warmup_steps, 1) * world_scale
        denom = max(total_steps - warmup_steps, 1)
        # clamp past the horizon: a resumed run whose restored step exceeds
        # total_steps must hold lr_min, not ride the cosine back up
        frac = min(max((step - warmup_steps) / denom, 0.0), 1.0)
        mul = math.cos(frac * math.pi) * 0.5 + 0.5
        return ((lr_max - lr_min) * mul + lr_min) * world_scale

    return schedule
