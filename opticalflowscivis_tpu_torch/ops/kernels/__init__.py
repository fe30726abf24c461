"""Hand-written Hopper kernels and their wrappers.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: each wrapper
adds one where it launches its kernel and nowhere else, so a run can show that
the main path went through the kernels (``chip_smoke.py`` zeroes the counts
with ``reset_launches`` before driving the path and reads them after).

| kernel       | source           | replaces (TPU)                                      |
| ------------ | ---------------- | --------------------------------------------------- |
| `warp2d`     | `csrc/warp2d.cu` | `ops/pallas/warp.py::backward_warp_pallas` forward  |
| `warp2d_bwd` | `csrc/warp2d.cu` | `ops/pallas/warp.py::_backward_fused` (its VJP)     |
| `warp3d`     | `csrc/warp3d.cu` | `ops/warp.py::backward_warp3d_slab` (scan of `warp2d` over z-taps) |
| `warp3d_bwd` | `csrc/warp3d.cu` | its VJP (scan of `_backward_fused` over z-taps)      |
| `corr`       | `csrc/corr.cu`   | `ops/pallas/correlation.py::cost_volume_pallas` forward |
| `corr_bwd`   | `csrc/corr.cu`   | its VJP (`_forward_bwd`, jnp on the TPU)            |

A backward call is one launch of one kernel: of a warp with or without the
image gradient, of the cost volume for one feature map's gradient or both.
"""

LAUNCHES: dict[str, int] = {
    "warp2d": 0, "warp2d_bwd": 0, "warp3d": 0, "warp3d_bwd": 0, "corr": 0, "corr_bwd": 0,
}
# the part of LAUNCHES made by the 3-D warps' z-offset instances (``warp3d``'s
# ``z_offset``: a depth shard's haloed slab)
OFFSET_LAUNCHES: dict[str, int] = {"warp3d": 0, "warp3d_bwd": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, OFFSET_LAUNCHES):
        for name in counts:
            counts[name] = 0
