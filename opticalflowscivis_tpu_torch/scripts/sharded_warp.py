"""The depth-sharded 3-D warp on the card: values, gradients, launches, times.

Each rank holds one depth shard of a seeded volume and flow and runs
``parallel.spatial.backward_warp3d_sharded`` (a halo exchange, then the
``warp3d`` kernels on the haloed shard), border and zeros, forward and
backward; the result is held against ``warp3d`` on the whole volume, the same
rows of it.  Then every rank times the halo exchange alone, the sharded
forward, the sharded forward and backward, and the unsharded forward on the
whole volume, by CUDA events:

    torchrun --nproc_per_node 2 -m opticalflowscivis_tpu_torch.scripts.sharded_warp \\
        --backend gloo --size 256 --out /tmp/sw

``--backend gloo`` lets the ranks share one card (NCCL needs a card a rank);
there the halo goes through the host, and each rank's times are wall times
that hold the host's copies and the other rank's work on the same card, not
device times of the exchange or the kernels.
``--cpu`` rehearses it with gloo ranks on the CPU (times by the host's clock).
Each rank writes ``<out>/rank<r>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ITERS = 10  # timed calls after 2 warm-up calls


def _inputs(size: int, seed: int, device: torch.device):
    """Image ``[1, 1, S, S, S]``, flow ``[1, 3, S, S, S]`` and a cotangent;
    ``flow_z`` reaches past 8 in places (clipped), the in-plane flow is
    unbounded."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (1, 1, size, size, size)
    img = torch.rand(shape, generator=gen, device=device)
    flow = torch.randn((1, 3) + shape[2:], generator=gen, device=device)
    flow *= torch.tensor([4.0, 2.0, 2.0], device=device).view(1, 3, 1, 1, 1)
    g = torch.randn(shape, generator=gen, device=device)
    return img, flow, g


def _ms(fn, iters: int, device: torch.device) -> float:
    """Mean ms a call after 2 warm-up calls: CUDA events on the card, the
    host's clock on the CPU."""
    for _ in range(2):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(device)
    begin.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return begin.elapsed_time(end) / iters


def run(size: int, r_z: int, device: torch.device) -> dict:
    """This rank's checks and times, inside an initialised process group."""
    import torch.distributed as dist

    from opticalflowscivis_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from opticalflowscivis_tpu_torch.ops.kernels.warp import warp3d
    from opticalflowscivis_tpu_torch.parallel import make_mesh
    from opticalflowscivis_tpu_torch.parallel.spatial import (
        backward_warp3d_sharded,
        halo_exchange,
    )

    mesh = make_mesh(1, dist.get_world_size())
    z_local = size // mesh.n_space
    z0 = mesh.space_index * z_local
    img, flow, g = _inputs(size, 0, device)
    local = [t.narrow(2, z0, z_local).contiguous() for t in (img, flow, g)]
    res = {"rank": mesh.rank, "shard": [z0, z0 + z_local], "size": size, "r_z": r_z}
    for padding in ("border", "zeros"):
        a = [t.clone().requires_grad_(True) for t in local[:2]]
        reset_launches()
        out = backward_warp3d_sharded(*a, mesh, r_z=r_z, padding=padding, r_yx=0)
        out.backward(local[2])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        res[f"launches_{padding}"] = {k: v for k, v in LAUNCHES.items() if v}
        b = [t.clone().requires_grad_(True) for t in (img, flow)]
        want = warp3d(*b, r_z, 0, padding)
        want.backward(g)
        errs = {"fwd": float((out - want.narrow(2, z0, z_local)).detach().abs().max())}
        for name, got, full in (("dimg", a[0].grad, b[0].grad), ("dflow", a[1].grad, b[1].grad)):
            ref = full.narrow(2, z0, z_local)
            errs[name] = float((got - ref).abs().max())
            errs[f"{name}_scale"] = float(ref.abs().max())
        res[f"err_{padding}"] = errs
        del a, b, out, want
    mz = r_z + 1
    with torch.no_grad():
        res["ms"] = {
            "halo_exchange": _ms(
                lambda: halo_exchange(local[0], mesh.space_group, mz, dim=2, boundary="edge"),
                ITERS, device),
            "sharded_fwd": _ms(
                lambda: backward_warp3d_sharded(local[0], local[1], mesh, r_z=r_z, r_yx=0),
                ITERS, device),
            "unsharded_fwd": _ms(lambda: warp3d(img, flow, r_z, 0, "border"), ITERS, device),
        }
    a = [t.clone().requires_grad_(True) for t in local[:2]]

    def fwd_bwd():
        backward_warp3d_sharded(*a, mesh, r_z=r_z, r_yx=0).backward(local[2])

    res["ms"]["sharded_fwd_bwd"] = _ms(fwd_bwd, ITERS, device)
    return res


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="sharded_warp", description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--r_z", type=int, default=8)
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None)
    p.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU (a rehearsal)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else None

    import torch.distributed as dist

    from opticalflowscivis_tpu_torch.parallel import initialize_multihost
    from opticalflowscivis_tpu_torch.parallel.multihost import local_device

    info = initialize_multihost(device=device, backend=args.backend, timeout_s=600)
    if not info["initialized"]:
        raise SystemExit("sharded_warp: run it under torchrun (no process group)")
    try:
        res = run(args.size, args.r_z, local_device(device))
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"rank{res['rank']}.json"), "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
