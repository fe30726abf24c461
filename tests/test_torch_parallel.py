"""PyTorch port: the distributed runtime over gloo ranks on the CPU.

- ``halo_exchange`` over 4 ranks against shift-, edge- and zero-padding of the
  full array, with its gradient (exact: the exchange moves values, and its
  gradient adds at most two terms to a slice);
- ``backward_warp3d_sharded`` over 4 depth shards against the JAX package's
  ``backward_warp3d_sharded`` on the 8-device CPU mesh of ``conftest.py``,
  border and zeros, values and gradients;
- data-parallel training: ``scripts/dryrun_dp.py`` over 2 gloo ranks against
  the same script on one device (the global batch on one rank): the RIFE-2D
  and the UPFlow step's parts and gradients, the fit's ``loss.json`` and its
  checkpoint, with the occlusion-normalised photometric term and census on a
  batch with occlusion;
- the refusals: ``n_data`` or ``n_space`` without a process group, an
  ``n_space`` below 1, a depth that does not split over the space ranks.

Each multi-process case starts its ranks as subprocesses with one torch
thread each, a ``file://`` rendezvous in ``tmp_path`` and a 120 s timeout on
the rendezvous, every collective and the join.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowscivis_tpu.parallel import make_mesh as jax_make_mesh
from opticalflowscivis_tpu.parallel.spatial import (
    backward_warp3d_sharded as jax_backward_warp3d_sharded,
)
from opticalflowscivis_tpu_torch.ops.kernels.warp import warp3d
from opticalflowscivis_tpu_torch.parallel import Mesh, data_parallel_mesh
from opticalflowscivis_tpu_torch.parallel.spatial import (
    backward_warp3d_sharded,
    halo_exchange,
    volume_batch_sharding,
)
from opticalflowscivis_tpu_torch.scripts import dryrun_dp
from opticalflowscivis_tpu_torch.training import Trainer, TrainConfig, UPFlowTrainConfig, UPFlowTrainer

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
# f32 sums in other orders: values within F32_TOL, gradients within BWD_F32_TOL
# of the largest reference gradient (the tolerances of the kernels' checks)
F32_TOL = 1e-5
BWD_F32_TOL = 1e-4
# k ranks on their rows against one rank on the global batch: the same f32
# arithmetic but for the order of the batch sums and of one all-reduce
DP_PARTS_RTOL = 1e-5
DP_GRAD_TOL = 1e-5  # of the largest gradient
DP_PARAM_TOL = 1e-5  # after the fit's Adam steps

HALO = 2
Z_LOCAL, N_SPACE, R_Z = 4, 4, 2  # mz = 3 <= Z_LOCAL
WARP_SHAPE = (2, 2, Z_LOCAL * N_SPACE, 6, 7)  # [B, C, Z, Y, X]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _launch(argv_of_rank, world: int, out: Path, also=()) -> None:
    """Start ``world`` ranks (``argv_of_rank(rank)``) and the commands in
    ``also`` beside them, wait for all, fail with their output if one fails
    or the join times out."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    argvs = [argv_of_rank(r) for r in range(world)] + list(also)
    procs = [subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for argv in argvs]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {r} exited {p.returncode}:\n{log[-4000:]}"
    (out / "ranks.log").write_text("\n".join(logs[:world]))


# the ranks of the spatial cases: each exchanges halos of its shard of seeded
# arrays and warps its depth shard, and saves outputs and gradients
_SPATIAL_RANK = r"""
import sys, torch
torch.set_num_threads(1)
from opticalflowscivis_tpu_torch.parallel import initialize_multihost, make_mesh
from opticalflowscivis_tpu_torch.parallel.spatial import (
    backward_warp3d_sharded,
    halo_exchange,
    volume_batch_sharding,
)
rank, world, url, out, halo, zl, rz = sys.argv[1:8]
rank, world, halo, zl, rz = int(rank), int(world), int(halo), int(zl), int(rz)
initialize_multihost(url, world, rank, device="cpu", timeout_s=120)
mesh = make_mesh(1, world)
inputs = torch.load(f"{out}/inputs.pt")
res = {}
for boundary in ("shift", "edge", "zeros"):
    x = inputs["halo_x"].narrow(2, 4 * rank, 4).clone().requires_grad_(True)
    y = halo_exchange(x, mesh.space_group, halo, dim=2, boundary=boundary)
    (y * inputs["halo_g"].narrow(2, (4 + 2 * halo) * rank, 4 + 2 * halo)).sum().backward()
    res["halo_" + boundary] = (y.detach(), x.grad)
for padding in ("border", "zeros"):
    img = inputs["img"].narrow(2, zl * rank, zl).clone().requires_grad_(True)
    flow = inputs["flow"].narrow(2, zl * rank, zl).clone().requires_grad_(True)
    o = backward_warp3d_sharded(img, flow, mesh, r_z=rz, padding=padding, r_yx=0)
    (o * inputs["g"].narrow(2, zl * rank, zl)).sum().backward()
    res["warp_" + padding] = (o.detach(), img.grad, flow.grad)
torch.save(res, f"{out}/rank{rank}.pt")
"""


@pytest.fixture(scope="module")
def spatial_ranks(tmp_path_factory):
    """The 4-rank session's inputs and each rank's results."""
    out = tmp_path_factory.mktemp("spatial")
    rng = np.random.default_rng(11)
    inputs = {
        "halo_x": torch.from_numpy(rng.normal(size=(2, 3, 4 * N_SPACE, 5)).astype(np.float32)),
        "halo_g": torch.from_numpy(
            rng.normal(size=(2, 3, (4 + 2 * HALO) * N_SPACE, 5)).astype(np.float32)),
        "img": torch.from_numpy(rng.random(WARP_SHAPE).astype(np.float32)),
        # |flow_z| beyond r_z in places (clipped on both sides), in-plane unbounded
        "flow": torch.from_numpy(
            rng.normal(0, 2, (WARP_SHAPE[0], 3) + WARP_SHAPE[2:]).astype(np.float32)),
        "g": torch.from_numpy(rng.normal(size=WARP_SHAPE).astype(np.float32)),
    }
    torch.save(inputs, out / "inputs.pt")
    url = f"file://{out / 'rendezvous'}"
    _launch(lambda r: [sys.executable, "-c", _SPATIAL_RANK, str(r), str(N_SPACE), url,
                       str(out), str(HALO), str(Z_LOCAL), str(R_Z)], N_SPACE, out)
    return inputs, [torch.load(out / f"rank{r}.pt") for r in range(N_SPACE)]


def _padded(full: torch.Tensor, boundary: str) -> torch.Tensor:
    """The full array padded along dim 2 as the global boundary asks."""
    if boundary == "shift":
        return torch.cat([full[:, :, :HALO], full, full[:, :, -HALO:]], 2)
    if boundary == "edge":
        first, last = full[:, :, :1], full[:, :, -1:]
        return torch.cat([first.expand(-1, -1, HALO, -1), full,
                          last.expand(-1, -1, HALO, -1)], 2)
    return torch.nn.functional.pad(full, (0, 0, HALO, HALO))


@pytest.mark.parametrize("boundary", ["shift", "edge", "zeros"])
def test_halo_exchange_matches_padding_of_the_full_array(spatial_ranks, boundary):
    """Rank i's haloed shard is rows [4i, 4i + 4 + 2·halo) of the padded full
    array; the gradient of sum_i <shard_i, g_i> is the padded array's
    gradient, cut back to the rank's rows."""
    inputs, ranks = spatial_ranks
    full = inputs["halo_x"].clone().requires_grad_(True)
    padded = _padded(full, boundary)
    span = 4 + 2 * HALO
    total = sum((padded[:, :, 4 * i : 4 * i + span]
                 * inputs["halo_g"][:, :, span * i : span * (i + 1)]).sum()
                for i in range(N_SPACE))
    total.backward()
    for i, res in enumerate(ranks):
        y, dx = res["halo_" + boundary]
        torch.testing.assert_close(y, padded[:, :, 4 * i : 4 * i + span].detach(),
                                   rtol=0, atol=0)
        torch.testing.assert_close(dx, full.grad[:, :, 4 * i : 4 * i + 4], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_sharded_warp(spatial_ranks):
    """The JAX package's sharded warp on a (data 2, space 4) mesh of the 8 CPU
    devices: outputs and the VJP of the same cotangent, channels-first."""
    inputs, _ = spatial_ranks
    mesh = jax_make_mesh(n_data=2, n_space=N_SPACE)
    img = jnp.asarray(inputs["img"].numpy().transpose(0, 2, 3, 4, 1))
    flow = jnp.asarray(inputs["flow"].numpy().transpose(0, 2, 3, 4, 1))
    g = jnp.asarray(inputs["g"].numpy().transpose(0, 2, 3, 4, 1))
    def value_and_vjp(i, f, g, padding):
        out, vjp = jax.vjp(lambda i, f: jax_backward_warp3d_sharded(
            i, f, mesh, r_z=R_Z, padding=padding, r_yx=0), i, f)
        return (out,) + vjp(g)

    fn = jax.jit(value_and_vjp, static_argnames="padding")
    return {padding: tuple(torch.from_numpy(np.asarray(a).transpose(0, 4, 1, 2, 3).copy())
                           for a in fn(img, flow, g, padding=padding))
            for padding in ("border", "zeros")}


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_backward_warp3d_sharded_matches_jax(spatial_ranks, jax_sharded_warp, padding):
    """Values within F32_TOL, image and flow gradients within BWD_F32_TOL of
    the largest JAX gradient; each rank's shard against the same z rows."""
    _, ranks = spatial_ranks
    want = jax_sharded_warp[padding]
    for name, k in (("out", 0), ("dimg", 1), ("dflow", 2)):
        got = torch.cat([res["warp_" + padding][k] for res in ranks], dim=2)
        tol = F32_TOL if k == 0 else BWD_F32_TOL * float(want[k].abs().max())
        torch.testing.assert_close(got, want[k], rtol=0, atol=tol, msg=f"{padding} {name}")


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_one_shard_is_the_unsharded_warp(padding):
    """A mesh of one space rank (no process group): the haloed warp equals
    ``warp3d`` on the whole volume, values and gradients (F32_TOL)."""
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.random((1, 1, 6, 5, 4)).astype(np.float32))
    flow = torch.from_numpy(rng.normal(0, 2, (1, 3, 6, 5, 4)).astype(np.float32))
    a = [t.clone().requires_grad_(True) for t in (img, flow)]
    b = [t.clone().requires_grad_(True) for t in (img, flow)]
    got = backward_warp3d_sharded(*a, Mesh(1, 1, 0), r_z=3, padding=padding)
    want = warp3d(*b, 3, 0, padding)
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)
    got.sum().backward()
    want.sum().backward()
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_z_offset_slab_samples_the_volume_bit_for_bit(padding):
    """``warp3d`` on a slab of a volume with its ``z_offset`` gives the
    volume's values and flow gradient on the slab's interior bit for bit, also
    where flow_z is an integer ± 2^-22: there the slab's own frame rounds
    z + flow_z to the other side of an integer, where the z gradient jumps
    (shown by the same slab without the offset)."""
    rng = np.random.default_rng(9)
    z, lo, r = 24, 6, 4  # the slab is rows [6, 24); rows [10, 24) sample inside it
    img = torch.from_numpy(rng.random((1, 1, z, 6, 5)).astype(np.float32))
    fz = rng.integers(-3, 4, (1, 1, z, 6, 5)) + rng.choice([-1.0, 1.0], (1, 1, z, 6, 5)) * 2.0**-22
    flow = torch.from_numpy(np.concatenate(
        [fz, rng.normal(0, 2, (1, 2, z, 6, 5))], axis=1).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(1, 1, z, 6, 5)).astype(np.float32))
    g[:, :, : lo + r] = 0  # only rows whose samples stay inside the slab

    def run(i, f, gg, **kw):
        f = f.clone().requires_grad_(True)
        out = warp3d(i, f, r, 0, padding, **kw)
        out.backward(gg)
        return out.detach(), f.grad

    out, dflow = run(img, flow, g)
    slab = (img[:, :, lo:].contiguous(), flow[:, :, lo:].contiguous(), g[:, :, lo:])
    got, got_dflow = run(*slab, z_offset=lo)
    inner = slice(r, None)  # slab rows [4, 18) = volume rows [10, 24)
    assert torch.equal(got[:, :, inner], out[:, :, lo + r:])
    assert torch.equal(got_dflow[:, :, inner], dflow[:, :, lo + r:])
    _, plain_dflow = run(*slab)
    assert not torch.equal(plain_dflow[:, :, inner], dflow[:, :, lo + r:])


def test_sharded_warp_refuses_thin_shards_and_bad_boundaries():
    img = torch.zeros((1, 1, 4, 3, 3))
    flow = torch.zeros((1, 3, 4, 3, 3))
    with pytest.raises(ValueError, match="must split into 1 shards of >= r_z\\+1=5"):
        backward_warp3d_sharded(img, flow, Mesh(1, 1, 0), r_z=4)
    for r_z in (0, -1):  # no bound on flow_z: samples past the halo
        with pytest.raises(ValueError, match="r_z must be >= 1"):
            backward_warp3d_sharded(img, flow, Mesh(1, 1, 0), r_z=r_z)
    with pytest.raises(ValueError, match="boundary"):
        halo_exchange(img, None, 1, dim=2, boundary="wrap")


# -- data parallelism -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The dry run over 2 gloo ranks, and beside them on one device (a
    process without a group)."""
    one = tmp_path_factory.mktemp("dp1")
    two = tmp_path_factory.mktemp("dp2")
    url = f"file://{two / 'rendezvous'}"
    script = [sys.executable, "-m", "opticalflowscivis_tpu_torch.scripts.dryrun_dp", "--cpu",
              "--threads", "1"]
    _launch(lambda r: script + ["--out", str(two), "--coordinator", url, "--num_processes",
                                "2", "--process_id", str(r), "--timeout_s", str(TIMEOUT_S)],
            2, two, also=[script + ["--out", str(one)]])
    ref, got = ({name: torch.load(d / name / "step.pt", weights_only=False)
                 for name in ("rife", "upflow")} for d in (one, two))
    return one, two, ref, got, (two / "ranks.log").read_text()


def _close_parts(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=DP_PARTS_RTOL, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("model", ["rife", "upflow"])
def test_dp_step_equals_the_one_rank_step(dp_runs, model):
    """Two ranks on their rows give the one-rank step on the global batch:
    the parts (global values) within DP_PARTS_RTOL, every averaged gradient
    within DP_GRAD_TOL of the largest gradient."""
    _, _, ref, got, _ = dp_runs
    _close_parts(got[model]["parts"], ref[model]["parts"])
    want_g, got_g = ref[model]["grads"], got[model]["grads"]
    assert set(got_g) == set(want_g)
    scale = max(float(g.abs().max()) for g in want_g.values())
    for name in want_g:
        torch.testing.assert_close(got_g[name], want_g[name], rtol=0,
                                   atol=DP_GRAD_TOL * scale, msg=name)


def test_dp_upflow_batch_has_occlusion(dp_runs):
    """The occlusion-normalised terms matter in this batch: part of it is
    occluded, and the visible share differs between the two ranks' rows (so
    that per-rank ratios would not give the global one)."""
    _, _, ref, _, _ = dp_runs
    parts = ref["upflow"]["parts"]
    assert 0.01 < parts["occ_fw_mean"] < 0.99
    assert parts["photo_loss"] > 0 and parts["census_loss"] > 0
    cfg, pairs, _, _ = dryrun_dp.upflow_setup(str(dp_runs[0]), "tiny", None)
    tr = UPFlowTrainer(cfg, device="cpu")
    shares = []
    for rows in (pairs[:2], pairs[2:4]):
        p, _ = tr.eval_step(tr._batch(tr.upload(rows)))
        shares.append(float(p["occ_fw_mean"]))
    assert abs(shares[0] - shares[1]) > 1e-3


def test_dp_loss_json_equals_the_one_rank_run(dp_runs):
    """``loss.json`` after the fit: RIFE's validation 7-tuple and UPFlow's
    epoch means with ``val_epe``, written once (rank 0), equal within
    DP_PARTS_RTOL."""
    one, two, _, _, _ = dp_runs
    rife = "res/rectangle2d/2x/flownet/loss.json"
    for rel, key in ((f"rife/{rife}", "val_loss"), ("upflow/loss.json", "loss")):
        want = json.loads((one / rel).read_text())[key]
        got = json.loads((two / rel).read_text())[key]
        assert len(got) == len(want) == 1
        if key == "loss":
            assert "val_epe" in got[0]
            _close_parts(got[0], want[0])
        else:
            np.testing.assert_allclose(got[0], want[0], rtol=DP_PARTS_RTOL, atol=1e-7)


@pytest.mark.parametrize("model", ["rife", "upflow"])
def test_dp_checkpoint_is_the_one_device_format(dp_runs, model):
    """The 2-rank fit's checkpoint (rank 0's) has the one-device file's keys,
    no ``module.`` prefix, loads strictly into a one-device trainer, and its
    parameters equal the one-device fit's within DP_PARAM_TOL; the one-device
    checkpoint loads into the same trainer by the same path."""
    one, two, _, _, _ = dp_runs
    rel = ("rife/log/rectangle2d/flownet.ckpt" if model == "rife" else "upflow/upflow.ckpt")
    a = torch.load(one / rel, weights_only=True)
    b = torch.load(two / rel, weights_only=True)
    assert a.keys() == b.keys() and a["model"].keys() == b["model"].keys()
    assert not any(k.startswith("module.") for k in b["model"])
    assert a["step"] == b["step"] > 0
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=DP_PARAM_TOL, msg=k)
    if model == "rife":
        cfg, _, _ = dryrun_dp.rife_setup(str(two), "tiny", None)
        tr = Trainer(cfg, device="cpu")
        tr.init_state(3)
    else:
        cfg, _, _, _ = dryrun_dp.upflow_setup(str(two), "tiny", None)
        tr = UPFlowTrainer(cfg, device="cpu")
        tr.init_state(2)
    assert tr.load_checkpoint() and tr.state.step == b["step"]


def test_dp_dry_run_reports_two_ranks(dp_runs):
    """The twin of ``dryrun_multichip``'s data-parallel half: the ranks'
    summary and a finite ``loss_G`` for the 2-rank RIFE-2D step; kernel
    launches none on the CPU (the plain versions run there)."""
    _, _, _, got, log = dp_runs
    line = next(json.loads(s) for s in log.splitlines() if s.startswith('{"dryrun_dp"'))
    assert line["dryrun_dp"]["initialized"] and line["dryrun_dp"]["process_count"] == 2
    assert np.isfinite(line["rife"]["parts"]["loss_G"])
    assert sum(got["rife"]["launches"].values()) == 0


# -- refusals -----------------------------------------------------------------------------


def test_n_data_without_a_process_group_raises(tmp_path):
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        data_parallel_mesh(2)
    assert data_parallel_mesh(None) is None and data_parallel_mesh(1) is None
    with pytest.raises(RuntimeError, match="torchrun"):
        Trainer(TrainConfig(n_data=2, data_dir=str(tmp_path)), device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        UPFlowTrainer(UPFlowTrainConfig(n_data=2, exp_dir=str(tmp_path)), device="cpu")


@pytest.mark.parametrize("kw, error, match", [
    ({"n_space": 2, "spatial_shard": True}, RuntimeError,
     r"n_data=None, n_space=2 needs a default process group of 2 processes.*"
     r"torchrun --nproc_per_node 2"),
    ({"n_data": 2, "n_space": 2}, RuntimeError, r"of 4 processes.*--nproc_per_node 4"),
    ({"n_space": 0}, ValueError, r"n_space must be >= 1"),
])
def test_spatial_sharding_without_its_mesh_raises(kw, error, match):
    """A sharded run needs ``n_data * n_space`` processes and says how to
    launch them; ``n_space`` below 1 is refused by the config."""
    with pytest.raises(error, match=match):
        Trainer(dataclasses.replace(TrainConfig(), **kw), device="cpu")


@pytest.mark.parametrize("n_leading", [1, 2])
def test_depth_that_does_not_split_over_the_space_ranks_raises(n_leading):
    """``volume_batch_sharding`` names what to change when the first spatial
    axis does not split over ``n_space`` ranks, and cuts one that does."""
    mesh = Mesh(1, 3, 2, spatial=True)  # the last of 3 space ranks; no group needed
    shape = (2,) + (3,) * (n_leading - 1) + (16, 4, 1)
    batch = np.arange(np.prod(shape)).reshape(shape)
    with pytest.raises(ValueError, match=r"pad_multiple.*n_space"):
        volume_batch_sharding(batch, mesh, n_leading)
    cut = volume_batch_sharding(batch[(slice(None),) * n_leading + (slice(0, 15),)], mesh,
                                n_leading)
    want = batch[(slice(None),) * n_leading + (slice(10, 15),)]
    np.testing.assert_array_equal(cut, want)
