"""PyTorch port: spatially sharded train steps on a (2, 2) dp x sp mesh of gloo
ranks on the CPU against the one-device step (``tests/torch_spatial_cases.py``).

- ``halo``: IFNet-3D at 32³ (``conv0_kernel=4``, ``bounded_warp_rz=4``,
  ``fast_warp_r=4``, ``remat``), so that every level runs sharded and the
  model's warps go through ``backward_warp3d_sharded``'s halo, not the
  gather; ``plane``: IFNet-2D at 32 x 32 with its height sharded
  (``spatial_shard`` on 2-D batches), its warps in the gather form.  For
  each, ``Trainer.train_step`` on the global batch against the one-device
  step: parts within PARTS_RTOL, gradients within GRAD_TOL of the largest;
  then every loss term alone, its value and parameter gradients (each within
  GRAD_TOL of the term's largest) against the one-device terms on each data
  rank's rows averaged.  The term-by-term reference takes the data ranks'
  rows so that only the depth sharding differs: the photometric and
  smoothness terms' Charbonnier gradients at near-equal values change with
  the order of the batch's sums, on one device too (ROADMAP, parity traps).
- ``options``: the halo case with the model options the JAX package also
  takes sharded (``refine``, ``arbitrary_timestep``, ``teacher_scale=2``):
  its step.
- ``scripts/dryrun_dp.py``'s dp x sp half (the reference's 16³ config, batch
  2) on the mesh against ``--n_space 1`` on one device: the step's parts and
  gradients, the fit's ``loss.json`` and its checkpoint in the one-device
  format, and the collectives each rank issued.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_spatial_cases as cases
from opticalflowscivis_tpu_torch.scripts import dryrun_dp
from opticalflowscivis_tpu_torch.training import Trainer

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
# 4 ranks on their depth shards and rows against one process on the global
# batch: float32 sums in other orders
PARTS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of the largest gradient


@pytest.fixture(scope="module")
def steps_session(tmp_path_factory):
    """The 4 ranks' results and the one-device reference, run side by side."""
    out = tmp_path_factory.mktemp("spatial_steps")
    url = f"file://{out / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    script = [sys.executable, str(REPO / "tests" / "torch_spatial_cases.py")]
    world = cases.STEP_MESH[0] * cases.STEP_MESH[1]
    argvs = [script + ["steps", str(r), str(world), url, str(out)] for r in range(world)]
    argvs.append(script + ["steps_ref", str(out)])
    procs = [subprocess.Popen(a, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for a in argvs]
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
    return (out, torch.load(out / "sharded.pt", weights_only=False),
            torch.load(out / "ref.pt", weights_only=False))


def _close_grads(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        torch.testing.assert_close(got[name], g, rtol=0, atol=GRAD_TOL * max(scale, 1e-30),
                                   msg=f"{what} {name}")


def _close_parts(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], v, rtol=PARTS_RTOL, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("case", cases.STEP_CASES)
def test_sharded_step_equals_the_one_device_step(steps_session, case):
    """``Trainer.train_step`` on the (2, 2) mesh against one device on the
    global batch: parts and averaged gradients."""
    _, got, want = steps_session
    _close_parts(got[case]["parts"], want[case]["parts"])
    assert want[case]["parts"]["loss_flow"] > 0 and want[case]["parts"]["loss_distill"] > 0
    _close_grads(got[case]["grads"], want[case]["grads"], case)


@pytest.mark.parametrize("case", cases.TERM_CASES)
def test_each_loss_term_alone_equals_its_unsharded_value(steps_session, case):
    """Every term of ``rife_losses`` on its own: the mean over the mesh of the
    ranks' shares against the term on one device, and its parameter
    gradients; in the halo case the terms read across depth through halos
    (smoothness) and gathers (photometric warps), in the plane case also
    ``lap_loss``'s pyramid."""
    _, got, want = steps_session
    g, w = got[case]["terms"], want[case]["terms"]
    _close_parts(g["values"], w["values"])
    live = [t for t in w["grads"] if w["values"][t] != 0]
    expected = {"halo": {"loss_l1", "loss_tea", "loss_distill", "l1_reg", "loss_photo",
                         "loss_smooth", "loss_flow", "loss_leash"},
                "plane": {"loss_l1", "loss_tea", "loss_distill", "l1_reg", "loss_photo",
                          "loss_smooth", "loss_flow"}}[case]
    assert set(live) == expected
    for term in w["grads"]:
        _close_grads(g["grads"][term], w["grads"][term], f"{case} {term}")


def test_halo_case_shards_every_level_and_warps_through_the_halo():
    """The halo case's shapes: 16 slices a rank, every level of every block
    sharded (no gather), and warps through the halo (r_z + 1 = 5 <= 16)."""
    cfg, batch = cases.step_case("halo")
    model = Trainer(cfg, device="cpu").model
    z_local = batch.shape[2] // cases.STEP_MESH[1]
    assert model.halo_warps(z_local)
    for i, scale in enumerate(model.scales):
        assert all(getattr(model, f"block{i}").sharded_levels(z_local, scale, 2)), i
    assert all(model.block_tea.sharded_levels(z_local, model.teacher_scale, 2))


def test_dry_run_dp_x_sp_equals_one_device(steps_session):
    """``dryrun_dp``'s dp x sp half on the (2, 2) mesh against ``--n_space 1``:
    the step, the fit's ``loss.json`` (written once) and a checkpoint that
    loads strictly into a one-device trainer; each rank issued the same
    collectives, halo exchanges and the gathers of its coarse levels."""
    out, _, _ = steps_session
    want = torch.load(out / "one" / "sp" / "step.pt", weights_only=False)
    got = torch.load(out / "mesh" / "sp" / "step.pt", weights_only=False)
    assert got["mesh"] == list(cases.STEP_MESH) and want["mesh"] == [1, 1]
    _close_parts(got["parts"], want["parts"])
    _close_grads(got["grads"], want["grads"], "dry run")
    rel = "sp/res/rectangle3d/2x/flownet/loss.json"
    a = json.loads((out / "one" / rel).read_text())["val_loss"]
    b = json.loads((out / "mesh" / rel).read_text())["val_loss"]
    assert len(a) == len(b) == 1
    np.testing.assert_allclose(b[0], a[0], rtol=PARTS_RTOL, atol=1e-8)
    collectives = [r["collectives"] for r in got["ranks"]]
    assert len(collectives) == 4 and all(c == collectives[0] for c in collectives)
    assert collectives[0]["halo_exchange"] > 0 and collectives[0]["gather"] > 0
    ckpt = torch.load(out / "mesh" / "sp" / "log" / "rectangle3d" / "flownet.ckpt",
                      weights_only=True)
    assert not any(k.startswith("module.") for k in ckpt["model"])
    cfg, _, _ = dryrun_dp.sp_setup(str(out / "mesh"), "tiny", None, 1)
    tr = Trainer(cfg, device="cpu")
    tr.init_state(2)
    assert tr.load_checkpoint() and tr.state.step == ckpt["step"] == 2
