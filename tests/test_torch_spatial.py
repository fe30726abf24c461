"""PyTorch port: the depth-sharded layers and the spatially sharded train step
against the JAX package, over 4 gloo space ranks on the CPU (a (1, 4) mesh).

- every sharded layer against the unsharded layer on the same inputs
  (``tests/torch_spatial_cases.py``): convs 3³ s1, 3³ s2 and 4³ s2, the
  heads' transposed conv, the resize down by 4 and up by 4 (a flow, its
  values rescaled), ``gather_space`` / ``scatter_space``, the gather form of
  the unbounded warp (image and flow gradients), and the losses that read
  across depth (``smoothness_loss`` through its halo, the 3-D
  ``photometric_loss`` and ``lap_loss`` through the gather): values and
  gradients within LAYER_TOL of the largest;
- the spatially sharded IFNet-3D train step of ``Trainer(TrainConfig(n_space=4,
  spatial_shard=True))`` against the JAX package's ``spatial_shard`` step:
  its loss and gradient jitted on the (2, 4) mesh of the 8 CPU devices, the
  batch placed by its ``volume_batch_sharding``, at the reference's own
  configuration (``__graft_entry__.py:130-160``: 16³, blocks (8, 8, 8),
  teacher 8, ``conv0_kernel=3``, unbounded warps, ``preset_3d``; batch 2)
  from the same numpy-drawn weights through ``bridge.py``: parts within
  STEP_PARTS_RTOL, parameter gradients within STEP_GRAD_TOL of the largest.
  At 4 slices a rank the blocks at scales 4 and 2 gather their coarse
  levels, and the unbounded warps take the gather form.

The ranks run as subprocesses with one torch thread each, a ``file://``
rendezvous and 120 s timeouts, as in ``tests/test_torch_parallel.py``; the
JAX step compiles while they run.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spatial_cases as cases
from opticalflowscivis_tpu.losses.rife import rife_losses as jax_rife_losses
from opticalflowscivis_tpu.parallel import make_mesh as jax_make_mesh
from opticalflowscivis_tpu.parallel.spatial import (
    volume_batch_sharding as jax_volume_batch_sharding,
)
from opticalflowscivis_tpu.training import TrainConfig as JaxTrainConfig
from opticalflowscivis_tpu.training import build_model as jax_build_model
from opticalflowscivis_tpu.training import split_batch as jax_split_batch
from opticalflowscivis_tpu_torch.bridge import ifnet_params_from_flax

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
N_SPACE = cases.N_LAYER_RANKS
# a sharded layer reads the slices the whole layer reads; its sums in other
# orders (a weight gradient's over the shards, a halo's gradient added back)
# are float64's, the losses' float32's
LAYER_TOL = 1e-6  # of the largest value or gradient
# the step against the JAX package: float32 convolutions of two libraries
STEP_PARTS_RTOL = 1e-5
STEP_GRAD_TOL = 1e-4  # of the largest gradient


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_params(jnet, seed: int):
    """Params of ``jnet`` drawn with numpy on its abstract shapes (no init)."""
    x = jax.ShapeDtypeStruct((1, 16, 16, 16, 1), jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, x, x)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (0.7 * rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "slope" in name:
            return rng.uniform(0.1, 0.4, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def spatial_session(tmp_path_factory):
    """The 4 ranks' results, and the JAX package's ``spatial_shard`` step on
    the same batch and weights (computed while the ranks run)."""
    out = tmp_path_factory.mktemp("spatial")
    torch.save({name: fn(cases.inputs()[key]).shape
                for name, (fn, key, _) in cases.layer_cases(None).items()}, out / "shapes.pt")
    cfg, train, _ = cases.reference_step_setup(str(out))
    jcfg = JaxTrainConfig.from_json(cfg.to_json())
    jnet = jax_build_model(jcfg)
    params = _jax_params(jnet, seed=3)
    torch.save(ifnet_params_from_flax(params), out / "weights.pt")

    url = f"file://{out / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    script = str(REPO / "tests" / "torch_spatial_cases.py")
    procs = [subprocess.Popen([sys.executable, script, "layers", str(r), str(N_SPACE), url,
                               str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(N_SPACE)]
    try:
        mesh = jax_make_mesh(n_data=2, n_space=N_SPACE)

        def loss_fn(p, batch):
            img0, img1, gt, _ = jax_split_batch(batch, 3, False)
            return jax_rife_losses(jnet.apply(p, img0, img1, gt), img0, img1, gt, p,
                                   jcfg.loss, 3)

        repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                       in_shardings=(repl, jax_volume_batch_sharding(mesh, n_leading=2)))
        (_, jparts), jgrads = step(params, jnp.asarray(train))
        want = ({k: float(v) for k, v in jparts.items()},
                ifnet_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads)))
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(out / f"rank{r}.pt") for r in range(N_SPACE)], want


def _close(got, want, what):
    tol = LAYER_TOL * max(float(want.abs().max()), 1e-30)
    torch.testing.assert_close(got, want, rtol=0, atol=tol, msg=what)


@pytest.mark.parametrize("name", sorted(cases.layer_cases(None)))
def test_sharded_layer_matches_the_whole_layer(spatial_session, name):
    """The ranks' outputs put together are the whole layer's; so are their
    input gradients put together and their weight gradients summed.  A loss
    is a rank's share: the mean over the ranks is the whole loss, and the
    gradient of that mean the whole gradient."""
    ranks, _ = spatial_session
    fn, key, is_loss = cases.layer_cases(None)[name]
    x = cases.inputs()[key].clone().requires_grad_(True)
    layer = cases.conv_layers().get(name, torch.nn.Identity())
    y = fn(x)
    dim = cases.depth_dim(key)
    if is_loss:
        want_dx, *want_dw = torch.autograd.grad(y, [x] + list(layer.parameters()))
        got_y = torch.stack([r[name][0] for r in ranks]).mean()
        got_dx = torch.cat([r[name][1] for r in ranks], dim) / N_SPACE
    else:
        g = cases.cotangent(name, y.shape)
        want_dx, *want_dw = torch.autograd.grad(y, [x] + list(layer.parameters()), g)
        got_y = torch.cat([r[name][0] for r in ranks], 2)
        got_dx = torch.cat([r[name][1] for r in ranks], dim)
    _close(got_y, y.detach(), f"{name} value")
    _close(got_dx, want_dx, f"{name} input gradient")
    for k, w in enumerate(want_dw):
        _close(sum(r[name][2][k] for r in ranks), w, f"{name} weight gradient {k}")


def test_sharded_step_matches_the_jax_spatial_shard_step(spatial_session):
    """The port's step on 4 space ranks against the JAX package's on its
    (2, 4) mesh: every part within STEP_PARTS_RTOL, every parameter's
    gradient within STEP_GRAD_TOL of the largest; the same parameters have
    one."""
    ranks, (want_parts, want_grads) = spatial_session
    got_parts, got_grads = ranks[0]["step"]
    assert set(got_parts) == set(want_parts)
    for k, v in want_parts.items():
        assert np.isfinite(got_parts[k]), k
        np.testing.assert_allclose(got_parts[k], v, rtol=STEP_PARTS_RTOL, atol=1e-8, err_msg=k)
    assert want_parts["loss_l1"] > 0
    assert set(got_grads) == set(want_grads)
    scale = max(float(g.abs().max()) for g in want_grads.values())
    for name, g in want_grads.items():
        torch.testing.assert_close(got_grads[name], g, rtol=0, atol=STEP_GRAD_TOL * scale,
                                   msg=name)
    # every rank holds the same averaged gradients
    for r in ranks[1:]:
        for name, g in got_grads.items():
            assert torch.equal(r["step"][1][name], g), name
