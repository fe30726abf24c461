"""PyTorch port: ``UPFlowTrainer`` against the benchmark's plain UPFlow
reference (``portbench/reference/upflow.py``) on the CPU in float32.

The cell's configuration (``portbench/configs/upflow_kitti.json``: SGU,
census, pyramid distillation, boundary-dilated warping) at narrow widths on
64 x 128 crops with rho 4, batch 2, cut by ``kitti_batch`` from seeded
KITTI-like frames.  One seeded state in both, its three flow heads scaled by
0.01 so that the untrained flows start small and the occlusion check passes
pixels (the distillation term is then not zero): the forward flows at every
level, every loss part, the first gradient, and three AdamW steps.
Importing the reference loads neither JAX nor the port.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from opticalflowscivis_tpu_torch.data.kitti import KittiHBMCache
from opticalflowscivis_tpu_torch.losses import UPFlowLossConfig
from opticalflowscivis_tpu_torch.models import UPFlowConfig
from opticalflowscivis_tpu_torch.training import UPFlowTrainConfig, UPFlowTrainer
from portbench import kitti_scenes
from portbench.drivers.upflow_train import seeded, unmasked
from portbench.reference.upflow import RefUPFlow, channels_first, train_steps

ROOT = Path(__file__).resolve().parents[1]
NARROW = dict(num_chs=[3, 4, 8, 8, 12, 16, 16], estimator_f_channels=[16, 16, 12, 8, 8],
              context_f_channels=[16, 16, 16, 12, 8, 8, 2])
HEADS = ("flow_estimators.convs.5.conv.weight", "context_networks.convs.6.conv.weight",
         "sgi_model.dense_estimator_mask.convs.5.conv.weight")
SEED = 2**32 + 3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cfg():
    with open(ROOT / "portbench" / "configs" / "upflow_kitti.json") as f:
        c = json.load(f)
    c["bfloat16"] = False
    c["model"].update(NARROW)
    return c


def _state(cfg):
    state = seeded(cfg, SEED, "cpu")
    for name in HEADS:
        state[name] = state[name] * 0.01
    return state


def _trainer(cfg) -> UPFlowTrainer:
    model = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["model"].items()}
    tc = UPFlowTrainConfig(batch_size=2, bfloat16=False, model=UPFlowConfig(**model),
                           loss=UPFlowLossConfig(**cfg["loss"]), **cfg["optim"])
    tr = UPFlowTrainer(tc, device="cpu")
    tr.net.load_state_dict(_state(cfg))
    tr.init_state()
    return tr


def _reference(cfg) -> RefUPFlow:
    ref = RefUPFlow(cfg["model"])
    ref.load_state_dict(_state(cfg))
    return ref


@pytest.fixture(scope="module")
def batches(cfg):
    store = kitti_scenes.kitti_scenes(SEED + 1, 2, 3, (80, 144), 4.0, "cpu")
    cache = KittiHBMCache.for_store(store.shape, kitti_scenes.pairs(2, 3), (64, 128), 4)
    rng = np.random.default_rng(SEED + 2)
    tr = _trainer(cfg)
    return [tr.kitti_batch(cache, store, rng) for _ in range(3)]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def test_forward_flows_and_loss_parts_match_the_reference(cfg, batches):
    tr, ref = _trainer(cfg), _reference(cfg)
    b = batches[0]
    cf = channels_first(b, "cpu")
    with torch.no_grad():
        out = tr._forward(b["im1"], b["im2"])
        _, parts = tr.losses(b)
        rout = ref(cf["im1"], cf["im2"])
        _, rparts = ref.losses(rout, cf["im1"], cf["im2"],
                               (cf["im1_raw"], cf["im2_raw"], cf["start"]), cfg["loss"])
    for key in ("flow_f", "flow_b"):
        assert _rel(out[key].movedim(-1, 1), rout[key]) < 1e-5, key
    assert len(out["flows"]) == len(rout["flows"]) == 5
    for (pf, pb), (rf, rb) in zip(out["flows"], rout["flows"]):
        assert _rel(pf.movedim(-1, 1), rf) < 1e-5 and _rel(pb.movedim(-1, 1), rb) < 1e-5
    assert set(parts) == set(rparts)
    for key, want in rparts.items():
        assert float(parts[key]) == pytest.approx(float(want), rel=1e-5, abs=1e-7), key
    # every term is at work: the check passes pixels, so the distillation is not zero
    assert 0 < float(rparts["occ_fw_mean"]) and float(rparts["msd_loss"]) > 0
    assert min(float(rparts[k]) for k in ("photo_loss", "smooth_loss", "census_loss")) > 0


def test_first_gradient_matches_the_reference(cfg, batches):
    tr, ref = _trainer(cfg), _reference(cfg)
    total, _ = tr.losses(batches[0])
    total.backward()
    cf = channels_first(batches[0], "cpu")
    rout = ref(cf["im1"], cf["im2"])
    rtotal, _ = ref.losses(rout, cf["im1"], cf["im2"], (cf["im1_raw"], cf["im2_raw"], cf["start"]),
                           cfg["loss"])
    names = [n for n, _ in ref.named_parameters()]
    want = dict(zip(names, torch.autograd.grad(rtotal, list(ref.parameters()))))
    got = {n: p.grad for n, p in tr.net.named_parameters()}
    assert set(got) == set(want)
    largest = max(float(g.abs().max()) for g in want.values())
    worst = max(float((got[n] - want[n]).abs().max()) for n in want)
    assert largest > 0 and worst <= 1e-4 * largest, (worst, largest)
    flat = lambda d: torch.cat([d[n].flatten() for n in names])  # noqa: E731
    assert _rel(flat(got), flat(want)) < 1e-4


def test_gradient_of_the_unmasked_terms_matches_the_reference(cfg, batches):
    """The first gradient of the photometric, census and smoothness terms
    (the distillation, behind the occlusion check's hard mask, left out), as
    the cell compares it: the program's by autograd, the reference's from
    ``train_steps``."""
    tr = _trainer(cfg)
    names, params = zip(*tr.net.named_parameters())
    _, parts = tr.losses(batches[0])
    got = dict(zip(names, torch.autograd.grad(unmasked(parts), params)))
    ref = train_steps(_reference(cfg), [channels_first(batches[0], "cpu")], cfg)
    want = ref["grads_unmasked"]
    assert set(got) == set(want)
    flat = lambda d: torch.cat([d[n].flatten() for n in names])  # noqa: E731
    assert float(flat(want).norm()) > 0 and _rel(flat(got), flat(want)) < 1e-4
    # the distillation's gradient is what tells the two apart
    assert _rel(flat(want), flat(ref["grads"])) > 1e-3


def test_three_adamw_steps_match_the_reference(cfg, batches):
    """The three steps' losses within 1e-5; the parameters' change after them
    in bulk within 10 %: Adam's first step is lr times the gradient's sign, so
    the sign of a gradient at round-off moves its element by 2 lr, and the
    third step's flows (grown after two steps) sit at the occlusion check's
    hard threshold, where a flipped pixel changes the gradient."""
    tr = _trainer(cfg)
    names = [n for n, _ in tr.net.named_parameters()]
    start = {n: p.detach().clone() for n, p in tr.net.named_parameters()}
    losses = [float(tr.train_step(b)["loss_total"]) for b in batches]
    ref = train_steps(_reference(cfg), [channels_first(b, "cpu") for b in batches], cfg)
    for a, b in zip(losses, ref["losses"]):
        assert a == pytest.approx(b, rel=1e-5)
    assert len(ref["grads"]) == len(names)
    got = torch.cat([(p.detach() - start[n]).flatten() for n, p in tr.net.named_parameters()])
    want = torch.cat([(ref["params"][n] - start[n]).flatten() for n in names])
    assert float(want.norm()) > 0 and _rel(got, want) < 0.1


def test_importing_the_reference_loads_neither_jax_nor_the_port():
    code = ("import sys; import portbench.reference.upflow, portbench.reference.upflow_count; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'opticalflowscivis_tpu', 'opticalflowscivis_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout
