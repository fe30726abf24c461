"""PyTorch port: the lattice-Boltzmann simulation against the JAX package,
and the registry's three lattice-Boltzmann datasets.

Tolerance: 1e-5 absolute on every channel (density normalised to [0, 1],
velocities up to 0.4 lattice units).  Both run the same float32 arithmetic;
the sums over the nine populations go in another order, which measured
2e-6 after 60 steps.  The registry's full runs (33 000 to 94 000 steps) are
too slow for the CPU: their arguments are recorded through a stand-in
simulator in both registries.
"""

import pickle

import numpy as np
import pytest
import torch

from opticalflowscivis_tpu.data import lbs as jlbs
from opticalflowscivis_tpu.data import registry as jreg
from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
from opticalflowscivis_tpu_torch.data import lbs as tlbs
from opticalflowscivis_tpu_torch.data import registry as treg

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("inflow_u", [0.0, 0.1], ids=["decaying", "inlet"])
def test_lattice_boltzmann_matches_the_reference(inflow_u):
    kw = dict(nx=40, ny=12, n_steps=60, skip=20, sample_every=4, seed=3, inflow_u=inflow_u)
    got = tlbs.lattice_boltzmann_2d(device="cpu", **kw)
    want = jlbs.lattice_boltzmann_2d(**kw)
    assert got.shape == want.shape == (10, 12, 40, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL
    assert got[..., 0].min() == 0.0 and got[..., 0].max() == 1.0
    # the inside of the cylinder carries no velocity
    _, cylinder = tlbs.initial_state(40, 12, 100.0, 3)
    assert (got[:, cylinder, 1:] == 0).all() and np.abs(got[..., 1:]).max() > 0.01


# (registry entry, simulator arguments, observable = |velocity|)
ENTRIES = [
    ("lbs2d", {}, False),
    ("vortex2d", dict(n_steps=34000, skip=4000, sample_every=20, inflow_u=0.1), True),
    ("vortex2d_fast", dict(n_steps=94000, skip=4000, sample_every=60, inflow_u=0.1), True),
]


@pytest.mark.parametrize("name, args, magnitude", ENTRIES, ids=[e[0] for e in ENTRIES])
def test_registry_calls_the_simulator_as_the_reference(monkeypatch, name, args, magnitude):
    stand_in = np.random.default_rng(0).uniform(-1, 1, (4, 3, 5, 3)).astype(np.float32)
    calls = {}

    def recorder(package):
        def fake(*a, **kw):
            calls[package] = (a, kw)
            return stand_in.copy()
        return fake

    monkeypatch.setattr(tlbs, "lattice_boltzmann_2d", recorder("port"))
    monkeypatch.setattr(jlbs, "lattice_boltzmann_2d", recorder("reference"))
    got = treg.get_spec(name).generator()
    want = jreg.get_spec(name).generator()
    assert calls["port"] == calls["reference"] == ((), args)
    np.testing.assert_array_equal(got, want)
    if magnitude:
        np.testing.assert_allclose(got[..., 0], np.hypot(stand_in[..., 1], stand_in[..., 2]),
                                   rtol=1e-6)
    for field in ("gt_flow_stride", "resample_stride", "train", "val", "test", "pkl_file"):
        assert getattr(treg.get_spec(name), field) == getattr(jreg.get_spec(name), field)


def test_generate_lbs2d_writes_the_pkl(monkeypatch, tmp_path, capsys):
    """``generate --dataset lbs2d`` writes what the simulator returns (here a
    short CPU run in place of the registry's full one on the card)."""
    simulate = tlbs.lattice_boltzmann_2d

    def short_run(**kw):
        return simulate(nx=40, ny=12, n_steps=30, skip=10, sample_every=5, device="cpu")

    monkeypatch.setattr(tlbs, "lattice_boltzmann_2d", short_run)
    cli(["generate", "--dataset", "lbs2d", "--data_dir", str(tmp_path)])
    with open(tmp_path / "lbs2d.pkl", "rb") as f:
        arr = pickle.load(f)
    assert arr.shape == (4, 12, 40, 3) and np.isfinite(arr).all()
    assert "wrote (4, 12, 40, 3)" in capsys.readouterr().out


def test_lattice_boltzmann_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlbs.lattice_boltzmann_2d(nx=8, ny=4, n_steps=2, skip=0, sample_every=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli(["generate", "--dataset", "lbs2d", "--data_dir", str(tmp_path)])
