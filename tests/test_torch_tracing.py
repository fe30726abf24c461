"""PyTorch port: the ``ofs.`` spans at the layer boundaries.

Spans off: one shared no-op, and a profile holds none of them.  Under
``trace`` one tiny CPU train step (2-D, a few channels a block, 32x32,
batch 2) and one tiny series call give the spans nested as the layers are:
each span's parent is the innermost span that encloses it on its thread.
So do a narrow UPFlow step with SGU, census and distillation on a batch cut
by ``kitti_batch`` (``ofs.kitti_batch`` before ``ofs.train_step``), and with
the spans off it records none.
"""

import json

import numpy as np
import pytest
import torch

from opticalflowscivis_tpu_torch.inference import Interpolator, interpolate_series_device
from opticalflowscivis_tpu_torch.losses import RIFELossWeights
from opticalflowscivis_tpu_torch.training import ModelConfig, TrainConfig, Trainer
from opticalflowscivis_tpu_torch.utils import span, spans, trace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans")
    loss = RIFELossWeights(smooth=0.1, flow=0.5, flow_leash=0.01, flow_leash_radius=16.0)
    cfg = TrainConfig(dataset="rectangle2d", batch_size=2, loss=loss,
                      model=ModelConfig(block_channels=(8, 8, 8), teacher_channels=8,
                                        bfloat16=False),
                      data_dir=str(tmp / "d"), log_dir=str(tmp / "l"), results_dir=str(tmp / "r"))
    tr = Trainer(cfg, device="cpu")
    tr.init_state(total_steps=4)
    return tr


def _batch() -> torch.Tensor:
    """``[2, 3, 32, 32, 3]``: the scalar field and its flow in each slot."""
    return torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 3, 32, 32, 3))
                            .astype(np.float32))


def _span_tree(path) -> list[tuple[str, str | None]]:
    """``(name, parent name)`` of every ``ofs.`` span in a Chrome trace, in
    order of start; the parent is the innermost span enclosing it on its thread."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e["name"].startswith("ofs.")]
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    tree = []
    for i, e in enumerate(events):
        outer = [o for o in events[:i] if o["tid"] == e["tid"]
                 and o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]]
        tree.append((e["name"], outer[-1]["name"] if outer else None))
    return tree


def test_spans_off_are_one_shared_no_op(trainer, tmp_path):
    assert span("ofs.a") is span("ofs.b")
    with spans():
        assert span("ofs.a") is not span("ofs.b")
        with spans(False):
            assert span("ofs.a") is span("ofs.b")
    assert span("ofs.a") is span("ofs.b")
    with trace(str(tmp_path / "off")) as path, spans(False):
        trainer.train_step(_batch())
    assert _span_tree(path) == []


def test_a_train_step_under_trace_nests_its_spans(trainer, tmp_path):
    with trace(str(tmp_path / "tb")) as path:
        trainer.train_step(_batch())
    tree = _span_tree(path)
    parts = ["ofs.losses." + p for p in ("l1", "tea", "reg", "photo", "smooth", "flow", "leash")]
    assert tree == (
        [("ofs.train_step", None), ("ofs.ifnet", "ofs.train_step")]
        + [(f"ofs.block{i}", "ofs.ifnet") for i in range(3)]
        + [("ofs.teacher", "ofs.ifnet"), ("ofs.distill", "ofs.ifnet"),
           ("ofs.losses", "ofs.train_step")]
        + [(p, "ofs.losses") for p in parts]
        + [("ofs.backward", "ofs.train_step"), ("ofs.optimizer", "ofs.train_step")])


def test_a_series_call_and_a_request_under_trace_nest_their_spans(trainer, tmp_path):
    interp = Interpolator(trainer.model, pad_multiple=32, device="cpu")
    frames = np.random.default_rng(1).uniform(0, 1, (5, 32, 32, 1)).astype(np.float32)
    with trace(str(tmp_path / "series")) as path:
        recon, flows = interpolate_series_device(interp, frames, 4, collect_flow=True)
    assert recon.shape == (5, 32, 32, 1) and flows.shape == (1, 32, 32, 4)
    tree = _span_tree(path)
    request = [("ofs.interpolate", "ofs.series.level"), ("ofs.ifnet", "ofs.interpolate")] + [
        (f"ofs.block{i}", "ofs.ifnet") for i in range(3)] + [("ofs.distill", "ofs.ifnet")]
    download = [("ofs.series.download", "ofs.series")]
    level = [("ofs.series.level", "ofs.series")] + request + download
    flows_spans = [(n, "ofs.series.flows" if p == "ofs.series.level" else p) for n, p in request]
    # one download a level and one for the flows, then the wait for them all
    calls = [("ofs.series.upload", "ofs.series")] + level + level + [
        ("ofs.series.flows", "ofs.series")] + flows_spans + download + download
    # the staging ring is allocated at the interpolator's first call alone
    assert tree == [("ofs.series", None), ("ofs.series.stage", "ofs.series")] + calls
    with trace(str(tmp_path / "series2")) as path:
        interpolate_series_device(interp, frames, 4, collect_flow=True)
    assert _span_tree(path) == [("ofs.series", None)] + calls

    x = torch.from_numpy(frames[:2]).movedim(-1, 1)
    with trace(str(tmp_path / "pair")) as path:
        interp.forward(x[:1], x[1:], 0.5)
    assert _span_tree(path)[:2] == [("ofs.interpolate", None), ("ofs.ifnet", "ofs.interpolate")]


# -- UPFlow ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def upflow(tmp_path_factory):
    """A narrow UPFlow trainer with SGU, census and distillation, and a frame
    store of 2 sequences of 3 frames for ``kitti_batch`` (64 x 64 crops)."""
    from opticalflowscivis_tpu_torch.data.kitti import KittiHBMCache
    from opticalflowscivis_tpu_torch.losses import UPFlowLossConfig
    from opticalflowscivis_tpu_torch.models import UPFlowConfig
    from opticalflowscivis_tpu_torch.training import UPFlowTrainConfig, UPFlowTrainer

    model = UPFlowConfig(num_chs=(3, 4, 8, 8, 12, 16, 16), estimator_f_channels=(8, 8, 8, 8, 8),
                         context_f_channels=(8, 8, 8, 8, 8, 8, 2), search_range=2,
                         if_norm_before_cost_volume=True, if_sgu_upsample=True)
    loss = UPFlowLossConfig(census_weight=1.0, msd_weight=0.01)
    tr = UPFlowTrainer(UPFlowTrainConfig(batch_size=2, bfloat16=False, model=model, loss=loss,
                                         exp_dir=str(tmp_path_factory.mktemp("upflow"))),
                       device="cpu")
    tr.init_state()
    frames = list(np.random.default_rng(2).uniform(-0.5, 0.5, (6, 80, 80, 3)).astype(np.float32))
    cache = KittiHBMCache.from_frames(frames, [(0, 1), (1, 2), (3, 4), (4, 5)], (64, 64), 8)
    return tr, cache, torch.from_numpy(cache.frames)


UPFLOW_STEP = (
    [("ofs.train_step", None), ("ofs.upflow", "ofs.train_step"),
     ("ofs.upflow.features", "ofs.upflow"),
     ("ofs.upflow.level0", "ofs.upflow"), ("ofs.upflow.corr", "ofs.upflow.level0")]
    + [span for level in range(1, 5) for span in (
        (f"ofs.upflow.level{level}", "ofs.upflow"), ("ofs.upflow.sgu", f"ofs.upflow.level{level}"),
        ("ofs.upflow.corr", f"ofs.upflow.level{level}"))]
    + [("ofs.upflow.sgu", "ofs.upflow"), ("ofs.losses", "ofs.train_step")]
    + [(f"ofs.losses.{p}", "ofs.losses") for p in ("occ", "smooth", "photo", "census", "msd")]
    + [("ofs.backward", "ofs.train_step"), ("ofs.optimizer", "ofs.train_step")])


def test_an_upflow_kitti_step_under_trace_nests_its_spans(upflow, tmp_path):
    tr, cache, store = upflow
    rng = np.random.default_rng(0)
    with trace(str(tmp_path / "upflow")) as path:
        tr.train_step(tr.kitti_batch(cache, store, rng))
    assert _span_tree(path) == [("ofs.kitti_batch", None)] + UPFLOW_STEP


def test_upflow_spans_off_record_nothing(upflow, tmp_path):
    tr, cache, store = upflow
    rng = np.random.default_rng(1)
    with trace(str(tmp_path / "off")) as path, spans(False):
        tr.train_step(tr.kitti_batch(cache, store, rng))
    assert _span_tree(path) == []
