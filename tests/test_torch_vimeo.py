"""PyTorch port: the Vimeo90K triplet stream against the JAX package, the
twin of ``tests/test_vimeo_kitti.py``'s Vimeo cases, and ``train --dataset
vimeo2d``.  The tests write Vimeo-layout trees of random grayscale PNGs
(no Vimeo90K files are in the repository)."""

import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from opticalflowscivis_tpu.data.vimeo import VimeoDataset as JaxVimeoDataset
from opticalflowscivis_tpu_torch.cli.__main__ import main as cli
from opticalflowscivis_tpu_torch.data import VimeoDataset
from opticalflowscivis_tpu_torch.losses import RIFELossWeights
from opticalflowscivis_tpu_torch.training import ModelConfig, TrainConfig, Trainer


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _make_vimeo_root(tmp_path, n_triplets=3, size=(48, 64)):
    root = tmp_path / "vimeo"
    rng = np.random.default_rng(0)
    names = []
    for i in range(n_triplets):
        name = f"0000{i}/0001"
        d = root / "sequences" / name
        os.makedirs(d)
        for j in (1, 2, 3):
            cv2.imwrite(str(d / f"im{j}.png"), rng.uniform(0, 255, size).astype(np.uint8))
        names.append(name)
    (root / "tri_trainlist.txt").write_text("\n".join(names) + "\n")
    (root / "tri_testlist.txt").write_text(names[0] + "\n")
    return str(root)


@pytest.mark.parametrize("split", ["train", "test"])
def test_vimeo_sample_equals_the_reference(tmp_path, split):
    root = _make_vimeo_root(tmp_path)
    ds = VimeoDataset(root, split=split, crop=(32, 32), seed=1)
    ref = JaxVimeoDataset(root, split=split, crop=(32, 32), seed=1)
    assert len(ds) == len(ref) == (3 if split == "train" else 1)
    for _ in range(3):  # the generator's draws stay in step over several batches
        batch = ds.sample(4)
        np.testing.assert_array_equal(batch, ref.sample(4))
    assert batch.shape == ((4, 3, 32, 32, 1) if split == "train" else (4, 3, 48, 64, 1))
    assert batch.dtype == np.float32 and 0.0 <= batch.min() and batch.max() <= 1.0


def test_vimeo_fit_stream_two_steps(tmp_path):
    """Two streamed steps on written Vimeo dirs through ``Trainer.fit_stream``."""
    root = _make_vimeo_root(tmp_path)
    ds = VimeoDataset(root, split="train", crop=(32, 32), seed=2)
    cfg = TrainConfig(
        dataset="vimeo2d", batch_size=8,
        model=ModelConfig(block_channels=(8, 8, 8), teacher_channels=8, bfloat16=False),
        loss=RIFELossWeights.preset_2d(),
        data_dir=str(tmp_path / "d"), log_dir=str(tmp_path / "l"), results_dir=str(tmp_path / "r"),
    )
    tr = Trainer(cfg, device="cpu")
    hist = tr.fit_stream(lambda: ds.sample(8), ds.sample(8), steps_per_epoch=2, epochs=1,
                         log_every=0)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss_G"])
    assert tr.state.step == 2 and os.path.exists(tr.checkpoint_path())


def test_cli_train_vimeo2d(tmp_path, capsys):
    """``train --dataset vimeo2d --cpu``: 224 x 224 crops of a written tree,
    a narrow model from ``--config_json``, one streamed step."""
    root = _make_vimeo_root(tmp_path, n_triplets=2, size=(232, 240))
    cfg = TrainConfig(
        dataset="vimeo2d", batch_size=2, epochs=1,
        model=ModelConfig(block_channels=(8, 8, 8), teacher_channels=8, bfloat16=False),
        loss=RIFELossWeights.preset_2d(),
        data_dir=str(tmp_path / "d"), log_dir=str(tmp_path / "l"), results_dir=str(tmp_path / "r"),
    )
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    cli(["train", "--cpu", "--config_json", str(tmp_path / "cfg.json"), "--vimeo_root", root,
         "--steps_per_epoch", "1"])
    out = capsys.readouterr().out
    assert "vimeo: 2 train triplets, val (1, 3, 232, 240, 1)" in out
    final = json.loads(out.strip().splitlines()[-1])["final_val"]
    assert np.isfinite(final["loss_G"])
    assert os.path.isfile(tmp_path / "l" / "vimeo2d" / "flownet.ckpt")


@pytest.mark.parametrize("argv, match", [
    (["train", "--cpu", "--dataset", "vimeo2d"], "requires --vimeo_root"),
    (["test", "--cpu", "--dataset", "vimeo2d"], "no test series"),
])
def test_vimeo2d_verbs_exit_with_a_reason(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli(argv)


def test_train_vimeo2d_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli(["train", "--dataset", "vimeo2d", "--vimeo_root", _make_vimeo_root(tmp_path)])
