"""Dataset registry — numpy copy of the reference's ``data/registry.py``.

One ``DatasetSpec`` per dataset: source, spatial rank, GT-flow availability,
fixed index splits, temporal resampling, flip augmentation and the default
batch size.  ``load_data(dataset, exp, mode)`` returns grouped tuple arrays
``[N, slots, *S, C]``: (train, val) for mode='train', test for mode='test'.
``load_raw_series`` returns one normalised split ``[T, *S, C]``.

Synthetic datasets are generated on first use and cached as ``.pkl`` in
``data_dir``; external SciVis pkls are read from ``data_dir`` with automatic
channels-first → channels-last conversion.

The lattice-Boltzmann datasets (``lbs2d``, ``vortex2d``, ``vortex2d_fast``)
are generated by ``data/lbs.py`` on the GPU.  Tuples of 2-D and 3-D series
are prepared by the native ``csrc/fastprep.cpp`` (``data/fastprep.py``), as the
reference does; it is bit-equal to the numpy pipeline, and a failure to build
it raises.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
from typing import Callable, Sequence

import numpy as np

from opticalflowscivis_tpu_torch.data import synthetic
from opticalflowscivis_tpu_torch.data.pipeline import (
    flip_augment,
    group_tuples,
    minmax_normalize,
    temporal_resample,
)

Slices = Sequence[tuple[int | None, int | None]]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    ndim: int
    has_flow: bool
    train: Slices
    val: Slices
    test: Slices
    batch_size: int
    generator: Callable[..., np.ndarray] | None = None  # synthetic source
    pkl_file: str | None = None  # external source (relative to data_dir)
    resample_stride: int = 3  # every-3rd w/ phase shifts; 0 = off (3-D path)
    flip_aug: bool = True
    val_pkl_file: str | None = None  # droplet3d ships pre-split train/val pkls
    gt_flow_stride: float = 1.0  # stored flow units → pixels per stored frame.
    #   Synthetic generators stamp the exact per-frame displacement (1.0); the
    #   LBS export stores instantaneous velocity sampled every 10 sim steps, so
    #   displacement ≈ 10 x stored value (approximate for unsteady flow).
    #   External NetCDF velocity pkls keep 1.0 — physical units are unknown.


def _spec(**kw) -> DatasetSpec:
    return DatasetSpec(**kw)


REGISTRY: dict[str, DatasetSpec] = {
    # ---- 2-D (Flow-2D/load_datasets.py) ----
    "rectangle2d": _spec(
        name="rectangle2d", ndim=2, has_flow=True,
        train=[(0, 2205)], val=[(2370, 2685)], test=[(2685, 3000)],
        batch_size=180, generator=synthetic.rectangle_2d,
    ),
    "rectangle2d_tex": _spec(
        # rectangle2d with a static textured background (synthetic.rectangle_2d
        # background="texture") — the unsupervised-flow benchmark: photometric
        # terms are ill-posed on the reference's zero background (flow there is
        # unconstrained), textured background anchors it like KITTI texture.
        name="rectangle2d_tex", ndim=2, has_flow=True,
        train=[(0, 2205)], val=[(2370, 2685)], test=[(2685, 3000)],
        batch_size=180,
        generator=functools.partial(synthetic.rectangle_2d,
                                    background="texture"),
    ),
    "rectangle2d_tex_pan": _spec(
        # rectangle2d_tex with the background PANNING under the box (bounded
        # integer camera walk, synthetic.rectangle_2d background="pan") — the
        # full-field-motion regime of KITTI egomotion, where the reference's
        # unsupervised recipe demonstrably trains (simple_train.py:56-59).
        # Static textured backgrounds are a reinforced zero-flow attractor
        # for robust photometric losses (measured, round 3); every-pixel
        # motion removes the attractor while the stamped GT stays the exact
        # apparent displacement, so EPE-vs-zero-flow remains a fair skill
        # metric.
        name="rectangle2d_tex_pan", ndim=2, has_flow=True,
        train=[(0, 2205)], val=[(2370, 2685)], test=[(2685, 3000)],
        batch_size=180,
        generator=functools.partial(synthetic.rectangle_2d,
                                    background="pan"),
    ),
    "rectangle2d_tex_pan8": _spec(
        # rectangle2d_tex_pan with KITTI-magnitude camera motion
        # (pan_vel_max=8 px/frame vs 3).  Measured motivation (round 3): at
        # mean |pan| ~ 3 px the shift is SUB-PIXEL at every decoded pyramid
        # level (the finest decode is 1/4 res, so 3 px -> 0.75 px), leaving
        # the cost volume with no integer-offset signal anywhere — the long
        # pan run's flow never became pan-coherent.  KITTI flow magnitudes
        # are tens of px (the regime UPFlow's 5-level decode was designed
        # for); 8 px/frame puts 2 px at the finest decoded level, inside the
        # +/-4 search range with real off-center correlation mass.
        name="rectangle2d_tex_pan8", ndim=2, has_flow=True,
        train=[(0, 2205)], val=[(2370, 2685)], test=[(2685, 3000)],
        batch_size=180,
        generator=functools.partial(synthetic.rectangle_2d,
                                    background="pan", pan_vel_max=8),
    ),
    "rectangles2d": _spec(  # multi-box variant (create_rectangles_2d.py)
        name="rectangles2d", ndim=2, has_flow=True,
        train=[(0, 2205)], val=[(2370, 2685)], test=[(2685, 3000)],
        batch_size=180, generator=synthetic.rectangles_2d,
    ),
    "rectangles2d_tex_pan8": _spec(
        # STRUCTURED ego-motion (VERDICT r4 #1b): three independently-moving
        # rigid textured boxes at different scales OVER the pan8 panning
        # multi-octave background — the KITTI-like regime (motion boundaries
        # + occlusion structure at several scales) that plain pan8 lacks.
        # The r5 landscape probe (Results/landscape_r5) shows pan8's census
        # basin flattening/biasing at the decoded pyramid scales; rigid
        # boundaries restore coarse-scale structure census can lock onto.
        name="rectangles2d_tex_pan8", ndim=2, has_flow=True,
        train=[(0, 2205)], val=[(2370, 2685)], test=[(2685, 3000)],
        batch_size=180,
        generator=functools.partial(synthetic.rectangles_2d,
                                    background="pan", pan_vel_max=8),
    ),
    "lbs2d": _spec(
        name="lbs2d", ndim=2, has_flow=True,
        train=[(0, 2205)], val=[(2370, 2685)], test=[(2685, 3000)],
        batch_size=100, pkl_file="lbs2d_skip_.pkl",
        generator=None,  # set below
        gt_flow_stride=10.0,  # velocity stored per sim step, frames kept every 10
    ),
    "vortex2d": _spec(
        # Vortex-street analogue of the reference's headline pipedcylinder2d
        # (450x150x1501, README.md:15): the same D2Q9 cylinder-wake simulation
        # as lbs2d but with a sustained velocity inlet (the reference's
        # kick-and-decay sim goes near-static: per-frame change drops 50x by
        # step 60000 — measured round 2) and sampled every 20th step so the
        # kept-frame motion is advective (px-scale) rather than sub-pixel —
        # at every-10th sampling on the decaying sim, linear cross-fade is
        # unbeatable by construction (measured, RESULTS.md round 1).
        # Observable = |velocity|, matching the reference's magnitude pkl for
        # its NetCDF 2-D datasets (read_data.py:405-410) — NOT density: LBS
        # flow is near-incompressible, so the density channel is visually
        # static and linear cross-fade wins at every factor (measured round 2:
        # 62.5 dB linear vs 50.0 dB model at 2x on the density observable).
        name="vortex2d", ndim=2, has_flow=True,
        train=[(0, 1050)], val=[(1050, 1200)], test=[(1200, 1500)],
        batch_size=64, generator=None,  # set below
        gt_flow_stride=20.0,
        # no every-3rd resample: consecutive-frame triplets keep the flow
        # supervision target exact (F_t→±1 spans one stored frame = v*40) and
        # match the factor-2 test spacing.  The reference resamples stride 3
        # AND supervises with per-frame GT flow — a 3x span/target mismatch
        # (load_datasets.py:227-240 vs RIFE.py:131-141) not worth reproducing
        # on the quality-parity dataset.
        resample_stride=0,
    ),
    "vortex2d_fast": _spec(
        # vortex2d sampled every 60th sim step (~9 px mean / ~17 px p95
        # advection per kept frame vs ~3.1 px at stride 20).  Round-2 parity
        # measurement on vortex2d: the model beats linear cross-fade exactly
        # where the kept-frame gap is 25-50 px (factors 8x/16x) — at 2x the
        # 6 px gap leaves cross-fade near-optimal.  This variant moves the
        # same physics so factor 2x (≈19 px gap) and 4x (≈37 px) land inside
        # the model-wins regime, matching the reference headline data where
        # its model wins from 2x up (error.py:442).
        name="vortex2d_fast", ndim=2, has_flow=True,
        train=[(0, 1050)], val=[(1050, 1200)], test=[(1200, 1500)],
        batch_size=64, generator=None,  # set below
        gt_flow_stride=60.0,
        resample_stride=0,
    ),
    "droplet2d": _spec(
        name="droplet2d", ndim=2, has_flow=False,
        train=[(0, 51300)], val=[(51300, 54000)], test=[(0, 2700)],
        batch_size=128, pkl_file="droplet2d.pkl",
    ),
    "pipedcylinder2d": _spec(
        name="pipedcylinder2d", ndim=2, has_flow=True,
        train=[(0, 540), (-540, None)], val=[(540, 810)], test=[(810, 1080)],
        batch_size=64, pkl_file="pipedcylinder2d.pkl",
    ),
    "cylinder2d": _spec(
        name="cylinder2d", ndim=2, has_flow=True,
        train=[(0, 540), (-540, None)], val=[(540, 810)], test=[(810, 1080)],
        batch_size=64, pkl_file="cylinder2d.pkl",
    ),
    "FluidSimML2d": _spec(
        name="FluidSimML2d", ndim=2, has_flow=True,
        train=[(100, 820)], val=[(820, 964)], test=[(820, 964)],
        batch_size=64, pkl_file="FluidSimML2d.pkl",
    ),
    "vimeo2d": _spec(  # Vimeo90K triplets (Flow-2D/dataset.py, train.py:78-100).
        # Streamed via data.vimeo.VimeoDataset (random crops each step), not
        # the pkl pipeline — slices are unused; flip aug lives in the dataset.
        name="vimeo2d", ndim=2, has_flow=False,
        train=[(None, None)], val=[(None, None)], test=[(None, None)],
        batch_size=16, resample_stride=0, flip_aug=False,
    ),
    # ---- 3-D (Flow-3D/load_datasets.py; no temporal resample, L1-style path) ----
    "rectangle3d": _spec(
        name="rectangle3d", ndim=3, has_flow=True,
        train=[(0, 750)], val=[(750, 900)], test=[(900, 999)],
        batch_size=30, generator=synthetic.rectangle_3d,
        resample_stride=0,
    ),
    "droplet3d": _spec(
        name="droplet3d", ndim=3, has_flow=False,
        train=[(None, None)], val=[(None, None)], test=[(None, None)],
        batch_size=20, pkl_file="droplet3d_64_train.pkl",
        val_pkl_file="droplet3d_64_val.pkl", resample_stride=0,
    ),
    "jets3d": _spec(  # 5Jets (README.md:24-26); synthetic analogue built in
        name="jets3d", ndim=3, has_flow=True,
        train=[(0, 350)], val=[(350, 425)], test=[(425, 500)],
        batch_size=15, generator=synthetic.jets_3d,
        pkl_file="jets3d.pkl",  # convert_5jets output takes precedence
        resample_stride=0, flip_aug=False,
    ),
    "tangaroa3d": _spec(
        name="tangaroa3d", ndim=3, has_flow=False,
        train=[(0, 150)], val=[(150, 201)], test=[(150, 201)],
        batch_size=15, pkl_file="tangaroa3d_downs.pkl",
        resample_stride=0, flip_aug=False,
    ),
    "tornado3d": _spec(
        name="tornado3d", ndim=3, has_flow=False,
        train=[(None, None)], val=[(None, None)], test=[(None, None)],
        batch_size=15, pkl_file="tornado3d.pkl",
        resample_stride=0, flip_aug=False,
    ),
}


def _lbs_generator() -> np.ndarray:
    from opticalflowscivis_tpu_torch.data.lbs import lattice_boltzmann_2d

    return lattice_boltzmann_2d()


def _vortex_generator() -> np.ndarray:
    from opticalflowscivis_tpu_torch.data.lbs import lattice_boltzmann_2d

    # sustained inlet (the decaying kick of lbs2d is too static for the
    # interpolation protocol, see the registry entry), a 4000-step burn-in to
    # developed shedding, then 1500 frames at stride 20
    arr = lattice_boltzmann_2d(n_steps=34000, skip=4000, sample_every=20, inflow_u=0.1)
    # observable channel = velocity magnitude (see the registry entry)
    arr[..., 0] = np.sqrt(arr[..., 1] ** 2 + arr[..., 2] ** 2)
    return arr


def _vortex_fast_generator() -> np.ndarray:
    from opticalflowscivis_tpu_torch.data.lbs import lattice_boltzmann_2d

    # vortex2d's simulation sampled every 60th step: 1500 kept frames need
    # 4000 + 1500 * 60 = 94000 steps
    arr = lattice_boltzmann_2d(n_steps=94000, skip=4000, sample_every=60, inflow_u=0.1)
    arr[..., 0] = np.sqrt(arr[..., 1] ** 2 + arr[..., 2] ** 2)
    return arr


# the simulations run on the GPU (data/lbs.py), so they are imported on use
for _name, _gen in (("lbs2d", _lbs_generator), ("vortex2d", _vortex_generator),
                    ("vortex2d_fast", _vortex_fast_generator)):
    REGISTRY[_name] = dataclasses.replace(REGISTRY[_name], generator=_gen)


def get_spec(dataset: str) -> DatasetSpec:
    if dataset not in REGISTRY:
        raise KeyError(f"unknown dataset {dataset!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[dataset]


def _to_channels_last(data: np.ndarray, ndim: int) -> np.ndarray:
    """Accept reference layouts [T,*S], [T,C,*S] or ours [T,*S,C] → [T,*S,C]."""
    if data.ndim == 1 + ndim:  # [T, *S]
        return data[..., None]
    if data.ndim == 2 + ndim:
        # channels-first if axis 1 is small and last axis is big
        if data.shape[1] <= 4 and data.shape[-1] > 4:
            return np.moveaxis(data, 1, -1)
        return data
    raise ValueError(f"cannot interpret shape {data.shape} as {ndim}-D series")


def _load_raw(spec: DatasetSpec, data_dir: str, which_pkl: str | None = None) -> np.ndarray:
    pkl_name = which_pkl or spec.pkl_file
    if spec.generator is not None:
        path = os.path.join(data_dir, f"{spec.name}.pkl")
        if not os.path.exists(path):
            os.makedirs(data_dir, exist_ok=True)
            arr = spec.generator()
            with open(path, "wb") as f:
                pickle.dump(arr, f, protocol=4)
        with open(path, "rb") as f:
            data = pickle.load(f)
    else:
        path = os.path.join(data_dir, pkl_name)
        with open(path, "rb") as f:
            data = pickle.load(f)
    data = _to_channels_last(np.asarray(data, np.float32), spec.ndim)
    if not spec.has_flow and spec.generator is None:
        data = data[..., :1]
    return data


def _apply_slices(data: np.ndarray, slices: Slices) -> np.ndarray:
    parts = [data[slice(a, b)] for a, b in slices]
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


_FRACTIONS = {"train": (0.0, 0.70), "val": (0.70, 0.85), "test": (0.85, 1.0)}


def select_split(data: np.ndarray, spec: DatasetSpec, which: str) -> np.ndarray:
    """Public split selector: reference indices with small-series fallback."""
    return _split_or_fraction(data, getattr(spec, which), which)


def load_raw_series(dataset: str, data_dir: str, which: str = "test") -> np.ndarray:
    """Normalized raw series ``[T, *S, C]`` for one split (CLI convenience)."""
    spec = get_spec(dataset)
    data = minmax_normalize(_load_raw(spec, data_dir))
    return select_split(data, spec, which)


def _split_or_fraction(data: np.ndarray, slices: Slices, which: str) -> np.ndarray:
    """Reference index splits; fractional 70/15/15 fallback for short series.

    The reference's splits hard-code its dataset lengths (load_datasets.py:
    193-224); series shorter than those (e.g. freshly generated small data)
    fall back to proportional splits so every mode still works.
    """
    sub = _apply_slices(data, slices)
    if sub.shape[0] >= 9:  # enough for any exp grouping (9-tuples at exp=3)
        return sub
    lo, hi = _FRACTIONS[which]
    n = data.shape[0]
    return data[int(lo * n) : int(hi * n)]


def _prepare(spec: DatasetSpec, data: np.ndarray, slices: Slices, exp: int,
             augment: bool, which: str = "train") -> np.ndarray:
    sub = _split_or_fraction(data, slices, which)
    if sub.ndim in (4, 5):
        # native fused path (csrc/fastprep.cpp): bit-equal to the lines below
        from opticalflowscivis_tpu_torch.data.fastprep import prepare_tuples_native

        return prepare_tuples_native(
            sub,
            exp=exp,
            resample_stride=spec.resample_stride or 1,
            flip_axes=2 if (augment and spec.flip_aug) else 0,
        )
    if spec.resample_stride:
        sub = temporal_resample(sub, spec.resample_stride)
    if augment and spec.flip_aug:
        sub = flip_augment(sub)
    return group_tuples(sub, exp)


def load_data(
    dataset: str,
    exp: int = 1,
    mode: str = "train",
    data_dir: str = "data_cache",
    use_cache: bool = True,
    host_flip_aug: bool | None = None,
):
    """(train_tuples, val_tuples) for mode='train'; test_tuples for mode='test'.

    Prepared tuples are cached as .npy under ``data_dir/prepared/`` keyed by
    (dataset, exp, mode) and invalidated by the source pkl's mtime — the
    normalize/resample/flip/group pipeline costs tens of seconds on the big
    datasets and is fully deterministic.

    ``host_flip_aug=False`` skips the host-side flip augmentation (the trainer
    then applies ``device_flip_augment`` per batch on device instead).
    """
    spec = get_spec(dataset)
    if host_flip_aug is not None and spec.flip_aug != host_flip_aug:
        spec = dataclasses.replace(spec, flip_aug=host_flip_aug)
    if use_cache and (spec.generator is not None or spec.pkl_file):
        src = os.path.join(
            data_dir,
            f"{spec.name}.pkl" if spec.generator is not None else spec.pkl_file,
        )
        cache_dir = os.path.join(data_dir, "prepared")
        tag = f"{spec.name}_exp{exp}_{mode}" + ("" if spec.flip_aug else "_noflip")
        paths = [os.path.join(cache_dir, f"{tag}_{i}.npy") for i in range(2)]
        if use_cache and os.path.exists(src) and all(
            os.path.exists(p) and os.path.getmtime(p) > os.path.getmtime(src)
            for p in (paths if mode == "train" else paths[:1])
        ):
            if mode == "train":
                return np.load(paths[0]), np.load(paths[1])
            return np.load(paths[0])
    else:
        paths = None

    result = _load_data_uncached(spec, exp, mode, data_dir)
    if use_cache and paths is not None:
        os.makedirs(os.path.dirname(paths[0]), exist_ok=True)
        if mode == "train":
            np.save(paths[0], result[0])
            np.save(paths[1], result[1])
        else:
            np.save(paths[0], result)
    return result


def _load_data_uncached(spec: DatasetSpec, exp: int, mode: str, data_dir: str):
    data = minmax_normalize(_load_raw(spec, data_dir))
    if mode == "train":
        if spec.val_pkl_file:  # droplet3d ships pre-split pkls
            val_raw = minmax_normalize(
                _load_raw(spec, data_dir, which_pkl=spec.val_pkl_file)
            )
            train = _prepare(spec, data, spec.train, exp, augment=True, which="train")
            val = _prepare(spec, val_raw, spec.val, exp, augment=False, which="val")
        else:
            train = _prepare(spec, data, spec.train, exp, augment=True, which="train")
            val = _prepare(spec, data, spec.val, exp, augment=False, which="val")
        return train, val
    return _prepare(spec, data, spec.test, exp, augment=False, which="test")
