"""Datasets: numpy generators and their on-device counterparts, host
pipeline, dataset registry, the KITTI readers, samplers and frame store, and
the Vimeo90K triplet stream."""

from opticalflowscivis_tpu_torch.data.device_synthetic import (
    box_density_device,
    pan_pairs_device,
    pan_scene_host,
    tuple_positions,
)
from opticalflowscivis_tpu_torch.data.kitti import (
    KittiHBMCache,
    KittiPairDataset,
    device_batch,
    kitti_photometric_normalize,
    load_kitti_eval_pairs,
    read_flo,
    read_kitti_flow_png,
    write_flo,
    write_kitti_flow_png,
)
from opticalflowscivis_tpu_torch.data.pipeline import (
    PrefetchSampler,
    TupleDataset,
    device_flip_augment,
    flip_augment,
    group_tuples,
    minmax_normalize,
    pad_to_multiple,
    temporal_resample,
)
from opticalflowscivis_tpu_torch.data.registry import (
    REGISTRY,
    DatasetSpec,
    get_spec,
    load_data,
    load_raw_series,
    select_split,
)
from opticalflowscivis_tpu_torch.data.synthetic import (
    rectangle_2d,
    rectangle_3d,
    rectangles_2d,
)
from opticalflowscivis_tpu_torch.data.vimeo import VimeoDataset

__all__ = [
    "KittiHBMCache", "KittiPairDataset", "device_batch", "kitti_photometric_normalize",
    "load_kitti_eval_pairs", "read_flo", "read_kitti_flow_png", "write_flo",
    "write_kitti_flow_png", "PrefetchSampler",
    "TupleDataset", "device_flip_augment", "flip_augment", "group_tuples", "minmax_normalize", "pad_to_multiple",
    "temporal_resample",
    "REGISTRY", "DatasetSpec", "get_spec", "load_data", "load_raw_series",
    "select_split",
    "rectangle_2d", "rectangle_3d", "rectangles_2d",
    "box_density_device", "pan_pairs_device", "pan_scene_host", "tuple_positions",
    "VimeoDataset",
]
