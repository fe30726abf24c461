"""Datasets: numpy generators, host pipeline and dataset registry."""

from opticalflowscivis_tpu_torch.data.pipeline import (
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

__all__ = [
    "TupleDataset", "device_flip_augment", "flip_augment", "group_tuples", "minmax_normalize", "pad_to_multiple",
    "temporal_resample",
    "REGISTRY", "DatasetSpec", "get_spec", "load_data", "load_raw_series",
    "select_split",
    "rectangle_2d", "rectangle_3d", "rectangles_2d",
]
