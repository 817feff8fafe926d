"""Host-side data: the page decoders, numpy image preprocessing, shape
buckets, the datasets, the batch loader and the device prefetcher. The
package exports the names of ``tdnet/data/__init__.py``."""

from tdnet_torch.data.csv_dataset import CSVDataset, read_annotations, read_classes
from tdnet_torch.data.generator import BatchLoader, LoaderConfig, default_buckets, pick_bucket
from tdnet_torch.data.image import (
    CAFFE_MEAN_BGR,
    compute_resize_scale,
    preprocess_image,
    read_image_bgr,
    resize_image,
)
from tdnet_torch.data.prefetch import prefetch_to_device
from tdnet_torch.data.transform import TransformParameters, random_transform_generator

__all__ = [
    "CSVDataset",
    "read_annotations",
    "read_classes",
    "BatchLoader",
    "LoaderConfig",
    "default_buckets",
    "pick_bucket",
    "CAFFE_MEAN_BGR",
    "compute_resize_scale",
    "preprocess_image",
    "read_image_bgr",
    "resize_image",
    "prefetch_to_device",
    "TransformParameters",
    "random_transform_generator",
]
