"""Bucketed batch loader (host side), the counterpart of
``tdnet/data/generator.py``.

Every resized image is padded top-left into one of a fixed set of canvases
(shape buckets), so each bucket runs one set of shapes. Ground truth leaves
as fixed-size padded arrays with a validity mask; target assignment happens
on the device inside the train step.

Batch dict (numpy):
  images   (B, H, W, 3)  float32 normalized BGR, zero-padded; or uint8 with
                         ``device_normalize``, padded with the mean pixel
  gt_boxes (B, M, 4) float32, gt_labels (B, M) int32, gt_mask (B, M) bool
  image_hw (B, 2) float32 unpadded sizes; scale (B,) resize scales
  indices  (B,) int32 dataset indices

The Dataset protocol is the reference's: ``size()``, ``load_image(i)``
(BGR array), ``load_annotations(i)`` ({"bboxes" (m, 4), "labels" (m,)}),
``image_aspect_ratio(i)``, ``num_classes()``, and optionally
``max_annotations()``.

With ``random_transform`` each image is warped by a random affine
transform (the reference's ``--random-transform`` ranges, ``transform.py``)
before it is normalized and resized, and its boxes go through
``transform_aabb`` and are clipped to the image again. The transforms come
from their own stream, seeded with ``seed + 1`` and drawn one a local
image in order before a batch's loads start, so worker threads do not race
for it and a run is reproducible.
"""

from __future__ import annotations

import math
import warnings
import weakref
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tdnet_torch.data.image import CAFFE_MEAN_BGR, preprocess_image, resize_image
from tdnet_torch.data.transform import (TransformParameters, adjust_transform_for_image,
                                        apply_transform, random_transform_generator,
                                        transform_aabb)
from tdnet_torch.parallel.mesh import process_count, process_index

__all__ = ["LoaderConfig", "BatchLoader", "default_buckets", "pick_bucket"]


def _round_up(x: int, m: int = 32) -> int:
    return int(math.ceil(x / m) * m)


def default_buckets(min_side: int = 800, max_side: int = 1333) -> List[Tuple[int, int]]:
    """Landscape and portrait canvases, dims rounded up to 32: for the
    default 800/1333 rule, (800, 1344) and (1344, 800)."""
    lo, hi = _round_up(min_side), _round_up(max_side)
    if lo == hi:
        return [(lo, hi)]
    return [(lo, hi), (hi, lo)]


def pick_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Smallest-area bucket that fits (h, w)."""
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if fitting:
        return min(fitting, key=lambda b: b[0] * b[1])
    raise ValueError(
        f"image of resized shape ({h}, {w}) fits no configured bucket "
        f"{list(buckets)}; add a bucket of at least that size")


@dataclass
class LoaderConfig:
    batch_size: int = 1
    min_side: int = 800
    max_side: int = 1333
    # GT padding width; None sizes it to the densest image (floor 64,
    # rounded up to a multiple of 8)
    max_boxes: Optional[int] = None
    preprocess_mode: str = "caffe"
    # ship uint8 canvases; the train step normalizes them on the device
    device_normalize: bool = False
    buckets: Optional[List[Tuple[int, int]]] = None
    shuffle: bool = True
    seed: int = 0
    # augmentation (the reference's --random-transform)
    random_transform: bool = False
    transform_parameters: TransformParameters = field(default_factory=TransformParameters)
    # multi-process slicing of every global batch: every rank computes the
    # same global batch sequence and loads its strided slice of each. None
    # resolves from the process group (parallel/mesh.py) at loader build.
    # Under a 2-D grid (parallel/mesh.py Grid) the ranks of a row load the
    # same pages: pass the grid's data_index and data_count, not the rank
    process_index: Optional[int] = None
    process_count: Optional[int] = None
    # host decode/resize threads; 0 or 1 = in the iterator's thread
    workers: int = 0

    def resolved_buckets(self) -> List[Tuple[int, int]]:
        return self.buckets or default_buckets(self.min_side, self.max_side)


class BatchLoader:
    """Fixed-shape batches over a Dataset, grouped by bucket. Every process
    computes the same global batch sequence (same seed -> same shuffle,
    buckets and chunking) and takes its strided slice of each."""

    _densest_cache = weakref.WeakKeyDictionary()

    def __init__(self, dataset, config: LoaderConfig):
        self.dataset = dataset
        self.config = config
        self._rng = np.random.RandomState(config.seed)
        if config.process_index is None or config.process_count is None:
            self.process_index, self.process_count = process_index(), process_count()
        else:
            self.process_index = config.process_index
            self.process_count = config.process_count
        self._pool = None
        if config.workers and config.workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=config.workers, thread_name_prefix="tdnet-loader")
        self._transform_gen = None
        if config.random_transform:  # the reference's --random-transform ranges
            self._transform_gen = random_transform_generator(
                min_rotation=-0.1,
                max_rotation=0.1,
                min_translation=(-0.1, -0.1),
                max_translation=(0.1, 0.1),
                min_shear=-0.1,
                max_shear=0.1,
                min_scaling=(0.9, 0.9),
                max_scaling=(1.1, 1.1),
                flip_x_chance=0.5,
                prng=np.random.RandomState(config.seed + 1),
            )
        self._bucket_of: dict = {}
        if config.max_boxes is not None:
            self.max_boxes = int(config.max_boxes)
        else:
            self.max_boxes = self._auto_max_boxes(dataset)

    @classmethod
    def _auto_max_boxes(cls, dataset) -> int:
        """The densest image's box count (cached per dataset object), floor
        64, rounded up to a multiple of 8; ``max_annotations()`` skips the
        scan."""
        hint = getattr(dataset, "max_annotations", None)
        if callable(hint):
            densest = int(hint())
        else:
            try:
                densest = cls._densest_cache.get(dataset)
            except TypeError:  # unhashable dataset object
                densest = None
            if densest is None:
                densest = max((len(dataset.load_annotations(i)["labels"])
                               for i in range(dataset.size())), default=0)
                try:
                    cls._densest_cache[dataset] = densest
                except TypeError:
                    pass
        return max(64, int(math.ceil(densest / 8)) * 8)

    @property
    def num_classes(self) -> int:
        return self.dataset.num_classes()

    def steps_per_epoch(self) -> int:
        """Batches per epoch(), the same on every process: per-bucket ceil
        over the global batch size."""
        gbs = self.config.batch_size * self.process_count
        counts: dict = {}
        for idx in range(self.dataset.size()):
            bkt = self._bucket_for_index(idx)
            counts[bkt] = counts.get(bkt, 0) + 1
        return sum(math.ceil(n / gbs) for n in counts.values())

    def _bucket_for_index(self, idx: int) -> Tuple[int, int]:
        bkt = self._bucket_of.get(idx)
        if bkt is None:
            ar = self.dataset.image_aspect_ratio(idx)
            if ar >= 1.0:
                h, w = self.config.min_side, min(
                    self.config.max_side, int(round(self.config.min_side * ar)))
            else:
                w, h = self.config.min_side, min(
                    self.config.max_side, int(round(self.config.min_side / ar)))
            bkt = pick_bucket(h, w, self.config.resolved_buckets())
            self._bucket_of[idx] = bkt
        return bkt

    def _load_entry(self, index: int, transform=None):
        """Load, filter boxes, warp by ``transform`` (drawn beforehand),
        resize, normalize one image: (image, boxes (m, 4) f32, labels (m,)
        i32, scale)."""
        image = self.dataset.load_image(index)
        ann = self.dataset.load_annotations(index)
        boxes = ann["bboxes"].astype(np.float64).copy()
        labels = ann["labels"].astype(np.int32).copy()
        if len(boxes):  # drop degenerate and out-of-image boxes
            h, w = image.shape[:2]
            keep = ((boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
                    & (boxes[:, 0] >= 0) & (boxes[:, 1] >= 0)
                    & (boxes[:, 2] <= w) & (boxes[:, 3] <= h))
            boxes, labels = boxes[keep], labels[keep]
        if transform is not None:
            params = self.config.transform_parameters
            t = adjust_transform_for_image(transform, image, params.relative_translation)
            image = apply_transform(t, image, params)
            for i in range(len(boxes)):
                boxes[i, :] = transform_aabb(t, boxes[i, :])
            h, w = image.shape[:2]
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
        if not self.config.device_normalize:
            image = preprocess_image(image, mode=self.config.preprocess_mode)
        image, scale = resize_image(image, min_side=self.config.min_side,
                                    max_side=self.config.max_side)
        boxes = boxes * scale
        if self.config.device_normalize:
            image = np.clip(image, 0, 255).astype(np.uint8)
            return image, boxes.astype(np.float32), labels, scale
        return image.astype(np.float32), boxes.astype(np.float32), labels, scale

    def _assemble(self, entries, indices, bucket):
        bh, bw = bucket
        b = len(entries)
        m = self.max_boxes
        if self.config.device_normalize:
            # pad with the mean pixel, which the device normalize maps to ~0
            # like the host path's zero padding
            fill = (np.round(CAFFE_MEAN_BGR).astype(np.uint8)
                    if self.config.preprocess_mode == "caffe" else np.uint8(128))
            images = np.empty((b, bh, bw, 3), dtype=np.uint8)
            images[...] = fill
        else:
            images = np.zeros((b, bh, bw, 3), dtype=np.float32)
        batch = {
            "images": images,
            "gt_boxes": np.zeros((b, m, 4), dtype=np.float32),
            "gt_labels": np.zeros((b, m), dtype=np.int32),
            "gt_mask": np.zeros((b, m), dtype=bool),
            "image_hw": np.zeros((b, 2), dtype=np.float32),
            "scale": np.zeros((b,), dtype=np.float32),
            "indices": np.asarray(indices, dtype=np.int32),
        }
        for i, (img, boxes, labels, scale) in enumerate(entries):
            h, w = img.shape[:2]
            batch["images"][i, :h, :w, :] = img
            n = min(len(boxes), m)
            if len(boxes) > m:
                warnings.warn(f"image has {len(boxes)} boxes; truncating to "
                              f"max_boxes={m}")
            batch["gt_boxes"][i, :n] = boxes[:n]
            batch["gt_labels"][i, :n] = labels[:n]
            batch["gt_mask"][i, :n] = True
            batch["image_hw"][i] = (h, w)
            batch["scale"][i] = scale
        return batch

    def _global_batches(self) -> List[Tuple[Tuple[int, int], List[int]]]:
        """The epoch's global batches: shuffle, group by bucket, chunk by the
        global batch size, repeat-pad each bucket's last chunk."""
        order = np.arange(self.dataset.size())
        if self.config.shuffle:
            self._rng.shuffle(order)
        groups: dict = {}
        for idx in order:
            idx = int(idx)
            groups.setdefault(self._bucket_for_index(idx), []).append(idx)
        gbs = self.config.batch_size * self.process_count
        batches = []
        for bucket, idxs in groups.items():
            for start in range(0, len(idxs), gbs):
                chunk = idxs[start:start + gbs]
                while len(chunk) < gbs:
                    chunk = chunk + chunk[:gbs - len(chunk)]
                batches.append((bucket, chunk))
        return batches

    def local_batches(self) -> List[Tuple[Tuple[int, int], List[int]]]:
        p, n = self.process_index, self.process_count
        return [(bucket, chunk[p::n]) for bucket, chunk in self._global_batches()]

    def __iter__(self) -> Iterator[dict]:
        return self.epoch()

    def epoch(self) -> Iterator[dict]:
        """One epoch of this process's batches."""
        for bucket, chunk in self.local_batches():
            transforms = [next(self._transform_gen) if self._transform_gen else None
                          for _ in chunk]
            if self._pool is not None:
                entries = list(self._pool.map(self._load_entry, chunk, transforms))
            else:
                entries = [self._load_entry(i, t) for i, t in zip(chunk, transforms)]
            yield self._assemble(entries, chunk, bucket)

    def forever(self) -> Iterator[dict]:
        while True:
            yield from self.epoch()

    def skip_epochs(self, n: int) -> None:
        """Advance the shuffle and transform streams past n epochs without
        loading pixels (one shuffle an epoch, one transform a local image),
        so a resumed run sees the batches the unbroken run would have."""
        for _ in range(max(0, int(n))):
            for _, chunk in self.local_batches():
                if self._transform_gen is not None:
                    for _ in chunk:
                        next(self._transform_gen)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
