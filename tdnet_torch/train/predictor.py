"""Host-facing predictor: raw BGR pages -> detections in original image
coordinates, the counterpart of ``tdnet/train/predictor.py``.

Per batch: resize on the host, pad into a shape bucket, pad the bucket's
sub-batch to a power of two, run the model and the deferred-decode tail on
the device, then divide the boxes by the resize scale on the host. With
``device_preprocess`` the canvases cross to the device as uint8 and take one
of two routes:

- packed (B, H, W*3) rows -> the fused ingest+stem kernel -> the model from
  its pooled stem output (``fused_stem``; on by default on CUDA for ResNet
  and SE-ResNet backbones);
- flat rows ((R, 3072), or (B*H, W*3) where 3072 does not divide) -> the
  normalize kernel -> the model.

Without it, the host normalizes to float32. On CUDA a kernel failure
raises: there is no fallback route, so ``fused_stem_fallback`` (the
reference's record of a switch to the flat route, which ``serve``'s
``/stats`` reports) is always None, and ``use_pallas=False`` (the
reference's plain-XLA route) raises on CUDA, where the port has no plain
route; on the CPU the plain versions run anyway. ``batch_size`` is the
chunk ``utils/eval.py`` hands to ``predict_batch`` (16 on CUDA, the
counterpart of the reference's TPU default, else 1).
``TDNET_BLOCK_KERNEL=1`` turns on the fused identity-bottleneck kernel of
a ResNet backbone on CUDA for the Predictor's calls (as
``RetinaNet(block_kernel=True)`` does), like the reference's opt-in; the
caller's model keeps its own setting.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from tdnet_torch.data.generator import default_buckets, pick_bucket
from tdnet_torch.data.image import CAFFE_MEAN_BGR, preprocess_image, resize_image
from tdnet_torch.device import resolve_device
from tdnet_torch.models.detect import detections_from_outputs
from tdnet_torch.models.retinanet import takes_fused_stem
from tdnet_torch.ops.anchors import AnchorParameters
from tdnet_torch.ops.ingest import normalize_uint8_rows, pack_uint8_host
from tdnet_torch.ops.stem import fused_stem_packed, supports_shape
from tdnet_torch.weights import torch_state_from_variables

__all__ = ["Predictor", "resolve_device"]


class Predictor:
    """Batched inference on one device (``device`` None means CUDA, and
    raises without a GPU). The predictor owns ``model``: it loads
    ``variables`` (the flax ``{params, batch_stats}`` tree) into it when
    given, and moves it to the device in ``channels_last``."""

    def __init__(
        self,
        model,
        variables: Optional[dict] = None,
        anchor_params: Optional[AnchorParameters] = None,
        min_side: int = 800,
        max_side: int = 1333,
        buckets=None,
        preprocess_mode: str = "caffe",
        score_threshold: float = 0.05,
        max_detections: int = 300,
        nms_threshold: float = 0.5,
        nms: bool = True,
        class_specific_filter: bool = True,
        pre_nms_top_k: int = 1024,
        soft_nms_sigma: float = 0.0,
        device_preprocess: bool = False,
        fused_stem: Optional[bool] = None,
        device=None,
        batch_size: Optional[int] = None,
        use_pallas: Optional[bool] = None,
    ):
        if use_pallas is False and torch.device(device or "cuda").type == "cuda":
            raise ValueError("use_pallas=False asks for the plain route, which "
                             "the port does not run on CUDA: its kernels are "
                             "the only CUDA route")
        self.device = resolve_device(device)
        self.use_pallas = use_pallas
        if batch_size is None:
            batch_size = 16 if self.device.type == "cuda" else 1
        self.batch_size = batch_size
        self.fused_stem_fallback = None
        if variables is not None:
            model.load_state_dict(torch_state_from_variables(variables))
        # deferred tail: keep the heads' dtype at the model boundary (the
        # tail upcasts only its K candidates, exactly)
        if nms and class_specific_filter:
            model.output_dtype = None
        # None: the model's own setting
        self.block_kernel = (
            True if (os.environ.get("TDNET_BLOCK_KERNEL", "0") == "1"
                     and self.device.type == "cuda"
                     and model.backbone_name.startswith("resnet")) else None)
        self.model = model.to(device=self.device,
                              memory_format=torch.channels_last).eval()
        self.anchor_params = anchor_params
        self.min_side = min_side
        self.max_side = max_side
        self.buckets = buckets or default_buckets(min_side, max_side)
        self.preprocess_mode = preprocess_mode
        self.device_preprocess = device_preprocess
        if fused_stem is None:
            fused_stem = (device_preprocess and self.device.type == "cuda"
                          and takes_fused_stem(model.backbone_name)
                          and preprocess_mode in ("caffe", "tf"))
        self.fused_stem = bool(fused_stem)
        self._stem_params = None
        if self.fused_stem:
            with torch.no_grad():
                self._stem_params = self.model.stem_params()
        # cumulative host-prep vs device-dispatch seconds; "dispatch" is the
        # device work plus the result fetch that waits for it
        self.host_prep_s = 0.0
        self.dispatch_s = 0.0
        self.dispatch_count = 0
        self.dispatch_images = 0
        self.det_kwargs = dict(
            score_threshold=score_threshold,
            max_detections=max_detections,
            nms_threshold=nms_threshold,
            nms=nms,
            class_specific_filter=class_specific_filter,
            pre_nms_top_k=pre_nms_top_k,
            soft_nms_sigma=soft_nms_sigma,
        )

    def _run(self, images: torch.Tensor, bucket):
        """Device tensor for one bucket -> Detections."""
        dtype = self.model.dtype
        mode = self.preprocess_mode
        with torch.inference_mode():
            if images.dtype == torch.uint8 and images.dim() == 3:
                k7, inv, off = self._stem_params
                act = fused_stem_packed(images, k7, inv, off, normalize=mode,
                                        out_dtype=dtype)
                outputs = self.model(act, stem_input=True,
                                     block_kernel=self.block_kernel)
            else:
                if images.dtype == torch.uint8:  # 2-D rows: normalize kernel
                    b = images.numel() // (bucket[0] * bucket[1] * 3)
                    images = normalize_uint8_rows(
                        images, mode, out_dtype=dtype
                    ).reshape((b,) + tuple(bucket) + (3,))
                outputs = self.model(images, block_kernel=self.block_kernel)
            return detections_from_outputs(
                outputs, bucket, anchor_params=self.anchor_params,
                **self.det_kwargs)

    def _prepare(self, image_bgr: np.ndarray):
        """One raw BGR image -> (canvas (H, W, 3), scale, bucket)."""
        if self.device_preprocess:
            x, scale = resize_image(image_bgr, min_side=self.min_side,
                                    max_side=self.max_side)
            h, w = x.shape[:2]
            bucket = tuple(pick_bucket(h, w, self.buckets))
            # pad with the mean pixel so the device normalize maps the
            # padding to ~0, like the host path's zero padding
            if self.preprocess_mode == "caffe":
                fill = np.round(CAFFE_MEAN_BGR).astype(np.uint8)
            else:
                fill = np.uint8(128)
            canvas = np.full((bucket[0], bucket[1], 3), fill, dtype=np.uint8)
            canvas[:h, :w, :] = np.clip(x, 0, 255).astype(np.uint8)
        else:
            x = preprocess_image(image_bgr, mode=self.preprocess_mode)
            x, scale = resize_image(x, min_side=self.min_side, max_side=self.max_side)
            h, w = x.shape[:2]
            bucket = tuple(pick_bucket(h, w, self.buckets))
            canvas = np.zeros((bucket[0], bucket[1], 3), dtype=np.float32)
            canvas[:h, :w, :] = x
        return canvas, scale, bucket

    def __call__(self, image_bgr: np.ndarray):
        """One raw BGR image -> (boxes, scores, labels) in its coordinates,
        -1-padded."""
        return self.predict_batch([image_bgr])[0]

    def predict_batch(self, images_bgr):
        """A list of raw BGR images, one device dispatch per shape bucket ->
        a list of (boxes, scores, labels) in input order."""
        t0 = time.monotonic()
        prepped = [self._prepare(img) for img in images_bgr]
        groups: dict = {}
        for i, (_, _, bucket) in enumerate(prepped):
            groups.setdefault(bucket, []).append(i)

        out = [None] * len(prepped)
        for bucket, idxs in groups.items():
            # pad the sub-batch to a power of two (a bounded set of shapes)
            n = len(idxs)
            padded_n = 1 << (n - 1).bit_length() if n > 1 else 1
            stack = np.stack([prepped[i][0] for i in idxs]
                             + [prepped[idxs[0]][0]] * (padded_n - n))
            if stack.dtype == np.uint8 and self.fused_stem \
                    and supports_shape(stack.shape):
                stack = pack_uint8_host(stack)  # packed rows for the stem
            if stack.dtype == np.uint8 and stack.ndim == 4:
                stack = pack_uint8_host(stack, flat=True)  # flat rows
            t_disp = time.monotonic()
            self.host_prep_s += t_disp - t0
            det = self._run(torch.from_numpy(stack).to(self.device), bucket)
            boxes = det.boxes.cpu().numpy().astype(np.float64)
            scores = det.scores.cpu().numpy().astype(np.float64)
            labels = det.labels.cpu().numpy().astype(np.int64)
            t0 = time.monotonic()  # the next group's prep and the rescale
            self.dispatch_s += t0 - t_disp  # count as host time
            self.dispatch_count += 1
            self.dispatch_images += n
            for j, i in enumerate(idxs):
                b, s, l = boxes[j], scores[j], labels[j]
                b[s > -1] /= prepped[i][1]  # host-side rescale
                out[i] = (b, s, l)
        return out
