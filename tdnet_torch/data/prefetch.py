"""Background host-to-device prefetch, the counterpart of
``tdnet/data/prefetch.py``.

A worker thread runs the host pipeline, packs uint8 canvases to
(B, H, W*3) rows (``pack_uint8_host``), and moves each batch to the device,
keeping up to ``buffer_size`` batches in flight. On CUDA it copies every
array into pinned host memory and then to the device with
``non_blocking=True`` on a side stream, and records an event after the
copies. The consumer's stream waits on that event before it uses the batch,
and each tensor is marked with ``record_stream`` for the consumer's stream,
so the caching allocator does not hand its memory to the side stream's next
copy while the step may still read it.

The iterator owns its thread: ``close()`` stops it and drops the buffered
batches.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from tdnet_torch.device import resolve_device
from tdnet_torch.ops.ingest import pack_uint8_host

__all__ = ["DevicePrefetcher"]

_SENTINEL = object()


def _pack_uint8_images(batch):
    """NHWC uint8 canvases -> (B, H, W*3) rows; other batches pass."""
    images = batch.get("images") if isinstance(batch, dict) else None
    if isinstance(images, np.ndarray) and images.dtype == np.uint8 \
            and images.ndim == 4 and images.shape[-1] == 3:
        batch = dict(batch)
        batch["images"] = pack_uint8_host(images)
    return batch


class DevicePrefetcher:
    """Iterator of device-resident batches from a host batch iterator
    (``device`` None means CUDA); see the module docstring."""

    def __init__(self, iterator, device=None, buffer_size: int = 2):
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._err: list = []
        cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None

        def to_device(batch):
            batch = _pack_uint8_images(batch)
            host = {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in batch.items()}
            if not cuda:
                return host, None
            with torch.cuda.stream(self._copy_stream):
                out = {k: v.pin_memory().to(self.device, non_blocking=True)
                       for k, v in host.items()}
                done = torch.cuda.Event()
                done.record(self._copy_stream)
            return out, done

        def worker():
            try:
                for batch in iterator:
                    if self._stop.is_set():
                        return
                    item = to_device(batch)
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except Exception as e:  # raised again in the consumer
                self._err.append(e)
            finally:
                while not self._stop.is_set():
                    try:
                        self._q.put(_SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="tdnet-prefetch")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                continue
        if item is _SENTINEL:
            if self._err:
                raise self._err[0]
            raise StopIteration
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def close(self) -> None:
        """Stop the worker and drop buffered batches."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __del__(self):
        stop = getattr(self, "_stop", None)  # absent if __init__ raised
        if stop is not None:
            stop.set()
