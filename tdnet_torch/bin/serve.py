"""Batch-inference HTTP server for a ``.tdn`` model, the counterpart of
``tdnet/bin/serve.py``: dynamic micro-batching in front of the Predictor.
Concurrent requests are coalesced into one device dispatch (up to
``--max-batch`` images, or ``--max-delay-ms`` of queueing, whichever comes
first), and each request gets its own response.

    python -m tdnet_torch.bin.serve model.tdn --device-normalize --bf16 \\
        --port 8000 --max-batch 16 --max-delay-ms 5

Endpoints:
    GET  /healthz    -> {"status": "ok", "model": ..., "device": ...}
    GET  /stats      -> request and batch counters, latency quantiles, the
                        fused-stem state and the host/dispatch split
    POST /v1/detect  -> body: a PNG, JPEG, BMP or TIFF (decoded as
                        ``cv2.imdecode(..., IMREAD_COLOR)`` does, a JPEG
                        turned by its EXIF orientation) or a raw ``.npy``
                        (H, W, 3) BGR array (Content-Type:
                        application/x-npy); a body that does not decode
                        gets 400. Optional ?threshold=0.5.
                        Returns {"detections": [{"box": [x1, y1, x2, y2],
                        "score": s, "label": i, "name": ...}, ...],
                        "time_ms": t, "image_hw": [h, w]} in image
                        coordinates.

One worker thread owns the Predictor, so responses are the same for a given
request set whatever the arrival order. Runs on CUDA unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from tdnet_torch.data.image import decode_image

__all__ = ["MicroBatcher", "build_server", "parse_args", "main"]


class _Pending:
    __slots__ = ("image", "event", "result", "error", "t0")

    def __init__(self, image):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t0 = time.monotonic()


class MicroBatcher:
    """Coalesce concurrent predict requests into predict_batch calls.

    One worker thread owns the predictor: it blocks on the first queued
    request, then drains the queue until ``max_batch`` images are in hand
    or ``max_delay_ms`` has passed since the first, and runs one
    ``predict_batch`` over them."""

    def __init__(self, predictor, max_batch: int = 16, max_delay_ms: float = 5.0):
        self.predictor = predictor
        self.max_batch = max(1, int(max_batch))
        self.max_delay = max(0.0, float(max_delay_ms)) / 1000.0
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.images = 0
        self.errors = 0
        self._latencies = collections.deque(maxlen=2048)
        self._closed = False
        self._thread = threading.Thread(target=self._run, name="tdnet-batcher",
                                        daemon=True)
        self._thread.start()

    def submit(self, image_bgr: np.ndarray):
        """Blocking predict: (boxes, scores, labels) in image coordinates.
        Raises whatever the predictor raised."""
        p = _Pending(image_bgr)
        # enqueue under the lock: close() takes it too before it enqueues
        # the shutdown sentinel, so no request can land behind the sentinel
        # where the worker would no longer drain it
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self.requests += 1
            self._queue.put(p)
        p.event.wait()
        if p.error is not None:
            raise p.error
        with self._lock:
            self._latencies.append(time.monotonic() - p.t0)
        return p.result

    def _drain(self, first: _Pending):
        batch = [first]
        deadline = time.monotonic() + self.max_delay
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:  # the close sentinel: stop draining
                self._closed = True
                break
            batch.append(nxt)
        return batch

    def _run(self):
        batch = []
        try:
            while True:
                item = self._queue.get()
                if item is None:
                    self._closed = True
                    return
                batch = self._drain(item)
                try:
                    results = self.predictor.predict_batch([p.image for p in batch])
                except Exception as exc:  # every waiter gets the error
                    with self._lock:
                        self.errors += len(batch)
                    for p in batch:
                        p.error = exc
                        p.event.set()
                    batch = []
                    continue
                with self._lock:
                    self.batches += 1
                    self.images += len(batch)
                for p, r in zip(batch, results):
                    p.result = r
                    p.event.set()
                batch = []
                if self._closed:
                    return
        finally:
            # the worker is exiting (the sentinel, or a crash such as a
            # KeyboardInterrupt mid-dispatch): fail the batch in flight and
            # whatever is queued. _closed flips under the lock: a submit
            # that passed its check has already put() and is drained below
            with self._lock:
                self._closed = True
            for p in batch:
                if not p.event.is_set():
                    p.error = RuntimeError("batcher is closed")
                    p.event.set()
            while True:
                try:
                    p = self._queue.get_nowait()
                except queue.Empty:
                    break
                if p is not None:
                    p.error = RuntimeError("batcher is closed")
                    p.event.set()

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)

            def q(f):
                if not lat:
                    return None
                return round(lat[min(len(lat) - 1, int(f * len(lat)))] * 1000, 2)

            return {
                "requests": self.requests,
                "batches": self.batches,
                "images": self.images,
                "errors": self.errors,
                "mean_batch_size": (round(self.images / self.batches, 2)
                                    if self.batches else None),
                "latency_ms": {"p50": q(0.50), "p90": q(0.90), "p99": q(0.99)},
                # True while the fused ingest+stem kernel is the route; the
                # port has no fallback route, so the fallback is always None
                "fused_stem": bool(getattr(self.predictor, "fused_stem", False)),
                "fused_stem_fallback": getattr(self.predictor, "fused_stem_fallback", None),
                # host/device split: dispatch_s is the device work and the
                # result fetch inside predict_batch, host_prep_s the
                # resize/pad/pack time
                "device": self._device_stats(),
            }

    def _device_stats(self):
        pr = self.predictor
        if not getattr(pr, "dispatch_count", 0):
            return None
        return {
            "dispatches": pr.dispatch_count,
            "images": pr.dispatch_images,
            "dispatch_s": round(pr.dispatch_s, 3),
            "host_prep_s": round(pr.host_prep_s, 3),
            "imgs_per_dispatch_sec": (round(pr.dispatch_images / pr.dispatch_s, 2)
                                      if pr.dispatch_s > 0 else None),
        }

    def close(self):
        with self._lock:
            already = self._closed
            self._closed = True
            if not already:
                self._queue.put(None)
        self._thread.join(timeout=5.0)


def _decode_body(raw: bytes, ctype: str, keep_u8: bool) -> np.ndarray:
    """A request body -> an (H, W, 3) BGR image: uint8 where the predictor
    normalizes on the device (it re-quantizes any float input), else
    float32."""
    if "x-npy" in ctype or raw[:6] == b"\x93NUMPY":
        image = np.load(io.BytesIO(raw), allow_pickle=False)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"npy image must be (H, W, 3) BGR, got {image.shape}")
    else:
        # the reference decodes bodies with cv2.imdecode(IMREAD_COLOR)
        try:
            image = decode_image(raw, route="cv2")[:, :, ::-1]
        except ValueError as e:
            raise ValueError(f"could not decode image body: {e}") from None
    if keep_u8 and image.dtype == np.uint8:
        return np.ascontiguousarray(image)
    return np.asarray(image, np.float32)


class _Handler(BaseHTTPRequestHandler):
    # ThreadingHTTPServer: one thread per connection blocks in
    # batcher.submit while the worker thread runs the coalesced dispatch
    protocol_version = "HTTP/1.1"

    def _send_json(self, payload: dict, status: int = 200):
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet unless --verbose
        if self.server.verbose:  # type: ignore[attr-defined]
            super().log_message(fmt, *args)

    def do_GET(self):
        srv = self.server
        if self.path.startswith("/healthz"):
            self._send_json({"status": "ok", "model": srv.model_name,
                             "device": srv.device_kind})
        elif self.path.startswith("/stats"):
            self._send_json(srv.batcher.stats())
        else:
            self._send_json({"error": f"unknown path {self.path}"}, 404)

    def do_POST(self):
        srv = self.server
        if not self.path.startswith("/v1/detect"):
            self._send_json({"error": f"unknown path {self.path}"}, 404)
            return
        try:
            raw = self.rfile.read(int(self.headers.get("Content-Length", "0")))
            image = _decode_body(
                raw, (self.headers.get("Content-Type") or "").lower(),
                bool(getattr(srv.batcher.predictor, "device_preprocess", False)))
        except Exception as exc:
            self._send_json({"error": f"bad request: {exc}"}, 400)
            return
        threshold = srv.default_threshold
        qs = parse_qs(urlsplit(self.path).query)
        if "threshold" in qs:
            try:
                threshold = float(qs["threshold"][0])
            except ValueError:
                self._send_json({"error": "bad threshold"}, 400)
                return
        t0 = time.monotonic()
        try:
            boxes, scores, labels = srv.batcher.submit(image)
        except Exception as exc:
            self._send_json({"error": f"inference failed: {exc}"}, 500)
            return
        dets = []
        for i in np.where(scores > threshold)[0]:
            d = {"box": [round(float(v), 2) for v in boxes[i]],
                 "score": round(float(scores[i]), 4), "label": int(labels[i])}
            if srv.label_names is not None:
                d["name"] = srv.label_names.get(int(labels[i]), str(labels[i]))
            dets.append(d)
        self._send_json({"detections": dets,
                         "time_ms": round((time.monotonic() - t0) * 1000, 2),
                         "image_hw": [int(image.shape[0]), int(image.shape[1])]})


def build_server(predictor, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 16, max_delay_ms: float = 5.0,
                 label_names=None, default_threshold: float = 0.05,
                 model_name: str = "tdnet", verbose: bool = False):
    """(ThreadingHTTPServer, MicroBatcher), not yet serving: call
    ``httpd.serve_forever()`` (in a thread, say), then ``httpd.shutdown()``
    and ``batcher.close()`` to stop."""
    batcher = MicroBatcher(predictor, max_batch=max_batch, max_delay_ms=max_delay_ms)

    class _Server(ThreadingHTTPServer):
        # more than max_batch concurrent clients is the point; the default
        # backlog of 5 resets connection bursts before accept() sees them
        request_queue_size = 128
        daemon_threads = True

    httpd = _Server((host, port), _Handler)
    httpd.batcher = batcher
    httpd.label_names = label_names
    httpd.default_threshold = default_threshold
    httpd.model_name = model_name
    dev = getattr(predictor, "device", torch.device("cpu"))
    httpd.device_kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else dev.type)
    httpd.verbose = verbose
    return httpd, batcher


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Serve a tdnet_torch model over HTTP with dynamic batching.")
    parser.add_argument("model", help=".tdn model bundle")
    parser.add_argument("--host", default="127.0.0.1", type=str)
    parser.add_argument("--port", default=8000, type=int)
    parser.add_argument("--max-batch", default=16, type=int,
                        help="largest coalesced device batch")
    parser.add_argument("--max-delay-ms", default=5.0, type=float,
                        help="longest a request waits for batch-mates")
    parser.add_argument("--score-threshold", default=0.05, type=float,
                        help="default report threshold (per request: ?threshold=)")
    parser.add_argument("--labels", default=None, type=str,
                        help="optional classes.csv for label names")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device-normalize", action="store_true",
                        help="ship uint8 and normalize on the device (with a "
                             "ResNet on CUDA: the fused ingest+stem kernel)")
    parser.add_argument("--no-pallas", dest="use_pallas", action="store_false",
                        default=None, help="the plain route: CPU only")
    parser.add_argument("--pre-nms-top-k", default=1024, type=int)
    parser.add_argument("--soft-nms-sigma", default=None, type=float)
    parser.add_argument("--eval-batch-size", dest="predict_batch_size",
                        default=None, type=int,
                        help="Predictor batch size (default: 16 on CUDA)")
    parser.add_argument("--verbose", action="store_true", help="per-request access log")
    parser.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.use_pallas is False and torch.device(args.device).type == "cuda":
        parser.error("--no-pallas asks for the plain route, which the port "
                     "runs only on the CPU (--device cpu)")
    return args


def main(argv=None) -> int:
    from tdnet_torch.bin.predict import label_names_from_csv, predictor_from_bundle

    args = parse_args(argv)
    predictor = predictor_from_bundle(args.model, args,
                                      device_preprocess=args.device_normalize,
                                      batch_size=args.predict_batch_size)
    label_names = label_names_from_csv(args.labels) if args.labels else None
    httpd, batcher = build_server(
        predictor, host=args.host, port=args.port, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, label_names=label_names,
        default_threshold=args.score_threshold, model_name=args.model,
        verbose=args.verbose)
    print(f"tdnet-torch-serve: {args.model} on http://{args.host}:"
          f"{httpd.server_address[1]} (max_batch={args.max_batch}, "
          f"max_delay={args.max_delay_ms}ms, device={httpd.device_kind})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        batcher.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
