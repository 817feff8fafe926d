"""Training loop: epochs, metrics, the LR plateau schedule, checkpoints and
eval, the counterpart of ``tdnet/train/loop.py``.

Per-epoch checkpoints, resume from an epoch, per-epoch eval every
``eval_every`` epochs (and always after the last), Keras
``ReduceLROnPlateau(monitor='loss', factor=0.1, patience=2)``, and step
metrics (loss parts, lr, images/s) to stdout and JSONL. Metrics are summed
on the device and read back only at log time, so the host does not wait for
the device on every step.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

__all__ = ["ReduceLROnPlateau", "MetricsWriter", "EpochCloser",
           "RssBudgetExceeded", "RSS_BUDGET_EXIT_CODE", "fit",
           "get_learning_rate", "set_learning_rate"]

# sysexits EX_TEMPFAIL: a supervisor relaunches with the snapshot
RSS_BUDGET_EXIT_CODE = 75


class RssBudgetExceeded(RuntimeError):
    """Raised by fit() after the epoch checkpoint when host RSS crossed
    ``rss_budget_mb``: the run is healthy but should checkpoint, exit and
    resume. Carries the last state."""

    def __init__(self, state, epoch: int, rss_mb: float, budget_mb: float):
        super().__init__(
            f"host RSS {rss_mb:.0f} MB crossed the {budget_mb:.0f} MB "
            f"budget after epoch {epoch}; checkpoint saved — relaunch and "
            f"resume from it (exit code {RSS_BUDGET_EXIT_CODE})")
        self.state = state
        self.epoch = epoch
        self.rss_mb = rss_mb


def get_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@dataclass
class ReduceLROnPlateau:
    """Keras-parity plateau schedule (monitor 'loss', factor 0.1, patience
    2, min_delta 0)."""

    factor: float = 0.1
    patience: int = 2
    min_delta: float = 0.0
    min_lr: float = 0.0
    verbose: bool = True

    best: float = float("inf")
    wait: int = 0

    def update(self, monitored: float, lr: float) -> float:
        if monitored < self.best - self.min_delta:
            self.best = monitored
            self.wait = 0
            return lr
        self.wait += 1
        if self.wait >= self.patience:
            new_lr = max(lr * self.factor, self.min_lr)
            self.wait = 0
            if self.verbose and new_lr < lr:
                print(f"ReduceLROnPlateau: lr {lr:.3g} -> {new_lr:.3g}", flush=True)
            return new_lr
        return lr


class MetricsWriter:
    """JSONL step and epoch metrics. TensorBoard scalars are not ported:
    the reference writes them through tensorflow (ROADMAP A11, slice 4)."""

    def __init__(self, path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None):
        if tensorboard_dir:
            raise NotImplementedError(
                "tensorboard_dir is not ported (ROADMAP A11, slice 4)")
        self._f = open(path, "a") if path else None

    def write(self, record: dict) -> None:
        if self._f is not None:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


class EpochCloser:
    """End of an epoch: the loss-spike warning, host RSS, eval_every gating
    and the epoch JSONL record."""

    def __init__(self, writer: MetricsWriter, epochs: int,
                 eval_every: int = 1, initial_epoch: int = 0):
        self.writer = writer
        self.epochs = epochs
        self.eval_every = max(1, eval_every)
        self.initial_epoch = initial_epoch
        self.prev_epoch_loss: Optional[float] = None

    def should_eval(self, epoch: int) -> bool:
        """Every eval_every-th epoch, and always the final one."""
        return ((epoch + 1 - self.initial_epoch) % self.eval_every == 0
                or epoch == self.epochs - 1)

    def close(self, epoch: int, epoch_loss: float, epoch_time_s: float,
              eval_metrics: Optional[dict] = None) -> dict:
        rec = {"epoch": epoch, "epoch_loss": round(epoch_loss, 5),
               "epoch_time_s": round(epoch_time_s, 2)}
        # a >10x single-epoch loss jump is the Adam second-moment collapse
        # the reference measured at low loss: flag it
        if (self.prev_epoch_loss is not None and self.prev_epoch_loss > 0
                and epoch_loss > 10.0 * self.prev_epoch_loss):
            rec["loss_spike"] = True
            print(f"tdnet: WARNING epoch {epoch} loss jumped "
                  f"{epoch_loss / self.prev_epoch_loss:.1f}x "
                  f"({self.prev_epoch_loss:.4g} -> {epoch_loss:.4g}) — likely "
                  "optimizer divergence; consider resuming from the last "
                  "snapshot with a lower lr or a tighter clipnorm.", flush=True)
        self.prev_epoch_loss = epoch_loss
        rec["host_rss_mb"] = round(_rss_mb(), 1)
        if eval_metrics is not None:
            rec.update({k: (round(v, 5) if isinstance(v, float) else v)
                        for k, v in eval_metrics.items()})
        print(json.dumps(rec), flush=True)
        self.writer.write(rec)
        return rec


def _rss_mb() -> float:
    """Host resident-set size in MB (0.0 where /proc is unavailable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def _profiler(profile_dir: str, device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=lambda p: p.export_chrome_trace(
            os.path.join(profile_dir, "trace.json")))


def fit(
    state,
    train_step: Callable,
    batch_iterator,
    steps_per_epoch: int,
    epochs: int,
    checkpointer=None,
    evaluate_fn: Optional[Callable] = None,
    lr_schedule: Optional[ReduceLROnPlateau] = None,
    metrics_path: Optional[str] = None,
    tensorboard_dir: Optional[str] = None,
    log_every: int = 50,
    initial_epoch: int = 0,
    profile_dir: Optional[str] = None,
    eval_every: int = 1,
    rss_budget_mb: Optional[float] = None,
):
    """Run the training loop; returns the final state.

    ``batch_iterator`` yields device batches (``data.prefetch``).
    ``evaluate_fn(state)`` -> dict of eval metrics, run at each
    ``eval_every``-th epoch end and always after the final epoch.
    ``profile_dir`` traces the second epoch with ``torch.profiler`` into
    ``profile_dir/trace.json``.
    """
    writer = MetricsWriter(metrics_path, tensorboard_dir)
    batches_per_log = max(1, log_every)
    closer = EpochCloser(writer, epochs=epochs, eval_every=eval_every,
                         initial_epoch=initial_epoch)
    prof = None
    try:
        for epoch in range(initial_epoch, epochs):
            if profile_dir and epoch == initial_epoch + 1:
                prof = _profiler(profile_dir, state.device)
                prof.start()
            epoch_start = time.time()
            sums: dict = {}
            window_start = time.time()
            window_images = 0

            for step_in_epoch in range(steps_per_epoch):
                batch = next(batch_iterator)
                state, metrics = train_step(state, batch)
                window_images += batch["images"].shape[0]
                # summed on the device; read back only at log time
                for k, v in metrics.items():
                    sums[k] = sums[k] + v if k in sums else v

                if (step_in_epoch + 1) % batches_per_log == 0:
                    host_sums = {k: float(v) for k, v in sums.items()}
                    elapsed = time.time() - window_start
                    rec = {
                        "epoch": epoch,
                        "step": int(state.step),
                        "lr": get_learning_rate(state.optimizer),
                        "images_per_sec": round(window_images / max(elapsed, 1e-9), 2),
                        **{k: round(v / (step_in_epoch + 1), 5)
                           for k, v in host_sums.items()},
                    }
                    print(json.dumps(rec), flush=True)
                    writer.write(rec)
                    window_start = time.time()
                    window_images = 0

            epoch_loss = float(sums.get("loss", 0.0)) / max(steps_per_epoch, 1)
            eval_metrics = (evaluate_fn(state)
                            if evaluate_fn is not None and closer.should_eval(epoch)
                            else None)
            closer.close(epoch, epoch_loss, time.time() - epoch_start,
                         eval_metrics)

            if checkpointer is not None:
                checkpointer.save(int(state.step), state)

            if rss_budget_mb is not None and epoch < epochs - 1:
                rss = _rss_mb()
                if rss > rss_budget_mb:
                    raise RssBudgetExceeded(state, epoch, rss, rss_budget_mb)

            if lr_schedule is not None:
                lr = get_learning_rate(state.optimizer)
                new_lr = lr_schedule.update(epoch_loss, lr)
                if new_lr != lr:
                    set_learning_rate(state.optimizer, new_lr)
            if prof is not None:
                prof.stop()
                prof = None
    finally:
        if prof is not None:
            prof.stop()
        writer.close()
    return state
