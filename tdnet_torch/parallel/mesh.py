"""Data parallelism across processes, the counterpart of
``tdnet/parallel/mesh.py``.

The reference runs one SPMD program over a 1-D ``data`` mesh of every
device of every host: parameters replicated, batches sharded on their
leading axis, the gradient all-reduce inserted by XLA. The port runs one
process per card, joined by ``torch.distributed``:

- a rank is one process on one card (or one CPU process in the tests); the
  reference's one process over many local devices maps to as many ranks as
  cards. A run without ``--distributed`` is one rank on one card;
- the data axis is the set of ranks. There is no mesh object: the
  counterparts of ``create_mesh``, ``shard_batch`` and ``make_global_batch``
  reduce to each rank holding its own rows of every global batch, which the
  loader gives it (``data/generator.py`` ``local_batches``), with the
  global batch ``batch_size x`` the number of ranks;
- the gradient all-reduce is ``DistributedDataParallel``'s
  (``train/step.py``), and the host-side gather of the sharded evaluation
  is :func:`process_allgather_rows`.

The backend: ``nccl`` when every rank has a card of its own, ``gloo`` when
ranks share a card, and on the CPU. A rank's card is its rank modulo
``torch.cuda.device_count()``; the ranks tell each other their host and
card through the coordinator's store before the group is made, so the rule
holds across hosts too. The choice is printed, and a failure raises: there
is no switch to another backend.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize_distributed",
    "is_distributed",
    "process_index",
    "process_count",
    "barrier",
    "check_shard",
    "process_allgather_rows",
    "Grid",
    "create_grid",
]

_TIMEOUT = timedelta(minutes=10)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> None:
    """Join the process group of ``num_processes`` ranks whose rank 0
    listens at ``coordinator_address`` ("host:port"); a no-op when
    ``num_processes`` <= 1, as in the reference. ``device`` is where this
    rank computes: a CUDA rank takes card ``process_id %
    device_count()``. Calling it again with the same arguments is a no-op;
    with others it raises."""
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes, process_id):
            raise RuntimeError(
                f"the process group is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}; asked for rank {process_id} of "
                f"{num_processes}")
        return
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                          timeout=_TIMEOUT)
    on_card = torch.device(device).type == "cuda"
    card = None
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on CUDA, but no CUDA GPU is available")
        card = process_id % torch.cuda.device_count()
        torch.cuda.set_device(card)
    store.set(f"tdnet/card/{process_id}", f"{socket.gethostname()}/{card}")
    cards = {store.get(f"tdnet/card/{r}").decode() for r in range(num_processes)}
    backend = "nccl" if on_card and len(cards) == num_processes else "gloo"
    print(f"distributed: rank {process_id} of {num_processes}, backend {backend}"
          + (f", card {card}" if on_card else ", CPU")
          + (" (ranks share a card)" if on_card and backend == "gloo" else ""),
          flush=True)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=_TIMEOUT)


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if is_distributed():
        dist.barrier()


def check_shard(local_rows: int, global_batch: int) -> None:
    """The shape rule of the reference's mesh-sharded kernel wrappers: a
    global batch of ``global_batch`` rows splits evenly over the ranks, and
    this rank's shard holds its ``global_batch / ranks`` of them; else
    raises."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"batch {global_batch} does not divide over the data "
                         f"axis ({n} ranks)")
    if local_rows * n != global_batch:
        raise ValueError(f"this rank holds {local_rows} rows of a batch of "
                         f"{global_batch} over {n} ranks")


@dataclass(frozen=True)
class Grid:
    """This rank's place in a 2-D (data, ``axis``) grid of the ranks.

    ``axis`` is "spatial" or "model"; ``size`` ranks a row share its pages
    (``index`` is this rank's place in the row), ``data_count`` rows split
    the global batch (``data_index`` is this rank's row). ``group`` is the
    row's process group, ``data_group`` the column's; both None for one
    process, where every collective of the forms is the identity."""

    axis: str
    size: int
    index: int
    data_index: int
    data_count: int
    group: object = None
    data_group: object = None

    @property
    def axis_names(self) -> Tuple[str, str]:
        return ("data", self.axis)


def create_grid(n: int, axis: str) -> Grid:
    """The (data, ``axis``) grid of ``n`` ranks along ``axis`` over every
    rank of the process group (one process: a 1-rank grid), with the
    reference's refusal when ``n`` does not divide the ranks. Call it on
    every rank, in the same order: it makes the subgroups."""
    world = process_count()
    if n < 1 or world % n:
        raise ValueError(f"{axis} axis {n} must divide the {world} devices")
    rank = process_index()
    rows = world // n
    if world == 1:
        return Grid(axis, 1, 0, 0, 1)
    row_groups = [dist.new_group([d * n + s for s in range(n)]) for d in range(rows)]
    col_groups = [dist.new_group([d * n + s for d in range(rows)]) for s in range(n)]
    d, s = divmod(rank, n)
    return Grid(axis, n, s, d, rows, row_groups[d], col_groups[s])


def _collective_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_allgather_rows(rows: np.ndarray) -> np.ndarray:
    """All-gather a host (n_local, ...) array across the ranks along axis 0;
    n_local may differ between ranks. The result is the same on every rank,
    in rank order. Without a process group: the input unchanged.

    The block travels as raw bytes, padded to the largest count, so every
    dtype arrives bit for bit (one gather of the counts, one of the
    bytes)."""
    if process_count() == 1:
        return rows
    rows = np.ascontiguousarray(rows)
    dev = _collective_device()
    n = process_count()
    counts = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(n)]
    dist.all_gather(counts, torch.tensor([rows.shape[0]], dtype=torch.int64, device=dev))
    counts = [int(c.item()) for c in counts]
    n_max = max(counts)
    if n_max == 0:
        return rows
    row_bytes = rows.dtype.itemsize * int(np.prod(rows.shape[1:], dtype=np.int64))
    block = np.zeros((n_max, row_bytes), np.uint8)
    block[:rows.shape[0]] = rows.view(np.uint8).reshape(rows.shape[0], row_bytes)
    local = torch.from_numpy(block).to(dev)
    gathered = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(gathered, local)
    out = [g[:c].cpu().numpy().reshape(-1).view(rows.dtype)
           .reshape((c,) + rows.shape[1:]) for g, c in zip(gathered, counts)]
    return np.concatenate(out, axis=0)
