"""Parallelism across processes: data parallelism (``mesh.py``) and ZeRO-1
(``zero.py``). The reference's spatial, tensor and pipeline forms are not
ported yet (ROADMAP A16.3, A16.4)."""

from tdnet_torch.parallel.mesh import (
    barrier,
    initialize_distributed,
    is_distributed,
    process_allgather_rows,
    process_count,
    process_index,
)

__all__ = [
    "barrier",
    "initialize_distributed",
    "is_distributed",
    "process_allgather_rows",
    "process_count",
    "process_index",
]
