"""Devices and process group of data-parallel training: the counterpart of
flownet2_tpu/parallel/mesh.py and of the device picking in
flownet2_tpu/cli/train.py:157-171.

The JAX package builds a mesh and lets XLA place the collectives inside one
program. The port runs one process per card, as the reference runs one
solver per GPU (parallel.cpp:152-437), and joins them in a
``torch.distributed`` process group: NCCL between cards, gloo between CPU
processes. Gloo on card tensors is taken only when a caller names it (the
card tests share one card between two processes); it never stands in for
NCCL.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

# how long a collective or the rendezvous waits for a lost rank before failing
DEFAULT_TIMEOUT = timedelta(minutes=5)


@dataclass(frozen=True)
class Group:
    """One rank's view of the data-parallel group: its rank, the world size,
    its device and the backend of the collectives."""

    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        """Rank 0 logs, writes snapshots and is the source of broadcasts."""
        return self.rank == 0


def pick_devices(spec: str, count: Optional[int] = None) -> list[torch.device]:
    """The cards of a ``--gpu`` spec: ``all``, one index, or a comma list of
    indices (the reference's ``caffe train -gpu 0,1`` / ``all``,
    tools/caffe.cpp:175-197). A single number names one card, as ``--gpu N``
    does in every CLI of the port. ``count`` is the number of cards present
    (default ``torch.cuda.device_count()``).

    Raises ValueError on duplicate indices, on an index past the cards
    present, and when there is no card at all; it never picks the CPU."""
    count = torch.cuda.device_count() if count is None else count
    if spec == "all":
        indices = list(range(count))
    else:
        try:
            indices = [int(s) for s in spec.split(",")]
        except ValueError:
            raise ValueError(f"--gpu {spec}: expected 'all', a card index or a comma list of indices") from None
        if len(set(indices)) != len(indices):
            raise ValueError(f"--gpu {spec}: duplicate card index")
        if any(i < 0 for i in indices):
            raise ValueError(f"--gpu {spec}: negative card index")
    if count == 0:
        raise ValueError(f"--gpu {spec}: no CUDA device present (0 present); pass --device cpu to run on the CPU")
    missing = [i for i in indices if i >= count]
    if missing:
        raise ValueError(f"--gpu {spec}: card {missing[0]} not available ({count} present)")
    return [torch.device("cuda", i) for i in indices]


def default_backend(device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_address() -> str:
    """A ``tcp://localhost:PORT`` rendezvous address on a port free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def init_group(
    rank: int,
    world: int,
    device,
    init_method: str,
    *,
    backend: Optional[str] = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> Group:
    """Join the process group as ``rank`` of ``world`` on ``device``
    (``backend`` default: :func:`default_backend`). ``timeout`` bounds the
    rendezvous and every collective, so a lost rank fails the others."""
    device = torch.device(device)
    backend = backend or default_backend(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, timeout=timeout)
    return Group(rank, world, device, backend)
