"""What every traffic driver shares: the process clock, the reference's
exact float32, the result of a run, and the checks that decide ``correct``."""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

# modules that no run may load, compared by the name before the first dot
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "flownet2_tpu")


def since_process_start() -> float:
    """Seconds since this process started, interpreter start-up included:
    the boot-time clock less the process's start time from /proc/self/stat."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")  # field 22, starttime
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


class Phases:
    """Seconds of each phase of set-up since the last mark, printed to standard error."""

    def __init__(self):
        self.t, self.parts = time.perf_counter(), []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append((name, now - self.t))
        self.t = now

    def report(self) -> None:
        print("setup: " + ", ".join(f"{n} {s:.3f} s" for n, s in self.parts), file=sys.stderr)


def forbidden_loaded(modules) -> list:
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN_MODULES))


@contextlib.contextmanager
def exact_float32():
    """cuDNN convolutions and CUDA matmuls in IEEE float32 (TF32 off) inside;
    the global flags as they were outside."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


@dataclass
class Check:
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # False for NaN


@dataclass
class Result:
    """A run as a traffic driver hands it back."""

    setup_s: float
    attempted: int
    failed: int
    end_to_end: dict  # metric name -> value
    memory_peak_bytes: int
    checks: dict = field(default_factory=dict)  # name -> Check
    stretch: Optional[object] = None  # trace.Stretch of a --trace 1 run


def sync(device) -> None:
    """Wait for a card's queue; nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
