"""Inference traffic: one client, closed loop, through ``FlowRunner``.

A request is a call that hands the runner host frames (uint8, (H, W, 3)
each) and returns when the flow is on the host: ``FlowRunner.__call__`` for
one pair, as ``run_flownet_many`` calls it per job, and ``FlowRunner.batch``
for several. Requests cycle a pool of distinct pairs made from the seed
(``harness/data.py``), back to back. The cell's file sets the frame size,
the pairs a request, the pool, the warm-up, the traced stretch, the
requests sampled for the check and the check's limit.

``correct``: the flows of ``check_requests`` requests, drawn from the seed
among those the window completed (a reservoir sample), against the plain
reference (``reference/nets.py::run_flownet``, IEEE float32) on the same
frames and weights: ``flow_epe``, the worst request's mean end-point
distance in pixels between the program's flow and the reference's.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness.common import Check, Phases, Result, exact_float32, since_process_start, sync
from benchmark.harness.data import make_pairs
from benchmark.harness.trace import Tracer
from benchmark.harness.weights import make_weights
from benchmark.reference import nets

REF_BLOCK = 8  # pairs the reference runs at once


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.items = k, []
        self.rng = np.random.default_rng([seed, 1])

    def offer(self, i: int, item) -> None:
        if i < self.k:
            self.items.append((i, item))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.items[j] = (i, item)


def build(cell, seed: int, device, phases: Phases | None = None, dtype=None):
    """(pool of (img0, img1) host batches, weights, runner, request call);
    ``dtype`` goes to ``FlowRunner`` (None: float32, as the configuration states)."""
    from flownet2_tpu_torch.inference import FlowRunner

    tr, model = cell.traffic, cell.config["model"]
    phases = phases or Phases()
    n = tr["pairs_per_request"]
    data = make_pairs(tr["pool_requests"] * n, tr["height"], tr["width"], seed, device)
    pool = [(data["img0"][i * n:(i + 1) * n], data["img1"][i * n:(i + 1) * n]) for i in range(tr["pool_requests"])]
    phases.mark("pairs")
    params = make_weights(model, seed, device)
    phases.mark("weights")
    runner = FlowRunner(model, params, device=device, dtype=dtype)
    phases.mark("runner")
    if n == 1:
        def call(a, b):
            return runner(a[0], b[0])[None]
    else:
        call = runner.batch
    return pool, params, runner, call


def reference_flows(params: dict, model: str, img0: np.ndarray, img1: np.ndarray, device) -> torch.Tensor:
    """The reference's (N, H, W, 2) flow, on the host, in blocks of pairs."""
    P = nets.prepare(params, model, device)
    ops = nets.Ops()
    out = []
    with exact_float32(), torch.no_grad():
        for i in range(0, len(img0), REF_BLOCK):
            a = torch.from_numpy(img0[i:i + REF_BLOCK]).to(device)
            b = torch.from_numpy(img1[i:i + REF_BLOCK]).to(device)
            out.append(nets.run_flownet(ops, P, a, b).cpu())
    return torch.cat(out)


def run(cell, seed: int, seconds: float, trace: bool, device) -> Result:
    tr = cell.traffic
    phases = Phases()
    pool, params, runner, call = build(cell, seed, device, phases)
    for i in range(tr["warmup_requests"]):
        call(*pool[i % len(pool)])
    sync(device)
    phases.mark("warm-up")
    setup_s = since_process_start()
    phases.report()

    sample = Reservoir(tr["check_requests"], seed)
    tracer, traced_from, stretch = None, None, None
    latencies, i = [], 0
    t0 = time.perf_counter()
    while True:
        if trace and tracer is None and time.perf_counter() - t0 >= seconds / 3:
            tracer, traced_from = Tracer(), i
            tracer.start()
        with record_function("bench.request"):
            ts = time.perf_counter()
            flow = call(*pool[i % len(pool)])
            te = time.perf_counter()
        latencies.append(te - ts)
        sample.offer(i, flow)
        i += 1
        if tracer is not None and stretch is None and i - traced_from == tr["stretch_requests"]:
            tracer.stop()
            units = {"requests": tr["stretch_requests"], "pairs": tr["stretch_requests"] * tr["pairs_per_request"]}
            stretch = tracer.stretch(units, dict(tr, model=cell.config["model"]))
        if te - t0 >= seconds and (not trace or stretch is not None):
            break
    window = te - t0
    pairs = i * tr["pairs_per_request"]
    e2e = {"pairs_per_s": pairs / window, "latency_p95_ms": float(np.percentile(latencies, 95)) * 1e3}
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0

    del runner, call
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    epes = []
    for idx, flow in sample.items:
        a, b = pool[idx % len(pool)]
        ref = reference_flows(params, cell.config["model"], a, b, device)
        epes.append(mean_epe(torch.from_numpy(np.asarray(flow)), ref))
    checks = {"flow_epe": Check(max(epes), cell.limits["flow_epe"])}
    return Result(setup_s, i, 0, e2e, peak, checks, stretch)


def readings(cell, seed: int, device, control: bool, fault: str | None = None) -> dict:
    """The comparison's numbers on the requests a run samples first (pool
    requests 0 .. check_requests - 1), for setting its limit: the program's
    (with ``fault`` planted, ``harness/faults.py``), and with ``control`` the
    control's: the program's own bfloat16 path (``FlowRunner(dtype=
    "bfloat16")``, weights and activations in bfloat16) on the same requests."""
    from benchmark.harness.faults import planted

    tr = cell.traffic
    sides = {"program": None, "control": torch.bfloat16} if control else {"program": None}
    flows = {}
    for side, dtype in sides.items():
        with planted(fault if side == "program" else None):
            pool, params, runner, call = build(cell, seed, device, dtype=dtype)
            flows[side] = [call(*pool[i]) for i in range(tr["check_requests"])]
        del runner, call
        gc.collect()
    out = {"program": [], "control": []}
    for i in range(tr["check_requests"]):
        ref = reference_flows(params, cell.config["model"], *pool[i], device)
        for side, got in flows.items():
            out[side].append({"flow_epe": mean_epe(torch.from_numpy(np.asarray(got[i])), ref)})
    return out


def mean_epe(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Mean end-point distance in pixels between two (N, H, W, 2) flows."""
    return float(torch.linalg.vector_norm((got - ref).double(), dim=-1).mean())
