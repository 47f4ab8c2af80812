"""Inference traffic for RAFT: one client, closed loop, through ``FlowRunner``.

As ``infer.py``: requests hand ``FlowRunner("raft", ..., iters=...)`` host
uint8 frames (``FlowRunner.batch`` for several pairs, ``__call__`` for one)
and return when the flow is on the host; they cycle a pool of distinct pairs
made from the seed (``harness/data.py``, the frames of the FlowNet2 cells),
back to back. The cell's file sets the frame size, the pairs a request, the
pool, the warm-up, the traced stretch, the requests sampled for the check
and the check's limit; the configuration sets the updates (``iters``).
Weights: ``reference/raft.py::make_weights``.

``correct``: ``check_requests`` requests, drawn from the seed among those
the window completed (a reservoir sample), against the plain reference
(``reference/raft.py``, IEEE float32) on the same frames and weights. With
random weights RAFT's recurrence is chaotic: after 32 updates TF32
convolutions part from the float32 reference by about 18 px, as far as a
planted fault or the bfloat16 control, so the final flow is not held to a
from-scratch reference run. Forward hooks on the net's update block
(:class:`Capture`) keep, for each request, the updates it ran, the flow
increments of the first ``checked_update`` updates (the cell's file) and
the state after the last; then

- ``first_epe`` and ``loop_epe``: the worst sampled pair's mean end-point
  distance, in input pixels (x8), between the program's 1/8 flow after its
  first update, and after update ``checked_update``, and the reference's,
  both from the frames: the encoders, the volume, and the loop as deep as
  the TF32 program still stands apart from the bfloat16 control. A loop
  whose state stops moving (``lookup_at_start``, ``flow_input_zeroed``)
  reads as the program does after one update and fails only ``loop_epe``;
- ``pair_epe``: the worst pair's mean end-point distance, px, between the
  program's flow and the reference's mask head, convex upsampling and crop
  run on the program's last GRU state and 1/8 flow. Per pair, so that a
  fault in one pair of a request shows whole;
- ``update_gap``: the most updates a sampled request ran apart from the
  configuration's ``iters``.

Faults (``planted``): those of ``harness/faults.py`` that apply to
inference, and RAFT's own: ``one_update_fewer`` (the net runs one update
less than it was built for), ``window_transposed`` (the lookup's window
with its outer index moving y), ``lookup_at_start`` (every lookup at the
starting grid) and ``flow_input_zeroed`` (the motion encoder's flow input
held at zero).
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import faults
from benchmark.harness.common import Check, Phases, Result, exact_float32, since_process_start, sync
from benchmark.harness.data import make_pairs
from benchmark.harness.trace import Tracer
from benchmark.reference import raft as ref
from benchmark.traffic.infer import Reservoir, mean_epe

FAULTS = ("one_update_fewer", "window_transposed", "lookup_at_start", "flow_input_zeroed")


class Capture:
    """Forward hooks on the net's update block, kept on for the run: for the
    request running, the updates it ran, the flow increments of its first
    ``depth`` updates and, of the last, the 1/8 flow it took, its increment
    and the GRU state it left. References to the net's own tensors: nothing
    is copied and no operation is added."""

    def __init__(self, net, depth: int):
        self.depth, self.record = depth, {}
        net.update_block.register_forward_pre_hook(self._inputs)
        net.update_block.register_forward_hook(self._outputs)

    def _inputs(self, module, args):
        self.record["flow_in"] = args[3]

    def _outputs(self, module, args, out):
        h, delta = out
        n = self.record.get("updates", 0) + 1
        self.record.update(updates=n, h_out=h, delta_out=delta)
        if n <= self.depth:
            self.record.setdefault("deltas", []).append(delta)

    def take(self) -> dict:
        """The request's record; the next request starts a new one."""
        record, self.record = self.record, {}
        return record


@contextlib.contextmanager
def planted(fault: str | None):
    """``harness/faults.py``'s faults, and RAFT's own."""
    if fault not in FAULTS:
        with faults.planted(fault):
            yield
        return
    from flownet2_tpu_torch.models.raft import RAFT, BasicMotionEncoder
    from flownet2_tpu_torch.ops.all_pairs import AllPairs

    forward, lookup, motion = RAFT.forward, AllPairs.lookup, BasicMotionEncoder.forward

    def fewer(self, img0, img1):
        self.iters -= 1
        try:
            return forward(self, img0, img1)
        finally:
            self.iters += 1

    def transposed(self, coords):
        out = lookup(self, coords)
        n, c, h, w = out.shape
        k = 2 * self.radius + 1
        return out.view(n, c // (k * k), k, k, h, w).transpose(2, 3).reshape(n, c, h, w)

    def at_start(self, coords):
        if not hasattr(self, "start"):
            self.start = coords
        return lookup(self, self.start)

    def zeroed(self, flow, corr):
        return motion(self, torch.zeros_like(flow), corr)

    patch = {"one_update_fewer": (RAFT, "forward", fewer), "window_transposed": (AllPairs, "lookup", transposed),
             "lookup_at_start": (AllPairs, "lookup", at_start),
             "flow_input_zeroed": (BasicMotionEncoder, "forward", zeroed)}[fault]
    setattr(*patch)
    try:
        yield
    finally:
        RAFT.forward, AllPairs.lookup, BasicMotionEncoder.forward = forward, lookup, motion


def build(cell, seed: int, device, phases: Phases | None = None, dtype=None, iters: int | None = None,
          depth: int | None = None):
    """(pool of (img0, img1) host batches, weights, runner, request call);
    ``dtype`` goes to ``FlowRunner`` (None: float32, as the configuration
    states), ``iters`` to the net (None: the configuration's); the
    :class:`Capture` keeps the increments of the first ``depth`` updates
    (None: the cell's ``checked_update``). A call returns (flow, the
    request's :class:`Capture` record)."""
    from flownet2_tpu_torch.inference import FlowRunner

    tr = cell.traffic
    phases = phases or Phases()
    n = tr["pairs_per_request"]
    data = make_pairs(tr["pool_requests"] * n, tr["height"], tr["width"], seed, device)
    pool = [(data["img0"][i * n:(i + 1) * n], data["img1"][i * n:(i + 1) * n]) for i in range(tr["pool_requests"])]
    phases.mark("pairs")
    params = ref.make_weights(seed, device)
    phases.mark("weights")
    runner = FlowRunner(cell.config["model"], params, device=device, dtype=dtype,
                        iters=cell.config["iters"] if iters is None else iters)
    capture = Capture(runner.net, tr["checked_update"] if depth is None else depth)
    phases.mark("runner")

    def call(a, b):
        flow = runner(a[0], b[0])[None] if n == 1 else runner.batch(a, b)
        return flow, capture.take()

    return pool, params, runner, call


def coarse_flows(deltas: list, coords0: torch.Tensor) -> list:
    """The 1/8 flow after each update, from the updates' increments, with the
    net's arithmetic: the coordinates advanced by each increment in float32."""
    coords, out = coords0, []
    for delta in deltas:
        coords = coords + delta.float()
        out.append(coords - coords0)
    return out


def reference_checks(params: dict, img0: np.ndarray, img1: np.ndarray, flow: np.ndarray, record: dict,
                     device) -> dict:
    """A request's per-pair ``first_epe``, ``loop_epe`` and ``pair_epe``
    (lists) against the reference, and its ``updates``; the program's
    ``flow`` and ``record`` (:class:`Capture`) on frames ``img0``, ``img1``.
    ``loop_epe`` reads the update the record's increments reach."""
    P = ref.prepare(params, device)
    ops = ref.Ops()
    with exact_float32(), torch.no_grad():
        x0, x1, pads = ref.pad_frames(torch.from_numpy(img0).to(device), torch.from_numpy(img1).to(device))
        want = reference_flows(ops, P, x0, x1, len(record["deltas"]))
        got = coarse_flows(record["deltas"], want[0])
        coarse = record["flow_in"].float() + record["delta_out"].float()
        final = ref.crop(ref.mask_upsample(ops, P, record["h_out"].float(), coarse), pads, *img0.shape[1:3])
    return {"first_epe": pair_epes(8 * to_nhwc(got[0]), 8 * to_nhwc(want[1])),
            "loop_epe": pair_epes(8 * to_nhwc(got[-1]), 8 * to_nhwc(want[-1])),
            "pair_epe": pair_epes(torch.from_numpy(np.asarray(flow)), final.cpu()), "updates": record["updates"]}


def reference_flows(ops, P, x0, x1, depth: int) -> list:
    """The reference from padded frames: [coords0, then the 1/8 flow after
    each of the first ``depth`` updates]."""
    pyramid, h, inp, coords0 = ref.encode(ops, P, x0, x1)
    coords1, out = coords0, [coords0]
    for _ in range(depth):
        h, delta = ref.update(ops, P, h, inp, ref.lookup(pyramid, coords1), coords1 - coords0)
        coords1 = coords1 + delta
        out.append(coords1 - coords0)
    return out


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).cpu()


def pair_epes(got: torch.Tensor, want: torch.Tensor) -> list:
    """Each pair's mean end-point distance between two (N, H, W, 2) flows."""
    return [mean_epe(got[i:i + 1], want[i:i + 1]) for i in range(len(want))]


def run(cell, seed: int, seconds: float, trace: bool, device) -> Result:
    from flownet2_tpu_torch.inference import check_model

    check_model(cell.config["model"])  # a program without the model stops here, before any work
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
            flow, record = call(*pool[i % len(pool)])
            te = time.perf_counter()
        latencies.append(te - ts)
        sample.offer(i, (flow, record))
        i += 1
        if tracer is not None and stretch is None and i - traced_from == tr["stretch_requests"]:
            tracer.stop()
            units = {"requests": tr["stretch_requests"], "pairs": tr["stretch_requests"] * tr["pairs_per_request"]}
            stretch = tracer.stretch(units, dict(tr, model=cell.config["model"], iters=cell.config["iters"]))
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
    worst = {"first_epe": 0.0, "loop_epe": 0.0, "pair_epe": 0.0, "update_gap": 0}
    for idx, (flow, record) in sample.items:
        got = reference_checks(params, *pool[idx % len(pool)], flow, record, device)
        for k in ("first_epe", "loop_epe", "pair_epe"):
            worst[k] = max(worst[k], *got[k])
        worst["update_gap"] = max(worst["update_gap"], abs(got["updates"] - cell.config["iters"]))
    checks = {k: Check(v, cell.limits[k]) for k, v in worst.items()}
    return Result(setup_s, i, 0, e2e, peak, checks, stretch)


def readings(cell, seed: int, device, control: bool, fault: str | None = None, iters: int | None = None) -> dict:
    """The comparison's numbers on the requests a run samples first (pool
    requests 0 .. check_requests - 1), for setting its limit: the program's
    (with ``fault`` planted), and with ``control`` the control's: the
    program's own bfloat16 path (``FlowRunner(dtype="bfloat16")``, weights and
    activations in bfloat16, the volume, lookup and coordinates in float32)
    on the same requests. ``iters``: the updates, both sides (None: the
    configuration's)."""
    tr = cell.traffic
    iters = cell.config["iters"] if iters is None else iters
    sides = {"program": None, "control": torch.bfloat16} if control else {"program": None}
    got = {}
    for side, dtype in sides.items():
        with planted(fault if side == "program" else None):
            pool, params, runner, call = build(cell, seed, device, dtype=dtype, iters=iters)
            got[side] = [call(*pool[i]) for i in range(tr["check_requests"])]
        del runner, call
        gc.collect()
    out = {"program": [], "control": []}
    for side, requests in got.items():
        for i, (flow, record) in enumerate(requests):
            r = reference_checks(params, *pool[i], flow, record, device)
            out[side] += [{"first_epe": f, "loop_epe": lp, "pair_epe": p, "update_gap": abs(r["updates"] - iters)}
                          for f, lp, p in zip(r["first_epe"], r["loop_epe"], r["pair_epe"])]
    return out
