"""Training traffic: ``cli.train``'s loader path, built as ``cli/train.py::train``
builds it, for as long as the window lasts.

Set-up makes ``samples`` pairs at source size from the seed on the card
(``harness/data.py``), writes them in FlyingChairs' public layout (PPM
frames, ``.flo`` flow) under ``TMPDIR``, and packs them with the port's
``cli.convert_dataset`` into the ``.flowrec`` that users train from, read in
transport mode. Then ``BatchLoader`` (keyed, ``shard=(0, 1)``: batch k is a
function of the seed and k, whichever of its threads makes it; the
single-process loader hands batches out in the order its threads finish)
with ``make_flownet_augmenter`` (``--no-augment``: center crops on the
host), ``DevicePrefetcher``, and ``Solver`` with ``make_augmented_loss``
around ``LOSSES[model]``, Adam on ``S_long``. The window calls
``Solver.solve`` in chunks of ``chunk_steps`` until ``--seconds`` have
passed, then waits for the card: only steps it finished count.

``correct``: set-up runs the first three steps through the same
``solve`` and the same feed; the reference (``reference/train.py``) follows
them from the same weights on the batches it works out again from the
seed. Compared: ``flow_epe1``, step 1's finest prediction (the net's
flow2, read by a forward hook) as the mean end-point distance to the
reference's, in pixels at its size: the number the control (the port's
bfloat16 path) fails; ``loss_gap``, the worst step's |loss - reference| /
|reference|; ``grad_gap``, step 1's gradient as Adam got it (its first
moment / (1 - beta1)), and ``change_gap``, the parameters' change over the
three steps, each as the worst leaf's |norm - reference norm| / max(the
reference leaf's norm, the median leaf's); the change leaves out leaves
whose reference gradient is under a thousandth of the median leaf's.
The limits of the last three are set against planted faults
(``harness/faults.py``): gradient and change norms move with the kinks a
rounding flips, so TF32 and bfloat16 read alike in them.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness.common import Check, Phases, Result, exact_float32, since_process_start, sync
from benchmark.harness.data import make_pairs, write_flo, write_ppm
from benchmark.harness.trace import Tracer
from benchmark.harness.weights import make_weights
from benchmark.reference.train import reference_steps

CHECK_STEPS = 3
DIV_FLOW = 20.0  # the nets predict flow / 20
SMALL_GRAD = 1e-3  # leaves whose reference gradient is under this share of the median leaf's


def _quiet(_):
    pass


class TimedBatches:
    """The Solver's feed, with the host seconds spent waiting in ``next()``."""

    def __init__(self, it):
        self.it, self.wait_s = it, 0.0

    def __iter__(self):
        return self

    def __next__(self):
        with record_function("bench.next_batch"):
            t = time.perf_counter()
            batch = next(self.it)
            self.wait_s += time.perf_counter() - t
        return batch


def write_dataset(data: dict, folder: str) -> str:
    """The pairs in FlyingChairs' layout under ``folder``, packed by the
    port's ``cli.convert_dataset``; the ``.flowrec`` path."""
    from flownet2_tpu_torch.cli import convert_dataset

    src = os.path.join(folder, "chairs")
    os.makedirs(src)
    for i in range(len(data["img0"])):
        write_ppm(os.path.join(src, f"{i:05d}_img1.ppm"), data["img0"][i])
        write_ppm(os.path.join(src, f"{i:05d}_img2.ppm"), data["img1"][i])
        write_flo(os.path.join(src, f"{i:05d}_flow.flo"), data["flow"][i])
    rec = os.path.join(folder, "train.flowrec")
    with contextlib.redirect_stdout(sys.stderr):
        convert_dataset.main([rec, "--dataset", "flyingchairs", "--data-root", src])
    return rec


class Program:
    """The training run as ``cli.train`` builds it, on one device; ``dtype``
    bfloat16 runs the objective through ``with_compute_dtype`` (the net's
    activations and a cast copy of its weights in bfloat16), the program's
    own lower-precision path."""

    def __init__(self, cell, seed: int, device, folder: str, phases: Phases | None = None, dtype=None):
        from flownet2_tpu_torch.checkpoint import load_into
        from flownet2_tpu_torch.data import BatchLoader, DevicePrefetcher, FlowRecordReader
        from flownet2_tpu_torch.data.augment_pipeline import make_augmented_loss, make_flownet_augmenter
        from flownet2_tpu_torch.models import NETS
        from flownet2_tpu_torch.train import FLOWNET_SCHEDULES, Solver, SolverConfig
        from flownet2_tpu_torch.train.objectives import LOSSES, trainable_module, with_compute_dtype

        tr, cfg = cell.traffic, cell.config
        model, solver_cfg = cfg["model"], cfg["solver"]
        phases = phases or Phases()
        self.data = make_pairs(tr["samples"], tr["source_height"], tr["source_width"], seed, device)
        phases.mark("pairs")
        dataset = FlowRecordReader(write_dataset(self.data, folder), transport=True)
        phases.mark("files and records")
        self.params = make_weights(model, seed, device)
        phases.mark("weights")
        sched = FLOWNET_SCHEDULES["S_long"]
        config = SolverConfig(solver_type=solver_cfg["type"], lr_policy=sched["policy"], base_lr=sched["base_lr"],
                              gamma=sched["gamma"], stepvalues=sched["stepvalues"], max_iter=sched["max_iter"],
                              momentum=solver_cfg["momentum"], momentum2=solver_cfg["momentum2"], iter_size=1)
        ch, cw = tr["crop_height"], tr["crop_width"]
        loss_fn, transform = with_compute_dtype(LOSSES[model], dtype), None
        if tr["augment"]:
            loss_fn = make_augmented_loss(loss_fn, ch, cw, seed=seed)
            transform = make_flownet_augmenter(ch, cw)
        with torch.device("meta"):
            net = NETS[model]()
        load_into(net, self.params)
        self.solver = Solver(config, loss_fn, net, device=device, trainable=trainable_module(net, model),
                             snapshot_dir=None, display=0)
        loader = BatchLoader(dataset, tr["batch"], crop=None if tr["augment"] else (ch, cw), shuffle_seed=seed,
                             transform=transform, shard=(0, 1), num_threads=tr["loader_threads"])
        self.loader_iter = iter(loader)
        self.staged = iter(DevicePrefetcher(self.loader_iter, depth=tr["prefetch_depth"], device=self.solver.device))
        self.batches = TimedBatches(self.staged)
        self.losses = []  # the first steps' losses, then the latest chunk's
        phases.mark("program")

    def solve(self, steps: int) -> None:
        if self.solver.iteration >= CHECK_STEPS:
            del self.losses[CHECK_STEPS:]
        with record_function("bench.solve"):
            self.solver.solve(self.batches, max_iter=self.solver.iteration + steps, log=_quiet,
                              on_step=lambda it, loss, aux: self.losses.append(loss))

    def leaves(self) -> dict:
        """Trainable parameters under the reference's leaf names ("conv1/w")."""
        names = {"weight": "w", "bias": "b"}
        return {"/".join(n.split(".")[:-1]) + "/" + names[n.split(".")[-1]]: p
                for n, p in self.solver.net.named_parameters() if p.requires_grad}

    def first_steps(self) -> dict:
        """Steps 1 .. CHECK_STEPS through ``solve``: losses, step 1's finest
        prediction (the net's flow2, read by a forward hook), step 1's
        gradient as Adam's first moment holds it, the weights before and after."""
        leaves = self.leaves()
        before = {k: p.detach().clone() for k, p in leaves.items()}
        seen = []
        hook = self.solver.net.register_forward_hook(lambda m, i, out: seen.append(out["flow2"].detach().float()))
        try:
            self.solve(1)
        finally:
            hook.remove()
        b1 = self.solver.config.momentum
        state = self.solver.optimizer.state
        grad = {k: state[p].get("mu", torch.zeros_like(p)) / (1 - b1) for k, p in leaves.items()}
        self.solve(CHECK_STEPS - 1)
        after = {k: p.detach().clone() for k, p in leaves.items()}
        return {"losses": [float(x) for x in self.losses[:CHECK_STEPS]], "flow": seen[0], "grad": grad,
                "before": before, "weights": after}

    def close(self) -> None:
        """Stop the staging thread, then the loader's threads."""
        self.staged.close()
        for _ in range(100):
            try:
                self.loader_iter.close()
                return
            except ValueError:  # the staging thread is still inside it
                time.sleep(0.05)


def gaps(program: dict, ref: dict) -> dict:
    """flow_epe1, loss_gap, grad_gap and change_gap of the program's first
    steps against the reference's (the module's docstring)."""
    got = torch.zeros_like(ref["flow"])  # rows the program did not predict count as zero flow
    got[:len(program["flow"])] = program["flow"].to(got.device)
    epe = torch.linalg.vector_norm((got - ref["flow"]).double(), dim=1).mean() * DIV_FLOW

    def norm(t):
        return float(torch.linalg.vector_norm(t.double()))

    keys = sorted(ref["grad"])
    g_ref = {k: norm(ref["grad"][k]) for k in keys}
    g_med = float(np.median(list(g_ref.values())))
    grad = max(abs(norm(program["grad"][k]) - g_ref[k]) / max(g_ref[k], g_med) for k in keys)
    moved = [k for k in keys if g_ref[k] >= SMALL_GRAD * g_med]
    d_ref = {k: norm(ref["weights"][k] - program["before"][k]) for k in moved}
    d_med = float(np.median(list(d_ref.values())))
    change = max(abs(norm(program["weights"][k] - program["before"][k]) - d_ref[k]) / max(d_ref[k], d_med)
                 for k in moved)
    loss = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], ref["losses"]))
    return {"flow_epe1": float(epe), "loss_gap": loss, "grad_gap": grad, "change_gap": change}


def reference(data: dict, params: dict, seed: int, cell, device) -> dict:
    """The reference's first steps, in IEEE float32."""
    with exact_float32():
        return reference_steps(params, data, seed, cell.traffic, cell.config["solver"], device, CHECK_STEPS)


def run(cell, seed: int, seconds: float, trace: bool, device) -> Result:
    tr = cell.traffic
    folder = tempfile.mkdtemp(prefix="flownet2-bench-")
    try:
        phases = Phases()
        prog = Program(cell, seed, device, folder, phases)
        first = prog.first_steps()
        phases.mark("first steps")
        prog.solve(tr["warmup_steps"] - CHECK_STEPS)
        sync(device)
        phases.mark("warm-up")
        setup_s = since_process_start()
        phases.report()

        tracer, stretch = None, None
        start_it = prog.solver.iteration
        t0 = time.perf_counter()
        while True:
            if trace and tracer is None and time.perf_counter() - t0 >= seconds / 3:
                tracer, traced_from, wait0 = Tracer(), prog.solver.iteration, prog.batches.wait_s
                tracer.start()
            prog.solve(tr["chunk_steps"])
            if tracer is not None and stretch is None and prog.solver.iteration - traced_from >= tr["stretch_steps"]:
                tracer.stop()
                steps = prog.solver.iteration - traced_from
                units = {"steps": steps, "pairs": steps * tr["batch"], "data_wait_s": prog.batches.wait_s - wait0}
                stretch = tracer.stretch(units, dict(tr, model=cell.config["model"]))
            if time.perf_counter() - t0 >= seconds and (not trace or stretch is not None):
                break
        sync(device)
        window = time.perf_counter() - t0
        steps = prog.solver.iteration - start_it
        # a step that goes non-finite leaves the weights so: the latest chunk shows it
        failed = int((~torch.isfinite(torch.stack(prog.losses))).sum())
        peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
        data, params = prog.data, prog.params
        prog.close()
        del prog
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        numbers = gaps(first, reference(data, params, seed, cell, device))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    checks = {k: Check(v, cell.limits[k]) for k, v in numbers.items() if k in cell.limits}
    e2e = {"train_pairs_per_s": steps * tr["batch"] / window}
    return Result(setup_s, steps, failed, e2e, peak, checks, stretch)


def readings(cell, seed: int, device, control: bool, fault: str | None = None) -> dict:
    """The comparison's numbers after the first steps, for setting its limits:
    the program's (with ``fault`` planted, ``harness/faults.py``), and with
    ``control`` the control's, the program's own bfloat16 path
    (``with_compute_dtype``) on the same batches."""
    from benchmark.harness.faults import planted

    sides = {"program": None, "control": torch.bfloat16} if control else {"program": None}
    out = {}
    for side, dtype in sides.items():
        folder = tempfile.mkdtemp(prefix="flownet2-bench-")
        try:
            with planted(fault if side == "program" else None):
                prog = Program(cell, seed, device, folder, dtype=dtype)
                out[side] = prog.first_steps()
            data, params = prog.data, prog.params
            prog.close()
            del prog
            gc.collect()
        finally:
            shutil.rmtree(folder, ignore_errors=True)
    ref = reference(data, params, seed, cell, device)
    return {side: [gaps(first, ref)] for side, first in out.items()}
