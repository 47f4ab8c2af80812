"""Faults planted in the program, to show that the comparison deciding
``correct`` catches them. Used by the tests under ``benchmark/tests`` and by
``study.py --faults``; the benchmark's runs never plant one.

- ``state_unchanged``: the optimizer's step returns with the parameters as
  they were;
- ``half_batch``: the objective sees the first half of each batch, its mean
  taken over those rows (training); the second half of a request's flows
  replaced by the first half's (inference of several pairs);
- ``altered_answer``: the answer altered where it is produced: the
  objective's loss by 1% (training); the runner's flow of the first pair of
  each request moved by 0.1 px (inference).
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "half_batch", "altered_answer")


@contextlib.contextmanager
def planted(fault: str | None):
    from flownet2_tpu_torch.inference import FlowRunner
    from flownet2_tpu_torch.train import objectives
    from flownet2_tpu_torch.train.solvers import CaffeSolver

    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; choose from {FAULTS}")
    losses, run, step = dict(objectives.LOSSES), FlowRunner.run, CaffeSolver.step

    def wrap(base):
        def loss_fn(net, batch):
            if fault == "half_batch":
                n = batch["img0"].shape[0]
                batch = {k: v[:n // 2] if torch.is_tensor(v) and v.dim() and v.shape[0] == n else v
                         for k, v in batch.items()}
            loss, aux = base(net, batch)
            return (loss * 1.01, aux) if fault == "altered_answer" else (loss, aux)
        return loss_fn

    def faulty_run(self, img0, img1):
        flow = run(self, img0, img1)
        if fault == "altered_answer":
            flow = flow.clone()
            flow[0, ..., 0] += 0.1
        elif fault == "half_batch" and flow.shape[0] > 1:
            flow = flow.clone()
            n = flow.shape[0]
            flow[n - n // 2:] = flow[:n // 2]
        return flow

    try:
        if fault == "state_unchanged":
            CaffeSolver.step = torch.no_grad()(lambda self, closure=None: None)
        else:
            objectives.LOSSES.update({k: wrap(v) for k, v in losses.items()})
            FlowRunner.run = faulty_run
        yield
    finally:
        objectives.LOSSES.clear()
        objectives.LOSSES.update(losses)
        FlowRunner.run = run
        CaffeSolver.step = step
