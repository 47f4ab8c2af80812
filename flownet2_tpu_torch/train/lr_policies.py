"""Learning-rate policies with Caffe semantics (flownet2_tpu/train/lr_policies.py).

Reference: SolverParameter (caffe.proto:159-174) and
SGDSolver::GetLearningRate (src/caffe/solvers/sgd_solver.cpp):

  fixed:     base_lr
  step:      base_lr * gamma^floor(iter/stepsize)
  exp:       base_lr * gamma^iter
  inv:       base_lr * (1 + gamma*iter)^(-power)
  multistep: base_lr * gamma^(#stepvalues passed)
  poly:      base_lr * (1 - iter/max_iter)^power
  sigmoid:   base_lr * 1/(1 + exp(-gamma*(iter - stepsize)))

Each policy returns a schedule: iteration (int) -> learning rate. The
arithmetic is float32, as in the JAX package, so ``exp`` and ``inv`` at
large iterations give the same numbers there and here.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

Schedule = Callable[[int], float]


def lr_policy(
    policy: str,
    base_lr: float,
    *,
    gamma: float = 0.1,
    stepsize: int = 100000,
    power: float = 1.0,
    max_iter: int = 0,
    stepvalues: Sequence[int] = (),
) -> Schedule:
    f32 = np.float32
    if policy == "fixed":
        return lambda it: float(f32(base_lr))
    if policy == "step":
        return lambda it: float(base_lr * gamma ** np.floor(f32(it) / f32(stepsize)))
    if policy == "exp":
        return lambda it: float(base_lr * gamma ** f32(it))
    if policy == "inv":
        return lambda it: float(base_lr * (1.0 + gamma * f32(it)) ** (-power))
    if policy == "multistep":
        steps = tuple(stepvalues)
        return lambda it: float(base_lr * gamma ** f32(sum(it >= s for s in steps)))
    if policy == "poly":
        if max_iter <= 0:
            raise ValueError("poly policy requires max_iter")
        return lambda it: float(base_lr * (1.0 - f32(it) / max_iter) ** power)
    if policy == "sigmoid":

        def sigmoid(it):
            with np.errstate(over="ignore"):  # exp overflows to inf: the rate is then 0
                return float(base_lr / (1.0 + np.exp(-gamma * (f32(it) - stepsize))))

        return sigmoid
    raise ValueError(f"unknown lr_policy {policy!r}")


# The FlowNet2 training schedules (the S_long / S_fine / S_short solver
# prototxts of the released models; schedule shapes per the FlowNet 2.0
# paper, section 4).
FLOWNET_SCHEDULES = {
    # 1.2M iterations on FlyingChairs from scratch; lr 1e-4 halved at 400k/600k/800k/1M.
    "S_long": dict(
        policy="multistep", base_lr=1e-4, gamma=0.5,
        stepvalues=(400_000, 600_000, 800_000, 1_000_000), max_iter=1_200_000,
    ),
    # 500k fine-tuning iterations (FlyingThings3D); lr 1e-5 halved at 200k/300k/400k.
    "S_fine": dict(
        policy="multistep", base_lr=1e-5, gamma=0.5,
        stepvalues=(200_000, 300_000, 400_000), max_iter=500_000,
    ),
    # 600k iterations; lr 1e-4 halved at 300k/400k/500k.
    "S_short": dict(
        policy="multistep", base_lr=1e-4, gamma=0.5,
        stepvalues=(300_000, 400_000, 500_000), max_iter=600_000,
    ),
}


def flownet_schedule(name: str) -> tuple[Schedule, int]:
    """(schedule, max_iter) of a named FlowNet recipe."""
    cfg = dict(FLOWNET_SCHEDULES[name])
    max_iter = cfg.pop("max_iter")
    return lr_policy(**cfg), max_iter
