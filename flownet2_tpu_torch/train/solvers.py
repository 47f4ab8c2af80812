"""The six reference solver update rules as one ``torch.optim.Optimizer``.

Counterpart of flownet2_tpu/train/solvers.py, which builds each rule as an
optax chain (reference src/caffe/solvers/{sgd,nesterov,adagrad,rmsprop,
adadelta,adam}_solver.cpp). :class:`CaffeSolver` applies the same chain,
in the same order, with float32 state:

1. clip by global L2 norm (``clip_gradients`` > 0);
2. L2 weight decay, g + weight_decay * w (``weight_decay`` > 0);
3. the rule;
4. the LR schedule;
5. the sign: w <- w - update.

SGD and Nesterov apply the learning rate BEFORE the momentum trace, as
Caffe does (v = m*v + lr*(g + wd*w); w -= v). ``torch.optim.SGD`` applies
it after, and the two part at every step of a multistep schedule, so no
``torch.optim`` rule is used. A parameter without a gradient takes a zero
gradient, as a leaf of the JAX pytree would.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np
import torch

from flownet2_tpu_torch.train.lr_policies import Schedule, lr_policy

RULES = ("sgd", "nesterov", "adagrad", "rmsprop", "adadelta", "adam")


@dataclass(frozen=True)
class SolverConfig:
    """The SolverParameter subset that affects optimization (caffe.proto:104-244)."""

    solver_type: str = "sgd"  # sgd|nesterov|adagrad|rmsprop|adadelta|adam
    base_lr: float = 1e-4
    lr_policy: str = "fixed"
    gamma: float = 0.1
    stepsize: int = 100_000
    power: float = 1.0
    stepvalues: Sequence[int] = ()
    max_iter: int = 1_200_000
    momentum: float = 0.9
    momentum2: float = 0.999  # Adam beta2
    weight_decay: float = 0.0
    delta: float = 1e-8  # AdaGrad/RMSProp/AdaDelta/Adam epsilon
    rms_decay: float = 0.99
    iter_size: int = 1
    clip_gradients: float = -1.0  # L2-norm clip threshold; <0 disables

    def schedule(self) -> Schedule:
        return lr_policy(
            self.lr_policy, self.base_lr, gamma=self.gamma, stepsize=self.stepsize,
            power=self.power, max_iter=self.max_iter, stepvalues=self.stepvalues,
        )


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax computes it."""
    return float(1.0 - np.float32(decay) ** np.float32(count))


class CaffeSolver(torch.optim.Optimizer):
    """One Caffe update rule (``config.solver_type``) over ``params``.

    The update count (which indexes the LR schedule and Adam's bias
    correction) lives in the parameter group, so ``state_dict`` carries it."""

    def __init__(self, params: Iterable[torch.nn.Parameter], config: SolverConfig):
        if config.solver_type.lower() not in RULES:
            raise ValueError(f"unknown solver_type {config.solver_type!r}; choose from {RULES}")
        super().__init__(params, {"count": 0})
        self.config = config
        self.rule = config.solver_type.lower()
        self.schedule = config.schedule()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("CaffeSolver takes no closure")
        cfg = self.config
        params = [p for group in self.param_groups for p in group["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        if cfg.clip_gradients > 0:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            grads = [torch.where(g_norm < cfg.clip_gradients, g, g / g_norm * cfg.clip_gradients)
                     for g in grads]
        if cfg.weight_decay > 0:
            grads = [g + cfg.weight_decay * p for g, p in zip(grads, params)]
        count = self.param_groups[0]["count"]
        lr = self.schedule(count)
        for p, g in zip(params, grads):
            p.sub_(self._rule_update(self.state[p], p, g, lr, count))
        for group in self.param_groups:
            group["count"] = count + 1

    def _rule_update(self, state: dict, p: torch.Tensor, g: torch.Tensor, lr: float, count: int):
        cfg = self.config

        def slot(name):
            if name not in state:
                state[name] = torch.zeros_like(p, dtype=torch.float32)
            return state[name]

        if self.rule in ("sgd", "nesterov"):
            g = lr * g
            trace = g + cfg.momentum * slot("trace")
            state["trace"] = trace
            return g + cfg.momentum * trace if self.rule == "nesterov" else trace
        if self.rule == "adagrad":
            sum_sq = g * g + slot("sum_of_squares")
            state["sum_of_squares"] = sum_sq
            inv = torch.where(sum_sq > 0, torch.rsqrt(sum_sq + cfg.delta), 0.0)
            return lr * (inv * g)
        if self.rule == "rmsprop":
            nu = (1 - cfg.rms_decay) * (g * g) + cfg.rms_decay * slot("nu")
            state["nu"] = nu
            return lr * (torch.rsqrt(nu + cfg.delta) * g)
        if self.rule == "adadelta":
            rho = cfg.momentum
            e_g = (1 - rho) * (g * g) + rho * slot("e_g")
            upd = (torch.sqrt(slot("e_x") + cfg.delta) / torch.sqrt(e_g + cfg.delta)) * g
            state["e_g"] = e_g
            state["e_x"] = (1 - rho) * (upd * upd) + rho * state["e_x"]
            return lr * upd
        # adam
        b1, b2 = cfg.momentum, cfg.momentum2
        mu = (1 - b1) * g + b1 * slot("mu")
        nu = (1 - b2) * (g * g) + b2 * slot("nu")
        state["mu"], state["nu"] = mu, nu
        mu_hat = mu / _bias_correction(b1, count + 1)
        nu_hat = nu / _bias_correction(b2, count + 1)
        return lr * (mu_hat / (torch.sqrt(nu_hat) + cfg.delta))


def make_solver(config: SolverConfig, params: Iterable[torch.nn.Parameter]) -> CaffeSolver:
    """The optimizer for ``config`` over ``params``."""
    return CaffeSolver(params, config)
