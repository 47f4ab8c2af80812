"""Training: the reference Solver subsystem on PyTorch (flownet2_tpu/train).

- ``lr_policies`` — the 7 Caffe LR policies and the FlowNet schedule presets.
- ``solvers``     — SGD/Nesterov/AdaGrad/RMSProp/AdaDelta/Adam as one
                    ``torch.optim.Optimizer`` with Caffe's order (the LR
                    inside the momentum trace).
- ``objectives``  — the per-net and per-stage losses, the joint FlowNet2 loss,
                    and bf16 compute over float32 master weights.
- ``solver``      — the train loop: iter_size accumulation, smoothed loss,
                    snapshot and restore, signal actions, and the K-step
                    loop of the device cache (``solve_cached``).
"""

from flownet2_tpu_torch.train.lr_policies import FLOWNET_SCHEDULES, lr_policy
from flownet2_tpu_torch.train.solver import Solver, make_multistep_train_step, make_train_step
from flownet2_tpu_torch.train.solvers import SolverConfig, make_solver

__all__ = [
    "FLOWNET_SCHEDULES",
    "Solver",
    "SolverConfig",
    "lr_policy",
    "make_multistep_train_step",
    "make_solver",
    "make_train_step",
]
