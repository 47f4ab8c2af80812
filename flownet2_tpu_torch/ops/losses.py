"""Robust flow losses: L1/EPE (``L1Loss``) and generalized Lpq (``LpqLoss``).

Counterpart of flownet2_tpu/ops/losses.py (reference
l1loss_layer.{cpp,cu}, lpq_loss_layer.{cpp,cu}), on NCHW tensors: the
channel axis is dim 1.

L1Loss, ``l2_per_location`` (the FlowNet EPE loss):
  diff = pred - gt; mask = isfinite(diff); diff = diff * mask
  s    = sum_c diff^2  (x 1/C with l2_prescale_by_channels)
  if plateau > 0: s = s * (s >= plateau^2)
  loss = sum (s + epsilon)^0.5 / normalize_coeff
L1Loss, plain:
  mask &= |diff| >= plateau; loss = sum |diff * mask| / normalize_coeff
LpqLoss:
  loss = sum (sum_c (|diff * mask| + p_eps)^p + q_eps)^q / normalize_coeff

normalize_coeff is the batch size, or the number of finite entries over C
with ``normalize_by_num_entries`` (l1loss_layer.cu:86-91). Masks carry no
gradient. Sums are float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from flownet2_tpu_torch.ops.downsample import downsample_nan_aware


def _nan_mask_and_norm(diff: torch.Tensor, normalize_by_num_entries: bool):
    """The finite mask and the divisor: a tensor (the valid entries over the
    channels) or the batch size as a Python number. A tensor made from the
    batch size on a card would be a blocking copy, which waits for every
    step queued before it."""
    mask = torch.isfinite(diff)
    if normalize_by_num_entries:
        norm = torch.clamp(mask.float().sum() / diff.shape[1], min=1.0)
    else:
        norm = float(diff.shape[0])
    return mask, norm


def l1_loss(
    pred: torch.Tensor,
    target: torch.Tensor | None = None,
    *,
    l2_per_location: bool = False,
    l2_prescale_by_channels: bool = False,
    normalize_by_num_entries: bool = False,
    epsilon: float = 1e-2,
    plateau: float = 0.0,
) -> torch.Tensor:
    """Scalar L1/EPE loss over NCHW inputs (``target`` optional, as in the
    reference's 1-bottom mode)."""
    diff = pred if target is None else pred - target
    diff = diff.float()
    mask, norm = _nan_mask_and_norm(diff, normalize_by_num_entries)
    if l2_per_location:
        diff = torch.where(mask, diff, 0.0)
        scale = 1.0 / diff.shape[1] if l2_prescale_by_channels else 1.0
        s = torch.sum(diff * diff, dim=1, keepdim=True) * scale
        if plateau > 0:
            s = torch.where(s.detach() >= plateau * plateau, s, 0.0)
        return torch.sum(torch.sqrt(s + epsilon)) / norm
    if plateau > 0:
        mask = mask & (diff.detach().abs() >= plateau)
    return torch.sum(torch.abs(torch.where(mask, diff, 0.0))) / norm


def epe(pred_flow: torch.Tensor, gt_flow: torch.Tensor) -> torch.Tensor:
    """Average endpoint error over NCHW flows, NaN GT pixels excluded."""
    d = pred_flow.float() - gt_flow.float()
    dist = torch.sqrt(torch.sum(d * d, dim=1))
    valid = torch.isfinite(dist)
    return torch.sum(torch.where(valid, dist, 0.0)) / torch.clamp(valid.float().sum(), min=1.0)


@dataclass(frozen=True)
class LpqSchedule:
    """Iteration-indexed (p, q) episode schedule (lpq_loss_layer.cpp:19-80)."""

    start_iters: Sequence[int] = (0,)
    ps: Sequence[float] = (2.0,)
    qs: Sequence[float] = (0.5,)

    def __post_init__(self):
        if not (len(self.start_iters) == len(self.ps) == len(self.qs)):
            raise ValueError("schedule arrays must have equal length")
        if len(self.start_iters) == 0:
            raise ValueError("schedule must not be empty")
        if self.start_iters[0] != 0:
            raise ValueError("first episode must start at iteration 0")
        if any(a >= b for a, b in zip(self.start_iters, self.start_iters[1:])):
            raise ValueError("episode start iterations must be strictly increasing")

    def at(self, iteration: int) -> tuple[float, float]:
        idx = 0
        for i, start in enumerate(self.start_iters):
            if iteration >= start:
                idx = i
        return self.ps[idx], self.qs[idx]


def lpq_loss(
    pred: torch.Tensor,
    target: torch.Tensor | None = None,
    *,
    p: float = 2.0,
    q: float = 0.5,
    p_epsilon: float = 0.0,
    q_epsilon: float = 1e-2,
    l2_prescale_by_channels: bool = False,
    normalize_by_num_entries: bool = False,
) -> torch.Tensor:
    """Scalar Lpq loss: (sum_c (|diff| + pe)^p + qe)^q, summed and normalized."""
    diff = pred if target is None else pred - target
    diff = diff.float()
    mask, norm = _nan_mask_and_norm(diff, normalize_by_num_entries)
    a = torch.abs(torch.where(mask, diff, 0.0))
    scale = 1.0 / diff.shape[1] if l2_prescale_by_channels else 1.0
    s = torch.sum((a + p_epsilon) ** p, dim=1, keepdim=True) * scale
    return torch.sum((s + q_epsilon) ** q) / norm


# The FlowNet per-scale supervision weights (loss_weight of the L1 losses at
# predict_flow6..2 in the released FlowNet2 training templates).
DEFAULT_SCALE_WEIGHTS = {
    "flow6": 0.32,
    "flow5": 0.08,
    "flow4": 0.02,
    "flow3": 0.01,
    "flow2": 0.005,
}


def multiscale_l1_loss(
    flows: dict[str, torch.Tensor],
    gt_flow: torch.Tensor,
    weights: dict[str, float] | None = None,
    *,
    l2_per_location: bool = True,
    downsample_gt: bool = True,
    normalize: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Weighted sum of per-scale EPE losses over NCHW flows.

    Ground truth is downsampled to each prediction's resolution with the
    NaN-aware area downsample, as the reference training nets wire
    Downsample -> L1Loss per scale. ``normalize`` passes
    ``normalize_by_num_entries`` to every scale.
    """
    weights = DEFAULT_SCALE_WEIGHTS if weights is None else weights
    total = torch.zeros((), device=gt_flow.device)
    per_scale = {}
    for name, flow in flows.items():
        w = weights.get(name, 0.0)
        if w == 0.0:
            continue
        gt = gt_flow
        if downsample_gt and gt_flow.shape[2:] != flow.shape[2:]:
            gt = downsample_nan_aware(gt_flow, flow.shape[2], flow.shape[3])
        loss = l1_loss(flow, gt, l2_per_location=l2_per_location, normalize_by_num_entries=normalize)
        per_scale[name] = loss
        total = total + w * loss
    return total, per_scale
