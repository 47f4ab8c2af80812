"""Training objectives: the net's forward plus multi-scale EPE supervision.

Counterpart of flownet2_tpu/train/objectives.py: normalize -> net ->
per-scale NaN-aware GT downsample -> weighted L1/EPE losses, with the GT
flow scaled by 1/DIV_FLOW where the net predicts flow/20.

A loss is ``loss_fn(net, batch) -> (loss, aux)``: ``net`` the
``nn.Module`` it trains (a FlowNet2 for the cascade losses), ``batch`` a dict
of NHWC tensors on the net's device, img0/img1 (N, H, W, 3) raw 0-255 and
flow (N, H, W, 2) in pixels (for DispNetC, (N, H, W, 1) disparity). The
stage losses run their frozen upstream nets under ``torch.no_grad()``; the
optimizer is given only the stage's sub-net (:func:`trainable_module`),
which is the semantics of the JAX package's ``make_split_stage_loss``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from flownet2_tpu_torch.core.codec import flow_as_f32
from flownet2_tpu_torch.models.common import to_nchw
from flownet2_tpu_torch.models.flownet2 import (
    DIV_FLOW,
    _cascade_stage,
    _upsample_flow_4x,
    build_fusion_inputs,
    flownet2_forward,
    normalize_images,
)
from flownet2_tpu_torch.ops.augment import apply_black_augmentation
from flownet2_tpu_torch.ops.downsample import downsample_nan_aware
from flownet2_tpu_torch.ops.losses import DEFAULT_SCALE_WEIGHTS, l1_loss, lpq_loss, multiscale_l1_loss


def _batch_views(batch: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NHWC batch -> NCHW img0, img1 (floating dtype kept, so a bf16 batch
    trains in bf16; integer images become float32) and float32 flow. A
    batch may come in the transport domain of the packed records (uint8
    images, int16 fixed-point flow): the flow decodes here, on the batch's
    device, as value/32 with SHRT_MAX -> NaN (``core/codec.flow_as_f32``)."""

    def as_float(x):
        return x if x.is_floating_point() else x.float()

    return to_nchw(as_float(batch["img0"])), to_nchw(as_float(batch["img1"])), to_nchw(flow_as_f32(batch["flow"]))


class _BoundLoss(nn.Module):
    """``loss_fn`` bound to ``net`` as a module, for ``functional_call``."""

    def __init__(self, loss_fn: Callable, net: nn.Module):
        super().__init__()
        self.loss_fn = loss_fn
        self.net = net

    def forward(self, batch):
        return self.loss_fn(self.net, batch)


def with_compute_dtype(loss_fn: Callable, dtype: torch.dtype | None) -> Callable:
    """Mixed precision: run the net in ``dtype`` (activations and a cast copy
    of the weights) while the optimizer keeps float32 master weights; the
    gradients come back in float32 through the cast. The images are cast
    too, uint8 transport images included (0-255 is exact in bfloat16), so
    the first convolution sees the weights' dtype. ``None`` is the
    identity."""
    if dtype is None:
        return loss_fn

    def wrapped(net: nn.Module, batch: dict):
        b = dict(batch)
        for k in ("img0", "img1"):
            b[k] = b[k].to(dtype)
        cast = {f"net.{name}": p.to(dtype) for name, p in net.named_parameters()}
        return torch.func.functional_call(_BoundLoss(loss_fn, net), cast, (b,))

    return wrapped


def flownet_s_loss(net: nn.Module, batch: dict) -> tuple[torch.Tensor, dict]:
    img0, img1, flow = _batch_views(batch)
    x0, x1 = normalize_images(img0, img1)
    total, per_scale = multiscale_l1_loss(net(torch.cat([x0, x1], dim=1)), flow / DIV_FLOW)
    return total, {"loss": total, **per_scale}


def flownet_c_loss(net: nn.Module, batch: dict) -> tuple[torch.Tensor, dict]:
    img0, img1, flow = _batch_views(batch)
    x0, x1 = normalize_images(img0, img1)
    total, per_scale = multiscale_l1_loss(net(x0, x1), flow / DIV_FLOW)
    return total, {"loss": total, **per_scale}


def flownet_sd_loss(net: nn.Module, batch: dict) -> tuple[torch.Tensor, dict]:
    img0, img1, flow = _batch_views(batch)
    x0, x1 = normalize_images(img0, img1)
    # the SD net predicts at 20x the other nets' scale: its target is the raw flow
    total, per_scale = multiscale_l1_loss(net(torch.cat([x0, x1], dim=1)), flow)
    return total, {"loss": total, **per_scale}


def flownet_sd_chairssdhom_loss(
    net: nn.Module, batch: dict, episode: tuple[float, float] = (2.0, 0.5)
) -> tuple[torch.Tensor, dict]:
    """The ChairsSDHom small-displacement recipe: BlackAugmentation of the
    batch (whole pairs blacked out or a border band zeroed,
    black_augmentation_layer.cu), when it carries ``black_mask`` /
    ``border_frac`` (N,), then per-scale Lpq losses at the (p, q)
    ``episode`` (``Solver``'s ``loss_schedule`` passes it) against the
    NaN-aware downsampled ground truth."""
    img0, img1, flow = _batch_views(batch)
    if "black_mask" in batch:
        stack, flow = apply_black_augmentation(
            torch.cat([img0, img1], dim=1), flow, batch["black_mask"], batch["border_frac"]
        )
        img0, img1 = stack[:, :3], stack[:, 3:]
    x0, x1 = normalize_images(img0, img1)
    p, q = episode
    total = torch.zeros((), device=flow.device)
    per_scale = {}
    for name, f in net(torch.cat([x0, x1], dim=1)).items():
        w = DEFAULT_SCALE_WEIGHTS.get(name, 0.0)
        if w == 0.0:
            continue
        loss = lpq_loss(f, downsample_nan_aware(flow, f.shape[2], f.shape[3]), p=p, q=q)
        per_scale[name] = loss
        total = total + w * loss
    return total, {"loss": total, **per_scale}


def dispnet_c_loss(net: nn.Module, batch: dict) -> tuple[torch.Tensor, dict]:
    """Stereo objective: multi-scale L1 on 1-channel disparity (img0 the left
    frame, img1 the right, flow (N, H, W, 1) the disparity, the DisparityData
    convention), targets scaled by 1/DIV_FLOW like the flow nets'."""
    img0, img1, disp = _batch_views(batch)
    x0, x1 = normalize_images(img0, img1)
    total, per_scale = multiscale_l1_loss(net(x0, x1), disp / DIV_FLOW)
    return total, {"loss": total, **per_scale}


def flownet2_loss(net: nn.Module, batch: dict) -> tuple[torch.Tensor, dict]:
    """Joint objective on the whole cascade: EPE of the fused final flow.
    Every warp of the cascade then takes a flow that depends on trained
    weights, so the warp's backward runs 4 times per step."""
    img0, img1, flow = _batch_views(batch)
    loss = l1_loss(flownet2_forward(net, img0, img1), flow, l2_per_location=True)
    return loss, {"loss": loss}


def make_cascade_stage_loss(stage: str) -> Callable:
    """Objective of a refinement stage (``flownets_1`` or ``flownets_2``) of
    a FlowNet2 net, with the upstream nets frozen: the FlowNet2 stage-wise
    recipe (paper section 4)."""
    if stage not in ("flownets_1", "flownets_2"):
        raise ValueError(f"unknown cascade stage {stage!r}")

    def loss_fn(net, batch):
        img0, img1, flow = _batch_views(batch)
        x0, x1 = normalize_images(img0, img1)
        with torch.no_grad():
            upstream = _upsample_flow_4x(net.flownetc(x0, x1)["flow2"], DIV_FLOW)
            if stage == "flownets_2":
                upstream = _cascade_stage(net, "flownets_1", x0, x1, upstream)[0]
        _, flows = _cascade_stage(net, stage, x0, x1, upstream)
        total, per_scale = multiscale_l1_loss(flows, flow / DIV_FLOW)
        return total, {"loss": total, **per_scale}

    return loss_fn


def make_sd_stage_loss() -> Callable:
    """The SD branch of a FlowNet2 net (same math as ``flownet2-sd``)."""

    def loss_fn(net, batch):
        return flownet_sd_loss(net.flownetsd, batch)

    return loss_fn


def make_c_stage_loss() -> Callable:
    """FlowNetC of a FlowNet2 net (same math as ``flownetc``)."""

    def loss_fn(net, batch):
        return flownet_c_loss(net.flownetc, batch)

    return loss_fn


def make_fusion_stage_loss(weights: dict[str, float] | None = None) -> Callable:
    """The fusion net of a FlowNet2 net with the whole upstream cascade
    frozen. The fusion net predicts real-scale flow at strides 1/2/4, so the
    targets are the raw GT flow, and each scale is a mean EPE per valid
    pixel (``normalize_by_num_entries``); the default weights fold each
    scale's pixel share in (1 : 0.5/4 : 0.25/16)."""
    weights = weights or {"flow0": 1.0, "flow1": 0.125, "flow2": 0.015625}

    def loss_fn(net, batch):
        img0, img1, flow = _batch_views(batch)
        x0, x1 = normalize_images(img0, img1)
        with torch.no_grad():
            fused_in = build_fusion_inputs(net, x0, x1)
        total, per_scale = multiscale_l1_loss(net.fusion(fused_in), flow, weights, normalize=True)
        return total, {"loss": total, **per_scale}

    return loss_fn


# Cascade stage -> the sub-net it trains (the stage-wise recipe order).
STAGE_SUBTREE = {
    "c": "flownetc",
    "s1": "flownets_1",
    "s2": "flownets_2",
    "sd": "flownetsd",
    "fusion": "fusion",
}

# Objectives that train a model other than the one of their own name.
LOSS_MODEL = {"flownet2-sd-sdhom": "flownet2-sd"}

# Cascade stage -> its key in LOSSES (the loss takes the whole FlowNet2 net).
STAGE_LOSS_KEY = {
    "c": "flownet2-c-stage",
    "s1": "flownet2-s1",
    "s2": "flownet2-s2",
    "sd": "flownet2-sd-stage",
    "fusion": "flownet2-fusion",
}


def trainable_module(net: nn.Module, loss_key: str) -> nn.Module:
    """The part of ``net`` the optimizer updates under ``LOSSES[loss_key]``:
    the stage's sub-net for a stage loss, else the whole net."""
    stages = {key: stage for stage, key in STAGE_LOSS_KEY.items()}
    if loss_key in stages:
        return getattr(net, STAGE_SUBTREE[stages[loss_key]])
    return net


LOSSES: dict[str, Callable] = {
    "flownets": flownet_s_loss,
    "flownetc": flownet_c_loss,
    "dispnetc": dispnet_c_loss,
    "flownet2-sd": flownet_sd_loss,
    "flownet2-sd-sdhom": flownet_sd_chairssdhom_loss,
    "flownet2-s1": make_cascade_stage_loss("flownets_1"),
    "flownet2-s2": make_cascade_stage_loss("flownets_2"),
    "flownet2-fusion": make_fusion_stage_loss(),
    # FlowNet2-net variants of the self-contained stages (same math as
    # flownetc / flownet2-sd; the optimizer updates the named sub-net)
    "flownet2-c-stage": make_c_stage_loss(),
    "flownet2-sd-stage": make_sd_stage_loss(),
}
