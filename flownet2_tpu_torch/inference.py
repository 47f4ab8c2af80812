"""End-to-end inference: the ``run-flownet`` contract (flownet2_tpu/inference.py).

Each model has its input rule. The FlowNet models: resize the image pair to
the /64-adapted resolution (linear, the reference's offsets), run the net,
resize the flow back to the input resolution and rescale u and v by
target/adapted per axis (flownet2_tpu/core/adapt.py). RAFT, as its published
Sintel evaluation: pad the pair to a multiple of 8 with replicated edges
(split evenly, the extra row or column below or right), run the net, crop
the padding off the flow; no rescale.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from flownet2_tpu_torch.checkpoint import init_params, load_into
from flownet2_tpu_torch.core.adapt import adapt_shape
from flownet2_tpu_torch.data.pipeline import pack_into, pack_layout, unpack_views
from flownet2_tpu_torch.models import MODELS
from flownet2_tpu_torch.models.common import to_nchw, to_nhwc
from flownet2_tpu_torch.models.flownet2 import (
    DIV_FLOW,
    flownet2_cs_forward,
    flownet2_css_forward,
    flownet2_forward,
    normalize_images,
)
from flownet2_tpu_torch.ops.resample import resample


def _s_quarter(net, x0, x1):
    return net(torch.cat([x0, x1], dim=1))["flow2"], DIV_FLOW


def _c_quarter(net, x0, x1):
    return net(x0, x1)["flow2"], DIV_FLOW


def _sd_quarter(net, x0, x1):
    return net(torch.cat([x0, x1], dim=1))["flow2"], 1.0 / DIV_FLOW


def _make_forward(model: str) -> Callable:
    """forward(net, img0, img1) -> adapted-resolution flow (real scale), NCHW.

    img0/img1: (N, 3, Ha, Wa), raw 0-255 range, already at the adapted size.
    """
    cascades = {
        "flownet2": flownet2_forward,
        "flownet2-css": flownet2_css_forward,
        "flownet2-cs": flownet2_cs_forward,
    }
    if model in cascades:
        return cascades[model]
    # DispNetC takes the left/right pair as FlowNetC takes its two frames
    quarter = {
        "flownets": _s_quarter, "flownetc": _c_quarter, "flownet2-sd": _sd_quarter, "dispnetc": _c_quarter,
    }[model]

    def forward(net, img0, img1):
        flow_q, post_scale = quarter(net, *normalize_images(img0, img1))
        return resample(flow_q * post_scale, img0.shape[2], img0.shape[3], antialias=False)

    return forward


# model name -> seed -> random weights in the JAX package's flat layout
MODEL_INITS = {name: partial(init_params, name) for name in MODELS}
MODEL_NAMES = tuple(MODEL_INITS)


def check_model(model: str) -> None:
    if model not in MODEL_INITS:
        raise ValueError(f"unknown model {model!r}; choose from {MODEL_NAMES}")


def pad_to_8(h: int, w: int) -> tuple[int, int, int, int]:
    """RAFT's "sintel" padding of an (h, w) frame to multiples of 8:
    (top, bottom, left, right), the odd row or column below or right."""
    ph, pw = ((h // 8 + 1) * 8 - h) % 8, ((w // 8 + 1) * 8 - w) % 8
    return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2


class FlowRunner:
    """Inference for one model on one device.

    ``params``: weights in the JAX package's layout, flat (``.npz`` keys) or
    nested. ``device``: required, e.g. "cuda" (the kernels) or "cpu" (the
    plain versions). ``dtype``: None or "float32" keeps float32; "bfloat16" casts the
    weights and the activations, as the JAX runner does. Flow input and
    output stay float32 either way. ``fusion_head``: run the fusion net's
    decoder head as one fused call (the K4 kernel on the card), the
    counterpart of the JAX package's ``FLOWNET2_TPU_FUSION_HEAD=1``;
    ``flownet2`` only, default off. ``iters``: RAFT's updates a forward
    (default 32, the published Sintel evaluation's); ``raft`` only. RAFT in
    bfloat16 keeps its volume, the lookup and the coordinates in float32.

    ``batch`` runs in four ``torch.profiler.record_function`` ranges, one
    after another: ``fn2.runner.prepare``, ``fn2.runner.upload``,
    ``fn2.runner.forward`` (all of ``run``) and ``fn2.runner.download``.
    On a card, uint8 frames cross the link as uint8: prepare copies both
    into one pinned host buffer the runner keeps (grown when a batch needs
    more bytes), after the buffer's previous copy has completed, and upload
    enqueues one ``non_blocking`` copy of it; ``run`` converts them to
    float32 on the card. Frames of any other dtype, and every frame on a
    CPU runner, are converted to float32 on the host and uploaded from
    there. ``u8_uploads`` counts the batches staged as uint8, over every
    instance.
    """

    u8_uploads = 0

    def __init__(self, model: str, params: dict, *, device, dtype=None, fusion_head: bool = False,
                 iters: int | None = None):
        check_model(model)
        if fusion_head and model != "flownet2":
            raise ValueError(f"fusion_head applies to flownet2 (the model that runs the fusion net), not {model!r}")
        if iters is not None and model != "raft":
            raise ValueError(f"iters applies to raft (the model that refines in updates), not {model!r}")
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.model = model
        self.device = torch.device(device)
        self.dtype = dtype or torch.float32
        options = {"fusion_head": True} if fusion_head else {}
        if iters is not None:
            options["iters"] = iters
        with torch.device("meta"):
            net = MODELS[model](**options)
        self.net = load_into(net, params).to(device=self.device, dtype=self.dtype).eval()
        # a net's input rule: RAFT's says it pads to /8; the FlowNet models' /64 adapt is the default
        if getattr(net, "pads_to_8", False):
            self._run = self._run_padded
        else:
            self._forward = _make_forward(model)
            self._run = self._run_adapted
        self._staging = (None, None)  # pinned uint8 host buffer, event of its last copy

    @torch.inference_mode()
    def run(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) RGB tensors on the runner's device -> (N, H, W, 2) float32 flow."""
        with record_function("fn2.runner.forward"):
            if img0.shape != img1.shape:
                raise ValueError(f"image shapes differ: {tuple(img0.shape)} vs {tuple(img1.shape)}")
            return self._run(img0, img1)

    def _run_adapted(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """The FlowNet models' rule: the /64 adapt, the net, the resize back and rescale."""
        h, w = img0.shape[1], img0.shape[2]
        geom = adapt_shape(h, w)
        ah, aw = geom.adapted_height, geom.adapted_width
        # adapt the input resolution (the deploy nets' leading Resample layers)
        x0 = resample(to_nchw(img0.float()), ah, aw).to(self.dtype)
        x1 = resample(to_nchw(img1.float()), ah, aw).to(self.dtype)
        flow = self._forward(self.net, x0, x1)
        # back to the input size, u and v rescaled per axis; dispnetc's one
        # disparity channel broadcasts to (d * scale_w, d * scale_h), as the
        # JAX runner's output does
        flow = resample(flow.float(), h, w, antialias=False)
        scale = torch.tensor([geom.scale_width, geom.scale_height], device=flow.device)
        return to_nhwc(flow * scale.view(1, 2, 1, 1))

    def _run_padded(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """RAFT's rule: replicate-pad to /8, the net, crop the padding off."""
        h, w = img0.shape[1], img0.shape[2]
        top, bottom, left, right = pad_to_8(h, w)
        x0, x1 = (F.pad(to_nchw(x.float()), (left, right, top, bottom), mode="replicate").to(self.dtype)
                  for x in (img0, img1))
        flow = self.net(x0, x1)
        return to_nhwc(flow[:, :, top:top + h, left:left + w])

    def __call__(self, img0: np.ndarray, img1: np.ndarray) -> np.ndarray:
        """img0/img1: (H, W, 3) uint8/float RGB -> (H, W, 2) float32 flow."""
        return self.batch(np.asarray(img0)[None], np.asarray(img1)[None])[0]

    def batch(self, img0: np.ndarray, img1: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) -> (N, H, W, 2)."""
        u8 = all(isinstance(x, np.ndarray) and x.dtype == np.uint8 for x in (img0, img1))
        if u8 and self.device.type == "cuda":
            i0, i1 = self._upload_u8(img0, img1)
        else:
            with record_function("fn2.runner.prepare"):
                f0, f1 = np.asarray(img0, np.float32), np.asarray(img1, np.float32)
            with record_function("fn2.runner.upload"):
                i0 = torch.as_tensor(f0, device=self.device)
                i1 = torch.as_tensor(f1, device=self.device)
        flow = self.run(i0, i1)
        with record_function("fn2.runner.download"):
            return flow.cpu().numpy()

    def _upload_u8(self, img0: np.ndarray, img1: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Both uint8 frames through the pinned staging buffer: uint8 views on the card."""
        frames = {"img0": img0, "img1": img1}
        offsets, total = pack_layout(frames)
        with record_function("fn2.runner.prepare"):
            buf, event = self._staging
            if event is not None:
                event.synchronize()  # the buffer's previous copy may still be reading it
            if buf is None or buf.numel() < total:
                buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
            pack_into(buf, frames, offsets)
        with record_function("fn2.runner.upload"):
            on_card = torch.empty(total, dtype=torch.uint8, device=self.device)
            on_card.copy_(buf[:total], non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._staging = (buf, event)
        FlowRunner.u8_uploads += 1
        views = unpack_views(on_card, frames, offsets)
        return views["img0"], views["img1"]
