"""Per-stage cost breakdown derived from the model definition itself (the
port of flownet2_tpu/tools/breakdown.py).

The reference's ``caffe time`` walks the Net's layer list and times each
layer's Forward/Backward (tools/caffe.cpp:302-388). Here the unit is the
CASCADE STAGE: the sub-nets (FlowNetC/S/SD, the fusion net, DispNetC) and
the glue ops between them (normalize, warp, channel norm, resample), the
granularity of the JAX tool.

:func:`walk_stages` derives the stage list from one real forward of the
model's own forward function (``inference._make_forward``): the sub-nets
are recorded by forward pre-hooks, the glue ops by recording shims put
where the forward references them (``models/flownet2.py`` and
``inference.py``), so the stage list, the call counts and the input shapes
come from the actual wiring and any cascade (flownetc, flownet2-css,
dispnetc, ...) breaks down without a table of its own.

:func:`time_stages` then times each stage alone on random inputs of the
recorded shapes after warm-ups, by CUDA events on the card (the host clock
on the CPU): forward, and forward plus backward through
``torch.autograd.grad`` with respect to its first floating input, with
cotangents of ones. A stage with nothing to differentiate (no floating
input, or no output that depends on it) reports NaN; any other error
propagates.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch import nn

# stage name -> (module path, attribute) pairs where the glue ops are
# *referenced* (patching the defining module alone would miss the
# `from x import y` aliases)
_PATCH_SITES: dict[str, list[tuple[str, str]]] = {
    "normalize_images": [
        ("flownet2_tpu_torch.models.flownet2", "normalize_images"),
        ("flownet2_tpu_torch.inference", "normalize_images"),
    ],
    "flow_warp": [("flownet2_tpu_torch.models.flownet2", "flow_warp")],
    "channel_norm": [("flownet2_tpu_torch.models.flownet2", "channel_norm")],
    "resample": [
        ("flownet2_tpu_torch.models.flownet2", "resample"),
        ("flownet2_tpu_torch.inference", "resample"),
    ],
}


def _subnet_stage_names() -> dict[type, str]:
    from flownet2_tpu_torch.models import DispNetC, FlowNetC, FlowNetFusion, FlowNetS, FlowNetSD

    return {FlowNetC: "flownetc", FlowNetS: "flownets", FlowNetSD: "flownet-sd", FlowNetFusion: "fusion",
            DispNetC: "dispnetc"}


@dataclass
class Stage:
    """One timed row: a stage-level op and the shapes it was called with
    inside the model; ``count`` is how many times the model calls it with
    this signature."""

    name: str
    fn: Callable
    arg_specs: tuple  # per positional arg: ("arr", shape, dtype) | ("static", value)
    kwargs: dict
    count: int = 1
    # filled by time_stages:
    fwd_ms: float = field(default=float("nan"))
    fwdbwd_ms: float = field(default=float("nan"))

    @property
    def bwd_ms(self) -> float:
        return self.fwdbwd_ms - self.fwd_ms

    def signature(self) -> tuple:
        return (self.name, self.arg_specs, tuple(sorted(self.kwargs.items())))

    def spatial(self) -> list[tuple[int, int]]:
        """(H, W) of each array argument (NCHW)."""
        return [tuple(s[1][2:4]) for s in self.arg_specs if s[0] == "arr"]


def _spec_of(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return ("arr", tuple(x.shape), x.dtype)
    return ("static", x)


@contextlib.contextmanager
def _recording(net: nn.Module, records: list):
    """Shims on the glue ops and pre-hooks on the sub-nets, appending
    (name, callable, arg specs, kwargs) to ``records`` for each call."""

    def make_shim(name, real):
        def shim(*a, **kw):
            records.append((name, real, tuple(_spec_of(x) for x in a), dict(kw)))
            return real(*a, **kw)

        return shim

    saved, hooks = [], []
    try:
        for name, sites in _PATCH_SITES.items():
            shim = None
            for mod_path, attr in sites:
                mod = importlib.import_module(mod_path)
                real = getattr(mod, attr)
                shim = shim or make_shim(name, real)
                saved.append((mod, attr, real))
                setattr(mod, attr, shim)
        names = _subnet_stage_names()
        for module in net.modules():
            if type(module) in names:
                def hook(m, args, kwargs, _name=names[type(module)]):
                    records.append((_name, m, tuple(_spec_of(x) for x in args), dict(kwargs)))

                hooks.append(module.register_forward_pre_hook(hook, with_kwargs=True))
        yield
    finally:
        for h in hooks:
            h.remove()
        for mod, attr, real in saved:
            setattr(mod, attr, real)


def walk_stages(model: str, net: nn.Module, img0: torch.Tensor, img1: torch.Tensor) -> list[Stage]:
    """Run ``model``'s forward once on ``net`` and the raw NCHW frames (at a
    size divisible by 64) with recording in place; return the deduplicated
    stage list in first-call order with per-signature call counts."""
    from flownet2_tpu_torch.inference import _make_forward

    records: list[tuple[str, Callable, tuple, dict]] = []
    forward = _make_forward(model)
    with _recording(net, records), torch.no_grad():
        forward(net, img0, img1)

    stages: dict[tuple, Stage] = {}
    for name, fn, arg_specs, kwargs in records:
        st = Stage(name=name, fn=fn, arg_specs=arg_specs, kwargs=kwargs)
        sig = st.signature()
        if sig in stages:
            stages[sig].count += 1
        else:
            stages[sig] = st
    return list(stages.values())


def _materialize(spec, gen: torch.Generator, device):
    """A random tensor in [-1, 1) for an array spec; statics pass through."""
    if spec[0] == "arr":
        _, shape, dtype = spec
        return (torch.rand(shape, generator=gen) * 2 - 1).to(device=device, dtype=dtype)
    return spec[1]


def _leaves(out) -> list[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    return [t for o in out for t in _leaves(o)]


def time_ms(fn: Callable[[], Any], device: torch.device, *, warmup: int, runs: int) -> float:
    """Mean ms of one call of ``fn`` over ``runs`` calls after ``warmup``:
    CUDA events around the runs on a card, the host clock (after the
    calls end) on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / runs
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    return (time.perf_counter() - t0) * 1e3 / runs


def time_stages(
    stages: list[Stage], device, *, warmup: int = 3, runs: int = 10, backward: bool = False
) -> list[Stage]:
    """Fill ``fwd_ms`` (and ``fwdbwd_ms`` when ``backward``) of every stage,
    each run alone on seeded random inputs of its recorded shapes."""
    device = torch.device(device)
    gen = torch.Generator().manual_seed(1)
    for st in stages:
        args = [_materialize(s, gen, device) for s in st.arg_specs]
        grad_at = next((i for i, a in enumerate(args) if isinstance(a, torch.Tensor) and a.is_floating_point()),
                       None)

        def fwd(_st=st, _args=args):
            with torch.no_grad():
                return _st.fn(*_args, **_st.kwargs)

        st.fwd_ms = time_ms(fwd, device, warmup=warmup, runs=runs)
        if not backward or grad_at is None:
            continue

        def differentiated_outputs(_st=st, _args=args, _i=grad_at):
            a = _args[_i].detach().requires_grad_()
            return a, [t for t in _leaves(_st.fn(*_args[:_i], a, *_args[_i + 1:], **_st.kwargs)) if t.requires_grad]

        if not differentiated_outputs()[1]:  # no output depends on the input differentiably
            continue

        def fwdbwd(_outputs=differentiated_outputs):
            a, outs = _outputs()
            return torch.autograd.grad(outs, a, grad_outputs=[torch.ones_like(t) for t in outs])

        st.fwdbwd_ms = time_ms(fwdbwd, device, warmup=warmup, runs=runs)
    return stages
