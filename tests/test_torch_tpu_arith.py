"""The port's two arms of the JAX TPU run's arithmetic, on the CPU: the
bfloat16 affine sample of the augmentation (``apply_spatial_transform``'s
``sample_dtype``) against the JAX package's accelerator route, the
bfloat16-pass convolutions (``tools/diag/tpu_arith``) against float64, and
the decision rule of ``scripts/convergence_runs.py`` over the arms.

Tolerances:
- the bf16 sample against the JAX Pallas warp in interpret mode: both
  sample the same bf16 pixels at the same float32 positions; the TPU kernel
  rounds its horizontal tap weights to bf16 (each by at most 2^-9 of
  itself, so the sum moves by at most 2^-9 on [0, 1] images) and both round
  the output to bf16 once (one ulp, 2^-8 below 1.0): 2^-8 + 2^-9;
- the default sample bit-equal to the float32 sample as it was;
- a bf16-pass conv, deconv and their gradients against float64 of the
  bf16-rounded operands: the products are exact in float32, so only the
  float32 sums round: per element n * 2^-24 times the sum of the terms'
  magnitudes (n terms a sum), the standard bound of a float32 sum;
- a net beside a routed copy of it bit-equal to itself before the routing.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from flownet2_tpu_torch.ops.augment import affine_position_flow, apply_spatial_transform
from flownet2_tpu_torch.ops.warp import flow_warp
from flownet2_tpu_torch.tools.diag.tpu_arith import BF16PassConv, route_convs

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

import convergence_runs as cr  # noqa: E402

U32 = 2.0 ** -24


def _sources(seed: int, n: int = 2, h: int = 48, w: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """8-bit images scaled to [0, 1] (NHWC) and mild crop -> source affines
    (rotation within 0.1 rad, zoom 0.9-1.1, shifts of a few pixels): inside
    the Pallas warp's window budget."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, h, w, 3)).astype(np.float32) / 255.0
    mats = []
    for _ in range(n):
        a, z = rng.uniform(-0.1, 0.1), rng.uniform(0.9, 1.1)
        c, s = np.cos(a) * z, np.sin(a) * z
        mats.append([c, s, -s, c, rng.uniform(0, 6), rng.uniform(0, 6)])
    return images, np.asarray(mats, np.float32)


def test_bf16_sample_matches_the_jax_accelerator_route():
    import jax.numpy as jnp

    from flownet2_tpu.ops import augment as jax_aug
    from flownet2_tpu.ops.pallas.warp import flow_warp_pallas

    images, mats = _sources(3)
    out_h, out_w = 40, 56
    u, v = jax_aug._affine_positions(jnp.asarray(mats), 48, 64)
    posflow = jnp.stack([u, v], axis=-1)
    # flownet2_tpu/ops/augment.py:445-448: bf16 images, the f32 position flow
    ref = flow_warp_pallas(jnp.asarray(images).astype(jnp.bfloat16), posflow, interpret=True)
    ref = np.asarray(ref[:, :out_h, :out_w].astype(jnp.float32)).transpose(0, 3, 1, 2)
    got = apply_spatial_transform(torch.from_numpy(images).permute(0, 3, 1, 2), torch.from_numpy(mats),
                                  out_h, out_w, sample_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == (2, 3, out_h, out_w)
    assert np.abs(got.numpy() - ref).max() <= 2.0 ** -8 + 2.0 ** -9
    # the sample is bf16: it differs from the float32 sample by up to a bf16 ulp
    f32 = apply_spatial_transform(torch.from_numpy(images).permute(0, 3, 1, 2), torch.from_numpy(mats), out_h, out_w)
    assert torch.equal(got, got.bfloat16().float()) and 0 < (got - f32).abs().max() <= 2.0 ** -8


@pytest.mark.parametrize("crop", [(40, 56), (56, 80)], ids=["inside the source", "wider than the source"])
def test_default_sample_is_the_float32_sample_bit_for_bit(crop):
    images, mats = _sources(4)
    x, m = torch.from_numpy(images).permute(0, 3, 1, 2), torch.from_numpy(mats)
    n, c, h, w = x.shape
    ch, cw = max(h, crop[0]), max(w, crop[1])
    before = flow_warp(F.pad(x.float(), (0, cw - w, 0, ch - h)).contiguous(),
                       affine_position_flow(m, h, w, ch, cw))[:, :, :crop[0], :crop[1]]
    assert torch.equal(apply_spatial_transform(x, m, *crop), before)
    assert torch.equal(apply_spatial_transform(x, m, *crop, sample_dtype=torch.float32), before)
    with pytest.raises(ValueError, match="sample_dtype"):
        apply_spatial_transform(x, m, *crop, sample_dtype=torch.float16)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


LAYERS = {
    "conv 3x3 s1": lambda: nn.Conv2d(5, 7, 3, stride=1, padding=1),
    "conv 7x7 s2": lambda: nn.Conv2d(6, 8, 7, stride=2, padding=3),
    "deconv k4 s2": lambda: nn.ConvTranspose2d(6, 4, 4, stride=2, padding=1),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_bf16_pass_conv_matches_float64_of_rounded_operands(name):
    torch.manual_seed(5)
    layer = LAYERS[name]()
    transposed = isinstance(layer, nn.ConvTranspose2d)
    x = torch.randn(2, layer.in_channels, 12, 16)
    geometry = (layer.stride, layer.padding, layer.dilation, transposed,
                layer.output_padding if transposed else (0, 0), layer.groups)

    xg = x.clone().requires_grad_()
    w, b = layer.weight.detach().clone().requires_grad_(), layer.bias.detach().clone().requires_grad_()
    out = BF16PassConv.apply(xg, w, b, geometry)
    g = torch.randn_like(out)
    out.backward(g)

    def float64_conv(xx, ww, bb, gg):
        xx, ww = xx.double().requires_grad_(), ww.double().requires_grad_()
        o = torch.ops.aten.convolution(xx, ww, None, *geometry) + bb.double().view(1, -1, 1, 1)
        o.backward(gg.double())
        return o.detach(), xx.grad, ww.grad

    ref, ref_dx, ref_dw = float64_conv(_bf16(x), _bf16(layer.weight.detach()), layer.bias.detach(), _bf16(g))
    mag, mag_dx, mag_dw = float64_conv(_bf16(x).abs(), _bf16(layer.weight.detach()).abs(),
                                       layer.bias.detach().abs(), _bf16(g).abs())
    k = layer.kernel_size[0] * layer.kernel_size[1]
    terms = {"out": layer.in_channels * k + 1, "dx": layer.out_channels * k, "dw": g.shape[0] * g.shape[2] * g.shape[3]}
    for got_, ref_, mag_, n in ((out, ref, mag, terms["out"]), (xg.grad, ref_dx, mag_dx, terms["dx"]),
                                (w.grad, ref_dw, mag_dw, terms["dw"])):
        assert got_.dtype == torch.float32
        assert ((got_.double() - ref_).abs() <= n * U32 * mag_ + 1e-30).all()
    db_terms = g.shape[0] * g.shape[2] * g.shape[3]
    assert ((b.grad.double() - g.double().sum((0, 2, 3))).abs()
            <= db_terms * U32 * g.double().abs().sum((0, 2, 3))).all()
    # the rounding is real: the plain float32 layer gives another result
    assert (layer(x) - out).abs().max() > 0


def test_route_convs_changes_one_net_and_nothing_else():
    import copy

    from flownet2_tpu_torch.models import NETS

    torch.manual_seed(6)
    net = NETS["flownets"]()
    x = torch.randn(1, 6, 64, 64)
    with torch.no_grad():
        before = net(x)["flow2"]
        routed_net = copy.deepcopy(net)
        assert route_convs(routed_net) == sum(isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))
                                              for m in net.modules())
        routed, after = routed_net(x)["flow2"], net(x)["flow2"]
    assert torch.equal(after, before)
    state, routed_state = net.state_dict(), routed_net.state_dict()
    assert list(routed_state) == list(state) and all(torch.equal(routed_state[k], state[k]) for k in state)
    assert 0 < (routed - before).abs().max() <= 1e-2 * before.abs().max()
    with pytest.raises(TypeError, match="float32"):
        routed_net.double()(x.double())


JAX = cr.jax_r5()


def _arm_runs(arm: str, lates: list[float], early: float = 70.4, held: float = 8.4) -> list[dict]:
    """Runs of ``arm`` at the recipe's full length: late-window losses
    ``lates``, the early window and the held-out means spread evenly
    around ``early`` (+-0.64) and ``held`` (+-0.32)."""
    out = []
    for i, late in enumerate(lates):
        d = (i - (len(lates) - 1) / 2) / len(lates)
        epe = held + 0.8 * d
        out.append(dict(seed=3 + 2 * i, arm=arm, tf32="TF32: cudnn False matmul False", iter_per_s=30.0,
                        loss_means=[early + 1.6 * d, late],
                        curve=[dict(iteration=it, epe=epe) for it in (0, 1504, 3008, 4512, 6016)]))
    return out


TF32_LIKE = [55.2, 56.1, 54.6, 57.0, 55.9]
JAX_LIKE = [53.0, 53.6, 52.8, 53.9, 53.3]


@pytest.mark.parametrize("sample,tpu,verdict", [
    (JAX_LIKE, TF32_LIKE, "the bf16 sample accounts for the gap: closed as the TPU run's arithmetic, not a port fault"),
    (TF32_LIKE, JAX_LIKE, "the TPU run's whole arithmetic accounts for the gap: closed as the TPU run's arithmetic, "
                          "not a port fault"),
    (TF32_LIKE, TF32_LIKE, "neither arm names the cause: open, with precision and the sample excluded"),
], ids=["the sample names", "the whole arithmetic names", "neither names"])
def test_decide_gives_each_verdict(tmp_path, capsys, sample, tpu, verdict):
    runs = _arm_runs("bf16-sample", sample) + _arm_runs("tpu", tpu) + _arm_runs("tf32", [55.4, 56.7, 58.0])[:3]
    for r, seed in zip(runs[-3:], (3, 17, 31)):
        r["seed"] = seed
    path = tmp_path / "convergence.json"
    path.write_text(json.dumps({"r5": {"runs": runs, "jax": dict(JAX, curve={str(k): v for k, v in
                                                                           JAX["curve"].items()})}}))
    assert cr.main(["--decide", str(path)]) == 0
    out = capsys.readouterr().out
    assert "the TF32 arm: PR 19's ten seeds" in out
    assert "TF32 drift check, seed 17: losses 3104-6016 56.7000, PR 19's ten seeds 54.0572-58.5489: within" in out
    assert out.rstrip().endswith(f"[decide] decision: {verdict}")


def test_decide_names_an_arm_but_leaves_the_gap_open_when_its_own_seeds_fail_rule_b():
    runs = cr.r5_rows(_arm_runs("bf16-sample", JAX_LIKE, held=10.5) + _arm_runs("tpu", TF32_LIKE))
    lines = []
    verdict = cr.decide_runs(runs, JAX, log=lines.append)
    assert verdict == "the bf16 sample accounts for the gap: still open: rule (a) or (b) fails on its own seeds"
    assert any("arm bf16-sample, 5 seeds" in line and line.endswith("names its arithmetic") for line in lines)


def test_arm_jobs_run_in_turns_seed_by_seed():
    assert cr.r5_jobs("bf16-sample,tpu,tf32:3+31", [3, 5, 31]) == [
        (3, "bf16-sample"), (3, "tpu"), (3, "tf32"), (5, "bf16-sample"), (5, "tpu"),
        (31, "bf16-sample"), (31, "tpu"), (31, "tf32")]
    with pytest.raises(SystemExit, match="unknown arm"):
        cr.r5_jobs("bf16", [3])
