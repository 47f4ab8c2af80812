"""The port's training objectives against the JAX package: loss and every
trainable parameter's gradient, on the CPU.

One set of seeded random FlowNet2 weights (the port's ``init_params``)
goes to both packages (DispNetC's objective: its own seeded weights, and
the batch's first flow channel as the disparity); the batch is numpy from a
seed, with NaN ground-truth pixels. JAX takes its exact CPU routes (the gather warp, and
``correlation_auto``'s custom VJP). Loss: rtol 1e-4. Gradients: the
relative L2 error of each tensor <= 1e-3, since XLA and PyTorch sum 20+
layers of convolutions in different orders.

The frames are smooth seeded textures, as natural frames are locally
smooth. On white-noise frames the warp's flow derivative (the image's
difference between neighbouring pixels) jumps at every pixel boundary, and
the joint loss's gradients at FlowNetC then move by 2% under a 1e-6
relative change of one input frame: no two float32 implementations could
agree there to 1e-3. Even on smooth frames a deep layer of a 64x128 input
has a few dozen activations, and a leaky-ReLU kink within float32 noise
of zero moves its gradient by a percent. The batch of the per-tensor test
(seed 7) was checked to sit clear of that (worst tensor 6e-5 against the
JAX package, where a 1e-6 change of one frame moves the port's own
gradients by up to 1e-3). Batches that were not checked (seeds 1 and 2)
hold the joint loss's gradients as a whole, which kinks flipping in a few
tensors cannot swing: relative L2 over all tensors together <= 1e-3, and
the median tensor's <= 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flownet2_tpu.checkpoint import flatten_params, unflatten_params
from flownet2_tpu.train import objectives as jax_objectives
from flownet2_tpu_torch.checkpoint import init_params, load_into, params_from_state_dict
from flownet2_tpu_torch.models import DispNetC, FlowNet2
from flownet2_tpu_torch.train import objectives

torch.set_num_threads(2)  # the suite runs several workers side by side

H, W = 64, 128


@pytest.fixture(scope="module")
def flat():
    return init_params("flownet2", seed=3)


def smooth_frame(rng: np.random.Generator) -> np.ndarray:
    """(1, H, W, 3) in 0-255: four random low-frequency plane waves per channel."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    freq = rng.uniform(0.01, 0.05, (4, 3))
    phase = rng.uniform(0, 2 * np.pi, (4, 3))
    slant = rng.uniform(-1, 1, (4, 3))
    waves = sum(np.sin(xs[..., None] * freq[k] + ys[..., None] * freq[k] * slant[k] + phase[k]) for k in range(4))
    return (127.5 + 30 * waves)[None].astype(np.float32)


def make_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    b = {"img0": smooth_frame(rng), "img1": smooth_frame(rng), "flow": rng.normal(0, 4, (1, H, W, 2)).astype(np.float32)}
    b["flow"][0, 10:14, 20:30] = np.nan  # invalid ground truth
    return b


@pytest.fixture(scope="module")
def batch():
    return make_batch(7)


@functools.cache
def jax_value_and_grad(loss_key):
    jax_fn = jax_objectives.flownet2_loss if loss_key == "joint" else jax_objectives.LOSSES[loss_key]
    return jax.jit(jax.value_and_grad(jax_fn, has_aux=True))


def _jax_grads(flat, batch, loss_key):
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax_value_and_grad(loss_key)(unflatten_params(flat), jax_batch)
    return float(loss), flatten_params(grads)


def _port_grads(flat, batch, loss_key):
    """Loss and JAX-layout gradients of the port's objective (net trained
    as the Solver trains it: only the stage's sub-net needs gradients)."""
    with torch.device("meta"):
        net = DispNetC() if loss_key == "dispnetc" else FlowNet2()
    load_into(net, flat)
    loss_fn = objectives.flownet2_loss if loss_key == "joint" else objectives.LOSSES[loss_key]
    sub = net if loss_key == "joint" else objectives.trainable_module(net, loss_key)
    prefix = "" if sub is net else next(k for k, m in net.named_children() if m is sub) + "."
    for p in net.parameters():
        p.requires_grad_(False)
    for p in sub.parameters():
        p.requires_grad_(True)
    loss, _ = loss_fn(net, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    grads = {prefix + k: p.grad for k, p in sub.named_parameters()}
    return loss.item(), params_from_state_dict(grads)


@pytest.mark.parametrize("loss_key", ["flownetc", "flownet2-s1", "flownet2-fusion", "joint", "dispnetc"])
def test_objective_loss_and_gradients_match_jax(flat, batch, loss_key):
    if loss_key == "flownetc":  # the C-stage loss on the FlowNet2 net: FlowNetC's loss
        loss_key = "flownet2-c-stage"
    if loss_key == "dispnetc":  # DispNetC's own weights; the batch's disparity is one flow channel
        flat = init_params("dispnetc", seed=3)
        batch = {**batch, "flow": np.ascontiguousarray(batch["flow"][..., :1])}
    ref_loss, ref_grads = _jax_grads(flat, batch, loss_key)
    loss, grads = _port_grads(flat, batch, loss_key)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    assert grads, "no trainable parameter got a gradient"
    for k, g in grads.items():
        r = np.asarray(ref_grads[k])
        assert np.isfinite(g).all(), k
        err = np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30)
        assert err <= 1e-3, f"{k}: relative L2 error {err:.3g}"
    # frozen sub-nets: JAX's stop_gradient gives zeros, the port no gradient
    frozen = {k for k in ref_grads if k not in grads}
    assert all(not np.asarray(ref_grads[k]).any() for k in frozen)


@pytest.mark.parametrize("seed", [1, 2])
def test_joint_gradients_match_jax_as_a_whole(flat, seed):
    batch = make_batch(seed)
    ref_loss, ref_grads = _jax_grads(flat, batch, "joint")
    loss, grads = _port_grads(flat, batch, "joint")
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    assert grads.keys() == ref_grads.keys()
    diff = sum(float(np.sum((grads[k] - np.asarray(r)) ** 2)) for k, r in ref_grads.items())
    norm = sum(float(np.sum(np.asarray(r) ** 2)) for r in ref_grads.values())
    per = {k: np.linalg.norm(grads[k] - np.asarray(r)) / np.linalg.norm(r) for k, r in ref_grads.items()}
    worst = max(per, key=per.get)
    whole, median = (diff / norm) ** 0.5, float(np.median(list(per.values())))
    assert whole <= 1e-3 and median <= 1e-3, (
        f"relative L2 of all {whole:.3g}, median tensor {median:.3g}; worst {worst} {per[worst]:.3g}")
