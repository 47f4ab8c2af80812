"""The ``run_r5.sh`` training recipe chained, port against the JAX package, on
the CPU: FlowNetS trained from the device cache through the K-step path,
augmented 64x64 crops from 96x128 transport samples, batch 2, 3 steps.

Both packages start from the same weights (the port's seeded draws, carried
to the JAX layout), the same slabs and the same ``CacheChunks`` bank (equal
arrays from one seed, checked here), with noise 0. The JAX side runs
``make_multistep_train_step`` (a ``lax.scan``; its spatial sample on the
exact gather route on the CPU), the port's the same function of its own (the
warp's plain version on the CPU). Each piece of the step is held apart, so
that a difference names its step:

- step 1's augmented images (1e-3 on 0-255) and flow (equal, NaN pattern
  included);
- each step's loss (rtol 1e-4 at step 1, 1e-3 after: the later steps start
  from parameters that already differ by rounding);
- step 1's gradients (relative L2 1e-3, of all tensors and of the median
  tensor);
- the update after 3 steps, theta_3 - theta_0, as relative L2 of all
  tensors: 1e-3 under SGD; 2e-2 under Adam, which divides each gradient by
  its own running RMS, so an element whose gradient is near 0 takes a full
  step whose sign follows the rounding (one process running 8 pairs as 2 x 4
  moves Adam's updates by 1.1%, PERF.md section 6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flownet2_tpu.checkpoint import flatten_params, unflatten_params
from flownet2_tpu.data import augment_pipeline as jax_pipeline
from flownet2_tpu.data import device_cache as jax_cache
from flownet2_tpu.train import objectives as jax_objectives
from flownet2_tpu.train.solver import TrainState
from flownet2_tpu.train.solver import make_multistep_train_step as jax_multistep
from flownet2_tpu.train.solvers import SolverConfig as JaxSolverConfig
from flownet2_tpu.train.solvers import make_solver as jax_make_solver
from flownet2_tpu_torch.checkpoint import init_params, load_into, params_from_state_dict
from flownet2_tpu_torch.core.codec import encode_flow_int16
from flownet2_tpu_torch.data import augment_pipeline, device_cache
from flownet2_tpu_torch.models import FlowNetS
from flownet2_tpu_torch.train import SolverConfig, make_solver, objectives
from flownet2_tpu_torch.train.solver import make_multistep_train_step

torch.set_num_threads(2)  # the suite runs several workers side by side

SRC_H, SRC_W, CROP_H, CROP_W = 96, 128, 64, 64
BATCH, STEPS, SLAB, N_SLABS, SEED = 2, 3, 4, 2, 3
CONFIG = dict(lr_policy="multistep", base_lr=2e-4, gamma=0.5, stepvalues=(300_000, 400_000, 500_000),
              max_iter=600_000, momentum=0.9, momentum2=0.999)  # run_r5.sh: S_short, --base-lr 2e-4


def samples(seed=11, n=SLAB * N_SLABS):
    """Transport samples: smooth uint8 frames (no white noise: on noise the
    warp's derivatives jump at every pixel boundary) and smooth int16 flow,
    with an invalid (NaN) patch in the middle of every other sample."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:SRC_H, 0:SRC_W].astype(np.float32)
    out = []
    for i in range(n):
        frames = [np.clip(127.5 + 60 * np.sin(xs[..., None] * rng.uniform(0.02, 0.08, 3) + ys[..., None]
                                              * rng.uniform(0.02, 0.08, 3) + rng.uniform(0, 6, 3)), 0, 255)
                  for _ in range(2)]
        flow = np.stack([4 * np.sin(xs * rng.uniform(0.01, 0.05) + rng.uniform(0, 6)),
                         3 * np.cos(ys * rng.uniform(0.01, 0.05) + rng.uniform(0, 6))], axis=-1)
        if i % 2 == 0:
            flow[30:60, 40:90] = np.nan
        out.append({"img0": frames[0].astype(np.uint8), "img1": frames[1].astype(np.uint8),
                    "flow": encode_flow_int16(flow.astype(np.float32))})
    return out


def aug_sampler(rng, n):
    arrays = augment_pipeline.sample_aug_arrays(augment_pipeline.FlowNetAugConfig(), rng, n, SRC_H, SRC_W,
                                                CROP_H, CROP_W)
    arrays["aug_noise"] = np.zeros_like(arrays["aug_noise"])  # noise 0: the two generators differ
    return arrays


def jax_aug_sampler(rng, n):
    arrays = jax_pipeline.sample_aug_arrays(jax_pipeline.FlowNetAugConfig(), rng, n, SRC_H, SRC_W, CROP_H, CROP_W)
    arrays["aug_noise"] = np.zeros_like(arrays["aug_noise"])
    return arrays


@pytest.fixture(scope="module")
def chain():
    """Both packages' slabs and first bank, from one sample list and one seed."""
    items = samples()
    ours = device_cache.DeviceSampleCache(iter(items), slab_samples=SLAB, n_slabs=N_SLABS, refresh=False,
                                          device="cpu")
    theirs = jax_cache.DeviceSampleCache(iter(items), slab_samples=SLAB, n_slabs=N_SLABS, refresh=False,
                                         device=jax.devices("cpu")[0])
    slabs, bank = next(iter(device_cache.CacheChunks(ours, BATCH, STEPS, seed=SEED, aug_sampler=aug_sampler)))
    jax_slabs, jax_bank = next(iter(jax_cache.CacheChunks(theirs, BATCH, STEPS, seed=SEED,
                                                          aug_sampler=jax_aug_sampler)))
    assert sorted(bank) == sorted(jax_bank)
    for k, v in jax_bank.items():
        np.testing.assert_array_equal(bank[k], v)
    for s, js in zip(slabs, jax_slabs):
        for k in js:
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(js[k]))
    return dict(params=init_params("flownets", seed=SEED), slabs=slabs, bank=bank, jax_slabs=jax_slabs)


def step_batch(chain, i: int, jax_side: bool) -> dict:
    """Step i's batch as the K-step path hands it to the loss: the slabs'
    concatenation and row i of the bank."""
    bank = {k: v[i] for k, v in chain["bank"].items()}
    if jax_side:
        merged = {f"cache_{k}": jnp.concatenate([s[k] for s in chain["jax_slabs"]]) for k in chain["jax_slabs"][0]}
        return {**merged, **{k: jnp.asarray(v) for k, v in bank.items()}}
    merged = {f"cache_{k}": torch.cat([s[k] for s in chain["slabs"]]) for k in chain["slabs"][0]}
    return {**merged, **{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in bank.items()}}


def our_loss(base=objectives.flownet_s_loss):
    return device_cache.make_cache_gather_loss(
        augment_pipeline.make_augmented_loss(base, CROP_H, CROP_W, seed=SEED))


def their_loss(base=jax_objectives.flownet_s_loss):
    return jax_cache.make_cache_gather_loss(
        jax_pipeline.make_augmented_loss(base, CROP_H, CROP_W, seed=SEED, config=jax_pipeline.FlowNetAugConfig()))


def our_net(params) -> FlowNetS:
    with torch.device("meta"):
        net = FlowNetS()
    return load_into(net, params)


def rel_l2(got: dict, ref: dict) -> float:
    diff = sum(float(np.sum((np.asarray(got[k], np.float64) - np.asarray(r, np.float64)) ** 2))
               for k, r in ref.items())
    return (diff / sum(float(np.sum(np.asarray(r, np.float64) ** 2)) for r in ref.values())) ** 0.5


def median_rel_l2(got: dict, ref: dict) -> float:
    return float(np.median([rel_l2({k: got[k]}, {k: r}) for k, r in ref.items() if np.any(r)]))


def test_first_step_augmented_batch_and_gradients_match_jax(chain):
    seen, jax_seen = {}, {}

    def capture(net, batch):
        seen.update({k: v.detach().clone() for k, v in batch.items()})
        return objectives.flownet_s_loss(net, batch)

    def jax_capture(params, batch):
        jax_seen.update({k: np.asarray(v) for k, v in batch.items()})
        return jax_objectives.flownet_s_loss(params, batch)

    net = our_net(chain["params"])
    loss, _ = our_loss(capture)(net, step_batch(chain, 0, jax_side=False))
    loss.backward()
    grads = params_from_state_dict({k: p.grad for k, p in net.named_parameters()})
    their_loss(jax_capture)(unflatten_params(chain["params"]), step_batch(chain, 0, jax_side=True))
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(their_loss(), has_aux=True))(
        unflatten_params(chain["params"]), step_batch(chain, 0, jax_side=True))

    flow, ref_flow = seen["flow"].numpy(), jax_seen["flow"]
    ref_grads = flatten_params(ref_grads)
    print(f"step 1: images max abs {max(np.abs(seen[k].numpy() - jax_seen[k]).max() for k in ('img0', 'img1')):.3g} "
          f"on 0-255, flow NaN values {int(np.isnan(ref_flow).sum())}, loss rel "
          f"{abs(loss.item() - float(ref_loss)) / abs(float(ref_loss)):.3g}, gradients relative L2 "
          f"{rel_l2(grads, ref_grads):.3g} (median tensor {median_rel_l2(grads, ref_grads):.3g})")
    for k in ("img0", "img1"):
        assert seen[k].shape == (BATCH, CROP_H, CROP_W, 3)
        np.testing.assert_allclose(seen[k].numpy(), jax_seen[k], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(np.isnan(flow), np.isnan(ref_flow))
    assert np.isnan(flow).any()
    np.testing.assert_array_equal(flow[~np.isnan(flow)], ref_flow[~np.isnan(ref_flow)])

    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    assert sorted(grads) == sorted(ref_grads)
    assert rel_l2(grads, ref_grads) <= 1e-3
    assert median_rel_l2(grads, ref_grads) <= 1e-3


@pytest.mark.parametrize("solver_type,update_tol", [("adam", 2e-2), ("sgd", 1e-3)])
def test_three_chained_steps_match_jax(chain, solver_type, update_tol):
    params = chain["params"]
    tx = jax_make_solver(JaxSolverConfig(solver_type=solver_type, **CONFIG))
    start = unflatten_params(params)
    state = TrainState(params=start, opt_state=tx.init(start), iteration=jnp.zeros([], jnp.int32))
    state, ref_losses = jax_multistep(their_loss(), tx)(
        state, chain["jax_slabs"], {k: jnp.asarray(v) for k, v in chain["bank"].items()})
    ref_update = {k: v - params[k] for k, v in flatten_params(state.params).items()}

    net = our_net(params)
    optimizer = make_solver(SolverConfig(solver_type=solver_type, **CONFIG), list(net.parameters()))
    losses = make_multistep_train_step(our_loss(), optimizer)(net, chain["slabs"], chain["bank"])
    update = {k: v - params[k] for k, v in params_from_state_dict(net.state_dict()).items()}

    print(f"{solver_type}: losses rel {', '.join(f'{v:.3g}' for v in np.abs(losses.numpy() / ref_losses - 1))}, "
          f"update relative L2 {rel_l2(update, ref_update):.3g}")
    assert losses.shape == (STEPS,)
    np.testing.assert_allclose(losses[0].item(), float(ref_losses[0]), rtol=1e-4)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=1e-3)
    assert rel_l2(update, ref_update) <= update_tol
