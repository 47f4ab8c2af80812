"""The port's training stack against the JAX package, on the CPU: losses and
the NaN-aware downsample, LR policies, the six solvers, the weight files,
the data loader, the Solver and the train CLI.

Inputs are numpy arrays from a seed, handed to both packages. The port's
ops take NCHW, the JAX ops NHWC; the tests permute at the boundary.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flownet2_tpu.checkpoint import flatten_params as jax_flatten, load_params as jax_load_params
from flownet2_tpu.checkpoint import unflatten_params
from flownet2_tpu.data import BatchLoader as JaxBatchLoader, FlyingChairs as JaxFlyingChairs
from flownet2_tpu.ops import downsample as jax_downsample, losses as jax_losses
from flownet2_tpu.train import objectives as jax_objectives
from flownet2_tpu.train.lr_policies import lr_policy as jax_lr_policy
from flownet2_tpu.train.solver import Solver as JaxSolver
from flownet2_tpu.train.solvers import SolverConfig as JaxSolverConfig, make_solver as jax_make_solver
from flownet2_tpu_torch.checkpoint import init_params, load_into, params_from_state_dict, save_params
from flownet2_tpu_torch.cli.train import main as train_main
from flownet2_tpu_torch.core.flow_io import write_flo, write_ppm
from flownet2_tpu_torch.data import BatchLoader, FlyingChairs, open_dataset
from flownet2_tpu_torch.models import FlowNetC
from flownet2_tpu_torch.ops import downsample, losses
from flownet2_tpu_torch.train import Solver, SolverConfig, lr_policy, make_solver
from flownet2_tpu_torch.train.lr_policies import FLOWNET_SCHEDULES, flownet_schedule
from flownet2_tpu_torch.train.objectives import flownet_c_loss, with_compute_dtype

torch.set_num_threads(2)  # the suite runs several workers side by side

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _flows(rng, shape=(2, 16, 20, 2), nan_frac=0.1):
    """A prediction and a ground truth with NaN pixels, and a few |diff| under 0.3."""
    pred = rng.normal(0, 2, shape).astype(np.float32)
    gt = rng.normal(0, 2, shape).astype(np.float32)
    gt[rng.random(shape[:3]) < nan_frac] = np.nan
    gt[:, :2, :3] = pred[:, :2, :3] + 0.1
    return pred, gt


# -- losses and downsample (rtol 1e-6: float32 sums in another order) ------------------


L1_FLAGS = [
    dict(),
    dict(l2_per_location=True),
    dict(l2_per_location=True, l2_prescale_by_channels=True, normalize_by_num_entries=True),
    dict(l2_per_location=True, plateau=0.5, epsilon=1e-3),
    dict(plateau=0.3, normalize_by_num_entries=True),
]


@pytest.mark.parametrize("flags", L1_FLAGS, ids=lambda f: "-".join(f) or "plain")
@pytest.mark.parametrize("with_target", [True, False])
def test_l1_loss_matches_jax(rng, flags, with_target):
    pred, gt = _flows(rng)
    target = gt if with_target else None
    got = losses.l1_loss(nchw(pred), None if target is None else nchw(target), **flags)
    ref = jax_losses.l1_loss(jnp.asarray(pred), None if target is None else jnp.asarray(target), **flags)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def test_l1_loss_gradient_matches_jax(rng):
    """NaN pixels pass no gradient; the EPE's gradient equals jax.grad's."""
    pred, gt = _flows(rng)
    p = nchw(pred).requires_grad_(True)
    losses.l1_loss(p, nchw(gt), l2_per_location=True).backward()
    ref = jax.grad(lambda a: jax_losses.l1_loss(a, jnp.asarray(gt), l2_per_location=True))(jnp.asarray(pred))
    np.testing.assert_allclose(nhwc(p.grad), np.asarray(ref), rtol=1e-6, atol=1e-7)
    assert torch.isfinite(p.grad).all()


@pytest.mark.parametrize("kw", [dict(), dict(p=1.0, q=0.4, p_epsilon=0.01, q_epsilon=1e-3),
                                dict(l2_prescale_by_channels=True, normalize_by_num_entries=True)])
def test_lpq_loss_and_epe_match_jax(rng, kw):
    pred, gt = _flows(rng)
    got = losses.lpq_loss(nchw(pred), nchw(gt), **kw)
    ref = jax_losses.lpq_loss(jnp.asarray(pred), jnp.asarray(gt), **kw)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(losses.epe(nchw(pred), nchw(gt)).item(),
                               float(jax_losses.epe(jnp.asarray(pred), jnp.asarray(gt))), rtol=1e-6)


def test_lpq_schedule_matches_jax():
    kw = dict(start_iters=(0, 10, 25), ps=(2.0, 1.0, 0.5), qs=(0.5, 0.4, 0.3))
    ours, theirs = losses.LpqSchedule(**kw), jax_losses.LpqSchedule(**kw)
    assert [ours.at(i) for i in range(40)] == [theirs.at(i) for i in range(40)]
    with pytest.raises(ValueError):
        losses.LpqSchedule(start_iters=(1,), ps=(2.0,), qs=(0.5,))


@pytest.mark.parametrize("in_hw,out_hw", [((32, 40), (8, 10)), ((17, 23), (5, 7)), ((16, 20), (1, 1)),
                                          ((16, 20), (16, 20))])
def test_downsample_nan_aware_matches_jax(rng, in_hw, out_hw):
    """NaN votes included (a fully-NaN block must come out NaN); identity passes through."""
    x = rng.normal(0, 3, (2, *in_hw, 2)).astype(np.float32)
    x[rng.random(x.shape[:3]) < 0.3] = np.nan
    x[0, :8, :8] = np.nan
    got = nhwc(downsample.downsample_nan_aware(nchw(x), *out_hw))
    ref = np.asarray(jax_downsample.downsample_nan_aware(jnp.asarray(x), *out_hw))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    if in_hw == out_hw:
        t = nchw(x)
        assert downsample.downsample_nan_aware(t, *out_hw) is t


@pytest.mark.parametrize("normalize", [False, True])
def test_multiscale_l1_loss_matches_jax(rng, normalize):
    gt = rng.normal(0, 3, (2, 16, 32, 2)).astype(np.float32)
    gt[:, 3:9, 5:20] = np.nan
    flows = {f"flow{k}": rng.normal(0, 3, (2, 16 >> k, 32 >> k, 2)).astype(np.float32) for k in range(1, 5)}
    weights = {"flow1": 0.5, "flow2": 0.25, "flow3": 0.0, "flow4": 1.0}
    got, got_scales = losses.multiscale_l1_loss({k: nchw(v) for k, v in flows.items()}, nchw(gt), weights,
                                                normalize=normalize)
    ref, ref_scales = jax_losses.multiscale_l1_loss({k: jnp.asarray(v) for k, v in flows.items()},
                                                    jnp.asarray(gt), weights, normalize=normalize)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    assert set(got_scales) == set(ref_scales) == {"flow1", "flow2", "flow4"}
    for k in ref_scales:
        np.testing.assert_allclose(got_scales[k].item(), float(ref_scales[k]), rtol=1e-6)
    default, _ = losses.multiscale_l1_loss({k: nchw(v) for k, v in flows.items()}, nchw(gt))
    np.testing.assert_allclose(default.item(), float(jax_losses.multiscale_l1_loss(
        {k: jnp.asarray(v) for k, v in flows.items()}, jnp.asarray(gt))[0]), rtol=1e-6)


# -- LR policies and solvers -------------------------------------------------------------


LR_CASES = [
    ("fixed", {}),
    ("step", dict(gamma=0.5, stepsize=7)),
    ("exp", dict(gamma=0.9999)),
    ("inv", dict(gamma=1e-3, power=0.75)),
    ("multistep", dict(gamma=0.5, stepvalues=(3, 10, 400_000))),
    ("poly", dict(power=0.9, max_iter=500_000)),
    ("sigmoid", dict(gamma=-1e-3, stepsize=5000)),
]


@pytest.mark.parametrize("policy,kw", LR_CASES, ids=[c[0] for c in LR_CASES])
def test_lr_policy_matches_jax(policy, kw):
    """Both compute in float32: equal to rtol 1e-7."""
    ours, theirs = lr_policy(policy, 1e-4, **kw), jax_lr_policy(policy, 1e-4, **kw)
    for it in (0, 1, 2, 3, 6, 7, 9, 10, 99, 1000, 12345, 399_999, 400_000, 499_999):
        np.testing.assert_allclose(ours(it), float(theirs(jnp.asarray(it, jnp.int32))), rtol=1e-7)


def test_flownet_schedules_and_bad_policy():
    sched, max_iter = flownet_schedule("S_long")
    assert max_iter == 1_200_000 and FLOWNET_SCHEDULES["S_long"]["base_lr"] == 1e-4
    assert [sched(i) for i in (0, 399_999, 400_000, 1_000_000)] == pytest.approx([1e-4, 1e-4, 5e-5, 6.25e-6])
    with pytest.raises(ValueError):
        lr_policy("cosine", 1e-4)
    with pytest.raises(ValueError):
        lr_policy("poly", 1e-4)


@pytest.mark.parametrize("wd,clip", [(0.0, -1.0), (0.01, 1.5)], ids=["plain", "decay-clip"])
@pytest.mark.parametrize("rule", ["sgd", "nesterov", "adagrad", "rmsprop", "adadelta", "adam"])
def test_solver_rule_matches_optax_chain(rule, wd, clip):
    """5 steps under a multistep schedule that halves the LR at steps 2 and 4,
    on the same gradients: rtol 1e-6 of each tensor's scale."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    steps = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(5)]
    kw = dict(solver_type=rule, base_lr=0.1, lr_policy="multistep", gamma=0.5, stepvalues=(2, 4),
              weight_decay=wd, clip_gradients=clip)
    tx = jax_make_solver(JaxSolverConfig(**kw))
    ref = [jnp.asarray(p) for p in p0]
    state = tx.init(ref)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = make_solver(SolverConfig(**kw), params)
    for grads in steps:
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, ref)
        ref = optax.apply_updates(ref, updates)
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
    for p, r in zip(params, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(p.detach().numpy(), r, rtol=1e-6, atol=1e-6 * np.abs(r).max())


def test_sgd_applies_lr_before_momentum():
    """Caffe's v = m*v + lr*g differs from torch.optim.SGD's v = m*v + g,
    w -= lr*v once the LR changes: the port follows Caffe."""
    p = torch.nn.Parameter(torch.zeros(1))
    opt = make_solver(SolverConfig(solver_type="sgd", base_lr=1.0, lr_policy="multistep", gamma=0.5,
                                   stepvalues=(1,), momentum=0.9), [p])
    for _ in range(2):
        p.grad = torch.ones(1)
        opt.step()
    # step 1: v = 1, w = -1; step 2: v = 0.9 + 0.5 = 1.4, w = -2.4 (torch.optim.SGD: -2.45)
    np.testing.assert_allclose(p.item(), -2.4, rtol=1e-6)
    with pytest.raises(ValueError):
        make_solver(SolverConfig(solver_type="lamb"), [p])


# -- weight files ------------------------------------------------------------------------


def test_params_from_state_dict_round_trips(tmp_path):
    """init_params -> net -> params_from_state_dict is the identity, and the
    port's .npz is what flownet2_tpu.checkpoint.load_params reads."""
    flat = init_params("flownetc", seed=5)
    with torch.device("meta"):
        net = FlowNetC()
    load_into(net, flat)
    back = params_from_state_dict(net.state_dict())
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    path = str(tmp_path / "w.npz")
    save_params(path, back)
    loaded = jax_flatten(jax_load_params(path))
    assert loaded.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(np.asarray(loaded[k]), flat[k])
    with pytest.raises(ValueError):
        params_from_state_dict({"bn.running_mean": torch.zeros(3)})


# -- data --------------------------------------------------------------------------------


def _write_chairs(root, n=6, h=40, w=60, official=False, seed=0):
    rng = np.random.default_rng(seed)
    names = ("{:05d}_img1.ppm", "{:05d}_img2.ppm", "{:05d}_flow.flo") if official else (
        "{:07d}-img0.ppm", "{:07d}-img1.ppm", "{:07d}-gt.flo")
    for i in range(n):
        write_ppm(os.path.join(root, names[0].format(i)), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        write_ppm(os.path.join(root, names[1].format(i)), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        write_flo(os.path.join(root, names[2].format(i)), rng.normal(0, 3, (h, w, 2)).astype(np.float32))


@pytest.mark.parametrize("official", [False, True], ids=["examples-layout", "official-layout"])
def test_batch_loader_matches_jax(tmp_path, official):
    """One worker thread: the same batches, in the same seeded order, across an epoch boundary."""
    _write_chairs(str(tmp_path), official=official)
    ds, jds = FlyingChairs(str(tmp_path)), JaxFlyingChairs(str(tmp_path))
    assert len(ds) == len(jds) == 6
    np.testing.assert_array_equal(ds.permutation(4, block_size=2), jds.permutation(4, block_size=2))
    kw = dict(crop=(32, 48), shuffle_seed=3, num_threads=1)
    ours, theirs = iter(BatchLoader(ds, 2, **kw)), iter(JaxBatchLoader(jds, 2, **kw))
    for _ in range(5):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys() == {"img0", "img1", "flow"}
        for k in a:
            assert a[k].shape[:3] == (2, 32, 48) and a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])


def test_sintel_layout_matches_jax(tmp_path):
    """PNG frames (through PIL) and .flo ground truth: the same samples, loaded alike."""
    from PIL import Image

    from flownet2_tpu.data.datasets import Sintel as JaxSintel

    rng = np.random.default_rng(8)
    for scene in ("alley_1", "bamboo_2"):
        os.makedirs(tmp_path / "training" / "clean" / scene)
        os.makedirs(tmp_path / "training" / "flow" / scene)
        for k in range(1, 4):
            Image.fromarray(rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)).save(
                tmp_path / "training" / "clean" / scene / f"frame_{k:04d}.png")
            if k < 3:  # the last frame has no successor, so no ground truth
                write_flo(tmp_path / "training" / "flow" / scene / f"frame_{k:04d}.flo",
                          rng.normal(0, 2, (12, 20, 2)).astype(np.float32))
    ours, theirs = open_dataset("sintel", str(tmp_path)), JaxSintel(str(tmp_path))
    assert len(ours) == len(theirs) == 4
    for i in range(4):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_dataset_subsets_and_errors(tmp_path):
    _write_chairs(str(tmp_path), n=4)
    ds = open_dataset("flyingchairs", str(tmp_path))
    assert len(ds.subset_range(1, 2)) == 2
    np.testing.assert_array_equal(ds.permutation(None), np.arange(4))
    with pytest.raises(ValueError, match="unknown dataset 'middlebury'"):
        open_dataset("middlebury", str(tmp_path))
    with pytest.raises(ValueError, match="empty"):
        FlyingChairs(str(tmp_path / "nothing"))
    with pytest.raises(ValueError, match="smaller than crop"):
        next(iter(BatchLoader(ds, 1, crop=(64, 64), num_threads=1)))


# -- the Solver ----------------------------------------------------------------------------


def _smooth_batch(rng, n, h=64, w=128):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(0.01, 0.05, (n, 1, 1, 3))
    img0 = 127.5 + 60 * np.sin(xs[None, ..., None] * f + ys[None, ..., None] * f[..., ::-1])
    img1 = np.roll(img0, 2, axis=2)
    flow = np.zeros((n, h, w, 2), np.float32)
    flow[..., 0] = -2.0
    return {"img0": img0.astype(np.float32), "img1": img1.astype(np.float32), "flow": flow}


def test_solver_adam_iter_size_matches_jax_solver():
    """3 Adam steps of the FlowNetC loss with iter_size=2 (two micro-batches of
    one pair): each parameter tensor's update agrees with the JAX Solver's
    to 1e-3 relative L2."""
    rng = np.random.default_rng(2)
    batches = [{k: v.reshape(2, 1, *v.shape[1:]) for k, v in _smooth_batch(rng, 2).items()} for _ in range(3)]
    flat = init_params("flownetc", seed=6)
    kw = dict(solver_type="adam", base_lr=1e-3, lr_policy="fixed", momentum=0.9, momentum2=0.999, iter_size=2)
    ref = JaxSolver(JaxSolverConfig(**kw), jax_objectives.flownet_c_loss, unflatten_params(flat))
    with torch.device("meta"):
        net = FlowNetC()
    solver = Solver(SolverConfig(**kw), flownet_c_loss, load_into(net, flat), device="cpu")
    for b in batches:
        ref_loss, _ = ref.step({k: jnp.asarray(v) for k, v in b.items()})
        loss, _ = solver.step(b)
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    assert solver.iteration == 3
    got = params_from_state_dict(solver.net.state_dict())
    want = jax_flatten(ref.state.params)
    for k in flat:
        moved = np.asarray(want[k]) - flat[k]
        err = np.linalg.norm((got[k] - flat[k]) - moved) / np.linalg.norm(moved)
        assert err <= 1e-3, f"{k}: update differs by {err:.3g} relative L2"


def test_with_compute_dtype_runs_bf16_over_float32_master_weights():
    """The net runs in bf16 on a cast copy of the weights; every gradient
    lands in the float32 parameters, finite, and points the way the float32
    gradient does (bf16 against f32 under random weights is no closer)."""
    batch = {k: torch.from_numpy(v) for k, v in _smooth_batch(np.random.default_rng(6), 1).items()}
    grads = {}
    for dtype in (None, torch.bfloat16):
        with torch.device("meta"):
            net = FlowNetC()
        load_into(net, init_params("flownetc", seed=2))
        loss, aux = with_compute_dtype(flownet_c_loss, dtype)(net, batch)
        assert loss.dtype == torch.float32 and torch.isfinite(loss) and set(aux) >= {"loss", "flow2", "flow6"}
        loss.backward()
        assert all(p.dtype == torch.float32 for p in net.parameters())
        grads[dtype] = torch.cat([p.grad.flatten() for p in net.parameters()])
    assert torch.isfinite(grads[torch.bfloat16]).all()
    assert torch.nn.functional.cosine_similarity(grads[None], grads[torch.bfloat16], dim=0) > 0.9


def test_with_compute_dtype_takes_uint8_transport_images():
    """A transport batch (uint8 images, int16 flow) trains in bf16 to the
    loss of its float form: 0-255 is exact in bf16, so both cast to the same
    images (uint8 images reached the bf16 convolution as float32 before)."""
    from flownet2_tpu_torch.core.codec import encode_flow_int16

    batch = _smooth_batch(np.random.default_rng(8), 1)
    batch = {"img0": np.round(batch["img0"]), "img1": np.round(batch["img1"]),
             "flow": np.round(batch["flow"] * 32) / 32}
    transport = {"img0": batch["img0"].astype(np.uint8), "img1": batch["img1"].astype(np.uint8),
                 "flow": encode_flow_int16(batch["flow"])}
    with torch.device("meta"):
        net = FlowNetC()
    load_into(net, init_params("flownetc", seed=2))
    loss_fn = with_compute_dtype(flownet_c_loss, torch.bfloat16)
    with torch.no_grad():
        losses = [loss_fn(net, {k: torch.from_numpy(v) for k, v in b.items()})[0].item() for b in (batch, transport)]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


def test_solver_snapshot_restore_gives_the_same_next_step(tmp_path):
    rng = np.random.default_rng(4)
    batches = [_smooth_batch(rng, 1) for _ in range(3)]
    flat = init_params("flownetc", seed=7)
    config = SolverConfig(solver_type="adam", base_lr=1e-3, lr_policy="multistep", gamma=0.5, stepvalues=(2,))

    def fresh(seed):
        with torch.device("meta"):
            net = FlowNetC()
        return Solver(config, flownet_c_loss, load_into(net, init_params("flownetc", seed=seed)), device="cpu",
                      snapshot_dir=str(tmp_path))

    class Counter:  # host-side state that rides along with the snapshot
        def __init__(self):
            self.n = np.zeros(2)

        def state_dict(self):
            return {"n": self.n}

        def load_state_dict(self, sd):
            self.n = sd["n"]

    first = fresh(7)
    first.copy_weights_from(flat)
    extra = Counter()
    extra.n += [3, 4]
    first.register_extra("counter", extra)
    for b in batches[:2]:
        first.step(b)
    prefix = first.snapshot()
    assert os.path.exists(prefix + ".npz") and os.path.exists(prefix + ".pt")
    assert jax_flatten(jax_load_params(prefix + ".npz")).keys() == flat.keys()  # the JAX package reads it
    first.step(batches[2])

    second = fresh(8)  # other weights: the restore must overwrite them
    second.register_extra("counter", Counter())
    second.restore(prefix + ".npz")
    assert second.iteration == 2
    np.testing.assert_array_equal(second._extras["counter"].n, [3, 4])
    second.step(batches[2])
    a, b = first.net.state_dict(), second.net.state_dict()
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=1e-6, atol=1e-9, err_msg=k)


def test_solver_solve_displays_snapshots_and_stops_on_signal(tmp_path):
    rng = np.random.default_rng(5)
    batch = _smooth_batch(rng, 1)
    with torch.device("meta"):
        net = FlowNetC()
    solver = Solver(SolverConfig(solver_type="sgd", base_lr=1e-6, max_iter=3), flownet_c_loss,
                    load_into(net, init_params("flownetc", seed=1)), device="cpu",
                    snapshot_dir=str(tmp_path), snapshot_interval=2, display=1)
    logs = []
    solver.solve(iter([batch] * 3), log=logs.append)
    assert solver.iteration == 3 and len(solver.history) == 3 and np.isfinite(solver.smoothed_loss)
    assert sorted(os.listdir(tmp_path)) == ["iter_0000002.npz", "iter_0000002.pt", "iter_0000003.npz",
                                            "iter_0000003.pt"]
    solver._requested_action = "stop"
    solver.solve(iter([batch] * 3), max_iter=10, log=logs.append)
    assert solver.iteration == 4 and "Stopping early" in logs[-1]
    with pytest.raises(ValueError):
        solver.copy_weights_from({"conv1": {"w": np.zeros((1, 1, 1, 1), np.float32)}}, strict=True)


# -- the CLI -------------------------------------------------------------------------------


def test_train_cli_runs_snapshots_and_resumes(tmp_path, capsys):
    data, snaps = tmp_path / "chairs", tmp_path / "snaps"
    data.mkdir()
    _write_chairs(str(data), n=4, h=70, w=140)
    args = ["--model", "flownetc", "--dataset", "flyingchairs", "--data-root", str(data), "--no-augment",
            "--batch", "2", "--crop", "64x128", "--snapshot-dir", str(snaps), "--device", "cpu", "--display", "1"]
    assert train_main(args + ["--max-iter", "2"]) == 0
    assert (snaps / "iter_0000002.npz").exists() and (snaps / "iter_0000002.pt").exists()
    assert train_main(args + ["--max-iter", "3", "--snapshot", str(snaps / "iter_0000002")]) == 0
    out = capsys.readouterr().out
    assert "Iteration 3, loss" in out and "Iteration 1," in out
    assert (snaps / "iter_0000003.npz").exists()


@pytest.mark.parametrize("model", ["flownetc", "flownet2-sd-sdhom"])
def test_train_cli_augments_by_default(tmp_path, capsys, model):
    """Without --no-augment: batches at source size (80x160), crops of 64x128
    made by the objective; the sdhom loss trains FlowNet2-SD."""
    data = tmp_path / "chairs"
    data.mkdir()
    _write_chairs(str(data), n=4, h=80, w=160)
    net = ["--model", "flownetc"] if model == "flownetc" else ["--model", "flownet2-sd", "--loss", model]
    assert train_main([*net, "--data-root", str(data), "--batch", "2", "--crop", "64x128", "--max-iter", "2",
                       "--snapshot-dir", "", "--device", "cpu", "--display", "1"]) == 0
    out = capsys.readouterr().out
    assert "crop 64x128, batch 2 x iter_size 1, augmented" in out and "Iteration 2, loss" in out
    assert "nan" not in out.split("Iteration 2, loss")[1].split("\n")[0]


def test_train_cli_recompute_mean_and_write_augmented(tmp_path, capsys):
    """--recompute-mean 2 --write-augmented DIR --display 1: each step's
    augmented pair under the JAX names, the two running means as .float3
    (read by the JAX reader) and .ppm, and the means in the snapshot."""
    from flownet2_tpu.tools.writers import read_float_blob as jax_read_float_blob

    data, snaps, aug = tmp_path / "chairs", tmp_path / "snaps", tmp_path / "aug"
    data.mkdir()
    _write_chairs(str(data), n=4, h=80, w=160)
    assert train_main(["--model", "flownetc", "--data-root", str(data), "--batch", "2", "--crop", "64x128",
                       "--max-iter", "2", "--recompute-mean", "2", "--write-augmented", str(aug), "--display", "1",
                       "--snapshot-dir", str(snaps), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("Augmenting 0, affine0: [") == 2 and out.count("Augmenting 1,") == 2
    written = sorted(os.listdir(aug))
    assert written == sorted([f"aug{f}_{i:07d}({n:03d}).ppm" for f in (0, 1) for i in (1, 2) for n in (0, 1)]
                             + ["mean0.float3", "mean0.ppm", "mean1.float3", "mean1.ppm"])
    extras = torch.load(snaps / "iter_0000002.pt", weights_only=True)["extras"]
    for i in (0, 1):
        blob = jax_read_float_blob(str(aug / f"mean{i}.float3"))
        assert blob.shape == (64, 128, 3) and 0 < blob.mean() < 1
        np.testing.assert_array_equal(extras[f"mean{i}"]["mean"].numpy(), blob)
        assert int(extras[f"mean{i}"]["num_iter"]) == 2


@pytest.mark.parametrize("extra,cards,message", [
    # the augmentation's ground-truth transform takes 2-channel flow, in the JAX package too
    (["--model", "dispnetc"], None, "1-channel disparity, which the augmentation cannot transform"),
    # --gpu: no card at all, a card past those present, a duplicate; never the CPU
    (["--no-augment", "--gpu", "all"], 0, "no CUDA device"),
    (["--no-augment", "--gpu", "0,1"], 1, r"card 1 not available \(1 present\)"),
    (["--gpu", "0,0"], 2, "duplicate"),  # with augmentation
    # the device cache feeds one card, in the JAX CLI too, and refuses what it refuses
    (["--device-cache", "64", "--gpu", "0,1"], 2, "single-device"),
    (["--device-cache", "64", "--write-augmented", "aug"], None, "--write-augmented"),
    (["--device-cache", "64", "--recompute-mean", "2"], None, "--steps-per-dispatch 1"),  # K 32 by default
    # K > 1 without the cache: the JAX CLI ignores it
    (["--no-augment", "--steps-per-dispatch", "4"], None, "pass --device-cache"),
    (["--recompute-mean", "2", "--iter-size", "2"], None, "--iter-size"),
    (["--no-augment", "--device", "cpu", "--loss", "flownet2-s1"], None, "does not train"),
    # DispNetC trains from packed disparity records, not from a flow layout
    (["--no-augment", "--device", "cpu", "--model", "dispnetc"], None, "disparity"),
])
def test_train_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, extra, cards, message):
    """Refusals of what the port does not do, or the JAX package cannot do
    or refuses.
    ``cards``: the number of cards the CLI is told are present."""
    if cards is not None:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(SystemExit, match=message):
        train_main(["--model", "flownetc", "--data-root", str(tmp_path), *extra])


_NO_JAX = """
import importlib.abc, sys

BLOCKED = ("jax", "flownet2_tpu")

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if blocked(name):
            raise ImportError(f"{name} is blocked in this process")

sys.meta_path.insert(0, BlockJax())
import flownet2_tpu_torch.train, flownet2_tpu_torch.train.objectives, flownet2_tpu_torch.data
import flownet2_tpu_torch.cli.train, flownet2_tpu_torch.ops.losses
import flownet2_tpu_torch.data.augment_pipeline, flownet2_tpu_torch.data.aug_params, flownet2_tpu_torch.data.mean
import flownet2_tpu_torch.ops.augment, flownet2_tpu_torch.ops.mean, flownet2_tpu_torch.tools.writers
import flownet2_tpu_torch.parallel, flownet2_tpu_torch.tools.diag.bf16_parity
import flownet2_tpu_torch.data.device_cache, flownet2_tpu_torch.core.hostmem
assert not [m for m in sys.modules if blocked(m)]
print("imported without jax")
"""


def test_training_stack_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported without jax" in proc.stdout
