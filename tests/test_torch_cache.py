"""The port's device sample cache and K-step training against the JAX package,
on the CPU (``device="cpu"``): ``data/device_cache.py``,
``train/solver.make_multistep_train_step`` and ``Solver.solve_cached``,
``core/hostmem.py`` and ``cli.train --device-cache``.

Tolerances: the host-side draws (indices, ``aug_*`` arrays, which slab)
equal from one seed; a gathered loss equal to the direct loss (rtol 1e-6:
the same arrays through the same code); K steps from one bank against K
single steps and against the JAX package's K-step program on the same toy
slabs and bank, parameters 1e-6. The card's side of the cache (pinned
uploads on a stream of its own, the swap under in-flight steps) is held by
``chip_smoke.py`` [cache]."""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from flownet2_tpu.data import augment_pipeline as jax_pipeline
from flownet2_tpu.data import device_cache as jax_cache
from flownet2_tpu.train.solver import TrainState
from flownet2_tpu.train.solver import make_multistep_train_step as jax_multistep
from flownet2_tpu.train.solvers import SolverConfig as JaxSolverConfig
from flownet2_tpu.train.solvers import make_solver as jax_make_solver
from flownet2_tpu_torch.checkpoint import init_params, load_into
from flownet2_tpu_torch.cli.train import main as train_main
from flownet2_tpu_torch.core.codec import encode_flow_int16
from flownet2_tpu_torch.core.hostmem import tune_host_allocator
from flownet2_tpu_torch.data import FlowRecordReader, FlowRecordWriter, augment_pipeline
from flownet2_tpu_torch.data.device_cache import (
    CacheBatches,
    CacheChunks,
    DeviceSampleCache,
    cycle_dataset,
    make_cache_gather_loss,
)
from flownet2_tpu_torch.models import FlowNetS
from flownet2_tpu_torch.parallel.mesh import Group
from flownet2_tpu_torch.train import Solver, SolverConfig, make_solver, make_train_step, objectives
from flownet2_tpu_torch.train.solver import make_multistep_train_step, upload_bank

torch.set_num_threads(2)  # the suite runs several workers side by side

SRC_H, SRC_W, CROP_H, CROP_W = 96, 128, 64, 64  # the smallest crop FlowNetS takes


def transport_samples(n: int, seed: int = 0, h: int = SRC_H, w: int = SRC_W) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"img0": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
             "img1": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
             "flow": encode_flow_int16(rng.normal(0, 3, (h, w, 2)).astype(np.float32))} for _ in range(n)]


def ours_and_theirs(items, slab=4, n_slabs=3):
    """The port's cache on the CPU and the JAX package's, filled from the
    same samples, without refresh."""
    ours = DeviceSampleCache(iter(items), slab_samples=slab, n_slabs=n_slabs, refresh=False, device="cpu")
    theirs = jax_cache.DeviceSampleCache(iter(items), slab_samples=slab, n_slabs=n_slabs, refresh=False,
                                         device=jax.devices("cpu")[0])
    return ours, theirs


def samplers():
    def ours(rng, n):
        return augment_pipeline.sample_aug_arrays(augment_pipeline.FlowNetAugConfig(), rng, n, SRC_H, SRC_W,
                                                  CROP_H, CROP_W)

    def theirs(rng, n):
        return jax_pipeline.sample_aug_arrays(jax_pipeline.FlowNetAugConfig(), rng, n, SRC_H, SRC_W, CROP_H, CROP_W)

    return ours, theirs


# -- host-side draws ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [3, 6], ids=["without replacement", "with replacement"])
def test_cache_batches_draw_the_jax_modules_arrays(batch):
    ours, theirs = ours_and_theirs(transport_samples(12))
    ours_aug, theirs_aug = samplers()
    got = iter(CacheBatches(ours, batch, seed=5, aug_sampler=ours_aug))
    ref = iter(jax_cache.CacheBatches(theirs, batch, seed=5, aug_sampler=theirs_aug))
    for _ in range(4):
        a, b = next(got), next(ref)
        assert sorted(a) == sorted(b)
        for k, v in b.items():
            got_v = a[k].numpy() if isinstance(a[k], torch.Tensor) else a[k]
            np.testing.assert_array_equal(got_v, np.asarray(v))
            assert got_v.dtype == np.asarray(v).dtype, k
    assert ours.samples_drawn == theirs.samples_drawn == 4 * batch


def test_cache_chunks_draw_the_jax_modules_banks():
    ours, theirs = ours_and_theirs(transport_samples(12))
    ours_aug, theirs_aug = samplers()
    got = iter(CacheChunks(ours, 2, 5, seed=7, aug_sampler=ours_aug))
    ref = iter(jax_cache.CacheChunks(theirs, 2, 5, seed=7, aug_sampler=theirs_aug))
    for _ in range(3):
        (slabs, bank), (ref_slabs, ref_bank) = next(got), next(ref)
        assert isinstance(slabs, tuple) and len(slabs) == len(ref_slabs) == 3
        for s, r in zip(slabs, ref_slabs):
            for k in r:
                np.testing.assert_array_equal(s[k].numpy(), np.asarray(r[k]))
        assert sorted(bank) == sorted(ref_bank)
        for k, v in ref_bank.items():
            assert bank[k].dtype == v.dtype and bank[k].shape == v.shape, k
            np.testing.assert_array_equal(bank[k], v)
    assert bank["cache_idx"].shape == (5, 2) and bank["aug_mat0"].shape == (5, 2, 6)
    assert 0 <= bank["cache_idx"].min() and bank["cache_idx"].max() < 12
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        CacheChunks(ours, 2, 0)


def test_slabs_keep_the_transport_domain_and_scalar_fields():
    items = [dict(s, label=i) for i, s in enumerate(transport_samples(4))]
    cache = DeviceSampleCache(iter(items), slab_samples=2, n_slabs=2, refresh=False, device="cpu")
    slabs = cache.current_slabs()
    assert slabs[0]["img0"].dtype == torch.uint8 and slabs[0]["flow"].dtype == torch.int16
    assert slabs[0]["img0"].shape == (2, SRC_H, SRC_W, 3)
    assert slabs[1]["label"].tolist() == [2, 3]
    np.testing.assert_array_equal(slabs[1]["flow"][0].numpy(), items[2]["flow"])
    assert cache.stats() == {"slabs_swapped": 0, "samples_uploaded": 4, "bytes_uploaded": 4 * sum(
        np.asarray(v).nbytes for v in items[0].values()), "capacity_samples": 4, "samples_drawn": 0}


# -- the gather ----------------------------------------------------------------------------------


def test_cache_gather_loss_equals_the_direct_loss():
    items = transport_samples(8, seed=3)
    cache = DeviceSampleCache(iter(items), slab_samples=8, n_slabs=1, refresh=False, device="cpu")
    ours_aug, _ = samplers()
    aug = ours_aug(np.random.default_rng(4), 3)
    idx = np.array([6, 1, 6], np.int32)
    slab = cache.current_slabs()[0]
    with torch.device("meta"):
        net = FlowNetS()
    load_into(net, init_params("flownets", seed=1))

    def loss(batch):
        fn = augment_pipeline.make_augmented_loss(objectives.flownet_s_loss, CROP_H, CROP_W, seed=2)
        with torch.no_grad():
            return fn(net, {k: torch.as_tensor(v) for k, v in batch.items()})[0].item()

    gathered = make_cache_gather_loss(
        augment_pipeline.make_augmented_loss(objectives.flownet_s_loss, CROP_H, CROP_W, seed=2))
    with torch.no_grad():
        got = gathered(net, {**{f"cache_{k}": v for k, v in slab.items()}, "cache_idx": idx,
                             **{k: torch.from_numpy(v) for k, v in aug.items()}})[0].item()
    direct = {k: np.stack([items[i][k] for i in idx]) for k in items[0]}
    assert got == pytest.approx(loss({**direct, **aug}), rel=1e-6)


# -- K steps from one bank -------------------------------------------------------------------------


class Toy(nn.Module):
    """A linear model whose parameter a snapshot can name (``fc/w``)."""

    def __init__(self, w: np.ndarray):
        super().__init__()
        self.fc = nn.Module()
        self.fc.weight = nn.Parameter(torch.from_numpy(w.copy()).reshape(1, -1, 1, 1))

    @property
    def w(self) -> np.ndarray:
        return self.fc.weight.detach().reshape(-1).numpy()


def toy_loss(net, batch):
    pred = batch["x"] @ net.fc.weight.reshape(-1)
    return torch.mean((pred - batch["coef"]) ** 2), {}


def jax_toy_loss(params, batch):
    pred = batch["x"] @ params["w"]
    return jnp.mean((pred - batch["coef"]) ** 2), {}


def toy_setup(k=4, batch=3, dim=5, n_slabs=2, slab=6, seed=0):
    rng = np.random.default_rng(seed)
    slabs = [{"x": rng.normal(size=(slab, dim)).astype(np.float32)} for _ in range(n_slabs)]
    bank = {"cache_idx": rng.integers(0, n_slabs * slab, size=(k, batch)).astype(np.int32),
            "coef": rng.normal(size=(k, batch)).astype(np.float32)}
    return slabs, bank, rng.normal(size=(dim,)).astype(np.float32)


def torch_slabs(slabs):
    return tuple({k: torch.from_numpy(v) for k, v in s.items()} for s in slabs)


TOY_CONFIG = dict(base_lr=1e-2, max_iter=100)


@pytest.mark.parametrize("solver_type", ["sgd", "adam"])
def test_multistep_equals_k_single_steps_and_the_jax_program(solver_type):
    k = 4
    slabs, bank, w = toy_setup(k=k)
    config = SolverConfig(solver_type=solver_type, **TOY_CONFIG)
    loss_fn = make_cache_gather_loss(toy_loss)

    net = Toy(w)
    losses = make_multistep_train_step(loss_fn, make_solver(config, list(net.parameters())))(
        net, torch_slabs(slabs), bank)

    single = Toy(w)
    step = make_train_step(loss_fn, make_solver(config, list(single.parameters())))
    merged = torch.cat([torch.from_numpy(s["x"]) for s in slabs])
    single_losses = [step(single, {"cache_x": merged, "cache_idx": torch.from_numpy(bank["cache_idx"][i]),
                                   "coef": torch.from_numpy(bank["coef"][i])})[0].item() for i in range(k)]
    assert losses.shape == (k,)
    np.testing.assert_allclose(losses.numpy(), single_losses, rtol=1e-6, atol=0)
    np.testing.assert_allclose(net.w, single.w, rtol=1e-6, atol=1e-7)

    tx = jax_make_solver(JaxSolverConfig(solver_type=solver_type, **TOY_CONFIG))
    params = {"w": jnp.asarray(w)}
    state = TrainState(params=params, opt_state=tx.init(params), iteration=jnp.zeros([], jnp.int32))
    state, ref_losses = jax_multistep(jax_cache.make_cache_gather_loss(jax_toy_loss), tx)(
        state, tuple({"x": jnp.asarray(s["x"])} for s in slabs), {n: jnp.asarray(v) for n, v in bank.items()})
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(net.w, np.asarray(state.params["w"]), rtol=1e-6, atol=1e-6)


def test_upload_bank_keeps_arrays_on_the_cpu():
    bank = {"cache_idx": np.arange(6, dtype=np.int32).reshape(3, 2),
            "aug_mat0": np.random.default_rng(0).normal(size=(3, 2, 6)).astype(np.float32)}
    rows = upload_bank({k: v[:2] for k, v in bank.items()}, "cpu")
    assert rows["cache_idx"].dtype == torch.int32 and rows["aug_mat0"].shape == (2, 2, 6)
    np.testing.assert_array_equal(rows["aug_mat0"].numpy(), bank["aug_mat0"][:2])


def chunk_stream(slabs, k, batch, seed=0):
    """(slabs, bank) chunks in CacheChunks' layout, from a seed."""
    rng = np.random.default_rng(seed)
    total = sum(s["x"].shape[0] for s in slabs)
    while True:
        yield slabs, {"cache_idx": rng.integers(0, total, size=(k, batch)).astype(np.int32),
                      "coef": rng.normal(size=(k, batch)).astype(np.float32)}


def toy_solver(max_iter, seed=0, solver_type="adam", iter_size=1, **kw):
    w = np.random.default_rng(seed).normal(size=(5,)).astype(np.float32)
    config = SolverConfig(solver_type=solver_type, base_lr=1e-3, max_iter=max_iter, iter_size=iter_size)
    return Solver(config, make_cache_gather_loss(kw.pop("loss", toy_loss)), Toy(w), device="cpu", display=0, **kw)


def test_solve_cached_equals_solve_with_a_partial_last_chunk():
    slabs, _, _ = toy_setup()
    slabs = torch_slabs(slabs)
    k, batch, max_iter = 3, 2, 7  # 3 + 3 + 1
    cached = toy_solver(max_iter)
    cached.solve_cached(chunk_stream(slabs, k, batch), log=lambda m: None)
    assert cached.iteration == max_iter and len(cached._loss_window) == max_iter

    plain = toy_solver(max_iter)
    merged = torch.cat([s["x"] for s in slabs])

    def batches():
        for _, bank in chunk_stream(slabs, k, batch):
            for i in range(k):
                yield {"cache_x": merged, "cache_idx": bank["cache_idx"][i], "coef": bank["coef"][i]}

    plain.solve(batches(), log=lambda m: None)
    assert plain.iteration == max_iter
    np.testing.assert_allclose(cached.net.w, plain.net.w, rtol=1e-6, atol=1e-7)
    assert cached.smoothed_loss == pytest.approx(plain.smoothed_loss, rel=1e-6)


def test_solve_cached_refuses_schedules_iter_size_and_groups():
    slabs = torch_slabs(toy_setup()[0])
    with pytest.raises(ValueError, match="iter_size"):
        toy_solver(4, iter_size=2).solve_cached(chunk_stream(slabs, 2, 2))

    class Schedule:
        def at(self, it):
            return 0

    def loss_with_episode(net, batch, episode=0):
        return toy_loss(net, batch)

    with pytest.raises(ValueError, match="schedule"):
        toy_solver(4, loss=loss_with_episode, loss_schedule=Schedule()).solve_cached(chunk_stream(slabs, 2, 2))
    solver = toy_solver(4)
    solver.group = Group(rank=0, world=2, device=torch.device("cpu"), backend="gloo")  # as a rank would hold
    with pytest.raises(ValueError, match="single-device"):
        solver.solve_cached(chunk_stream(slabs, 2, 2))
    assert solver.iteration == 0


def test_solve_cached_display_test_and_snapshots_at_chunk_boundaries(tmp_path):
    """Chunks of 3 to max_iter 8 end at 3, 6 and 8 (cut): each interval
    boundary acts at the first chunk end at or past it; the last snapshot
    always lands."""
    slabs = torch_slabs(toy_setup()[0])
    logs, tested = [], []
    solver = toy_solver(8, snapshot_dir=str(tmp_path), snapshot_interval=4,
                        test_fn=lambda net: tested.append(1) or 0.5, test_interval=5)
    solver.display = 2
    solver.solve_cached(chunk_stream(slabs, 3, 2), log=logs.append)
    assert solver.iteration == 8
    assert [m.split(",")[0] for m in logs if "loss =" in m] == ["Iteration 3", "Iteration 6", "Iteration 8"]
    assert [m for m in logs if "test metric" in m] == ["Iteration 6, test metric = 0.500000"]
    snaps = sorted(p for p in os.listdir(tmp_path) if p.endswith(".npz"))
    assert snaps == ["iter_0000006.npz", "iter_0000008.npz"]
    restored = toy_solver(8)
    restored.restore(str(tmp_path / "iter_0000008"))
    assert restored.iteration == 8
    np.testing.assert_array_equal(restored.net.w, solver.net.w)


def test_solve_cached_stops_at_the_chunk_boundary_after_a_signal():
    slabs = torch_slabs(toy_setup()[0])
    solver = toy_solver(100)
    logs = []

    def stream():
        for chunk in chunk_stream(slabs, 4, 2):
            solver._requested_action = "stop"  # as the SIGINT handler sets it
            yield chunk

    solver.solve_cached(stream(), log=logs.append)
    assert solver.iteration == 4
    assert logs[-1] == "Stopping early at iteration 4 (signal)."


# -- fill, refresh, stats ----------------------------------------------------------------------------


def test_fill_refresh_and_stats_on_a_finite_stream():
    items = [{"x": np.full((2,), i, np.float32)} for i in range(20)]
    cache = DeviceSampleCache(iter(items), slab_samples=4, n_slabs=2, device="cpu", link_duty=1.0)
    try:
        assert [s["x"][:, 0].tolist() for s in cache.current_slabs()] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        time.sleep(0.3)
        assert cache.slabs_swapped == 0, "the refresh ran without any draws (the echo cap)"
        deadline = time.time() + 30
        while cache._thread.is_alive() and time.time() < deadline:
            cache.note_drawn(4)
            time.sleep(0.02)
        assert not cache._thread.is_alive(), "the refresh did not end with its stream"
        # 20 samples: the fill (8), then 3 slabs swapped in turn; the stream
        # then runs out and the cache keeps its last fill
        assert [s["x"][:, 0].tolist() for s in cache.current_slabs()] == [[16, 17, 18, 19], [12, 13, 14, 15]]
        st = cache.stats()
        assert st["slabs_swapped"] == 3 and st["samples_uploaded"] == 20 and st["capacity_samples"] == 8
        assert st["bytes_uploaded"] == 20 * 8 and st["samples_drawn"] >= 3 * 4
    finally:
        cache.stop()


def test_swaps_never_hand_out_a_half_built_slab():
    """The consumer draws chunks while the refresh swaps unthrottled, the
    interpreter switching threads every microsecond: every slab a chunk
    sees holds one whole run of consecutive ids, and the counters agree."""
    def ids():
        i = 0
        while True:
            yield {"x": np.full((3,), i, np.int64)}
            i += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    cache = DeviceSampleCache(ids(), slab_samples=4, n_slabs=3, device="cpu", min_echo=0, link_duty=1.0)
    try:
        chunks = iter(CacheChunks(cache, 2, 2, seed=0))
        deadline = time.time() + 20
        while cache.slabs_swapped < 50 and time.time() < deadline:
            slabs, bank = next(chunks)
            for s in slabs:
                x = s["x"].numpy()
                assert (x == x[:, :1]).all() and (np.diff(x[:, 0]) == 1).all() and x[0, 0] % 4 == 0
            assert bank["cache_idx"].max() < 12
    finally:
        sys.setswitchinterval(interval)
        cache.stop()
    assert not cache._thread.is_alive()
    assert cache.slabs_swapped >= 50
    assert cache.stats()["samples_uploaded"] == 4 * (3 + cache.slabs_swapped)


def test_refresh_error_reaches_the_consumer():
    def stream():
        for i in range(4):
            yield {"x": np.full((2,), i, np.float32)}
        raise OSError("the disk went away")

    cache = DeviceSampleCache(stream(), slab_samples=2, n_slabs=2, device="cpu", min_echo=0, link_duty=1.0)
    cache.note_drawn(1)  # the echo cap's least draw
    cache._thread.join(30)
    with pytest.raises(RuntimeError, match="refresh thread failed") as info:
        cache.current_slabs()
    assert isinstance(info.value.__cause__, OSError)
    cache.stop()


def test_cycle_dataset_reshuffles_each_epoch(tmp_path):
    path = str(tmp_path / "five.flowrec")
    with FlowRecordWriter(path) as w:
        for s in transport_samples(5, h=8, w=8):
            w.write(s["img0"], s["img1"], np.zeros((8, 8, 2), np.float32))
    ds = FlowRecordReader(path, transport=True)
    stream = cycle_dataset(ds, seed=4)
    ids = [int(next(stream)["img0"][0, 0, 0]) for _ in range(10)]
    firsts = [int(ds[i]["img0"][0, 0, 0]) for i in range(5)]
    assert ids[:5] == [firsts[i] for i in ds.permutation(4)]
    assert ids[5:] == [firsts[i] for i in ds.permutation(5)]


def test_tune_host_allocator_is_idempotent():
    first = tune_host_allocator()
    assert tune_host_allocator() is first
    assert isinstance(first, bool)
    buf = np.ones(1 << 22, np.uint8)  # an allocation above the old mmap threshold still works
    assert int(buf.sum()) == 1 << 22


# -- cli.train -----------------------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [4, 1], ids=["chunks", "batches"])
def test_train_cli_trains_flownets_from_the_device_cache(tmp_path, capsys, steps):
    rec, snaps = str(tmp_path / "train.flowrec"), tmp_path / "snaps"
    rng = np.random.default_rng(9)
    ys, xs = np.mgrid[0:SRC_H, 0:SRC_W].astype(np.float32)
    with FlowRecordWriter(rec) as w:
        for _ in range(24):
            frame = 127.5 + 60 * np.sin(xs[..., None] * rng.uniform(0.05, 0.2, 3) + ys[..., None] * 0.1)
            w.write(frame.astype(np.uint8), np.roll(frame, 2, axis=1).astype(np.uint8),
                    np.full((SRC_H, SRC_W, 2), [2.0, 0.0], np.float32))
    argv = ["--model", "flownets", "--dataset", "flowrec", "--data-root", rec, "--batch", "2", "--crop",
            f"{CROP_H}x{CROP_W}", "--max-iter", "6", "--display", "2", "--snapshot-dir", str(snaps),
            "--snapshot-interval", "4", "--device-cache", "16", "--cache-slab", "8", "--steps-per-dispatch",
            str(steps), "--device", "cpu"]
    assert train_main(argv) == 0
    out = capsys.readouterr().out
    assert "device cache 16 samples" in out and f"{steps} steps a dispatch" in out
    assert "Device cache: " in out and " slab refreshes, " in out and " samples uploaded (" in out
    assert "Optimization done" in out
    shown = [line.split(",")[0] for line in out.splitlines() if line.startswith("Iteration")]
    assert shown == (["Iteration 4", "Iteration 6"] if steps == 4 else ["Iteration 2", "Iteration 4", "Iteration 6"])
    assert (snaps / "iter_0000006.npz").exists() and (snaps / "iter_0000006.pt").exists()
    uploaded = int(out.split(" samples uploaded")[0].rsplit(" ", 1)[1])
    assert uploaded >= 16 and uploaded % 8 == 0
