"""Data-parallel training in the port, on the CPU: 2 ranks over gloo against
the JAX package's 2-device data-parallel ``Solver`` and against one port
process on the same global batch; the keyed loader's rank rows; the
running mean, snapshots and signal actions across ranks; the collectives a
step makes; the train CLI's per-rank body; the bf16 parity tool against the
JAX tool.

The rank processes are started with the ``spawn`` method and import this
module, so its top level imports neither jax nor the JAX package: the tests
that compare with the JAX package import it inside. One spawn runs every
Solver case in both ranks (``_ranks_main``), started by the first comparison,
while this process computes the references; no two spawns run at once. Every
join has a timeout and every process group a finite one.
"""

import collections
import contextlib
import functools
import hashlib
import os
import signal
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from flownet2_tpu_torch.checkpoint import init_params, load_into, params_from_state_dict, save_params
from flownet2_tpu_torch.core.flow_io import write_flo, write_ppm
from flownet2_tpu_torch.data import BatchLoader, FlyingChairs
from flownet2_tpu_torch.data.augment_pipeline import (
    BATCH_MEAN_KEYS,
    MEAN_KEYS,
    FlowNetAugConfig,
    make_augmented_loss,
    make_flownet_augmenter,
)
from flownet2_tpu_torch.data.mean import MeanRecompute
from flownet2_tpu_torch.models import FlowNet2, FlowNetC
from flownet2_tpu_torch.ops.augment import EffectAugSpec
from flownet2_tpu_torch.parallel import RankFailed, pick_devices, rank_rows, spawn
from flownet2_tpu_torch.train import Solver, SolverConfig
from flownet2_tpu_torch.train.objectives import LOSSES, flownet_c_loss, trainable_module, with_compute_dtype

torch.set_num_threads(2)  # the suite runs several workers side by side

GLOBAL, H, W = 4, 64, 128
ADAM = dict(solver_type="adam", base_lr=1e-3, lr_policy="fixed", momentum=0.9, momentum2=0.999)
PG_TIMEOUT = timedelta(seconds=60)  # a lost rank fails the collective instead of hanging
JOIN_TIMEOUT = 120.0
# _ranks_main's spawn (every Solver case, the snapshot and the signal) took
# up to 115 s of its join under the whole suite's load on an 8-core host
RANKS_JOIN_TIMEOUT = 240.0
# Solver cases in both ranks against one process: name -> (loss, iter_size, steps)
CASES = {"plain": ("flownetc", 1, 2), "iter_size2": ("flownetc", 2, 1), "s1": ("flownet2-s1", 1, 1),
         "bf16": ("flownetc", 1, 1)}
NOISELESS = FlowNetAugConfig(effect=EffectAugSpec())
COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor", "reduce_scatter",
               "reduce_scatter_tensor", "reduce", "gather", "scatter", "all_to_all", "barrier", "all_gather_object",
               "gather_object", "broadcast_object_list")


def smooth_batch(seed: int, n: int = GLOBAL, h: int = H, w: int = W) -> dict:
    """Smooth frames shifted by 2 px: on noise frames the warp's and the
    random net's kinks make float32 implementations disagree."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(0.01, 0.05, (n, 1, 1, 3))
    img0 = 127.5 + 60 * np.sin(xs[None, ..., None] * f + ys[None, ..., None] * f[..., ::-1])
    flow = np.zeros((n, h, w, 2), np.float32)
    flow[..., 0] = -2.0
    return {"img0": img0.astype(np.float32), "img1": np.roll(img0, 2, axis=2).astype(np.float32), "flow": flow}


def case_batches(name: str) -> list[dict]:
    """The global batches of a case: (iter_size, GLOBAL, ...) with a micro-batch axis."""
    _, iter_size, steps = CASES[name]
    out = []
    for i in range(steps):
        micro = [smooth_batch(100 * i + j) for j in range(iter_size)]
        out.append(micro[0] if iter_size == 1 else {k: np.stack([m[k] for m in micro]) for k in micro[0]})
    return out


def make_solver(loss_key: str, group=None, *, iter_size: int = 1, seed: int = 6, loss_fn=None, **kw) -> Solver:
    model = "flownet2" if loss_key.startswith("flownet2-") else "flownetc"
    with torch.device("meta"):
        net = FlowNet2() if model == "flownet2" else FlowNetC()
    load_into(net, init_params(model, seed=seed))
    return Solver(SolverConfig(**ADAM, iter_size=iter_size), loss_fn or LOSSES[loss_key], net, device="cpu",
                  trainable=trainable_module(net, loss_key), group=group, **kw)


def case_loss(name: str):
    """The bf16 case computes in bfloat16 over float32 master weights."""
    return with_compute_dtype(flownet_c_loss, torch.bfloat16) if name == "bf16" else None


def trainable_grads(solver: Solver) -> dict:
    return {k: p.grad.numpy().copy() for k, p in solver.net.named_parameters() if p.requires_grad}


def digest(arrays: dict) -> str:
    h = hashlib.sha1()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def counting_collectives():
    """Counts every torch.distributed collective called in the block, and
    the element count of each all_reduce."""
    counts, sizes, saved = collections.Counter(), [], {}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            counts[name] += 1
            if name == "all_reduce":
                sizes.append(args[0].numel())
            return fn(*args, **kwargs)

        return counted

    for name in COLLECTIVES:
        saved[name] = getattr(dist, name)
        setattr(dist, name, wrap(name, saved[name]))
    try:
        yield counts, sizes
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def mean_batches() -> list[dict]:
    """Three augmented global batches at source size 80x160, noise 0."""
    transform = make_flownet_augmenter(H, W, NOISELESS)
    return [transform(smooth_batch(40 + k, h=80, w=160), np.random.default_rng([5, k])) for k in range(3)]


def run_mean_steps(group=None) -> list[dict]:
    """3 augmented steps with the running mean (window 3): the means' states."""
    rank = group.rank if group is not None else 0
    solver = make_solver("flownetc", group, loss_fn=make_augmented_loss(
        flownet_c_loss, H, W, seed=0, mean_window=3, rank=rank))
    means = [MeanRecompute(H, W, 3, window=3) for _ in MEAN_KEYS]
    for batch in mean_batches():
        if group is not None:
            batch = rank_rows(batch, group.rank, group.world)
        for m, key in zip(means, MEAN_KEYS):
            batch = m.attach(batch, key=key)
        _, aux = solver.step(batch)
        for m, key in zip(means, BATCH_MEAN_KEYS):
            m.update(aux[key].numpy())
    return [m.state_dict() for m in means]


# -- the rank processes ----------------------------------------------------------------------


def _solver_cases(group, tmp: str) -> dict:
    out = {}
    for name, (loss_key, iter_size, _) in CASES.items():
        solver = make_solver(loss_key, group, iter_size=iter_size, loss_fn=case_loss(name))
        losses, counted = [], None
        for i, batch in enumerate(case_batches(name)):
            local = rank_rows(batch, group.rank, group.world, axis=1 if iter_size > 1 else 0)
            if i == 1:  # a step after the first: what crosses the group
                with counting_collectives() as (counts, sizes):
                    loss, _ = solver.step(local)
                counted = dict(counts=dict(counts), sizes=sizes)
            else:
                loss, _ = solver.step(local)
            losses.append(loss.item())
            if i == 0:
                grads = trainable_grads(solver)
        params = {}
        if name == "plain":  # copies: the Solver steps on below
            params = {k: v.copy() for k, v in params_from_state_dict(solver.net.state_dict()).items()}
        out[name] = dict(losses=losses, counted=counted, grads_digest=digest(grads), params_digest=digest(params),
                         grads=grads if group.is_main else None, params=params if group.is_main else None,
                         n_trainable=sum(p.numel() for p in solver.net.parameters() if p.requires_grad))
        if name == "plain":
            out.update(_snapshot_and_signal(group, solver, tmp))
    return out


def _snapshot_and_signal(group, first: Solver, tmp: str) -> dict:
    """Snapshot the plain case's Solver after its 2 steps: rank 0 writes,
    rank 1 (given a directory of its own) writes nothing. A fresh 2-rank
    Solver restored from rank 0's files takes the same third step. Then
    SIGINT on rank 1 before the restored Solver's solve(): rank 1's stop
    request rides step 4, is read after step 5, and both ranks stop there."""
    first.snapshot_dir = os.path.join(tmp, "snaps" if group.is_main else f"snaps_rank{group.rank}")
    first.snapshot()
    dist.barrier()  # rank 0's files are complete before any rank reads them
    batch = rank_rows(smooth_batch(20), group.rank, group.world)
    first.step(batch)
    second = make_solver("flownetc", group, seed=8, display=1)
    second.restore(os.path.join(tmp, "snaps", "iter_0000002"))
    second.step(batch)
    a, b = first.net.state_dict(), second.net.state_dict()
    snapshot = dict(iteration=second.iteration, max_diff=max(float((a[k] - b[k]).abs().max()) for k in a),
                    files=sorted(os.listdir(first.snapshot_dir)) if os.path.isdir(first.snapshot_dir) else [])
    second.install_signal_handlers()
    if group.rank == 1:
        os.kill(os.getpid(), signal.SIGINT)
    logs = []
    batches = iter([rank_rows(smooth_batch(30 + i), group.rank, group.world) for i in range(4)])
    second.solve(batches, max_iter=10, log=logs.append)
    return dict(snapshot=snapshot, signal=dict(iteration=second.iteration, logs=logs))


def _ranks_main(group, tmp: str) -> dict:
    torch.set_num_threads(2)
    out = _solver_cases(group, tmp)
    out["mean"] = run_mean_steps(group)
    return out


@pytest.fixture(scope="module")
def ranks_future(tmp_path_factory):
    """Both ranks' results, computed in the background from the first test
    that reads them on, while each comparison computes its reference. Not
    earlier: the tests before that one spawn two ranks of their own, and two
    spawns at once share the host's cores, so that under the whole suite's
    load either can miss its join limit."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn, _ranks_main, ["cpu", "cpu"], tmp, timeout=PG_TIMEOUT,
                          join_timeout=RANKS_JOIN_TIMEOUT)


@pytest.fixture
def ranks(ranks_future):
    return ranks_future


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# -- the loader ----------------------------------------------------------------------------------


def _write_chairs(root, n=6, h=80, w=160, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        write_ppm(os.path.join(root, f"{i:07d}-img0.ppm"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        write_ppm(os.path.join(root, f"{i:07d}-img1.ppm"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        write_flo(os.path.join(root, f"{i:07d}-gt.flo"), rng.normal(0, 3, (h, w, 2)).astype(np.float32))


@pytest.mark.parametrize("augment", [True, False], ids=["augmented", "center-crops"])
def test_keyed_loader_cuts_one_global_batch_between_the_ranks(tmp_path, augment):
    """2 threads each: rank r's rows of batch k equal rows [2r, 2r+2) of the
    world-1 keyed loader's batch k (samples and augmentation coefficients),
    across an epoch boundary (6 samples, global batch 4); one thread gives
    the same batches."""
    _write_chairs(str(tmp_path))
    ds = FlyingChairs(str(tmp_path))
    kw = dict(shuffle_seed=3, transform=make_flownet_augmenter(H, W)) if augment else dict(shuffle_seed=3, crop=(H, W))
    whole = iter(BatchLoader(ds, GLOBAL, shard=(0, 1), num_threads=2, **kw))
    single = iter(BatchLoader(ds, GLOBAL, shard=(0, 1), num_threads=1, **kw))
    parts = [iter(BatchLoader(ds, GLOBAL, shard=(r, 2), num_threads=2, **kw)) for r in range(2)]
    for _ in range(4):
        g, s = next(whole), next(single)
        assert g.keys() == s.keys() and (not augment or "aug_mat0" in g)
        for k in g:
            np.testing.assert_array_equal(g[k], s[k])
        for r, it in enumerate(parts):
            got = next(it)
            assert got.keys() == g.keys()
            for k in g:
                np.testing.assert_array_equal(got[k], g[k][2 * r : 2 * r + 2], err_msg=f"rank {r} {k}")


def test_keyed_loader_ends_after_its_epochs_and_refuses_an_uneven_cut(tmp_path):
    _write_chairs(str(tmp_path), n=5)
    ds = FlyingChairs(str(tmp_path))
    assert len(list(BatchLoader(ds, 2, shard=(1, 2), epochs=2, crop=(H, W)))) == 5
    with pytest.raises(ValueError, match="evenly"):
        BatchLoader(ds, 3, shard=(0, 2))


# -- pieces ------------------------------------------------------------------------------------


@pytest.mark.parametrize("spec,count,want", [
    ("all", 2, [0, 1]),
    ("1", 2, [1]),
    ("1,0", 4, [1, 0]),
    ("all", 0, "no CUDA device"),
    ("0", 0, "no CUDA device"),
    ("0,1", 1, r"card 1 not available \(1 present\)"),
    ("0,0", 2, "duplicate"),
    ("zero", 2, "expected 'all'"),
])
def test_pick_devices(spec, count, want):
    if isinstance(want, list):
        assert pick_devices(spec, count) == [torch.device("cuda", i) for i in want]
    else:
        with pytest.raises(ValueError, match=want):
            pick_devices(spec, count)


def test_iter_size_averages_each_aux_value_in_its_shape():
    """With iter_size 2 an aux value keeps its shape, averaged over the
    micro-batches (the augmentation's (H, W, C) batch means; the stack's
    mean over every element took it to a scalar before)."""
    from flownet2_tpu_torch.train import make_train_step, make_solver as make_optimizer

    w = torch.nn.Parameter(torch.ones(3))

    def loss_fn(net, batch):
        return (w * batch["x"]).sum(), {"loss": (w * batch["x"]).sum(), "map": batch["x"].detach()}

    step = make_train_step(loss_fn, make_optimizer(SolverConfig(**ADAM, iter_size=2), [w]), iter_size=2)
    _, aux = step(None, {"x": torch.tensor([[1.0, 2.0, 3.0], [3.0, 4.0, 5.0]])})
    np.testing.assert_array_equal(aux["map"].numpy(), [2.0, 3.0, 4.0])
    assert aux["loss"].shape == ()


def test_rank_rows_keeps_replicated_state_whole():
    batch = {"img0": np.arange(8).reshape(4, 2), "aug_gamma": np.arange(4.0), "mean_image0": np.zeros((4, 2, 3)),
             "mean_iter": np.asarray(3), "other": np.zeros(5)}
    got = rank_rows(batch, 1, 2)
    np.testing.assert_array_equal(got["img0"], [[4, 5], [6, 7]])
    np.testing.assert_array_equal(got["aug_gamma"], [2.0, 3.0])
    assert got["mean_image0"].shape == (4, 2, 3) and got["mean_iter"] == 3 and got["other"].shape == (5,)
    micro = rank_rows({"img0": np.zeros((2, 4, 3))}, 0, 2, axis=1)
    assert micro["img0"].shape == (2, 2, 3)
    with pytest.raises(ValueError, match="equal parts"):
        rank_rows({"img0": np.zeros((3, 1))}, 0, 2)


# -- the CLI -------------------------------------------------------------------------------------


def bounded_ranks(monkeypatch):
    """cli.train's ranks with this file's process-group and join timeouts,
    and 2 threads each: more threads than the cores stall them."""
    import flownet2_tpu_torch.parallel

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setattr(flownet2_tpu_torch.parallel, "spawn",
                        functools.partial(spawn, timeout=PG_TIMEOUT, join_timeout=JOIN_TIMEOUT))


def test_train_cli_rank_body_trains_and_snapshots_on_two_cpu_ranks(tmp_path, capfd, monkeypatch):
    """cli.train's per-rank body on ["cpu", "cpu"]: --batch 1 per rank, the
    running mean and --write-augmented (rank 0 writes the gathered global
    batch of 2), snapshots by rank 0."""
    from flownet2_tpu_torch.cli.train import build_parser, train_ranks

    bounded_ranks(monkeypatch)
    data, snaps, aug = tmp_path / "chairs", tmp_path / "snaps", tmp_path / "aug"
    data.mkdir()
    _write_chairs(str(data), n=4)
    args = build_parser().parse_args([
        "--model", "flownetc", "--data-root", str(data), "--batch", "1", "--crop", f"{H}x{W}", "--max-iter", "2",
        "--recompute-mean", "2", "--write-augmented", str(aug), "--display", "1", "--snapshot-dir", str(snaps)])
    assert train_ranks(args, ["cpu", "cpu"]) == 0
    assert "batch per card" in build_parser().format_help()
    out = capfd.readouterr().out
    assert "batch 2 (1 x 2 devices) x iter_size 1, augmented" in out and "Iteration 2, loss" in out
    assert out.count("Training flownetc") == 1 and out.count("Augmenting 1,") == 2
    assert sorted(os.listdir(snaps)) == ["iter_0000002.npz", "iter_0000002.pt"]
    assert {f"aug0_0000002({n:03d}).ppm" for n in (0, 1)} <= set(os.listdir(aug))
    extras = torch.load(snaps / "iter_0000002.pt", weights_only=True)["extras"]
    assert int(extras["mean0"]["num_iter"]) == 2


def test_train_cli_exits_nonzero_when_a_rank_fails(tmp_path, capfd, monkeypatch):
    """Both ranks fail on an empty data root: the run exits 1, in time."""
    from flownet2_tpu_torch.cli.train import build_parser, train_ranks

    bounded_ranks(monkeypatch)
    args = build_parser().parse_args(["--model", "flownetc", "--data-root", str(tmp_path), "--batch", "1",
                                      "--no-augment", "--snapshot-dir", ""])
    assert train_ranks(args, ["cpu", "cpu"]) == 1
    assert "exited with code" in capfd.readouterr().err


def _fail_on_rank_one(group):
    if group.rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()  # rank 0 waits in a collective for the rank that is gone


def test_spawn_raises_when_a_rank_fails_while_another_waits():
    with pytest.raises(RankFailed, match="rank 1 exited"):
        spawn(_fail_on_rank_one, ["cpu", "cpu"], timeout=PG_TIMEOUT, join_timeout=JOIN_TIMEOUT)


# -- the bf16 parity tool ----------------------------------------------------------------------


def test_bf16_parity_tool_matches_the_jax_tool(tmp_path, capsys):
    """FlowNetS: XLA's CPU backend has no bf16 x bf16 -> f32 dot, which the
    JAX package's bf16 correlation takes."""
    from flownet2_tpu.tools.diag import bf16_parity as jax_bf16_parity

    from flownet2_tpu_torch.tools.diag import bf16_parity

    weights = str(tmp_path / "w.npz")
    save_params(weights, init_params("flownets", seed=3))
    argv = ["--weights", weights, "--model", "flownets", "--synth", "--size", f"{H}x{W}"]
    jax_bf16_parity.main(argv)
    want = capsys.readouterr().out.splitlines()
    assert bf16_parity.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):  # the same lines, numbers aside
        assert g.split(":")[0] == w.split(":")[0]
    epe = [float(lines[0].split(":")[1]) for lines in (got, want)]
    assert abs(epe[0] - epe[1]) <= 1e-3, epe
    assert got[1].startswith("bf16 GT-EPE: ") and "(delta " in got[1] and got[2].endswith(" px")


def test_bf16_parity_tool_refuses_without_a_card(tmp_path, monkeypatch):
    from flownet2_tpu_torch.tools.diag import bf16_parity

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bf16_parity.main(["--weights", str(tmp_path / "w.npz"), "--synth"])


# -- against the JAX package -------------------------------------------------------------------


def test_two_ranks_match_the_jax_data_parallel_solver(ranks):
    """2 Adam steps of the FlowNetC loss, global batch 4: the JAX Solver on
    a 2-device data mesh against 2 port ranks of 2 pairs each."""
    import jax
    import jax.numpy as jnp

    from flownet2_tpu.checkpoint import flatten_params as jax_flatten, unflatten_params
    from flownet2_tpu.parallel import MeshConfig, make_mesh
    from flownet2_tpu.train import objectives as jax_objectives
    from flownet2_tpu.train.solver import Solver as JaxSolver
    from flownet2_tpu.train.solvers import SolverConfig as JaxSolverConfig

    flat = init_params("flownetc", seed=6)
    mesh = make_mesh(MeshConfig(data=2, spatial=1), jax.devices()[:2])
    ref = JaxSolver(JaxSolverConfig(**ADAM), jax_objectives.flownet_c_loss, unflatten_params(flat), mesh=mesh)
    ref_losses = [float(ref.step({k: jnp.asarray(v) for k, v in b.items()})[0]) for b in case_batches("plain")]
    want = jax_flatten(ref.state.params)
    got = ranks.result()
    for r in got:
        np.testing.assert_allclose(r["plain"]["losses"], ref_losses, rtol=1e-4)
    params = got[0]["plain"]["params"]
    assert got[1]["plain"]["params_digest"] == digest(params), "the ranks' parameters differ"
    for k in flat:
        moved = np.asarray(want[k]) - flat[k]
        err = rel_l2(params[k] - flat[k], moved)
        assert err <= 1e-3, f"{k}: update differs by {err:.3g} relative L2"


# -- against one port process on the global batch ----------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_average_the_one_process_gradients(ranks, name):
    """The all-reduced gradients of the first step equal one process's on
    the global batch within 1e-5 relative L2 per tensor, on both ranks:
    plain, iter_size 2 (the micro-batches' rows cut on axis 1), the
    flownet2-s1 stage loss, whose frozen upstream a DDP wrapper would have
    left out of its sync, and bf16 compute over float32 masters through
    ``functional_call``. bf16 sums a batch's weight gradients in bf16, so
    its one process runs the ranks' halves as iter_size 2."""
    loss_key, iter_size, _ = CASES[name]
    batch = case_batches(name)[0]
    if name == "bf16":
        iter_size, batch = 2, {k: v.reshape(2, GLOBAL // 2, *v.shape[1:]) for k, v in batch.items()}
    solver = make_solver(loss_key, iter_size=iter_size, loss_fn=case_loss(name))
    loss, _ = solver.step(batch)
    want = trainable_grads(solver)
    got = ranks.result()
    grads = got[0][name]["grads"]
    assert got[1][name]["grads_digest"] == digest(grads), "the ranks' gradients differ"
    assert grads.keys() == want.keys()
    for k in want:
        err = rel_l2(grads[k], want[k])
        assert err <= 1e-5, f"{name} {k}: gradient differs by {err:.3g} relative L2"
    np.testing.assert_allclose(got[0][name]["losses"][0], loss.item(), rtol=1e-5)


def test_a_step_makes_two_collectives(ranks):
    """One flat gradient all_reduce of every trainable element and one small
    stats all_reduce; no broadcast, no per-tensor collective."""
    for r in ranks.result():
        counted = r["plain"]["counted"]
        assert counted["counts"] == {"all_reduce": 2}
        assert counted["sizes"][0] == r["plain"]["n_trainable"]
        assert counted["sizes"][1] < 64


def test_running_mean_agrees_across_ranks_and_with_one_process(ranks):
    want = run_mean_steps()
    got = ranks.result()
    for a, b in zip(got[0]["mean"], got[1]["mean"]):
        np.testing.assert_array_equal(a["mean"], b["mean"])
        assert a["num_iter"] == b["num_iter"] == 3
    for a, w in zip(got[0]["mean"], want):
        np.testing.assert_allclose(a["mean"], w["mean"], rtol=1e-5, atol=1e-7)


def test_rank_zero_alone_writes_snapshots_and_a_restore_gives_the_same_next_step(ranks):
    got = ranks.result()
    assert got[0]["snapshot"]["files"] == ["iter_0000002.npz", "iter_0000002.pt"]
    assert got[1]["snapshot"]["files"] == []
    for r in got:
        assert r["snapshot"]["iteration"] == 3
        assert r["snapshot"]["max_diff"] <= 1e-6


def test_a_signal_on_one_rank_stops_both_at_the_same_iteration(ranks):
    got = ranks.result()
    assert [r["signal"]["iteration"] for r in got] == [5, 5]
    logs = got[0]["signal"]["logs"]
    assert [line.split(",")[0] for line in logs] == ["Iteration 4", "Iteration 5",
                                                     "Stopping early at iteration 5 (signal)."]
    assert got[1]["signal"]["logs"] == []
