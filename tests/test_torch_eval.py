"""The PyTorch port's scoring and convergence tools against the JAX
package's on the same synthetic data and weights: cli.test, eval_parity,
overfit (its examples and its first optimizer steps) and overfit_cascade."""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flownet2_tpu.checkpoint import load_params as jax_load_params
from flownet2_tpu.checkpoint import save_params
from flownet2_tpu.cli import eval_parity as jax_eval_parity
from flownet2_tpu.cli import test as jax_test
from flownet2_tpu.tools import overfit as jax_overfit
from flownet2_tpu.train.objectives import flownet_s_loss as jax_flownet_s_loss
from flownet2_tpu_torch.checkpoint import expected_params, init_params, load_into
from flownet2_tpu_torch.cli import eval_parity, test
from flownet2_tpu_torch.core.flow_io import write_flo, write_ppm
from flownet2_tpu_torch.data import BatchLoader, FlowRecordReader, FlowRecordWriter
from flownet2_tpu_torch.inference import FlowRunner
from flownet2_tpu_torch.models import FlowNetS
from flownet2_tpu_torch.tools import overfit, overfit_cascade
from flownet2_tpu_torch.tools.parse_log import parse_log
from flownet2_tpu_torch.tools.synth_dataset import make_sample, write_split
from flownet2_tpu_torch.train.objectives import flownet_s_loss

torch.set_num_threads(2)  # the suite runs several workers side by side


def nested(flat: dict) -> dict:
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    return out


def run_main(main, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def batch_epes(out: str) -> list[float]:
    return [float(line.rsplit("=", 1)[1]) for line in out.splitlines() if line.startswith("Batch ")]


@pytest.fixture(scope="module")
def held_out(tmp_path_factory):
    """A 6-sample synthetic split at 64x128 (the easy settings)."""
    path = str(tmp_path_factory.mktemp("synth") / "eval.flowrec")
    write_split(path, 6, 17, 64, 128, log=lambda *_: None, max_shift=5.0, n_layers=2)
    return path


@pytest.mark.parametrize("model", ["flownets", "flownet2"])
def test_cli_test_per_batch_epe_matches_jax(tmp_path, held_out, model):
    """cli.test on one .npz and the same .flowrec: every batch's EPE equal to
    the JAX tool's to 1e-4 relative (plus half the printed digit), the same
    average line. The JAX loader's two threads may swap the order of its
    batches (their contents are fixed), so the batches compare sorted."""
    npz = str(tmp_path / "w.npz")
    save_params(npz, init_params(model, seed=3))
    argv = ["--weights", npz, "--model", model, "--dataset", "flowrec", "--data-root", held_out, "--batch", "2"]
    rc, ours = run_main(test.main, argv + ["--device", "cpu"])
    rc_jax, theirs = run_main(jax_test.main, argv)
    assert rc == rc_jax == 0
    a, b = sorted(batch_epes(ours)), sorted(batch_epes(theirs))
    assert len(a) == len(b) == 3
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-5)
    assert ours.splitlines()[-1].startswith("Loss: average EPE over 3 batches = ")
    assert abs(float(ours.rsplit("=", 1)[1]) - float(theirs.rsplit("=", 1)[1])) <= 1e-4 * float(theirs.rsplit("=", 1)[1]) + 5e-5


def test_cli_test_transport_records_score_as_their_float_form(tmp_path):
    """A .flowrec read in the transport domain (uint8 images, int16 flow)
    scores as its float form: the int16 flow is decoded (value/32, SHRT_MAX
    as NaN) before the EPE, so invalid pixels stay out of it."""
    rng = np.random.default_rng(8)
    rec = str(tmp_path / "nan.flowrec")
    with FlowRecordWriter(rec) as w:
        for _ in range(4):
            img0, img1, flow = make_sample(rng, 64, 64, n_layers=1, max_shift=4.0)
            flow[10:20, 5:30] = np.nan
            w.write(img0, img1, flow)
    runner = FlowRunner("flownets", init_params("flownets", seed=1), device="cpu")
    log = []
    floats = test.score(runner, BatchLoader(FlowRecordReader(rec), 2, shuffle_seed=None, epochs=1, num_threads=1),
                        log=log.append)
    transport = test.score(runner, BatchLoader(FlowRecordReader(rec, transport=True), 2, shuffle_seed=None, epochs=1,
                                               num_threads=1), log=log.append)
    assert len(floats) == 2 and all(np.isfinite(floats))
    np.testing.assert_allclose(transport, floats, rtol=1e-6)
    assert log[0].startswith("Batch 0, EPE = ")
    rc, out = run_main(test.main, ["--weights", "random", "--model", "flownets", "--dataset", "flowrec",
                                   "--data-root", rec, "--batch", "2", "--iterations", "1", "--device", "cpu"])
    assert rc == 0 and out.splitlines()[-1].startswith("Loss: average EPE over 1 batches")


def write_chairs(root, n: int) -> str:
    """n synthetic FlyingChairs-layout pairs at 96x128 (NNNNNNN-img0.ppm,
    -img1.ppm, -gt.flo) under ``root``."""
    rng = np.random.default_rng(21)
    for i in range(n):
        img0, img1, flow = make_sample(rng, 96, 128, n_layers=2, max_shift=5.0)
        write_ppm(str(root / f"{i:07d}-img0.ppm"), img0)
        write_ppm(str(root / f"{i:07d}-img1.ppm"), img1)
        write_flo(str(root / f"{i:07d}-gt.flo"), flow)
    return str(root)


@pytest.fixture(scope="module")
def chairs(tmp_path_factory):
    """8 pairs, as the reference's FlyingChairs examples hold."""
    return write_chairs(tmp_path_factory.mktemp("chairs"), 8)


def test_eval_parity_json_equals_jax_in_both_modes(tmp_path, chairs):
    """--list with --weights (an .npz), --out-dir: the one JSON line equals
    the JAX tool's (EPEs to 1e-5); --flo-a/--flo-b over the written sets:
    equal."""
    npz = str(tmp_path / "w.npz")
    save_params(npz, init_params("flownetc", seed=4))
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("".join(f"{chairs}/{i:07d}-img0.ppm {chairs}/{i:07d}-img1.ppm {chairs}/{i:07d}-gt.flo\n"
                             for i in range(3)))
    argv = ["--model", "flownetc", "--weights", npz, "--list", str(pairs)]
    rc, ours = run_main(eval_parity.main, argv + ["--out-dir", str(tmp_path / "ours"), "--device", "cpu"])
    rc_jax, theirs = run_main(jax_eval_parity.main, argv + ["--out-dir", str(tmp_path / "theirs")])
    assert rc == rc_jax == 0
    a, b = json.loads(ours), json.loads(theirs)
    assert a["pairs"] == b["pairs"] == 3 and a["worst_file"] == b["worst_file"]
    np.testing.assert_allclose([a["mean_epe"], a["max_epe"]], [b["mean_epe"], b["max_epe"]], rtol=1e-5)
    sets = ["--flo-a", str(tmp_path / "ours"), "--flo-b", chairs]
    assert json.loads(run_main(eval_parity.main, sets)[1]) == json.loads(run_main(jax_eval_parity.main, sets)[1]) == a
    one = ["--flo-a", str(tmp_path / "ours" / "0000001-gt.flo"), "--flo-b", str(tmp_path / "theirs" / "0000001-gt.flo")]
    assert run_main(eval_parity.main, one)[1] == run_main(jax_eval_parity.main, one)[1]


def test_overfit_examples_and_first_steps_match_jax(chairs):
    """load_examples (the resize to 64x128 with the flow rescaled) equals the
    JAX tool's to 1e-4; from the same initial weights, the first 3 losses of
    the port's Adam steps (cosine-decayed) equal the JAX tool's step (optax's
    adam on its flownet_s_loss) to 1e-4 relative."""
    ours = overfit.load_examples(chairs, (64, 128))
    theirs = jax_overfit.load_examples(chairs, (64, 128))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)

    params = init_params("flownets", seed=2)
    batch = {k: torch.from_numpy(v) for k, v in zip(("img0", "img1", "flow"), ours)}
    with torch.device("meta"):
        net = FlowNetS()
    solver = overfit.make_solver(load_into(net, params), flownet_s_loss, lr=1e-4, iters=10, cosine=True,
                                 device="cpu")
    got = [float(solver.step(batch)[0]) for _ in range(3)]

    tx = optax.adam(optax.cosine_decay_schedule(1e-4, 10))
    p = nested(params)
    state = tx.init(p)
    jbatch = {k: jnp.asarray(v) for k, v in zip(("img0", "img1", "flow"), ours)}

    @jax.jit
    def step(p, state):
        (loss, _), grads = jax.value_and_grad(jax_flownet_s_loss, has_aux=True)(p, jbatch)
        updates, state = tx.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss

    ref = []
    for _ in range(3):
        p, state, loss = step(p, state)
        ref.append(float(loss))
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got[2] < got[0]


def test_overfit_main_logs_in_the_solver_format(tmp_path, chairs):
    """A few iterations: the log holds the test metric at 0 and at the end,
    a loss line per chunk (tools/parse_log reads them), the final EPE line;
    the exit code says whether the 1/4-resolution EPE is below 0.5."""
    log = str(tmp_path / "log.txt")
    rc, out = run_main(overfit.main, ["--data", chairs, "--height", "64", "--width", "128", "--iters", "4",
                                      "--chunk", "2", "--cosine", "--log", log, "--device", "cpu"])
    final = float(out.splitlines()[-1].split(";")[1].split()[0])
    assert rc == (0 if final < 0.5 else 1)
    with open(log) as f:
        train, tests = parse_log(f)
    assert [r["iteration"] for r in train] == [2, 4] and [r["iteration"] for r in tests] == [0, 4]
    assert out.splitlines()[-1].startswith("final EPE over the 8 training pairs: ")


def test_overfit_cascade_writes_the_jax_keys(tmp_path):
    """All five stages at 2 iterations each (on 2 pairs): results.json has
    the JAX tool's keys, one log per stage, and the .npz carries every
    parameter of FlowNet2 in the JAX package's layout and scores through
    cli.test."""
    (tmp_path / "pairs").mkdir()
    pairs = write_chairs(tmp_path / "pairs", 2)
    out = tmp_path / "cascade"
    rc, text = run_main(overfit_cascade.main, ["--data", pairs, "--height", "64", "--width", "64", "--iters", "2",
                                               "--chunk", "2", "--out", str(out), "--device", "cpu"])
    assert rc in (0, 1) and "cascade EPE at random init" in text
    with open(out / "results.json") as f:
        results = json.load(f)
    assert set(results) == {"init_epe", "stages", "final_epe"}
    assert list(results["stages"]) == ["c", "s1", "s2", "sd", "fusion"]
    assert all(set(v) == {"first_loss", "final_loss", "cascade_epe"} for v in results["stages"].values())
    assert sorted(os.listdir(out)) == sorted(["results.json", "flownet2_staged.npz"] +
                                              [f"log_{s}.txt" for s in results["stages"]])
    loaded = jax_load_params(str(out / "flownet2_staged.npz"))
    got = {"/".join(k.key for k in path): leaf.shape for path, leaf in jax.tree_util.tree_leaves_with_path(loaded)}
    assert got == expected_params("flownet2")
    rec = str(tmp_path / "s.flowrec")
    write_split(rec, 2, 5, 64, 64, log=lambda *_: None)
    rc, scored = run_main(test.main, ["--weights", str(out / "flownet2_staged.npz"), "--model", "flownet2",
                                      "--dataset", "flowrec", "--data-root", rec, "--batch", "2", "--device", "cpu"])
    assert rc == 0 and scored.splitlines()[-1].startswith("Loss: average EPE over 1 batches")
