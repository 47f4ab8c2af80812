"""The PyTorch port's tools against the JAX package's on the same numpy
inputs and weights: the synthetic dataset, flow_vis, parse_log,
plot_training_log, accum, Solver's test metric, summarize, the per-stage
breakdown and time_cmd, device_query; every new module imported with jax
blocked; the CLIs that run a net refuse to fall back to the CPU."""

import contextlib
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from flownet2_tpu.ops.accum import accum as jax_accum
from flownet2_tpu.tools import breakdown as jax_breakdown
from flownet2_tpu.tools import flow_vis as jax_flow_vis
from flownet2_tpu.tools import parse_log as jax_parse_log
from flownet2_tpu.tools import summarize as jax_summarize
from flownet2_tpu.tools import synth_dataset as jax_synth
from flownet2_tpu.train import Solver as JaxSolver
from flownet2_tpu.train import SolverConfig as JaxSolverConfig
from flownet2_tpu_torch.checkpoint import init_params, load_into
from flownet2_tpu_torch.cli import device_query, time_cmd
from flownet2_tpu_torch.inference import _make_forward
from flownet2_tpu_torch.models import NETS
from flownet2_tpu_torch.ops.accum import accum
from flownet2_tpu_torch.ops.resample import resample
from flownet2_tpu_torch.tools import breakdown, flow_vis, parse_log, plot_training_log, summarize, synth_dataset
from flownet2_tpu_torch.train import Solver, SolverConfig

torch.set_num_threads(2)  # the suite runs several workers side by side

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def nested(flat: dict) -> dict:
    """Flat ``a/b/w`` parameters -> the JAX package's nested pytree."""
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    return out


# ---------------------------------------------------------------- synth_dataset


def test_synth_dataset_arrays_equal_jax():
    """make_sample from one seed: every array equal to the JAX module's
    (both numpy), at the easy and the default settings."""
    for kw in (dict(n_layers=2, max_shift=5.0), {}):
        a = jax_synth.make_sample(np.random.default_rng(4), 48, 64, **kw)
        b = synth_dataset.make_sample(np.random.default_rng(4), 48, 64, **kw)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def test_synth_dataset_split_files_equal_jax(tmp_path):
    """write_split: the port's .flowrec and its index are byte for byte the
    JAX writer's; the CLI writes both splits."""
    ours, theirs = str(tmp_path / "ours.flowrec"), str(tmp_path / "theirs.flowrec")
    synth_dataset.write_split(ours, 3, 9, 32, 48, log=lambda *_: None)
    jax_synth.write_split(theirs, 3, 9, 32, 48, log=lambda *_: None)
    for suffix in ("", ".idx"):
        with open(ours + suffix, "rb") as f, open(theirs + suffix, "rb") as g:
            assert f.read() == g.read()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = synth_dataset.main(["--n", "2", "--n-eval", "1", "--height", "32", "--width", "48",
                                 "--out", str(tmp_path / "s")])
    assert rc == 0 and {"s_train.flowrec", "s_eval.flowrec"} <= set(os.listdir(tmp_path))


# ---------------------------------------------------------------- flow_vis, parse_log, plot


def test_flow_to_color_equals_jax():
    rng = np.random.default_rng(2)
    flow = rng.normal(0, 6, (17, 23, 2)).astype(np.float32)
    flow[3, 4] = np.nan
    for max_flow in (None, 4.0):
        np.testing.assert_array_equal(flow_vis.flow_to_color(flow, max_flow), jax_flow_vis.flow_to_color(flow, max_flow))


LOG = """Training flownets on flowrec
Iteration 100, loss = 12.5 (4.21 iter/s)
Iteration 100, test metric = 7.25
Iteration 200, loss = nan (3.9 iter/s)
Iteration 300, loss = 1.5e-3
Iteration 400, test metric = inf
"""


def test_parse_log_rows_equal_jax(tmp_path):
    lines = LOG.splitlines()
    rows = parse_log.parse_log(lines)
    assert repr(rows) == repr(jax_parse_log.parse_log(lines))  # repr: nan != nan
    assert [len(r) for r in rows] == [3, 2]
    log = tmp_path / "train.log"
    log.write_text(LOG)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert parse_log.main([str(log)]) == 0
    assert "parsed 3 train rows, 2 test rows" in out.getvalue()
    assert (tmp_path / "train.log.train.csv").read_text().splitlines()[0] == "iteration,loss,iters_per_sec"


def test_plot_training_log_draws(tmp_path):
    pytest.importorskip("matplotlib")
    log = tmp_path / "train.log"
    log.write_text(LOG.replace("nan", "2.0"))
    with contextlib.redirect_stdout(io.StringIO()):
        assert plot_training_log.main([str(log), "--out", str(tmp_path / "curve.png"), "--log-scale"]) == 0
    assert (tmp_path / "curve.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plot_training_log_without_matplotlib_names_it(tmp_path, monkeypatch):
    """Where matplotlib cannot be imported, the tool exits with a message
    that names it (the card's machine has no matplotlib)."""
    log = tmp_path / "train.log"
    log.write_text(LOG)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    with pytest.raises(SystemExit, match="matplotlib"):
        plot_training_log.main([str(log)])


# ---------------------------------------------------------------- accum


ACCUM_SIZES = [(5, 7), (10, 14), (3, 9), (8, 4)]


@pytest.mark.parametrize("method", ["nearest", "linear"])
@pytest.mark.parametrize("mode", ["largest", "reference", "divisible"])
def test_accum_equals_jax(mode, method):
    """accum over four maps of different sizes and widths, in each size
    mode and both methods: the port (NCHW) equals the JAX op (NHWC); nearest
    exactly (a gather of the same source pixels), linear to 1e-5."""
    rng = np.random.default_rng(6)
    xs = [rng.normal(0, 1, (2, h, w, c)).astype(np.float32) for (h, w), c in zip(ACCUM_SIZES, (1, 2, 3, 2))]
    kw = {"largest": {}, "reference": {"reference": 2}, "divisible": {"size_divisible_by": 4}}[mode]
    ref = np.asarray(jax_accum([jnp.asarray(x) for x in xs], method=method, **kw))
    got = accum([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs], method=method, **kw)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == {"largest": (2, 10, 14, 8), "reference": (2, 3, 9, 8),
                                      "divisible": (2, 12, 16, 8)}[mode]
    if method == "nearest":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_nearest_resample_is_not_interpolate_nearest():
    """The reference's nearest indices (swapped half-pixel offsets, C round)
    are not F.interpolate's at this ratio: the port computes its own."""
    from flownet2_tpu.ops.resample import resample as jax_resample

    x = torch.arange(2 * 5 * 7, dtype=torch.float32).reshape(1, 2, 5, 7)
    ours = resample(x, 9, 4, method="nearest")
    ref = np.asarray(jax_resample(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), 9, 4, method="nearest"))
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(), ref)
    assert not torch.equal(ours, torch.nn.functional.interpolate(x, size=(9, 4), mode="nearest"))


# ---------------------------------------------------------------- Solver test metric


class _Quadratic(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(w))


def test_solver_test_metric_lines_equal_jax():
    """Solver(test_fn=, test_interval=): the 'test metric' lines come at the
    JAX Solver's iterations with its values (a quadratic loss under Adam, so
    both take the same steps), between the display and the snapshot."""
    w0 = np.array([0.5, -1.0, 2.0], np.float32)
    target = np.array([1.0, 2.0, -3.0], np.float32)
    config = dict(solver_type="adam", base_lr=0.1, lr_policy="fixed", max_iter=7)
    batch = {"t": target}

    ours = Solver(SolverConfig(**config), lambda net, b: (((net.w - b["t"]) ** 2).sum(), {}), _Quadratic(w0),
                  device="cpu", display=2, test_fn=lambda net: float(net.w.detach().sum()), test_interval=3)
    theirs = JaxSolver(JaxSolverConfig(**config), lambda p, b: (((p["w"] - b["t"]) ** 2).sum(), {}),
                       {"w": jnp.asarray(w0)}, display=2, test_fn=lambda p: float(p["w"].sum()), test_interval=3)
    logs = {"ours": [], "theirs": []}
    ours.solve(iter(lambda: {"t": torch.from_numpy(target)}, None), log=logs["ours"].append)
    theirs.solve(iter(lambda: batch, None), log=logs["theirs"].append)

    def metric_lines(lines):
        return [(int(line.split(",")[0].split()[1]), float(line.rsplit("=", 1)[1]))
                for line in lines if "test metric" in line]

    got, ref = metric_lines(logs["ours"]), metric_lines(logs["theirs"])
    assert [i for i, _ in got] == [i for i, _ in ref] == [3, 6]
    np.testing.assert_allclose([m for _, m in got], [m for _, m in ref], rtol=1e-5)
    kinds = [("test" if "test metric" in line else "loss") for line in logs["ours"]]
    assert kinds == [("test" if "test metric" in line else "loss") for line in logs["theirs"]]


# ---------------------------------------------------------------- summarize


@pytest.mark.parametrize("model", ["flownetc", "flownet2"])
def test_summarize_rows_equal_jax(model):
    """The layer table (names, weight and bias shapes, counts, subtotals,
    total) and the forward's output shape equal the JAX tool's."""
    ours, theirs = io.StringIO(), io.StringIO()
    total = summarize.summarize(model, 64, 128, 1, device="cpu", out=ours)
    assert total == jax_summarize.summarize(model, 64, 128, 1, out=theirs)
    a, b = ours.getvalue().splitlines(), theirs.getvalue().splitlines()
    n = b.index("output @ 128x64 (batch 1):")
    assert a[: n + 2] == b[: n + 2]
    assert b[n + 1] == "  (1, 64, 128, 2)"
    # the port also prints each scale of the last sub-net
    assert a[n + 2:][0].startswith("  flow")


# ---------------------------------------------------------------- breakdown, time_cmd


def _walk_rows_jax(model, flat_params, h, w):
    img = jnp.zeros((1, h, w, 3), jnp.float32)
    stages = jax_breakdown.walk_stages(model, nested(flat_params), img, img)
    return [(st.name, st.count, [tuple(s.shape[1:3]) for s in st.arg_specs if isinstance(s, jax.ShapeDtypeStruct)])
            for st in stages]


@pytest.mark.parametrize("model", ["flownet2", "flownet2-css", "dispnetc"])
def test_walk_stages_equal_jax(model):
    """The stage list from one forward: names in first-call order, call
    counts and spatial shapes of the array inputs equal the JAX walk's."""
    params = init_params(model, seed=0)
    with torch.device("meta"):
        net = NETS[model]()
    net = load_into(net, params)
    img = torch.zeros(1, 3, 64, 128)
    ours = [(st.name, st.count, st.spatial()) for st in breakdown.walk_stages(model, net, img, img)]
    assert ours == _walk_rows_jax(model, params, 64, 128)
    names = [name for name, _, _ in ours]
    if model == "flownet2":
        assert dict((n, c) for n, c, _ in ours if n not in ("channel_norm",)) == {
            "normalize_images": 1, "flownetc": 1, "resample": 4, "flow_warp": 4, "flownets": 2,
            "flownet-sd": 1, "fusion": 1}
    assert names[0] == "normalize_images"


def test_time_stages_fills_every_stage_and_nan_without_gradient():
    """time_stages on the CPU: forward and forward+backward times for every
    differentiable stage; a stage whose inputs carry nothing floating gets
    NaN for its backward."""
    with torch.device("meta"):
        net = NETS["flownet2-cs"]()
    net = load_into(net, init_params("flownet2-cs", seed=0))
    img = torch.zeros(1, 3, 64, 64)
    stages = breakdown.walk_stages("flownet2-cs", net, img, img)
    breakdown.time_stages(stages, "cpu", warmup=0, runs=1, backward=True)
    assert all(st.fwd_ms > 0 and st.fwdbwd_ms > 0 for st in stages)
    integer = breakdown.Stage("round", torch.round, (("arr", (2, 3), torch.int32),), {})
    breakdown.time_stages([integer], "cpu", warmup=0, runs=1, backward=True)
    assert integer.fwd_ms > 0 and np.isnan(integer.fwdbwd_ms)


def test_time_cmd_breakdown_prints_its_table():
    """time_cmd --breakdown --backward on the CPU: the whole-program lines,
    one row per stage of the walk with its count, and the count-weighted
    sums beside the whole program."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = time_cmd.main(["--model", "flownet2-cs", "--height", "64", "--width", "64", "--iterations", "1",
                            "--breakdown", "--backward", "--device", "cpu"])
    assert rc == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("forward: ") and "ms/iter" in lines[0] and "pairs/s" in lines[0]
    assert lines[1] == "forward+backward: no objective trains flownet2-cs"
    assert lines[2].split() == ["stage", "shape", "count", "fwd", "ms", "bwd", "ms", "f+b", "ms"]
    rows = [line.split() for line in lines[3:-1]]
    assert [(r[0], int(r[2])) for r in rows] == [
        ("normalize_images", 1), ("flownetc", 1), ("resample", 2), ("flow_warp", 1), ("channel_norm", 1),
        ("flownets", 1)]
    assert lines[-1].startswith("sum (count-weighted)") and lines[-1].endswith("vs whole-program above")


def test_time_cmd_backward_times_the_objective():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = time_cmd.main(["--model", "flownets", "--height", "64", "--width", "64", "--iterations", "1",
                            "--backward", "--device", "cpu"])
    assert rc == 0 and out.getvalue().splitlines()[1].startswith("forward+backward: ")


@pytest.mark.parametrize("model, channels", [("dispnetc", 1), ("flownetc", 2)])
def test_time_cmd_backward_target_has_the_objectives_layout(model, channels, monkeypatch):
    """--backward differentiates the objective on a target of its own
    layout: (N, H, W, 1) disparity for dispnetc (a 2-channel target would
    broadcast against its 1-channel prediction without an error), flow
    for the flow nets; the target has the prediction's channel count."""
    seen, objective = [], time_cmd.objective

    def recording(model_name):
        loss_fn = objective(model_name)

        def wrapped(net, batch):
            seen.append(tuple(batch["flow"].shape))
            return loss_fn(net, batch)

        return wrapped

    monkeypatch.setattr(time_cmd, "objective", recording)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = time_cmd.main(["--model", model, "--height", "64", "--width", "128", "--iterations", "1",
                            "--backward", "--device", "cpu"])
    assert rc == 0 and out.getvalue().splitlines()[1].startswith("forward+backward: ")
    assert seen and set(seen) == {(1, 64, 128, channels)}
    with torch.device("meta"):
        net = NETS[model]()
    net = load_into(net, init_params(model, seed=0)).eval()
    with torch.no_grad():
        pred = _make_forward(model)(net, torch.zeros(1, 3, 64, 128), torch.zeros(1, 3, 64, 128))
    assert pred.shape[1] == channels


# ---------------------------------------------------------------- device_query, no card, no jax


def test_device_query_exits_0_without_a_card():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert device_query.main([]) == 0
    assert out.getvalue().startswith("backend: cpu\nno CUDA device visible")


@pytest.mark.parametrize("tool", ["test", "time_cmd", "eval_parity", "overfit", "overfit_cascade", "summarize"])
def test_tools_without_card_refuse_to_fall_back(tool, tmp_path, monkeypatch):
    """Without a card and without --device, every tool that runs a net exits
    with a message; none falls back to the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {
        "test": ["--weights", "random", "--model", "flownets", "--data-root", str(tmp_path)],
        "time_cmd": ["--model", "flownets"],
        "eval_parity": ["--model", "flownets", "--weights", "random", "--list", str(tmp_path / "l.txt")],
        "overfit": ["--data", str(tmp_path)],
        "overfit_cascade": ["--data", str(tmp_path), "--out", str(tmp_path / "out")],
        "summarize": ["flownets"],
    }[tool]
    pkg = "cli" if tool in ("test", "time_cmd", "eval_parity") else "tools"
    module = importlib.import_module(f"flownet2_tpu_torch.{pkg}.{tool}")
    with pytest.raises(SystemExit, match="no CUDA device available; pass --device cpu"):
        module.main(argv)


_NO_JAX = """
import importlib, importlib.abc, sys

BLOCKED = ("jax", "flownet2_tpu")

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if blocked(name):
            raise ImportError(f"{name} is blocked in this process")

sys.meta_path.insert(0, BlockJax())
for name in ("cli.test", "cli.time_cmd", "cli.eval_parity", "cli.device_query", "ops.accum", "tools.synth_dataset",
             "tools.flow_vis", "tools.parse_log", "tools.plot_training_log", "tools.breakdown", "tools.summarize",
             "tools.overfit", "tools.overfit_cascade", "train.solver"):
    importlib.import_module("flownet2_tpu_torch." + name)
from flownet2_tpu_torch.cli import device_query, test
from flownet2_tpu_torch.tools.synth_dataset import write_split
write_split(sys.argv[1], 2, 0, 64, 64, log=print)
assert device_query.main([]) == 0
rc = test.main(["--weights", "random", "--model", "flownets", "--dataset", "flowrec", "--data-root", sys.argv[1],
                "--batch", "2", "--device", "cpu"])
assert not [m for m in sys.modules if blocked(m)]
print("ran without jax, rc", rc)
"""


def test_new_modules_import_and_run_without_jax(tmp_path):
    """Every module this slice adds imports in a process that refuses jax
    and the JAX package; the synthetic split, device_query and cli.test run
    there."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path / "s.flowrec")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ran without jax, rc 0" in proc.stdout and "Loss: average EPE over 1 batches" in proc.stdout


def test_nearest_resample_keeps_a_nan_where_it_is():
    """A NaN pixel upsampled x2 by the port's nearest gather fills its own
    2x2 block and nothing else. (The JAX package's nearest resample is a
    one-hot matmul, where 0 * NaN spreads the NaN to every output: a fault
    of the JAX package the port does not copy.)"""
    x = torch.arange(20, dtype=torch.float32).reshape(1, 1, 4, 5)
    x[0, 0, 1, 2] = float("nan")
    out = resample(x, 8, 10, method="nearest")
    assert out.isnan().nonzero()[:, 2:].tolist() == [[2, 4], [2, 5], [3, 4], [3, 5]]
    assert torch.equal(out.nan_to_num(-1)[0, 0, ::2, ::2], x.nan_to_num(-1)[0, 0])


def test_time_stages_nan_for_an_output_without_gradient():
    """A floating input whose output does not depend on it differentiably
    (a comparison) times its forward and reports NaN for the backward."""
    stage = breakdown.Stage("sign", torch.gt, (("arr", (2, 3), torch.float32), ("static", 0.0)), {})
    breakdown.time_stages([stage], "cpu", warmup=0, runs=1, backward=True)
    assert stage.fwd_ms > 0 and np.isnan(stage.fwdbwd_ms)
