"""The PyTorch port's run_flownet CLI and host I/O: against the JAX package,
and without it."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flownet2_tpu.checkpoint import save_params
from flownet2_tpu.cli.run_flownet import main as jax_main
from flownet2_tpu.cli.run_flownet_many import main as jax_many_main
from flownet2_tpu.core import adapt as jax_adapt
from flownet2_tpu.core import flow_io as jax_flow_io
from flownet2_tpu.core.flow_io import read_flo, write_ppm
from flownet2_tpu_torch.checkpoint import init_params
from flownet2_tpu_torch.cli.run_flownet import main, resolve_model_name
from flownet2_tpu_torch.cli.run_flownet_many import main as many_main
from flownet2_tpu_torch.core import adapt, flow_io

torch.set_num_threads(2)  # the suite runs several workers side by side

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def pair(tmp_path):
    """Two seeded 70x90 PPMs (a size the nets must adapt to /64)."""
    rng = np.random.default_rng(11)
    paths = []
    for i in range(2):
        p = tmp_path / f"img{i}.ppm"
        write_ppm(p, rng.integers(0, 256, (70, 90, 3), dtype=np.uint8))
        paths.append(str(p))
    return paths


def test_both_clis_agree_on_one_npz(tmp_path, pair):
    """Same .npz weights, same images: the two .flo files agree to mean
    EPE <= 1e-3 px (float32 on both sides)."""
    npz = str(tmp_path / "w.npz")
    save_params(npz, init_params("flownetc", seed=2))
    out_jax, out_torch = str(tmp_path / "jax.flo"), str(tmp_path / "torch.flo")
    assert jax_main([npz, "flownetc", *pair, out_jax]) == 0
    assert main([npz, "flownetc", *pair, out_torch, "--device", "cpu"]) == 0
    a, b = read_flo(out_jax), read_flo(out_torch)
    assert a.shape == b.shape == (70, 90, 2)
    assert float(np.sqrt(((a - b) ** 2).sum(-1)).mean()) <= 1e-3


def _epe(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(((a - b) ** 2).sum(-1)).mean())


def test_both_clis_agree_on_dispnetc(tmp_path, pair):
    """dispnetc through both run_flownet CLIs on one .npz: the .flo files
    (the disparity scaled per axis into both channels) agree to mean EPE
    <= 1e-3 px, float32 on both sides."""
    npz = str(tmp_path / "w.npz")
    save_params(npz, init_params("dispnetc", seed=5))
    out_jax, out_torch = str(tmp_path / "jax.flo"), str(tmp_path / "torch.flo")
    assert jax_main([npz, "dispnetc", *pair, out_jax]) == 0
    assert main([npz, "dispnetc", *pair, out_torch, "--device", "cpu"]) == 0
    a, b = read_flo(out_jax), read_flo(out_torch)
    assert a.shape == b.shape == (70, 90, 2)
    assert _epe(a, b) <= 1e-3


def test_run_flownet_many_agrees_with_jax_on_dispnetc(tmp_path):
    """dispnetc through both run_flownet_many CLIs over two jobs of different
    sizes (70x90, 100x130) on one .npz: every .flo agrees to mean EPE <= 1e-3 px."""
    rng = np.random.default_rng(14)
    sizes = [(70, 90), (100, 130)]
    lines = {"jax": [], "torch": []}
    for j, hw in enumerate(sizes):
        imgs = [str(tmp_path / f"job{j}_img{i}.ppm") for i in range(2)]
        for p in imgs:
            write_ppm(p, rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
        for side in lines:
            lines[side].append(f"{imgs[0]} {imgs[1]} {tmp_path / f'{side}{j}.flo'}")
    for side, ls in lines.items():
        (tmp_path / f"{side}.txt").write_text("\n".join(ls) + "\n")
    npz = str(tmp_path / "w.npz")
    save_params(npz, init_params("dispnetc", seed=6))
    assert jax_many_main([npz, "dispnetc", str(tmp_path / "jax.txt")]) == 0
    assert many_main([npz, "dispnetc", str(tmp_path / "torch.txt"), "--device", "cpu"]) == 0
    for j, hw in enumerate(sizes):
        a, b = read_flo(tmp_path / f"jax{j}.flo"), read_flo(tmp_path / f"torch{j}.flo")
        assert a.shape == b.shape == (*hw, 2)
        assert _epe(a, b) <= 1e-3


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
import flownet2_tpu_torch._build, flownet2_tpu_torch.checkpoint, flownet2_tpu_torch.inference
import flownet2_tpu_torch.core.adapt, flownet2_tpu_torch.core.flow_io
import flownet2_tpu_torch.models, flownet2_tpu_torch.ops
from flownet2_tpu_torch.cli.run_flownet import main
rc = main(sys.argv[1:])
assert not [m for m in sys.modules if blocked(m)]
print("ran without jax, rc", rc)
"""


def test_port_cli_runs_without_jax(tmp_path, pair):
    """The port and its CLI import neither jax nor the JAX package: a
    subprocess that refuses to import either runs the CLI end to end."""
    out = str(tmp_path / "out.flo")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "random", "flownets", *pair, out, "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "ran without jax, rc 0" in proc.stdout
    flow = read_flo(out)
    assert flow.shape == (70, 90, 2) and np.isfinite(flow).all()


_TRAIN_NO_JAX = _NO_JAX.replace("from flownet2_tpu_torch.cli.run_flownet import main", "from flownet2_tpu_torch.cli.train import main")


def test_augmented_training_from_transport_records_runs_without_jax(tmp_path):
    """cli.train with augmentation (its default) on a .flowrec read in
    transport mode (uint8 images, int16 flow at source size, decoded by the
    objective), in a subprocess that refuses jax: it trains, writes the
    augmented pairs and the running means."""
    from flownet2_tpu_torch.data import FlowRecordWriter

    rng = np.random.default_rng(12)
    rec = str(tmp_path / "chairs.flowrec")
    with FlowRecordWriter(rec) as w:
        for _ in range(4):
            flow = rng.normal(0, 3, (80, 160, 2)).astype(np.float32)
            flow[5:9, 10:30] = np.nan
            w.write(rng.integers(0, 256, (80, 160, 3), dtype=np.uint8),
                    rng.integers(0, 256, (80, 160, 3), dtype=np.uint8), flow)
    aug = tmp_path / "aug"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["OMP_NUM_THREADS"] = "2"
    argv = ["--model", "flownets", "--dataset", "flowrec", "--data-root", rec, "--batch", "2", "--crop", "64x128",
            "--max-iter", "1", "--recompute-mean", "1", "--mean-per-pixel", "--write-augmented", str(aug),
            "--display", "1", "--snapshot-dir", "", "--device", "cpu"]
    proc = subprocess.run([sys.executable, "-c", _TRAIN_NO_JAX, *argv], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ran without jax, rc 0" in proc.stdout and "augmented" in proc.stdout
    assert sorted(os.listdir(aug)) == ["aug0_0000001(000).ppm", "aug0_0000001(001).ppm", "aug1_0000001(000).ppm",
                                       "aug1_0000001(001).ppm", "mean0.float3", "mean0.ppm", "mean1.float3",
                                       "mean1.ppm"]
    assert flow_io.read_ppm(str(aug / "aug0_0000001(000).ppm")).shape == (64, 128, 3)


def test_train_cli_without_card_refuses_to_fall_back(monkeypatch, tmp_path):
    """Augmented training without --device and without a card exits; the
    augmentation never moves to the CPU on its own."""
    from flownet2_tpu_torch.cli.train import main as train_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train_main(["--model", "flownetc", "--data-root", str(tmp_path)])


def test_cli_without_card_refuses_to_fall_back(monkeypatch, tmp_path, pair):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["random", "flownets", *pair, str(tmp_path / "out.flo")])
    assert not (tmp_path / "out.flo").exists()


@pytest.mark.parametrize(
    "argv_model,message",
    [("dispnetc", None), ("FlowNet3_deploy.prototxt", "cannot infer model")],
    ids=["dispnetc", "FlowNet3_deploy.prototxt-cannot infer model"],
)
def test_cli_rejects_unported_and_unknown_models(tmp_path, pair, argv_model, message):
    """An unknown model exits with a message. dispnetc, refused until the
    port had the 1-D correlation, now runs: a finite (70, 90, 2) .flo."""
    out = str(tmp_path / "out.flo")
    if message is None:
        assert main(["random", argv_model, *pair, out, "--device", "cpu"]) == 0
        flow = read_flo(out)
        assert flow.shape == (70, 90, 2) and np.isfinite(flow).all()
        return
    with pytest.raises(SystemExit, match=message):
        main(["random", argv_model, *pair, out, "--device", "cpu"])


def test_cli_refuses_caffemodel_with_hint(tmp_path, pair):
    """The CLI imports Caffe weights itself now; a file that holds none of the
    net's layers is refused with the keys it lacks, and no .flo is written."""
    weights = tmp_path / "w.caffemodel"
    weights.write_bytes(b"")
    with pytest.raises(SystemExit, match="do not fit the flownets net: 46 missing: conv1/b, conv1/w"):
        main([str(weights), "flownets", *pair, str(tmp_path / "out.flo"), "--device", "cpu"])
    assert not (tmp_path / "out.flo").exists()


@pytest.mark.parametrize(
    "spec,model",
    [
        ("flownet2", "flownet2"),
        ("models/FlowNet2-CSS-ft-sd/FlowNet2-CSS-ft-sd_deploy.prototxt.template", "flownet2-css"),
        ("models/FlowNet2-C/FlowNet2-C_deploy.prototxt.template", "flownetc"),
        ("models/FlowNet2-Sintel/FlowNet2-CSS-Sintel_deploy.prototxt.template", "flownet2-css"),
        ("FlowNet2-SD_deploy.prototxt.template", "flownet2-sd"),
    ],
)
def test_resolve_model_name(spec, model):
    assert resolve_model_name(spec) == model


@pytest.mark.parametrize("hw", [(100, 150), (320, 448), (436, 1024), (64, 64), (1, 1)])
def test_adapt_shape_matches_jax(hw):
    """The port's /64 adapt: the same geometry and per-axis scales, exactly."""
    got, ref = adapt.adapt_shape(*hw), jax_adapt.adapt_shape(*hw)
    assert (got.adapted_height, got.adapted_width) == (ref.adapted_height, ref.adapted_width)
    assert (got.scale_width, got.scale_height) == (ref.scale_width, ref.scale_height)


def test_flo_io_matches_jax_byte_for_byte(tmp_path):
    flow = np.random.default_rng(12).normal(0, 20, (7, 9, 2)).astype(np.float32)
    ours, theirs = tmp_path / "ours.flo", tmp_path / "theirs.flo"
    flow_io.write_flo(ours, flow)
    jax_flow_io.write_flo(theirs, flow)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(flow_io.read_flo(theirs), flow)
    (tmp_path / "bad.flo").write_bytes(b"XXXX" + ours.read_bytes()[4:])
    with pytest.raises(ValueError, match="magic"):
        flow_io.read_flo(tmp_path / "bad.flo")


@pytest.mark.parametrize("shape", [(5, 6, 3), (5, 6), (5, 6, 1)], ids=["ppm", "pgm2d", "pgm"])
def test_pnm_io_matches_jax_byte_for_byte(tmp_path, shape):
    """PPM / PGM writes equal the JAX package's bytes; read_image gives the
    same RGB array, a header comment and grayscale broadcast included."""
    img = np.random.default_rng(13).integers(0, 256, shape, dtype=np.uint8)
    ext = ".ppm" if len(shape) == 3 and shape[2] == 3 else ".pgm"
    ours, theirs = tmp_path / f"ours{ext}", tmp_path / f"theirs{ext}"
    flow_io.write_ppm(ours, img)
    jax_flow_io.write_ppm(theirs, img)
    assert ours.read_bytes() == theirs.read_bytes()
    commented = tmp_path / f"commented{ext}"
    raw = theirs.read_bytes()
    commented.write_bytes(raw[:3] + b"# a comment\n" + raw[3:])
    for p in (theirs, commented):
        got = flow_io.read_image(p)
        assert got.shape == (5, 6, 3)
        np.testing.assert_array_equal(got, jax_flow_io.read_image(p))
