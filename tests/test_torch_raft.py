"""RAFT in the port (``models/raft.py``, ``ops/all_pairs.py``, ``FlowRunner``'s
/8 rule) against a plain-PyTorch reference (``tests/raft_reference.py``,
which imports nothing of the port), on the CPU: the flow through
``FlowRunner``, the lookup and the convex upsampling against loops, the
published parameter count, the counter, the spans, the weight bridge and
the CLIs."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import raft_reference as ref
from flownet2_tpu_torch.checkpoint import (
    expected_params,
    init_params,
    load_into,
    load_params,
    params_from_state_dict,
    save_params,
)
from flownet2_tpu_torch.cli.run_flownet import main as run_flownet_main
from flownet2_tpu_torch.cli.run_flownet_many import main as run_flownet_many_main
from flownet2_tpu_torch.core.flow_io import read_flo, write_ppm
from flownet2_tpu_torch.inference import FlowRunner, pad_to_8
from flownet2_tpu_torch.models import RAFT, export_caffe, import_caffe
from flownet2_tpu_torch.models.raft import convex_upsample
from flownet2_tpu_torch.ops.all_pairs import AllPairs

torch.set_num_threads(2)  # the suite runs several workers side by side

PUBLISHED_PARAMETERS = 5_257_536  # RAFT's full model, the paper's 5.3M


def seeded_weights(seed: int) -> dict:
    return ref.seeded_weights(expected_params("raft"), seed)


@pytest.fixture(scope="module")
def weights():
    return seeded_weights(3)


@pytest.fixture
def one_thread():
    """One CPU thread while the port and the reference run: the BLAS and the
    convolutions split their sums by the threads they get, and may get fewer
    on a loaded host, which would part two runs of the same arithmetic."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8) for _ in range(2))


@pytest.mark.parametrize("iters", [4, 12])
def test_runner_batch_equals_the_reference(weights, iters, one_thread):
    """Two pairs of 124x190, padded on both axes (to 128x192: 2 rows above, 2
    below, 1 column left, 1 right). Max |flow difference| <= 1e-4 px: the
    port and the reference run the published operations in the same order in
    float32, and agree to the bit on the CPU in one thread; the random weights make the
    recurrence amplify any change of rounding (the reference in float64
    parts from float32 by 2.8e-4 px after 4 updates and 0.02 px after 12),
    so an arithmetic that departs from the published one shows here."""
    assert pad_to_8(124, 190) == (2, 2, 1, 1)
    img0, img1 = _frames(2, 124, 190)
    got = FlowRunner("raft", weights, device="cpu", iters=iters).batch(img0, img1)
    with torch.no_grad():
        want = ref.raft(weights, img0, img1, iters).numpy()
    assert got.shape == want.shape == (2, 124, 190, 2) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-4, np.abs(got - want).max()


def test_runner_call_equals_the_reference(weights, one_thread):
    """``__call__`` on one (H, W, 3) pair, no padding needed (128x192); as above, 1e-4 px."""
    img0, img1 = _frames(1, 128, 192, seed=1)
    got = FlowRunner("raft", weights, device="cpu", iters=3)(img0[0], img1[0])
    with torch.no_grad():
        want = ref.raft(weights, img0, img1, 3).numpy()[0]
    assert got.shape == (128, 192, 2) and np.abs(got - want).max() <= 1e-4


def test_lookup_equals_a_loop():
    """The window's order (channel 81 l + 9 i + j at (x + i - 4, y + j - 4)),
    zeros outside, all four levels; coordinates inside, at the edges and far
    outside. The loop runs in float64 on the float32 pyramid: 1e-5 leaves
    float32's rounding of the bilinear weights."""
    gen = torch.Generator().manual_seed(5)
    f1, f2 = torch.randn(1, 16, 16, 16, generator=gen), torch.randn(1, 16, 16, 16, generator=gen)
    volume = AllPairs(f1, f2)
    assert [tuple(p.shape) for p in volume.pyramid] == [(256, 1, 16, 16), (256, 1, 8, 8), (256, 1, 4, 4),
                                                        (256, 1, 2, 2)]
    ys, xs = torch.meshgrid(torch.arange(16.0), torch.arange(16.0), indexing="ij")
    coords = torch.stack([xs, ys])[None] + torch.randn(1, 2, 16, 16, generator=gen) * 6
    coords[0, :, 0, :4] = torch.tensor([[0.0, 15.0, -30.0, 40.0], [0.0, 15.0, 3.0, -25.0]])
    got = volume.lookup(coords)
    want = ref.lookup_loop(ref.pyramid(f1, f2), coords)
    assert got.shape == (1, 324, 16, 16) and got.dtype == torch.float32
    assert np.abs(got.double().numpy() - want).max() <= 1e-5
    assert (want == 0).any() and (want != 0).mean() > 0.3  # both kinds of taps were read


def test_lookup_keeps_float32_for_bfloat16_features():
    f = torch.randn(1, 8, 16, 16).bfloat16()
    volume = AllPairs(f, f)
    assert all(p.dtype == torch.float32 for p in volume.pyramid)
    coords = torch.zeros(1, 2, 16, 16)
    assert volume.lookup(coords).dtype == torch.float32


def test_convex_upsampling_equals_a_loop():
    gen = torch.Generator().manual_seed(7)
    flow, mask = torch.randn(2, 2, 4, 5, generator=gen) * 3, torch.randn(2, 576, 4, 5, generator=gen)
    got = convex_upsample(flow, mask)
    assert got.shape == (2, 2, 32, 40)
    assert np.abs(got.double().numpy() - ref.upsample_loop(flow, mask)).max() <= 1e-5


def test_published_parameter_count():
    with torch.device("meta"):
        net = RAFT()
    assert sum(p.numel() for p in net.parameters()) == PUBLISHED_PARAMETERS
    shapes = expected_params("raft")
    counted = sum(int(np.prod(s)) for k, s in shapes.items() if not k.endswith(("/mean", "/var")))
    assert counted == PUBLISHED_PARAMETERS
    assert shapes["update_block/gru/convz1/w"] == (1, 5, 384, 128)
    assert shapes["cnet/layer2/0/downsample/1/scale"] == (96,)
    assert not any(k.startswith("fnet/") and k.endswith("/scale") for k in shapes)  # instance norm: no leaves


def test_init_params_and_the_bridge_round_trip(tmp_path):
    params = init_params("raft", 0)
    assert set(params) == set(expected_params("raft"))
    assert (params["cnet/norm1/scale"] == 1).all() and (params["cnet/norm1/var"] == 1).all()
    assert init_params("raft", 0)["fnet/conv1/w"].tobytes() == params["fnet/conv1/w"].tobytes()
    net = load_into(RAFT(), seeded_weights(1))
    back = params_from_state_dict(net.state_dict())
    assert all(np.array_equal(back[k], v) for k, v in seeded_weights(1).items()) and len(back) == len(params)
    save_params(tmp_path / "raft.npz", back)
    loaded = load_params(tmp_path / "raft.npz")
    assert all(np.array_equal(loaded[k], v) for k, v in back.items())
    bad = dict(params, **{"cnet/norm1/scale": np.ones((1, 64), np.float32)})
    with pytest.raises(ValueError, match="1-D batch-norm leaf"):
        FlowRunner("raft", bad, device="cpu")


def test_updates_counter(weights):
    img0, img1 = _frames(1, 128, 128)
    runner = FlowRunner("raft", weights, device="cpu", iters=5)
    before = RAFT.updates
    runner.batch(img0, img1)
    runner.batch(img0, img1)
    assert RAFT.updates - before == 10


def test_spans_once_and_once_an_update(weights):
    """``fn2.raft.encode``, ``volume`` and ``refine`` once a request and
    ``lookup`` once an update, inside ``refine``, inside the runner's forward."""
    img0, img1 = _frames(1, 128, 128)
    runner = FlowRunner("raft", weights, device="cpu")  # 32 updates, the published Sintel evaluation's
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.batch(img0, img1)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith(("fn2.raft.", "fn2.runner."))), key=lambda s: s[1])
    names = [s[0] for s in spans]
    assert [names.count(n) for n in ("fn2.raft.encode", "fn2.raft.volume", "fn2.raft.refine", "fn2.raft.lookup")] \
        == [1, 1, 1, 32]
    assert [n for n in names if n.startswith("fn2.runner.")] == ["fn2.runner.prepare", "fn2.runner.upload",
                                                                  "fn2.runner.forward", "fn2.runner.download"]
    forward = next(s for s in spans if s[0] == "fn2.runner.forward")
    refine = next(s for s in spans if s[0] == "fn2.raft.refine")
    assert all(forward[1] <= s[1] and s[2] <= forward[2] for s in spans if s[0].startswith("fn2.raft."))
    assert all(refine[1] <= s[1] and s[2] <= refine[2] for s in spans if s[0] == "fn2.raft.lookup")


def test_iters_is_raft_only():
    with pytest.raises(ValueError, match="iters applies to raft"):
        FlowRunner("flownets", init_params("flownets", 0), device="cpu", iters=4)
    with pytest.raises(ValueError, match="at least 1"):
        RAFT(iters=0)
    with pytest.raises(ValueError, match="fusion_head applies to flownet2"):
        FlowRunner("raft", init_params("raft", 0), device="cpu", fusion_head=True)


def test_bfloat16_runner_gives_a_flow(weights):
    img0, img1 = _frames(1, 128, 128)
    flow = FlowRunner("raft", weights, device="cpu", dtype="bfloat16", iters=2).batch(img0, img1)
    assert flow.dtype == np.float32 and flow.shape == (1, 128, 128, 2) and np.isfinite(flow).all()


def test_clis_run_raft_and_refuse_what_does_not_apply(tmp_path, one_thread):
    img0, img1 = _frames(1, 124, 130)
    pair = [str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")]
    write_ppm(pair[0], img0[0])
    write_ppm(pair[1], img1[0])
    out = str(tmp_path / "out.flo")
    assert run_flownet_main(["random", "raft", *pair, out, "--device", "cpu", "--iters", "2"]) == 0
    want = FlowRunner("raft", init_params("raft", 0), device="cpu", iters=2)(img0[0], img1[0])
    assert np.array_equal(read_flo(out), want)
    jobs = tmp_path / "jobs.txt"
    jobs.write_text(f"{pair[0]} {pair[1]} {tmp_path / 'many.flo'}\n")
    assert run_flownet_many_main(["random", "raft", str(jobs), "--device", "cpu", "--iters", "2"]) == 0
    assert np.array_equal(read_flo(str(tmp_path / "many.flo")), want)
    with pytest.raises(SystemExit, match="iters applies to raft"):
        run_flownet_main(["random", "flownets", *pair, out, "--device", "cpu", "--iters", "2"])
    caffemodel = tmp_path / "raft.caffemodel"
    caffemodel.write_bytes(b"")
    with pytest.raises(SystemExit, match="no Caffe RAFT"):
        run_flownet_main([str(caffemodel), "raft", *pair, out, "--device", "cpu"])
    with pytest.raises(ValueError, match="no Caffe RAFT"):
        import_caffe.import_caffemodel(str(caffemodel), "raft")
    for export in (export_caffe.export_caffemodel, export_caffe.export_caffemodel_h5):
        with pytest.raises(ValueError, match="no Caffe RAFT"):
            export(init_params("raft", 0))
    assert not os.path.exists(tmp_path / "raft.h5")
