"""The RAFT cell's benchmark pieces on the CPU: the plain reference against
the port's CPU path, the operation count and the bounds by hand, the
check's control and faults at a small size, and the seven ``raft_*``
readers on a hand-built stretch."""

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import raft_readers, yardstick
from benchmark.harness.cell import load_cell, metric_reader
from benchmark.harness.trace import Interval, Stretch
from benchmark.reference import raft as ref
from benchmark.traffic import infer_raft

CPU = torch.device("cpu")
CELL = "raft.sintel-b4"
SMALL = dict(height=124, width=190, pool_requests=2, check_requests=2, warmup_requests=1, pairs_per_request=2)


def _small_cell(iters=6):
    cell = load_cell(CELL)
    cell.traffic.update(SMALL)
    cell.config["iters"] = iters
    return cell


def test_reference_layers_are_the_ports():
    from flownet2_tpu_torch.checkpoint import expected_params

    assert ref.param_shapes() == expected_params("raft")
    counted = sum(int(np.prod(s)) for k, s in ref.param_shapes().items() if not k.endswith(("/mean", "/var")))
    assert counted == 5_257_536


@pytest.mark.parametrize("h,w,n,iters", [(124, 190, 2, 4), (136, 128, 1, 9)])
def test_reference_flow_equals_the_ports_cpu_path(h, w, n, iters):
    """Both run the published float32 operations in the same order: equal to the
    bit here, in one thread (the BLAS and the convolutions split their sums by
    the threads they get, which a loaded host can change between two runs)."""
    from flownet2_tpu_torch.inference import FlowRunner

    params = ref.make_weights(11, CPU)
    rng = np.random.default_rng(3)
    img0, img1 = (rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8) for _ in range(2))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = FlowRunner("raft", params, device=CPU, iters=iters).batch(img0, img1)
        with torch.no_grad():
            want = ref.run_raft(ref.Ops(), ref.prepare(params), torch.from_numpy(img0), torch.from_numpy(img1),
                                iters)
    finally:
        torch.set_num_threads(threads)
    assert got.shape == want.shape == (n, h, w, 2)
    assert np.abs(got - want.numpy()).max() <= 1e-4


def test_weights_draw_the_stated_distributions():
    p = ref.make_weights(2**31 + 5, CPU)
    scale = np.concatenate([v for k, v in p.items() if k.endswith("/scale")])
    offset = np.concatenate([v for k, v in p.items() if k.endswith("/offset")])
    assert 0.5 <= scale.min() and scale.max() <= 1.5 and abs(offset.std() - 0.1) < 0.02
    w = p["update_block/gru/convz1/w"]
    assert abs(w.std() - (2 / (5 * 384)) ** 0.5) < 0.002
    again = ref.make_weights(2**31 + 5, CPU)
    assert all(np.array_equal(v, again[k]) for k, v in p.items())


def test_operations_a_pair_by_hand():
    """1024x440 (Sintel padded to /8), 32 updates: 183.70 + 25.38 + 32 x 37.68 + 6.23 GFLOP."""
    f = ref.forward_flops(440, 1024, 32)
    hw = 55 * 128
    assert f["volume"] == 2 * hw * hw * 256
    # one update: convc1, convc2, convf1, convf2, conv, six GRU convs, the flow head's two
    per_update = 2 * hw * (324 * 256 + 9 * 256 * 192 + 49 * 2 * 128 + 9 * 128 * 64 + 9 * 256 * 126
                           + 6 * 5 * 384 * 128 + 9 * 128 * 256 + 9 * 256 * 2)
    assert f["update"] == 32 * per_update
    assert f["mask"] == 2 * hw * (9 * 128 * 256 + 256 * 576)
    assert [round(f[k] / 1e9, 2) for k in ("encode", "volume", "mask")] == [183.70, 25.38, 6.23]
    assert round(per_update / 1e9, 2) == 37.68 and round(sum(f.values()) / 1e9) == 1421


def test_bounds_by_hand():
    # the pyramid at 55x128: 55x128 + 27x64 + 13x32 + 6x16 maps of 55x128 pixels, f1 and f2 read
    nbytes = 4 * (2 * 4 * 256 * 7040 + 4 * 7040 * (7040 + 1728 + 416 + 96))
    assert raft_readers.volume_bound_s(4, 55, 128) == max(nbytes / 3.35e12, 2 * 4 * 7040 ** 2 * 256 / 495e12)
    assert raft_readers.lookup_bound_s(4, 55, 128) == 4 * 4 * 7040 * 326 / 3.35e12
    assert yardstick.PEAK_BYTES_PER_S == 3.35e12


FAULTS = [None, "altered_answer", "half_batch", "one_update_fewer", "window_transposed", "lookup_at_start",
          "flow_input_zeroed"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_makes_the_run_not_correct(fault):
    cell = _small_cell()
    with infer_raft.planted(fault):
        result = infer_raft.run(cell, 2**31 + 11, 0.5, False, CPU)
    assert result.attempted > 0 and set(result.checks) == set(cell.limits)
    assert bench_run.is_correct(result) == (fault is None), {k: (c.value, c.limit) for k, c in result.checks.items()}


@pytest.mark.parametrize("fault", ["lookup_at_start", "flow_input_zeroed"])
def test_a_loop_that_stops_moving_fails_only_the_loop_check(fault):
    """A lookup that stays at the starting grid, or a motion encoder whose
    flow input stays zero: the first update and the output stage are the
    program's own, so ``first_epe`` and ``pair_epe`` pass; the flow after the
    checked update, held from the frames, does not."""
    cell = _small_cell()
    with infer_raft.planted(fault):
        result = infer_raft.run(cell, 2**31 + 13, 0.5, False, CPU)
    checks = {k: (c.value, c.limit) for k, c in result.checks.items()}
    assert [k for k, (value, limit) in checks.items() if value > limit] == ["loop_epe"], checks


def test_the_program_equals_the_reference_through_the_checked_update():
    """On the CPU in one thread the net's coordinates after each update, rebuilt
    from the increments the hooks keep, are the reference's to the bit."""
    cell = _small_cell()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = infer_raft.readings(cell, 2**31 + 17, CPU, False)["program"]
    finally:
        torch.set_num_threads(threads)
    assert [(x["first_epe"], x["loop_epe"]) for x in got] == [(0.0, 0.0)] * 4


def test_the_control_fails_where_the_program_passes():
    cell = _small_cell()
    got = infer_raft.readings(cell, 7, CPU, True)
    for side, ok in (("program", True), ("control", False)):
        worst = {k: max(x[k] for x in got[side]) for k in cell.limits}
        assert all(worst[k] <= limit for k, limit in cell.limits.items()) == ok, (side, worst)


def test_the_parent_stops_before_any_work(monkeypatch):
    """A program without RAFT: the traffic code raises at once, before frames or weights."""
    from flownet2_tpu_torch import inference

    monkeypatch.setattr(inference, "MODEL_INITS", {k: v for k, v in inference.MODEL_INITS.items() if k != "raft"})
    monkeypatch.setattr(infer_raft, "build", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(ValueError, match="unknown model 'raft'"):
        infer_raft.run(_small_cell(), 1, 1.0, False, CPU)


# a request of two pairs at 124x190 (padded 128x192, 1/8: 16x24), two updates; us
ANNOTATIONS = [("fn2.raft.encode", 0, 10), ("fn2.raft.volume", 10, 14), ("fn2.raft.refine", 14, 40),
               ("fn2.raft.lookup", 14, 16), ("fn2.raft.lookup", 26, 28)]
KERNELS = [(0, 4), (5, 10), (10, 14), (14, 16), (16, 25), (26, 28), (28, 38), (60, 70)]


def _stretch(requests=2, iters=2, annotations=ANNOTATIONS):
    ann, dev = [], [Interval("Memcpy HtoD", -5, -1)]
    for r in range(requests):
        ann += [Interval(n, s + 100 * r, e + 100 * r) for n, s, e in annotations]
        dev += [Interval("k", s + 100 * r, e + 100 * r) for s, e in KERNELS]
    cell = dict(SMALL, model="raft", iters=iters)
    return Stretch(200e-6 * requests, dev, ann, [], {}, {"requests": requests, "pairs": 2 * requests}, cell)


def test_the_readers_on_a_hand_built_stretch():
    st = _stretch()
    read = {m: metric_reader(m)(st) for m in ("raft_encode_ms.infer", "raft_volume_ms.infer", "raft_lookup_ms.infer",
                                              "raft_refine_ms.infer", "raft_volume_roofline.infer",
                                              "raft_lookup_roofline.infer", "raft_mfu.infer")}
    # device us a pair: encode 4 + 5 over 2 pairs; volume 4; lookups 2 + 2; refine 2 + 9 + 2 + 10 less the lookups
    assert read["raft_encode_ms.infer"] == pytest.approx(0.0045)
    assert read["raft_volume_ms.infer"] == pytest.approx(0.002)
    assert read["raft_lookup_ms.infer"] == pytest.approx(0.002)
    assert read["raft_refine_ms.infer"] == pytest.approx(0.0095)
    assert read["raft_volume_roofline.infer"] == pytest.approx(100 * raft_readers.volume_bound_s(2, 16, 24) / 4e-6)
    assert read["raft_lookup_roofline.infer"] == pytest.approx(100 * 2 * raft_readers.lookup_bound_s(2, 16, 24) / 4e-6)
    flops = sum(ref.forward_flops(128, 192, 2).values())
    assert read["raft_mfu.infer"] == pytest.approx(100 * flops * 4 / 400e-6 / 495e12)


def test_the_readers_read_nothing_without_the_spans():
    """A program that opens no ``fn2.raft.*`` span, or a lookup count that is
    not one an update: every reader gives None and the line leaves it out."""
    names = ("raft_encode_ms.infer", "raft_volume_ms.infer", "raft_lookup_ms.infer", "raft_refine_ms.infer",
             "raft_volume_roofline.infer", "raft_lookup_roofline.infer", "raft_mfu.infer")
    assert all(metric_reader(m)(_stretch(annotations=[])) is None for m in names)
    wrong = _stretch(iters=3)
    assert metric_reader("raft_lookup_ms.infer")(wrong) is None and metric_reader("raft_encode_ms.infer")(wrong)


def test_the_reference_loads_nothing_of_the_program_and_the_traffic_code_no_jax():
    from benchmark.tests.test_bench_imports import _modules_after
    from benchmark.harness.common import forbidden_loaded

    mods = _modules_after("import benchmark.reference.raft")
    assert not [m for m in mods if m.split(".")[0] in ("flownet2_tpu_torch", "flownet2_tpu", "jax")]
    mods = _modules_after("from benchmark.traffic import infer_raft\nfrom benchmark.harness import raft_readers\n"
                          "import flownet2_tpu_torch.models.raft, flownet2_tpu_torch.ops.all_pairs")
    assert forbidden_loaded(mods) == [] and "flownet2_tpu_torch.models.raft" in mods
