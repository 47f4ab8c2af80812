"""The port's ``DevicePrefetcher`` (``flownet2_tpu_torch/data/pipeline.py``)
against the JAX package's, on the CPU: the same batches in the same order
(max abs 0), how far the source is pulled ahead, errors raised at the
consumer, shutdown, the refusal without a card; ``Solver.solve`` fed
through it against the raw loader; ``cli.train``'s loader path through it;
the one-block packing its card path uses.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from flownet2_tpu.data.pipeline import DevicePrefetcher as JaxDevicePrefetcher
from flownet2_tpu_torch.checkpoint import init_params, load_into
from flownet2_tpu_torch.data import BatchLoader, DevicePrefetcher, FlowRecordReader, FlowRecordWriter
from flownet2_tpu_torch.data.augment_pipeline import make_augmented_loss, make_flownet_augmenter
from flownet2_tpu_torch.data.pipeline import pack_into, pack_layout, unpack_views
from flownet2_tpu_torch.models import FlowNetC
from flownet2_tpu_torch.train import Solver, SolverConfig
from flownet2_tpu_torch.train.objectives import flownet_c_loss

torch.set_num_threads(2)  # the suite runs several workers side by side


def seeded_batches(n: int, seed: int = 0) -> list[dict]:
    """Batches of the dtypes a loader hands over: uint8 images, int16
    transport flow, float32 flow with NaN, float32 and int32 coefficients."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        flow = rng.normal(0, 3, (2, 6, 10, 2)).astype(np.float32)
        flow[rng.random(flow.shape) < 0.1] = np.nan
        out.append({
            "img0": rng.integers(0, 256, (2, 6, 10, 3), dtype=np.uint8),
            "img1": rng.integers(0, 256, (2, 6, 10, 3), dtype=np.uint8),
            "flow_i16": rng.integers(-32768, 32767, (2, 6, 10, 2), dtype=np.int16),
            "flow": flow,
            "aug_mat0": rng.normal(size=(2, 6)).astype(np.float32),
            "label": rng.integers(0, 9, (2,), dtype=np.int32),
        })
    return out


def prefetcher_threads() -> set:
    return {t for t in threading.enumerate() if t.name == "DevicePrefetcher"}


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_yields_the_jax_prefetchers_batches_in_order(depth):
    batches = seeded_batches(7)
    ours = list(DevicePrefetcher(iter(batches), depth=depth, device="cpu"))
    theirs = list(JaxDevicePrefetcher(iter(batches), depth=depth, device=jax.devices("cpu")[0]))
    assert len(ours) == len(theirs) == 7
    for a, b, src in zip(ours, theirs, batches):
        assert a.keys() == b.keys() == src.keys()
        for k in a:
            assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
            got, want = a[k].numpy(), np.asarray(b[k])
            assert got.dtype == want.dtype == src[k].dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)  # NaN where NaN
            np.testing.assert_array_equal(got, src[k])


def _settled(counter: list, timeout: float = 5.0) -> int:
    """The counter's value once it has stopped moving for 0.3 s."""
    deadline = time.monotonic() + timeout
    last, since = counter[0], time.monotonic()
    while time.monotonic() < deadline:
        time.sleep(0.02)
        if counter[0] != last:
            last, since = counter[0], time.monotonic()
        elif time.monotonic() - since > 0.3:
            break
    return last


@pytest.mark.parametrize("depth", [1, 3])
def test_depth_bounds_how_far_the_source_is_pulled(depth):
    """After the consumer took one batch: ``depth`` staged in the queue and
    one in the staging thread's hands, as the JAX class pulls."""
    pulled = {}
    for name, make in (("port", lambda src: DevicePrefetcher(src, depth=depth, device="cpu")),
                       ("jax", lambda src: JaxDevicePrefetcher(src, depth=depth, device=jax.devices("cpu")[0]))):
        counter = [0]
        batch = seeded_batches(1)[0]

        def source(counter=counter):
            while True:
                counter[0] += 1
                yield batch

        gen = iter(make(source()))
        next(gen)
        pulled[name] = _settled(counter)
        gen.close()
    assert pulled["port"] == pulled["jax"] == depth + 2, pulled


def test_a_source_error_is_raised_at_the_consumer():
    def source():
        yield from seeded_batches(2)
        raise ValueError("record 2 is torn")

    gen = iter(DevicePrefetcher(source(), device="cpu"))
    assert len([next(gen), next(gen)]) == 2
    with pytest.raises(ValueError, match="record 2 is torn"):
        next(gen)


def test_an_upload_error_is_raised_at_the_consumer():
    """An array torch cannot hold (object dtype) fails in the staging thread."""
    bad = {"img0": np.array([object(), object()])}
    gen = iter(DevicePrefetcher(iter(seeded_batches(1) + [bad]), device="cpu"))
    next(gen)
    with pytest.raises(TypeError):
        next(gen)


@pytest.mark.parametrize("slow_source", [False, True], ids=["blocked-on-the-queue", "blocked-on-the-source"])
def test_an_early_close_leaves_no_live_thread(slow_source):
    batch = seeded_batches(1)[0]

    def source():
        while True:
            if slow_source:
                time.sleep(0.5)
            yield batch

    before = prefetcher_threads()
    gen = iter(DevicePrefetcher(source(), depth=2, device="cpu"))
    next(gen)
    ours = prefetcher_threads() - before
    assert len(ours) == 1
    time.sleep(0.2)  # the thread fills the queue, or waits on the source
    gen.close()
    thread = ours.pop()
    thread.join(5)
    assert not thread.is_alive()


def test_without_a_card_and_without_a_device_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetcher(iter(seeded_batches(1)))
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(iter(seeded_batches(1)), depth=0, device="cpu")


@pytest.mark.parametrize("arrays", [
    seeded_batches(1)[0],
    {"scalar": np.array(7, np.int32), "mask": np.array([True, False, True]), "odd": np.arange(5, dtype=np.uint8),
     "f64": np.linspace(0, 1, 3), "empty": np.zeros((0, 4), np.float32), "i16": np.arange(3, dtype=np.int16)},
], ids=["loader-batch", "odd-sizes"])
def test_one_block_packing_round_trips(arrays):
    """The card path's layout: every array 8-byte aligned in one uint8
    block, viewed back in its type and shape (here on a host block)."""
    offsets, total = pack_layout(arrays)
    assert all(off % 8 == 0 for off in offsets.values())
    assert total == max(offsets[k] + a.nbytes for k, a in arrays.items())
    block = torch.zeros(total, dtype=torch.uint8)
    pack_into(block, arrays, offsets)
    views = unpack_views(block, arrays, offsets)
    for k, a in arrays.items():
        assert views[k].numpy().dtype == a.dtype and tuple(views[k].shape) == a.shape
        np.testing.assert_array_equal(views[k].numpy(), a)


# -- the training loop fed through it ---------------------------------------------------------


def _write_transport_records(path, n=6, h=80, w=160, seed=0):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    with FlowRecordWriter(path) as wr:
        for _ in range(n):
            f = rng.uniform(0.02, 0.08, 3)
            img0 = (127.5 + 60 * np.sin(xs[..., None] * f + ys[..., None] * f[::-1])).astype(np.uint8)
            dx, dy = (int(v) for v in rng.integers(-3, 4, 2))
            flow = np.broadcast_to(np.float32([dx, dy]), (h, w, 2)).copy()
            wr.write(img0, np.roll(img0, (dy, dx), axis=(0, 1)), flow)


def _augmented_solver():
    with torch.device("meta"):
        net = FlowNetC()
    load_into(net, init_params("flownetc", seed=4))
    config = SolverConfig(solver_type="adam", base_lr=1e-4, lr_policy="fixed", momentum=0.9, momentum2=0.999,
                          max_iter=3)
    return Solver(config, make_augmented_loss(flownet_c_loss, 64, 128, seed=2), net, device="cpu", display=0)


def test_solve_through_the_prefetcher_equals_solve_on_the_raw_loader(tmp_path):
    """3 augmented FlowNetC steps at 64x128 b2 from 80x160 transport
    records: every parameter equal (max abs 0) either way."""
    path = str(tmp_path / "train.flowrec")
    _write_transport_records(path)
    dataset = FlowRecordReader(path, transport=True)

    def loader():
        return iter(BatchLoader(dataset, 2, shuffle_seed=3, num_threads=1, transform=make_flownet_augmenter(64, 128)))

    direct, prefetched = _augmented_solver(), _augmented_solver()
    direct.solve(loader(), max_iter=3, log=lambda m: None)
    staged = iter(DevicePrefetcher(loader(), device="cpu"))
    prefetched.solve(staged, max_iter=3, log=lambda m: None)
    staged.close()
    assert direct.iteration == prefetched.iteration == 3
    got, want = prefetched.net.state_dict(), direct.net.state_dict()
    start = _augmented_solver().net.state_dict()
    assert max((got[k] - want[k]).abs().max().item() for k in want) == 0
    assert max((want[k] - start[k]).abs().max().item() for k in want) > 0


def test_train_cli_loader_path_stages_through_the_prefetcher(tmp_path, monkeypatch, capsys):
    """``cli.train`` without the device cache feeds ``Solver.solve`` through
    one DevicePrefetcher on the solver's device, and its thread ends with
    the run."""
    from flownet2_tpu_torch.cli.train import main as train_main
    import flownet2_tpu_torch.data as data

    made = []

    class Recording(DevicePrefetcher):
        def __init__(self, batches, **kw):
            super().__init__(batches, **kw)
            made.append(self)

    monkeypatch.setattr(data, "DevicePrefetcher", Recording)
    path = str(tmp_path / "train.flowrec")
    _write_transport_records(path, n=4)
    before = prefetcher_threads()
    assert train_main(["--model", "flownetc", "--dataset", "flowrec", "--data-root", path, "--batch", "2",
                       "--crop", "64x128", "--max-iter", "2", "--display", "1", "--snapshot-dir", "",
                       "--device", "cpu"]) == 0
    assert "Iteration 2, loss" in capsys.readouterr().out
    assert len(made) == 1 and made[0].device == torch.device("cpu")
    for t in prefetcher_threads() - before:
        t.join(5)
        assert not t.is_alive()
