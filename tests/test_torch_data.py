"""The port's dataset formats, loader and transport decode against the JAX
package's, on the CPU.

``.flowrec`` records byte for byte and item for item both ways, LMDB and
LevelDB items, labels and permutations (their files written by the JAX
tests' independent writers), the ChairsSDHom and FlyingThings3D layouts,
KITTI's 16-bit flow PNG against the KITTI devkit's formula (not against the
JAX reader, which reads such files through Pillow at 8 bits a channel), the
BatchLoader's seeded block-shuffled batches, the objectives on transport
batches, and the train and convert_dataset CLIs on packed records.

The JAX record reader's float path would build and load
``cpp/libflowdata.so``; the ``jax_numpy_records`` fixture keeps it on its
numpy path, so these tests never build that library.
"""

import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flownet2_tpu.checkpoint import unflatten_params
from flownet2_tpu.cli.convert_dataset import main as jax_convert
from flownet2_tpu.core.flow_io import write_flo, write_pfm, write_ppm
from flownet2_tpu.data import BatchLoader as JaxBatchLoader
from flownet2_tpu.data import datasets as jax_datasets
from flownet2_tpu.data import native as jax_native
from flownet2_tpu.data.leveldb import LevelDBFlowDataset as JaxLevelDBFlowDataset
from flownet2_tpu.data.lmdb import LmdbFlowDataset as JaxLmdbFlowDataset
from flownet2_tpu.data.records import FlowRecordReader as JaxFlowRecordReader
from flownet2_tpu.data.records import FlowRecordWriter as JaxFlowRecordWriter
from flownet2_tpu.train import objectives as jax_objectives
from flownet2_tpu_torch.checkpoint import init_params, load_into
from flownet2_tpu_torch.cli.convert_dataset import main as convert
from flownet2_tpu_torch.cli.train import main as train_main
from flownet2_tpu_torch.core.codec import encode_flow_int16, encode_occlusion_bits
from flownet2_tpu_torch.core.flow_io import read_kitti_flow, read_png16_rgb
from flownet2_tpu_torch.data import (
    BatchLoader,
    ChairsSDHom,
    FlowRecordReader,
    FlowRecordWriter,
    FlyingThings3D,
    KITTI,
    LevelDBFlowDataset,
    LmdbFlowDataset,
    open_dataset,
)
from flownet2_tpu_torch.data.lmdb import DISPARITY_ENCODINGS, DISPARITY_SLICE_POINTS
from flownet2_tpu_torch.models import DispNetC, FlowNetC
from flownet2_tpu_torch.train import objectives
from test_leveldb import write_leveldb
from test_lmdb import encode_datum, make_flow_datum, write_lmdb

torch.set_num_threads(2)  # the suite runs several workers side by side


@pytest.fixture
def jax_numpy_records(monkeypatch):
    """The JAX record reader's float items through its numpy decode."""
    monkeypatch.setattr(jax_native, "decode_record", lambda body: None)


def assert_items_equal(a: dict, b: dict) -> None:
    """Same keys; arrays equal in dtype, shape and value (NaN where NaN)."""
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=k)


# -- .flowrec records --------------------------------------------------------------------------

RECORD_KINDS = ("flow", "disparity", "occlusion")


def _samples(kind: str, n: int = 3, h: int = 6, w: int = 10, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img0, img1 = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(2))
        flow = rng.uniform(-30, 30, (h, w, 1 if kind == "disparity" else 2)).astype(np.float32)
        flow[0, 0] = np.nan
        occ = rng.integers(0, 2, (h, w)).astype(bool) if kind == "occlusion" else None
        out.append((img0, img1, flow, occ))
    return out


def _write_records(writer_cls, path: str, samples) -> None:
    with writer_cls(path) as w:
        for s in samples:
            w.write(*s)


@pytest.mark.parametrize("kind", RECORD_KINDS)
def test_record_writer_bytes_equal_jax(tmp_path, kind):
    samples = _samples(kind)
    ours, theirs = str(tmp_path / "a.flowrec"), str(tmp_path / "b.flowrec")
    _write_records(FlowRecordWriter, ours, samples)
    _write_records(JaxFlowRecordWriter, theirs, samples)
    for ext in ("", ".idx"):
        assert open(ours + ext, "rb").read() == open(theirs + ext, "rb").read()


@pytest.mark.parametrize("transport", [False, True], ids=["float", "transport"])
@pytest.mark.parametrize("kind", RECORD_KINDS)
def test_record_readers_read_each_others_files(tmp_path, jax_numpy_records, kind, transport):
    """The port reads the JAX writer's file, and the JAX reader the port's,
    to the same items: float32 HWC with NaN invalids, or transport uint8 /
    int16 / uint8 occlusion."""
    samples = _samples(kind)
    ours, theirs = str(tmp_path / "a.flowrec"), str(tmp_path / "b.flowrec")
    _write_records(FlowRecordWriter, ours, samples)
    _write_records(JaxFlowRecordWriter, theirs, samples)
    port_reads_jax, jax_reads_port = FlowRecordReader(theirs, transport=transport), JaxFlowRecordReader(
        ours, transport=transport)
    assert len(port_reads_jax) == len(jax_reads_port) == 3
    for i, (img0, _, flow, occ) in enumerate(samples):
        a, b = port_reads_jax[i], jax_reads_port[i]
        assert_items_equal(a, b)
        assert a["flow"].shape == flow.shape
        assert a["flow"].dtype == (np.int16 if transport else np.float32)
        np.testing.assert_array_equal(a["img0"], img0 if transport else img0.astype(np.float32))
        assert ("occ" in a) == (occ is not None)
    port_reads_jax.close()
    jax_reads_port.close()


def test_record_permutation_matches_jax(tmp_path):
    path = str(tmp_path / "r.flowrec")
    _write_records(FlowRecordWriter, path, _samples("flow", n=7))
    ours, theirs = FlowRecordReader(path), JaxFlowRecordReader(path)
    for seed, block in ((None, 1), (3, 1), (3, 2), (5, 3)):
        np.testing.assert_array_equal(ours.permutation(seed, block), theirs.permutation(seed, block))


# -- LMDB and LevelDB ------------------------------------------------------------------------


def make_disparity_datum(rng, h, w, label=0):
    """The reference's disparity packing (convert_imageset_and_disparity.cpp):
    CHW uint8 BGR frames, int16 x32 disparity, bit-packed occlusion."""
    img0, img1 = (rng.integers(0, 255, (3, h, w), np.uint8) for _ in range(2))
    disp = rng.uniform(-40, 0, (h, w, 1)).astype(np.float32)
    disp[1, 1] = np.nan
    occ = rng.integers(0, 2, (h, w)).astype(bool)
    data = img0.tobytes() + img1.tobytes() + encode_flow_int16(disp).transpose(2, 0, 1).astype("<i2").tobytes()
    return encode_datum(8, h, w, data + encode_occlusion_bits(occ).tobytes(), label=label)


def _db_items(packing: str, n: int = 7):
    rng = np.random.default_rng(3)
    make = (lambda i: make_flow_datum(rng, 6, 8, label=i % 3)[0]) if packing == "flow" else (
        lambda i: make_disparity_datum(rng, 6, 8, label=i % 3))
    return [(b"%07d" % i, make(i)) for i in range(n)]


def _packing_kw(packing: str) -> dict:
    return {} if packing == "flow" else dict(slice_points=DISPARITY_SLICE_POINTS, encodings=DISPARITY_ENCODINGS)


def _assert_db_datasets_equal(ours, theirs, n: int) -> None:
    assert len(ours) == len(theirs) == n
    for i in range(n):
        assert_items_equal(ours[i], theirs[i])
    np.testing.assert_array_equal(ours.labels(), theirs.labels())
    for kw in (dict(seed=3, block_size=2), dict(seed=4, block_size=3, range_start=1, range_end=5),
               dict(preselection_label=1), dict(seed=2, order="first_range_then_permute", range_end=4)):
        np.testing.assert_array_equal(ours.permutation(**kw), theirs.permutation(**kw))


@pytest.mark.parametrize("packing", ["flow", "disparity"])
def test_lmdb_items_labels_and_permutations_match_jax(tmp_path, packing):
    """A reference-packed LMDB (written by the JAX tests' writer): items
    (BGR -> RGB, CHW -> HWC, the int16 decode), labels and the CustomData
    permutations equal the JAX dataset's."""
    path = str(tmp_path / "db")
    write_lmdb(path, _db_items(packing))
    kw = _packing_kw(packing)
    ours = LmdbFlowDataset(path, **kw)
    _assert_db_datasets_equal(ours, JaxLmdbFlowDataset(path, **kw), 7)
    assert ours[0]["flow"].shape == (6, 8, 1 if packing == "disparity" else 2)
    assert ours[0]["occ"].shape == (6, 8, 1)


@pytest.mark.parametrize("via", ["log", "table"])
@pytest.mark.parametrize("packing", ["flow", "disparity"])
def test_leveldb_items_labels_and_permutations_match_jax(tmp_path, packing, via):
    """The same over LevelDB, from the write-ahead log and from a
    snappy-compressed table."""
    path = str(tmp_path / "db")
    write_leveldb(path, _db_items(packing), via=via, compress=via == "table")
    kw = _packing_kw(packing)
    _assert_db_datasets_equal(LevelDBFlowDataset(path, **kw), JaxLevelDBFlowDataset(path, **kw), 7)


def test_open_dataset_sniffs_the_packed_formats(tmp_path):
    rec = str(tmp_path / "r.flowrec")
    _write_records(FlowRecordWriter, rec, _samples("flow", n=1))
    write_lmdb(str(tmp_path / "lmdb"), _db_items("flow", 2))
    write_leveldb(str(tmp_path / "leveldb"), _db_items("flow", 2))
    assert isinstance(open_dataset("auto", rec), FlowRecordReader)
    assert isinstance(open_dataset("auto", str(tmp_path / "lmdb")), LmdbFlowDataset)
    assert isinstance(open_dataset("auto", str(tmp_path / "lmdb" / "data.mdb")), LmdbFlowDataset)
    ds = open_dataset("auto", str(tmp_path / "leveldb"))
    assert isinstance(ds, LevelDBFlowDataset) and len(ds) == 2
    assert isinstance(open_dataset("LevelDB", str(tmp_path / "leveldb")), LevelDBFlowDataset)
    with pytest.raises(ValueError, match="cannot sniff"):
        open_dataset("auto", str(tmp_path))
    with pytest.raises(ValueError, match="unknown dataset 'middlebury'"):
        open_dataset("middlebury", str(tmp_path))


# -- layouts: ChairsSDHom, FlyingThings3D, KITTI ---------------------------------------------------


def _png(path, rng, h, w):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)


def test_chairssdhom_layout_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    base = tmp_path / "data" / "train"
    for k in range(3):
        _png(str(base / "t0" / f"{k:05d}.png"), rng, 8, 12)
        _png(str(base / "t1" / f"{k:05d}.png"), rng, 8, 12)
        os.makedirs(base / "flow", exist_ok=True)
        write_pfm(base / "flow" / f"{k:05d}.pfm", rng.normal(0, 3, (8, 12, 3)).astype(np.float32))
    ours, theirs = open_dataset("chairs_sdhom", str(tmp_path)), jax_datasets.ChairsSDHom(str(tmp_path))
    assert len(ours) == len(theirs) == len(ChairsSDHom(str(tmp_path))) == 3
    for i in range(3):
        assert_items_equal(ours[i], theirs[i])
        assert ours[i]["flow"].shape == (8, 12, 2)


@pytest.mark.parametrize("direction", ["into_future", "into_past"])
def test_flyingthings3d_layout_matches_jax(tmp_path, direction):
    rng = np.random.default_rng(6)
    for letter, scene in (("A", "0000"), ("B", "0007")):
        for num in range(6, 9):
            _png(str(tmp_path / "frames_cleanpass" / "TRAIN" / letter / scene / "left" / f"{num:04d}.png"), rng, 8, 12)
            d = tmp_path / "optical_flow" / "TRAIN" / letter / scene / direction
            os.makedirs(d, exist_ok=True)
            name = "Future" if direction == "into_future" else "Past"
            write_pfm(d / f"OpticalFlowInto{name}_{num:04d}_L.pfm", rng.normal(0, 3, (8, 12, 3)).astype(np.float32))
    ours = FlyingThings3D(str(tmp_path), direction=direction)
    theirs = jax_datasets.FlyingThings3D(str(tmp_path), direction=direction)
    assert len(ours) == len(theirs) == 4  # each scene's last (or first) frame has no partner
    for i in range(4):
        assert_items_equal(ours[i], theirs[i])


PNG_FILTERS = (0, 1, 2, 3, 4)


def encode_png16_rgb(arr: np.ndarray, filters=PNG_FILTERS) -> bytes:
    """A 16-bit RGB PNG of ``arr`` (uint16 (H, W, 3)), written here with zlib;
    row y takes filter ``filters[y % len(filters)]`` (None, Sub, Up, Average,
    Paeth), computed byte by byte as the PNG specification defines them."""
    h, w, _ = arr.shape
    raw_rows = [arr[y].astype(">u2").tobytes() for y in range(h)]
    bpp, out = 6, bytearray()
    for y, row in enumerate(raw_rows):
        prior = raw_rows[y - 1] if y else bytes(len(row))
        ftype = filters[y % len(filters)]
        line = bytearray([ftype])
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line.append((x - pred) % 256)
        out += line

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(
        b"IEND", b"")


def _kitti_png(rng, h=10, w=9):
    arr = rng.integers(0, 65536, (h, w, 3)).astype(np.uint16)
    arr[..., 2] = rng.integers(0, 2, (h, w))
    arr[0, 0] = [40000, 30000, 1]  # the pixel Pillow reads as (156, 117, 0)
    return arr


@pytest.mark.parametrize("filters", [PNG_FILTERS, (4,), (3,)], ids=["all-five", "paeth", "average"])
def test_kitti_flow_png_follows_the_devkit_formula(tmp_path, filters):
    """u, v = (value - 2^15) / 64 at all 16 bits, NaN where channel 2 is 0,
    across every row filter."""
    arr = _kitti_png(np.random.default_rng(len(filters)))
    path = tmp_path / "flow.png"
    path.write_bytes(encode_png16_rgb(arr, filters))
    np.testing.assert_array_equal(read_png16_rgb(path), arr)
    flow = read_kitti_flow(path)
    want = (arr[..., :2].astype(np.float64) - 32768) / 64
    valid = arr[..., 2] == 1
    np.testing.assert_array_equal(flow[valid], want[valid].astype(np.float32))
    assert np.isnan(flow[~valid]).all() and flow.dtype == np.float32
    assert flow[0, 0].tolist() == [(40000 - 32768) / 64, (30000 - 32768) / 64]


def test_kitti_png_reader_refuses_other_kinds(tmp_path):
    arr = _kitti_png(np.random.default_rng(1), 3, 4)
    good = encode_png16_rgb(arr)
    bad_crc = bytearray(good)
    bad_crc[45] ^= 0xFF  # inside the IDAT payload
    (tmp_path / "crc.png").write_bytes(bytes(bad_crc))
    with pytest.raises(ValueError, match="CRC"):
        read_png16_rgb(tmp_path / "crc.png")
    Image.fromarray(arr.astype(np.uint8)).save(tmp_path / "eight.png")
    with pytest.raises(ValueError, match="bit depth 8"):
        read_png16_rgb(tmp_path / "eight.png")
    (tmp_path / "no.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png16_rgb(tmp_path / "no.png")


def test_kitti_layout_reads_16_bit_flow(tmp_path):
    """The KITTI 2015 layout: 8-bit frames through read_image, the flow PNG at 16 bits."""
    rng = np.random.default_rng(9)
    flows = {}
    for key in ("000000", "000001"):
        for f in ("10", "11"):
            _png(str(tmp_path / "training" / "image_2" / f"{key}_{f}.png"), rng, 10, 9)
        flows[key] = _kitti_png(rng)
        os.makedirs(tmp_path / "training" / "flow_occ", exist_ok=True)
        (tmp_path / "training" / "flow_occ" / f"{key}_10.png").write_bytes(encode_png16_rgb(flows[key]))
    ds = open_dataset("kitti", str(tmp_path))
    assert len(ds) == len(KITTI(str(tmp_path))) == 2
    item = ds[1]
    np.testing.assert_array_equal(item["img0"], np.asarray(Image.open(
        tmp_path / "training" / "image_2" / "000001_10.png")).astype(np.float32))
    np.testing.assert_array_equal(item["flow"], read_kitti_flow(tmp_path / "training" / "flow_occ" / "000001_10.png"))
    assert np.isnan(item["flow"][flows["000001"][..., 2] == 0]).all()


# -- the loader -----------------------------------------------------------------------------


def test_batch_loader_over_lmdb_matches_jax(tmp_path):
    """Shuffle seed and block_size: the same batches as the JAX loader, in
    the same order, over two epochs, and then the iteration ends."""
    path = str(tmp_path / "db")
    write_lmdb(path, _db_items("flow", n=9))
    kw = dict(shuffle_seed=5, block_size=3, num_threads=1, epochs=2)
    ours = list(BatchLoader(LmdbFlowDataset(path), 2, **kw))
    theirs = list(JaxBatchLoader(JaxLmdbFlowDataset(path), 2, **kw))
    assert len(ours) == len(theirs) == 9  # 18 samples in batches of 2
    for a, b in zip(ours, theirs):
        assert_items_equal(a, b)
    first = LmdbFlowDataset(path).permutation(5, 3)[:2]
    np.testing.assert_array_equal(ours[0]["label"], [i % 3 for i in first])


def test_batch_loader_keeps_transport_dtypes_and_crops(tmp_path):
    path = str(tmp_path / "r.flowrec")
    _write_records(FlowRecordWriter, path, _samples("occlusion", n=4, h=10, w=14))
    batches = list(BatchLoader(FlowRecordReader(path, transport=True), 2, crop=(6, 8), shuffle_seed=None,
                               num_threads=2, epochs=1, prefetch=1))
    assert len(batches) == 2
    for b in batches:
        assert {k: (v.dtype, v.shape) for k, v in b.items()} == {
            "img0": (np.uint8, (2, 6, 8, 3)), "img1": (np.uint8, (2, 6, 8, 3)), "flow": (np.int16, (2, 6, 8, 2)),
            "occ": (np.uint8, (2, 6, 8, 1))}


# -- transport batches through the objectives ------------------------------------------------------


def _smooth_transport_batch(n, h, w, channels, seed):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(0.02, 0.06, (n, 1, 1, 3))
    img0 = (127.5 + 60 * np.sin(xs[None, ..., None] * f + ys[None, ..., None] * f[..., ::-1])).astype(np.uint8)
    flow = rng.uniform(-6, 6, (n, h, w, channels)).astype(np.float32)
    flow[:, :3, :5] = np.nan
    return {"img0": img0, "img1": np.roll(img0, 2, axis=2), "flow": encode_flow_int16(flow)}


def _float_form(batch):
    from flownet2_tpu_torch.core.codec import decode_flow_int16

    return {"img0": batch["img0"].astype(np.float32), "img1": batch["img1"].astype(np.float32),
            "flow": decode_flow_int16(batch["flow"])}


@pytest.mark.parametrize("model", ["flownetc", "dispnetc"])
def test_transport_batch_trains_to_the_float_batch_loss(model):
    """uint8 images and int16 flow (a transport .flowrec batch) give the loss
    of their float form: the flow decodes as value/32, SHRT_MAX as NaN (a
    plain cast would train on flows 32 times too large, with no invalid
    pixels)."""
    net = load_into(FlowNetC() if model == "flownetc" else DispNetC(), init_params(model, seed=1))
    batch = _smooth_transport_batch(2, 64, 128, 2 if model == "flownetc" else 1, seed=2)
    loss_fn = objectives.LOSSES[model]
    with torch.no_grad():
        got = loss_fn(net, {k: torch.from_numpy(v) for k, v in batch.items()})[0].item()
        want = loss_fn(net, {k: torch.from_numpy(v) for k, v in _float_form(batch).items()})[0].item()
        cast = loss_fn(net, {k: torch.from_numpy(v.astype(np.float32)) for k, v in batch.items()})[0].item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert abs(cast - want) > 0.1 * abs(want)


def test_transport_batch_loss_matches_jax_objective():
    """The same transport batch through the JAX objective, which decodes
    with flow_as_f32_device: loss rtol 1e-4."""
    flat = init_params("flownetc", seed=3)
    net = load_into(FlowNetC(), flat)
    batch = _smooth_transport_batch(2, 64, 128, 2, seed=4)
    with torch.no_grad():
        got = objectives.flownet_c_loss(net, {k: torch.from_numpy(v) for k, v in batch.items()})[0].item()
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = float(jax_objectives.flownet_c_loss(unflatten_params(flat), jax_batch)[0])
    np.testing.assert_allclose(got, want, rtol=1e-4)


# -- the CLIs --------------------------------------------------------------------------------


def _disparity_records(path, n=3, h=70, w=140, seed=7):
    rng = np.random.default_rng(seed)
    with FlowRecordWriter(path) as wr:
        for _ in range(n):
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            wr.write(img, np.roll(img, -3, axis=1), np.full((h, w), -3.0, np.float32))


def test_train_cli_trains_dispnetc_from_disparity_records(tmp_path, capsys):
    rec, snaps = str(tmp_path / "disp.flowrec"), tmp_path / "snaps"
    _disparity_records(rec)
    assert train_main(["--model", "dispnetc", "--dataset", "flowrec", "--data-root", rec, "--no-augment",
                       "--device", "cpu", "--batch", "2", "--crop", "64x128", "--max-iter", "2", "--display", "1",
                       "--snapshot-dir", str(snaps)]) == 0
    out = capsys.readouterr().out
    assert "Iteration 2, loss" in out and "dispnetc" in out
    assert (snaps / "iter_0000002.npz").exists() and (snaps / "iter_0000002.pt").exists()


def test_train_cli_trains_dispnetc_from_a_disparity_lmdb(tmp_path):
    rng = np.random.default_rng(8)
    path, snaps = str(tmp_path / "db"), tmp_path / "snaps"
    write_lmdb(path, [(b"%07d" % i, make_disparity_datum(rng, 64, 128, label=i)) for i in range(2)])
    assert train_main(["--model", "dispnetc", "--dataset", "lmdb", "--data-root", path, "--no-augment",
                       "--device", "cpu", "--batch", "1", "--crop", "64x128", "--max-iter", "1",
                       "--snapshot-dir", str(snaps)]) == 0
    assert (snaps / "iter_0000001.npz").exists()


def test_train_cli_refuses_ground_truth_the_model_does_not_learn(tmp_path):
    rec = str(tmp_path / "disp.flowrec")
    _disparity_records(rec, n=1)
    with pytest.raises(SystemExit, match="1-channel ground truth; --model flownetc trains on 2-channel flow"):
        train_main(["--model", "flownetc", "--dataset", "auto", "--data-root", rec, "--no-augment", "--device", "cpu"])
    flow_rec = str(tmp_path / "flow.flowrec")
    _write_records(FlowRecordWriter, flow_rec, _samples("flow", n=1))
    with pytest.raises(SystemExit, match="--model dispnetc trains on 1-channel disparity"):
        train_main(["--model", "dispnetc", "--dataset", "flowrec", "--data-root", flow_rec, "--no-augment",
                    "--device", "cpu"])


def _chairs_tree(root, n=3, h=12, w=16, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        write_ppm(os.path.join(root, f"{i:07d}-img0.ppm"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        write_ppm(os.path.join(root, f"{i:07d}-img1.ppm"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        flow = rng.normal(0, 3, (h, w, 2)).astype(np.float32)
        flow[0, :3] = np.nan
        write_flo(os.path.join(root, f"{i:07d}-gt.flo"), flow)


@pytest.mark.parametrize("source", ["listfile-flow", "listfile-disparity", "dataset"])
def test_convert_dataset_output_equals_jax(tmp_path, source):
    root = str(tmp_path / "chairs")
    os.makedirs(root)
    _chairs_tree(root)
    if source == "dataset":
        args = ["--dataset", "flyingchairs", "--data-root", root]
    else:
        rng = np.random.default_rng(2)
        lines = []
        for i in range(3):
            a, b = (os.path.join(root, f"{i:07d}-img{k}.ppm") for k in (0, 1))
            if source == "listfile-flow":
                occ = os.path.join(root, f"{i:07d}-occ.ppm")
                write_ppm(occ, rng.integers(0, 256, (12, 16), dtype=np.uint8))
                lines.append(f"{a} {b} {os.path.join(root, f'{i:07d}-gt.flo')} {occ}")
            else:
                disp = os.path.join(root, f"{i:07d}-disp.pfm")
                write_pfm(disp, rng.uniform(-20, 0, (12, 16)).astype(np.float32))
                lines.append(f"{a} {b} {disp}")
        listfile = tmp_path / "list.txt"
        listfile.write_text("\n".join(lines) + "\n\n")
        args = ["--listfile", str(listfile)]
    ours, theirs = str(tmp_path / "ours.flowrec"), str(tmp_path / "theirs.flowrec")
    assert convert([ours, *args]) == 0
    assert jax_convert([theirs, *args]) == 0
    for ext in ("", ".idx"):
        assert open(ours + ext, "rb").read() == open(theirs + ext, "rb").read()
    item = FlowRecordReader(ours)[0]
    assert item["flow"].shape == (12, 16, 1 if source == "listfile-disparity" else 2)
    assert ("occ" in item) == (source == "listfile-flow")
