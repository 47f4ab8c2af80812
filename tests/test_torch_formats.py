"""The port's weight and file formats against the JAX package's, on the CPU.

Caffe weights of the standalone nets: the inputs are built by the JAX
tests' independent protobuf wire encoder (tests/test_import_caffe.py) and
by the JAX exporter, from the port's seeded weights; the port's importer
must give arrays equal to the JAX importer's, and load into the port's net,
or refuse with the keys that do not fit. The port's exporter must write the
JAX exporter's bytes. Then the HDF5 subset, the int16 flow codec and PFM,
byte for byte and value for value, and the train CLI on Caffe weights.
FlowNet2's merged weights: tests/test_torch_caffe_flownet2.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flownet2_tpu.core import codec as jax_codec
from flownet2_tpu.core import flow_io as jax_flow_io
from flownet2_tpu.core import hdf5_lite as jax_hdf5
from flownet2_tpu.models import export_caffe as jax_export
from flownet2_tpu.models import import_caffe as jax_import
from flownet2_tpu_torch.checkpoint import flatten_params, init_params, load_into
from flownet2_tpu_torch.cli.run_flownet import main as run_flownet
from flownet2_tpu_torch.cli.train import main as train_main
from flownet2_tpu_torch.core import codec, flow_io, hdf5_lite
from flownet2_tpu_torch.core.flow_io import write_flo, write_ppm
from flownet2_tpu_torch.models import NETS, export_caffe, import_caffe
from test_import_caffe import _len_field, encode_layer

torch.set_num_threads(2)  # the suite runs several workers side by side

SINGLE_NETS = ("flownets", "flownetc", "flownet2-sd")
SINGLE_NET_BGR = {"flownets": {"conv1": 2}, "flownetc": {"conv1": 1}, "flownet2-sd": {"conv0": 2}}


def nested(flat: dict) -> dict:
    """``a/b/w`` keys -> {"a": {"b": {"w": ...}}}."""
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def assert_trees_equal(a: dict, b: dict, skip=()) -> None:
    """Same keys, arrays equal in value, shape and dtype (keys in ``skip``: shape and dtype)."""
    fa, fb = flatten_params(a), flatten_params(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype == np.float32 and fa[k].shape == fb[k].shape, k
        if k not in skip:
            assert np.array_equal(fa[k], fb[k]), k


def wire_encoded(params: dict) -> bytes:
    """A NetParameter of the caffe-layout blobs of flat JAX-layout ``params``
    (biases moved off zero), layer by layer from the JAX tests' wire encoder,
    with a blob-less layer among them: ``encode_net``'s bytes, joined once."""
    layers = [encode_layer("relu1", "ReLU", [])]
    for name, p in nested(params).items():
        kind = "Deconvolution" if "deconv" in name or "upsample_flow" in name else "Convolution"
        layers.append(encode_layer(name, kind, [p["w"].transpose(3, 2, 0, 1), p["b"] + 0.5]))
    return b"".join([_len_field(1, b"testnet"), *(_len_field(100, layer) for layer in layers)])


# -- Caffe import ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", SINGLE_NETS)
def test_single_net_import_matches_jax(tmp_path, model):
    """A standalone net's .caffemodel: the port's import equals the JAX
    importer's array for array, loads into the port's net, and comes back
    from the exporter with the same flips undone. FlowNet2-SD's conv1 is
    the exception: the JAX importer flips the first three of its 64 input
    channels as if they were an image's, which they are not; the port flips
    only conv0, the layer that sees the frames."""
    params = init_params(model, seed=3)
    path = str(tmp_path / "w.caffemodel")
    with open(path, "wb") as f:
        f.write(wire_encoded(params))
    ours = import_caffe.import_caffemodel(path, model)
    theirs = jax_import.import_caffemodel(path, model)
    assert_trees_equal(ours, theirs, skip=("conv1/w",) if model == "flownet2-sd" else ())
    if model == "flownet2-sd":
        np.testing.assert_array_equal(ours["conv1"]["w"], theirs["conv1"]["w"][:, :, [2, 1, 0, *range(3, 64)]])
    with torch.device("meta"):
        net = NETS[model]()
    load_into(net, ours)
    export_caffe.export_caffemodel(nested(params), path, bgr_slots=SINGLE_NET_BGR[model])
    assert_trees_equal(import_caffe.import_caffemodel(path, model), nested(params))


def test_standalone_h5_import_matches_jax(tmp_path):
    params = init_params("flownetc", seed=5)
    path = str(tmp_path / "FlowNet2-C.caffemodel.h5")
    jax_export.export_caffemodel_h5(nested(params), path, bgr_slots={"conv1": 1})
    ours = import_caffe.import_caffemodel(path, "flownetc")
    assert_trees_equal(ours, jax_import.import_caffemodel(path, "flownetc"))
    assert_trees_equal(ours, nested(params))


@pytest.mark.parametrize("slots", [1, 2])
def test_bgr_flip_matches_jax(slots):
    """Input-facing weights: each 3-channel image slot's channels reversed,
    as the JAX importer reverses them."""
    w = np.arange(4 * 3 * slots * 3 * 3, dtype=np.float32).reshape(4, 3 * slots, 3, 3)
    raw = _len_field(100, encode_layer("conv1", "Convolution", [w, np.ones(4, np.float32)]))
    ours = import_caffe.layers_to_params(import_caffe.parse_caffemodel(raw), bgr_slots={"conv1": slots})
    theirs = jax_import.layers_to_params(jax_import.parse_caffemodel(raw), bgr_slots={"conv1": slots})
    assert_trees_equal(ours, theirs)
    flipped = np.concatenate([w[:, 3 * s : 3 * s + 3][:, ::-1] for s in range(slots)], axis=1)
    np.testing.assert_array_equal(ours["conv1"]["w"], flipped.transpose(2, 3, 1, 0))


def test_dispnetc_import_is_refused_with_the_missing_keys(tmp_path):
    """The JAX importer files DispNetC's layers under flownetc/ (every name
    outside its single-net list is a cascade); those cannot load into the
    port's DispNetC, so the port refuses and names what is missing."""
    params = init_params("dispnetc", seed=6)
    path = str(tmp_path / "DispNetC.caffemodel")
    export_caffe.export_caffemodel(nested(params), path)
    theirs = jax_import.import_caffemodel(path, "dispnetc")
    assert sorted(flatten_params(theirs)) == sorted(f"flownetc/{k}" for k in params)
    with pytest.raises(ValueError, match=r"do not fit the dispnetc net: \d+ missing: .*conv1/w"):
        import_caffe.import_caffemodel(path, "dispnetc")
    with pytest.raises(SystemExit, match="unexpected: flownetc/"):
        run_flownet([path, "dispnetc", path, path, str(tmp_path / "out.flo"), "--device", "cpu"])


def test_import_refuses_a_misshapen_layer(tmp_path):
    params = init_params("flownets", seed=7)
    params["conv2/b"] = np.zeros(7, np.float32)
    path = str(tmp_path / "w.caffemodel")
    export_caffe.export_caffemodel(nested(params), path)
    with pytest.raises(ValueError, match=r"1 of another shape: conv2/b \(7,\) \(net \(128,\)\)"):
        import_caffe.import_caffemodel(path, "flownets")


# -- Caffe export ---------------------------------------------------------------------------


def _small_cascade(seed: int) -> dict:
    """A few layers of each FlowNet2 subnet, narrow (the exporter takes any tree)."""
    rng = np.random.default_rng(seed)

    def layer(cin, cout, k=3, deconv=False):
        shape = (k, k, cout, cin) if deconv else (k, k, cin, cout)
        return {"w": rng.standard_normal(shape).astype(np.float32), "b": rng.standard_normal(cout).astype(np.float32)}

    return {
        "flownetc": {"conv1": layer(3, 4, 7), "conv_redir": layer(4, 2, 1), "deconv5": layer(6, 2, 4, True),
                     "upsample_flow6to5": layer(2, 2, 4, True)},
        "flownets_1": {"conv1": layer(12, 4), "predict_flow6": layer(4, 2)},
        "flownets_2": {"conv1": layer(12, 4)},
        "flownetsd": {"conv0": layer(6, 4), "conv1": layer(4, 4)},
        "fusion": {"conv0": layer(11, 4), "upsample_flow1to0": layer(2, 2, 4, True)},
    }


@pytest.mark.parametrize("form", ["binaryproto", "h5", "merged", "merged-h5"])
def test_export_bytes_equal_jax(form):
    params = _small_cascade(8)
    if form.startswith("merged"):
        fn = "export_caffemodel_merged_h5" if form == "merged-h5" else "export_caffemodel_merged"
        ours, theirs = getattr(export_caffe, fn)(params), getattr(jax_export, fn)(params)
    else:
        fn = "export_caffemodel_h5" if form == "h5" else "export_caffemodel"
        ours = getattr(export_caffe, fn)(params["flownetc"], bgr_slots={"conv1": 1})
        theirs = getattr(jax_export, fn)(params["flownetc"], bgr_slots={"conv1": 1})
    assert isinstance(ours, bytes) and ours == theirs


# -- HDF5 -----------------------------------------------------------------------------------


def _hdf5_tree(rng):
    return {
        "data": {
            "conv1": {"0": rng.standard_normal((4, 3, 3, 3)).astype(np.float32), "1": np.arange(4, dtype=np.float32)},
            "deep": {"inner": {"x": rng.standard_normal((2, 5)), "i": np.arange(6, dtype="<i4").reshape(2, 3)}},
        },
        "bytes": rng.integers(0, 255, 17).astype(np.uint8),
    }


def _assert_hdf5_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_hdf5_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_hdf5_round_trips_between_the_packages(rng, writer):
    """Each package reads what the other writes; the two writers' bytes are equal."""
    tree = _hdf5_tree(rng)
    ours, theirs = hdf5_lite.write_hdf5(None, tree), jax_hdf5.write_hdf5(None, tree)
    assert ours == theirs
    raw = ours if writer == "port" else theirs
    _assert_hdf5_equal(hdf5_lite.read_hdf5(raw), jax_hdf5.read_hdf5(raw))
    _assert_hdf5_equal(hdf5_lite.read_hdf5(raw), {k: v for k, v in tree.items()})


def test_hdf5_rejects_what_it_does_not_read():
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5_lite.read_hdf5(b"\x00" * 64)
    raw = bytearray(hdf5_lite.write_hdf5(None, {"a": np.zeros(3, np.float32)}))
    raw[8] = 2  # superblock version 2
    with pytest.raises(NotImplementedError, match="superblock version 2"):
        hdf5_lite.read_hdf5(bytes(raw))


# -- the int16 flow codec and PFM -------------------------------------------------------------


def _codec_flow(rng):
    flow = rng.uniform(-2000, 2000, (6, 7, 2)).astype(np.float32)
    flow[0, 0] = np.nan
    flow[0, 1] = [np.inf, -np.inf]
    flow[1, 0] = [1023.99, -1024.5]  # saturate at 32766 / -32768
    flow[1, 1] = [1e9, -1e9]
    flow[2, 0] = [0.015625, -0.015625]  # exactly half a step: round half to even
    return flow


def test_codec_encode_decode_match_jax(rng):
    flow = _codec_flow(rng)
    enc = codec.encode_flow_int16(flow)
    np.testing.assert_array_equal(enc, jax_codec.encode_flow_int16(flow))
    assert enc.dtype == np.int16
    assert enc[0, 0].tolist() == [32767, 32767] and enc[0, 1].tolist() == [32767, 32767]
    assert enc[1, 0].tolist() == [32766, -32768] and enc[1, 1].tolist() == [32766, -32768]
    dec = codec.decode_flow_int16(enc)
    np.testing.assert_array_equal(dec, jax_codec.decode_flow_int16(enc))
    assert np.isnan(dec[0, :2]).all()


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32, torch.bfloat16])
def test_flow_as_f32_equals_numpy_decode(rng, dtype):
    """int16 decodes as value/32 with SHRT_MAX -> NaN, exactly numpy's
    decode; a floating tensor is cast to float32."""
    enc = codec.encode_flow_int16(_codec_flow(rng))
    enc[3, 3] = [-32768, 32766]
    if dtype == torch.int16:
        got, want = codec.flow_as_f32(torch.from_numpy(enc)), codec.decode_flow_int16(enc)
    else:
        t = torch.from_numpy(enc.astype(np.float32) / 7).to(dtype)
        got, want = codec.flow_as_f32(t), t.float().numpy()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_occlusion_bits_match_jax(rng):
    occ = rng.integers(0, 2, (5, 11)).astype(bool)
    bits = codec.encode_occlusion_bits(occ)
    np.testing.assert_array_equal(bits, jax_codec.encode_occlusion_bits(occ))
    np.testing.assert_array_equal(codec.decode_occlusion_bits(bits, (5, 11)), occ)


@pytest.mark.parametrize("channels", [1, 3])
def test_pfm_matches_jax_byte_for_byte(tmp_path, rng, channels):
    img = rng.standard_normal((5, 7, channels)).astype(np.float32)
    ours, theirs = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    flow_io.write_pfm(ours, img, scale=2.0)
    jax_flow_io.write_pfm(theirs, img, scale=2.0)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    got, scale = flow_io.read_pfm(theirs)
    np.testing.assert_array_equal(got, img)
    assert scale == 2.0
    # a big-endian file (positive scale) reads the same
    with open(tmp_path / "be.pfm", "wb") as f:
        f.write((b"PF\n" if channels == 3 else b"Pf\n") + b"7 5\n1.0\n")
        img[::-1].astype(">f4").tofile(f)
    big_endian = flow_io.read_pfm(tmp_path / "be.pfm")[0]
    np.testing.assert_array_equal(big_endian, jax_flow_io.read_pfm(tmp_path / "be.pfm")[0])
    np.testing.assert_array_equal(big_endian, img)


# -- the CLIs on Caffe weights ----------------------------------------------------------------


def test_train_cli_finetunes_from_a_caffemodel(tmp_path):
    """--weights takes a .caffemodel: the copied weights are the ones the
    first step starts from (a zero learning rate keeps them)."""
    data = tmp_path / "chairs"
    data.mkdir()
    rng = np.random.default_rng(11)
    for i in range(2):
        for k in (0, 1):
            write_ppm(data / f"{i:07d}-img{k}.ppm", rng.integers(0, 256, (64, 128, 3), dtype=np.uint8))
        write_flo(data / f"{i:07d}-gt.flo", rng.normal(0, 3, (64, 128, 2)).astype(np.float32))
    params = init_params("flownetc", seed=11)
    path = str(tmp_path / "FlowNet2-C.caffemodel")
    export_caffe.export_caffemodel(nested(params), path, bgr_slots=SINGLE_NET_BGR["flownetc"])
    snaps = tmp_path / "snaps"
    assert train_main(["--model", "flownetc", "--dataset", "flyingchairs", "--data-root", str(data), "--no-augment",
                       "--batch", "1", "--crop", "64x128", "--max-iter", "1", "--base-lr", "0", "--device", "cpu",
                       "--snapshot-dir", str(snaps), "--weights", path]) == 0
    with np.load(snaps / "iter_0000001.npz") as z:
        for k, v in params.items():
            assert np.array_equal(z[k], v), k


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
import numpy as np
from flownet2_tpu_torch.cli import convert_dataset, run_flownet, train
from flownet2_tpu_torch.core import codec, flow_io, hdf5_lite
from flownet2_tpu_torch.data import leveldb, lmdb, records
from flownet2_tpu_torch.models import export_caffe, import_caffe

tree = {"conv1": {"w": np.ones((3, 3, 3, 2), np.float32), "b": np.zeros(2, np.float32)}}
for raw in (export_caffe.export_caffemodel(tree), export_caffe.export_caffemodel_h5(tree)):
    layers = (import_caffe.parse_caffemodel_h5 if raw[:4] == b"\\x89HDF" else import_caffe.parse_caffemodel)(raw)
    assert [l.name for l in layers] == ["conv1"]
out = sys.argv[1]
img = np.zeros((4, 6, 3), np.uint8)
with records.FlowRecordWriter(out) as w:
    w.write(img, img, np.zeros((4, 6, 2), np.float32))
assert records.FlowRecordReader(out, transport=True)[0]["flow"].dtype == np.int16
assert not [m for m in sys.modules if blocked(m)]
with open("/proc/self/maps") as maps:
    assert "libflowdata" not in maps.read()
print("ran without jax")
"""


def test_formats_run_without_jax(tmp_path):
    """The new modules import neither jax nor the JAX package, and the
    record path loads no native library: a subprocess that refuses to import
    either exports and parses Caffe weights and writes and reads a record."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path / "r.flowrec")], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ran without jax" in proc.stdout
