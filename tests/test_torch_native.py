"""The port's native data-path library (``flownet2_tpu_torch/native/flowdata.cc``
through ``data/native.py``) against the JAX package's numpy decoders, on the
CPU: the flow codec, the occlusion bits, netpbm, ``.flo`` and whole
``.flowrec`` records, all exact (max abs 0, the same NaN pattern); the JAX
package's ``ValueError`` messages on malformed input; the build (digest-named,
locked, renamed into place; a failed build raises the compiler's output).

The JAX reader is held to its numpy route: its own native library is never
built here (its ``get_lib`` is replaced), and where its Python wrappers are
compared they call the port's library, whose C ABI is the same.
"""

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import flownet2_tpu.data.native as jax_native
from flownet2_tpu.core import codec as jax_codec
from flownet2_tpu.core.flow_io import read_flo as jax_read_flo, read_ppm as jax_read_ppm
from flownet2_tpu.core.flow_io import write_flo as jax_write_flo, write_ppm as jax_write_ppm
from flownet2_tpu.data import FlowRecordReader as JaxFlowRecordReader
from flownet2_tpu_torch.data import FlowRecordReader, FlowRecordWriter, native
from flownet2_tpu_torch.data.records import decode_body

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_numpy_route(monkeypatch):
    """The JAX package's readers on their numpy route: its native library
    reported unavailable, so nothing of it is built."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)


@pytest.fixture
def jax_wrappers_on_port_lib(monkeypatch):
    """The JAX package's Python wrappers calling the port's library."""
    lib = native.get_lib()
    monkeypatch.setattr(jax_native, "get_lib", lambda: lib)


def assert_exact(got: np.ndarray, want: np.ndarray) -> None:
    """Same dtype and shape, max abs 0, NaN where the reference has NaN."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)


def test_library_is_built_from_the_ports_source_into_build():
    lib = native.get_lib()
    assert lib.fd_version() == 2
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR == Path(REPO, "build", "flownet2_tpu_torch")
    assert native.SOURCE == Path(REPO, "flownet2_tpu_torch", "native", "flowdata.cc")


# -- the entry points against the numpy decoders ---------------------------------------


def _flow_values(rng, shape):
    """Flow with NaN, inf, -inf, values beyond float's range once scaled,
    saturating values and exact ties of the 1/32 grid (half to even)."""
    flow = rng.uniform(-1200, 1200, shape).astype(np.float32)
    flat = flow.reshape(-1)
    special = [np.nan, np.inf, -np.inf, 3e38, -3e38, 1e37, 0.5 / 32, 1.5 / 32, 2.5 / 32, -0.5 / 32, -2.5 / 32,
               1023.984375, -1024.0, 1024.0, 0.0, -0.0]
    flat[: len(special)] = special
    return flow


@pytest.mark.parametrize("shape", [(13, 17, 2), (6, 8, 1), (4, 5)])
def test_flow_codec_matches_numpy(shape):
    flow = _flow_values(np.random.default_rng(1), shape)
    enc = native.encode_flow_i16(flow)
    assert_exact(enc, jax_codec.encode_flow_int16(flow))
    assert_exact(native.decode_flow_i16(enc), jax_codec.decode_flow_int16(enc))
    every = np.arange(-32768, 32768, dtype=np.int16)  # each int16, the sentinel included
    assert_exact(native.decode_flow_i16(every), jax_codec.decode_flow_int16(every))


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (8, 10), (7, 9)])
def test_unpack_bits_matches_numpy(hw):
    """``fd_unpack_bits`` (whole bytes, then the tail) through its C ABI."""
    occ = np.random.default_rng(2).integers(0, 2, hw).astype(bool)
    bits = jax_codec.encode_occlusion_bits(occ)
    out = np.empty(hw, np.float32)
    native.get_lib().fd_unpack_bits(bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
    assert_exact(out, jax_codec.decode_occlusion_bits(bits, hw).astype(np.float32))


@pytest.mark.parametrize("channels", [3, 1])
def test_decode_pnm_matches_jax_read_ppm(tmp_path, channels):
    img = np.random.default_rng(3).integers(0, 256, (9, 11, channels), dtype=np.uint8)
    path = tmp_path / "x.ppm"
    jax_write_ppm(path, img)
    assert_exact(native.decode_pnm(path.read_bytes()), jax_read_ppm(path))
    commented = tmp_path / "c.ppm"  # a comment in the header, as the JAX reader skips it
    commented.write_bytes(b"P6\n# a comment\n2 2\n255\n" + bytes(range(12)))
    assert_exact(native.decode_pnm(commented.read_bytes()), jax_read_ppm(commented))


def test_read_flo_matches_jax_read_flo(tmp_path):
    flow = np.random.default_rng(4).standard_normal((7, 9, 2)).astype(np.float32)
    flow[0, 0] = np.nan
    path = tmp_path / "x.flo"
    jax_write_flo(path, flow)
    assert_exact(native.read_flo(path.read_bytes()), jax_read_flo(path))


def _write_records(path, kind: str, n: int = 3, h: int = 6, w: int = 10):
    rng = np.random.default_rng({"flow": 5, "disparity": 6, "occlusion": 7}[kind])
    with FlowRecordWriter(path) as wr:
        for _ in range(n):
            img0 = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            img1 = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            if kind == "disparity":
                flow = rng.uniform(-60, 0, (h, w)).astype(np.float32)
            else:
                flow = rng.uniform(-40, 40, (h, w, 2)).astype(np.float32)
            flow.reshape(-1)[rng.random(flow.size) < 0.1] = np.nan
            occ = rng.integers(0, 2, (h, w)).astype(bool) if kind == "occlusion" else None
            wr.write(img0, img1, flow, occ)


@pytest.mark.parametrize("kind", ["flow", "disparity", "occlusion"])
def test_float_records_match_the_jax_reader(tmp_path, jax_numpy_route, kind):
    """FlowRecordReader(transport=False) decodes natively; every item equals
    the JAX reader's numpy decode and the port's own numpy plain version."""
    path = str(tmp_path / f"{kind}.flowrec")
    _write_records(path, kind)
    ours, theirs = FlowRecordReader(path), JaxFlowRecordReader(path)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys() == ({"img0", "img1", "flow", "occ"} if kind == "occlusion" else
                                        {"img0", "img1", "flow"})
        assert a["flow"].shape[-1] == (1 if kind == "disparity" else 2)
        assert np.isnan(a["flow"]).any()
        plain = decode_body(ours.body(i), transport=False)
        for k in a:
            assert_exact(a[k], b[k])
            assert_exact(a[k], plain[k])


def test_float_items_go_through_the_native_decoder_and_transport_items_do_not(tmp_path, monkeypatch):
    path = str(tmp_path / "r.flowrec")
    _write_records(path, "occlusion", n=1)
    calls = []
    decode = native.decode_record
    monkeypatch.setattr(native, "decode_record", lambda body: calls.append(len(body)) or decode(body))
    FlowRecordReader(path)[0]
    transport = FlowRecordReader(path, transport=True)[0]
    assert len(calls) == 1
    assert transport["img0"].dtype == np.uint8 and transport["flow"].dtype == np.int16
    assert transport["occ"].dtype == np.uint8


# -- malformed input: the JAX package's ValueErrors -------------------------------------


_MALFORMED = {
    "pnm bad magic": ("decode_pnm", b"Q6\n2 2\n255\n" + bytes(12)),
    "pnm P3": ("decode_pnm", b"P3\n2 2\n255\n" + bytes(12)),
    "pnm missing maxval": ("decode_pnm", b"P6\n2 2\n"),
    "pnm maxval 65535": ("decode_pnm", b"P6\n2 2\n65535\n" + bytes(24)),
    "pnm truncated": ("decode_pnm", b"P6\n2 2\n255\n" + bytes(11)),
    "pnm empty": ("decode_pnm", b""),
    "flo bad magic": ("read_flo", b"PIEX" + np.int32([2, 2]).tobytes() + bytes(32)),
    "flo zero width": ("read_flo", b"PIEH" + np.int32([0, 2]).tobytes()),
    "flo truncated": ("read_flo", b"PIEH" + np.int32([2, 2]).tobytes() + bytes(31)),
    "record short header": ("decode_record", np.uint32([2, 2]).tobytes()),
    "record truncated": ("decode_record", np.uint32([2, 2, 0]).tobytes() + bytes(4 * 6 + 4 * 2 * 2 - 1)),
    "record occlusion bits missing": ("decode_record", np.uint32([2, 2, 1]).tobytes() + bytes(4 * 6 + 4 * 2 * 2)),
}


@pytest.mark.parametrize("case", list(_MALFORMED))
def test_malformed_buffers_raise_the_jax_packages_errors(jax_wrappers_on_port_lib, case):
    name, buf = _MALFORMED[case]
    with pytest.raises(ValueError) as theirs:
        getattr(jax_native, name)(buf)
    with pytest.raises(ValueError) as ours:
        getattr(native, name)(buf)
    assert str(ours.value) == str(theirs.value)
    assert str(ours.value).startswith(f"fd_{name} ")


def test_a_truncated_record_file_raises_the_jax_readers_error(tmp_path, jax_wrappers_on_port_lib):
    path = str(tmp_path / "t.flowrec")
    _write_records(path, "flow", n=2)
    os.truncate(path, os.path.getsize(path) - 5)  # the last record's body loses 5 bytes
    ours, theirs = FlowRecordReader(path), JaxFlowRecordReader(path)
    assert_exact(ours[0]["flow"], theirs[0]["flow"])
    with pytest.raises(ValueError) as want:
        theirs[1]
    with pytest.raises(ValueError) as got:
        ours[1]
    assert str(got.value) == str(want.value) == f"{path}[1]: fd_decode_record header failed: -2"


# -- the build -------------------------------------------------------------------------------


_LOAD = """
import sys
from flownet2_tpu_torch.data import native
lib = native.get_lib(sys.argv[1])
print(lib.fd_version(), native.library_path(sys.argv[1]).name)
"""


def test_two_processes_building_into_an_empty_directory_both_load(tmp_path):
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, str(build_dir)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["2", native.library_path(build_dir).name]
    assert sorted(os.listdir(build_dir)) == sorted([native.library_path(build_dir).name,
                                                    native.library_path(build_dir).with_suffix(".lock").name])


def test_threads_loading_at_once_get_one_library(tmp_path):
    build_dir = tmp_path / "build"
    libs = [None] * 4

    def load(i):
        libs[i] = native.get_lib(build_dir)

    threads = [threading.Thread(target=load, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert all(lib is libs[0] for lib in libs) and libs[0].fd_version() == 2


def test_a_failed_build_raises_the_compilers_error(tmp_path, monkeypatch):
    bad = tmp_path / "flowdata.cc"
    bad.write_text("int fd_version() { return this_is_not_declared; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*this_is_not_declared"):
        native.get_lib()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [native.library_path().with_suffix(".lock").name]
    path = str(tmp_path / "r.flowrec")
    _write_records(path, "flow", n=1)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):  # no numpy fallback
        FlowRecordReader(path)[0]


def test_a_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.get_lib()


def test_the_build_writes_nothing_under_cpp(tmp_path, monkeypatch):
    """The compiler reads the port's source and writes into the build
    directory alone; no argument names the JAX package's ``cpp/``."""
    commands = []
    run = subprocess.run

    def recording_run(cmd, *args, **kwargs):
        commands.append(list(cmd))
        return run(cmd, *args, **kwargs)

    monkeypatch.setattr(native.subprocess, "run", recording_run)
    build_dir = tmp_path / "build"
    lib = native.build(build_dir)
    assert len(commands) == 1 and commands[0][0] == "g++"
    cpp = os.path.join(REPO, "cpp")
    assert not [a for a in commands[0] if os.path.abspath(a).startswith(cpp + os.sep)]
    assert str(native.SOURCE) in commands[0]
    assert lib.parent == build_dir and sorted(p.name for p in build_dir.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".lock").name])
    assert native.build(build_dir) == lib and len(commands) == 1  # built once
