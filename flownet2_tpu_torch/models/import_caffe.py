"""Import reference ``.caffemodel`` / ``.caffemodel.h5`` weights (the port's
copy of flownet2_tpu/models/import_caffe.py).

The result is the JAX package's parameter layout, array for array the JAX
importer's, which ``checkpoint.load_into`` and ``Solver.copy_weights_from``
then load. The reference serializes ``NetParameter`` protobufs (weights as
per-layer ``BlobProto`` float arrays; net.cpp:752-885). Rather than depending on
protobuf codegen, this module implements a minimal clean-room decoder for
the protobuf *wire format* (varint/length-delimited framing — a public,
stable spec) and extracts just the fields the importer needs, identified by
their field numbers in src/caffe/proto/caffe.proto:

  NetParameter:   name=1 (string), layer=100 (LayerParameter, v2),
                  layers=2 (V1LayerParameter, legacy)
  LayerParameter: name=1 (string), type=2 (string), blobs=7 (BlobProto)
  V1LayerParameter: name=4, type=5 (enum), blobs=6
  BlobProto:      shape=7 (BlobShape: dim=1 repeated int64), data=5
                  (repeated/packed float), num=1 channels=2 height=3 width=4
                  (legacy 4-D dims), double_data=9

Weight-layout conversions to the JAX layout:
  conv    OIHW → HWIO  (reference blobs are (out, in, kh, kw))
  deconv  OIHW → HWOI' : a Caffe deconv blob is (bottom_c, top_c, kh, kw);
          the JAX deconv2d takes (kh, kw, Cout, Cin)=(kh, kw, top_c, bottom_c)
  bias    (out,) unchanged
  BGR → RGB: the reference CLI feeds BGR images (run-flownet.py:32); the
          port feeds RGB, so input-facing conv weights get their input
          channels flipped per 3-channel image slot.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Minimal protobuf wire decoding
# ---------------------------------------------------------------------------

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def iter_fields(buf: memoryview) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wtype == _WIRE_I64:
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == _WIRE_I32:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype} for field {fnum}")
        yield fnum, wtype, val


def _floats(wtype: int, val) -> np.ndarray:
    """Decode a repeated-float field occurrence (packed or single)."""
    if wtype == _WIRE_LEN:
        return np.frombuffer(bytes(val), "<f4")
    if wtype == _WIRE_I32:
        return np.frombuffer(bytes(val), "<f4")
    raise ValueError("unexpected wire type for float field")


def _varints(wtype: int, val) -> list[int]:
    if wtype == _WIRE_VARINT:
        return [val]
    out = []
    mv = memoryview(val)
    pos = 0
    while pos < len(mv):
        v, pos = _read_varint(mv, pos)
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# Caffe message extraction
# ---------------------------------------------------------------------------


@dataclass
class CaffeBlob:
    shape: tuple[int, ...]
    data: np.ndarray


@dataclass
class CaffeLayer:
    name: str
    type: str
    blobs: list = field(default_factory=list)


def _parse_blob(buf: memoryview) -> CaffeBlob:
    data_parts: list[np.ndarray] = []
    dims: list[int] = []
    legacy = {1: 0, 2: 0, 3: 0, 4: 0}
    has_legacy = False
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 5:  # data (packed float)
            data_parts.append(_floats(wtype, val))
        elif fnum == 9:  # double_data
            data_parts.append(np.frombuffer(bytes(val), "<f8").astype(np.float32))
        elif fnum == 7:  # shape: BlobShape { repeated int64 dim = 1 }
            for f2, w2, v2 in iter_fields(val):
                if f2 == 1:
                    dims.extend(_varints(w2, v2))
        elif fnum in legacy and wtype == _WIRE_VARINT:
            legacy[fnum] = val
            has_legacy = True
    data = np.concatenate(data_parts) if data_parts else np.zeros((0,), np.float32)
    if dims:
        shape = tuple(int(d) for d in dims)
    elif has_legacy:
        shape = (legacy[1], legacy[2], legacy[3], legacy[4])
    else:
        shape = (data.size,)
    return CaffeBlob(shape=shape, data=data)


def _parse_string(val) -> str:
    return bytes(val).decode("utf-8")


def _parse_layer_v2(buf: memoryview) -> CaffeLayer:
    layer = CaffeLayer(name="", type="")
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 1:
            layer.name = _parse_string(val)
        elif fnum == 2:
            layer.type = _parse_string(val)
        elif fnum == 7:
            layer.blobs.append(_parse_blob(val))
    return layer


# V1LayerParameter LayerType enum values we care about
_V1_TYPES = {4: "Convolution", 39: "Deconvolution", 14: "InnerProduct"}


def _parse_layer_v1(buf: memoryview) -> CaffeLayer:
    layer = CaffeLayer(name="", type="")
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 4:
            layer.name = _parse_string(val)
        elif fnum == 5:
            layer.type = _V1_TYPES.get(val, str(val))
        elif fnum == 6:
            layer.blobs.append(_parse_blob(val))
    return layer


def parse_caffemodel(path_or_bytes) -> list[CaffeLayer]:
    """Parse a binaryproto NetParameter → list of layers carrying blobs."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()
    layers = []
    for fnum, wtype, val in iter_fields(memoryview(raw)):
        if fnum == 100:  # layer (v2)
            layers.append(_parse_layer_v2(val))
        elif fnum == 2 and wtype == _WIRE_LEN:  # layers (v1)
            try:
                layers.append(_parse_layer_v1(val))
            except ValueError:
                pass  # field 2 is also the (string) legacy name in some protos
    return [l for l in layers if l.blobs]


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------


def convert_conv_blob(blob: CaffeBlob, *, deconv: bool = False, bgr_to_rgb_slots: int = 0) -> np.ndarray:
    """OIHW float blob → HWIO (conv) or (kh,kw,Cout,Cin) (deconv).

    ``bgr_to_rgb_slots``: number of leading 3-channel image slots in the
    input-channel axis whose channel order must be reversed (BGR-trained
    weights consumed by an RGB pipeline).
    """
    o, i, kh, kw = blob.shape
    w = blob.data.reshape(o, i, kh, kw)
    if bgr_to_rgb_slots:
        w = w.copy()
        for s in range(bgr_to_rgb_slots):
            sl = slice(3 * s, 3 * s + 3)
            w[:, sl] = w[:, sl][:, ::-1]
    if deconv:
        # caffe deconv blob: (bottom=Cin, top=Cout, kh, kw) → (kh,kw,Cout,Cin)
        return np.transpose(w, (2, 3, 1, 0)).astype(np.float32)
    return np.transpose(w, (2, 3, 1, 0)).astype(np.float32)


def layers_to_params(
    layers: list[CaffeLayer],
    *,
    name_map: Optional[dict[str, str]] = None,
    bgr_slots: Optional[dict[str, int]] = None,
) -> dict:
    """Generic conversion: each Conv/Deconv layer → {"w","b"} entry.

    ``name_map`` renames caffe layer names to our param keys; unmapped
    layers keep their caffe names. ``bgr_slots`` marks input-facing layers
    needing BGR→RGB input-channel flips.
    """
    name_map = name_map or {}
    bgr_slots = bgr_slots or {}
    params: dict = {}
    for layer in layers:
        if not layer.blobs:
            continue
        key = name_map.get(layer.name, layer.name)
        deconv = layer.type == "Deconvolution"
        entry: dict = {}
        wblob = layer.blobs[0]
        if len(wblob.shape) == 4:
            entry["w"] = convert_conv_blob(
                wblob, deconv=deconv, bgr_to_rgb_slots=bgr_slots.get(layer.name, 0)
            )
        else:
            entry["w"] = wblob.data.reshape(wblob.shape).astype(np.float32)
        if len(layer.blobs) > 1:
            entry["b"] = layer.blobs[1].data.reshape(-1).astype(np.float32)
        else:
            entry["b"] = np.zeros((wblob.shape[0 if not deconv else 1],), np.float32)
        params[key] = entry
    return params


# Known layer-name prefixes inside the released FlowNet2 merged caffemodel.
# The full cascade model prefixes each subnet's layers; standalone models use
# bare names. These maps cover the standalone nets; the merged-net mapping is
# validated once real caffemodels are available (they are downloaded assets,
# not in the reference tree).
_SUBNET_PREFIXES = {
    "flownetc": ("", "netc_"),
    "flownets_1": ("net2_", "netS1_"),
    "flownets_2": ("net3_", "netS2_"),
    "flownetsd": ("netsd_",),
    "fusion": ("fuse_", "netfusion_"),
}

# Input-facing layers of each subnet and how many leading 3-channel image
# slots their input stacks carry (BGR↔RGB flips): the C net's siamese conv1
# sees one image; the S refinement stages see [img0, img1, warped] (then
# flow+err channels); SD sees the img0|img1 stack; fusion sees img0 then
# flow/magnitude channels.
_CASCADE_BGR = {
    "flownetc": {"conv1": 1},
    "flownets_1": {"conv1": 3},
    "flownets_2": {"conv1": 3},
    "flownetsd": {"conv0": 2},
    "fusion": {"conv0": 1},
}


# Input-facing layers of the standalone nets: FlowNetS's conv1 sees the
# img0|img1 stack, FlowNetC's siamese conv1 one image, FlowNet2-SD's conv0
# the stack. (The JAX importer also flips FlowNet2-SD's conv1, whose first
# three of 64 input channels are features, not an image: the port does not.)
_SINGLE_NET_BGR = {"flownets": {"conv1": 2}, "flownetc": {"conv1": 1}, "flownet2-sd": {"conv0": 2}}


def parse_caffemodel_h5(path_or_bytes) -> list[CaffeLayer]:
    """Parse a ``.caffemodel.h5`` (net.cpp ToHDF5 layout: ``/data/<layer>/
    <blob_index>``) into CaffeLayer records, using the pure-Python HDF5
    subset reader (core/hdf5_lite.py; h5py is not a dependency).

    HDF5 stores no layer types; Convolution vs Deconvolution is inferred
    from the FlowNet naming convention (deconv*/upsample_flow* substrings),
    which holds across all released FlowNet2 nets.
    """
    from flownet2_tpu_torch.core.hdf5_lite import read_hdf5

    tree = read_hdf5(path_or_bytes)
    data = tree.get("data", tree)
    layers: list[CaffeLayer] = []
    for lname, blobs in data.items():
        if not isinstance(blobs, dict):
            continue
        ordered = sorted(blobs.items(), key=lambda kv: int(kv[0]))
        bs = [
            CaffeBlob(tuple(arr.shape), np.asarray(arr, np.float32).reshape(-1))
            for _, arr in ordered
        ]
        ltype = (
            "Deconvolution"
            if ("deconv" in lname or "upsample_flow" in lname)
            else "Convolution"
        )
        layers.append(CaffeLayer(lname, ltype, bs))
    return layers


def check_params_fit(params: dict, model: str) -> None:
    """Raise ``ValueError`` unless ``params`` has exactly the keys and shapes
    of the port's ``model`` net, naming every missing, unexpected and
    misshapen key: weights that do not fit are refused whole, never loaded
    in part."""
    from flownet2_tpu_torch.checkpoint import expected_params, flatten_params

    want = expected_params(model)
    got = {k: tuple(np.shape(v)) for k, v in flatten_params(params).items()}
    problems = []
    missing = sorted(set(want) - set(got))
    if missing:
        problems.append(f"{len(missing)} missing: {', '.join(missing)}")
    unexpected = sorted(set(got) - set(want))
    if unexpected:
        problems.append(f"{len(unexpected)} unexpected: {', '.join(unexpected)}")
    shapes = [f"{k} {got[k]} (net {want[k]})" for k in sorted(set(want) & set(got)) if want[k] != got[k]]
    if shapes:
        problems.append(f"{len(shapes)} of another shape: {', '.join(shapes)}")
    if problems:
        raise ValueError(f"the imported weights do not fit the {model} net: " + "; ".join(problems))


def import_caffemodel(path: str, model: str) -> dict:
    """Import a reference caffemodel for the given model name.

    For single nets (flownets/flownetc/flownet2-sd) layer names map 1:1 to
    the param keys, and the input-facing layer's image channels are flipped
    from BGR (``_SINGLE_NET_BGR``). For every other name, layers are routed to the cascade's
    subnets by name prefix, as the JAX importer routes them (so DispNetC's
    layers land under ``flownetc/`` there). Both binaryproto ``.caffemodel``
    and HDF5 ``.caffemodel.h5`` (net.cpp:805-885) are read. The result is
    checked against the port's net (:func:`check_params_fit`) and refused
    with the keys that do not fit. ``raft`` is refused: there is no Caffe RAFT.
    """
    if model == "raft":
        raise ValueError("there is no Caffe RAFT: load RAFT's weights from an .npz in the port's layout, "
                         "or use 'random'")
    params = _import_layers(path, model)
    check_params_fit(params, model)
    return params


def _import_layers(path: str, model: str) -> dict:
    """The JAX importer's result for ``model``, unchecked."""
    if path.endswith(".h5"):
        layers = parse_caffemodel_h5(path)
    else:
        layers = parse_caffemodel(path)
    if model in _SINGLE_NET_BGR:
        return layers_to_params(layers, bgr_slots=_SINGLE_NET_BGR[model])

    # cascade: route by prefix
    params: dict = {k: {} for k in _SUBNET_PREFIXES}
    for layer in layers:
        routed = False
        for subnet, prefixes in _SUBNET_PREFIXES.items():
            for pre in prefixes:
                if pre and layer.name.startswith(pre):
                    sub_layers = [
                        CaffeLayer(layer.name[len(pre) :], layer.type, layer.blobs)
                    ]
                    params[subnet].update(
                        layers_to_params(sub_layers, bgr_slots=_CASCADE_BGR[subnet])
                    )
                    routed = True
                    break
            if routed:
                break
        if not routed:
            params["flownetc"].update(
                layers_to_params([layer], bgr_slots=_CASCADE_BGR["flownetc"])
            )
    return params
