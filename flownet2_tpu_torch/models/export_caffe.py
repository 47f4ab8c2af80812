"""Export JAX-layout parameters as reference-format ``.caffemodel`` binaryprotos
and ``.caffemodel.h5`` files (the port's copy of flownet2_tpu/models/export_caffe.py).

The inverse of :mod:`flownet2_tpu_torch.models.import_caffe`: encodes a
NetParameter with one Convolution/Deconvolution layer per param entry
(weights converted back to the reference's OIHW / (bottom,top,kh,kw)
layouts), so weights move both directions between the frameworks. The
bytes are the JAX exporter's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(fnum: int, wtype: int) -> bytes:
    return _varint((fnum << 3) | wtype)


def _len_field(fnum: int, payload: bytes) -> bytes:
    return _tag(fnum, 2) + _varint(len(payload)) + payload


def _field(fnum: int, pieces: list) -> list:
    """A length-delimited field as a list of pieces (its tag, its length,
    its payload's pieces), which the writer joins once: a net of FlowNet2's
    size is 650 MB, and concatenating each level of nesting would copy it
    once a level."""
    return [_tag(fnum, 2), _varint(sum(len(p) for p in pieces)), *pieces]


def _encode_blob(arr: np.ndarray) -> list:
    shape_payload = b"".join(_tag(1, 0) + _varint(int(d)) for d in arr.shape)
    data = memoryview(np.ascontiguousarray(arr, dtype="<f4")).cast("B")
    return _field(7, [shape_payload]) + _field(5, [data])


def _is_deconv(name: str, w: np.ndarray) -> bool:
    # substring (not prefix): merged-cascade names carry subnet prefixes
    # (net2_deconv5, fuse_upsample_flow1to0, ...)
    return ("deconv" in name or "upsample_flow" in name) and w.ndim == 4


def _to_caffe_blob(name: str, p: dict, bgr_slots: dict) -> tuple[np.ndarray, str]:
    """Our {w,b} entry → (caffe-layout weight blob, layer type)."""
    w = np.asarray(p["w"], np.float32)
    if w.ndim == 4:
        if _is_deconv(name, w):
            # (kh, kw, Cout, Cin) → caffe deconv (bottom=Cin, top=Cout, kh, kw)
            blob = np.transpose(w, (3, 2, 0, 1))
            ltype = "Deconvolution"
        else:
            # HWIO → OIHW
            blob = np.transpose(w, (3, 2, 0, 1))
            ltype = "Convolution"
        slots = bgr_slots.get(name, 0)
        if slots:
            blob = blob.copy()
            for s in range(slots):
                sl = slice(3 * s, 3 * s + 3)
                blob[:, sl] = blob[:, sl][:, ::-1]
    else:
        blob = w
        ltype = "InnerProduct"
    return blob, ltype


# RAFT's top-level modules: it has no Caffe form (the reference's Caffe is FlowNet's)
_RAFT_MODULES = ("fnet", "cnet", "update_block")


def refuse_raft(params: dict) -> None:
    """Raise ``ValueError`` on RAFT's weights (flat or nested): there is no Caffe RAFT."""
    if any(str(k).split("/")[0] in _RAFT_MODULES for k in params):
        raise ValueError("there is no Caffe RAFT: RAFT's weights stay in the port's .npz layout "
                         "(checkpoint.save_params)")


def _layer_fields(params: dict, bgr_slots: dict) -> list:
    """The pieces of one NetParameter ``layer`` field (100) per {w, b}
    entry, in order, for the caller to join."""
    refuse_raft(params)
    pieces = []
    for name, p in params.items():
        blob, ltype = _to_caffe_blob(name, p, bgr_slots)
        layer = [_len_field(1, name.encode()), _len_field(2, ltype.encode()), *_field(7, _encode_blob(blob))]
        if "b" in p:
            layer += _field(7, _encode_blob(np.asarray(p["b"], np.float32)))
        pieces += _field(100, layer)
    return pieces


def _write(path: Optional[str], body: bytes) -> bytes:
    if path is not None:
        with open(path, "wb") as f:
            f.write(body)
    return body


def export_caffemodel(
    params: dict,
    path: Optional[str] = None,
    *,
    net_name: str = "flownet2-tpu-export",
    bgr_slots: Optional[dict[str, int]] = None,
) -> bytes:
    """Encode a flat {layer: {"w","b"}} param dict (one subnet) as a
    binaryproto NetParameter; optionally write to ``path``.

    ``bgr_slots`` reverses the importer's RGB→BGR input-channel flips for
    input-facing layers so exported weights drop into a BGR-fed reference
    deploy unchanged.
    """
    fields = _layer_fields(params, bgr_slots or {})
    return _write(path, b"".join([_len_field(1, net_name.encode()), *fields]))


def export_caffemodel_h5(
    params: dict,
    path: Optional[str] = None,
    *,
    bgr_slots: Optional[dict[str, int]] = None,
    name_prefix: str = "",
) -> bytes:
    """Encode a param dict as a ``.caffemodel.h5`` (the reference's
    save_hdf5/ToHDF5 layout, net.cpp:840-885: groups /data/<layer> with
    datasets "0" (weights, caffe layouts) and "1" (bias)), written by the
    pure-Python HDF5 subset writer."""
    from flownet2_tpu_torch.core.hdf5_lite import write_hdf5

    refuse_raft(params)
    bgr_slots = bgr_slots or {}
    data: dict = {}
    for name, p in params.items():
        blob, _ = _to_caffe_blob(name, p, bgr_slots)
        entry = {"0": blob}
        if "b" in p:
            entry["1"] = np.asarray(p["b"], np.float32)
        data[name_prefix + name] = entry
    return write_hdf5(path, {"data": data})


def export_caffemodel_merged_h5(
    cascade_params: dict, path: Optional[str] = None
) -> bytes:
    """HDF5 variant of :func:`export_caffemodel_merged`."""
    from flownet2_tpu_torch.core.hdf5_lite import write_hdf5
    from flownet2_tpu_torch.models.import_caffe import _CASCADE_BGR, _SUBNET_PREFIXES

    data: dict = {}
    for subnet, prefixes in _SUBNET_PREFIXES.items():
        prefix = prefixes[0]
        bgr = _CASCADE_BGR.get(subnet, {})
        for name, p in cascade_params[subnet].items():
            blob, _ = _to_caffe_blob(name, p, bgr)
            entry = {"0": blob}
            if "b" in p:
                entry["1"] = np.asarray(p["b"], np.float32)
            data[prefix + name] = entry
    return write_hdf5(path, {"data": data})


def export_caffemodel_merged(
    cascade_params: dict, path: Optional[str] = None, *, net_name: str = "FlowNet2"
) -> bytes:
    """Encode a full FlowNet2 cascade pytree as ONE merged caffemodel with
    the per-subnet layer-name prefixes of import_caffe._SUBNET_PREFIXES
    (flownetc bare, net2_/net3_ for the S stages, netsd_, fuse_) and the
    cascade's BGR input slots — the synthetic stand-in for the released
    merged model (models/download-models.sh) that pins the importer's
    routing until real weights are in the repository."""
    from flownet2_tpu_torch.models.import_caffe import _CASCADE_BGR, _SUBNET_PREFIXES

    pieces = [_len_field(1, net_name.encode())]
    for subnet, prefixes in _SUBNET_PREFIXES.items():
        prefix = prefixes[0]
        prefixed = {prefix + name: p for name, p in cascade_params[subnet].items()}
        pbgr = {prefix + name: n for name, n in _CASCADE_BGR.get(subnet, {}).items()}
        pieces += _layer_fields(prefixed, pbgr)
    return _write(path, b"".join(pieces))
