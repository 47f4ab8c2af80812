"""Fixed-point flow codec of the packed dataset formats (flownet2_tpu/core/codec.py).

The reference packs ground-truth flow as int16 fixed point,
``int16 = round(flow * 32)`` with NaN (invalid pixels) mapped to SHRT_MAX
(tools/convert_imageset_and_flow.cpp:169-181), and decodes it as
``float = int16 / 32`` with SHRT_MAX -> NaN (custom_data_layer.cpp:94-112,
"UINT16FLOW"). Occlusions are packed 1 bit a pixel ("BOOL1"). The on-disk
contract is the JAX package's, so records interchange losslessly.
"""

from __future__ import annotations

import numpy as np

FLO_SCALE = 32.0
FLO_NAN_SENTINEL = np.int16(32767)  # SHRT_MAX


def encode_flow_int16(flow: np.ndarray) -> np.ndarray:
    """float32 flow (any shape) -> int16, NaN -> SHRT_MAX, saturating."""
    flow = np.asarray(flow, dtype=np.float32)
    scaled = np.round(flow * FLO_SCALE)
    nan_mask = ~np.isfinite(scaled)
    scaled = np.where(nan_mask, 0.0, scaled)
    clipped = np.clip(scaled, -32768, 32766).astype(np.int16)
    return np.where(nan_mask, FLO_NAN_SENTINEL, clipped)


def decode_flow_int16(data: np.ndarray) -> np.ndarray:
    """int16 -> float32 flow; SHRT_MAX -> NaN."""
    data = np.asarray(data, dtype=np.int16)
    out = data.astype(np.float32) / FLO_SCALE
    return np.where(data == FLO_NAN_SENTINEL, np.float32(np.nan), out)


def flow_as_f32(flow):
    """A flow tensor as float32 on its own device, whatever domain it came
    in: int16 transport records decode as value/32 with SHRT_MAX -> NaN
    (:func:`decode_flow_int16`'s arithmetic); floating tensors are cast.
    The tensor twin of the JAX package's ``flow_as_f32_device``, which every
    objective calls, so a transport batch trains like its float form."""
    import torch

    if flow.dtype == torch.int16:
        out = flow.float() / FLO_SCALE
        return out.masked_fill(flow == int(FLO_NAN_SENTINEL), float("nan"))
    return flow.float()


def encode_occlusion_bits(occ: np.ndarray) -> np.ndarray:
    """Bit-pack a boolean occlusion map row-major into uint8: bit i of byte
    i // 8 is pixel i (tools/convert_imageset_and_flow.cpp, decoded at
    custom_data_layer.cpp:113-128, "BOOL1")."""
    flat = np.asarray(occ).reshape(-1).astype(bool)
    return np.packbits(flat, bitorder="little")


def decode_occlusion_bits(data: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """Unpack uint8 bits -> boolean array of ``shape``."""
    n = int(np.prod(shape))
    flat = np.unpackbits(np.asarray(data, dtype=np.uint8), count=n, bitorder="little")
    return flat.astype(bool).reshape(shape)
