"""Host-side helpers, numpy only: the /64 resolution adapt, the flow and
image file formats (``.flo``, PPM/PGM, PFM, KITTI's 16-bit flow PNG), the
int16 flow codec of the packed formats, and the HDF5 subset of Caffe's
``.caffemodel.h5``. Counterparts of ``flownet2_tpu/core/{adapt,flow_io,
codec,hdf5_lite}.py``, kept in the port so that it never imports the JAX
package; ``prng`` computes JAX's threefry keys for seeded weights."""

from flownet2_tpu_torch.core.adapt import AdaptedGeometry, adapt_shape
from flownet2_tpu_torch.core.codec import (
    FLO_NAN_SENTINEL,
    decode_flow_int16,
    decode_occlusion_bits,
    encode_flow_int16,
    encode_occlusion_bits,
    flow_as_f32,
)
from flownet2_tpu_torch.core.flow_io import (
    read_flo,
    read_image,
    read_kitti_flow,
    read_pfm,
    read_png16_rgb,
    read_ppm,
    write_flo,
    write_pfm,
    write_ppm,
)
from flownet2_tpu_torch.core.hdf5_lite import read_hdf5, write_hdf5

__all__ = [
    "AdaptedGeometry",
    "FLO_NAN_SENTINEL",
    "adapt_shape",
    "decode_flow_int16",
    "decode_occlusion_bits",
    "encode_flow_int16",
    "encode_occlusion_bits",
    "flow_as_f32",
    "read_flo",
    "read_hdf5",
    "read_image",
    "read_kitti_flow",
    "read_pfm",
    "read_png16_rgb",
    "read_ppm",
    "write_flo",
    "write_hdf5",
    "write_pfm",
    "write_ppm",
]
