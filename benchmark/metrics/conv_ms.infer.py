"""Device ms a pair in cuDNN's convolutions and deconvolutions, their layout
transposes included: the self device time of the aten ops that launch them
(the ops ``scripts/profile_slice.py::OP_PARTS`` reads)."""

from benchmark.harness.readers import op_ms_per

OPS = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose")


def read(st):
    return op_ms_per(st, OPS, "pairs")
