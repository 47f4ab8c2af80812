"""The operators of the FlowNet2 paths, on NCHW tensors.

- ``activations``  — leaky ReLU.
- ``channel_norm`` — per-pixel L2 norm over channels, stabilized backward.
- ``resample``     — linear resize with the reference's offsets, as two matmuls;
                     nearest as a gather.
- ``accum``        — the Accum layer: inputs resized to one size, concatenated.
- ``downsample``   — the NaN-aware area downsample of ground truth.
- ``losses``       — L1/EPE, Lpq and the multi-scale loss.
- ``warp``         — FlowWarp: CUDA kernels (forward, backward) + plain PyTorch version.
- ``correlation``  — cost volume, 2-D (FlowNetC) and 1-D (DispNetC): CUDA kernels
                     (forward, backward) + plain PyTorch versions.
- ``head_conv``    — the full-resolution head convs and deconvs (bias, leaky
                     fused): CUDA kernels + plain PyTorch versions, and the
                     width routing.
- ``fusion_head``  — the fusion net's decoder head in one CUDA launch + the
                     plain composition of its layers.
- ``augment``      — the training augmentation: host coefficient sampling and the
                     device transforms (the affine sample through ``warp``).
- ``mean``         — the Mean layer: add or subtract a mean with scales.

Other convolutions and deconvolutions are ``F.conv2d`` / ``F.conv_transpose2d``
(through ``nn.Conv2d`` / ``nn.ConvTranspose2d`` in the models).
"""

from flownet2_tpu_torch.ops.activations import leaky_relu
from flownet2_tpu_torch.ops.channel_norm import channel_norm
from flownet2_tpu_torch.ops.correlation import correlation
from flownet2_tpu_torch.ops.resample import resample
from flownet2_tpu_torch.ops.warp import flow_warp

__all__ = ["channel_norm", "correlation", "flow_warp", "leaky_relu", "resample"]
