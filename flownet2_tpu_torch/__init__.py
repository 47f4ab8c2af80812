"""flownet2_tpu_torch: FlowNet2 inference and training in PyTorch, with CUDA kernels for Hopper.

The PyTorch counterpart of ``flownet2_tpu`` (the JAX package, which stays the
reference). Module names follow the JAX package:

- ``ops``        — leaky ReLU, channel norm, linear resample, the NaN-aware
                   downsample, the losses, FlowWarp and Correlation (each
                   with hand-written CUDA kernels for its forward and
                   backward), the full-resolution head convs and the fused
                   fusion-net decoder head (hand-written CUDA forwards);
                   the kernels live in ``csrc/``, built on first use by
                   ``_build``, and each has a plain PyTorch version that
                   serves CPU tensors.
- ``models``     — FlowNetS / C / SD, the fusion net and the FlowNet2 cascade
                   as ``nn.Module``s; their apply functions take and return
                   NHWC like the JAX package, the nets run NCHW inside.
- ``core``       — numpy-only host helpers: the /64 adapt, ``.flo`` and PPM I/O.
- ``checkpoint`` — the JAX package's flat ``.npz`` weights to a ``state_dict``,
                   and seeded random weights.
- ``inference``  — ``FlowRunner``: the /64 adapt, the net, the resize back.
- ``train``      — LR policies, the Caffe solvers, the training objectives
                   and the ``Solver`` loop.
- ``data``       — FlyingChairs and Sintel readers, the prefetching loader.
- ``cli``        — ``run_flownet``, ``run_flownet_many`` and ``train``,
                   argument-compatible with the JAX CLIs.

This package imports neither jax nor the JAX package.
"""

__version__ = "0.1.0"
