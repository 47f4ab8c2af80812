"""flownet2_tpu_torch: FlowNet2 inference and training in PyTorch, with CUDA kernels for Hopper.

The PyTorch counterpart of ``flownet2_tpu`` (the JAX package, which stays the
reference). Module names follow the JAX package:

- ``ops``        — leaky ReLU, channel norm, linear and nearest resample,
                   Accum, the NaN-aware
                   downsample, the losses, FlowWarp and Correlation (each
                   with hand-written CUDA kernels for its forward and
                   backward), the full-resolution head convs and the fused
                   fusion-net decoder head (hand-written CUDA forwards);
                   the kernels live in ``csrc/``, built on first use by
                   ``_build``, and each has a plain PyTorch version that
                   serves CPU tensors.
- ``models``     — FlowNetS / C / SD, the fusion net, the FlowNet2 cascade
                   and DispNetC as ``nn.Module``s; their apply functions
                   take and return NHWC like the JAX package, the nets run
                   NCHW inside; the reference's ``.caffemodel`` /
                   ``.caffemodel.h5`` import and export.
- ``core``       — numpy-only host helpers: the /64 adapt, ``.flo``, PPM,
                   PFM and KITTI's 16-bit PNG I/O, the int16 flow codec,
                   the HDF5 subset of ``.caffemodel.h5``.
- ``checkpoint`` — the JAX package's flat ``.npz`` weights to a ``state_dict``,
                   and seeded random weights.
- ``inference``  — ``FlowRunner``: the /64 adapt, the net, the resize back.
- ``train``      — LR policies, the Caffe solvers, the training objectives
                   and the ``Solver`` loop.
- ``data``       — the FlyingChairs, ChairsSDHom, FlyingThings3D, Sintel and
                   KITTI layouts, ``.flowrec`` records, LMDB and LevelDB
                   (numpy only), the prefetching loader.
- ``cli``        — ``run_flownet``, ``run_flownet_many``, ``train``,
                   ``convert_dataset``, ``test``, ``time_cmd``, ``eval_parity``
                   and ``device_query``, argument-compatible with the JAX CLIs.
- ``tools``      — the synthetic dataset, the per-stage breakdown, the overfit
                   and stage-wise cascade runs, summarize, flow_vis, the log
                   parser and plotter, the artifact writers.

This package imports neither jax nor the JAX package.
"""

__version__ = "0.1.0"
