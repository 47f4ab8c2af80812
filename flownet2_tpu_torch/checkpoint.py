"""Weight bridge: the JAX package's parameters to a PyTorch ``state_dict`` and back.

The JAX package stores weights as a flat ``.npz`` with ``/``-joined keys
(flownet2_tpu/checkpoint.py), e.g. ``flownetc/conv1/w`` and
``flownetc/conv1/b``. Here those become ``flownetc.conv1.weight`` and
``flownetc.conv1.bias``, with the weight axes moved:

- conv weights (kh, kw, Cin, Cout) HWIO -> (Cout, Cin, kh, kw) OIHW;
- deconv weights (kh, kw, Cout, Cin) -> (Cin, Cout, kh, kw), the layout of
  ``conv_transpose2d``.

Both are ``w.transpose(3, 2, 0, 1)``, the inverse of the caffemodel
importer's move (flownet2_tpu/models/import_caffe.py:222-223).
:func:`params_from_state_dict` moves them back, and :func:`save_params`
writes the flat ``.npz`` that ``flownet2_tpu.checkpoint.load_params`` reads.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from flownet2_tpu_torch.core import prng
from flownet2_tpu_torch.models import NETS, FlowNet2

_LEAF_NAMES = {"w": "weight", "b": "bias"}
_JAX_LEAVES = {v: k for k, v in _LEAF_NAMES.items()}
# the cascade's sub-nets in the order its init splits the key among them
_CASCADE_ORDER = ("flownetc", "flownets_1", "flownets_2", "flownetsd", "fusion")


def flatten_params(params: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested parameter dict -> flat ``/``-joined keys (already flat passes through)."""
    out = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def load_params(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """Read a flat ``.npz`` written by ``flownet2_tpu.checkpoint.save_params``."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def state_dict_from_params(params: dict) -> dict[str, torch.Tensor]:
    """JAX-layout parameters (flat or nested, numpy or array-likes) -> ``state_dict``."""
    sd = {}
    for key, v in flatten_params(params).items():
        *path, leaf = key.split("/")
        if leaf not in _LEAF_NAMES:
            raise ValueError(f"unexpected parameter {key!r}: leaves must be 'w' or 'b'")
        a = np.asarray(v, dtype=np.float32)
        if leaf == "w":
            if a.ndim != 4:
                raise ValueError(f"{key}: expected a 4-D conv weight, got shape {a.shape}")
            a = a.transpose(3, 2, 0, 1)
        # a copy: the tensor must not share memory with the caller's arrays,
        # or training the net would write into them
        sd[".".join(path + [_LEAF_NAMES[leaf]])] = torch.from_numpy(np.array(a, order="C", copy=True))
    return sd


def params_from_state_dict(state_dict: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A net's ``state_dict`` -> flat ``/``-keyed float32 numpy parameters in
    the JAX layout: the inverse of :func:`state_dict_from_params`."""
    params = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        if leaf not in _JAX_LEAVES:
            raise ValueError(f"unexpected state_dict entry {key!r}: leaves must be 'weight' or 'bias'")
        a = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            a = a.transpose(2, 3, 1, 0)
        params["/".join(path + [_JAX_LEAVES[leaf]])] = np.ascontiguousarray(a)
    return params


def expected_params(model: str) -> dict[str, tuple[int, ...]]:
    """Every parameter ``model``'s net takes: JAX-layout key -> JAX-layout shape."""
    if model not in NETS:
        raise ValueError(f"unknown model {model!r}; choose from {tuple(NETS)}")
    with torch.device("meta"):
        net = NETS[model]()
    out = {}
    for key, t in net.state_dict().items():
        *path, leaf = key.split(".")
        shape = tuple(t.shape)
        out["/".join(path + [_JAX_LEAVES[leaf]])] = shape[2:] + shape[1::-1] if leaf == "weight" else shape
    return out


def save_params(path: str | os.PathLike, params: dict) -> None:
    """Write JAX-layout parameters (flat or nested) as a flat ``.npz``."""
    np.savez(path, **flatten_params(params))


def load_into(net: nn.Module, params: dict) -> nn.Module:
    """Load JAX-layout ``params`` into ``net``; every key must match.

    The tensors are assigned, not copied, so ``net`` may be built on the
    ``meta`` device and moved afterwards without a second allocation."""
    net.load_state_dict(state_dict_from_params(params), strict=True, assign=True)
    return net


def init_params(model: str = "flownet2", seed: int = 0) -> dict[str, np.ndarray]:
    """Random weights for ``model`` in the JAX package's flat layout: bit for
    bit the JAX package's ``MODEL_INITS[model](jax.random.PRNGKey(seed))``.

    MSRA init: weights N(0, 2 / (k*k*Cin)), biases 0, the distribution of
    flownet2_tpu/ops/conv.py::init_conv_params, drawn layer by layer with
    ``numpy.random.default_rng``. A single net seeds it from the key's last
    word, ``seed mod 2**32`` (models/common.py::ParamInit). The cascades
    split the key five ways, one subkey per sub-net in the order of
    models/flownet2.py::flownet2_init, and seed each sub-net's generator
    from its subkey's last word (``core.prng`` computes the keys). Within a
    net, layers are drawn in ``named_modules`` order, the JAX init's order.
    """
    if model not in NETS:
        raise ValueError(f"unknown model {model!r}; choose from {tuple(NETS)}")
    with torch.device("meta"):
        net = NETS[model]()
    key = prng.prng_key(seed)
    if isinstance(net, FlowNet2):
        subkeys = prng.split(key, len(_CASCADE_ORDER))
        parts = [(f"{name}/", getattr(net, name), sk) for name, sk in zip(_CASCADE_ORDER, subkeys)]
    else:
        parts = [("", net, key)]
    params = {}
    for prefix, sub, subkey in parts:
        rng = np.random.default_rng(int(subkey[-1]))
        for name, layer in sub.named_modules():
            if not isinstance(layer, (nn.Conv2d, nn.ConvTranspose2d)):
                continue
            k, cin, cout = layer.kernel_size[0], layer.in_channels, layer.out_channels
            shape = (k, k, cout, cin) if isinstance(layer, nn.ConvTranspose2d) else (k, k, cin, cout)
            std = (2.0 / (k * k * cin)) ** 0.5
            path = prefix + name.replace(".", "/")
            params[f"{path}/w"] = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
            params[f"{path}/b"] = np.zeros((cout,), np.float32)
    return params
