"""Weight bridge: the JAX package's parameters to a PyTorch ``state_dict`` and back.

The JAX package stores weights as a flat ``.npz`` with ``/``-joined keys
(flownet2_tpu/checkpoint.py), e.g. ``flownetc/conv1/w`` and
``flownetc/conv1/b``. Here those become ``flownetc.conv1.weight`` and
``flownetc.conv1.bias``, with the weight axes moved:

- conv weights (kh, kw, Cin, Cout) HWIO -> (Cout, Cin, kh, kw) OIHW;
- deconv weights (kh, kw, Cout, Cin) -> (Cin, Cout, kh, kw), the layout of
  ``conv_transpose2d``.

Both are ``w.transpose(3, 2, 0, 1)``, the inverse of the caffemodel
importer's move (flownet2_tpu/models/import_caffe.py:222-223). RAFT's
batch norms (the port's alone) keep four 1-D leaves: ``scale``, ``offset``,
``mean`` and ``var`` become ``weight``, ``bias``, ``running_mean`` and
``running_var``.
:func:`params_from_state_dict` moves them back, and :func:`save_params`
writes the flat ``.npz`` that ``flownet2_tpu.checkpoint.load_params`` reads.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from flownet2_tpu_torch.core import prng
from flownet2_tpu_torch.models import MODELS, FlowNet2
from flownet2_tpu_torch.models.raft import FrozenBatchNorm2d

_LEAF_NAMES = {"w": "weight", "b": "bias"}
_JAX_LEAVES = {v: k for k, v in _LEAF_NAMES.items()}
_NORM_LEAF_NAMES = {"scale": "weight", "offset": "bias", "mean": "running_mean", "var": "running_var"}
_NORM_JAX_LEAVES = {v: k for k, v in _NORM_LEAF_NAMES.items()}
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
        if leaf not in _LEAF_NAMES and leaf not in _NORM_LEAF_NAMES:
            raise ValueError(f"unexpected parameter {key!r}: leaves must be 'w' or 'b', "
                             f"or a batch norm's 'scale', 'offset', 'mean' or 'var'")
        a = np.asarray(v, dtype=np.float32)
        if leaf == "w":
            if a.ndim != 4:
                raise ValueError(f"{key}: expected a 4-D conv weight, got shape {a.shape}")
            a = a.transpose(3, 2, 0, 1)
        elif leaf in _NORM_LEAF_NAMES and a.ndim != 1:
            raise ValueError(f"{key}: expected a 1-D batch-norm leaf, got shape {a.shape}")
        # a copy: the tensor must not share memory with the caller's arrays,
        # or training the net would write into them
        name = _LEAF_NAMES.get(leaf) or _NORM_LEAF_NAMES[leaf]
        sd[".".join(path + [name])] = torch.from_numpy(np.array(a, order="C", copy=True))
    return sd


def _jax_leaf(state_dict, path: list, leaf: str) -> str | None:
    """The JAX-layout leaf of ``state_dict``'s ``path.leaf``: a batch norm's
    (its module holds all four of a norm's entries) or a conv's; None if neither."""
    if all(".".join(path + [name]) in state_dict for name in _NORM_JAX_LEAVES):
        return _NORM_JAX_LEAVES.get(leaf)
    return _JAX_LEAVES.get(leaf)


def params_from_state_dict(state_dict: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A net's ``state_dict`` -> flat ``/``-keyed float32 numpy parameters in
    the JAX layout: the inverse of :func:`state_dict_from_params`."""
    params = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        jax_leaf = _jax_leaf(state_dict, path, leaf)
        if jax_leaf is None:
            raise ValueError(f"unexpected state_dict entry {key!r}: leaves must be 'weight' or 'bias', "
                             f"or a batch norm's 'running_mean' or 'running_var'")
        a = t.detach().to("cpu", torch.float32).numpy()
        if jax_leaf == "w":
            a = a.transpose(2, 3, 1, 0)
        params["/".join(path + [jax_leaf])] = np.ascontiguousarray(a)
    return params


def expected_params(model: str) -> dict[str, tuple[int, ...]]:
    """Every parameter ``model``'s net takes: JAX-layout key -> JAX-layout shape."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; choose from {tuple(MODELS)}")
    with torch.device("meta"):
        net = MODELS[model]()
    out = {}
    sd = net.state_dict()
    for key, t in sd.items():
        *path, leaf = key.split(".")
        jax_leaf = _jax_leaf(sd, path, leaf)
        shape = tuple(t.shape)
        out["/".join(path + [jax_leaf])] = shape[2:] + shape[1::-1] if jax_leaf == "w" else shape
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

    MSRA init: weights N(0, 2 / (kh*kw*Cin)), biases 0, the distribution of
    flownet2_tpu/ops/conv.py::init_conv_params, drawn layer by layer with
    ``numpy.random.default_rng``. A single net seeds it from the key's last
    word, ``seed mod 2**32`` (models/common.py::ParamInit). The cascades
    split the key five ways, one subkey per sub-net in the order of
    models/flownet2.py::flownet2_init, and seed each sub-net's generator
    from its subkey's last word (``core.prng`` computes the keys). Within a
    net, layers are drawn in ``named_modules`` order, the JAX init's order.
    RAFT, which the JAX package lacks, draws as a single net does; its batch
    norms start as a fresh net's: scale 1, offset 0, mean 0, variance 1.
    """
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; choose from {tuple(MODELS)}")
    with torch.device("meta"):
        net = MODELS[model]()
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
            path = prefix + name.replace(".", "/")
            if isinstance(layer, FrozenBatchNorm2d):
                c = layer.weight.shape[0]
                params.update({f"{path}/scale": np.ones(c, np.float32), f"{path}/offset": np.zeros(c, np.float32),
                               f"{path}/mean": np.zeros(c, np.float32), f"{path}/var": np.ones(c, np.float32)})
                continue
            if not isinstance(layer, (nn.Conv2d, nn.ConvTranspose2d)):
                continue
            (kh, kw), cin, cout = layer.kernel_size, layer.in_channels, layer.out_channels
            shape = (kh, kw, cout, cin) if isinstance(layer, nn.ConvTranspose2d) else (kh, kw, cin, cout)
            std = (2.0 / (kh * kw * cin)) ** 0.5
            params[f"{path}/w"] = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
            params[f"{path}/b"] = np.zeros((cout,), np.float32)
    return params
