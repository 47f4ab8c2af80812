"""JAX's threefry key handling in numpy, as far as seeded weights need it.

The JAX package draws a net's weights from ``numpy.random.default_rng``
seeded by the last word of a ``jax.random`` key
(flownet2_tpu/models/common.py::ParamInit), and the FlowNet2 cascade first
splits its key five ways, one per sub-net (flownet2_tpu/models/flownet2.py::
flownet2_init). This module computes those keys without JAX, so that the
port's seeded weights are the JAX package's bit for bit:

- :func:`prng_key` is ``jax.random.PRNGKey(seed)`` with 64-bit types off;
- :func:`split` is ``jax.random.split(key, n)`` under the default
  ``jax_threefry_partitionable`` (the fold-like split of jax 0.5 on:
  subkey i is threefry2x32(key, (0, i)));
- :func:`threefry2x32` is the Threefry-2x32 hash with 20 rounds.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counts (x1, x2) under the key (k1, k2), all
    uint32 (broadcast together); returns the two uint32 output words."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: (0, seed mod 2**32)."""
    return np.array([0, int(seed) % 2**32], np.uint32)


def split(key, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``: an (n, 2) uint32 array of subkeys."""
    k1, k2 = np.asarray(key, np.uint32)
    b1, b2 = threefry2x32(k1, k2, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return np.stack([b1, b2], axis=1)
