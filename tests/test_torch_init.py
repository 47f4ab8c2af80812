"""The port's seeded weights against the JAX package's: the threefry keys
(``core.prng``) against ``jax.random``, ``init_params`` against
``MODEL_INITS`` bit for bit, and ``run_flownet random`` through both CLIs."""

import jax
import numpy as np
import pytest
import torch

from flownet2_tpu.checkpoint import flatten_params as jax_flatten_params
from flownet2_tpu.cli.run_flownet import main as jax_main
from flownet2_tpu.core.flow_io import read_flo, write_ppm
from flownet2_tpu.inference import MODEL_INITS as JAX_MODEL_INITS
from flownet2_tpu_torch.checkpoint import init_params
from flownet2_tpu_torch.cli.run_flownet import main
from flownet2_tpu_torch.core import prng
from flownet2_tpu_torch.models import NETS
from flownet2_tpu_torch.tools.synth_dataset import make_sample

torch.set_num_threads(2)  # the suite runs several workers side by side


@pytest.mark.parametrize("n", [2, 5])
@pytest.mark.parametrize("seed", [0, 3, 9, 2**31, 2**32 - 1])
def test_split_equals_jax(seed, n):
    """``prng.split(prng_key(s), n)`` is ``jax.random.split(PRNGKey(s), n)``."""
    want = np.asarray(jax.random.key_data(jax.random.split(jax.random.PRNGKey(seed), n)))
    got = prng.split(prng.prng_key(seed), n)
    assert got.dtype == np.uint32 and got.shape == (n, 2)
    np.testing.assert_array_equal(got, want)


def test_threefry_known_answer():
    """The Threefry-2x32 (20 rounds) known-answer vector of the Random123
    suite, which JAX's own tests also check."""
    x = prng.threefry2x32(0x13198A2E, 0x03707344, np.uint32(0x243F6A88), np.uint32(0x85A308D3))
    assert (int(x[0]), int(x[1])) == (0xC4923A9C, 0x483DF7A0)


def _assert_bit_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("model", list(NETS))
def test_init_params_equal_jax(model, seed):
    """Every tensor of ``init_params(m, s)`` equals the JAX package's
    ``MODEL_INITS[m](PRNGKey(s))`` bit for bit, the cascades' too."""
    assert set(NETS) == set(JAX_MODEL_INITS)
    _assert_bit_equal(init_params(model, seed), jax_flatten_params(JAX_MODEL_INITS[model](jax.random.PRNGKey(seed))))


@pytest.mark.parametrize("model", ["flownetc", "flownet2"])
@pytest.mark.parametrize("seed", [-1, 2**32 + 3])
def test_seed_reduces_as_prng_key(seed, model):
    """A seed outside [0, 2**32) reduces mod 2**32 as ``PRNGKey`` reduces it
    with 64-bit types off: the key, and so the weights, are the JAX ones."""
    key = np.asarray(jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(prng.prng_key(seed), key)
    assert int(key[1]) == seed % 2**32
    _assert_bit_equal(init_params(model, seed), jax_flatten_params(JAX_MODEL_INITS[model](jax.random.PRNGKey(seed))))


def test_run_flownet_random_flownet2_equals_jax(tmp_path):
    """``run_flownet random flownet2`` through both packages' CLIs on one
    synthetic 70x90 pair (adapted to 128x128): the .flo files agree to mean
    EPE <= 1e-3 px, the tolerance of tests/test_torch_cli.py (float32 on
    both sides): both start from PRNGKey(0)'s weights."""
    img0, img1, _ = make_sample(np.random.default_rng(4), 70, 90)
    pair = [str(tmp_path / "img0.ppm"), str(tmp_path / "img1.ppm")]
    write_ppm(pair[0], img0)
    write_ppm(pair[1], img1)
    out_jax, out_torch = str(tmp_path / "jax.flo"), str(tmp_path / "torch.flo")
    assert jax_main(["random", "flownet2", *pair, out_jax]) == 0
    assert main(["random", "flownet2", *pair, out_torch, "--device", "cpu"]) == 0
    a, b = read_flo(out_jax), read_flo(out_torch)
    assert a.shape == b.shape == (70, 90, 2)
    assert np.isfinite(a).all() and float(np.abs(a).mean()) > 0
    assert float(np.sqrt(((a - b) ** 2).sum(-1)).mean()) <= 1e-3
