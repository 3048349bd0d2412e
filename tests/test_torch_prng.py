"""Parity: the port's threefry PRNG (esvio_tpu_torch/core/prng.py) against
jax.random, bit for bit (tolerance: exact), for the seeds and shapes the
ESIO main path uses."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_parity  # noqa: F401  (torch thread cap)
from esvio_tpu_torch.core import prng

# seeds of the main path: the tracker's PRNGKey(0) chain and the stereo
# init's hybrid fallback keys (f * 9973 + 17) & 0x7FFFFFFF
SEEDS = [0, 1, 17 + 9973 * 1, 17 + 9973 * 10, 2 ** 31 - 1, 123456789]


def _key_eq(jk, tk):
    return np.array_equal(np.asarray(jk).astype(np.int64), tk.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_bit_exact(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    assert _key_eq(jk, tk)
    # the tracker splits its key once per tick
    for _ in range(5):
        js = jax.random.split(jk)
        ts = prng.split(tk)
        assert _key_eq(js, ts)
        jk, tk = js[0], ts[0]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_valid", [0, 8, 37, 128, 255])
def test_randint_bit_exact_x64(seed, n_valid):
    """Shapes of the main path's draws: (128, 8) tracker RANSAC and
    (256, 8) essential RANSAC, maxval = max(n_valid, 8); x64 is on in this
    suite, so jax samples 64 bits per value."""
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    tkey = prng.split(prng.PRNGKey(seed))[1]
    for shape in ((128, 8), (256, 8)):
        want = jax.random.randint(key, shape, 0, jnp.maximum(n_valid, 8))
        got = prng.randint(tkey, shape, 0, torch.tensor(max(n_valid, 8)),
                           bits=64)
        assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("maxval", [8, 37, 70000])
def test_randint_bit_exact_32bit(maxval):
    """Without x64 jax samples 32 bits per value (int32 default dtype)."""
    key = jax.random.PRNGKey(7)
    want = jax.random.randint(key, (64, 8), 0, maxval, dtype=jnp.int32)
    got = prng.randint(prng.PRNGKey(7), (64, 8), 0, maxval, bits=32)
    assert np.array_equal(np.asarray(want), got.numpy())
