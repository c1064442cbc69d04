"""Port ops/spectral.py vs the JAX spectral_conv_2d and the numpy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.ops.spectral import (
    naive_spectral_conv_2d_numpy as jax_naive,
    spectral_conv_2d as jax_spectral_conv_2d,
)
from sciml_pde_torch.ops.spectral import naive_spectral_conv_2d_numpy, spectral_conv_2d

from _torch_parity import precision

B, H, W, CI, CO, M1, M2 = 2, 16, 18, 5, 6, 4, 3


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, H, W, CI)).astype(np.float32)
    w1 = (rng.normal(size=(2, CI, CO, M1, M2)) * 0.2).astype(np.float32)
    w2 = (rng.normal(size=(2, CI, CO, M1, M2)) * 0.2).astype(np.float32)
    return x, w1, w2


@pytest.mark.parametrize("impl", ["dft", "fft"])
def test_spectral_conv_matches_jax_and_oracle(inputs, impl):
    x, w1, w2 = inputs
    with precision("highest"):
        got = spectral_conv_2d(torch.from_numpy(x), torch.from_numpy(w1),
                               torch.from_numpy(w2), M1, M2, impl=impl).numpy()
        want = np.asarray(jax_spectral_conv_2d(jnp.asarray(x), jnp.asarray(w1),
                                               jnp.asarray(w2), M1, M2, impl=impl))
    oracle = naive_spectral_conv_2d_numpy(x, w1[0] + 1j * w1[1], w2[0] + 1j * w2[1], M1, M2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-5)


def test_numpy_oracle_copy_matches_jax_package(inputs):
    x, w1, w2 = inputs
    c1, c2 = w1[0] + 1j * w1[1], w2[0] + 1j * w2[1]
    np.testing.assert_array_equal(naive_spectral_conv_2d_numpy(x, c1, c2, M1, M2),
                                  jax_naive(x, c1, c2, M1, M2))


def test_default_precision_rounds_dot_inputs_to_bf16(inputs):
    """`default` = bf16 dot inputs with f32 accumulation: close to f32 at
    bf16's relative resolution (2^-8), and not identical to it."""
    x, w1, w2 = inputs
    args = (torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2), M1, M2)
    with precision("highest"):
        exact = spectral_conv_2d(*args).numpy()
    with precision("default"):
        rounded = spectral_conv_2d(*args).numpy()
    scale = np.abs(exact).max()
    assert np.abs(rounded - exact).max() < 2e-2 * scale
    assert np.abs(rounded - exact).max() > 0
