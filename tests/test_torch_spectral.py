"""Port ops/spectral.py vs the JAX spectral_conv_2d and the numpy oracle."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.ops import spectral as jax_spectral
from sciml_pde_tpu.ops.spectral import (
    naive_spectral_conv_2d_numpy as jax_naive,
    spectral_conv_2d as jax_spectral_conv_2d,
)
from sciml_pde_torch.ops import spectral as port_spectral
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


@pytest.mark.parametrize("impl", ["dft", "fft", "dft2"])
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


@pytest.mark.parametrize("impl", ["dft", "dft2"])
def test_spectral_conv_grads_match_jax(inputs, impl):
    """Gradients of sum(out * cot) w.r.t. x, w1, w2 against jax.grad, f32
    products in both packages: within 1e-5 of the largest magnitude."""
    x, w1, w2 = inputs
    cot = np.random.default_rng(1).normal(size=(B, H, W, CO)).astype(np.float32)
    with precision("highest"):
        g_jax = jax.grad(lambda *a: jnp.sum(jax_spectral_conv_2d(*a, M1, M2, impl=impl) * cot),
                         argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2))
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w1, w2)]
        (spectral_conv_2d(*ts, M1, M2, impl=impl) * torch.from_numpy(cot)).sum().backward()
    for t, g in zip(ts, g_jax):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max())


@pytest.mark.parametrize("n, m", [(16, 4), (18, 3), (130, 12)])
def test_dft2_factors_equal_jax(n, m):
    for port_fn, jax_fn, args in (
        (port_spectral._dft2_real_axis, jax_spectral._dft2_real_axis, (n, m)),
        (port_spectral._dft2_corner_axis, jax_spectral._dft2_corner_axis, (n, m)),
    ):
        for got, want in zip(port_fn(*args), jax_fn(*args)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(2)
    wr, wi = (rng.normal(size=(3, 2, 2 * m, m)).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        port_spectral._weight_block(torch.from_numpy(wr), torch.from_numpy(wi)).numpy(),
        np.asarray(jax_spectral._weight_block(jnp.asarray(wr), jnp.asarray(wi))))


@pytest.mark.parametrize("env, want", [(None, "dft2"), ("dft", "dft"), ("FFT", "fft")])
def test_default_impl_follows_env(env, want):
    """``impl=None`` takes SCIML_SPECTRAL_IMPL, ``dft2`` when unset, as the
    JAX module's ``_DEFAULT_IMPL``."""
    code = ("import torch\n"
            "from sciml_pde_torch.ops import spectral as s\n"
            "from sciml_pde_torch.models.fno import FNO2d\n"
            "x = torch.randn(1, 16, 16, 3); w = torch.randn(2, 3, 3, 4, 4)\n"
            "same = torch.equal(s.spectral_conv_2d(x, w, w, 4, 4),\n"
            "                   s.spectral_conv_2d(x, w, w, 4, 4, impl=s.get_spectral_impl()))\n"
            "print(s.get_spectral_impl(), same)\n")
    env_vars = {k: v for k, v in os.environ.items()
                if k not in ("SCIML_SPECTRAL_IMPL", "PYTHONPATH")}
    if env is not None:
        env_vars["SCIML_SPECTRAL_IMPL"] = env
    r = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                       env=env_vars, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [want, "True"]
    if env is None:
        assert jax_spectral._DEFAULT_IMPL == os.environ.get("SCIML_SPECTRAL_IMPL", "dft2").lower()


def test_set_spectral_impl_validates():
    prev = port_spectral.get_spectral_impl()
    try:
        port_spectral.set_spectral_impl("DFT")
        assert port_spectral.get_spectral_impl() == "dft"
        with pytest.raises(ValueError, match="unknown spectral impl"):
            port_spectral.set_spectral_impl("cufft")
    finally:
        port_spectral.set_spectral_impl(prev)
