"""Port ops/spectral_fused.py (the fused dft2 FNO layer) vs the JAX
fused_fno_layer_2d, whose Pallas kernel runs in interpret mode on the CPU.
On the CPU the port's wrapper runs the kernel's plain f32 version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.ops.spectral_fused import _layer_reference as jax_layer_reference
from sciml_pde_tpu.ops.spectral_fused import fused_fno_layer_2d as jax_fused
from sciml_pde_torch.ops import spectral_fused as sf

from _torch_parity import precision

# (B, H, W, Ci, Co, m1, m2): the JAX test's shape, and an odd one
SHAPES = {"jax_test": (2, 18, 18, 6, 6, 4, 4), "odd": (1, 13, 11, 5, 3, 3, 4)}


def _inputs(shape):
    b, h, w, ci, co, m1, m2 = shape
    rng = np.random.default_rng(0)
    scale = 1.0 / (ci * co)
    return (rng.normal(size=(b, h, w, ci)).astype(np.float32),
            (scale * rng.normal(size=(2, ci, co, m1, m2))).astype(np.float32),
            (scale * rng.normal(size=(2, ci, co, m1, m2))).astype(np.float32),
            (rng.normal(size=(ci, co)) * 0.1).astype(np.float32),
            (rng.normal(size=(co,)) * 0.01).astype(np.float32)), (m1, m2)


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_forward_matches_jax(shape):
    arrays, modes = _inputs(shape)
    with precision("highest"):
        want = np.asarray(jax_fused(*map(jnp.asarray, arrays), *modes))
        got = sf.fused_fno_layer_2d(*map(torch.from_numpy, arrays), *modes).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_gradients_match_jax(shape):
    arrays, modes = _inputs(shape)
    with precision("highest"):
        g_jax = jax.grad(lambda *a: jnp.sum(jax_fused(*a, *modes) ** 2),
                         argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
        ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        (sf.fused_fno_layer_2d(*ts, *modes) ** 2).sum().backward()
    for t, g in zip(ts, g_jax):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=3e-5, atol=3e-5)


def test_layer_reference_matches_jax():
    arrays, modes = _inputs(SHAPES["jax_test"])
    with precision("highest"):
        want = np.asarray(jax_layer_reference(*map(jnp.asarray, arrays), *modes))
        got = sf._layer_reference(*map(torch.from_numpy, arrays), *modes).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_shapes_and_cpu_route():
    """Output shape and finiteness; on the CPU the wrapper is the plain
    version, f32 whatever the module precision, and counts no launch."""
    arrays, modes = _inputs(SHAPES["odd"])
    ts = [torch.from_numpy(a) for a in arrays]
    sf.reset_launch_counts()
    with precision("default"):
        out = sf.spectral_fused_layer(*ts, *modes)
        assert torch.equal(out, sf.fused_fno_layer_2d_plain(*ts, *modes))
    with precision("highest"):
        assert torch.equal(out, sf.fused_fno_layer_2d_plain(*ts, *modes))
    assert out.shape == (*ts[0].shape[:3], ts[3].shape[1])
    assert bool(torch.isfinite(out).all())
    assert sf.LAUNCHES["spectral_fused"] == 0
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        sf.spectral_fused_layer(*(t.to("meta") for t in ts), *modes)
