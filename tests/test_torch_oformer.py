"""The comparison models of the port (``sciml_pde_torch/models/oformer.py``,
``models/hyena.py``) against the JAX package's, class by class, from one
flax tree (``utils/weights.py::oformer_flax_to_state_dict``, every key
matched, ``strict=True``): every output within 1e-5 of its largest
magnitude, on inputs made with numpy from a seed, at small widths; the pad
masks drop rows; ``fftconv`` and the functions beside it; Hyena's ``l_max``
refusal; the decoder's latent rollout with and without ``remat``, in value and
gradient; ``B`` takes no gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sciml_pde_torch.models.hyena as th
import sciml_pde_torch.models.oformer as to
from sciml_pde_torch.utils.weights import oformer_flax_to_state_dict, oformer_state_dict_to_flax

from _torch_parity import few_threads, to_numpy_tree  # noqa: F401

TOL = 1e-5
RNG = np.random.default_rng(0)
B, N = 2, 16
X = RNG.normal(size=(B, N, 5)).astype(np.float32)
POS = RNG.uniform(size=(B, N, 2)).astype(np.float32)
POS1 = RNG.uniform(size=(B, N, 1)).astype(np.float32)
PAD = np.ones((B, N), bool)
PAD[1, 10:] = False
BOUND = RNG.uniform(size=(B, N)) < 0.3
XS = RNG.normal(size=(B, 4, N, 6)).astype(np.float32)
NT = RNG.integers(0, 3, size=(B, N)).astype(np.int32)
Z = RNG.normal(size=(B, N, 8)).astype(np.float32)


def _jx(a):
    return a if isinstance(a, (int, float)) else jnp.asarray(a)


def _tx(a):
    if isinstance(a, (int, float)):
        return a
    t = torch.as_tensor(a)
    return t.long() if t.dtype == torch.int32 else t


def _close(want, got, what):
    want, got = np.asarray(want), got.detach().numpy()
    assert want.shape == got.shape, (what, want.shape, got.shape)
    err = np.abs(want - got).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL, (what, err)


def _jo():
    import sciml_pde_tpu.models.oformer as jo
    return jo


def _jh():
    import sciml_pde_tpu.models.hyena as jh
    return jh


# (name, JAX module, the port's module, args, keyword arguments, method)
CASES = {
    "linear_attention_galerkin": (lambda: _jo().LinearAttention(8, heads=2, dim_head=4),
                                  lambda: to.LinearAttention(5, 8, heads=2, dim_head=4),
                                  (X, POS), {}),
    "linear_attention_fourier_masked": (
        lambda: _jo().LinearAttention(8, "fourier", heads=2, dim_head=4, scale=16.0),
        lambda: to.LinearAttention(5, 8, "fourier", heads=2, dim_head=4, scale=16.0),
        (X, POS), {"mask": PAD}),
    "linear_attention_1d": (
        lambda: _jo().LinearAttention(8, heads=2, dim_head=4, relative_emb_dim=1),
        lambda: to.LinearAttention(5, 8, heads=2, dim_head=4, relative_emb_dim=1),
        (X, POS1), {}),
    "cross_linear_attention_masked": (
        lambda: _jo().CrossLinearAttention(6, heads=4, dim_head=4),
        lambda: to.CrossLinearAttention(5, 6, heads=4, dim_head=4, z_dim=8),
        (X, Z, POS, POS), {"mask": PAD}),
    "feed_forward": (lambda: _jo().FeedForward(5, 7), lambda: to.FeedForward(5, 7), (X,), {}),
    "galerkin_transformer_masked": (
        lambda: _jo().GalerkinTransformer(5, 2, 2, 4, 7, scales=(32, 1)),
        lambda: to.GalerkinTransformer(5, 2, 2, 4, 7, scales=(32, 1)),
        (X, POS), {"mask": PAD}),
    "encoder": (lambda: _jo().SpatialTemporalEncoder2D(5, 8, 12, 2, 3),
                lambda: to.SpatialTemporalEncoder2D(5, 8, 12, 2, 3), (X, POS), {}),
    "fourier_features": (lambda: _jo().GaussianFourierFeatureTransform(4),
                         lambda: to.GaussianFourierFeatureTransform(2, 4), (POS,), {}),
    "decoder": (lambda: _jo().PointWiseDecoder2D(8, 2, 1, 2),
                lambda: to.PointWiseDecoder2D(8, 2, 1, 2), (Z, POS, POS), {}),
    "oformer2d": (lambda: _jo().OFormer2D(5, 2, 8, 16, 2, 2, propagator_depth=1),
                  lambda: to.OFormer2D(5, 2, 8, 16, 2, 2, propagator_depth=1), (X, POS), {}),
    "oformer1d": (lambda: _jo().OFormer1D(5, 1, 8, 8, 2, 3),
                  lambda: to.OFormer1D(5, 1, 8, 8, 2, 3), (X, POS1), {}),
    "oformer_irreg2d": (lambda: _jo().OFormerIrreg2D(5, 8),
                        lambda: to.OFormerIrreg2D(5, 8), (X, POS, PAD, BOUND), {}),
    "oformer_irreg_st2d_masked": (
        lambda: _jo().OFormerIrregST2D(6, 4, emb_dim=8, latent_channels=8, depth=3),
        lambda: to.OFormerIrregST2D(6, 4, emb_dim=8, latent_channels=8, depth=3),
        (XS, NT, POS, 2), {"pad_mask": PAD}),
    "hyena_operator": (lambda: _jh().HyenaOperator(8, l_max=20, filter_order=16),
                       lambda: th.HyenaOperator(8, l_max=20, filter_order=16), (Z,), {}),
    "hyena_block": (lambda: _jh().Hyena1dBlock(8, branches=2, l_max=16),
                    lambda: th.Hyena1dBlock(8, branches=2, l_max=16), (Z,), {}),
    "hyena_oformer2d": (lambda: _jh().HyenaOFormer2D(5, 2, 8, 16, 2, 2, branches=2, l_max=16),
                        lambda: th.HyenaOFormer2D(5, 2, 8, 16, 2, 2, branches=2, l_max=16),
                        (X, POS), {}),
}


@pytest.mark.parametrize("name", CASES)
def test_module_matches_jax(name):
    make_j, make_t, args, kw = CASES[name]
    jm, tm = make_j(), make_t()
    jargs = [_jx(a) for a in args]
    jkw = {k: _jx(v) for k, v in kw.items()}
    params = jm.init(jax.random.PRNGKey(3), *jargs, **jkw)["params"]
    tree = to_numpy_tree(params)
    tm.load_state_dict(oformer_flax_to_state_dict(tree), strict=True)
    want = jm.apply({"params": params}, *jargs, **jkw)
    got = tm(*[_tx(a) for a in args], **{k: _tx(v) for k, v in kw.items()})
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    for i, (w, g) in enumerate(zip(want, got)):
        _close(w, g, f"{name} output {i}")
    back = oformer_state_dict_to_flax(tm.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)


@pytest.mark.parametrize("depth,remat", [(2, False), (1, True)])
def test_decoder_rollout_matches_jax_scan(depth, remat):
    """``PointWiseDecoder2D.rollout`` (JAX's lax.scan, jax.checkpoint under
    remat) in value and in the gradients of the parameters and the latent,
    from the same latent: the models' rollouts are the encoder (above) and
    this."""
    jm = _jo().PointWiseDecoder2D(16, 2, 1, depth, remat=remat)
    tm = to.PointWiseDecoder2D(16, 2, 1, depth, remat=remat)
    z = RNG.normal(size=(B, N, 16)).astype(np.float32)
    args = (jnp.asarray(z), jnp.asarray(POS), 3, jnp.asarray(POS))
    params = jm.init(jax.random.PRNGKey(4), args[0], args[1], args[3])["params"]
    tm.load_state_dict(oformer_flax_to_state_dict(to_numpy_tree(params)))
    cot = RNG.normal(size=(B, N, 6)).astype(np.float32)

    def jloss(p, zz):
        out = jm.apply({"params": p}, zz, *args[1:], method=_jo().PointWiseDecoder2D.rollout)
        return jnp.sum(out * cot), out
    (_, want), (grads, gz) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, args[0])
    tz = torch.as_tensor(z).requires_grad_(True)
    got = tm.rollout(tz, torch.as_tensor(POS), 3, torch.as_tensor(POS))
    _close(want, got, "rollout")
    (got * torch.as_tensor(cot)).sum().backward()
    _close(gz, tz.grad, "d latent")
    flat = dict(tm.named_parameters())
    for path, g in jax.tree_util.tree_leaves_with_path(to_numpy_tree(grads)):
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        tg = flat[name].grad
        if name.endswith(".B"):
            assert tg is None and not np.any(g)  # stop_gradient / detach
            continue
        _close(g, tg, name)


def test_functions_match_jax():
    jo, jh = _jo(), _jh()
    coords = RNG.uniform(size=(B, N)).astype(np.float32)
    for dim, scale in ((4, 1.0), (8, 16.0)):
        _close(jo.rotary_freqs(jnp.asarray(coords), dim, 1 / 64, scale),
               to.rotary_freqs(torch.as_tensor(coords), dim, 1 / 64, scale), "rotary_freqs")
    t = RNG.normal(size=(B, 2, N, 8)).astype(np.float32)
    f = RNG.normal(size=(B, 1, N, 4)).astype(np.float32)
    _close(jo.apply_2d_rotary_pos_emb(jnp.asarray(t), jnp.asarray(f), jnp.asarray(f[..., ::-1])),
           to.apply_2d_rotary_pos_emb(torch.as_tensor(t), torch.as_tensor(f),
                                      torch.as_tensor(f[..., ::-1].copy())), "2d rotary")
    _close(jo._instance_norm(jnp.asarray(t)), to._instance_norm(torch.as_tensor(t)),
           "instance norm")
    u = RNG.normal(size=(B, 8, 24)).astype(np.float32)
    k = RNG.normal(size=(8, 24)).astype(np.float32)
    d = RNG.normal(size=(8,)).astype(np.float32)
    _close(jh.fftconv(jnp.asarray(u), jnp.asarray(k), jnp.asarray(d)),
           th.fftconv(torch.as_tensor(u), torch.as_tensor(k), torch.as_tensor(d)), "fftconv")
    for a, b in zip(jh.positional_embedding(5, 30), th.positional_embedding(5, 30)):
        np.testing.assert_array_equal(a, b)
    tt = th.positional_embedding(3, 30)[1]
    xx = RNG.normal(size=(1, 30, 6)).astype(np.float32)
    _close(jh.ExponentialModulation(6).apply({}, jnp.asarray(tt), jnp.asarray(xx)),
           th.ExponentialModulation(6)(torch.as_tensor(tt), torch.as_tensor(xx)), "modulation")
    jf = jh.HyenaFilter(6, order=16, seq_len=30)
    params = jf.init(jax.random.PRNGKey(5), 20, method=jh.HyenaFilter.filter)["params"]
    tf = th.HyenaFilter(6, order=16, seq_len=30)
    tf.load_state_dict(oformer_flax_to_state_dict(to_numpy_tree(params)))
    _close(jf.apply({"params": params}, 20, method=jh.HyenaFilter.filter), tf.filter(20),
           "HyenaFilter.filter")
    s = jh.Sin(4, 3.0)
    sp = s.init(jax.random.PRNGKey(0), jnp.asarray(Z[..., :4]))["params"]
    _close(s.apply({"params": sp}, jnp.asarray(Z[..., :4])), th.Sin(4, 3.0)(torch.as_tensor(
        Z[..., :4])), "Sin")


def test_hyena_refuses_a_sequence_past_l_max():
    jm, tm = _jh().HyenaOperator(8, l_max=8), th.HyenaOperator(8, l_max=8)
    with pytest.raises(ValueError) as want:
        jm.init(jax.random.PRNGKey(0), jnp.asarray(Z))
    with pytest.raises(ValueError) as got:
        tm(torch.as_tensor(Z))
    assert str(got.value) == str(want.value)
