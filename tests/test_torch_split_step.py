"""Port the five split kernels of ops/fno_fused_step.py (``_bb_forward``,
``_head_forward``, ``_head_backward``, ``_bb_backward``,
``_bb_weight_grads``) vs the JAX module's Pallas kernels run in interpret
mode: each port function on the JAX chain's own inputs, its outputs against
the JAX outputs sliced to the logical region, under `highest` and
`default`; then the port's five chained against the fused VJP."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_tpu.ops import fno_fused_step as jf
from sciml_pde_torch.ops import fno_fused_step as tf
from sciml_pde_torch.ops import fno_kernels as tk

from _torch_parity import precision, to_numpy_tree

B, X, Y, T, CC = 2, 16, 16, 3, 2
WIDTH, MODES, PAD = 8, 4, 2
HP, WP = X + PAD, Y + PAD
# Errors are held against the largest magnitude of the JAX output.
# `highest`: f32 products summed in another order.
TOL_HIGHEST = 1e-5
# `default` rounds every dot input to bf16 (relative resolution 2^-8); the
# two packages round at the same points, but a sum taken in another order
# can land on the other side of a rounding boundary (5.2e-5 at most
# measured).  The bound lies below the gap between f32 and bf16 dot inputs
# (1.0e-3 at least) and below the gap that bf16 mix weights in
# `_bb_backward` or a bf16 spectrum in `_bb_weight_grads` open (2.1e-3 at
# least); the tests check both.
TOL_DEFAULT = 5e-4
# The head's hidden activation is rounded to bf16 after the gelu, whose erf
# the JAX kernel takes from a polynomial (absolute error 1.5e-7): values
# near a rounding boundary round the other way (2.5e-3 measured; the
# f32-vs-bf16 gap is 1.35e-2).
TOL_DEFAULT_HEAD_FORWARD = 5e-3


def _tol(name, prec):
    if prec == "highest":
        return TOL_HIGHEST
    return TOL_DEFAULT_HEAD_FORWARD if name == "head_forward" else TOL_DEFAULT


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, X, Y, T, CC)).astype(np.float32)
    gx, gy = np.meshgrid(np.linspace(0, 1, X, dtype=np.float32),
                         np.linspace(0, 1, Y, dtype=np.float32), indexing="ij")
    grid = np.stack([gx, gy], -1)
    params = to_numpy_tree(
        FlaxFNO2d(num_channels=CC, modes1=MODES, modes2=MODES, width=WIDTH, initial_step=T)
        .init(jax.random.PRNGKey(1), x, np.broadcast_to(grid[None], (B, X, Y, 2)))["params"])
    win = np.ascontiguousarray(np.transpose(x, (0, 3, 4, 1, 2)))  # (B, T, Cc, X, Y)
    grid2 = np.ascontiguousarray(np.transpose(grid, (2, 0, 1)))   # (2, X, Y)
    cot = rng.normal(size=(B, CC, X, Y)).astype(np.float32)
    return params, win, grid2, cot


def _logical(name, a):
    """A JAX output or input in the port's logical layout (the JAX arrays
    carry tile padding that changes no result)."""
    a = np.asarray(a)
    if name in ("pre", "dpre"):
        return a[:, :, :, :HP, :WP]
    if name == "h0p":
        return a[:, :, :HP, :WP]
    if name in ("dwmr", "dwmi"):
        return a[:, :, :, :MODES, :2 * MODES]
    return a


_CHAINS = {}


def _jax_chain(setup, prec):
    """Every input and output of the JAX split chain (interpret mode)."""
    if prec in _CHAINS:
        return _CHAINS[prec]
    params, win, grid2, cot = setup
    fp = jf.pack_params(params, MODES, MODES)
    with precision(prec):
        pre, bbout, stats, h0p = jf._bb_forward(win, grid2, fp, MODES, MODES, PAD)
        pred = jf._head_forward(bbout, stats, fp)
        dbb, dw1t, db1, dw2t, db2 = jf._head_backward(cot, bbout, stats, fp)
        dpre, dw0t, db0 = jf._bb_backward(dbb, pre, win, grid2, stats, fp, MODES, MODES, PAD)
        dwmr, dwmi, dpw, dpb = jf._bb_weight_grads(pre, h0p, dpre, fp, MODES, MODES, PAD, X, Y)
    out = {k: _logical(k, v) for k, v in dict(
        pre=pre, bbout=bbout, stats=stats, h0p=h0p, pred=pred, dbb=dbb, dw1t=dw1t, db1=db1,
        dw2t=dw2t, db2=db2, dpre=dpre, dw0t=dw0t, db0=db0, dwmr=dwmr, dwmi=dwmi, dpw=dpw,
        dpb=dpb).items()}
    _CHAINS[prec] = out
    return out


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# each split function: its inputs from the JAX chain and its output names
OUTPUTS = {
    "bb_forward": ("pre", "bbout", "stats", "h0p"),
    "head_forward": ("pred",),
    "head_backward": ("dbb", "dw1t", "db1", "dw2t", "db2"),
    "bb_backward": ("dpre", "dw0t", "db0"),
    "bb_weight_grads": ("dwmr", "dwmi", "dpw", "dpb"),
}


def _port_call(name, j, setup, p, ops=tk.KERNELS):
    _, win, grid2, cot = setup
    w, g2 = _t(win), _t(grid2)
    if name == "bb_forward":
        return tf._bb_forward(w, g2, p, MODES, MODES, PAD, ops=ops)
    if name == "head_forward":
        return (tf._head_forward(_t(j["bbout"]), _t(j["stats"]), p, ops=ops),)
    if name == "head_backward":
        return tf._head_backward(_t(cot), _t(j["bbout"]), _t(j["stats"]), p, ops=ops)
    if name == "bb_backward":
        return tf._bb_backward(_t(j["dbb"]), _t(j["pre"]), w, g2, _t(j["stats"]), p, MODES,
                               MODES, PAD, ops=ops)
    return tf._bb_weight_grads(_t(j["pre"]), _t(j["h0p"]), _t(j["dpre"]), p, MODES, MODES, PAD,
                               X, Y, ops=ops)


def _rel_errs(name, got, j):
    return {k: float(np.abs(g.numpy() - j[k]).max() / np.abs(j[k]).max())
            for k, g in zip(OUTPUTS[name], got)}


@pytest.mark.parametrize("prec", ["highest", "default"])
@pytest.mark.parametrize("name", list(OUTPUTS))
def test_split_function_matches_jax(setup, name, prec):
    """The port function on the JAX chain's inputs against the JAX kernel's
    outputs, each within _tol(name, prec) of its largest magnitude.  Under
    `default` the port with f32 dot inputs lies outside that bound."""
    j = _jax_chain(setup, prec)
    p = tf.pack_params(setup[0], MODES, MODES)
    with precision(prec):
        got = _port_call(name, j, setup, p)
    assert len(got) == len(OUTPUTS[name])
    for k, g in zip(OUTPUTS[name], got):
        assert g.dtype == torch.float32 and tuple(g.shape) == j[k].shape, (k, g.shape)
    errs = _rel_errs(name, got, j)
    assert max(errs.values()) <= _tol(name, prec), errs
    if prec == "default":
        with precision("highest"):
            gap = _rel_errs(name, _port_call(name, j, setup, p), j)
        assert max(gap.values()) > 2 * _tol(name, prec), gap


def test_split_default_keeps_its_own_dtypes(setup):
    """Under `default` a port that took the fused step's bf16 mix weights in
    `_bb_backward`, or its bf16 spectrum in `_bb_weight_grads`, lies
    outside TOL_DEFAULT (dw0t and db0, dwmr and dwmi); the port lies inside
    it."""
    j = _jax_chain(setup, "default")
    p = tf.pack_params(setup[0], MODES, MODES)
    rd = lambda t: t.bfloat16().float()  # noqa: E731
    p_bf = p._replace(wmr=rd(p.wmr), wmi=rd(p.wmi))

    def bf16_spectrum_corner(a, pf, w, q, adj, spec_dtype, bf, spec_only=False):
        return tk.corner_plain(a, pf, w, q, adj, spec_dtype if adj else torch.bfloat16, bf,
                               spec_only)

    ops_bf = SimpleNamespace(**{**vars(tk.PLAIN), "corner": bf16_spectrum_corner})
    with precision("default"):
        bwd = _rel_errs("bb_backward", _port_call("bb_backward", j, setup, p), j)
        bwd_ctl = _rel_errs("bb_backward", _port_call("bb_backward", j, setup, p_bf), j)
        wg = _rel_errs("bb_weight_grads", _port_call("bb_weight_grads", j, setup, p), j)
        wg_ctl = _rel_errs("bb_weight_grads",
                           _port_call("bb_weight_grads", j, setup, p, ops=ops_bf), j)
    assert max(bwd.values()) <= TOL_DEFAULT < max(bwd_ctl.values()), (bwd, bwd_ctl)
    assert max(wg.values()) <= TOL_DEFAULT < max(wg_ctl["dwmr"], wg_ctl["dwmi"]), (wg, wg_ctl)


def _port_chain(setup, p):
    params, win, grid2, cot = setup
    w, g2 = _t(win), _t(grid2)
    pre, bbout, stats, h0p = tf._bb_forward(w, g2, p, MODES, MODES, PAD)
    pred = tf._head_forward(bbout, stats, p)
    dbb, dw1t, db1, dw2t, db2 = tf._head_backward(_t(cot), bbout, stats, p)
    dpre, dw0t, db0 = tf._bb_backward(dbb, pre, w, g2, stats, p, MODES, MODES, PAD)
    dwmr, dwmi, dpw, dpb = tf._bb_weight_grads(pre, h0p, dpre, p, MODES, MODES, PAD, X, Y)
    return pred, tf.FastFNOParams(dwmr, dwmi, dpw, dpb, dw0t, db0, dw1t, db1, dw2t, db2)


@pytest.mark.parametrize("ref", ["port_vjp_reference", "jax_vjp"])
def test_split_chain_equals_fused_vjp(setup, ref):
    """The five chained (`highest`): the prediction and the ten parameter
    cotangents of sum(pred * cot) within 1e-5 of each one's largest
    magnitude, against the port's plain fused VJP or jax.vjp of the JAX
    reference composition."""
    params, win, grid2, cot = setup
    p = tf.pack_params(params, MODES, MODES)
    with precision("highest"):
        pred, grads = _port_chain(setup, p)
        if ref == "port_vjp_reference":
            w, g2 = _t(win), _t(grid2)
            want_pred = tf.fno2d_fused_reference(w, g2, p, MODES, MODES, PAD).numpy()
            want = tf.unpack_grads(tf.fno2d_fused_vjp_reference(_t(cot), w, g2, p, MODES, MODES,
                                                                PAD), MODES, MODES)
            want = {k: v.numpy() for k, v in jax.tree_util.tree_leaves_with_path(want)}
        else:
            fp = jf.pack_params(params, MODES, MODES)

            @jax.jit
            def ref_vjp(q, c):
                out, vjp = jax.vjp(
                    lambda q: jf.fno2d_fused_reference(win, grid2, q, MODES, MODES, PAD), q)
                return out, vjp(c)[0]

            want_pred, g = ref_vjp(fp, jnp.asarray(cot))
            want = dict(jax.tree_util.tree_leaves_with_path(
                to_numpy_tree(jf.unpack_grads(g, MODES, MODES, params))))
    got = dict(jax.tree_util.tree_leaves_with_path(tf.unpack_grads(grads, MODES, MODES)))
    want_pred = np.asarray(want_pred)
    assert np.abs(pred.numpy() - want_pred).max() <= 1e-5 * np.abs(want_pred).max()
    assert len(want) == len(got) == 22  # the ten packed cotangents as flax leaves
    for path, leaf in want.items():
        err = np.abs(got[path].numpy() - leaf).max()
        assert err <= 1e-5 * np.abs(leaf).max(), (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("fn", ["head_forward", "head_backward"])
def test_head_rejects_uneven_chunks(setup, fn):
    """As the JAX kernels: X*Y must split evenly into n_chunks."""
    p = tf.pack_params(setup[0], MODES, MODES)
    bbout = torch.zeros(B, WIDTH, X, Y)
    stats = torch.ones(B, CC, 2)
    with pytest.raises(ValueError, match="chunk"):
        if fn == "head_forward":
            tf._head_forward(bbout, stats, p, n_chunks=3)
        else:
            tf._head_backward(torch.zeros(B, CC, X, Y), bbout, stats, p, n_chunks=3)


def test_split_cpu_counts_no_launch(setup):
    """On CPU tensors every stage runs its plain version: no kernel launch
    and no split call is counted."""
    p = tf.pack_params(setup[0], MODES, MODES)
    tk.reset_launch_counts()
    tf.reset_split_counts()
    with precision("highest"):
        _port_chain(setup, p)
    assert sum(tk.LAUNCHES.values()) == 0
    assert sum(tf.SPLIT_LAUNCHES.values()) == 0
