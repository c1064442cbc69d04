"""Port ops/fno_fused_step.py vs the JAX module: the CPU fused apply (the
kernels' plain versions composed as on the card) against the JAX reference
composition and the JAX Pallas kernels run in interpret mode, values and
all ten gradients, at width 8, at width 40 and on a 16 x 40 field; the lift
and head kernels' plain versions at width 64 with 9 output channels, and
the mode mix's weight-gradient plain version over batches 1-8; CPU
rehearsals of the kernels' summation orders against the bounds
chip_smoke.py holds them to; the wrappers' shared-memory plans and the
limits they name."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_tpu.ops import fno_fused_step as jf
from sciml_pde_torch.ops import fno_fused_step as tf
from sciml_pde_torch.ops import fno_kernels as tk
from sciml_pde_torch.utils.weights import flax_to_packed, packed_to_flax

from _torch_parity import assert_trees_close, chip_smoke, precision, to_numpy_tree

B, X, Y, T, CC = 2, 16, 16, 3, 2
WIDTH, MODES = 8, 4
# values: as the JAX package's own fused-step tests; grads: the same
VAL_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)
# `default` rounds every dot input to bf16 (8 mantissa bits, relative
# resolution 2^-8 = 3.9e-3); the two packages round at the same points
# but sum in other orders, so a value can land on the other side of a
# rounding boundary.  Errors are held against the largest magnitude.
BF16_REL_TO_MAX = 3e-2
# fault C6: a width and an output-channel count above the 32 and 8 that the
# first lift and head kernels held in registers (JAX's fused step takes any)
WIDE, OP_C, OP_CO = 40, 64, 9
# faults C7 and C8 hang on the field's two padded sizes apart (the W-DFT and
# inverse-W kernels on Wp, the corner kernel on Hp): a field with X != Y
NON_SQUARE = (16, 40)


def _make_setup(width, cc, nx=X, ny=Y):
    """Seeded inputs and a flax FNO2d tree: params, win (B, T, Cc, nx, ny),
    grid2 (2, nx, ny) and a cotangent (B, Cc, nx, ny)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, nx, ny, T, cc)).astype(np.float32)
    gx, gy = np.meshgrid(np.linspace(0, 1, nx, dtype=np.float32),
                         np.linspace(0, 1, ny, dtype=np.float32), indexing="ij")
    grid = np.stack([gx, gy], -1)
    gridb = np.broadcast_to(grid[None], (B, nx, ny, 2))
    params = to_numpy_tree(
        FlaxFNO2d(num_channels=cc, modes1=MODES, modes2=MODES, width=width,
                  initial_step=T).init(jax.random.PRNGKey(1), x, gridb)["params"])
    win = np.ascontiguousarray(np.transpose(x, (0, 3, 4, 1, 2)))  # (B, T, Cc, X, Y)
    grid2 = np.ascontiguousarray(np.transpose(grid, (2, 0, 1)))   # (2, X, Y)
    cot = rng.normal(size=(B, cc, nx, ny)).astype(np.float32)
    return params, win, grid2, cot


@pytest.fixture(scope="module")
def setup():
    return _make_setup(WIDTH, CC)


@pytest.fixture(scope="module")
def setup_wide():
    return _make_setup(WIDE, CC)


@pytest.fixture(scope="module")
def setup_non_square():
    return _make_setup(WIDTH, CC, *NON_SQUARE)


def _port_apply(params, win, grid2, cot):
    p = tf.pack_params(params, MODES, MODES)
    p = tf.FastFNOParams(*(t.requires_grad_(True) for t in p))
    pred = tf.fno2d_fused_apply(torch.from_numpy(win), torch.from_numpy(grid2), p, MODES, MODES)
    (pred * torch.from_numpy(cot)).sum().backward()
    grads = tf.unpack_grads(tf.FastFNOParams(*(t.grad for t in p)), MODES, MODES)
    return pred.detach().numpy(), grads


def _jax_grads(fn, params, win, grid2, cot):
    fp = jf.pack_params(params, MODES, MODES)
    g = jax.grad(lambda q: jnp.sum(fn(win, grid2, q, MODES, MODES) * cot))(fp)
    return to_numpy_tree(jf.unpack_grads(g, MODES, MODES, params))


@pytest.mark.parametrize("jax_fn", ["reference", "pallas_interpret"])
def test_fused_apply_matches_jax(setup, jax_fn):
    params, win, grid2, cot = setup
    with precision("highest"):
        pred, grads = _port_apply(params, win, grid2, cot)
        fp = jf.pack_params(params, MODES, MODES)
        if jax_fn == "reference":
            want = jf.fno2d_fused_reference(win, grid2, fp, MODES, MODES)
        else:
            want = jf.fno2d_fused_apply(win, grid2, fp, MODES, MODES)
        np.testing.assert_allclose(pred, np.asarray(want), **VAL_TOL)
        if jax_fn == "pallas_interpret":
            want_g = _jax_grads(jf.fno2d_fused_apply, params, win, grid2, cot)
        else:
            want_g = _jax_grads(jf.fno2d_fused_reference, params, win, grid2, cot)
    assert_trees_close(grads, want_g, what="grad", **GRAD_TOL)


def test_plain_reference_and_vjp_match_jax(setup):
    """The whole-model plain reference and the plain hand-written VJP."""
    params, win, grid2, cot = setup
    with precision("highest"):
        p = tf.pack_params(params, MODES, MODES)
        w, g2 = torch.from_numpy(win), torch.from_numpy(grid2)
        pred = tf.fno2d_fused_reference(w, g2, p, MODES, MODES).numpy()
        vjp = tf.fno2d_fused_vjp_reference(torch.from_numpy(cot), w, g2, p, MODES, MODES)
        fp = jf.pack_params(params, MODES, MODES)
        want = np.asarray(jf.fno2d_fused_reference(win, grid2, fp, MODES, MODES))
        want_g = _jax_grads(jf.fno2d_fused_reference, params, win, grid2, cot)
    np.testing.assert_allclose(pred, want, **VAL_TOL)
    assert_trees_close(tf.unpack_grads(vjp, MODES, MODES), want_g, what="vjp", **GRAD_TOL)


def test_fused_apply_bf16_default_matches_jax(setup):
    params, win, grid2, cot = setup
    with precision("default"):
        pred, grads = _port_apply(params, win, grid2, cot)
        fp = jf.pack_params(params, MODES, MODES)
        want = np.asarray(jf.fno2d_fused_reference(win, grid2, fp, MODES, MODES))
        want_g = _jax_grads(jf.fno2d_fused_apply, params, win, grid2, cot)
    assert np.abs(pred - want).max() <= BF16_REL_TO_MAX * np.abs(want).max()
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want_g):
        err = np.abs(got[path].numpy() - leaf).max()
        assert err <= BF16_REL_TO_MAX * np.abs(leaf).max() + 1e-6, (path, err)


@pytest.mark.parametrize("prec", ["highest", "default"])
@pytest.mark.parametrize("jax_fn", ["reference", "pallas_interpret"])
def test_fused_apply_matches_jax_at_width_40(setup_wide, jax_fn, prec):
    """Fault C6: the fused step at width 40, which JAX's fused step takes and
    the first lift and head kernels refused on the card.  The CPU fused apply
    (the plain versions the kernels are held to) against JAX's reference
    composition or its Pallas kernels in interpret mode, the value and all
    ten gradients: under `highest` within the f32 tolerances of the width-8
    case, under `default` within BF16_REL_TO_MAX of each one's largest
    magnitude."""
    params, win, grid2, cot = setup_wide
    fn = jf.fno2d_fused_reference if jax_fn == "reference" else jf.fno2d_fused_apply
    with precision(prec):
        pred, grads = _port_apply(params, win, grid2, cot)
        fp = jf.pack_params(params, MODES, MODES)
        want = np.asarray(fn(win, grid2, fp, MODES, MODES))
        want_g = _jax_grads(fn, params, win, grid2, cot)
    assert pred.shape == want.shape == (B, CC, X, Y)
    if prec == "highest":
        np.testing.assert_allclose(pred, want, **VAL_TOL)
        assert_trees_close(grads, want_g, what="grad", **GRAD_TOL)
        return
    assert np.abs(pred - want).max() <= BF16_REL_TO_MAX * np.abs(want).max()
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want_g):
        err = np.abs(got[path].numpy() - leaf).max()
        assert err <= BF16_REL_TO_MAX * np.abs(leaf).max() + 1e-6, (path, err)


@pytest.mark.parametrize("prec", ["highest", "default"])
def test_fused_apply_matches_jax_non_square(setup_non_square, prec):
    """The fused step on a 16 x 40 field (Hp = 18, Wp = 42): the CPU fused
    apply against JAX's fused step with its Pallas kernels in interpret
    mode, the value and all ten gradients, from the same numpy-seeded
    window, cotangent and flax tree: under `highest` within the f32
    tolerances of the width-8 case, under `default` within BF16_REL_TO_MAX
    of each one's largest magnitude."""
    params, win, grid2, cot = setup_non_square
    with precision(prec):
        pred, grads = _port_apply(params, win, grid2, cot)
        fp = jf.pack_params(params, MODES, MODES)
        want = np.asarray(jf.fno2d_fused_apply(win, grid2, fp, MODES, MODES))
        want_g = _jax_grads(jf.fno2d_fused_apply, params, win, grid2, cot)
    assert pred.shape == want.shape == (B, CC, *NON_SQUARE)
    if prec == "highest":
        np.testing.assert_allclose(pred, want, **VAL_TOL)
        assert_trees_close(grads, want_g, what="grad", **GRAD_TOL)
        return
    assert np.abs(pred - want).max() <= BF16_REL_TO_MAX * np.abs(want).max()
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want_g):
        err = np.abs(got[path].numpy() - leaf).max()
        assert err <= BF16_REL_TO_MAX * np.abs(leaf).max() + 1e-6, (path, err)


@pytest.fixture(scope="module")
def op_setup():
    """Width 64 and 9 channels: a flax tree, a window, and seeded head
    inputs bbout (B, 64, X, Y), stats (B, 9, 2) and dpred (B, 9, X, Y)."""
    params, win, grid2, dpred = _make_setup(OP_C, OP_CO)
    rng = np.random.default_rng(7)
    bbout = rng.normal(size=(B, OP_C, X, Y)).astype(np.float32)
    stats = np.stack([rng.normal(size=(B, OP_CO)), rng.uniform(0.5, 2.0, size=(B, OP_CO))],
                     -1).astype(np.float32)
    return params, win, grid2, bbout, stats, dpred


# the ops at width 64 against JAX's split kernels, rel-to-max: f32 products
# summed in another order (`highest`); under `default` the hidden activation
# and dpre1 are rounded to bf16 after a gelu whose erf the JAX kernel takes
# from a polynomial, so values near a rounding boundary round the other way
# (1.1e-4 at most measured, against bf16-vs-f32 gaps of 1.8e-3 and more)
OP_TOL = {"highest": 1e-5, "default": 5e-4}


def _plain_op(op, setup, bf, jax_stats=None):
    params, win, grid2, bbout, stats, dpred = setup
    p = tf.pack_params(params, MODES, MODES)
    rd = lambda t: tk._rd(t, bf)  # noqa: E731
    t = torch.from_numpy
    if op == "lift":
        st = t(np.array(jax_stats))
        return (tk.lift_plain(t(win), t(grid2), st[..., 0], st[..., 1], rd(p.w0t), p.b0, X + 2,
                              Y + 2, bf)[0],)
    if op == "head_fwd":
        return (tk.head_fwd_plain(t(bbout), rd(p.w1t), p.b1, rd(p.w2t), p.b2,
                                  t(stats[..., 0]), t(stats[..., 1]), X, Y, bf),)
    return tk.head_bwd_plain(t(dpred), t(bbout), rd(p.w1t), p.b1, rd(p.w2t), t(stats[..., 1]),
                             bf)


@pytest.mark.parametrize("prec", ["highest", "default"])
@pytest.mark.parametrize("op", ["lift", "head_fwd", "head_bwd"])
def test_lift_and_head_plain_match_jax_at_width_64(op_setup, op, prec):
    """Fault C6 at the op level: ``lift_plain``, ``head_fwd_plain`` and
    ``head_bwd_plain`` at C = 64 with Co = Cc = 9 against JAX's Pallas
    kernels in interpret mode (the lift output h0p of ``_bb_forward``,
    ``_head_forward``, ``_head_backward``), each output within OP_TOL of its
    largest magnitude; under `default` the plain version with f32 dot inputs
    lies outside that bound."""
    params, win, grid2, bbout, stats, dpred = op_setup
    fp = jf.pack_params(params, MODES, MODES)
    with precision(prec):
        if op == "lift":
            _, _, jstats, h0p = jf._bb_forward(win, grid2, fp, MODES, MODES, 2)
            want = [np.asarray(h0p)[:, :, :X + 2, :Y + 2]]
        elif op == "head_fwd":
            jstats, want = None, [np.asarray(jf._head_forward(bbout, stats, fp))]
        else:
            jstats = None
            want = [np.asarray(a) for a in jf._head_backward(dpred, bbout, stats, fp)]
    bf = prec == "default"

    def errs(got):
        return [float(np.abs(g.numpy() - w).max() / np.abs(w).max()) for g, w in zip(got, want)]

    got = _plain_op(op, op_setup, bf, jstats)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert max(errs(got)) <= OP_TOL[prec], errs(got)
    if bf:
        gap = errs(_plain_op(op, op_setup, False, jstats))
        assert max(gap) > 2 * OP_TOL[prec], gap


@pytest.mark.parametrize("spec", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 3, 4, 8])
def test_mix_wgrad_plain_matches_jax_layer_wgrad(b, spec, monkeypatch):
    """mix_wgrad_plain, which fno_mix_wgrad is held to on the card, against
    JAX's dwmr and dwmi of ``_layer_wgrad_el`` summed over the batch from
    zero in order (as ``_full_bwd_kernel`` adds each element's to its
    revisited output block), on the spectra of JAX's ``_spectral_fwd_el``
    and ``_spectral_adj_el``, the forward spectrum in f32 (B2c) or rounded
    to bf16 (as ``_full_bwd_kernel`` saves it under `default`): within
    1e-5 of the largest magnitude (f32 sums of b products in another
    order)."""
    rng = np.random.default_rng(20 + b)
    c, o, hp, wp = 3, 5, X, Y
    f = jf.spectral_factors(hp, wp, MODES, MODES)
    (hpad, rp), (wpad, kp) = f.gr.shape, f.fr.shape
    wmr, wmi = (rng.normal(size=(c, o, kp, rp)).astype(np.float32) for _ in range(2))
    hs = rng.normal(size=(b, c, hpad, wpad)).astype(np.float32)
    dps = rng.normal(size=(b, o, hpad, wpad)).astype(np.float32)
    sdt = jnp.dtype(spec)
    real_fwd_el = jf._spectral_fwd_el

    def fwd_el(h, wr, wi, fac):
        out, (br, bi) = real_fwd_el(h, wr, wi, fac)
        return out, (br.astype(sdt), bi.astype(sdt))

    monkeypatch.setattr(jf, "_spectral_fwd_el", fwd_el)
    with precision("highest"):
        want = [jnp.zeros((c, o, kp, rp), jnp.float32)] * 2
        specs, dspecs = [], []
        for i in range(b):
            dwr, dwi, _, _ = jf._layer_wgrad_el(hs[i], dps[i], wmr, wmi, f)
            want = [want[0] + dwr, want[1] + dwi]
            specs.append(fwd_el(hs[i], wmr, wmi, f)[1])
            dspecs.append(jf._spectral_adj_el(dps[i], wmr, wmi, f)[1])
    as_t = lambda xs, j: torch.from_numpy(  # noqa: E731
        np.stack([np.asarray(x[j].astype(jnp.float32)) for x in xs]))
    spr, spi = (as_t(specs, j).to(getattr(torch, spec)) for j in (0, 1))
    got = tk.mix_wgrad_plain(spr, spi, as_t(dspecs, 0), as_t(dspecs, 1))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-5, (b, spec, err)


def test_pack_unpack_roundtrip(setup):
    params = setup[0]
    p = flax_to_packed(params, MODES)
    assert p.wmr.shape == (4, WIDTH, WIDTH, MODES, 2 * MODES)
    # the packed layout is the JAX package's, without the tile padding
    jp = jf.pack_params(params, MODES, MODES)
    np.testing.assert_array_equal(p.wmr[0].numpy(),
                                  np.asarray(jp.wmr[0])[:, :, :MODES, :2 * MODES])
    assert_trees_close(packed_to_flax(p, MODES), params, 0, 0, "roundtrip")


def test_cpu_fused_apply_is_the_kernels_plain_composition(setup):
    """On CPU tensors every kernel wrapper runs its plain version: no
    launch is counted."""
    from sciml_pde_torch.ops import fno_kernels as k

    params, win, grid2, cot = setup
    k.reset_launch_counts()
    _port_apply(params, win, grid2, cot)
    assert sum(k.LAUNCHES.values()) == 0


@pytest.mark.parametrize("shape", [(2, 3, 2, 16, 16), (3, 1, 3, 17, 13)])
def test_stats_plain_matches_jax_stats_cols_with_offset(shape):
    """``fno_stats``'s plain version against JAX's ``_stats_cols`` per element
    on data offset by 1e3 (unit spread): two-pass numerics give the mean
    and the unbiased std + 1e-7 within rtol 1e-5.  A one-pass
    E[x^2] - E[x]^2 loses about 1e6 * 2^-24 of the variance to cancellation
    here, a std off by a few percent."""
    from sciml_pde_torch.ops import fno_kernels as fk

    win = (np.random.default_rng(9).normal(size=shape) + 1e3).astype(np.float32)
    mean, std = fk.stats_plain(torch.from_numpy(win))
    for b in range(shape[0]):
        mc, sc = jf._stats_cols(jnp.asarray(win[b]))
        np.testing.assert_allclose(mean[b].numpy(), np.asarray(mc)[:, 0], rtol=1e-5)
        np.testing.assert_allclose(std[b].numpy(), np.asarray(sc)[:, 0], rtol=1e-5)


def test_stats_plain_matches_f64_two_pass():
    """``stats_plain`` against a two-pass f64 numpy reference on shifted,
    scaled data: the mean and the unbiased std + 1e-7 within rtol 1e-6."""
    from sciml_pde_torch.ops import fno_kernels as fk

    win = (np.random.default_rng(11).normal(size=(2, 4, 3, 16, 12)) * 3 + 7).astype(np.float32)
    mean, std = fk.stats_plain(torch.from_numpy(win))
    x = np.moveaxis(win, 2, 1).reshape(2, 3, -1).astype(np.float64)
    want_mean = x.mean(-1)
    want_std = np.sqrt(((x - want_mean[..., None]) ** 2).sum(-1) / (x.shape[-1] - 1)) + 1e-7
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-6)
    np.testing.assert_allclose(std.numpy(), want_std, rtol=1e-6)


def _csrc_constants(source, names):
    """Integer constants of a kernel source, ``NAME = value``."""
    import re
    from pathlib import Path

    text = (Path(tf.__file__).resolve().parent / "csrc" / source).read_text()
    return [int(re.search(rf"\b{n} = (\d+)", text).group(1)) for n in names]


def _reduce_rows_in_order(part):
    """``reduce_rows_kernel``'s sum of the rows of ``part`` (f32): the rows cut
    into RR_WARPS * RR_CLUSTER groups of ceil(rows / groups), each summed in
    order, the groups added in warp order within a block, the blocks in
    cluster-rank order."""
    warps, cluster = _csrc_constants("fno_bwd.cu", ("RR_WARPS", "RR_CLUSTER"))
    rows, cols = part.shape
    per = -(-rows // (warps * cluster))
    out = np.zeros(cols, np.float32)
    for r in range(cluster):
        b = np.zeros(cols, np.float32)
        for w in range(warps):
            g = r * warps + w
            s = np.zeros(cols, np.float32)
            for k in range(min(g * per, rows), min((g + 1) * per, rows)):
                s = s + part[k]
            b = b + s
        out = out + b
    return out


@pytest.mark.parametrize("what", ["head backward", "a layer's outer", "the lift's outer"])
def test_reduce_rows_grouped_order_meets_the_card_bound(what):
    """A rehearsal of ``reduce_rows_kernel``'s arithmetic at the three shapes
    the fused step gives it (chip_smoke.rr_shapes): the rows cut into the
    kernel's fixed groups of ceil(rows / groups) (a layer's 353 rows leave a
    ragged last group and empty ones after it), each summed in order in f32, the
    group sums added in warp order, then the blocks' sums in cluster-rank
    order.  It lies within chip_smoke.py's TOL_KERNEL of the plain version
    and within 1e-6 of the f64 sum."""
    from sciml_pde_torch.ops import fno_kernels as fk

    cs = chip_smoke()
    rows, cols = cs.rr_shapes()[what]
    warps, cluster = _csrc_constants("fno_bwd.cu", ("RR_WARPS", "RR_CLUSTER"))
    groups = warps * cluster
    per = -(-rows // groups)
    if what == "a layer's outer":
        assert 0 < rows % per and rows // per < groups - 1  # a ragged group, empty ones after
    part = np.random.default_rng(rows).normal(size=(rows, cols)).astype(np.float32)
    out = _reduce_rows_in_order(part)
    want = fk.reduce_rows_plain(torch.from_numpy(part)).numpy()
    scale = np.abs(want).max()
    assert np.abs(out - want).max() / scale <= cs.TOL_KERNEL
    exact = part.astype(np.float64).sum(0)
    assert np.abs(out - exact).max() / scale <= 1e-6


@pytest.mark.parametrize("variant", ["forward", "adjoint, pre bf16, gelu_grad"])
def test_wdft_bf16_mma_order_meets_the_card_bounds(variant):
    """A rehearsal of ``wdft_kernel``'s tensor-core arithmetic at the flagship
    shape (rows 4 * 20 * 130, Wp = 130, J = 24) under `default`: v rounded
    to bf16, K padded to 144 with zeros, each k16 step's 16 exact products
    summed and added to the f32 accumulator.  It lies within chip_smoke.py's
    TOL_KERNEL of the plain version and below half the plain bf16-vs-f32
    gap, the bound phase 3 holds the kernel to."""
    from sciml_pde_torch.ops import fno_kernels as fk

    cs = chip_smoke()
    hp = cs.XY + cs.PAD
    f = tf.kernel_factors(hp, hp, cs.MODES, cs.MODES, "cpu", True)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(cs.B, cs.WIDTH, hp, hp)).astype(np.float32))
    if variant == "forward":
        fac, pre, args = f.fwd_w, None, {}
        v = x
    else:
        fac = f.adj_w
        pre = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)).bfloat16()
        args = {"pre": pre, "gelu_grad": True}
        v = x * fk._gelu_grad(pre.float())

    def plain(bf):
        out = fk.wdft_plain(x, fac, bf=bf, **args)
        return (out if pre is None else out[0]).numpy()

    want = plain(True)
    gap = np.abs(plain(False) - want).max()
    kp = -(-hp // 16) * 16
    assert kp == 144
    a = np.zeros((v.numel() // hp, kp), np.float32)
    a[:, :hp] = v.reshape(-1, hp).bfloat16().float().numpy()
    b = np.zeros((kp, fac.shape[1]), np.float32)
    b[:hp] = fac.numpy()
    assert np.array_equal(b, torch.from_numpy(b).bfloat16().float().numpy())  # bf16-exact
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for ks in range(0, kp, 16):
        acc = acc + (a[:, ks:ks + 16].astype(np.float64) @ b[ks:ks + 16]).astype(np.float32)
    err = np.abs(acc - want.reshape(acc.shape)).max()
    scale = np.abs(want).max()
    assert err / scale <= cs.TOL_KERNEL and err < gap / 2, (err / scale, gap / scale)


@pytest.mark.parametrize("tc,pre_size,widest", [(True, 4, 787), (True, 2, 787), (True, 0, 787),
                                                (False, 4, 892), (False, 0, 892)])
def test_wdft_smem_check_names_the_widest_n(tc, pre_size, widest):
    """``wdft``'s shared-memory plan (the mirror of ``WdftLayout``) streams N
    in chunks, so every N passes at J = 24: the flagship's Wp = 130 in one
    chunk, 514 (512^2), 1026, 1154 (Y = 1152) and 10^6 in chunks of at most
    WD_KC_MAX k16 steps.  Shared memory grows with J only: the plan takes the
    variant's widest J and raises one past it with that limit named."""
    from sciml_pde_torch.ops import fno_kernels as fk

    assert _csrc_constants("fno_fwd.cu", ("WD_ROWS", "WD_KC_MAX")) == [fk.WDFT_ROWS,
                                                                      fk.WDFT_KC_MAX]
    assert fk.wdft_plan(130, 24, tc, pre_size) == 9  # the whole row, K padded to 144
    for n in (514, 1026, 1154, 10**6):
        kc = fk.wdft_plan(n, 24, tc, pre_size)
        assert fk.wdft_smem_bytes(n, 24, tc, pre_size, kc) <= fk.SMEM_MAX
    fk.wdft_plan(1154, widest, tc, pre_size)
    with pytest.raises(ValueError, match=f"J up to {widest}$"):
        fk.wdft_plan(1154, widest + 1, tc, pre_size)


# the widest width the head kernels take at NH 128, Co 2 (`default`, `highest`):
# the fused and split steps reach the corner, inverse-W and outer-product
# kernels at every such width
HEAD_WIDEST = {True: 149, False: 96}


@pytest.mark.parametrize("tc,widest", [(True, 360), (False, 294)])
def test_corner_smem_check_names_the_widest_c(tc, widest):
    """``corner``'s plan (the mirror of ``CornerLayout``) takes every width the
    head kernels take at Hp up to 1154, its chunk of H rows a multiple of 8
    that fits SMEM_MAX (the flagship's 33 rows a block in one chunk of 40);
    at R = 24 it takes the widest C and raises one past it, naming it."""
    assert _csrc_constants("fno_fwd.cu", ("CN_CLUSTER",)) == [tk.CORNER_CLUSTER]
    assert tk.corner_plan(20, 20, 130, 24, tc) == 40
    for hp in (130, 514, 1154):
        for c in (20, HEAD_WIDEST[tc]):
            hc = tk.corner_plan(c, c, hp, 24, tc)
            assert hc % 8 == 0 and tk.corner_smem_bytes(c, c, 24, hc, tc) <= tk.SMEM_MAX
    tk.corner_plan(widest, widest, 130, 24, tc)
    with pytest.raises(ValueError, match=f"C up to {widest} at this R$"):
        tk.corner_plan(widest + 1, widest + 1, 130, 24, tc)


@pytest.mark.parametrize("tc,widest", [(True, 240), (False, 176)])
def test_iwdft_smem_check_names_the_widest_c(tc, widest):
    """``iwdft_pw``'s plan (the mirror of ``IwdftLayout``) takes every width
    the head kernels take at Wp up to 1154, in chunks of W a multiple of 16
    that fit SMEM_MAX, about IW_GRID blocks (260 of 2 rows at the
    flagship); at K = 12 it takes the widest C and raises one past it,
    naming it."""
    assert _csrc_constants("fno_fwd.cu", ("IW_GRID",)) == [tk.IWDFT_GRID]
    assert tk.iwdft_plan(20, 20, 12, 130, 4 * 130, tc) == (144, 2)
    for wp in (130, 514, 1154):
        for c in (20, HEAD_WIDEST[tc]):
            wc, rb = tk.iwdft_plan(c, c, 12, wp, 4 * wp, tc)
            assert wc % 16 == 0 and rb >= 1
            assert tk.iwdft_smem_bytes(c, c, 12, wc, tc) <= tk.SMEM_MAX
    tk.iwdft_plan(widest, widest, 12, 130, 520, tc)
    with pytest.raises(ValueError, match=f"C up to {widest} at this K$"):
        tk.iwdft_plan(widest + 1, widest + 1, 12, 130, 520, tc)


def test_outer_smem_check_names_the_widest_na():
    """``outer``'s check on the mirror of ``OuterLayout``: OP_STAGES copied
    tiles of nA + OP_BT rows (Bm's channels come in chunks of OP_BT) and the
    k slices' sums, so shared memory grows with nA only, on either path: it
    takes nA up to 197, above the 194 that fault C8's repair opened and every
    width the head kernels take, at any nB, and raises at nA = 198, naming
    the limit."""
    assert _csrc_constants("fno_bwd.cu", ("OP_BT", "OP_MW", "OP_WARPS", "OP_LD", "OP_RLD")) == [
        tk.OUTER_BT, tk.OUTER_MW, tk.OUTER_WARPS, tk.OUTER_LD, tk.OUTER_RLD]
    for na in (1, HEAD_WIDEST[True], 194, 197):
        tk._check_outer_smem(na)
    assert tk.outer_smem_bytes(197) <= tk.SMEM_MAX < tk.outer_smem_bytes(198)
    # its warps' rows of m16 tiles (OP_MW each) cover the widest nA
    assert -(-197 // 16) <= tk.OUTER_MW * tk.OUTER_WARPS
    with pytest.raises(ValueError, match="it takes nA up to 197$"):
        tk._check_outer_smem(198)


def test_outer_rows_follow_the_kernel():
    """``outer`` allocates one partial row per persistent block of
    ``outer_partial_kernel``: at most OP_GRID blocks, the fewest that keep
    the rounds of OP_PIX-pixel tiles the same; and chip_smoke.py's
    reduce_rows shapes of a layer's and the lift's outer products are those
    row counts at the flagship (353 and 342, from 265 and 256 before)."""
    grid, pix, units, stages = _csrc_constants("fno_bwd.cu", ("OP_GRID", "OP_PIX", "OP_UNITS",
                                                              "OP_STAGES"))
    assert (grid, pix, units, stages) == (tk.OUTER_GRID, tk.OUTER_PIX, tk.OUTER_UNITS,
                                          tk.OUTER_STAGES)
    cs = chip_smoke()
    layer, lift = cs.B * (cs.XY + cs.PAD) ** 2, cs.B * cs.XY * cs.XY
    shapes = cs.rr_shapes()
    assert shapes["a layer's outer"] == (tk.outer_rows(layer), cs.WIDTH * cs.WIDTH + cs.WIDTH)
    assert shapes["the lift's outer"][0] == tk.outer_rows(lift)
    assert (tk.outer_rows(layer), tk.outer_rows(lift)) == (353, 342)
    for npix in (0, 1, pix, pix + 1, grid * pix, grid * pix + 1, layer, 10**7):
        tiles, rows = -(-npix // pix), tk.outer_rows(npix)
        if tiles == 0:
            assert rows == 1  # one row of zeros
            continue
        # no block without a tile, and the rounds that OP_GRID blocks take
        assert 1 <= rows <= min(grid, tiles)
        assert -(-tiles // rows) == -(-tiles // grid)


def _bf(a):
    """``a`` rounded to bf16, as f32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _k16(a, b, acc=None):
    """Sum over the k16 steps of ``a`` (..., K) @ ``b`` (..., K, N), K a multiple
    of 16: each step's 16 exact products summed, rounded to f32 and added to
    the f32 accumulator (zero, or ``acc``), as mma.sync m16n8k16 with f32
    accumulation."""
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32) if acc is None else acc
    for k in range(0, a.shape[-1], 16):
        acc = acc + (a[..., k:k + 16].astype(np.float64) @ b[..., k:k + 16, :]).astype(np.float32)
    return acc


def _worst_rel(got, want):
    return max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))


@pytest.mark.parametrize("adj", [False, True])
def test_corner_bf16_mma_order_meets_the_card_bounds(adj):
    """A rehearsal of ``corner_kernel``'s tensor-core arithmetic under
    `default` at the flagship shape (B = 4, C = 20, Hp = 130, K = 12, R = 24),
    forward and adjoint: each cluster rank's rows of H in chunks of the plan's
    HC rows, A rounded to bf16 with the real and imaginary parts of a row side
    by side against [[Pr, Pi], [-Pi, Pr]], k16 steps into the rank's partial
    spectrum; the partials added in rank order; the f32 mode mix in order over
    the input channels, rounded to bf16; D as k16 steps of [Cr | Ci] against
    [[Qr, Qi], [-Qi, Qr]].  The spectrum (in f32) and D lie within
    chip_smoke.py's TOL_KERNEL of the plain version and below half the plain
    bf16-vs-f32 gap, the bound phase 3 holds the kernel to."""
    cs = chip_smoke()
    b, c, hp, k, r = cs.B, cs.WIDTH, cs.XY + cs.PAD, cs.MODES, 2 * cs.MODES
    f = tf.kernel_factors(hp, hp, cs.MODES, cs.MODES, "cpu", True)
    pf, qf = (f.adj_p, f.adj_q) if adj else (f.fwd_p, f.fwd_q)
    rng = np.random.default_rng(31)
    a = rng.normal(size=(b, c, hp, 2 * k)).astype(np.float32)
    w = [(rng.normal(size=(c, c, k, r)) / c).astype(np.float32) for _ in range(2)]
    args = (torch.from_numpy(a), pf, tuple(map(torch.from_numpy, w)), qf, adj, torch.float32)
    want = [t.numpy() for t in tk.corner_plain(*args, True)]
    gap = _worst_rel([t.numpy() for t in tk.corner_plain(*args, False)], want)

    cl, hc = tk.CORNER_CLUSTER, tk.corner_plan(c, c, hp, r, True)
    hb = -(-hp // cl)
    ab = _bf(a)
    pr, pi = (t.numpy() for t in pf)
    bs = np.zeros((b, k, c, 2 * r), np.float32)  # the partials added in rank order
    for q in range(cl):
        part = np.zeros_like(bs)
        hn = max(0, min(hb, hp - q * hb))
        for c0 in range(0, hn, hc):
            hs = np.arange(q * hb + c0, q * hb + min(c0 + hc, hn))
            op_a = np.zeros((b, k, c, 2 * hc), np.float32)
            op_a[..., 0:2 * len(hs):2] = ab[:, :, hs, :k].transpose(0, 3, 1, 2)
            op_a[..., 1:2 * len(hs):2] = ab[:, :, hs, k:].transpose(0, 3, 1, 2)
            op_p = np.zeros((2 * hc, 2 * r), np.float32)
            op_p[0:2 * len(hs):2] = np.concatenate([pr[hs], pi[hs]], 1)
            op_p[1:2 * len(hs):2] = np.concatenate([-pi[hs], pr[hs]], 1)
            part = _k16(op_a, op_p, part)
        bs = bs + part
    wr, wi = w
    if adj:
        wr, wi = wr.transpose(1, 0, 2, 3), -wi.transpose(1, 0, 2, 3)
    br, bi = bs[..., :r], bs[..., r:]
    cr = np.zeros((b, k, c, r), np.float32)
    ci = np.zeros_like(cr)
    for i in range(c):
        wri, wii = wr[i].transpose(1, 0, 2)[None], wi[i].transpose(1, 0, 2)[None]
        cr = cr + (br[:, :, i, None] * wri - bi[:, :, i, None] * wii)
        ci = ci + (br[:, :, i, None] * wii + bi[:, :, i, None] * wri)
    ca = _bf(np.concatenate([cr, ci], -1))
    qr_, qi_ = (t.numpy() for t in qf)
    dr = _k16(ca, np.concatenate([qr_, -qi_], 0))  # (b, k, c, hp)
    di = _k16(ca, np.concatenate([qi_, qr_], 0))
    got = [br.transpose(0, 2, 1, 3), bi.transpose(0, 2, 1, 3),
           np.concatenate([dr.transpose(0, 2, 3, 1), di.transpose(0, 2, 3, 1)], -1)]
    rel = _worst_rel(got, want)
    assert rel <= cs.TOL_KERNEL and rel < gap / 2, (rel, gap)


@pytest.mark.parametrize("adj", [False, True])
def test_iwdft_bf16_mma_order_meets_the_card_bounds(adj):
    """A rehearsal of ``iwdft_pw_kernel``'s tensor-core arithmetic under
    `default` at the flagship shape (B = 4, C = 20, Hp = Wp = 130, K = 12):
    per row, [D_row | M] (20 x 44, padded to K = 48) against [Z ; xin_row]
    with D and xin rounded to bf16 and Z, M bf16-exact, as three k16 steps,
    then + bias, and gelu and a saved pre (forward) or neither (adjoint).  It
    lies within chip_smoke.py's TOL_KERNEL of the plain version and below
    half the plain bf16-vs-f32 gap."""
    cs = chip_smoke()
    b, c, hp, k = cs.B, cs.WIDTH, cs.XY + cs.PAD, cs.MODES
    f = tf.kernel_factors(hp, hp, cs.MODES, cs.MODES, "cpu", True)
    rng = np.random.default_rng(32)
    d = rng.normal(size=(b, c, hp, 2 * k)).astype(np.float32)
    xin = rng.normal(size=(b, c, hp, hp)).astype(np.float32)
    mw = _bf(rng.uniform(-1, 1, size=(c, c)) / np.sqrt(c))
    if adj:
        z, bias, gelu = f.adj_z.numpy(), None, False
    else:
        z, bias, gelu = f.fwd_z.numpy(), (0.1 * rng.normal(size=c)).astype(np.float32), True
    t = lambda v: None if v is None else torch.from_numpy(v)  # noqa: E731
    args = (t(d), t(z), t(xin), t(mw), t(bias), gelu, torch.float32)
    want = [v.numpy() for v in tk.iwdft_pw_plain(*args, True)]
    gap = _worst_rel([v.numpy() for v in tk.iwdft_pw_plain(*args, False)], want)

    kp = -(-(2 * k + c) // 16) * 16
    assert kp == 48
    op_a = np.zeros((b, hp, c, kp), np.float32)  # per row (b, h)
    op_a[..., :2 * k] = _bf(d).transpose(0, 2, 1, 3)
    op_a[..., 2 * k:2 * k + c] = mw
    op_b = np.zeros((b, hp, kp, hp), np.float32)
    op_b[:, :, :2 * k] = z
    op_b[:, :, 2 * k:2 * k + c] = _bf(xin).transpose(0, 2, 1, 3)
    v = _k16(op_a, op_b)
    if bias is not None:
        v = v + bias[:, None]
    v = v.transpose(0, 2, 1, 3)  # (b, c, hp, wp)
    out = tk._gelu(torch.from_numpy(v)).numpy() if gelu else v
    rel = _worst_rel([out, v], want)
    assert rel <= cs.TOL_KERNEL and rel < gap / 2, (rel, gap)


@pytest.mark.parametrize("variant", ["forward", "adjoint, pre f32, gelu_grad"])
def test_wdft_f32_bound_rejects_tf32_inputs(variant):
    """A rehearsal of phase 3's `highest` check on ``fno_wdft`` at the
    flagship shape: exact f32 products summed in order over k lie within
    chip_smoke.py's TOL_WDFT_F32 of the plain version, and the control, the
    plain version with TF32-rounded inputs (what a TF32 body would compute),
    lies above it."""
    from sciml_pde_torch.ops import fno_kernels as fk

    cs = chip_smoke()
    hp = cs.XY + cs.PAD
    f = tf.kernel_factors(hp, hp, cs.MODES, cs.MODES, "cpu", False)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(cs.B, cs.WIDTH, hp, hp)).astype(np.float32))
    if variant == "forward":
        fac, v = f.fwd_w, x
        want = fk.wdft_plain(x, fac)
    else:
        fac = f.adj_w
        pre = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
        want, v = fk.wdft_plain(x, fac, pre, True)
    a, b = v.reshape(-1, hp).numpy(), fac.numpy()
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(hp):
        acc = acc + a[:, k:k + 1] * b[k]
    scale = want.abs().max().item()
    assert np.abs(acc - want.reshape(acc.shape).numpy()).max() / scale <= cs.TOL_WDFT_F32
    ctl = torch.matmul(cs.tf32(v), cs.tf32(fac))
    assert (ctl - want).abs().max().item() / scale > cs.TOL_WDFT_F32


def test_head_bwd_partial_rows_follow_the_kernel():
    """``head_bwd`` allocates one partial row per persistent block of
    ``head_bwd_kernel`` (HB_GRID blocks at most, one per HB_PIX-pixel tile
    below that), and chip_smoke.py's "head backward" reduce_rows shape is that
    row count at the flagship."""
    grid, pix = _csrc_constants("fno_bwd.cu", ("HB_GRID", "HB_PIX"))
    assert (grid, pix) == (tk.HEAD_BWD_GRID, tk.HEAD_BWD_PIX)
    cs = chip_smoke()
    npix = cs.B * cs.XY * cs.XY
    assert cs.rr_shapes()["head backward"] == (tk.head_bwd_rows(npix),
                                             cs.NH * cs.WIDTH + cs.NH + cs.CC * cs.NH + cs.CC)
    assert tk.head_bwd_rows(npix) == grid < npix // pix
    assert tk.head_bwd_rows(100) == 2 and tk.head_bwd_rows(1) == 1


@pytest.mark.parametrize("widest", [64, 96, 124, 149])
def test_head_smem_check_names_the_widest_c(widest):
    """The head kernels' shared-memory check, on a stand-in layout of a
    fixed size a channel that fits SMEM_MAX up to C = ``widest``: it takes
    every C up to there and raises past it with that limit named.  The
    kernels' own layouts come from their library (``head_smem_bytes``);
    chip_smoke.py checks their limits on the card."""
    per_c = tk.SMEM_MAX // widest
    smem = lambda c, nh, co, tc: c * per_c  # noqa: E731
    for c in (1, widest // 2, widest):
        tk._check_head_smem("head_fwd", smem, c, 128, 2, True)
    with pytest.raises(ValueError, match=f"C up to {widest} at this NH and Co$"):
        tk._check_head_smem("head_fwd", smem, widest + 1, 128, 2, True)


def _tree_sum(v, axis):
    """The sum over ``axis`` (length 2^k) by pairs of neighbours, level by
    level: a shuffle tree's value on its first lane (f32 addition commutes)."""
    v = np.moveaxis(v, axis, 0)
    while v.shape[0] > 1:
        v = v[0::2] + v[1::2]
    return v[0]


def test_head_bwd_tile_order_meets_the_card_bounds():
    """A rehearsal of ``head_bwd_kernel``'s tensor-core arithmetic under
    `default` at the flagship shape (65,536 pixels, C = 20, NH = 128, Co = 2):
    tiles of HB_PIX consecutive pixels, tile k to block k mod HB_GRID, each
    block's tiles in order; fc1, dW1, dW2 and dbb as k16 steps of exact bf16
    products (C padded to 32) added to f32 sums; dt1 in order over the output
    channels; db1 summed by each lane over its rows g and g + 8 of the tile's
    m16 tiles in order, then over the lanes by the kernel's shuffle tree (g ^
    1, g ^ 2, g ^ 4), and db2 over the tile by a warp's tree; each tile's sums
    added to its block's in tile order; the blocks' partial rows through
    ``reduce_rows_kernel``'s fixed groups.
    Each weight gradient and dbb lies within chip_smoke.py's TOL_KERNEL of
    the plain version and within 1e-6 of the f64 sum of the same rounded
    products."""
    cs = chip_smoke()
    grid, pix = _csrc_constants("fno_bwd.cu", ("HB_GRID", "HB_PIX"))
    b, c, nh, co, xy = cs.B, cs.WIDTH, cs.NH, cs.CC, cs.XY
    npix, cp = b * xy * xy, -(-c // 16) * 16
    ntiles = npix // pix
    assert ntiles % grid == 0 and pix % 16 == 0
    rng = np.random.default_rng(21)
    def bf(a):  # rounded to bf16, as f32
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()
    hf = rng.normal(size=(b, c, xy + cs.PAD, xy + cs.PAD)).astype(np.float32)
    w1t = bf(rng.uniform(-1, 1, size=(nh, c)) / np.sqrt(c))
    b1 = (rng.uniform(-1, 1, size=nh) / np.sqrt(c)).astype(np.float32)
    w2t = bf(rng.uniform(-1, 1, size=(co, nh)) / np.sqrt(nh))
    dpred = rng.normal(size=(b, co, xy, xy)).astype(np.float32)
    std = rng.uniform(0.5, 2.0, size=(b, co)).astype(np.float32)
    want = tk.head_bwd_plain(*(torch.from_numpy(a) for a in (dpred, hf, w1t, b1, w2t, std)),
                             True)

    # per pixel, in the kernel's pixel order p = (b * X + x) * Y + y
    bb = bf(hf[:, :, :xy, :xy].transpose(0, 2, 3, 1).reshape(npix, c))
    dout = (dpred * std[:, :, None, None]).transpose(0, 2, 3, 1).reshape(npix, co)
    dor = bf(dout)

    def k16(a, bmat):  # sum over k16 steps of exact products: a (..., K), bmat (K, N)
        acc = np.zeros(a.shape[:-1] + bmat.shape[1:], np.float32)
        for k in range(0, a.shape[-1], 16):
            acc = acc + (a[..., k:k + 16].astype(np.float64) @ bmat[k:k + 16]).astype(np.float32)
        return acc

    bbp = np.zeros((npix, cp), np.float32)
    bbp[:, :c] = bb
    w1p = np.zeros((nh, cp), np.float32)
    w1p[:, :c] = w1t
    pre1 = torch.from_numpy(k16(bbp, w1p.T) + b1)
    t1 = bf(tk._gelu(pre1).numpy())
    dt = np.zeros((npix, nh), np.float32)
    for o in range(co):
        dt = dt + dor[:, o:o + 1] * w2t[o]
    dp = dt * tk._gelu_grad(pre1).numpy()
    dpr = bf(dp)

    # per tile (and m16 tile), then per block over its tiles in order
    tiles = lambda a: a.reshape(ntiles, pix, *a.shape[1:])  # noqa: E731
    steps = (tiles(dpr).reshape(ntiles, pix // 16, 16, nh).transpose(0, 1, 3, 2).astype(np.float64)
             @ tiles(bb).reshape(ntiles, pix // 16, 16, c)).astype(np.float32)
    dw1_t = np.zeros((ntiles, nh, c), np.float32)
    for k in range(pix // 16):
        dw1_t = dw1_t + steps[:, k]
    steps = (tiles(dor).reshape(ntiles, pix // 16, 16, co).transpose(0, 1, 3, 2)
             .astype(np.float64) @ tiles(t1).reshape(ntiles, pix // 16, 16, nh)).astype(np.float32)
    dw2_t = np.zeros((ntiles, co, nh), np.float32)
    for k in range(pix // 16):
        dw2_t = dw2_t + steps[:, k]
    pairs = tiles(dp).reshape(ntiles, pix // 16, 16, nh)
    pairs = pairs[:, :, :8] + pairs[:, :, 8:]  # rows g and g + 8 of each m16 tile
    lanes = np.zeros((ntiles, 8, nh), np.float32)
    for m in range(pix // 16):
        lanes = lanes + pairs[:, m]
    db1_t = _tree_sum(lanes, 1)  # (tiles, NH)
    d = tiles(dout).transpose(0, 2, 1)  # (tiles, Co, HB_PIX)
    db2_t = _tree_sum(sum(d[:, :, j:j + 32] for j in range(0, pix, 32)), 2)

    def block_rows(per_tile):  # (tiles, ...) -> (grid, -1), each block's tiles in order
        acc = np.zeros((grid,) + per_tile.shape[1:], np.float32)
        for j in range(ntiles // grid):
            acc = acc + per_tile[j * grid:(j + 1) * grid]
        return acc.reshape(grid, -1)

    part = np.concatenate([block_rows(a) for a in (dw1_t, db1_t, dw2_t, db2_t)], 1)
    assert part.shape == cs.rr_shapes()["head backward"]
    got = np.split(_reduce_rows_in_order(part), np.cumsum([nh * c, nh, co * nh]))
    dbb = k16(dpr, w1t)

    exact = [(dpr.astype(np.float64).T @ bb).ravel(), dp.astype(np.float64).sum(0),
             (dor.astype(np.float64).T @ t1).ravel(), dout.astype(np.float64).sum(0),
             dpr.astype(np.float64) @ w1t]
    plain = [want[1].numpy().ravel(), want[2].numpy(), want[3].numpy().ravel(),
             want[4].numpy(),
             want[0][:, :, :xy, :xy].numpy().transpose(0, 2, 3, 1).reshape(npix, c)]
    for name, g, e, w in zip(("dw1t", "db1", "dw2t", "db2", "dbb"), got + [dbb], exact, plain):
        scale = np.abs(w).max()
        assert np.abs(g - w).max() / scale <= cs.TOL_KERNEL, (name, np.abs(g - w).max() / scale)
        assert np.abs(g - e).max() / scale <= 1e-6, (name, np.abs(g - e).max() / scale)


def _xor_tree(v, axis):
    """The sum over ``axis`` (32 lanes) by a warp's xor shuffle tree, offsets
    16, 8, 4, 2, 1: lane 0's value (f32 addition commutes)."""
    v = np.moveaxis(v, axis, 0)
    while v.shape[0] > 1:
        v = v[: v.shape[0] // 2] + v[v.shape[0] // 2:]
    return v[0]


def _outer_in_order(a, bm, gelu, nh, nw):
    """``outer_partial_kernel``'s arithmetic under `default`, in numpy: the
    region's pixels in the order (b, y, x) cut into tiles of OP_PIX, tile
    k + r * grid to block k in round r; warp slice q of a block takes the
    tile's 16-pixel units q, q + ks, ... (k16 steps of A and g(Bm) rounded
    to bf16: each step's 16 exact products summed, rounded to f32 and added
    to the slice's f32 accumulator), tile after tile, and its lanes' sums of
    unrounded A (lane t of a row adds the pairs at pixels 2t, 2t + 1, then
    2t + 8, 2t + 9 of each unit); the lanes added as (t0 + t1) + (t2 + t3),
    the slices in order; the blocks' partial rows through
    ``reduce_rows_kernel``'s fixed groups.  Returns (out (nA, nB), asum
    (nA,)) and the exact f64 sums of the same rounded products and of A."""
    grid, pix, mw, warps, units = _csrc_constants("fno_bwd.cu", ("OP_GRID", "OP_PIX", "OP_MW",
                                                                 "OP_WARPS", "OP_UNITS"))
    na, nb = a.shape[1], bm.shape[1]
    av = a[:, :, :nh, :nw].transpose(1, 0, 2, 3).reshape(na, -1)
    bv = bm[:, :, :nh, :nw].astype(np.float32)
    if gelu:
        bv = tk._gelu(torch.from_numpy(bv)).numpy()
    bv = _bf(bv.transpose(1, 0, 2, 3).reshape(nb, -1))
    npix = av.shape[1]
    tiles = -(-npix // pix)
    rounds = -(-tiles // grid)
    nblk = -(-tiles // rounds)
    assert nblk == tk.outer_rows(npix) and pix == 16 * units
    span = rounds * nblk * pix  # whole rounds: the blocks without a last tile add zeros

    def tiled(v):  # (rows, rounds, blocks, units, 16)
        out = np.zeros((v.shape[0], span), np.float32)
        out[:, :npix] = v
        return out.reshape(v.shape[0], rounds, nblk, units, 16)

    at, bt = tiled(av), tiled(bv)
    mt = -(-na // 16)  # A's m16 tiles
    mrows = -(-mt // mw)  # warp rows of OP_MW m16 tiles
    ks = max(1, min(units, warps // mrows))
    prods = (_bf(at).transpose(1, 2, 3, 0, 4).astype(np.float64)
             @ bt.transpose(1, 2, 3, 4, 0)).astype(np.float32)  # (rounds, blocks, units, nA, nB)
    lane = at.reshape(na, rounds, nblk, units, 2, 4, 2)  # pixel 8h + 2t + c of a unit
    pairs = lane[..., 0] + lane[..., 1]  # (nA, rounds, blocks, units, h, t)
    acc = np.zeros((ks, nblk, na, nb), np.float32)
    sums = np.zeros((ks, 4, na, nblk), np.float32)
    for r in range(rounds):
        for u in range(units):
            acc[u % ks] = acc[u % ks] + prods[r, :, u]
            for h in range(2):
                sums[u % ks] = sums[u % ks] + pairs[:, r, :, u, h].transpose(2, 0, 1)
    out, asum = acc[0], (sums[0, 0] + sums[0, 1]) + (sums[0, 2] + sums[0, 3])
    for q in range(1, ks):
        out = out + acc[q]
        asum = asum + ((sums[q, 0] + sums[q, 1]) + (sums[q, 2] + sums[q, 3]))
    part = np.concatenate([out.reshape(nblk, na * nb), asum.T], 1)
    got = _reduce_rows_in_order(part)
    exact = (_bf(av).astype(np.float64) @ bv.T.astype(np.float64), av.astype(np.float64).sum(1))
    return (got[: na * nb].reshape(na, nb), got[na * nb:]), exact


@pytest.mark.parametrize("shape", ["a layer's weight gradient", "the lift's weight gradient"])
def test_outer_mma_order_meets_the_card_bounds(shape):
    """A rehearsal of ``outer_partial_kernel``'s tensor-core order under
    `default` (``_outer_in_order``) at the two shapes of the flagship's
    fused step: a layer's call (A = dpre and Bm = the bf16 pre through
    gelu, both (4, 20, 130, 130), over the whole padded field: 353 blocks of
    two or three tiles, the last tile 16 pixels) and the lift's (A = dh (4,
    20, 130, 130) over its 128 x 128 image, Bm = the f32 lift input (4, 22,
    128, 128): 342 blocks of two or three tiles).  Both outputs lie within chip_smoke.py's
    TOL_KERNEL of the plain version and of JAX's _dot (f32 sums of bf16
    products) and sum_cols summed over the batch in order, the products
    below half the plain bf16-vs-f32 gap, the bound phase 3 holds the kernel
    to; and within 1e-6 (of the largest magnitude) of the f64 sums of the
    same rounded products and of the unrounded A."""
    from _torch_parity import precision

    cs = chip_smoke()
    rng = np.random.default_rng(31)
    hp = cs.XY + cs.PAD
    a = rng.normal(size=(cs.B, cs.WIDTH, hp, hp)).astype(np.float32)
    if shape == "a layer's weight gradient":
        bm = torch.from_numpy(rng.normal(size=a.shape).astype(np.float32)).bfloat16()
        gelu, nh, nw = True, hp, hp
    else:
        bm = torch.from_numpy(rng.normal(size=(cs.B, cs.T0 * cs.CC + 2, cs.XY, cs.XY))
                              .astype(np.float32))
        gelu, nh, nw = False, cs.XY, cs.XY
    bnp = bm.float().numpy()
    got, exact = _outer_in_order(a, bnp, gelu, nh, nw)
    ta = torch.from_numpy(a)
    want = [t.numpy() for t in tk.outer_plain(ta, bm, gelu, nh, nw, True)]
    gap = np.abs(tk.outer_plain(ta, bm, gelu, nh, nw, False)[0].numpy() - want[0]).max()

    bv = tk._gelu(bm.float()).numpy() if gelu else bnp
    with precision("default"):
        jdot = np.zeros(want[0].shape, np.float32)
        jsum = np.zeros(want[1].shape, np.float32)
        for b in range(cs.B):
            ab = a[b, :, :nh, :nw].reshape(a.shape[1], -1)
            jdot = jdot + np.asarray(jf._dot(ab, bv[b, :, :nh, :nw].reshape(bv.shape[1], -1).T))
            jsum = jsum + np.asarray(jf._sum_cols(ab))[:, 0]
    for g, w, j, e in zip(got, want, (jdot, jsum), exact):
        scale = np.abs(w).max()
        assert np.abs(g - w).max() / scale <= cs.TOL_KERNEL
        assert np.abs(g - j).max() / scale <= cs.TOL_KERNEL
        assert np.abs(g - e).max() / scale <= 1e-6
    assert np.abs(got[0] - want[0]).max() < gap / 2


@pytest.mark.parametrize("field", [(130, 130, 128, 128), (20, 44, 16, 40), (17, 13, 15, 11),
                                   (9, 8, 9, 8)])
def test_lift_pad_stores_cover_the_pad_once(field):
    """A rehearsal of ``lift_kernel``'s index arithmetic on a padded (Hp, Wp)
    plane of an (X, Y) image: the image threads' pairs of pixels along a
    row (the last a single pixel where Y is odd), and the pad
    threads' stores (two floats where Wp and Y are even, PAIR; the columns
    Y.. of rows below X, then the rows X..), each store 8-byte aligned under
    PAIR: together they write every element of the plane exactly once."""
    hp, wp, x, y = field
    pair = wp % 2 == 0 and y % 2 == 0
    hits = np.zeros(hp * wp, np.int64)
    yp = -(-y // 2)
    for q in range(x * yp):
        row, y0 = q // yp, q % yp * 2
        for u in range(min(2, y - y0)):
            hits[row * wp + y0 + u] += 1
    step, pw = (2 if pair else 1), wp - y
    per = (hp * wp - x * y) // step
    assert per * step == hp * wp - x * y
    for item in range(per):
        idx = item * step
        pos = idx // pw * wp + y + idx % pw if idx < x * pw else x * wp + (idx - x * pw)
        assert not pair or pos % 2 == 0
        hits[pos:pos + step] += 1
    assert (hits == 1).all()
