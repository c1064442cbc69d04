"""Port ops/fno_fused_step.py vs the JAX module: the CPU fused apply (the
kernels' plain versions composed as on the card) against the JAX reference
composition and the JAX Pallas kernels run in interpret mode, values and
all ten gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_tpu.ops import fno_fused_step as jf
from sciml_pde_torch.ops import fno_fused_step as tf
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


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, X, Y, T, CC)).astype(np.float32)
    gx, gy = np.meshgrid(np.linspace(0, 1, X, dtype=np.float32),
                         np.linspace(0, 1, Y, dtype=np.float32), indexing="ij")
    grid = np.stack([gx, gy], -1)
    gridb = np.broadcast_to(grid[None], (B, X, Y, 2))
    params = to_numpy_tree(
        FlaxFNO2d(num_channels=CC, modes1=MODES, modes2=MODES, width=WIDTH,
                  initial_step=T).init(jax.random.PRNGKey(1), x, gridb)["params"])
    win = np.ascontiguousarray(np.transpose(x, (0, 3, 4, 1, 2)))  # (B, T, Cc, X, Y)
    grid2 = np.ascontiguousarray(np.transpose(grid, (2, 0, 1)))   # (2, X, Y)
    cot = rng.normal(size=(B, CC, X, Y)).astype(np.float32)
    return params, win, grid2, cot


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


@pytest.mark.parametrize("what", ["head backward", "a layer's outer", "the lift's outer"])
def test_reduce_rows_grouped_order_meets_the_card_bound(what):
    """A rehearsal of ``reduce_rows_kernel``'s arithmetic at the three shapes
    the fused step gives it (chip_smoke.RR_SHAPES): the rows cut into the
    kernel's fixed groups of ceil(rows / groups) (265 rows leave a ragged
    last group and empty ones after it), each summed in order in f32, the
    group sums added in warp order, then the blocks' sums in cluster-rank
    order.  It lies within chip_smoke.py's TOL_KERNEL of the plain version
    and within 1e-6 of the f64 sum."""
    from sciml_pde_torch.ops import fno_kernels as fk

    cs = chip_smoke()
    rows, cols = cs.RR_SHAPES[what]
    warps, cluster = _csrc_constants("fno_bwd.cu", ("RR_WARPS", "RR_CLUSTER"))
    groups = warps * cluster
    per = -(-rows // groups)
    if rows == 265:
        assert 0 < rows % per and rows // per < groups - 1  # a ragged group, empty ones after
    part = np.random.default_rng(rows).normal(size=(rows, cols)).astype(np.float32)
    sums = []
    for g in range(groups):
        s = np.zeros(cols, np.float32)
        for k in range(min(g * per, rows), min((g + 1) * per, rows)):
            s = s + part[k]
        sums.append(s)
    out = np.zeros(cols, np.float32)
    for r in range(cluster):
        b = np.zeros(cols, np.float32)
        for w in range(warps):
            b = b + sums[r * warps + w]
        out = out + b
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


@pytest.mark.parametrize("tc,pre_size,widest", [(True, 4, 492), (True, 2, 570), (True, 0, 677),
                                                (False, 4, 660), (False, 0, 1037)])
def test_wdft_smem_check_names_the_widest_n(tc, pre_size, widest):
    """``wdft``'s shared-memory check (the mirror of ``WdftLayout``) takes
    the flagship's Wp = 130 and every N up to the variant's widest at J = 24,
    and raises past it with that limit named."""
    from sciml_pde_torch.ops import fno_kernels as fk

    assert _csrc_constants("fno_fwd.cu", ("WD_ROWS",)) == [fk.WDFT_ROWS]
    fk._check_wdft_smem(130, 24, tc, pre_size)
    fk._check_wdft_smem(widest, 24, tc, pre_size)
    with pytest.raises(ValueError, match=f"N up to {widest}$"):
        fk._check_wdft_smem(widest + 1, 24, tc, pre_size)


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
