"""Port ops/spectral_fused.py (the fused dft2 FNO layer) vs the JAX
fused_fno_layer_2d, whose Pallas kernel runs in interpret mode on the CPU.
On the CPU the port's wrapper runs the kernel's plain f32 version."""

import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.ops.spectral_fused import _layer_reference as jax_layer_reference
from sciml_pde_tpu.ops.spectral_fused import fused_fno_layer_2d as jax_fused
from sciml_pde_torch.ops import spectral_fused as sf

from _torch_parity import precision

# (B, H, W, Ci, Co, m1, m2): the JAX test's shape, an odd one, and one with
# more corner rows than rows (2 * m1 > H)
SHAPES = {"jax_test": (2, 18, 18, 6, 6, 4, 4), "odd": (1, 13, 11, 5, 3, 3, 4),
          "modes_above_half": (1, 6, 10, 4, 3, 4, 3)}


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


# ---------------------------------------------------------------------------
# the redesigned kernels (csrc/spectral_fused.cu): their summation order, the
# shared-memory reckoning, and the checkout comparison's keys
# ---------------------------------------------------------------------------

# the flagship layer at batch 1 (chip_smoke.py phase 10 runs batch 4), the
# odd shape, and a shape that takes passes over the modes in chunks of 1 row
ORDER_SHAPES = {"flagship_b1": (1, 130, 130, 20, 20, 12, 12), "odd": SHAPES["odd"],
                "mode_passes": (1, 32, 32, 128, 4, 16, 16)}


def _cluster_order(x, w1, w2, pw, bias, m1, m2):
    """The layer as the two kernels sum it, in f32, at the wrapper's plan:
    per element, rank q of the plan's P takes its band of HB rows in
    chunks of RB, the W-axis rDFT's w-sum split into S groups added in
    order, the chunk's share of the corner DFT added to the band's; the
    ranks' shares added in rank order; the complex mix per corner row; the
    inverse corner DFT; the inverse W step and x . pw; bias and the erf
    gelu.  Passes over the modes or the corner rows, and the inverse's
    tiles, change no sum's order."""
    from sciml_pde_torch.ops.spectral import _dft2_corner_axis, _dft2_real_axis

    b, h, w, ci = x.shape
    co = pw.shape[1]
    r, k = 2 * m1, m2
    pl = sf.plan(h, w, ci, co, m1, m2)
    fw, vw = (torch.from_numpy(a) for a in _dft2_real_axis(w, m2))
    gh, gi = (torch.from_numpy(a) for a in _dft2_corner_axis(h, m1))
    fw3 = fw.reshape(w, 2, k)
    ghr = gh.permute(1, 0, 2, 3).reshape(h, 2, 2 * r)  # [h][s][(t, r)]
    band, ranks, rows, split = pl["HB"], pl["P"], pl["RB"], pl["S"]
    assert (ranks - 1) * band < h <= ranks * band
    wr, wi = torch.cat([w1[0], w2[0]], dim=2), torch.cat([w1[1], w2[1]], dim=2)
    outs = []
    for e in range(b):
        xf = torch.zeros(2 * r, k * ci)
        for k0 in range(0, k, pl["KP"]):  # the w-sum's groups are the pass's
            ks = slice(k0, min(k, k0 + pl["KP"]))
            fwp = fw3[:, :, ks].reshape(w, -1)
            shares = []
            for q in range(ranks):
                part = torch.zeros(2 * r, fwp.shape[1] // 2 * ci)
                hi = min(h, (q + 1) * band)
                for h0 in range(q * band, hi, rows):
                    chunk = x[e, h0:min(h0 + rows, hi)]
                    xw = None
                    for g in range(split):
                        ws = slice(g * w // split, (g + 1) * w // split)
                        share = torch.einsum("hwc,wm->hmc", chunk[:, ws], fwp[ws])
                        xw = share if xw is None else xw + share
                    xw = xw.reshape(chunk.shape[0], 2, -1)
                    part = part + torch.einsum("hst,hsn->tn", ghr[h0:h0 + chunk.shape[0]], xw)
                shares.append(part)
            total = shares[0]
            for part in shares[1:]:
                total = total + part
            xf.view(2 * r, k, ci)[:, ks] = total.view(2 * r, -1, ci)
        xr, xi = xf.reshape(2, r, k, ci)
        yr = torch.einsum("rkc,cork->rko", xr, wr) - torch.einsum("rkc,cork->rko", xi, wi)
        yi = torch.einsum("rkc,cork->rko", xr, wi) + torch.einsum("rkc,cork->rko", xi, wr)
        yh = torch.einsum("urko,urvh->hvko", torch.stack([yr, yi]), gi)
        y = (torch.einsum("vkw,hvko->hwo", vw, yh) + torch.einsum("hwc,co->hwo", x[e], pw)
             + bias)
        outs.append(0.5 * y * (1 + torch.erf(y * 0.7071067811865476)))
    return torch.stack(outs)


@pytest.mark.parametrize("shape", ORDER_SHAPES.values(), ids=ORDER_SHAPES.keys())
def test_cluster_order_meets_the_card_bound(shape):
    """The redesigned kernels' summation order (``_cluster_order``) lies
    within chip_smoke.py's SF_TOL (of the largest magnitude) of JAX's fused
    layer under `highest`, at batch 1 of the flagship layer shape, at the
    odd shape and at a shape of passes over the modes: every product stays
    exact f32, so only the order of the f32 sums moves the result."""
    from _torch_parity import chip_smoke

    cs = chip_smoke()
    arrays, modes = _inputs(shape)
    with precision("highest"):
        want = np.asarray(jax_fused(*map(jnp.asarray, arrays), *modes))
    got = _cluster_order(*map(torch.from_numpy, arrays), *modes).numpy()
    rel = np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()
    assert rel <= cs.SF_TOL, rel


def _card_shapes():
    from _torch_parity import chip_smoke

    cs = chip_smoke()
    return {"flagship": cs.SF_FLAGSHIP, **cs.SF_SHAPES}


# what each of phase 10's shapes takes of the plan's smaller layouts
SMALLER = {"NS-2D layer": {"RB": 2}, "16 ranks": {"P": 16, "HB": 8},
           "mode passes": {"RB": 1, "KP": 4}, "corner-row passes": {"RP": 96},
           "column tiles": {"WT": 256}, "1-row blocks": {"RT": 1},
           "corner rows staged": {"URC": 128}}


# the tests' ids of phase 10's shapes
_IDS = {"JAX test": "jax_test", "bands not dividing H": "ragged_bands"}


@pytest.mark.parametrize("name", list(_card_shapes()),
                         ids=[_IDS.get(n, re.sub(r"\W+", "_", n)) for n in _card_shapes()])
def test_smem_reckoning_takes_the_tested_shapes(name):
    """The wrapper's plan of the two kernels' shared memory takes every
    shape chip_smoke.py's phase 10 runs: each kernel's regions lie in order
    within the plan's bytes, which fit a block; the cluster's bands cover H
    with no empty rank; the flagship takes one pass with chunks of 4 rows,
    and each shape named for a smaller layout takes it."""
    b, h, w, ci, co, m1, m2 = _card_shapes()[name]
    pl = sf.plan(h, w, ci, co, m1, m2)
    assert len(pl) == len(sf.PLAN_FIELDS) and set(pl) == set(sf.PLAN_FIELDS)
    for regions, end in ((("fws", "xb", "xwp", "part"), "smem1"),
                         (("yfs", "gis", "vws", "pws", "bs", "yh", "xs", "os"), "smem2")):
        offsets = [pl[k] for k in regions]
        assert offsets == sorted(offsets) and all(o % 4 == 0 for o in offsets)
        assert 4 * offsets[-1] < pl[end] <= sf.MAX_SMEM
    assert pl["xg"] + pl["RB"] * 4 * pl["RP"] == pl["cb"] and pl["xb"] + 2 * pl["cb"] <= pl["xwp"]
    ranks, band = pl["P"], pl["HB"]
    assert 1 <= ranks <= sf.P_MAX and (ranks - 1) * band < h <= ranks * band
    want = SMALLER.get(name, {"RB": sf.CHUNK_ROWS, "KP": m2, "RP": 2 * m1, "RT": 2, "WT": w,
                              "URC": 4 * m1})
    assert {k: pl[k] for k in want} == want
    if name == "flagship":
        assert (ranks, pl["smem1"]) == (15, 206_272)
    with pytest.raises(ValueError, match="smallest layout"):
        sf.plan(130, 1024, 64, 64, 12, 12)


def _three_kernel_smem(w, ci, co, m1, m2):
    """The shared memory of the three kernels the layer had before its
    redesign (partial DFT of 4-row tiles, mix, inverse), as their wrapper
    reckoned it: the shapes it launched are those where all three fit."""
    r, t = 2 * m1, 4
    part = t * w * ci + w * 2 * m2 + 2 * t * 2 * r + t * 2 * m2 * ci
    inv = (2 * r * m2 * co + 2 * m2 * w + 2 * r * 2 * t + t * 2 * m2 * co + t * w * ci + ci * co
           + co)
    return 4 * part, 4 * 2 * m2 * ci, 4 * inv


def test_plan_takes_every_shape_the_three_kernels_took():
    """Every layer shape the three kernels before the redesign launched
    (H, W from 1 to 4096, 1 to 256 channels in and out, 1 to 128 modes on
    each axis, 2 * modes1 > H among them) has a plan, the smaller layouts
    taking what the largest cannot."""
    hs, ws = (1, 5, 13, 67, 130, 256, 1154, 4096), (1, 3, 11, 50, 130, 256, 1154, 4096)
    chans, modes = (1, 3, 5, 20, 64, 128, 256), (1, 3, 12, 32, 64, 128)
    taken = 0
    for w, ci, co, m1, m2 in itertools.product(ws, chans, chans, modes, modes):
        if max(_three_kernel_smem(w, ci, co, m1, m2)) > sf.MAX_SMEM:
            continue
        for h in hs:
            pl = sf.plan(h, w, ci, co, m1, m2)
            assert max(pl["smem1"], pl["smem2"]) <= sf.MAX_SMEM
            taken += 1
    assert taken > 40_000


def test_checkout_comparison_keys_each_trees_b6():
    """experiments/checkout_comparison.py reads each tree's B6 kernels under
    their own names: this tree's two (the cluster's spectrum and the
    inverse), each a kernel of spectral_fused.cu, called with the wrapper's
    plan and without the part scratch; a tree from before the redesign its
    three, renamed as the experiment renames the other tree, called with
    part and the shape's ints."""
    from sciml_pde_torch.experiments import checkout_comparison as cc
    from sciml_pde_torch.ops import _build

    src = (_build.CSRC / "spectral_fused.cu").read_text()
    assert cc._sf_kernels(src) == ["sf_spectrum_kernel", "sf_inverse_kernel"]
    assert not cc._sf_takes_part(src) and cc._sf_takes_plan(src)
    older = ("__global__ void sf_forward_partial_pkernel(const float* x, float* part) {}\n"
             "__global__ void sf_mix_pkernel(const float* part, float* yf) {}\n"
             "__global__ void sf_inverse_out_pkernel(const float* yf, float* out) {}\n"
             "SF_EXPORT int spectral_fused_forward(const float* x, const float* w1,\n"
             "    float* part, float* yf, float* out, int B, void* stream) {}\n")
    assert cc._sf_kernels(older) == ["sf_forward_partial_pkernel", "sf_mix_pkernel",
                                     "sf_inverse_out_pkernel"]
    assert cc._sf_takes_part(older) and not cc._sf_takes_plan(older)


def test_spectral_fused_ablation_cuts_what_it_names():
    """experiments/spectral_fused_ablation.py times copies of
    spectral_fused.cu with the spectrum kernel's mix, then its reduction,
    then its chunk loop cut: each loop it cuts occurs once in the source,
    each copy lacks exactly the loops cut so far, keeps both kernels and
    renames them to the profiler keys it reads."""
    from sciml_pde_torch.experiments import spectral_fused_ablation as sa
    from sciml_pde_torch.ops import _build

    src = (_build.CSRC / "spectral_fused.cu").read_text()
    vs = sa.variants(src)
    assert list(vs)[0] == "shipped" and vs["shipped"] == src and len(vs) == 1 + len(sa.CUTS)
    assert list(sa.KERNELS) == [k for k in sa.KERNELS if f"{k}(" in src]
    for i, (name, text) in enumerate(vs.items()):
        kept = [text.count(loop) for loop in sa.CUTS.values()]
        assert kept == [0] * i + [1] * (len(sa.CUTS) - i), name
        assert text.count("__global__") == src.count("__global__") == 2, name
        assert all(f"{key}(" in text for key in sa.keys(i)), name
