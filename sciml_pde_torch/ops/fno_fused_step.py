"""Fused FNO-2D training forward/backward (port of
``sciml_pde_tpu/ops/fno_fused_step.py``).

The JAX module runs the whole model per batch element inside one TPU
kernel per direction (``_full_fwd_kernel``, ``_full_bwd_kernel``).  Here
the same forward and hand-derived VJP are a sequence of hand-written CUDA
kernels (``fno_kernels``) that run layer by layer and spill activations to
device memory, as Hopper's 227 KB of shared memory per block cannot hold an
element's (20, 130, 130) activation:

  forward   stats -> lift -> 4 x (wdft -> corner -> iwdft_pw) -> head_fwd
  backward  head_bwd -> 4 x (wdft.adj -> corner.adj -> iwdft_pw.adj,
            mix_wgrad, outer) reversed -> outer (lift grads)

The forward saves, for the backward, each layer's pre-activation and
corner spectrum in the dot dtype (bf16 under the ``default`` precision,
as the TPU kernel's remat scratch), plus the lift input and output and the
last layer's output in f32.

Shapes are the logical ones: the field is (C, X+pad, Y+pad) and the modes
(m2 rfft columns, 2*m1 corner rows).  The JAX kernels' padding to multiples
of 8 and 128 only served the TPU compiler's shape rules and changes no
result.

``fno2d_fused_apply`` is a ``torch.autograd.Function``: on CUDA tensors its
forward and backward are the kernels, on CPU tensors the same composition
of the kernels' plain versions.  ``fno2d_fused_reference`` is the plain
whole-model forward (the JAX module's reference composition) and
``fno2d_fused_vjp_reference`` the plain hand-written VJP, both usable on
any device.

The JAX module's five split kernels (``_bb_forward``, ``_head_forward``,
``_head_backward``, ``_bb_backward``, ``_bb_weight_grads``) keep their
names, arguments and results here, each a sequence of the same stage
kernels run with the split form's own dtypes, which under the ``default``
precision differ from the fused step's: ``pre`` is kept in f32, the
adjoint mode mix takes the f32 weights, and the weight-gradient pass
recomputes each layer's corner spectrum in f32 from the layer input.
Every product runs in a stage kernel; between them PyTorch only moves
data (stacks per-layer results, crops and zero-pads fields, rounds
weights to the dot dtype).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from sciml_pde_torch.ops import fno_kernels as _k
from sciml_pde_torch.ops import spectral as _spec
from sciml_pde_torch.ops.spectral import _corner_rows, _dft_factors_1d

L_LAYERS = 4


# ---------------------------------------------------------------------------
# Constant DFT factors
# ---------------------------------------------------------------------------


class SpectralFactors(NamedTuple):
    """Partial-DFT bases for one (Hp, Wp, m1, m2) geometry, numpy f32.

    fr, fi (Wp, m2) forward W-axis rDFT; gr, gi (Hp, 2m1) forward H-axis
    corner DFT; hr, hi (2m1, Hp) inverse H; wr, wi (m2, Wp) inverse W
    (Hermitian-doubled, / Wp).
    """

    fr: np.ndarray
    fi: np.ndarray
    gr: np.ndarray
    gi: np.ndarray
    hr: np.ndarray
    hi: np.ndarray
    wr: np.ndarray
    wi: np.ndarray


@functools.lru_cache(maxsize=16)
def spectral_factors(hp: int, wp: int, m1: int, m2: int) -> SpectralFactors:
    (fr, fi), (iwr, iwi) = _dft_factors_1d(wp, m2, None)
    (gr, gi), (ihr, ihi) = _dft_factors_1d(hp, 2 * m1, _corner_rows(hp, m1))
    return SpectralFactors(fr, fi, gr, gi, ihr, ihi, iwr, iwi)


class KernelFactors(NamedTuple):
    """The factor matrices the kernels take, forward and adjoint, on one
    device and already rounded to the dot dtype."""

    fwd_w: torch.Tensor  # (Wp, 2K)  [fr | fi]
    fwd_p: tuple         # (Hp, R)   G
    fwd_q: tuple         # (R, Hp)   H
    fwd_z: torch.Tensor  # (2K, Wp)  [wr; -wi]
    adj_w: torch.Tensor  # (Wp, 2K)  [wr^T | -wi^T]
    adj_p: tuple         # (Hp, R)   conj(H^T)
    adj_q: tuple         # (R, Hp)   conj(G^T)
    adj_z: torch.Tensor  # (2K, Wp)  [fr^T; fi^T]


@functools.lru_cache(maxsize=8)
def kernel_factors(hp: int, wp: int, m1: int, m2: int, device: str, bf: bool) -> KernelFactors:
    f = spectral_factors(hp, wp, m1, m2)

    def t(a):
        return _k._rd(torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                      device=device), bf)

    cat1 = np.concatenate
    return KernelFactors(
        fwd_w=t(cat1([f.fr, f.fi], axis=1)),
        fwd_p=(t(f.gr), t(f.gi)),
        fwd_q=(t(f.hr), t(f.hi)),
        fwd_z=t(cat1([f.wr, -f.wi], axis=0)),
        adj_w=t(cat1([f.wr.T, -f.wi.T], axis=1)),
        adj_p=(t(f.hr.T), t(-f.hi.T)),
        adj_q=(t(f.gr.T), t(-f.gi.T)),
        adj_z=t(cat1([f.fr.T, f.fi.T], axis=0)),
    )


# ---------------------------------------------------------------------------
# Packed parameters
# ---------------------------------------------------------------------------


class FastFNOParams(NamedTuple):
    """FNO2d parameters oriented for the channels-first kernels.

    wmr/wmi (L, C, O, m2, 2m1) complex mode-mix weights (rfft column k,
    corner row r; rows [:m1] are the flax ``w1`` block, [m1:] ``w2``);
    pw (L, C, O) 1x1 conv kernels; pb (L, O); w0t (C, F) transposed lift
    kernel; w1t (128, C); w2t (Co, 128).
    """

    wmr: torch.Tensor
    wmi: torch.Tensor
    pw: torch.Tensor
    pb: torch.Tensor
    w0t: torch.Tensor
    b0: torch.Tensor
    w1t: torch.Tensor
    b1: torch.Tensor
    w2t: torch.Tensor
    b2: torch.Tensor


def _tensor(a, device=None) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = np.array(a, dtype=np.float32)
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def pack_params(tree, modes1: int, modes2: int, device=None) -> FastFNOParams:
    """Flax FNO2d parameter tree (nested dicts of arrays) -> FastFNOParams."""
    bb = tree["backbone"] if "backbone" in tree else tree
    wmr, wmi, pw, pb = [], [], [], []
    for i in range(L_LAYERS):
        conv = bb[f"conv{i}"]
        w1, w2 = _tensor(conv["w1"], device), _tensor(conv["w2"], device)  # (2, C, O, m1, m2)
        wmr.append(torch.cat([w1[0], w2[0]], dim=2).permute(0, 1, 3, 2))  # (C, O, m2, 2m1)
        wmi.append(torch.cat([w1[1], w2[1]], dim=2).permute(0, 1, 3, 2))
        dense = bb[f"w{i}"]["Dense_0"]
        pw.append(_tensor(dense["kernel"], device))
        pb.append(_tensor(dense["bias"], device))
    fc0, fc1 = bb["fc0"]["Dense_0"], bb["fc1"]["Dense_0"]
    head = tree.get("fc2", tree.get("fc2_primary"))
    fc2 = head["Dense_0"] if "Dense_0" in head else head
    c = lambda a: a.contiguous()  # noqa: E731
    return FastFNOParams(
        wmr=c(torch.stack(wmr)), wmi=c(torch.stack(wmi)),
        pw=c(torch.stack(pw)), pb=c(torch.stack(pb)),
        w0t=c(_tensor(fc0["kernel"], device).T), b0=_tensor(fc0["bias"], device),
        w1t=c(_tensor(fc1["kernel"], device).T), b1=_tensor(fc1["bias"], device),
        w2t=c(_tensor(fc2["kernel"], device).T), b2=_tensor(fc2["bias"], device),
    )


def unpack_grads(g: FastFNOParams, modes1: int, modes2: int, like_tree=None) -> dict:
    """FastFNOParams (values or cotangents) -> flax parameter tree of tensors."""
    m1 = modes1
    bb = {}
    for i in range(L_LAYERS):
        wr = g.wmr[i].permute(0, 1, 3, 2)  # (C, O, 2m1, m2)
        wi = g.wmi[i].permute(0, 1, 3, 2)
        bb[f"conv{i}"] = {
            "w1": torch.stack([wr[:, :, :m1], wi[:, :, :m1]]).contiguous(),
            "w2": torch.stack([wr[:, :, m1:], wi[:, :, m1:]]).contiguous(),
        }
        bb[f"w{i}"] = {"Dense_0": {"kernel": g.pw[i], "bias": g.pb[i]}}
    bb["fc0"] = {"Dense_0": {"kernel": g.w0t.T.contiguous(), "bias": g.b0}}
    bb["fc1"] = {"Dense_0": {"kernel": g.w1t.T.contiguous(), "bias": g.b1}}
    out = {"backbone": bb, "fc2": {"Dense_0": {"kernel": g.w2t.T.contiguous(), "bias": g.b2}}}
    if like_tree is not None and "backbone" not in like_tree:
        out.update(out.pop("backbone"))
    return out


# ---------------------------------------------------------------------------
# Plain whole-model reference (mirrors the JAX module's reference composition)
# ---------------------------------------------------------------------------


def _dot(eq, a, b, bf):
    return torch.einsum(eq, _k._rd(a, bf), _k._rd(b, bf))


def _spectral_fwd(h, wmr, wmi, f: SpectralFactors, bf):
    """h (B, C, Hp, Wp) -> (B, O, Hp, Wp), the partial-DFT chain."""
    t = lambda a: torch.as_tensor(a, device=h.device)  # noqa: E731
    ar = _dot("bchw,wk->bchk", h, t(f.fr), bf)
    ai = _dot("bchw,wk->bchk", h, t(f.fi), bf)
    br = _dot("bchk,hr->bckr", ar, t(f.gr), bf) - _dot("bchk,hr->bckr", ai, t(f.gi), bf)
    bi = _dot("bchk,hr->bckr", ar, t(f.gi), bf) + _dot("bchk,hr->bckr", ai, t(f.gr), bf)
    cr = torch.einsum("bckr,cokr->bokr", br, wmr) - torch.einsum("bckr,cokr->bokr", bi, wmi)
    ci = torch.einsum("bckr,cokr->bokr", br, wmi) + torch.einsum("bckr,cokr->bokr", bi, wmr)
    dr = _dot("bokr,rh->bohk", cr, t(f.hr), bf) - _dot("bokr,rh->bohk", ci, t(f.hi), bf)
    di = _dot("bokr,rh->bohk", cr, t(f.hi), bf) + _dot("bokr,rh->bohk", ci, t(f.hr), bf)
    return _dot("bohk,kw->bohw", dr, t(f.wr), bf) - _dot("bohk,kw->bohw", di, t(f.wi), bf)


def fno2d_fused_reference(win, grid2, p: FastFNOParams, modes1, modes2, pad=2):
    """win (B, T, Cc, X, Y), grid2 (2, X, Y) -> pred (B, Cc, X, Y).

    Plain PyTorch, differentiable by autograd in ``p``: instance norm
    (outside the graph) -> lift -> pad -> 4 layers -> unpad -> fc1 -> gelu
    -> fc2 -> de-norm, channels-first.
    """
    bf = _spec.dot_bf16()
    b, t, cc, xx, yy = win.shape
    hp, wp = xx + pad, yy + pad
    f = spectral_factors(hp, wp, modes1, modes2)
    with torch.no_grad():
        mean, std = _k.stats_plain(win)
    xn = (win - mean[:, None, :, None, None]) / std[:, None, :, None, None]
    finp = torch.cat([xn.reshape(b, t * cc, xx, yy), grid2.expand(b, -1, -1, -1)], dim=1)
    h0 = _dot("cf,bfxy->bcxy", p.w0t, finp, bf) + p.b0[:, None, None]
    h = torch.nn.functional.pad(h0, (0, pad, 0, pad))
    for i in range(L_LAYERS):
        s = _spectral_fwd(h, p.wmr[i], p.wmi[i], f, bf)
        pre = s + _dot("co,bchw->bohw", p.pw[i], h, bf) + p.pb[i][:, None, None]
        h = pre if i == L_LAYERS - 1 else _k._gelu(pre)
    bb = h[:, :, :xx, :yy]
    t1 = _k._gelu(_dot("jc,bcxy->bjxy", p.w1t, bb, bf) + p.b1[:, None, None])
    outn = _dot("oj,bjxy->boxy", p.w2t, t1, bf) + p.b2[:, None, None]
    return outn * std[:, :, None, None] + mean[:, :, None, None]


# ---------------------------------------------------------------------------
# The kernel composition: forward and hand-derived VJP
# ---------------------------------------------------------------------------


class _Saved(NamedTuple):
    std: torch.Tensor
    h0: torch.Tensor      # (B, C, Hp, Wp) lift output, f32
    finp: torch.Tensor    # (B, F, X, Y) lift input, f32
    pres: list            # per layer (B, C, Hp, Wp), dot dtype
    specs: list           # per layer (spec_r, spec_i) (B, C, K, R), dot dtype
    hlast: torch.Tensor   # (B, C, Hp, Wp) last layer output, f32


def _fused_forward(ops, win, grid2, p: FastFNOParams, m1, m2, pad, save: bool):
    bf = _spec.dot_bf16()
    b, t, cc, xx, yy = win.shape
    hp, wp = xx + pad, yy + pad
    f = kernel_factors(hp, wp, m1, m2, str(win.device), bf)
    sdt = torch.bfloat16 if bf else torch.float32
    rd = functools.partial(_k._rd, bf=bf)
    mean, std = ops.stats(win)
    h, finp = ops.lift(win, grid2, mean, std, rd(p.w0t), p.b0, hp, wp, bf)
    h0, pres, specs = h, [], []
    for i in range(L_LAYERS):
        a = ops.wdft(h, f.fwd_w, None, False, bf)
        spr, spi, d = ops.corner(a, f.fwd_p, (p.wmr[i], p.wmi[i]), f.fwd_q, False, sdt, bf)
        h, pre = ops.iwdft_pw(d, f.fwd_z, h, rd(p.pw[i].T.contiguous()), p.pb[i],
                              i < L_LAYERS - 1, sdt if save else None, bf)
        pres.append(pre)
        specs.append((spr, spi))
    pred = ops.head_fwd(h, rd(p.w1t), p.b1, rd(p.w2t), p.b2, mean, std, xx, yy, bf)
    return pred, (_Saved(std, h0, finp, pres, specs, h) if save else None)


def _fused_backward(ops, dpred, sv: _Saved, p: FastFNOParams, m1, m2, pad) -> FastFNOParams:
    bf = _spec.dot_bf16()
    b, c, hp, wp = sv.h0.shape
    xx, yy = hp - pad, wp - pad
    f = kernel_factors(hp, wp, m1, m2, str(dpred.device), bf)
    rd = functools.partial(_k._rd, bf=bf)
    dh, dw1t, db1, dw2t, db2 = ops.head_bwd(dpred, sv.hlast, rd(p.w1t), p.b1, rd(p.w2t),
                                            sv.std, bf)
    # the adjoint mode mix takes the weights in the dot dtype, as the TPU
    # backward kernel does
    wmr_b, wmi_b = rd(p.wmr), rd(p.wmi)
    dwmr, dwmi, dpw, dpb = [None] * L_LAYERS, [None] * L_LAYERS, [None] * L_LAYERS, [None] * L_LAYERS
    for i in reversed(range(L_LAYERS)):
        a, dpre = ops.wdft(dh, f.adj_w, sv.pres[i], i < L_LAYERS - 1, bf)
        dcr, dci, d = ops.corner(a, f.adj_p, (wmr_b[i], wmi_b[i]), f.adj_q, True,
                                 torch.float32, bf)
        dh, _ = ops.iwdft_pw(d, f.adj_z, dpre, rd(p.pw[i]), None, False, None, bf, adj=True)
        dwmr[i], dwmi[i] = ops.mix_wgrad(*sv.specs[i], dcr, dci)
        h_in = sv.h0 if i == 0 else sv.pres[i - 1]
        dpw_t, dpb[i] = ops.outer(dpre, h_in, i > 0, hp, wp, bf)
        dpw[i] = dpw_t.T
    dw0t, db0 = ops.outer(dh, sv.finp, False, xx, yy, bf)
    return FastFNOParams(
        wmr=torch.stack(dwmr), wmi=torch.stack(dwmi), pw=torch.stack(dpw),
        pb=torch.stack(dpb), w0t=dw0t, b0=db0, w1t=dw1t, b1=db1, w2t=dw2t, b2=db2,
    )


def fno2d_fused_vjp_reference(dpred, win, grid2, p: FastFNOParams, modes1, modes2, pad=2):
    """Plain hand-written VJP: the ten parameter cotangents of
    ``sum(pred * dpred)``, from the kernels' plain versions on any device."""
    _, sv = _fused_forward(_k.PLAIN, win, grid2, p, modes1, modes2, pad, save=True)
    return _fused_backward(_k.PLAIN, dpred, sv, p, modes1, modes2, pad)


class _FusedApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, win, grid2, m1, m2, pad, *params):
        p = FastFNOParams(*params)
        pred, sv = _fused_forward(_k.KERNELS, win, grid2, p, m1, m2, pad, save=True)
        ctx.sv, ctx.p, ctx.geom = sv, p, (m1, m2, pad)
        return pred

    @staticmethod
    def backward(ctx, dpred):
        m1, m2, pad = ctx.geom
        g = _fused_backward(_k.KERNELS, dpred.contiguous(), ctx.sv, ctx.p, m1, m2, pad)
        ctx.sv = ctx.p = None
        return (None, None, None, None, None, *g)


def fno2d_fused_apply(win, grid2, p: FastFNOParams, modes1, modes2, pad=2):
    """Fused FNO2d forward: win (B, T, Cc, X, Y), grid2 (2, X, Y) -> (B, Cc, X, Y).

    Differentiable in ``p`` (win and grid2 are data and get no cotangent;
    the instance-norm statistics are outside the graph).  Without grad
    mode or a parameter that requires grad, nothing is saved.
    """
    win, grid2 = win.contiguous(), grid2.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in p):
        return _FusedApply.apply(win, grid2, modes1, modes2, pad, *p)
    pred, _ = _fused_forward(_k.KERNELS, win, grid2, p, modes1, modes2, pad, save=False)
    return pred


# ---------------------------------------------------------------------------
# The split forms: the JAX module's five pallas_calls, one function each
# ---------------------------------------------------------------------------

SPLIT_NAMES = ("bb_forward", "head_forward", "head_backward", "bb_backward",
               "bb_weight_grads")
# One count per call that ran its stage kernels on the card (the plain
# composition on the CPU, or with ``ops=PLAIN``, counts nothing).
SPLIT_LAUNCHES: dict[str, int] = dict.fromkeys(SPLIT_NAMES, 0)


def reset_split_counts() -> None:
    for k in SPLIT_LAUNCHES:
        SPLIT_LAUNCHES[k] = 0


def _count(name: str, ops, t: torch.Tensor) -> None:
    if ops is _k.KERNELS and t.is_cuda:
        SPLIT_LAUNCHES[name] += 1


def _stats_cols(stats):
    """(B, Cc, 2) -> mean, std (B, Cc) each, contiguous."""
    return stats[..., 0].contiguous(), stats[..., 1].contiguous()


def _layer_major(a):
    """(B, L, ...) -> (L, B, ...) contiguous, so that each layer's slice is
    contiguous.  No copy for the views the split functions return."""
    return a.transpose(0, 1).contiguous()


def _check_chunks(xx: int, yy: int, n_chunks: int) -> None:
    if (xx * yy) % n_chunks:
        raise ValueError(f"head kernels chunk the {xx}x{yy} spatial axis into {n_chunks} "
                         f"slices; {xx * yy} % {n_chunks} != 0")


def _bb_forward(win, grid2, p: FastFNOParams, m1, m2, pad, *, ops=_k.KERNELS):
    """Stats, lift and the four spectral layers (``_bb_fwd_kernel``).

    win (B, T, Cc, X, Y), grid2 (2, X, Y) -> pre (B, L, C, Hp, Wp) every
    layer's pre-activation in f32, bbout (B, C, X, Y) the last layer's
    output, stats (B, Cc, 2) (mean, std), h0p (B, C, Hp, Wp) the padded lift
    output.  ``pre`` is a view of layer-major storage.  ``ops=PLAIN`` runs
    the plain versions on any device."""
    _count("bb_forward", ops, win)
    bf = _spec.dot_bf16()
    b, t, cc, xx, yy = win.shape
    hp, wp = xx + pad, yy + pad
    f = kernel_factors(hp, wp, m1, m2, str(win.device), bf)
    rd = functools.partial(_k._rd, bf=bf)
    mean, std = ops.stats(win)
    h0p, _ = ops.lift(win, grid2, mean, std, rd(p.w0t), p.b0, hp, wp, bf)
    h, pres = h0p, []
    for i in range(L_LAYERS):
        a = ops.wdft(h, f.fwd_w, None, False, bf)
        _, _, d = ops.corner(a, f.fwd_p, (p.wmr[i], p.wmi[i]), f.fwd_q, False, torch.float32,
                             bf)
        h, pre = ops.iwdft_pw(d, f.fwd_z, h, rd(p.pw[i].T.contiguous()), p.pb[i],
                              i < L_LAYERS - 1, torch.float32, bf)
        pres.append(pre)
    bbout = h[:, :, :xx, :yy].contiguous()
    return torch.stack(pres).transpose(0, 1), bbout, torch.stack([mean, std], -1), h0p


def _head_forward(bbout, stats, p: FastFNOParams, n_chunks=4, *, ops=_k.KERNELS):
    """fc1 -> gelu -> fc2 -> de-norm (``_head_fwd_kernel``): bbout
    (B, C, X, Y), stats (B, Cc, 2) -> pred (B, Co, X, Y).  The kernel runs
    one thread per pixel; ``n_chunks`` is checked as the JAX kernel's
    spatial chunking, which changes no result."""
    _check_chunks(bbout.shape[2], bbout.shape[3], n_chunks)
    _count("head_forward", ops, bbout)
    bf = _spec.dot_bf16()
    rd = functools.partial(_k._rd, bf=bf)
    mean, std = _stats_cols(stats)
    xx, yy = bbout.shape[2:]
    return ops.head_fwd(bbout.contiguous(), rd(p.w1t), p.b1, rd(p.w2t), p.b2, mean, std, xx,
                        yy, bf)


def _head_backward(dpred, bbout, stats, p: FastFNOParams, n_chunks=4, *, ops=_k.KERNELS):
    """Head recompute and backward (``_head_bwd_kernel``): -> dbb
    (B, C, X, Y), dw1t (NH, C), db1 (NH,), dw2t (Co, NH), db2 (Co,)."""
    _check_chunks(bbout.shape[2], bbout.shape[3], n_chunks)
    _count("head_backward", ops, bbout)
    bf = _spec.dot_bf16()
    rd = functools.partial(_k._rd, bf=bf)
    _, std = _stats_cols(stats)
    return ops.head_bwd(dpred.contiguous(), bbout.contiguous(), rd(p.w1t), p.b1, rd(p.w2t),
                        std, bf)


def _bb_backward(dbb, pre, win, grid2, stats, p: FastFNOParams, m1, m2, pad, *,
                 ops=_k.KERNELS):
    """Data cotangent through the four layers, last to first
    (``_bb_bwd_kernel``): dbb (B, C, X, Y), pre (B, L, C, Hp, Wp) f32 ->
    dpre (B, L, C, Hp, Wp) (a view of layer-major storage), dw0t (C, F),
    db0 (C,).  The adjoint mode mix takes the f32 weights, not the
    bf16-rounded ones of the fused step.  The lift input is recomputed
    from win, grid2 and stats (its lift output is not used)."""
    _count("bb_backward", ops, dbb)
    bf = _spec.dot_bf16()
    b, t, cc, xx, yy = win.shape
    hp, wp = xx + pad, yy + pad
    f = kernel_factors(hp, wp, m1, m2, str(win.device), bf)
    rd = functools.partial(_k._rd, bf=bf)
    mean, std = _stats_cols(stats)
    _, finp = ops.lift(win, grid2, mean, std, p.w0t, p.b0, hp, wp, bf)
    pre_l = _layer_major(pre)
    dh = dbb.new_zeros(b, dbb.shape[1], hp, wp)
    dh[:, :, :xx, :yy] = dbb
    dpres = [None] * L_LAYERS
    for i in reversed(range(L_LAYERS)):
        a, dpres[i] = ops.wdft(dh, f.adj_w, pre_l[i], i < L_LAYERS - 1, bf)
        _, _, d = ops.corner(a, f.adj_p, (p.wmr[i], p.wmi[i]), f.adj_q, True, torch.float32,
                             bf)
        dh, _ = ops.iwdft_pw(d, f.adj_z, dpres[i], rd(p.pw[i]), None, False, None, bf,
                             adj=True)
    dw0t, db0 = ops.outer(dh, finp, False, xx, yy, bf)
    return torch.stack(dpres).transpose(0, 1), dw0t, db0


def _bb_weight_grads(pre, h0p, dpre, p: FastFNOParams, m1, m2, pad, xx, yy, *,
                     ops=_k.KERNELS):
    """Per-layer spectral and pointwise weight grads (``_bb_wgrad_kernel``):
    pre, dpre (B, L, C, Hp, Wp), h0p (B, C, Hp, Wp) -> dwmr, dwmi
    (L, C, O, m2, 2m1), dpw (L, C, O), dpb (L, O).  Each layer's corner
    spectrum is recomputed in f32 from its input (h0p, or gelu of the
    previous layer's pre), and the cotangent's spectrum from dpre."""
    b, _, c, hp, wp = pre.shape
    if (hp, wp) != (xx + pad, yy + pad):
        raise ValueError(f"pre {tuple(pre.shape)} is not the padded field of {xx}x{yy}, "
                         f"pad {pad}")
    _count("bb_weight_grads", ops, pre)
    bf = _spec.dot_bf16()
    f = kernel_factors(hp, wp, m1, m2, str(pre.device), bf)
    f32 = torch.float32
    pre_l, dpre_l = _layer_major(pre), _layer_major(dpre)
    dwmr, dwmi, dpw, dpb = [], [], [], []
    for i in range(L_LAYERS):
        w = (p.wmr[i], p.wmi[i])
        h_in = h0p if i == 0 else pre_l[i - 1]
        a = ops.wdft(h_in, f.fwd_w, None, False, bf, gelu_in=i > 0)
        spr, spi, _ = ops.corner(a, f.fwd_p, w, f.fwd_q, False, f32, bf, spec_only=True)
        a = ops.wdft(dpre_l[i], f.adj_w, None, False, bf)
        dcr, dci, _ = ops.corner(a, f.adj_p, w, f.adj_q, True, f32, bf, spec_only=True)
        gr, gi = ops.mix_wgrad(spr, spi, dcr, dci)
        dpw_t, dpb_i = ops.outer(dpre_l[i], h_in, i > 0, hp, wp, bf)
        dwmr.append(gr)
        dwmi.append(gi)
        dpw.append(dpw_t.T)
        dpb.append(dpb_i)
    return torch.stack(dwmr), torch.stack(dwmi), torch.stack(dpw), torch.stack(dpb)
