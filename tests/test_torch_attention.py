"""Port ops/attention.py vs the JAX package: flash_attention values and q/k/v
gradients (JAX Pallas in interpret mode on the CPU), each plain version
against the Pallas body it stands for, and the shape rule.  One more test
rehearses the bf16 backward kernels' numerics (p and ds split into two bf16
terms) against chip_smoke.py's bounds.

Tolerances, relative to the largest magnitude of the JAX result: f32 1e-5
(sums in another order); bf16 3e-2 (roundings to bf16 at other points)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.ops import attention as ja
from sciml_pde_torch.ops import attention as ta

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
B, H, D = 1, 2, 16


def _inputs(n, seed, count=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, n, D)).astype(np.float32) for _ in range(count)]


def _close(got, want, tol, what):
    got = np.asarray(torch.as_tensor(got).float().detach().numpy(), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: max error {err:.3e} of the largest magnitude (tol {tol:.0e})"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [64, 512, 17, 320])
def test_flash_attention_values_and_grads_match_jax(n, dtype):
    """n = 64 and 512 (two Q blocks) take the fused path, 17 and 320 the
    jnp path, in both packages."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, g = _inputs(n, seed=n)
    scale = D**-0.5

    def jloss(q, k, v):
        o = ja.flash_attention(q, k, v, scale)
        return jnp.sum(o.astype(jnp.float32) * g), o

    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    (_, o_want), grads_want = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jq, jk, jv)
    tq, tk, tv = (torch.tensor(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    o = ta.flash_attention(tq, tk, tv, scale)
    (o.float() * torch.tensor(g)).sum().backward()
    assert o.dtype == tdt
    _close(o, o_want, tol, "o")
    for name, t, w in zip("qkv", (tq, tk, tv), grads_want):
        assert t.grad.dtype == tdt
        _close(t.grad, w, tol, f"d{name}")


def test_shape_rule_matches_jax(monkeypatch):
    fused = []
    real = ta._FlashCore.apply
    monkeypatch.setattr(ta._FlashCore, "apply", lambda *a: fused.append(1) or real(*a))
    for n, d, want in [(64, 16, True), (256, 16, True), (512, 16, True), (2048, 8, True),
                       (17, 16, False), (320, 16, False), (2304, 16, False),
                       (64, 12, False), (132, 16, False)]:
        fused.clear()
        x = torch.zeros(1, 1, n, d)
        ta.flash_attention(x, x, x, 1.0)
        assert bool(fused) == want, (n, d)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [64, 512])
def test_plain_versions_match_pallas_bodies(n, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    tol = 1e-5 if dtype == "f32" else 1e-2  # bf16: only the output rounding differs
    q, k, v, do = (a.reshape(B * H, n, D) for a in _inputs(n, seed=100 + n))
    scale = D**-0.5
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    o_want, l_want = ja._attention_fwd_flat(jq, jk, jv, scale)
    dq_want, dk_want, dv_want = ja._attention_bwd_flat(jq, jk, jv, o_want, l_want, jdo, scale)

    tq, tk, tv, tdo = (torch.tensor(a).to(tdt) for a in (q, k, v, do))
    o, l = ta.attention_fwd_plain(tq, tk, tv, scale)
    _close(o, o_want, tol, "o")
    np.testing.assert_allclose(l.numpy(), np.asarray(l_want), rtol=1e-6, atol=1e-6)
    # the backward from the JAX forward's own o and l
    o_j = torch.tensor(np.asarray(o_want.astype(jnp.float32))).to(tdt)
    l_j = torch.tensor(np.asarray(l_want))
    delta = torch.sum(tdo.float() * o_j.float(), dim=-1, keepdim=True)
    dq = ta.attention_dq_plain(tq, tk, tv, tdo, l_j, delta, scale)
    dk, dv = ta.attention_dkv_plain(tq, tk, tv, tdo, l_j, delta, scale)
    for name, got, want in (("dq", dq, dq_want), ("dk", dk, dk_want), ("dv", dv, dv_want)):
        assert got.dtype == tdt
        _close(got, want, tol, name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_jnp_attention_matches_jax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(40, seed=7, count=3)
    want = ja.jnp_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), 0.25)
    got = ta.jnp_attention(*(torch.tensor(a).to(tdt) for a in (q, k, v)), 0.25)
    assert got.dtype == tdt
    _close(got, want, tol, "jnp_attention")


def test_wrappers_run_plain_on_cpu_and_refuse_other_devices():
    q, k, v, do = (torch.tensor(a.reshape(B * H, 64, D)) for a in _inputs(64, seed=3))
    o, l = ta.attention_fwd(q, k, v, 0.25)
    o_p, l_p = ta.attention_fwd_plain(q, k, v, 0.25)
    assert torch.equal(o, o_p) and torch.equal(l, l_p)
    delta = torch.sum(do * o, dim=-1, keepdim=True)
    assert torch.equal(ta.attention_dq(q, k, v, do, l, delta, 0.25),
                       ta.attention_dq_plain(q, k, v, do, l, delta, 0.25))
    for a, b in zip(ta.attention_dkv(q, k, v, do, l, delta, 0.25),
                    ta.attention_dkv_plain(q, k, v, do, l, delta, 0.25)):
        assert torch.equal(a, b)
    assert all(c == 0 for c in ta.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        ta.attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"), 0.25)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [96, 24, 160, 192, 256])
def test_flash_attention_head_dims_96_and_24_match_jax(d, dtype):
    """Head dims that are multiples of 8 but not powers of two, and those above
    128, take the fused path in both packages (the kernels pad 24 to 32 in
    shared memory and are built for 96, 160, 192 and 256): values and q/k/v
    gradients against JAX in interpret mode."""
    jdt, tdt, tol = DTYPES[dtype]
    n = 64
    rng = np.random.default_rng(d)
    q, k, v, g = (rng.normal(size=(1, 2, n, d)).astype(np.float32) for _ in range(4))
    scale = d**-0.5

    def jloss(q, k, v):
        o = ja.flash_attention(q, k, v, scale)
        return jnp.sum(o.astype(jnp.float32) * g), o

    (_, o_want), grads_want = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    tq, tk, tv = (torch.tensor(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    fused = []
    real = ta._FlashCore.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ta._FlashCore, "apply", lambda *a: fused.append(1) or real(*a))
        o = ta.flash_attention(tq, tk, tv, scale)
    assert fused and o.dtype == tdt
    (o.float() * torch.tensor(g)).sum().backward()
    _close(o, o_want, tol, "o")
    for name, t, w in zip("qkv", (tq, tk, tv), grads_want):
        _close(t.grad, w, tol, f"d{name}")


def test_kernel_check_takes_any_head_dim_to_256_and_any_batch_heads():
    """The wrappers' shape check takes every head dim d % 8 == 0 up to 256 and
    a batch*heads count above 65535; it raises above 256, naming the limit,
    on a head dim that is not a multiple of 8, and on a non-contiguous
    panel."""
    meta = lambda *s, dt=torch.bfloat16: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    for d in (8, 24, 40, 96, 120, 128, 136, 160, 192, 256):
        assert ta._check(meta(3, 64, d), (meta(3, 64, d),)) == (3, 64, d, True)
    q = meta(70_000, 16, 16)
    rows = (meta(70_000, 16, 1, dt=torch.float32),) * 2
    assert ta._check(q, (q, q, q), rows) == (70_000, 16, 16, True)
    with pytest.raises(ValueError, match="head dims d % 8 == 0 up to 256"):
        ta._check(meta(2, 64, 264))
    with pytest.raises(ValueError, match="head dim"):
        ta._check(meta(2, 64, 20))
    with pytest.raises(ValueError, match="contiguous"):
        ta._check(meta(2, 64, 16), (meta(2, 16, 64).transpose(1, 2),))


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_split_bf16_backward_meets_the_card_bounds():
    """The bf16 dQ and dK/dV kernels take their products with the f32 p and ds
    split into two bf16 terms, x = bf16(x) + bf16(x - bf16(x)).  The plain
    backward with p and ds so split lies within 1e-5 of the largest magnitude
    of the plain f32 result, and after the bf16 store within chip_smoke.py's
    bf16 bound (one bf16 step of the value plus 1e-5 of the largest
    magnitude), with a mean error under half that of the bf16-p control
    (chip_smoke.att_bf16p)."""
    cs = _chip_smoke()
    rng = np.random.default_rng(11)
    bh, n, d = 2, 128, 64
    q, k, v, do = (torch.tensor(rng.normal(size=(bh, n, d)).astype(np.float32)).bfloat16()
                   for _ in range(4))
    scale = d**-0.5
    o, l = ta.attention_fwd_plain(q, k, v, scale)
    delta = torch.sum(do.float() * o.float(), dim=-1, keepdim=True)

    def split(x):
        hi = x.bfloat16().float()
        return hi + (x - hi).bfloat16().float()

    p, ds = ta._p_ds(q, k, v, do, l, delta, scale)
    qf, kf, dof = q.float(), k.float(), do.float()
    exact = {"dq": ds @ kf * scale, "dk": ds.transpose(-1, -2) @ qf * scale,
             "dv": p.transpose(-1, -2) @ dof}
    emul = {"dq": split(ds) @ kf * scale, "dk": split(ds).transpose(-1, -2) @ qf * scale,
            "dv": split(p).transpose(-1, -2) @ dof}
    plain = dict(zip(("dq", "dk", "dv"), (ta.attention_dq_plain(q, k, v, do, l, delta, scale),
                                          *ta.attention_dkv_plain(q, k, v, do, l, delta, scale))))
    ctl = dict(zip(("dq", "dk", "dv"),
                   (*cs.att_bf16p("attention_dq", q, k, v, do, l, delta, scale),
                    *cs.att_bf16p("attention_dkv", q, k, v, do, l, delta, scale))))
    for name in exact:
        f32_err = (emul[name] - exact[name]).abs().max() / exact[name].abs().max()
        assert f32_err <= cs.ATT_TOL_F32, (name, f32_err)
        got, want = emul[name].bfloat16().float(), plain[name].float()
        assert plain[name].dtype == torch.bfloat16
        lim = cs.BF16_STEP * torch.maximum(got.abs(), want.abs()) + cs.ATT_TOL_F32 * want.abs().max()
        assert ((got - want).abs() / lim).max() <= 1.0, name
        k_mean = (got - want).abs().mean()
        c_mean = (ctl[name].float() - want).abs().mean()
        assert k_mean < c_mean / 2, (name, k_mean, c_mean)
