"""Port ops/attention.py vs the JAX package: flash_attention values and q/k/v
gradients (JAX Pallas in interpret mode on the CPU), each plain version
against the Pallas body it stands for, and the shape rule.  Six more
tests rehearse the kernels' numerics against chip_smoke.py's bounds: the
bf16 backward kernels' p and ds split into two bf16 terms, the f32 forward
(against the Pallas body) and backward kernels' products in split TF32
(three passes against one), the backward's long sums taken per score
step under a model of an MMA that truncates its sum, and the cluster bodies
above head dim 256 (partial scores over each rank's 128 columns added in
rank order, then the forward's, dQ's and dK/dV's arithmetic) against the
Pallas bodies and the exact result.

Tolerances, relative to the largest magnitude of the JAX result: f32 1e-5
(sums in another order); bf16 3e-2 (roundings to bf16 at other points)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.ops import attention as ja
from sciml_pde_torch.ops import attention as ta

from _torch_parity import chip_smoke

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
@pytest.mark.parametrize("d", [96, 24, 160, 192, 256, 264, 320, 512, 1024, 1032])
def test_flash_attention_head_dims_96_and_24_match_jax(d, dtype):
    """Head dims that are multiples of 8 but not powers of two, and those above
    128, take the fused path in both packages (the kernels pad 24 to 32 in
    shared memory, are built for 96, 160, 192 and 256, and take 264, 320,
    512 and 1024 through their wide bodies, the forward, dQ and dK/dV as
    clusters, and 1032 through the CUDA-core bodies): values and q/k/v
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


def test_kernel_check_takes_any_head_dim_and_any_batch_heads():
    """The wrappers' shape check takes every head dim d % 8 == 0, with no
    upper limit (264, 320, 512 and 1024 go to the wide bodies, the forward,
    dQ and dK/dV as clusters; 1032 and 2056 to the three tensor-core bodies
    that loop over all of d), and a batch*heads count
    above 65535; it raises on a head dim that is not a multiple of 8, on a
    grid past 2^31 - 1 blocks (from 136 to 256 the bf16 bodies' two blocks
    per 64-row tile, the f32 forward taking one block per 96-row tile, dQ
    per 80-row tile and dK/dV per 64-row tile; above, the wide bodies'
    column groups: the clusters' 64-row tiles up to head dim 1024; above
    it one block per 64-row tile and 256 columns, the three kernels
    alike), and on a non-contiguous panel."""
    meta = lambda *s, dt=torch.bfloat16: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    for d in (8, 24, 40, 96, 120, 128, 136, 160, 192, 256, 264, 320, 512, 1024, 1032, 2056):
        for dt in (torch.bfloat16, torch.float32):
            want = (3, 64, d, dt == torch.bfloat16)
            assert ta._check(meta(3, 64, d, dt=dt), (meta(3, 64, d, dt=dt),)) == want
        for n in (64, 200, 2048):
            if 128 < d <= 256:
                assert max(-(-n // 80), 2 * -(-n // 64)) == ta._blocks_per_panel(n, d)
            elif 256 < d <= ta.CLUSTER_MAX_D:
                assert -(-n // 64) * -(-d // 128) == ta._blocks_per_panel(n, d)
            elif d > ta.CLUSTER_MAX_D:
                assert -(-n // 64) * -(-d // 256) == ta._blocks_per_panel(n, d)
    q = meta(70_000, 16, 16)
    rows = (meta(70_000, 16, 1, dt=torch.float32),) * 2
    assert ta._check(q, (q, q, q), rows) == (70_000, 16, 16, True)
    # 2^31 / (2048 / 64 row tiles x 8 ranks) batch*heads fill the clusters'
    # grid, 2^31 / (2048 / 64 row tiles x 5 blocks of 256 columns) the grid
    # above 1024
    assert ta._blocks_per_panel(2048, 1024) == 256
    ta._check(meta(2**23 - 1, 2048, 1024))
    with pytest.raises(ValueError, match="grid"):
        ta._check(meta(2**23, 2048, 1024))
    assert ta._blocks_per_panel(2048, 1032) == 160
    assert -(-2048 // ta.WIDE_TC_TILE[0]) * -(-1032 // ta.WIDE_TC_TILE[1]) == 160
    ta._check(meta(2**31 // 160, 2048, 1032))
    with pytest.raises(ValueError, match="grid"):
        ta._check(meta(2**31 // 160 + 1, 2048, 1032))
    with pytest.raises(ValueError, match="head dim"):
        ta._check(meta(2, 64, 20))
    with pytest.raises(ValueError, match="contiguous"):
        ta._check(meta(2, 64, 16), (meta(2, 16, 64).transpose(1, 2),))


def test_split_bf16_backward_meets_the_card_bounds():
    """The bf16 dQ and dK/dV kernels take their products with the f32 p and ds
    split into two bf16 terms, x = bf16(x) + bf16(x - bf16(x)).  The plain
    backward with p and ds so split lies within 1e-5 of the largest magnitude
    of the plain f32 result, and after the bf16 store within chip_smoke.py's
    bf16 bound (one bf16 step of the value plus 1e-5 of the largest
    magnitude), with a mean error under half that of the bf16-p control
    (chip_smoke.att_bf16p)."""
    cs = chip_smoke()
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


def _tf32_dot(a, b, passes):
    """a @ b (f32) as the f32 kernels take it on the tensor cores:
    with three passes a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, x_hi = tf32(x),
    x_lo = tf32(x - x_hi) (chip_smoke.tf32's rounding); with one pass
    a_hi.b_hi.  Summed in f64, rounded to f32 once."""
    cs = chip_smoke()
    ah, bh = cs.tf32(a), cs.tf32(b)
    if passes == 1:
        return (ah.double() @ bh.double()).float()
    al, bl = cs.tf32(a - ah), cs.tf32(b - bh)
    return (al.double() @ bh.double() + ah.double() @ bl.double()
            + ah.double() @ bh.double()).float()


def _step_dot(a, b, step, passes):
    """a @ b over the contraction in steps of ``step``, each step's
    _tf32_dot begun afresh and added to the running sum in f32, as the f32
    kernels take their long sums."""
    total = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for c0 in range(0, a.shape[-1], step):
        total = total + _tf32_dot(a[..., c0:c0 + step], b[..., c0:c0 + step, :], passes)
    return total


# keys of a dQ score step and queries of a dK/dV one (their long sums' steps):
# dq_tf32_kernel's DQ32_SC and dkv_tf32_kernel's DKV32_SC up to head dim 128;
# from 160 the K/V tiles of dq_tf32w_kernel (DQW_TK) and the Q/dO tiles of
# dkv_tf32w_kernel (WKV_TQ)
def _bwd_steps(d):
    return {"dq": 64 if d <= 64 else 32 if d <= 128 else 16,
            "dkv": 32 if d <= 64 or d > 128 else 16}


# (d, out, amp): each output at each head dim, and dQ at 256 with q and k
# times 3 (scores to about 40) against JAX's _dq_kernel
BWD_CASES = [pytest.param(d, out, 1.0, id=f"{d}-{out}")
             for d in (64, 96, 160, 192, 256) for out in ("dq", "dk", "dv")]
BWD_CASES.append(pytest.param(256, "dq", 3.0, id="256-dq-amp3"))


@pytest.mark.parametrize("d, out, amp", BWD_CASES)
def test_split_tf32_backward_meets_the_f32_bound(d, out, amp):
    """The f32 dQ and dK/dV kernels take every product in split TF32: s =
    (q * scale).k^T a k8 step at a time (each step's passes summed afresh
    and added in f32) and dp = do.v^T, then p = exp(s - l), ds = p (dp -
    delta), then dq = (ds.k) scale, dk = (ds^T.q) scale and dv = p^T.do,
    each product three TF32 passes and each long sum taken per score step
    (``_bwd_steps``) and added in f32.  That emulation at (2, 256, d) lies
    within chip_smoke.py's f32 bound (1e-5 of the largest magnitude) of
    attention_dq_plain and attention_dkv_plain; one pass per product (the
    control) lies outside it.  From head dim 160 it is dq_tf32w_kernel's and
    dkv_tf32w_kernel's arithmetic (each score formed once over all columns,
    dQ's long sums per 16-key tile).  With q and k times ``amp`` (3: dQ at
    256) the emulation, from JAX's own o and l, lies within chip_smoke.py's
    bounds of JAX's ``_dq_kernel`` (interpret mode) and of the exact result
    (``_wide_check``), and the control outside the f32 bound."""
    cs = chip_smoke()
    rng = np.random.default_rng(11)
    q, k, v, do = (rng.normal(size=(2, 256, d)).astype(np.float32) for _ in range(4))
    q, k = q * np.float32(amp), k * np.float32(amp)
    scale = d**-0.5
    q, k, v, do = (torch.tensor(a) for a in (q, k, v, do))
    if amp == 1.0:
        o, l = ta.attention_fwd_plain(q, k, v, scale)
        delta = torch.sum(do * o, dim=-1, keepdim=True)
        plain = dict(zip(("dq", "dk", "dv"),
                         (ta.attention_dq_plain(q, k, v, do, l, delta, scale),
                          *ta.attention_dkv_plain(q, k, v, do, l, delta, scale))))
    else:
        jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
        o_j, l_j = ja._attention_fwd_flat(jq, jk, jv, scale)
        dq_want, _, _ = ja._attention_bwd_flat(jq, jk, jv, o_j, l_j, jdo, scale)
        l = torch.tensor(np.asarray(l_j))
        delta = torch.sum(do * torch.tensor(np.asarray(o_j)), -1, keepdim=True)
    steps = _bwd_steps(d)

    def emulate(passes):
        s = _step_dot(q * scale, k.transpose(-1, -2), 8, passes)
        dp = _tf32_dot(do, v.transpose(-1, -2), passes)
        p = torch.exp(s - l)
        ds = p * (dp - delta)
        return {"dq": _step_dot(ds, k, steps["dq"], passes) * scale,
                "dk": _step_dot(ds.transpose(-1, -2), q, steps["dkv"], passes) * scale,
                "dv": _step_dot(p.transpose(-1, -2), do, steps["dkv"], passes)}[out]

    if amp == 1.0:
        want = plain[out]
        err = {n: ((emulate(n) - want).abs().max() / want.abs().max()).item() for n in (3, 1)}
        assert err[3] <= cs.ATT_TOL_F32, (out, d, err)
        assert err[1] > cs.ATT_TOL_F32, (out, d, err)
        return
    (exact,) = cs.att_f64("attention_dq", q, k, v, do, l, delta, scale=scale)
    _wide_check(emulate(3), dq_want, exact, "split_tf32", f"dq at {d}, q and k times {amp}")
    ctl = _wide_control(emulate(1), dq_want, "split_tf32")
    assert ctl > cs.ATT_TOL_F32, (d, amp, ctl)


def _split_tf32_forward(q, k, v, scale, passes):
    """attention_fwd as fwd_tf32_kernel (and from head dim 160
    fwd_tf32w_kernel, whose two warps of a row pair each form half of a
    tile's scores in the same order) takes it: s = (q * scale).k^T a k8
    step at a time, each step's TF32 passes summed afresh and added to s in
    f32; over the kernel's 32-key K/V tiles the online max m and sum, p =
    exp(s - m_new), the running output rescaled by exp(m - m_new) and the
    tile's p.v summed afresh and added in f32; o = acc * (1 / sum), l = m +
    log(sum)."""
    bh, n, d = q.shape
    qs, kt = q * scale, k.transpose(-1, -2)
    s = torch.zeros(bh, n, n)
    for k0 in range(0, d, 8):
        s = s + _tf32_dot(qs[..., k0:k0 + 8], kt[..., k0:k0 + 8, :], passes)
    m = torch.full((bh, n, 1), -torch.inf)
    total = torch.zeros(bh, n, 1)
    acc = torch.zeros(bh, n, d)
    for j in range(0, n, 32):
        st = s[..., j:j + 32]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        total = total * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _tf32_dot(p, v[:, j:j + 32], passes)
        m = m_new
    return acc * (1 / total), m + torch.log(total)


@pytest.mark.parametrize("amp", [1.0, 3.0])
@pytest.mark.parametrize("d", [64, 96, 160, 192, 256])
def test_split_tf32_forward_meets_the_f32_bound(d, amp):
    """The f32 forward kernel's arithmetic (``_split_tf32_forward``, three
    TF32 passes a product) at (2, 256, d), q and k times ``amp`` (3: scores
    to about 40), lies within chip_smoke.py's f32 bound (1e-5 of the largest
    magnitude) of the JAX Pallas body ``_fwd_kernel`` (interpret mode), in o
    and in l; one pass a product (the control) lies outside it."""
    cs = chip_smoke()
    rng = np.random.default_rng(13)
    q, k, v = (rng.normal(size=(2, 256, d)).astype(np.float32) for _ in range(3))
    q, k = q * np.float32(amp), k * np.float32(amp)
    scale = d**-0.5
    o_want, l_want = ja._attention_fwd_flat(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    o_want, l_want = np.asarray(o_want), np.asarray(l_want)

    def errs(passes):
        o, l = _split_tf32_forward(*(torch.tensor(a) for a in (q, k, v)), scale, passes)
        return [float(np.abs(got.numpy() - want).max() / np.abs(want).max())
                for got, want in ((o, o_want), (l, l_want))]

    split, one = errs(3), errs(1)
    assert max(split) <= cs.ATT_TOL_F32, (d, amp, split)
    assert min(one) > cs.ATT_TOL_F32, (d, amp, one)


def _rz(x):
    """f64 ``x`` rounded to f32 towards zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


@pytest.mark.parametrize("per_step", [False, True])
def test_split_tf32_step_sums_bound_a_truncating_accumulator(per_step):
    """dq = (ds.k) scale over 1280 keys, each k8 step three split-TF32 MMAs,
    under a model of an MMA that rounds its sum towards zero (products and
    their sum exact, one truncation to f32 per MMA).  Into one accumulator
    (480 MMAs) the bias leaves dq outside chip_smoke.py's f32 bound; summed
    per 64-key score step into a fresh accumulator and added to the
    running sum in f32 (to nearest), as dq_tf32_kernel does, it stays within
    half of it.  The kernel's scores are exact here (the plain p and ds)."""
    cs = chip_smoke()
    rng = np.random.default_rng(11)
    n, d, sc = 1280, 64, 64
    q, k, v, do = (torch.tensor(rng.normal(size=(1, n, d)).astype(np.float32))
                   for _ in range(4))
    scale = d**-0.5
    o, l = ta.attention_fwd_plain(q, k, v, scale)
    delta = torch.sum(do * o, dim=-1, keepdim=True)
    _, ds = ta._p_ds(q, k, v, do, l, delta, scale)
    want = ta.attention_dq_plain(q, k, v, do, l, delta, scale)[0]
    a, b = ds[0], k[0]
    ah, bh = cs.tf32(a), cs.tf32(b)
    al, bl = cs.tf32(a - ah), cs.tf32(b - bh)
    total = torch.zeros(n, d)
    acc = torch.zeros(n, d)
    for k0 in range(0, n, 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = _rz(acc.double() + x[:, ks].double() @ y[ks].double())
        if per_step and (k0 + 8) % sc == 0:
            total, acc = total + acc, torch.zeros(n, d)
    got = (total + acc) * scale
    err = ((got - want).abs().max() / want.abs().max()).item()
    if per_step:
        assert err <= cs.ATT_TOL_F32 / 2, err
    else:
        assert err > cs.ATT_TOL_F32, err


# ---------------------------------------------------------------------------
# the cluster bodies above head dim 256 (fwd_wide_kernel, dkv_wide_kernel)
# ---------------------------------------------------------------------------

WIDE_COLS = 128  # head-dim columns of one cluster rank
WIDE_TK = {"split_tf32": 32, "bf16": 64}  # keys of a forward K/V tile
WIDE_TQ = 32  # queries of a dK/dV Q/dO tile
WIDE_DQ_TK = 32  # keys of a dQ K/V tile


def _bf16_split(x):
    """x = bf16(x) + bf16(x - bf16(x)), as the bf16 kernels split p and ds."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def _dot64(a, b):
    """a @ b with exact products and one rounding to f32 (a k16 MMA chain's
    sum, which the model does not round step by step)."""
    return (a.double() @ b.double()).float()


def _rank_partials(a, b, mode, passes, per_step):
    """The partial products a[..., cols] @ b[cols, :] of each rank's 128
    columns, in rank order: bf16 raw; split TF32 each k8 step's passes summed
    afresh and added in f32 (per_step, the scores) or the slice's passes in
    one sum (dp)."""
    d = a.shape[-1]
    parts = []
    for c0 in range(0, d, WIDE_COLS):
        cols = slice(c0, min(d, c0 + WIDE_COLS))
        if mode == "bf16":
            parts.append(_dot64(a[..., cols], b[..., cols, :]))
        elif per_step:
            steps = _tf32_steps(a[..., cols], b[..., cols, :], passes)
            s = torch.zeros(a.shape[:-1] + b.shape[-1:])
            for i in range(steps.shape[-3]):
                s = s + steps[..., i, :, :]
            parts.append(s)
        else:
            parts.append(_tf32_dot(a[..., cols], b[..., cols, :], passes))
    return parts


def _tf32_steps(a, b, passes):
    """_tf32_dot of every k8 step of a @ b at once: (..., steps, rows, cols)."""
    cs = chip_smoke()
    k = a.shape[-1]
    a = a.reshape(*a.shape[:-1], k // 8, 8).movedim(-2, -3)
    b = b.reshape(*b.shape[:-2], k // 8, 8, b.shape[-1])
    ah, bh = cs.tf32(a), cs.tf32(b)
    if passes == 1:
        return (ah.double() @ bh.double()).float()
    al, bl = cs.tf32(a - ah), cs.tf32(b - bh)
    return (al.double() @ bh.double() + ah.double() @ bl.double()
            + ah.double() @ bh.double()).float()


def _cluster_sum(parts):
    """The cluster's sum: the ranks' partials added in rank order 0..P-1."""
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s


def _grad_dot(a, b, mode, passes, control):
    """a @ b over one tile of the long contraction: split TF32, or bf16 with a
    split into hi + lo (the control rounds a to bf16 instead)."""
    if mode == "bf16":
        return _dot64(a.bfloat16().float() if control else _bf16_split(a), b)
    return _tf32_dot(a, b, passes)


def _wide_forward(q, k, v, scale, mode, passes=3, control=False):
    """attention_fwd as fwd_wide_kernel takes it: the ranks' partial scores
    (bf16 q.k^T raw, then times scale; f32 (q * scale).k^T) summed in rank
    order; over the K/V tiles the online max and sum, p = exp(s - m_new), the
    running output rescaled and the tile's p.v added; o = acc * (1 / sum),
    l = m + log(sum)."""
    bh, n, _ = q.shape
    kt = k.transpose(-1, -2)
    if mode == "bf16":
        s = _cluster_sum(_rank_partials(q, kt, mode, passes, True)) * scale
    else:
        s = _cluster_sum(_rank_partials(q * scale, kt, mode, passes, True))
    m = torch.full((bh, n, 1), -torch.inf)
    total = torch.zeros(bh, n, 1)
    acc = torch.zeros_like(v)
    tk = WIDE_TK[mode]
    for j in range(0, n, tk):
        st = s[..., j:j + tk]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        total = total * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _grad_dot(p, v[:, j:j + tk], mode, passes, control)
        m = m_new
    return acc * (1 / total), m + torch.log(total)


def _wide_dkv(q, k, v, do, l, delta, scale, mode, passes=3, control=False):
    """attention_dkv as dkv_wide_kernel takes it: the ranks' partial s^T and
    dp^T summed in rank order, p^T = exp(s^T - l) and ds^T = p^T (dp^T -
    delta) formed once from the sums, then over the Q/dO tiles dv += p^T.do
    and dk += ds^T.q (times scale at the store)."""
    bh, n, _ = q.shape
    if mode == "bf16":
        s = _cluster_sum(_rank_partials(k, q.transpose(-1, -2), mode, passes, True)) * scale
    else:
        s = _cluster_sum(_rank_partials(k, (q * scale).transpose(-1, -2), mode, passes, True))
    dp = _cluster_sum(_rank_partials(v, do.transpose(-1, -2), mode, passes, False))
    lt, dt = l.transpose(-1, -2), delta.transpose(-1, -2)
    p = torch.exp(s - lt)
    ds = p * (dp - dt)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for j in range(0, n, WIDE_TQ):
        cols = slice(j, j + WIDE_TQ)
        dv = dv + _grad_dot(p[..., cols], do[:, cols], mode, passes, control)
        dk = dk + _grad_dot(ds[..., cols], q[:, cols], mode, passes, control)
    return dk * scale, dv


def _wide_dq(q, k, v, do, l, delta, scale, mode, passes=3, control=False):
    """attention_dq as dq_wide_kernel takes it: the ranks' partial s (per-step
    sums) and dp summed in rank order, ds = p (dp - delta) with p = exp(s -
    l) formed once from the sums, then over the K/V tiles dq += ds.k (times
    scale at the store)."""
    n = q.shape[1]
    kt = k.transpose(-1, -2)
    if mode == "bf16":
        s = _cluster_sum(_rank_partials(q, kt, mode, passes, True)) * scale
    else:
        s = _cluster_sum(_rank_partials(q * scale, kt, mode, passes, True))
    dp = _cluster_sum(_rank_partials(do, v.transpose(-1, -2), mode, passes, False))
    ds = torch.exp(s - l) * (dp - delta)
    dq = torch.zeros_like(q)
    for j in range(0, n, WIDE_DQ_TK):
        cols = slice(j, j + WIDE_DQ_TK)
        dq = dq + _grad_dot(ds[..., cols], k[:, cols], mode, passes, control)
    return dq * scale


def _wide_inputs(d, mode, amp, count):
    """(2, 160, d) inputs from a seed, q and k times amp; bf16 mode rounds them
    to bf16 (both packages take the same values)."""
    rng = np.random.default_rng(d)
    xs = [rng.normal(size=(2, 160, d)).astype(np.float32) for _ in range(count)]
    xs[0], xs[1] = xs[0] * np.float32(amp), xs[1] * np.float32(amp)
    if mode == "bf16":
        xs = [torch.tensor(x).bfloat16().float().numpy() for x in xs]
    return xs


def _rel(got, want) -> float:
    """max |got - want| over the largest magnitude of ``want`` (a tensor or a
    JAX array)."""
    if not isinstance(want, torch.Tensor):
        want = torch.tensor(np.asarray(jnp.asarray(want, jnp.float32)))
    want = want.double()
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def _wide_check(got, want, exact, mode, what):
    """chip_smoke.py's bounds.  f32: within 1e-5 of the largest magnitude of
    the exact result (chip_smoke.att_f64), and of JAX's result within 1e-5 plus JAX's own
    distance from the exact one (at scores times 3 JAX's f32 sums alone lie
    up to 1.4e-5 from it).  bf16: the f32 sums within 1e-5 of the exact
    result, and rounded to bf16 within one bf16 step of the value plus 1e-5
    of the largest magnitude of JAX's result.  Returns the mean absolute
    error against JAX."""
    cs = chip_smoke()
    err_exact = _rel(got, exact)
    assert err_exact <= cs.ATT_TOL_F32, f"{what}: rel-to-max {err_exact:.3e} from the f64 result"
    want = torch.tensor(np.asarray(jnp.asarray(want, jnp.float32)))
    if mode == "bf16":
        got = got.bfloat16().float()
        lim = cs.BF16_STEP * torch.maximum(got.abs(), want.abs()) + cs.ATT_TOL_F32 * want.abs().max()
        worst = ((got - want).abs() / lim).max().item()
        assert worst <= 1.0, f"{what}: worst error over one bf16 step {worst:.3f}"
    else:
        err, ref = _rel(got, want), _rel(want, exact)
        assert err <= cs.ATT_TOL_F32 + ref, f"{what}: rel-to-max {err:.3e} (JAX's own {ref:.3e})"
    return (got - want).abs().mean().item()


def _wide_control(got, want, mode):
    """The control's error: rel-to-max (split TF32, one pass a product) or
    mean abs after the bf16 store (bf16, p and ds rounded to bf16)."""
    want = torch.tensor(np.asarray(jnp.asarray(want, jnp.float32)))
    if mode == "bf16":
        return (got.bfloat16().float() - want).abs().mean().item()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("amp", [1.0, 3.0])
@pytest.mark.parametrize("mode", ["split_tf32", "bf16"])
@pytest.mark.parametrize("d", [264, 512, 1024])
def test_cluster_forward_meets_the_card_bounds(d, mode, amp):
    """The forward cluster body's arithmetic (``_wide_forward``: partial
    scores over each rank's 128 columns added in rank order, online softmax
    over its K/V tiles) at (2, 160, d), q and k times ``amp``, lies within
    chip_smoke.py's bounds of JAX's ``_fwd_kernel`` (interpret mode) and of
    the exact result (``_wide_check``) in o and l; the control (one TF32 pass a product; p rounded to bf16) does not
    (f32: outside the bound; bf16: at least twice the mean error)."""
    cs = chip_smoke()
    jdt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    q, k, v = _wide_inputs(d, mode, amp, 3)
    scale = d**-0.5
    o_want, l_want = ja._attention_fwd_flat(*(jnp.asarray(a, jdt) for a in (q, k, v)), scale)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    o, l = _wide_forward(tq, tk, tv, scale, mode)
    o_exact, l_exact = cs.att_f64("attention_fwd", tq, tk, tv, scale=scale)
    mean = _wide_check(o, o_want, o_exact, mode, "o")
    assert _rel(l, l_want) <= cs.ATT_TOL_F32 and _rel(l, l_exact) <= cs.ATT_TOL_F32
    ctl_o, _ = _wide_forward(tq, tk, tv, scale, mode, passes=1, control=True)
    ctl = _wide_control(ctl_o, o_want, mode)
    if mode == "bf16":
        assert mean < ctl / 2, (mean, ctl)
    else:
        assert ctl > cs.ATT_TOL_F32, ctl


@pytest.mark.parametrize("amp", [1.0, 3.0])
@pytest.mark.parametrize("mode", ["split_tf32", "bf16"])
@pytest.mark.parametrize("d", [264, 512, 1024])
def test_cluster_dkv_meets_the_card_bounds(d, mode, amp):
    """The dK/dV cluster body's arithmetic (``_wide_dkv``: partial s^T and
    dp^T over each rank's 128 columns added in rank order, p^T and ds^T from
    the sums, dv and dk over its Q/dO tiles) at (2, 160, d), q and k times
    ``amp``, from JAX's own o and l, lies within chip_smoke.py's bounds of
    JAX's ``_dkv_kernel`` (interpret mode) and of the exact result
    (``_wide_check``); the control (one TF32 pass a
    product; p and ds rounded to bf16) does not."""
    cs = chip_smoke()
    jdt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    q, k, v, do = _wide_inputs(d, mode, amp, 4)
    scale = d**-0.5
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    o_j, l_j = ja._attention_fwd_flat(jq, jk, jv, scale)
    _, dk_want, dv_want = ja._attention_bwd_flat(jq, jk, jv, o_j, l_j, jdo, scale)
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    l = torch.tensor(np.asarray(l_j))
    delta = torch.sum(tdo * torch.tensor(np.asarray(o_j.astype(jnp.float32))), -1, keepdim=True)
    dk, dv = _wide_dkv(tq, tk, tv, tdo, l, delta, scale, mode)
    dk_exact, dv_exact = cs.att_f64("attention_dkv", tq, tk, tv, tdo, l, delta, scale=scale)
    means = [_wide_check(dk, dk_want, dk_exact, mode, "dk"),
             _wide_check(dv, dv_want, dv_exact, mode, "dv")]
    ctl_dk, ctl_dv = _wide_dkv(tq, tk, tv, tdo, l, delta, scale, mode, passes=1, control=True)
    ctls = [_wide_control(ctl_dk, dk_want, mode), _wide_control(ctl_dv, dv_want, mode)]
    if mode == "bf16":
        assert all(m < c / 2 for m, c in zip(means, ctls)), (means, ctls)
    else:
        assert min(ctls) > cs.ATT_TOL_F32, ctls


@pytest.mark.parametrize("amp", [1.0, 3.0])
@pytest.mark.parametrize("mode", ["split_tf32", "bf16"])
@pytest.mark.parametrize("d", [264, 512, 1024])
def test_cluster_dq_meets_the_card_bounds(d, mode, amp):
    """The dQ cluster body's arithmetic (``_wide_dq``: partial s and dp over
    each rank's 128 columns added in rank order, ds from the sums, dq over
    its K/V tiles) at (2, 160, d), q and k times ``amp``, from JAX's own o
    and l, lies within chip_smoke.py's bounds of JAX's ``_dq_kernel``
    (interpret mode) and of the exact result (``_wide_check``); the control
    (one TF32 pass a product; ds rounded to bf16) does not."""
    cs = chip_smoke()
    jdt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    q, k, v, do = _wide_inputs(d, mode, amp, 4)
    scale = d**-0.5
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    o_j, l_j = ja._attention_fwd_flat(jq, jk, jv, scale)
    dq_want, _, _ = ja._attention_bwd_flat(jq, jk, jv, o_j, l_j, jdo, scale)
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    l = torch.tensor(np.asarray(l_j))
    delta = torch.sum(tdo * torch.tensor(np.asarray(o_j.astype(jnp.float32))), -1, keepdim=True)
    dq = _wide_dq(tq, tk, tv, tdo, l, delta, scale, mode)
    (dq_exact,) = cs.att_f64("attention_dq", tq, tk, tv, tdo, l, delta, scale=scale)
    mean = _wide_check(dq, dq_want, dq_exact, mode, "dq")
    ctl_dq = _wide_dq(tq, tk, tv, tdo, l, delta, scale, mode, passes=1, control=True)
    ctl = _wide_control(ctl_dq, dq_want, mode)
    if mode == "bf16":
        assert mean < ctl / 2, (mean, ctl)
    else:
        assert ctl > cs.ATT_TOL_F32, ctl


# ---------------------------------------------------------------------------
# the forward and dK/dV above head dim 1024 (fwd_wide_tc_kernel,
# dkv_wide_tc_kernel): one block's tensor-core score loop over all of d
# ---------------------------------------------------------------------------

WIDE_TC_SLICE = {"split_tf32": 64, "bf16": 128}  # columns of d a staged slice (WT_S)
WIDE_TC_TK = 64  # keys of a forward K/V tile (WT_TK)
WIDE_TC_PV = 32  # keys of an f32 p.v (and ds.k) sum begun at 0
WIDE_TC_DQ_TK = 64  # keys of a dQ K/V tile (WDQ_TC_TK)


def _slice_dot(a, b, mode, passes, per_step):
    """a @ b over all of d as the bodies above 1024 accumulate it, slice by
    slice in order: bf16 raw (each slice's sum exact, rounded to f32 once,
    added in f32); split TF32 each k8 step's passes summed afresh and added
    in f32 (``per_step``: the scores) or each slice's passes in one sum and
    added in f32 (dp^T)."""
    if mode == "split_tf32":
        return _step_dot(a, b, 8 if per_step else WIDE_TC_SLICE[mode], passes)
    total = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for c0 in range(0, a.shape[-1], WIDE_TC_SLICE[mode]):
        cols = slice(c0, c0 + WIDE_TC_SLICE[mode])
        total = total + _dot64(a[..., cols], b[..., cols, :])
    return total


def _wide_tc_forward(q, k, v, scale, mode, passes=3, control=False):
    """attention_fwd as fwd_wide_tc_kernel takes it: the scores over all of
    d slice by slice (``_slice_dot``: bf16 q.k^T raw, then times scale; f32
    (q * scale).k^T); over K/V tiles of 64 keys the online max and sum, p =
    exp(s - m_new), the running output rescaled and the tile's p.v added
    (bf16 p split into hi + lo; f32 the sums of each 32 keys begun afresh);
    o = acc * (1 / sum), l = m + log(sum)."""
    bh, n, _ = q.shape
    kt = k.transpose(-1, -2)
    if mode == "bf16":
        s = _slice_dot(q, kt, mode, passes, True) * scale
    else:
        s = _slice_dot(q * scale, kt, mode, passes, True)
    m = torch.full((bh, n, 1), -torch.inf)
    total = torch.zeros(bh, n, 1)
    acc = torch.zeros_like(v)
    for j in range(0, n, WIDE_TC_TK):
        st = s[..., j:j + WIDE_TC_TK]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        total = total * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        step = WIDE_TC_TK if mode == "bf16" else WIDE_TC_PV
        for h in range(0, p.shape[-1], step):
            acc = acc + _grad_dot(p[..., h:h + step], v[:, j + h:j + h + step], mode, passes,
                                  control)
        m = m_new
    return acc * (1 / total), m + torch.log(total)


def _wide_tc_dkv(q, k, v, do, l, delta, scale, mode, passes=3, control=False):
    """attention_dkv as dkv_wide_tc_kernel takes it: s^T and dp^T over all
    of d slice by slice (``_slice_dot``), p^T = exp(s^T - l) and ds^T = p^T
    (dp^T - delta), then over the Q/dO tiles of 32 queries dv += p^T.do and
    dk += ds^T.q (times scale at the store)."""
    n = q.shape[1]
    if mode == "bf16":
        s = _slice_dot(k, q.transpose(-1, -2), mode, passes, True) * scale
    else:
        s = _slice_dot(k, (q * scale).transpose(-1, -2), mode, passes, True)
    dp = _slice_dot(v, do.transpose(-1, -2), mode, passes, False)
    p = torch.exp(s - l.transpose(-1, -2))
    ds = p * (dp - delta.transpose(-1, -2))
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for j in range(0, n, WIDE_TQ):
        cols = slice(j, j + WIDE_TQ)
        dv = dv + _grad_dot(p[..., cols], do[:, cols], mode, passes, control)
        dk = dk + _grad_dot(ds[..., cols], q[:, cols], mode, passes, control)
    return dk * scale, dv


def _wide_tc_dq(q, k, v, do, l, delta, scale, mode, passes=3, control=False):
    """attention_dq as dq_wide_tc_kernel takes it: s and dp over all of d
    slice by slice (``_slice_dot``), ds = p (dp - delta) with p = exp(s - l),
    then dq += ds.k over the K/V tiles (bf16: a tile of WIDE_TC_DQ_TK keys,
    ds split into hi + lo; f32: the sums of each 32 keys begun afresh),
    times scale at the store."""
    n = q.shape[1]
    kt = k.transpose(-1, -2)
    if mode == "bf16":
        s = _slice_dot(q, kt, mode, passes, True) * scale
    else:
        s = _slice_dot(q * scale, kt, mode, passes, True)
    dp = _slice_dot(do, v.transpose(-1, -2), mode, passes, False)
    ds = torch.exp(s - l) * (dp - delta)
    dq = torch.zeros_like(q)
    step = WIDE_TC_DQ_TK if mode == "bf16" else WIDE_TC_PV
    for j in range(0, n, step):
        cols = slice(j, j + step)
        dq = dq + _grad_dot(ds[..., cols], k[:, cols], mode, passes, control)
    return dq * scale


@pytest.mark.parametrize("amp", [1.0, 3.0])
@pytest.mark.parametrize("mode", ["split_tf32", "bf16"])
@pytest.mark.parametrize("d", [1032, 2056])
def test_wide_tc_forward_meets_the_card_bounds(d, mode, amp):
    """The forward body above head dim 1024 (``_wide_tc_forward``: the
    scores summed slice by slice over all of d, online softmax over 64-key
    tiles, split p.v) at (2, 160, d), q and k times ``amp``, lies within
    chip_smoke.py's bounds of JAX's ``_fwd_kernel`` (interpret mode) and of
    the exact result (``_wide_check``) in o and l; the control (one TF32
    pass a product; p rounded to bf16) does not."""
    cs = chip_smoke()
    jdt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    q, k, v = _wide_inputs(d, mode, amp, 3)
    scale = d**-0.5
    o_want, l_want = ja._attention_fwd_flat(*(jnp.asarray(a, jdt) for a in (q, k, v)), scale)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    o, l = _wide_tc_forward(tq, tk, tv, scale, mode)
    o_exact, l_exact = cs.att_f64("attention_fwd", tq, tk, tv, scale=scale)
    mean = _wide_check(o, o_want, o_exact, mode, "o")
    assert _rel(l, l_want) <= cs.ATT_TOL_F32 and _rel(l, l_exact) <= cs.ATT_TOL_F32
    ctl_o, _ = _wide_tc_forward(tq, tk, tv, scale, mode, passes=1, control=True)
    ctl = _wide_control(ctl_o, o_want, mode)
    if mode == "bf16":
        assert mean < ctl / 2, (mean, ctl)
    else:
        assert ctl > cs.ATT_TOL_F32, ctl


@pytest.mark.parametrize("amp", [1.0, 3.0])
@pytest.mark.parametrize("mode", ["split_tf32", "bf16"])
@pytest.mark.parametrize("d", [1032, 2056])
def test_wide_tc_dkv_meets_the_card_bounds(d, mode, amp):
    """The dK/dV body above head dim 1024 (``_wide_tc_dkv``: s^T and dp^T
    summed slice by slice over all of d, p^T and ds^T from the sums, dv and
    dk over 32-query tiles) at (2, 160, d), q and k times ``amp``, from
    JAX's own o and l, lies within chip_smoke.py's bounds of JAX's
    ``_dkv_kernel`` (interpret mode) and of the exact result
    (``_wide_check``); the control (one TF32 pass a product; p and ds
    rounded to bf16) does not."""
    cs = chip_smoke()
    jdt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    q, k, v, do = _wide_inputs(d, mode, amp, 4)
    scale = d**-0.5
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    o_j, l_j = ja._attention_fwd_flat(jq, jk, jv, scale)
    _, dk_want, dv_want = ja._attention_bwd_flat(jq, jk, jv, o_j, l_j, jdo, scale)
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    l = torch.tensor(np.asarray(l_j))
    delta = torch.sum(tdo * torch.tensor(np.asarray(o_j.astype(jnp.float32))), -1, keepdim=True)
    dk, dv = _wide_tc_dkv(tq, tk, tv, tdo, l, delta, scale, mode)
    dk_exact, dv_exact = cs.att_f64("attention_dkv", tq, tk, tv, tdo, l, delta, scale=scale)
    means = [_wide_check(dk, dk_want, dk_exact, mode, "dk"),
             _wide_check(dv, dv_want, dv_exact, mode, "dv")]
    ctl_dk, ctl_dv = _wide_tc_dkv(tq, tk, tv, tdo, l, delta, scale, mode, passes=1, control=True)
    ctls = [_wide_control(ctl_dk, dk_want, mode), _wide_control(ctl_dv, dv_want, mode)]
    if mode == "bf16":
        assert all(m < c / 2 for m, c in zip(means, ctls)), (means, ctls)
    else:
        assert min(ctls) > cs.ATT_TOL_F32, ctls


@pytest.mark.parametrize("amp", [1.0, 3.0])
@pytest.mark.parametrize("mode", ["split_tf32", "bf16"])
@pytest.mark.parametrize("d", [1032, 2056])
def test_wide_tc_dq_meets_the_card_bounds(d, mode, amp):
    """The dQ body above head dim 1024 (``_wide_tc_dq``: s and dp summed
    slice by slice over all of d, ds from the sums, ds.k over the body's key
    tiles, whose size is the source's) at (2, 160, d), q and k times
    ``amp``, from JAX's own o and l, lies within chip_smoke.py's bounds of
    JAX's ``_dq_kernel`` (interpret mode) and of the exact result
    (``_wide_check``); the control (one TF32 pass a product; ds rounded to
    bf16) does not."""
    from sciml_pde_torch.ops import _build

    src = (_build.CSRC / "attention.cu").read_text()
    assert f"constexpr int WDQ_TC_TK = {WIDE_TC_DQ_TK};" in src
    cs = chip_smoke()
    jdt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    q, k, v, do = _wide_inputs(d, mode, amp, 4)
    scale = d**-0.5
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    o_j, l_j = ja._attention_fwd_flat(jq, jk, jv, scale)
    dq_want, _, _ = ja._attention_bwd_flat(jq, jk, jv, o_j, l_j, jdo, scale)
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    l = torch.tensor(np.asarray(l_j))
    delta = torch.sum(tdo * torch.tensor(np.asarray(o_j.astype(jnp.float32))), -1, keepdim=True)
    dq = _wide_tc_dq(tq, tk, tv, tdo, l, delta, scale, mode)
    (dq_exact,) = cs.att_f64("attention_dq", tq, tk, tv, tdo, l, delta, scale=scale)
    mean = _wide_check(dq, dq_want, dq_exact, mode, "dq")
    ctl_dq = _wide_tc_dq(tq, tk, tv, tdo, l, delta, scale, mode, passes=1, control=True)
    ctl = _wide_control(ctl_dq, dq_want, mode)
    if mode == "bf16":
        assert mean < ctl / 2, (mean, ctl)
    else:
        assert ctl > cs.ATT_TOL_F32, ctl


def test_wide_ablation_cuts_what_it_names():
    """experiments/wide_attention_ablation.py times copies of attention.cu
    with the three cluster bodies' exchanges, then also their barriers,
    removed: its markers occur in the source, and each copy lacks exactly
    those."""
    from sciml_pde_torch.experiments import wide_attention_ablation as wa
    from sciml_pde_torch.ops import _build

    src = (_build.CSRC / "attention.cu").read_text()
    vs = wa.variants(src)
    assert vs["shipped"] == src
    assert len(wa.EXCHANGES) == 3
    for name, text in vs.items():
        exchanges = sum(text.count(e) for e in wa.EXCHANGES)
        barriers = sum(text.count(b) for b in wa.BARRIERS)
        assert exchanges == (3 if name == "shipped" else 0), name
        assert barriers == (0 if "barriers" in name else 2), name
        assert text.count("__global__") == src.count("__global__"), name


def test_tf32w_control_lowers_the_cluster_floor():
    """experiments/tf32w_attention_control.py times the f32 forward, dQ and
    dK/dV of head dims 160-256 against the P = 2 cluster route and against
    copies with the forward's blocks cut otherwise: its control copy
    of attention.cu sends f32 above head dim 128 (not 256) to the cluster
    bodies, every copy makes its edits once and renames every kernel, keeps
    every kernel of the source, and holds the kernels its profiler keys
    name (the three of each copy)."""
    from sciml_pde_torch.experiments import tf32w_attention_control as tc
    from sciml_pde_torch.ops import _build

    src = (_build.CSRC / "attention.cu").read_text()
    vs = tc.variants(src)
    assert list(vs) == list(tc.DESIGNS) and vs["shipped"] == src
    assert src.count(tc.FLOOR) == 1 and src.count(tc.ROWS) == 1 and src.count(tc.BLOCKS) == 1
    control = vs["cluster control"]
    assert control.count(tc.CONTROL_FLOOR) == 1 and tc.FLOOR not in control
    for i, (name, text) in enumerate(vs.items()):
        assert text.count("__global__") == src.count("__global__"), name
        if i:
            assert "fwd_tf32w_kernel" not in text and "dkv_wide_kernel" not in text, name
            assert text != src.replace("_kernel", tc.suffix(i)), name
        assert list(tc.keys(i, name)) == list(tc.FNAMES), name
        for key in tc.keys(i, name).values():
            assert key[:-1] in text, (name, key)


def test_wide_tc_control_builds_each_layout():
    """experiments/wide_tc_attention_control.py times the forward, dQ and
    dK/dV above head dim 1024 with two groups of 128 output columns a block
    and with one, and dQ with K/V tiles of 64 keys and of 32: the shipped
    source sets WT_G and WDQ_TC_TK once, each copy changes one of them and
    renames every kernel, every copy keeps every kernel of the source, and
    the profiler keys each copy's forward, dQ and dK/dV under (and the
    cluster bodies the cliff reads at 1024) name kernels of it."""
    from sciml_pde_torch.experiments import wide_tc_attention_control as wc
    from sciml_pde_torch.ops import _build

    src = (_build.CSRC / "attention.cu").read_text()
    assert len(wc.GROUPS.findall(src)) == 1 and len(wc.DQ_TILE.findall(src)) == 1
    vs = wc.variants(src)
    designs = wc.designs(src)
    assert list(vs) == list(designs) and list(vs.values())[0] == src
    assert sorted({g for g, _ in designs.values()}) == [1, 2]
    assert sorted({tk for _, tk in designs.values()}) == [32, 64]
    shipped = list(designs.values())[0]
    assert all(sum(a != b for a, b in zip(dv, shipped)) == 1 for dv in list(designs.values())[1:])
    for i, (name, text) in enumerate(vs.items()):
        groups, tk = designs[name]
        assert wc.GROUPS.findall(text) == [str(groups)], name
        assert wc.DQ_TILE.findall(text) == [str(tk)], name
        assert text.count("__global__") == src.count("__global__"), name
        if i:
            assert "fwd_wide_tc_kernel" not in text and "dkv_wide_kernel" not in text, name
        assert list(wc.keys(i)) == list(wc.FNAMES), name
        for key in wc.keys(i).values():
            assert key[:-1] + "(" in text, (name, key)
    for body in wc.CLUSTER.values():
        assert f"{body}_kernel(" in src, body
    assert wc.bound_ms("attention_fwd", 2, 256, 1032, torch.float32) == pytest.approx(
        6 * 2 * 2 * 256**2 * 1032 / 495e12 * 1e3)
    assert wc.bound_ms("attention_dkv", 2, 256, 1032, torch.bfloat16) == pytest.approx(
        (6 * 2 * 256 * 1032 * 2 + 2 * 2 * 256 * 4) / 3.35e12 * 1e3)
    assert wc.bound_ms("attention_dq", 2, 256, 1032, torch.float32) == pytest.approx(
        9 * 2 * 2 * 256**2 * 1032 / 495e12 * 1e3)
    assert wc.bound_ms("attention_dq", 2, 256, 1032, torch.bfloat16) == pytest.approx(
        (5 * 2 * 256 * 1032 * 2 + 2 * 2 * 256 * 4) / 3.35e12 * 1e3)


def test_checkout_comparison_keys_each_trees_body():
    """experiments/checkout_comparison.py reads each tree's f32 kernel of head
    dim 256 under its own name: the split-TF32 bodies of two warpgroups in
    this tree, the CUDA-core bodies in a tree from before them, renamed as
    the experiment renames the other tree; and above head dim 1024 the
    three tensor-core bodies of this tree, dQ's CUDA-core body in a tree
    that has only the forward's and dK/dV's on the tensor cores, and the
    three CUDA-core bodies before those."""
    from sciml_pde_torch.experiments import checkout_comparison as cc
    from sciml_pde_torch.ops import _build

    src = (_build.CSRC / "attention.cu").read_text()
    keys = ["fwd_tf32w_kernel<", "dq_tf32w_kernel<", "dkv_tf32w_kernel<"]
    assert [cc._key_256(src, s, "_kernel") for s in ("fwd", "dq", "dkv")] == keys
    for key in keys:
        assert key[:-1] + "(" in src.replace("<DP>", ""), key  # a body of that name
    assert "dq_kernel(" not in src.replace("<DP>", "")
    older = "fwd_pkernel(...) dq_pkernel(...) dkv_pkernel(...) fwd_tf32_pkernel(...)"
    assert [cc._key_256(older, s, "_pkernel") for s in ("fwd", "dq", "dkv")] == [
        "fwd_pkernel<", "dq_pkernel<", "dkv_pkernel<"]
    # above head dim 1024: the three tensor-core bodies in this tree; dQ's
    # CUDA-core body beside the other two's tensor-core bodies in a tree
    # from before dQ's; the three CUDA-core bodies before those
    wide = ["fwd_wide_tc_kernel<", "dq_wide_tc_kernel<", "dkv_wide_tc_kernel<"]
    assert [cc._key_wide(src, s, "_kernel") for s in ("fwd", "dq", "dkv")] == wide
    for key in wide:
        assert key[:-1] + "(" in src.replace("<DP>", ""), key
    assert "_wide_cc_kernel" not in src
    older = "fwd_wide_tc_pkernel(...) dq_wide_cc_pkernel(...) dkv_wide_tc_pkernel(...)"
    assert [cc._key_wide(older, s, "_pkernel") for s in ("fwd", "dq", "dkv")] == [
        "fwd_wide_tc_pkernel<", "dq_wide_cc_pkernel<", "dkv_wide_tc_pkernel<"]
    older = "fwd_wide_cc_pkernel(...) dq_wide_cc_pkernel(...) dkv_wide_cc_pkernel(...)"
    assert [cc._key_wide(older, s, "_pkernel") for s in ("fwd", "dq", "dkv")] == [
        "fwd_wide_cc_pkernel<", "dq_wide_cc_pkernel<", "dkv_wide_cc_pkernel<"]


def test_f32_dq_above_128_runs_on_the_tensor_cores():
    """chip_smoke.py holds the f32 dQ from head dim 136 to 256 to 1e-5 of the
    exact result, bounds it by its 9 TF32 passes and times it under the
    split-TF32 body's name (``att_kernel_key``: dq_tf32w_kernel, a body of
    attention.cu); no body keeps an escape from that bound (the CUDA cores'
    ``att_cuda_cores`` is gone): above CLUSTER_MAX_D the forward, dQ and
    dK/dV run on the tensor cores (``att_kernel_key``: fwd_wide_tc_kernel,
    dq_wide_tc_kernel and dkv_wide_tc_kernel, bodies of attention.cu); all
    three are bounded as the function needs whatever body computes it:
    bf16 products at the bf16 tensor-core rate, f32 ones as 6, 9 and 12 TF32
    passes (or by bytes, where larger)."""
    from sciml_pde_torch.ops import _build

    cs = chip_smoke()
    assert not hasattr(cs, "att_cuda_cores") and not hasattr(cs, "att_work_f32_cores")
    src = (_build.CSRC / "attention.cu").read_text().replace("<DP>", "")
    for d in (136, 160, 192, 256):
        key = cs.att_kernel_key("attention_dq", d, False)
        assert key == "dq_tf32w_kernel<" and key[:-1] + "(" in src, (d, key)
        assert cs.att_work("attention_dq", 8, 1280, d, False)[1] == pytest.approx(
            9 * 2 * 8 * 1280**2 * d / cs.TF32_FLOPS)
    assert cs.att_work("attention_dq", 8, 1280, 256, False)[1] * 1e3 == pytest.approx(
        0.12202, abs=1e-5)
    for name in ta.KERNEL_NAMES:
        short = name.replace("attention_", "")
        for bf in (False, True):
            for d in (ta.CLUSTER_MAX_D + 8, 2056):
                key = cs.att_kernel_key(name, d, bf)
                assert key == f"{short}_wide_tc_kernel<"
                assert key[:-1] + "(" in src, key
            assert cs.att_kernel_key(name, ta.CLUSTER_MAX_D, bf) == f"{short}_wide_kernel<"
        prod = 2 * 2 * 256**2 * 1032
        bf16_s = {"attention_fwd": 3, "attention_dq": 4, "attention_dkv": 6}[name] * prod
        tf32_s = {"attention_fwd": 6, "attention_dq": 9, "attention_dkv": 12}[name] * prod
        assert cs.att_work(name, 2, 256, 1032, True)[1] == pytest.approx(
            bf16_s / cs.PEAK_FLOPS["default"])
        assert cs.att_work(name, 2, 256, 1032, False)[1] == pytest.approx(
            tf32_s / cs.TF32_FLOPS)
