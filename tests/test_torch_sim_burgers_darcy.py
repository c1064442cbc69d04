"""Port of the Burgers-1D and Darcy-2D generators (``sim/burgers_1d.py``,
``sim/darcy_2d.py``) vs the JAX package's on the CPU.

JAX draws its initial conditions and coefficient fields from its own PRNG,
which the port does not reproduce: the port's simulations run on JAX's
``u0`` and JAX's coefficients, and its filters on JAX's draws.  Bounds, of
the largest magnitude: 1e-5 for the initial condition and the Burgers
trajectory at nx 128 (complex64 FFTs in another order; readings 1e-7);
the Darcy operator 1e-6; the Darcy solution 1e-5 at nx 32 (``TOL_DARCY``:
the batch-coupled CG's f32 dot products in another order; readings
1.5e-6).  The CG is JAX's: one alpha and beta over the batch, so at a
``tol`` that stops it before ``maxiter`` the port stops at JAX's iteration
(``test_darcy_cg_stops_at_jax_iteration``, a batch of 3: JAX's solution
with ``maxiter`` one short of the port's count differs from its own, with
that count it is the same).  At ``tol`` 1e-8 (the generator's) the loop
ran 186 iterations on the batch of 3 at 32^2, stopping on its own test.
File schemas through both writers (h5py, the port's HDF5 subset).
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.sim import burgers_1d as JB
from sciml_pde_tpu.sim import darcy_2d as JD
from sciml_pde_torch.io import h5 as h5io
from sciml_pde_torch.io import hdf5_lite
from sciml_pde_torch.sim import burgers_1d as TB
from sciml_pde_torch.sim import darcy_2d as TD

TOL, TOL_DARCY = 1e-5, 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------- Burgers


def test_burgers_ic_matches_jax_draws():
    key = jax.random.PRNGKey(1)
    want = JB.random_sine_ic(key, 3, 128)
    ka, kp, km = jax.random.split(key, 3)
    got = TB.sine_ic(_t(jax.random.normal(ka, (3, 8))), _t(jax.random.uniform(km, (3, 8))),
                     _t(jax.random.uniform(kp, (3, 8))), 128)
    assert _rel(got, want) <= TOL
    fresh = TB.random_sine_ic(torch.Generator().manual_seed(0), 4, 64, device="cpu")
    np.testing.assert_allclose(fresh.abs().amax(dim=1).numpy(), 1.0, rtol=1e-5)


def test_burgers_trajectory_matches_jax():
    """nx 128, 11 frames x 40 substeps from JAX's u0; the port conserves the
    mean and dissipates energy (the JAX test's physics)."""
    u0 = JB.random_sine_ic(jax.random.PRNGKey(2), 2, 128)
    want = JB.simulate_burgers(u0, nu=0.01, t_final=0.5, nx=128, n_frames=11,
                               substeps_per_frame=40)
    got = TB.simulate_burgers(_t(u0), 0.01, 0.5, 128, 11, 40)
    assert tuple(got.shape) == want.shape == (2, 11, 128) and got.dtype == torch.float32
    assert _rel(got, want) <= TOL
    means = got.mean(dim=2).numpy()
    np.testing.assert_allclose(means, np.broadcast_to(means[:, :1], means.shape), atol=1e-5)
    assert np.all(np.diff((got**2).sum(dim=2).numpy(), axis=1) <= 1e-6)
    assert TB.burgers_substeps(1024, 201, 2.0) == 26  # JAX's ceil(dt_frame / (cfl dx))


@pytest.mark.parametrize("lite", [False, True])
def test_burgers_file_schema(tmp_path, monkeypatch, lite):
    if lite:
        monkeypatch.setattr(h5io, "h5py_module", lambda: hdf5_lite)
    kw = dict(n_samples=3, nx=64, n_frames=5, t_final=0.2, seed=1, batch=2)
    TB.main(["--out", str(tmp_path / "t.h5"), "--nsample", "3", "--xdim", "64", "--tdim", "5",
             "--t", "0.2", "--seed", "1", "--batch", "2", "--device", "cpu"])
    JB.generate_burgers_file(tmp_path / "j.h5", **kw)
    with h5py.File(tmp_path / "t.h5") as f, h5py.File(tmp_path / "j.h5") as g:
        assert sorted(f.keys()) == sorted(g.keys()) and dict(f.attrs) == dict(g.attrs)
        for k in g:
            assert (f[k].shape, f[k].dtype) == (g[k].shape, g[k].dtype), k
            assert (f[k].chunks, f[k].compression) == (g[k].chunks, g[k].compression), k
        np.testing.assert_array_equal(f["x-coordinate"][:], g["x-coordinate"][:])
        np.testing.assert_array_equal(f["t-coordinate"][:], g["t-coordinate"][:])
        u = f["tensor"][:]
    assert u.shape == (3, 5, 64) and np.isfinite(u).all()
    # each batch from its own draws, the second batch's one sample too
    np.testing.assert_allclose(np.abs(u[:, 0]).max(axis=1), 1.0, rtol=1e-5)
    assert not np.allclose(u[0], u[2])


# ------------------------------------------------------------------ Darcy


@pytest.fixture(scope="module")
def coeff():
    """JAX's coefficient fields: a batch of 3 at 32^2."""
    return np.asarray(JD.sample_coefficient(jax.random.PRNGKey(3), 3, 32, 32))


def test_darcy_coefficient_matches_jax_draws():
    key = jax.random.PRNGKey(0)
    want = np.asarray(JD.sample_coefficient(key, 2, 32, 32, hi=12.0, lo=3.0))
    keys = jax.random.split(key, 2)
    from sciml_pde_torch.sim.grf import rbf_filter

    g = torch.stack([rbf_filter(_t(jax.random.normal(k, (32, 32))),
                                _t(jax.random.normal(jax.random.split(k)[0], (32, 32))), 0.1)
                     for k in keys])
    np.testing.assert_array_equal(TD.threshold_coefficient(g, 12.0, 3.0).numpy(), want)
    fresh = TD.sample_coefficient(torch.Generator().manual_seed(0), 2, 16, 16, device="cpu")
    assert set(np.unique(fresh.numpy())) == {3.0, 12.0}


def test_darcy_operator_matches_jax(coeff):
    u = np.random.default_rng(0).normal(size=coeff.shape).astype(np.float32)
    mj, dj = JD.darcy_operator(jnp.asarray(coeff), 1.0 / 32)
    mt, dt = TD.darcy_operator(_t(coeff), 1.0 / 32)
    assert _rel(dt, dj) <= 1e-6 and _rel(mt(_t(u)), mj(jnp.asarray(u))) <= 1e-6
    for got, want in zip(TD._face_coeffs(_t(coeff), 1.0 / 32), JD._face_coeffs(jnp.asarray(coeff),
                                                                               1.0 / 32)):
        assert _rel(got, want) <= 1e-6


def test_darcy_solution_matches_jax(coeff):
    """The generator's tol 1e-8 and maxiter 4000 on JAX's batch of 3."""
    want = np.asarray(JD.solve_darcy(jnp.asarray(coeff), beta=1.0))
    got = TD.solve_darcy(_t(coeff), beta=1.0)
    assert _rel(got, want) <= TOL_DARCY
    matvec, diag = TD.darcy_operator(_t(coeff), 1.0 / 32)
    assert TD.cg_jacobi(matvec, torch.ones(coeff.shape), diag, 1e-8, 4000)[1] < 4000
    res = (matvec(got) - 1.0).norm() / np.sqrt(got.numel())
    assert float(res) < 1e-3 and float(got.min()) >= 0.0


def test_darcy_cg_stops_at_jax_iteration(coeff):
    """At tol 1e-3 the batch-coupled CG stops before maxiter: the port's
    count k is JAX's (JAX's solution with maxiter k equals its own with
    4000, with k - 1 it does not), and the solutions agree."""
    tol = 1e-3
    matvec, diag = TD.darcy_operator(_t(coeff), 1.0 / 32)
    got, k = TD.cg_jacobi(matvec, torch.ones(coeff.shape), diag, tol, 4000)
    assert 0 < k < 4000
    a = jnp.asarray(coeff)
    want = np.asarray(JD.solve_darcy(a, beta=1.0, tol=tol, maxiter=4000))
    np.testing.assert_array_equal(np.asarray(JD.solve_darcy(a, beta=1.0, tol=tol, maxiter=k)),
                                  want)
    assert not np.array_equal(np.asarray(JD.solve_darcy(a, beta=1.0, tol=tol, maxiter=k - 1)),
                              want)
    assert _rel(got, want) <= TOL_DARCY
    # coupled: the first sample alone stops at another iteration
    m1, d1 = TD.darcy_operator(_t(coeff[:1]), 1.0 / 32)
    assert TD.cg_jacobi(m1, torch.ones(1, 32, 32), d1, tol, 4000)[1] != k


@pytest.mark.parametrize("lite", [False, True])
def test_darcy_file_schema(tmp_path, monkeypatch, lite):
    if lite:
        monkeypatch.setattr(h5io, "h5py_module", lambda: hdf5_lite)
    kw = dict(n_samples=3, nx=16, seed=2, batch=2)
    TD.main(["--out", str(tmp_path / "t.h5"), "--nsample", "3", "--xdim", "16", "--seed", "2",
             "--batch", "2", "--device", "cpu"])
    JD.generate_darcy_file(tmp_path / "j.h5", **kw)
    with h5py.File(tmp_path / "t.h5") as f, h5py.File(tmp_path / "j.h5") as g:
        assert sorted(f.keys()) == sorted(g.keys()) and dict(f.attrs) == dict(g.attrs)
        for k in g:
            assert (f[k].shape, f[k].dtype) == (g[k].shape, g[k].dtype), k
            assert (f[k].chunks, f[k].compression) == (g[k].chunks, g[k].compression), k
        np.testing.assert_array_equal(f["x-coordinate"][:], g["x-coordinate"][:])
    a, u = TD.load_pdebench_darcy(tmp_path / "t.h5")
    aj, uj = JD.load_pdebench_darcy(tmp_path / "t.h5")
    np.testing.assert_array_equal(a, aj)
    np.testing.assert_array_equal(u, uj)
    assert a.shape == u.shape == (3, 16, 16) and set(np.unique(a)) <= {3.0, 12.0}
    # each sample solves -div(a grad u) = 1 on its own coefficient
    for i in range(3):
        matvec, _ = TD.darcy_operator(_t(a[i:i + 1]), 1.0 / 16)
        assert float((matvec(_t(u[i:i + 1])) - 1.0).abs().max()) < 1e-2
    if lite:  # h5py's compressed file reads through the subset too
        for got, want in zip(TD.load_pdebench_darcy(tmp_path / "j.h5"),
                             JD.load_pdebench_darcy(tmp_path / "j.h5")):
            np.testing.assert_array_equal(got, want)
