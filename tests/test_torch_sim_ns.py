"""Port of the NS-2D data generators (``sim/grf.py``, ``sim/ns_incomp_2d.py``,
``sim/gen_ns_incomp.py``, ``sim/vorticity.py``, ``sim/velocity2vorticity.py``)
vs the JAX package's on the CPU at 16^2-24^2.

JAX draws its noise from its own PRNG, which the port does not reproduce:
the filters are fed JAX's normals, and the simulation starts from JAX's
``init_state``.  Bounds, of the largest magnitude: 1e-5 for each function,
1e-4 for ``simulate_ns_frames`` over 10 momentum steps (f32 sums in another
order through the pressure solve, compounding; the semi-Lagrangian
backtrace takes JAX's formula term for term, so no position lands in a
neighbouring cell: ``test_backtrace_floors_agree`` checks every floor).
Port-written NS files load through both packages' loaders to the same
arrays, from h5py and from the port's own HDF5 subset.
"""

import dataclasses
import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.data import ns as jns
from sciml_pde_tpu.sim import gen_ns_incomp as jgen
from sciml_pde_tpu.sim import grf as jgrf
from sciml_pde_tpu.sim import ns_incomp_2d as J
from sciml_pde_tpu.sim import velocity2vorticity as jv2v
from sciml_pde_tpu.sim import vorticity as jvort
from sciml_pde_torch.data import ns as tns
from sciml_pde_torch.io import h5 as h5io
from sciml_pde_torch.io import hdf5_lite
from sciml_pde_torch.sim import gen_ns_incomp as tgen
from sciml_pde_torch.sim import grf as tgrf
from sciml_pde_torch.sim import ns_incomp_2d as T
from sciml_pde_torch.sim import velocity2vorticity as tv2v
from sciml_pde_torch.sim import vorticity as tvort

TOL, TOL_SIM = 1e-5, 1e-4
SMALL = dict(grid_size=(24, 24), dt=1e-3, n_steps=11, frame_int=1, n_batch=2, nu=0.01,
             cg_tol=1e-5, cg_max_iter=500)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def state():
    """JAX's initial state of one trajectory at SMALL."""
    return tuple(np.asarray(a) for a in J.init_state(jax.random.PRNGKey(1),
                                                     J.NSIncompConfig(**SMALL)))


def test_spectral_noise_filter_matches_jax():
    key = jax.random.PRNGKey(3)
    shape = (2, 17, 16)
    kr, ki = jax.random.split(key)
    want = jgrf.spectral_noise(key, shape, 0.15, 3.0)
    got = tgrf.spectral_filter(_t(jax.random.normal(kr, shape)), _t(jax.random.normal(ki, shape)),
                               0.15, 3.0)
    assert got.shape == shape and _rel(got, want) <= TOL
    fresh = tgrf.spectral_noise(torch.Generator().manual_seed(0), shape, 0.4, 1.0, device="cpu")
    assert fresh.shape == shape
    np.testing.assert_allclose(fresh.std(dim=(-2, -1), correction=0).numpy(), 0.4, rtol=1e-5)


def test_grf_rbf_filter_matches_jax():
    key = jax.random.PRNGKey(4)
    want = jgrf.grf_rbf(key, (16, 20), 0.1)
    wr = jax.random.normal(key, (16, 20))
    wi = jax.random.normal(jax.random.split(key)[0], (16, 20))
    assert _rel(tgrf.rbf_filter(_t(wr), _t(wi), 0.1), want) <= TOL
    assert tgrf.grf_rbf(torch.Generator().manual_seed(0), (16, 20), device="cpu").shape == (16, 20)


@pytest.mark.parametrize("zero_outside", [True, False])
def test_bilinear_matches_jax(zero_outside):
    rng = np.random.default_rng(0)
    field = rng.normal(size=(9, 11)).astype(np.float32)
    x = rng.uniform(-2, 11, size=(7, 5)).astype(np.float32)
    y = rng.uniform(-2, 13, size=(7, 5)).astype(np.float32)
    want = J.bilinear(jnp.asarray(field), jnp.asarray(x), jnp.asarray(y), zero_outside)
    got = T.bilinear(_t(field), _t(x), _t(y), zero_outside)
    assert _rel(got, want) <= TOL
    # batched field, broadcast positions: each trajectory as JAX's vmap
    fb = rng.normal(size=(3, 9, 11)).astype(np.float32)
    got_b = T.bilinear(_t(fb), _t(x[:, :1]), _t(y[:1, :]), zero_outside)
    for i in range(3):
        w = J.bilinear(jnp.asarray(fb[i]), jnp.asarray(x[:, :1]), jnp.asarray(y[:1, :]),
                       zero_outside)
        assert _rel(got_b[i], w) <= TOL


def test_advection_matches_jax(state):
    u, v, c, _, _ = state
    cfg = J.NSIncompConfig(**SMALL)
    dt_cells = (0.3 * cfg.dt / cfg.dx * 50, 0.3 * cfg.dt / cfg.dy * 50)
    wu, wv = J.advect_staggered(jnp.asarray(u), jnp.asarray(v), dt_cells)
    gu, gv = T.advect_staggered(_t(u), _t(v), dt_cells)
    assert _rel(gu, wu) <= TOL and _rel(gv, wv) <= TOL
    want = J.advect_centered(jnp.asarray(c), jnp.asarray(u), jnp.asarray(v), dt_cells)
    assert _rel(T.advect_centered(_t(c), _t(u), _t(v), dt_cells), want) <= TOL


def test_backtrace_floors_agree(state):
    """The backtraced positions' floors, where bilinear picks its cell, are
    the same in both packages at every point of the three advections."""
    u, v, _, _, _ = state
    nx, ny = 24, 24
    dtu = dtv = 1e-3 * 24 * 50
    for pos_j, pos_t in ((J._u_positions, T._u_positions), (J._v_positions, T._v_positions),
                         (J._c_positions, T._c_positions)):
        xj, yj = pos_j(nx, ny)
        uu, uv = J.velocity_at(jnp.asarray(u), jnp.asarray(v), xj, yj)
        xt, yt = pos_t(nx, ny)
        tu, tv = T.velocity_at(_t(u), _t(v), xt, yt)
        bxj, byj = np.asarray(xj - dtu * uu), np.asarray(yj - dtv * uv)
        bxt, byt = (xt - dtu * tu).numpy(), (yt - dtv * tv).numpy()
        for a, b in ((bxj, bxt), (byj, byt), (bxj - 0.5, bxt - 0.5), (byj - 0.5, byt - 0.5)):
            flips = np.argwhere(np.floor(a) != np.floor(b))
            assert len(flips) == 0, f"floor flips at {flips[:5].tolist()}: {a[tuple(flips[0])]}"


@pytest.mark.parametrize("mode", ["explicit", "exact"])
def test_diffusion_matches_jax(state, mode):
    u, v, _, _, _ = state
    sx, sy = 0.2, 0.15
    fu, fv = {"explicit": (J.diffuse_explicit_u, J.diffuse_explicit_v),
              "exact": (J.diffuse_exact_u, J.diffuse_exact_v)}[mode]
    gu_fn, gv_fn = {"explicit": (T.diffuse_explicit_u, T.diffuse_explicit_v),
                    "exact": (T.diffuse_exact_u, T.diffuse_exact_v)}[mode]
    assert _rel(gu_fn(_t(u), sx, sy), fu(jnp.asarray(u), sx, sy)) <= TOL
    assert _rel(gv_fn(_t(v), sx, sy), fv(jnp.asarray(v), sx, sy)) <= TOL


def test_pressure_solvers_and_projection_match_jax(state):
    u, v, _, _, _ = state
    cfg = J.NSIncompConfig(**SMALL)
    div = J.divergence(jnp.asarray(u), jnp.asarray(v), cfg.dx, cfg.dy)
    tdiv = T.divergence(_t(u), _t(v), cfg.dx, cfg.dy)
    assert _rel(tdiv, div) <= TOL
    assert _rel(T.solve_pressure_dct(tdiv, cfg.dx, cfg.dy),
                J.solve_pressure_dct(div, cfg.dx, cfg.dy)) <= TOL
    assert _rel(T.solve_pressure_cg(tdiv, cfg.dx, cfg.dy, 1e-5, 500),
                J.solve_pressure_cg(div, cfg.dx, cfg.dy, 1e-5, 500)) <= TOL
    for method in ("dct", "cg"):
        wu, wv = J.project(jnp.asarray(u), jnp.asarray(v), cfg.dx, cfg.dy, 1e-5, 500, method)
        gu, gv = T.project(_t(u), _t(v), cfg.dx, cfg.dy, 1e-5, 500, method)
        # of the input's largest magnitude: the projection subtracts the
        # pressure gradient from velocities about twice its output's size,
        # and CG's pressures (within 8e-7 of JAX's) come out of that
        # difference at up to 1.3e-5 of the output's (JAX's own CG lies as
        # far from the exact DCT solve)
        for got, want, inp in ((gu, wu, u), (gv, wv, v)):
            err = np.abs(got.numpy() - np.asarray(want)).max() / np.abs(inp).max()
            assert err <= TOL, (method, err)
        if method == "dct":
            assert _rel(gu, wu) <= TOL and _rel(gv, wv) <= TOL
        div1 = float(T.divergence(gu, gv, cfg.dx, cfg.dy).abs().max())
        assert div1 < max(1e-4 * float(tdiv.abs().max()), 1e-4), (method, div1)


def test_projection_at_the_production_grid():
    """At 256^2 (NSIncompConfig's grid) the f32 solve leaves more than the
    24^2 test's max(1e-4 x before, 1e-4): from JAX's PRNGKey(1) state the
    MAC divergence goes 90.0 -> 2.68e-2 under DCT, in both packages.  Both
    are held to 1e-3 x the divergence before, the bound chip_smoke.py's
    phase 18e holds the card to at this grid under either solver, and the
    projections agree within 1e-5.  (CG at this grid, a host loop of up to
    2000 iterations, is held on the card only: on a CPU shared by the
    tier's workers it takes minutes.)"""
    cfg = J.NSIncompConfig()
    u, v, _, _, _ = (np.asarray(a) for a in J.init_state(jax.random.PRNGKey(1), cfg))
    div0 = float(jnp.abs(J.divergence(jnp.asarray(u), jnp.asarray(v), cfg.dx, cfg.dy)).max())
    wu, wv = J.project(jnp.asarray(u), jnp.asarray(v), cfg.dx, cfg.dy, 1e-5, 2000, "dct")
    gu, gv = T.project(_t(u), _t(v), cfg.dx, cfg.dy, 1e-5, 2000, "dct")
    want = float(jnp.abs(J.divergence(wu, wv, cfg.dx, cfg.dy)).max())
    got = float(T.divergence(gu, gv, cfg.dx, cfg.dy).abs().max())
    assert want <= 1e-3 * div0 and got <= 1e-3 * div0, (div0, want, got)
    assert _rel(gu, wu) <= TOL and _rel(gv, wv) <= TOL


def test_cg_keeps_each_trajectorys_stop(state):
    """Batched CG: each trajectory stops by its own rule, as JAX's vmapped
    while_loop does: a batch of two different right-hand sides and a tight
    iteration cap agree with one solve each."""
    cfg = J.NSIncompConfig(**SMALL)
    rng = np.random.default_rng(5)
    divs = rng.normal(size=(2, 24, 24)).astype(np.float32)
    divs[1] *= 1e-3
    for max_iter in (7, 500):
        got = T.solve_pressure_cg(_t(divs), cfg.dx, cfg.dy, 1e-3, max_iter)
        for i in range(2):
            want = J.solve_pressure_cg(jnp.asarray(divs[i]), cfg.dx, cfg.dy, 1e-3, max_iter)
            assert _rel(got[i], want) <= TOL, (max_iter, i)


def test_full_f32_restores_the_callers_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with T.full_f32():
            assert torch.get_float32_matmul_precision() == "highest"
        T.solve_pressure_dct(torch.ones(8, 8), 0.1, 0.1)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("solver,mode,variant", [
    ("dct", "explicit", {}), ("cg", "exact", {}), ("dct", "explicit", {"enable_diffusion": False,
                                                                       "enable_force": False}),
])
def test_simulate_ns_frames_matches_jax(state, solver, mode, variant):
    """10 momentum steps (10 stored frames) from JAX's initial state."""
    kw = dict(SMALL, pressure_solver=solver, diffusion_mode=mode, cg_tol=1e-3, **variant)
    vj, pj = J.simulate_ns_frames(tuple(jnp.asarray(a) for a in state), J.NSIncompConfig(**kw))
    vt, pt = T.simulate_ns_frames(tuple(_t(a) for a in state), T.NSIncompConfig(**kw))
    assert tuple(vt.shape) == vj.shape == (11, 24, 24, 2) and tuple(pt.shape) == pj.shape
    assert _rel(vt, vj) <= TOL_SIM and _rel(pt, pj) <= TOL_SIM


def test_momentum_step_batched_is_per_trajectory(state):
    """A batch of two states steps as each alone (JAX vmaps the step)."""
    cfg = T.NSIncompConfig(**dict(SMALL, pressure_solver="cg"))
    s2 = [np.stack([a, a[::-1] if a.ndim == 2 else a]) for a in state]
    s2[0][1] = s2[0][1] * 0.5
    got = T.momentum_step(*(_t(a) for a in s2), cfg)
    for i in range(2):
        one = T.momentum_step(*(_t(a[i]) for a in s2), cfg)
        for g, o in zip(got, one):
            assert _rel(g[i], o) <= TOL


@pytest.mark.parametrize("chunk", [0, 2])
def test_simulate_ns_batch_shapes(chunk):
    cfg = T.NSIncompConfig(**dict(SMALL, n_steps=7, frame_int=2))
    vel, par, force, ts = T.simulate_ns_batch(0, cfg, frames_per_chunk=chunk, device="cpu")
    assert vel.shape == (2, 4, 24, 24, 2) and par.shape == (2, 4, 24, 24, 1)
    assert force.shape == (2, 24, 24, 2) and ts.shape == (2, 4)
    assert np.isfinite(vel).all() and np.abs(vel).max() < 100
    assert not np.allclose(vel[0, 0], vel[1, 0]) and not np.allclose(vel[0, 0], vel[0, -1])
    ref = T.simulate_ns_batch(0, cfg, device="cpu")
    np.testing.assert_array_equal(vel, ref[0])


@pytest.mark.parametrize("lite", [False, True])
@pytest.mark.parametrize("chunk", [0, 2])
def test_ns_file_loads_identically(tmp_path, monkeypatch, lite, chunk):
    """generate_ns_file's schema (datasets, chunks, filters, attributes) as
    JAX's write_ns_h5 writes it; both packages' loaders read the file to
    the same arrays."""
    if lite:
        monkeypatch.setattr(h5io, "h5py_module", lambda: hdf5_lite)
    cfg = T.NSIncompConfig(**dict(SMALL, n_steps=7, frame_int=2))
    for i in (0, 1, 250):
        tgen.generate_ns_file(tmp_path / f"ns_incom_inhom_2d_256-{i}.h5", i, cfg,
                              frames_per_chunk=chunk, device="cpu")
    # JAX's writer on the same arrays
    vel, par, force, ts = T.simulate_ns_batch(0, cfg, device="cpu")
    jgen.write_ns_h5(tmp_path / "j.h5", vel, par, force, ts, dataclasses.asdict(cfg))
    with h5py.File(tmp_path / "ns_incom_inhom_2d_256-0.h5") as f, \
            h5py.File(tmp_path / "j.h5") as g:
        assert sorted(f.keys()) == sorted(g.keys())
        assert dict(f.attrs) == dict(g.attrs)
        assert json.loads(f.attrs["config"])["grid_size"] == [24, 24]
        for k in g:
            np.testing.assert_array_equal(f[k][:], g[k][:])
            want = [g[k].chunks, g[k].compression, g[k].shuffle, g[k].dtype]
            # JAX's streaming path chunks the force by trajectory (1, X, Y, 2)
            # and writes t without the shuffle filter
            if chunk and k == "force":
                want[0] = (1, 24, 24, 2)
            if chunk and k == "t":
                want[2] = False
            assert [f[k].chunks, f[k].compression, f[k].shuffle, f[k].dtype] == want, k
    if lite:  # the subset reads its own file and JAX's as h5py does
        for path in (tmp_path / "ns_incom_inhom_2d_256-0.h5", tmp_path / "j.h5"):
            with hdf5_lite.File(path) as f, h5py.File(path) as g:
                assert sorted(f.keys()) == sorted(g.keys()) and dict(f.attrs) == dict(g.attrs)
                for k in g:
                    np.testing.assert_array_equal(np.asarray(f[k]), g[k][:])
                    assert [f[k].chunks, f[k].compression, f[k].shuffle] == \
                        [g[k].chunks, g[k].compression, g[k].shuffle], k
    got = tns.load_ns_baseline(str(tmp_path), train_subsample=2, initial_step=2,
                               rollout_test=1, test_range=(250, 251), device="cpu")
    want = jns.load_ns_baseline(str(tmp_path), train_subsample=2, initial_step=2,
                                rollout_test=1, test_range=(250, 251))
    for split in ("train", "test"):
        g, w = getattr(got, split), getattr(want, split)
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.grid.numpy(), np.asarray(w.grid))


def test_vorticity_matches_jax():
    vel = np.random.default_rng(2).normal(size=(2, 8, 6, 4, 3)).astype(np.float32)
    want = jvort.compute_spectral_vorticity_jnp(jnp.asarray(vel), 1.0, 2.0, 0.5)
    got = tvort.compute_spectral_vorticity_jnp(_t(vel), 1.0, 2.0, 0.5)
    assert _rel(got, want) <= TOL
    assert _rel(tvort.compute_spectral_vorticity_np(vel), jvort.compute_spectral_vorticity_np(vel)) \
        <= TOL


@pytest.mark.parametrize("lite", [False, True])
def test_velocity2vorticity_matches_jax(tmp_path, monkeypatch, lite):
    """A CFD file (Vx, Vy, Vz and coordinates) through both converters."""
    rng = np.random.default_rng(3)
    vel = {k: rng.normal(size=(3, 2, 8, 6, 4)).astype(np.float32) for k in ("Vx", "Vy", "Vz")}
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
        with h5py.File(tmp_path / d / "cfd.h5", "w") as f:
            for k, a in vel.items():
                f.create_dataset(k, data=a)
            for k, n in (("x-coordinate", 8), ("y-coordinate", 6), ("z-coordinate", 4),
                         ("t-coordinate", 2)):
                f.create_dataset(k, data=np.linspace(0, 1, n, endpoint=False).astype(np.float32))
    if lite:
        monkeypatch.setattr(h5io, "h5py_module", lambda: hdf5_lite)
    out_j = jv2v.convert_velocity(tmp_path / "j" / "cfd.h5", batch=2)
    out_t = tv2v.convert_velocity(tmp_path / "t" / "cfd.h5", batch=2, device="cpu")
    assert out_t.name == out_j.name == "cfd_vorticity.h5"
    with h5py.File(out_j) as fj, h5py.File(out_t) as ft:
        assert sorted(fj.keys()) == sorted(ft.keys())
        for k in ("omega_x", "omega_y", "omega_z"):
            assert ft[k].shape == (3, 2, 8, 6, 4) and _rel(ft[k][:], fj[k][:]) <= TOL
