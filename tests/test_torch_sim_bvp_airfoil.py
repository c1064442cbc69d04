"""Port of the BVP and airfoil generators (``sim/bvp_2d.py``,
``sim/airfoil_2d.py``) vs the JAX package's on the CPU.

Both draw from ``np.random.default_rng(seed)`` in the same order as JAX, so
the numpy-drawn parts are equal: every ``data_x`` column of a BVP case but
the source density (col 2, from the same numpy arrays: equal too), the
airfoil's nodes, node types, cells and meta.  The solves differ only in
f32 rounding.  Bounds: the BVP solve's columns (``data_y``) 1e-5 of each
column's largest magnitude (real FFTs in another order; readings 1e-6);
one airfoil step 1e-5 of each field's largest magnitude (readings 1e-6);
the TINY airfoil trajectory of the JAX test (``tests/test_airfoil.py``: 64^2,
24 settle steps, 3 frames 5 steps apart) 1e-4 (``TOL_TRAJ``: f32 rounding
through 34 steps whose minmod branches can flip on one ulp; readings
8.5e-6 on v).  The airfoil's inside mask, matplotlib's
``Path.contains_points`` in JAX, is the port's own even-odd test: equal to
matplotlib's on every point of the default 384^2 grid and on the
rejection-sampling candidates of several sampled shapes.
"""

import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from matplotlib.path import Path as MplPath

from sciml_pde_tpu.sim import airfoil_2d as JA
from sciml_pde_tpu.sim import bvp_2d as JV
from sciml_pde_torch.sim import airfoil_2d as TA
from sciml_pde_torch.sim import bvp_2d as TV

TOL, TOL_TRAJ = 1e-5, 1e-4
TINY = dict(nx=64, ny=64, n_frames=3, frame_dt=4.0e-4, settle_time=2.0e-3, sponge_width=0.8)


def _rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# -------------------------------------------------------------------- BVP


def test_poisson_dirichlet_matches_jax():
    rho = np.random.default_rng(0).normal(size=(32, 32)).astype(np.float32)
    dx = 1.0 / 33
    got = TV.poisson_dirichlet(torch.from_numpy(rho), dx)
    assert _rel(got, JV.poisson_dirichlet(jnp.asarray(rho), dx)) <= TOL
    assert _rel(TV._dst1(torch.from_numpy(rho), -2), JV._dst1(jnp.asarray(rho), -2)) <= TOL
    # it inverts the 5-point Laplacian with zero Dirichlet walls
    pp = np.pad(got.numpy(), 1)
    lap = (pp[2:, 1:-1] + pp[:-2, 1:-1] + pp[1:-1, 2:] + pp[1:-1, :-2] - 4 * pp[1:-1, 1:-1]) / dx**2
    np.testing.assert_allclose(lap, -rho, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("kind", ["electro", "magneto"])
def test_generate_case_matches_jax(kind):
    kw = dict(kind=kind, grid=64, min_points=100, max_points=160)
    for seed in (3, 4):
        want = JV.generate_case(seed, JV.BVPConfig(**kw))
        got = TV.generate_case(seed, TV.BVPConfig(**kw), device="cpu")
        assert got["data_x"].dtype == got["data_y"].dtype == np.float32
        np.testing.assert_array_equal(got["data_x"], want["data_x"])
        assert got["data_y"].shape == want["data_y"].shape
        for c in range(3):
            assert _rel(got["data_y"][:, c], want["data_y"][:, c]) <= TOL, (seed, c)
        bnd = got["data_x"][:, 3] == 1.0
        np.testing.assert_array_equal(got["data_y"][bnd, 0], 0.0)


def test_pointset_pickle_and_load_match_jax(tmp_path):
    cfg = dict(grid=32, min_points=50, max_points=80)
    cases = TV.generate_dataset(tmp_path / "t.pkl", 3, TV.BVPConfig(**cfg), seed0=7, device="cpu")
    JV.generate_dataset(tmp_path / "j.pkl", 3, JV.BVPConfig(**cfg), seed0=7)
    # the CLI: its defaults' point counts, magneto
    TV.main(["--out", str(tmp_path / "m.pkl"), "--kind", "magneto", "--n-cases", "2", "--grid",
             "32", "--seed-start", "3", "--device", "cpu"])
    JV.main(["--out", str(tmp_path / "mj.pkl"), "--kind", "magneto", "--n-cases", "2", "--grid",
             "32", "--seed-start", "3"])
    cli, cli_j = TV.load_pointset(tmp_path / "m.pkl"), JV.load_pointset(tmp_path / "mj.pkl")
    np.testing.assert_array_equal(cli["features"], cli_j["features"])
    assert _rel(cli["field"], cli_j["field"]) <= TOL
    with (tmp_path / "t.pkl").open("rb") as f:
        saved = pickle.load(f)
    assert [sorted(c) for c in saved] == [["data_x", "data_y"]] * 3
    assert all(np.array_equal(a["data_x"], b["data_x"]) for a, b in zip(saved, cases))
    got, want = TV.load_pointset(tmp_path / "t.pkl"), JV.load_pointset(tmp_path / "j.pkl")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if k in ("scalar", "field"):
            assert _rel(got[k], want[k]) <= TOL, k
        else:
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(TV.load_pointset(tmp_path / "j.pkl")["features"],
                                  want["features"])


# ---------------------------------------------------------------- airfoil


def test_contains_points_matches_matplotlib():
    """The default 384^2 grid of ``simulate`` and ``sample_nodes``'
    rejection-sampling candidates, for the default shape and sampled ones."""
    cfg = TA.AirfoilConfig()
    xs = np.linspace(-cfg.extent + cfg.dx / 2, cfg.extent - cfg.dx / 2, cfg.nx)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    grid = np.stack([X.ravel(), Y.ravel()], 1)
    rng = np.random.default_rng(0)
    shapes = [(cfg.camber, cfg.camber_pos, cfg.thickness, cfg.aoa_deg)] + [
        (rng.uniform(0.0, 0.045), rng.uniform(0.3, 0.5), rng.uniform(0.09, 0.16),
         rng.uniform(-10.0, 10.0)) for _ in range(3)]
    lim = cfg.extent - cfg.sponge_width
    for i, (m, p, t, aoa) in enumerate(shapes):
        poly = TA.place_airfoil(TA.naca4_polyline(m, p, t), aoa)
        # candidates as sample_nodes draws them, and points on the polygon
        cand = rng.uniform(-lim, lim, size=(1200 * 12, 2))
        pts = [cand, poly, 0.5 * (poly + np.roll(poly, -1, 0))] + ([grid] if i < 2 else [])
        for q in pts:
            np.testing.assert_array_equal(TA.contains_points(poly, q),
                                          MplPath(poly).contains_points(q))
    inside, dist = TA.airfoil_mask_and_distance(poly, cand[:500])
    want_in, want_d = JA.airfoil_mask_and_distance(poly, cand[:500])
    np.testing.assert_array_equal(inside, want_in)
    np.testing.assert_array_equal(dist, want_d)


def test_geometry_and_nodes_match_jax():
    for seed in range(2):
        cfg = dataclasses.replace(TA.AirfoilConfig(**TINY), aoa_deg=-7.0 + 5 * seed,
                                  camber=0.015 * seed)
        jcfg = JA.AirfoilConfig(**dataclasses.asdict(cfg))
        got = TA.sample_nodes(cfg, np.random.default_rng(seed))
        want = JA.sample_nodes(jcfg, np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(TA.naca4_polyline(0.02, 0.4, 0.12),
                                  JA.naca4_polyline(0.02, 0.4, 0.12))
    np.testing.assert_array_equal(TA.freestream_state(cfg), JA.freestream_state(jcfg))


@pytest.fixture(scope="module")
def tiny_fields():
    cfg = TA.AirfoilConfig(**TINY)
    _, _, chi, sponge = TA.setup(cfg)
    return cfg, chi, sponge


def test_make_step_matches_jax(tiny_fields):
    """One SSP-RK2 step from a perturbed free stream, each conservative
    field within TOL of its largest magnitude; free stream without a body is
    kept (the JAX test's steady state)."""
    cfg, chi, sponge = tiny_fields
    jcfg = JA.AirfoilConfig(**TINY)
    u_inf = TA.freestream_state(cfg)
    rng = np.random.default_rng(0)
    U = (u_inf[:, None, None] * (1 + 0.05 * rng.standard_normal((4, 64, 64)))).astype(np.float32)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    got = TA.make_step(cfg, f32(chi), f32(sponge), f32(u_inf))(f32(U)).numpy()
    want = np.asarray(JA.make_step(jcfg, jnp.asarray(chi, jnp.float32),
                                   jnp.asarray(sponge, jnp.float32), jnp.asarray(u_inf))(
        jnp.asarray(U)))
    for c in range(4):
        assert _rel(got[c], want[c]) <= TOL, c
    zero = torch.zeros(64, 64)
    step = TA.make_step(cfg, zero, zero, f32(u_inf))
    U0 = f32(u_inf)[:, None, None].expand(4, 64, 64).contiguous()
    U5 = U0
    for _ in range(5):
        U5 = step(U5)
    assert float(((U5 - U0).abs() / (U0.abs() + 1.0)).max()) < 1e-5
    for a, b in ((TA._minmod(f32(U[0]), f32(U[1])), JA._minmod(jnp.asarray(U[0]),
                                                              jnp.asarray(U[1]))),):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tiny_trajectory_matches_jax():
    frames_j, chi_j, grid_j = JA.simulate(JA.AirfoilConfig(**TINY))
    frames, chi, grid = TA.simulate(TA.AirfoilConfig(**TINY), device="cpu")
    np.testing.assert_array_equal(chi, chi_j)
    np.testing.assert_array_equal(grid, grid_j)
    assert frames.shape == frames_j.shape == (3, 4, 64, 64)
    for c in range(4):
        assert _rel(frames[:, c], frames_j[:, c]) <= TOL_TRAJ, c
    cfg = TA.AirfoilConfig(**TINY)
    assert (cfg.settle_steps, cfg.frame_steps) == (24, 5)
    # the JAX test's physics: the body stagnates, the far field keeps v_inf
    speed = np.sqrt(frames[-1, 1] ** 2 + frames[-1, 2] ** 2)
    assert speed[chi > 0.9].mean() < 0.2 * cfg.v_inf
    far = (chi <= 0.9) & (np.abs(grid[..., 0]) > 3.0)
    assert abs(speed[far].mean() - cfg.v_inf) < 0.3 * cfg.v_inf
    pos, _ = TA.sample_nodes(cfg, np.random.default_rng(1))
    got = TA.interpolate_frames(frames, pos, cfg, device="cpu")
    want = JA.interpolate_frames(frames, pos, JA.AirfoilConfig(**TINY))
    assert got.shape == want.shape == (3, len(pos), 4)
    for c in range(4):
        assert _rel(got[..., c], want[..., c]) <= 1e-6, c


def test_dataset_files_match_jax_schema(tmp_path):
    """The npz keys, shapes and dtypes of a sample and the statistics file,
    as JAX writes them; both loaders read the port's files alike."""
    (tmp_path / "t").mkdir()
    TA.generate_dataset(str(tmp_path / "t"), [0, 1], TA.AirfoilConfig(**TINY), verbose=False,
                        device="cpu")
    JA.generate_dataset(str(tmp_path / "j"), [0], JA.AirfoilConfig(**TINY), verbose=False)
    t0, j0 = np.load(tmp_path / "t" / "airfoil_0000.npz"), np.load(tmp_path / "j" /
                                                                  "airfoil_0000.npz")
    assert sorted(t0.files) == sorted(j0.files)
    for k in j0.files:
        assert (t0[k].shape, t0[k].dtype) == (j0[k].shape, j0[k].dtype), k
        if k in ("pos", "node_type", "cells", "meta"):
            np.testing.assert_array_equal(t0[k], j0[k])
        else:
            assert _rel(t0[k], j0[k]) <= TOL_TRAJ, k
    ts = np.load(tmp_path / "t" / "af_train_data_statistics.npz")
    js = np.load(tmp_path / "j" / "af_train_data_statistics.npz")
    assert sorted(ts.files) == sorted(js.files)
    assert all(ts[k].shape == js[k].shape == () for k in js.files)
    got = TA.load_airfoil_dataset(str(tmp_path / "t"))
    want = JA.load_airfoil_dataset(str(tmp_path / "t"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["fields"].shape[:2] == (2, 3) and got["fields"].shape[3] == 4
