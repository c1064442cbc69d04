"""Port of the 3D plume simulator (``sim/ns_plume_3d.py``) vs the JAX
package's on the CPU, at the JAX test's TINY config ((8, 8, 12), 6 frames x
2 substeps), and the plume loader without h5py (fault C9).

JAX draws the buoyancy jitter from its own PRNG, which the port does not
reproduce: the trajectories start from rest with JAX's jitter.  Bounds, of
the largest magnitude: 1e-5 for each function (``TOL``); 1e-4 for the
6-frame trajectory under either pressure solver (``TOL_SIM``: f32 sums in
another order through the DCT's contractions and CG's dot products,
compounding over 12 substeps; readings were 2e-7 (DCT) and 6e-6 (CG)).  The
backtraces take JAX's formulas term for term, so no position lands in a
neighbouring cell: ``test_backtrace_floors_agree`` checks every floor.
Port-written plume files load through both packages' ``load_ns3d_aux`` to
the same arrays, from h5py and from the port's own HDF5 subset.
"""

import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sciml_pde_tpu.data import ns3d as jns3d
from sciml_pde_tpu.sim import ns_plume_3d as J
from sciml_pde_torch.data import ns3d as tns3d
from sciml_pde_torch.io import h5 as h5io
from sciml_pde_torch.io import hdf5_lite
from sciml_pde_torch.sim import ns_plume_3d as T

TOL, TOL_SIM = 1e-5, 1e-4
TINY = dict(res=(8, 8, 12), dt=1e-3, n_frames=6, substeps=2, cg_tol=1e-3, cg_max_iter=100,
            out_res=(8, 8, 12), out_frames=6)
# the files' config: fewer frames and substeps, so that a file takes a
# fraction of a second on the CPU
FILES = dict(TINY, n_frames=4, substeps=1, out_frames=4)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jitter(key, cfg) -> tuple[float, float]:
    j = np.asarray(jax.random.uniform(key, (2,), minval=-cfg.buoyancy_jitter,
                                      maxval=cfg.buoyancy_jitter))
    return float(j[0]), float(j[1])


@pytest.fixture(scope="module")
def mac():
    """A MAC state at TINY whose backtraces move up to about a cell, some of
    them past the walls: (u, v, w, smoke, pressure) as numpy."""
    rng = np.random.default_rng(0)
    nx, ny, nz = TINY["res"]
    u = rng.normal(scale=60.0, size=(nx + 1, ny, nz))
    v = rng.normal(scale=60.0, size=(nx, ny + 1, nz))
    w = rng.normal(scale=60.0, size=(nx, ny, nz + 1))
    smoke = np.abs(rng.normal(size=(nx, ny, nz)))
    p = rng.normal(size=(nx, ny, nz))
    return tuple(a.astype(np.float32) for a in (u, v, w, smoke, p))


def _dtc(cfg):
    d = tuple(1.0 / n for n in cfg.res)
    return d, tuple(cfg.dt / dd for dd in d)


@pytest.mark.parametrize("zero_outside", [True, False])
def test_trilinear_matches_jax(zero_outside):
    rng = np.random.default_rng(1)
    field = rng.normal(size=(6, 7, 9)).astype(np.float32)
    x, y, z = (rng.uniform(-2, n + 1, size=(5, 4, 3)).astype(np.float32) for n in (6, 7, 9))
    want = J.trilinear(jnp.asarray(field), *map(jnp.asarray, (x, y, z)), zero_outside)
    got = T.trilinear(_t(field), _t(x), _t(y), _t(z), zero_outside)
    assert _rel(got, want) <= TOL
    # positions that broadcast (lattice axes) as the simulator passes them
    xs, ys, zs = (np.arange(n, dtype=np.float32).reshape(s) + 0.25
                  for n, s in ((6, (-1, 1, 1)), (7, (1, -1, 1)), (9, (1, 1, -1))))
    want = J.trilinear(jnp.asarray(field), *jnp.meshgrid(jnp.asarray(xs.ravel()),
                                                         jnp.asarray(ys.ravel()),
                                                         jnp.asarray(zs.ravel()), indexing="ij"),
                       zero_outside)
    assert _rel(T.trilinear(_t(field), _t(xs), _t(ys), _t(zs), zero_outside), want) <= TOL


def test_stencils_and_advection_match_jax(mac):
    u, v, w, smoke, p = mac
    cfg = J.Plume3DConfig(**TINY)
    d, dtc = _dtc(cfg)
    ju, jv, jw, js, jp = map(jnp.asarray, mac)
    tu, tv, tw, ts, tp = map(_t, mac)
    pos = J._positions_c(*cfg.res)
    tpos = T._positions(*cfg.res, None, torch.device("cpu"))
    for g, wnt in zip(T.velocity_at3(tu, tv, tw, *tpos), J.velocity_at3(ju, jv, jw, *pos)):
        assert _rel(g, wnt) <= TOL
    for g, wnt in zip(T.advect_velocity3(tu, tv, tw, dtc), J.advect_velocity3(ju, jv, jw, dtc)):
        assert _rel(g, wnt) <= TOL
    for sign in (1.0, -1.0):
        assert _rel(T._sl_smoke(ts, tu, tv, tw, dtc, sign),
                    J._sl_smoke(js, ju, jv, jw, dtc, sign)) <= TOL
    assert _rel(T.maccormack_smoke(ts, tu, tv, tw, dtc),
                J.maccormack_smoke(js, ju, jv, jw, dtc)) <= TOL
    coef = tuple(0.2 + 0.05 * a for a in range(3))
    for f_t, f_j, ax in ((tu, ju, 0), (tv, jv, 1), (tw, jw, 2)):
        assert _rel(T.diffuse3(f_t, coef, (ax,)), J.diffuse3(f_j, coef, (ax,))) <= TOL
    for g, wnt in zip(T._wall_bc3(tu, tv, tw), J._wall_bc3(ju, jv, jw)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert _rel(T.divergence3(tu, tv, tw, d), J.divergence3(ju, jv, jw, d)) <= TOL
    assert _rel(T._lap_neumann3(tp, d), J._lap_neumann3(jp, d)) <= TOL
    for ax in range(3):
        np.testing.assert_array_equal(T._center_to_face(ts, ax).numpy(),
                                      np.asarray(J._center_to_face(js, ax)))
    np.testing.assert_array_equal(T.inflow_field(T.Plume3DConfig(**TINY)),
                                  J.inflow_field(cfg))


def test_backtrace_floors_agree(mac):
    """The floors of every position the advections sample at (the velocity
    components' own, the backtraced ones of u, v, w and of the smoke's
    forward and backward steps) are the same in both packages."""
    u, v, w, _, _ = mac
    cfg = J.Plume3DConfig(**TINY)
    _, dtc = _dtc(cfg)
    ju, jv, jw = map(jnp.asarray, (u, v, w))
    tu, tv, tw = map(_t, (u, v, w))
    cases = [(J._positions_u, 0, (0.0, 0.5, 0.5), 1.0), (J._positions_v, 1, (0.5, 0.0, 0.5), 1.0),
             (J._positions_w, 2, (0.5, 0.5, 0.0), 1.0), (J._positions_c, None, (0.5,) * 3, 1.0),
             (J._positions_c, None, (0.5,) * 3, -1.0)]
    for pos_j, face, off, sign in cases:
        xj = pos_j(*cfg.res)
        xt = T._positions(*cfg.res, face, torch.device("cpu"))
        vj = J.velocity_at3(ju, jv, jw, *xj)
        vt = T.velocity_at3(tu, tv, tw, *xt)
        for a in range(3):
            bj = np.asarray(xj[a] - sign * dtc[a] * vj[a] - off[a])
            bt = (xt[a] - sign * dtc[a] * vt[a] - off[a]).numpy()
            flips = np.argwhere(np.floor(bj) != np.floor(bt))
            assert len(flips) == 0, (face, sign, a, flips[:5].tolist())
            # the velocity samples' own positions: lattice shifts by 0.5
            for s in (0.0, 0.5):
                pj = np.broadcast_to(np.asarray(xj[a]) - s, bj.shape)
                pt = np.broadcast_to((xt[a] - s).numpy(), bt.shape)
                assert np.array_equal(np.floor(pj), np.floor(pt))


def test_pressure_solvers_and_projection_match_jax(mac):
    _, _, _, _, p = mac
    # walls closed, as the substep hands the velocity to the projection
    u, v, w = (np.asarray(a) for a in J._wall_bc3(*map(jnp.asarray, mac[:3])))
    cfg = J.Plume3DConfig(**TINY)
    d, _ = _dtc(cfg)
    div = J.divergence3(*map(jnp.asarray, (u, v, w)), d)
    tdiv = _t(div)
    assert _rel(T.solve_pressure_dct3(tdiv, d), J.solve_pressure_dct3(div, d)) <= TOL
    for x0 in (None, p):
        want = J.solve_pressure_cg3(div, d, 1e-3, 100, None if x0 is None else jnp.asarray(x0))
        got = T.solve_pressure_cg3(tdiv, d, 1e-3, 100, None if x0 is None else _t(x0))
        assert _rel(got, want) <= TOL
    for method in ("dct", "cg"):
        want = J.project3(*map(jnp.asarray, (u, v, w)), d, 1e-3, 100, jnp.asarray(p), method)
        got = T.project3(*map(_t, (u, v, w)), d, 1e-3, 100, _t(p), method)
        # of the input's largest magnitude: the projection subtracts the
        # pressure gradient from velocities of about its size
        for g, wnt, inp in zip(got, want, (u, v, w, p)):
            err = np.abs(g.numpy() - np.asarray(wnt)).max() / np.abs(inp).max()
            assert err <= TOL, (method, err)
        div1 = float(T.divergence3(*got[:3], d).abs().max())
        bound = 1e-4 if method == "dct" else 2e-2
        assert div1 <= bound * float(tdiv.abs().max()), (method, div1)


@pytest.fixture(scope="module")
def jax_trajectories():
    """JAX's TINY trajectory from PRNGKey(0) under each pressure solver (the
    two programs compiled in two threads)."""
    from concurrent.futures import ThreadPoolExecutor

    def run(solver):
        cfg = J.Plume3DConfig(**TINY, pressure_solver=solver)
        vel, smk = J.simulate_plume(jax.random.PRNGKey(0), cfg)
        return np.asarray(vel), np.asarray(smk), _jitter(jax.random.PRNGKey(0), cfg)

    with ThreadPoolExecutor(2) as ex:
        return dict(zip(("dct", "cg"), ex.map(run, ("dct", "cg"))))


@pytest.mark.parametrize("solver", ["dct", "cg"])
def test_trajectory_matches_jax(jax_trajectories, solver):
    vj, sj, jitter = jax_trajectories[solver]
    vt, st = T.simulate_plume_jitter(jitter, T.Plume3DConfig(**TINY, pressure_solver=solver),
                                     device="cpu")
    assert tuple(vt.shape) == vj.shape == (6, 8, 8, 12, 3) and tuple(st.shape) == sj.shape
    assert _rel(vt, vj) <= TOL_SIM and _rel(st, sj) <= TOL_SIM
    # the JAX test's physics: smoke accumulates and its centre of mass rises
    m0, m1 = st[0].numpy(), st[-1].numpy()
    zc = np.arange(12)
    assert m1.sum() > m0.sum()
    assert (m1.sum((0, 1)) * zc).sum() / m1.sum() > (m0.sum((0, 1)) * zc).sum() / m0.sum()


def test_simulate_plume_draws_its_jitter():
    cfg = T.Plume3DConfig(**FILES)
    jx, jy = T.buoyancy_jitter(torch.Generator().manual_seed(3), cfg)
    assert abs(jx) <= cfg.buoyancy_jitter and abs(jy) <= cfg.buoyancy_jitter and jx != jy
    vel, smk = T.simulate_plume(torch.Generator().manual_seed(3), cfg, device="cpu")
    ref = T.simulate_plume_jitter((jx, jy), cfg, device="cpu")
    assert torch.equal(vel, ref[0]) and torch.equal(smk, ref[1])


def test_resample_outputs_matches_jax():
    import torch.nn.functional as F

    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 7)).astype(np.float32)
    got = T._resize_align_corners_1d(_t(a), 1, 11)
    want = F.interpolate(_t(a)[None], size=11, mode="linear", align_corners=True)[0]
    assert _rel(got, J._resize_align_corners_1d(jnp.asarray(a), 1, 11)) <= 1e-6
    assert _rel(got, want) <= 1e-5
    cfg = J.Plume3DConfig(res=(8, 8, 12), n_frames=7, out_res=(4, 5, 9), out_frames=9)
    vel = rng.normal(size=(7, 8, 8, 12, 3)).astype(np.float32)
    smk = rng.normal(size=(7, 8, 8, 12)).astype(np.float32)
    vj, sj = J.resample_outputs(jnp.asarray(vel), jnp.asarray(smk), cfg)
    vt, st = T.resample_outputs(_t(vel), _t(smk), T.Plume3DConfig(**{
        k: getattr(cfg, k) for k in ("res", "n_frames", "out_res", "out_frames")}))
    assert vt.shape == vj.shape == (4, 5, 9, 9, 3) and st.shape == sj.shape == (9, 4, 5, 9)
    assert _rel(vt, vj) <= 1e-6 and _rel(st, sj) <= 1e-6


def _write_files(folder, cfg):
    for seed, suffix in ((0, "_interp"), (275, "_interp"), (0, ""), (1, ""), (2, "")):
        T.generate_plume_files(folder, seed, cfg, suffix, device="cpu")


@pytest.mark.parametrize("lite", [False, True])
def test_plume_files_load_identically(tmp_path, monkeypatch, lite):
    """generate_plume_files's schema as JAX's (``data``: (X, Y, Z, T, 3) and
    (T, X, Y, Z), LZF with shuffle through h5py and through the subset);
    both packages' loaders read the files to the same arrays."""
    if lite:
        monkeypatch.setattr(h5io, "h5py_module", lambda: hdf5_lite)
    cfg = T.Plume3DConfig(**FILES)
    _write_files(tmp_path, cfg)
    # the CLI writes the aux seeds' convection form the same way
    T.main(["--path", str(tmp_path / "cli"), "--res", "8", "8", "12", "--frames", "2",
            "--dt", "1e-3", "--variant", "convection", "--device", "cpu"])
    with h5py.File(tmp_path / "v_trj_seed0_interp.h5") as f, \
            h5py.File(tmp_path / "s_trj_seed0_interp.h5") as g:
        assert f["data"].shape == (8, 8, 12, 4, 3) and g["data"].shape == (4, 8, 8, 12)
        assert [f["data"].compression, g["data"].compression, f["data"].shuffle] == \
            ["lzf", "lzf", True]
    with h5py.File(tmp_path / "cli" / "v_trj_seed0.h5") as f:
        assert f["data"].shape == (8, 8, 12, 2, 3) and np.isfinite(f["data"][:]).all()
    kw = dict(train_subsample=(1, 1, 3), num_aux_samples=3, initial_step=2, test_seeds=[275])
    got = tns3d.load_ns3d_aux(str(tmp_path), **kw, device="cpu")
    want = jns3d.load_ns3d_aux(str(tmp_path), **kw)
    for split in ("primary_train", "primary_test", "aux_train"):
        g, w = getattr(got, split), getattr(want, split)
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.grid.numpy(), np.asarray(w.grid))
    assert tuple(got.aux_train.data.shape) == (3, 4, 8, 8, 12, 4)


def test_plume_loader_and_trainer_read_without_h5py(tmp_path, monkeypatch):
    """Fault C9: with h5py not importable, the port writes the plume files
    through its HDF5 subset, ``load_ns3d_aux`` reads them, and
    ``run_training(dataset_family="ns3d")`` trains one step on them."""
    from sciml_pde_torch.train.fno_train import run_training

    monkeypatch.setitem(sys.modules, "h5py", None)
    assert h5io.h5py_module() is hdf5_lite
    cfg = T.Plume3DConfig(**FILES)
    _write_files(tmp_path, cfg)
    ds = tns3d.load_ns3d_aux(str(tmp_path), train_subsample=(1, 1, 3), num_aux_samples=3,
                             initial_step=3, test_seeds=[275], device="cpu")
    res = run_training(base_path=str(tmp_path), aux_path=str(tmp_path), dataset_family="ns3d",
                       if_aux=True, train_subsample=(1, 1, 3), num_aux_samples=3,
                       test_range=(275, 276), num_channels=4, modes=2, width=4,
                       initial_step=3, batch_size=1, epochs=1, run_dir=str(tmp_path / "run"),
                       model_name="plume_c9", log_every=0, device="cpu")
    monkeypatch.delitem(sys.modules, "h5py")
    with h5py.File(tmp_path / "s_trj_seed0_interp.h5") as f:
        smoke = f["data"][:]
    np.testing.assert_array_equal(ds.primary_train.data[0, ..., 3].numpy(), smoke)
    h = res.history[0]
    assert np.isfinite([h["first_step_loss"], h["train_loss"], h["val_loss"]]).all()
    assert (tmp_path / "run" / "plume_c9_ckpt").exists()
