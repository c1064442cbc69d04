"""The port's generic OFormer trainers
(``sciml_pde_torch/comparisons/oformer_generic.py``) and the magnitude-frame
converter (``comparisons/make_npy.py``) against the JAX package's, and
fault C10 (``utils/checkpoint.py::restore_params``):

  - Burgers and Darcy from one flax tree: the first 3 losses within 1e-4
    relative, the held-out evaluations of the trained trees within 1e-4;
  - ``load_pdebench_1d`` through h5py and through the port's own reader;
  - ``to_mag_frames`` against ``jax.image.resize`` (antialiased bilinear)
    within 1e-6 of the largest magnitude, shrinking and growing, and
    ``convert_dir``'s npy;
  - one flax tree saved through both packages' ``save_checkpoint``: both
    ``restore_params`` return the same tree and loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_losses_close, few_threads, logged, to_numpy_tree  # noqa: F401

DIMS = dict(in_emb_dim=16, depth=2, heads=2)


def test_burgers_matches_jax(tmp_path):
    from sciml_pde_tpu.comparisons import oformer_generic as jg
    from sciml_pde_tpu.models.oformer import OFormer1D
    from sciml_pde_torch.comparisons import oformer_generic as tg

    data = np.random.default_rng(0).normal(size=(3, 8, 32)).astype(np.float32)
    kw = dict(initial_step=4, batch_size=4, epochs=1, log_every=1, seed=16, **DIMS)
    want = jg.run_oformer_burgers(data, run_dir=str(tmp_path / "jax"), **kw)
    tree = to_numpy_tree(OFormer1D(input_channels=5, out_channels=1, in_emb_dim=16,
                                   latent_channels=16, heads=2, depth=2).init(
        jax.random.PRNGKey(16), jnp.zeros((1, 32, 5)), jnp.zeros((1, 32, 1)))["params"])
    got = tg.run_oformer_burgers(data, run_dir=str(tmp_path / "torch"), device="cpu",
                                 init_params=tree, **kw)
    assert_losses_close(logged(tmp_path / "torch", "oformer_burgers", "rel_l2"),
                        logged(tmp_path / "jax", "oformer_burgers", "rel_l2"))
    ev = dict(initial_step=4, batch_size=4, **DIMS)
    np.testing.assert_allclose(tg.eval_oformer_burgers(got.params, data, device="cpu", **ev),
                               jg.eval_oformer_burgers(want.params, data, **ev), rtol=1e-4)


def test_darcy_matches_jax(tmp_path):
    from sciml_pde_tpu.comparisons import oformer_generic as jg
    from sciml_pde_tpu.models.oformer import OFormer2D
    from sciml_pde_torch.comparisons import oformer_generic as tg

    rng = np.random.default_rng(1)
    a = rng.uniform(3, 12, size=(4, 8, 8)).astype(np.float32)
    u = rng.normal(size=(4, 8, 8)).astype(np.float32)
    kw = dict(batch_size=4, epochs=3, seed=16, **DIMS)  # one step an epoch
    want = jg.run_oformer_darcy(a, u, run_dir=str(tmp_path / "jax"), **kw)
    tree = to_numpy_tree(OFormer2D(input_channels=3, out_channels=1, in_emb_dim=16,
                                   latent_channels=16, heads=2, depth=2, out_steps=1,
                                   propagator_depth=1).init(
        jax.random.PRNGKey(16), jnp.zeros((1, 64, 3)), jnp.zeros((1, 64, 2)))["params"])
    got = tg.run_oformer_darcy(a, u, run_dir=str(tmp_path / "torch"), device="cpu",
                               init_params=tree, **kw)
    assert_losses_close([h["rel_l2"] for h in got.history], [h["rel_l2"] for h in want.history])
    assert got.norm_stats == want.norm_stats
    np.testing.assert_allclose(
        tg.eval_oformer_darcy(got.params, a, u, norm_stats=got.norm_stats, device="cpu", **DIMS),
        jg.eval_oformer_darcy(want.params, a, u, norm_stats=want.norm_stats, **DIMS), rtol=1e-4)


@pytest.mark.parametrize("reader", ["h5py", "hdf5_lite"])
def test_load_pdebench_1d_reads_both_ways(tmp_path, monkeypatch, reader):
    import h5py

    from sciml_pde_tpu.comparisons.oformer_generic import load_pdebench_1d as jload
    from sciml_pde_torch.comparisons.oformer_generic import load_pdebench_1d
    from sciml_pde_torch.io import h5 as h5io

    data = np.random.default_rng(2).normal(size=(2, 5, 12)).astype(np.float32)
    with h5py.File(tmp_path / "b.h5", "w") as f:
        f.create_dataset("tensor", data=data)
    if reader == "hdf5_lite":
        from sciml_pde_torch.io import hdf5_lite

        monkeypatch.setattr(h5io, "h5py_module", lambda: hdf5_lite)
    np.testing.assert_array_equal(load_pdebench_1d(tmp_path / "b.h5"),
                                  jload(tmp_path / "b.h5"))
    with h5py.File(tmp_path / "c.h5", "w") as f:
        f.create_dataset("other", data=data)
    with pytest.raises(KeyError, match="none of"):
        load_pdebench_1d(tmp_path / "c.h5")


@pytest.mark.parametrize("shape", [(3, 2, 100, 90, 2), (2, 50, 40), (4, 64, 64, 2),
                                   (2, 5, 200, 70)])
def test_to_mag_frames_matches_jax_resize(shape):
    from sciml_pde_tpu.comparisons.make_npy import to_mag_frames as jmag
    from sciml_pde_torch.comparisons.make_npy import to_mag_frames

    a = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want, got = jmag(a), to_mag_frames(a)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_convert_dir_writes_jax_npy(tmp_path):
    import h5py

    from sciml_pde_tpu.comparisons.make_npy import convert_dir as jconvert
    from sciml_pde_torch.comparisons.make_npy import main

    rng = np.random.default_rng(4)
    for i in range(2):
        with h5py.File(tmp_path / f"v{i}.h5", "w") as f:
            f.create_dataset("velocity", data=rng.normal(size=(3, 40, 40, 2)).astype(np.float32))
    main(["--src", str(tmp_path), "--out", str(tmp_path / "t.npy"), "--size", "16"])
    jconvert(tmp_path, tmp_path / "j.npy", size=16)
    got, want = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    assert got.shape == want.shape == (6, 16, 16)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_restore_params_matches_jax(tmp_path):
    """Fault C10: the port had no ``restore_params``."""
    from sciml_pde_tpu.utils.checkpoint import restore_params as jrestore
    from sciml_pde_tpu.utils.checkpoint import save_checkpoint as jsave
    from sciml_pde_torch.utils.checkpoint import restore_params, save_checkpoint

    rng = np.random.default_rng(5)
    tree = {"backbone": {"fc0": {"Dense_0": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                                             "bias": np.zeros(3, np.float32)}}},
            "fc2": {"Dense_0": {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                                "bias": rng.normal(size=2).astype(np.float32)}}}
    jsave(tmp_path / "jax_ckpt", tree, {"count": np.int32(3)}, epoch=4, loss=0.125)
    save_checkpoint(tmp_path / "torch_ckpt", tree, {"count": 3}, epoch=4, loss=0.125)
    (jp, jl), (tp, tl) = jrestore(tmp_path / "jax_ckpt"), restore_params(tmp_path / "torch_ckpt")
    assert tl == jl == 0.125 and isinstance(tl, float)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jp))
    flat_t = {k: v.numpy() for k, v in jax.tree_util.tree_leaves_with_path(tp)}
    assert sorted(map(str, flat_j)) == sorted(map(str, flat_t))
    for k, v in flat_j.items():
        np.testing.assert_array_equal(flat_t[k], np.asarray(v))
