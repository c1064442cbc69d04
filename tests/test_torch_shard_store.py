"""``run_training(shard_store=True)`` of the port over two gloo ranks
against the JAX package's ``shard_store`` run on a mesh of two devices,
from the same flax tree on the same NS files.

Each spawned rank (``torch.multiprocessing``, start method ``spawn``, a
timeout of its own) holds half the train trajectories (and, for aux, the
re-laid aux rows that pair with them), samples shard-major batches and
gathers its half of each from its own shard; the gradients are averaged
over the ranks before the adaptive clip.  JAX's mesh comes from
monkeypatching ``sciml_pde_tpu.train.fno_train.make_mesh`` to two of the
test process's devices, which changes no file of the JAX package.
Tolerances: per-epoch losses rtol 1e-4, trained parameters within 5e-4 of
each leaf's largest magnitude, on every rank."""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sciml_pde_tpu.train.fno_train as jax_fno_train
from sciml_pde_tpu.models import FNO2d as FlaxFNO2d
from sciml_pde_tpu.models import FNO2dAux as FlaxFNO2dAux
from sciml_pde_tpu.parallel import make_mesh as jax_make_mesh

from _torch_dist_worker import spawn, train
from _torch_parity import precision, to_numpy_tree

SIM, AUX = "ns_incom_inhom_2d_256", "ns_aux_2d_256"
X, NT, T0 = 12, 8, 3


def _write(path, seed):
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        f["velocity"] = rng.normal(size=(2, NT, X, X, 2)).astype(np.float32)
        f["particles"] = rng.uniform(size=(2, NT, X, X, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("ns_shard")
    for i in (0, 1, 250):
        _write(d / f"{SIM}-{i}.h5", i)
    for i in range(4):
        _write(d / f"{AUX}-{i}.h5", 40 + i)
    return str(d)


def _init(aux):
    x0, g0 = jnp.zeros((1, X, X, T0, 3)), jnp.zeros((1, X, X, 2))
    kw = dict(num_channels=3, modes1=3, modes2=3, width=6, initial_step=T0)
    key = jax.random.PRNGKey(3)
    if aux:
        return to_numpy_tree(jax.jit(FlaxFNO2dAux(**kw).init)(key, x0, g0, x0, g0)["params"])
    return to_numpy_tree(jax.jit(FlaxFNO2d(**kw).init)(key, x0, g0)["params"])


def _rel_trees(got, want, tol):
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        have = got
        for k in path:
            have = have[getattr(k, "key", k)]
        err = np.abs(np.asarray(have) - leaf).max() / np.abs(leaf).max()
        assert err <= tol, f"{jax.tree_util.keystr(path)} off by {err:.3e} of its max"


def test_two_rank_shard_store_matches_jax(folder, tmp_path, monkeypatch):
    common = dict(base_path=folder, aux_path=folder, dataset_family="ns",
                  train_subsample=(2, 2, 4), num_aux_samples=2, test_range=(250, 251),
                  num_channels=3, modes=3, width=6, initial_step=T0, batch_size=4, epochs=2,
                  learning_rate=2e-3, learning_rate_share=2e-3, learning_rate_fc2=1e-3,
                  log_every=0, seed=3, shard_store=True)
    runs = {name: dict(common, if_aux=aux, model_name=name, run_dir=str(tmp_path / "t"))
            for name, aux in (("baseline", False), ("aux", True))}
    for name, kw in runs.items():
        kw["init_params"] = _init(kw["if_aux"])
    ranks = spawn(train, 2, runs)
    monkeypatch.setattr(jax_fno_train, "make_mesh",
                        lambda: jax_make_mesh(devices=jax.devices()[:2]))
    with precision("highest"):
        for name, kw in runs.items():
            kw = {k: v for k, v in kw.items() if k != "init_params"}
            want = jax_fno_train.run_training(**dict(kw, run_dir=str(tmp_path / "j")))
            for got in ranks:
                hist = got[name]["history"]
                assert [h["epoch"] for h in hist] == [h["epoch"] for h in want.history] == [0, 1]
                for hg, hw in zip(hist, want.history):
                    np.testing.assert_allclose(hg["train_loss"], hw["train_loss"], rtol=1e-4)
                    np.testing.assert_allclose(hg["val_loss"], hw["val_loss"], rtol=1e-4)
                _rel_trees(got[name]["params"], to_numpy_tree(want.params), 5e-4)
    assert (tmp_path / "t" / "0" / "aux_ckpt").exists()
    assert not (tmp_path / "t" / "1" / "aux_ckpt").exists()  # rank 0 writes alone
