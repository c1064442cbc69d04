"""Resuming across packages from the JAX package's checkpoints (orbax
directories the port reads and writes without orbax): one package trains
an epoch and saves, both resume from copies of its directory with
``continue_training`` -- the FNO production, fused and aux steps and the
transformer baseline, each way -- losses within the CPU parity bound
1e-5; and ``pretrained_path`` from a JAX masked-SSL checkpoint and from a
JAX transformer run."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sciml_pde_tpu.utils import checkpoint as jck
from sciml_pde_torch.utils import checkpoint as tck

from _torch_parity import few_threads, jax_leaves, port_leaves, precision  # noqa: F401
from _torch_parity import to_numpy_tree

# ---------------------------------------------------------------------------
# resuming across packages
# ---------------------------------------------------------------------------

NT, X, C = 12, 16, 2
FNO = dict(train_subsample=(4, 2, 6), modes=4, width=8, initial_step=5, num_channels=C,
           batch_size=4, log_every=0, seed=3)
AUX = dict(FNO, batch_size=2, num_aux_samples=3, auxiliary_weight=0.7,
           learning_rate_share=2e-3, learning_rate_fc2=1e-3)
VMAE = dict(dataset_family="ns", if_aux=False, train_subsample=(1, 1, 1), test_range=(250, 251),
            img_size=32, patch_size=8, tubelet_size=2, in_chans=3, encoder_embed_dim=16,
            encoder_depth=1, encoder_num_heads=2, decoder_embed_dim=16, decoder_depth=1,
            decoder_num_heads=1, initial_step=4, batch_size=8, bf16=False, log_every=0,
            seed=5, grad_accum=2, warmup_steps=1)
RUNS = {"production": dict(FNO, if_aux=False, fast_step=False, learning_rate=2e-3),
        "fused": dict(FNO, if_aux=False, fast_step=True, learning_rate=2e-3),
        "aux": dict(AUX, if_aux=True), "transformer": VMAE}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """DR files (primary, extension, aux) and NS files (train, test)."""
    from sciml_pde_tpu.data import dr as jdr
    from sciml_pde_tpu.io.h5 import write_seed_group

    d = tmp_path_factory.mktemp("resume")

    def write(path, n, nt, x, seed, start=0):
        rng = np.random.default_rng(seed)
        lin = np.linspace(0, 1, x, dtype=np.float32)
        for s in range(start, start + n):
            write_seed_group(path, s, rng.normal(size=(nt, x, x, C)).astype(np.float32), lin,
                             lin, np.linspace(0, 1, nt, dtype=np.float32))
    write(d / jdr.PRIMARY_FILE, 10, NT, X, seed=0)
    write(d / "2D_diff-react_ext.h5", 4, NT, X, seed=1, start=100)
    write(d / jdr.AUX_FILE, 8, NT, X, seed=2)
    write(d / jdr.AUX_FILE_DOWNSAMPLED, 8, 6, 12, seed=3)
    import h5py

    for i in (0, 250):
        rng = np.random.default_rng(i)
        with h5py.File(d / f"ns_incom_inhom_2d_256-{i}.h5", "w") as f:
            f["velocity"] = rng.normal(size=(2, 20, 32, 32, 2)).astype(np.float32)
            f["particles"] = rng.uniform(size=(2, 20, 32, 32, 1)).astype(np.float32)
    return d


def _train(package, model, data, run_dir, **kw):
    """One call of the package's trainer for ``model`` (FNO ones under
    ``highest``): its result."""
    from sciml_pde_tpu.train import fno_train as jfno
    from sciml_pde_tpu.train import transformer_train as jtt
    from sciml_pde_torch.train import fno_train as tfno
    from sciml_pde_torch.train import transformer_train as ttt

    args = dict(RUNS[model], base_path=f"{data}/", run_dir=str(run_dir), model_name="m", **kw)
    if model == "aux":
        args["aux_path"] = f"{data}/"
    if package == "torch":
        args["device"] = "cpu"
    if model == "transformer":
        fn = jtt.run_transformer_training if package == "jax" else ttt.run_transformer_training
        return fn(**args)
    fn = jfno.run_training if package == "jax" else tfno.run_training
    with precision("highest"):
        return fn(**args)


@pytest.fixture(scope="module")
def first_epochs(data, tmp_path_factory):
    """{(model, package): the run directory of one trained epoch}, made on
    first use and shared by the tests."""
    cache = {}

    def get(model, package):
        if (model, package) not in cache:
            d = tmp_path_factory.mktemp(f"{model}_{package}")
            _train(package, model, data, d, epochs=1)
            cache[model, package] = d
        return cache[model, package]
    return get


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("model", list(RUNS))
def test_resume_across_packages(data, first_epochs, tmp_path, model, writer):
    """One package trains an epoch and saves; both resume from copies of that
    directory with ``continue_training`` for one more epoch.  Both restart
    their batches from ``seed``, so resume is held to resume: the same
    start epoch (the checkpoint's), the same best loss carried in, and the
    losses of both epochs within 1e-5."""
    src = first_epochs(model, writer) / "m_ckpt"
    meta = tck.restore_checkpoint(src)["meta"]
    res = {}
    for package in ("jax", "torch"):
        shutil.copytree(src, tmp_path / package / "m_ckpt")
        res[package] = _train(package, model, data, tmp_path / package, epochs=2,
                              continue_training=True)
    hj, ht = res["jax"].history, res["torch"].history
    assert [h["epoch"] for h in hj] == [h["epoch"] for h in ht] == list(
        range(int(meta["epoch"]), 2))
    for a, b in zip(ht, hj):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=f"{model} {k}")
    np.testing.assert_allclose(res["torch"].best_val, res["jax"].best_val, rtol=1e-5)
    assert res["torch"].best_val <= float(meta["loss"])


def _vmae_init():
    from sciml_pde_tpu.models.transformer import VideoMAEOperator as FlaxVideoMAE

    return to_numpy_tree(FlaxVideoMAE(num_frames=4, **_VMAE_KW).init(
        jax.random.PRNGKey(VMAE["seed"]), jnp.zeros((1, 4, 32, 32, 3)))["params"])


_VMAE_KW = dict(img_size=32, patch_size=8, tubelet_size=2, in_chans=3, encoder_dim=16,
                encoder_depth=1, encoder_heads=2, decoder_dim=16, decoder_depth=1,
                decoder_heads=1)


def test_pretrained_path_from_a_jax_ssl_checkpoint(data, tmp_path):
    """JAX's masked-SSL pretraining writes its checkpoint; the port's
    transformer takes it through ``pretrained_path`` as the JAX package
    loads pretrained weights (``load_partial_params`` over the checkpoint's
    parameters): every leaf the trees share from the checkpoint, bit for
    bit, the head as initialised.  (JAX's own trainer restores
    ``pretrained_path`` against its transformer template, which an SSL
    tree does not match; ``test_pretrained_path_from_a_jax_run`` holds the
    two trainers to each other on a checkpoint it takes.)"""
    from sciml_pde_tpu.data.windows import WindowedTrajectories as JW
    from sciml_pde_tpu.train import ssl_pretrain as jssl
    from sciml_pde_tpu.utils.checkpoint import load_partial_params
    from sciml_pde_torch.train import transformer_train as ttt

    arr = np.random.default_rng(6).normal(size=(2, 8, 32, 32, 3)).astype(np.float32)
    jssl.run_ssl_pretraining(JW(jnp.asarray(arr), jnp.zeros((32, 32, 2)), initial_step=4,
                                rollout=0, train=True),
                             model_kwargs=dict(_VMAE_KW, num_frames=4), initial_step=4,
                             batch_size=2, epochs=1, learning_rate=1e-3, run_dir=str(tmp_path),
                             model_name="ssl", seed=3, log_every=1000)
    init = _vmae_init()
    want = load_partial_params(init, jck.restore_params(tmp_path / "ssl_ckpt")[0])
    got = ttt.run_transformer_training(
        **dict(VMAE, base_path=f"{data}/", epochs=0, pretrained_path=str(tmp_path / "ssl_ckpt")),
        run_dir=str(tmp_path / "t"), model_name="t", init_params=init, device="cpu")
    g, w = jax_leaves(got.params), jax_leaves(to_numpy_tree(want))
    assert sorted(g) == sorted(w) and all(g[k].tobytes() == w[k].tobytes() for k in g)
    ssl = port_leaves(tck.restore_params(tmp_path / "ssl_ckpt")[0])
    shared = [k for k in g if k in ssl and ssl[k].shape == g[k].shape]
    assert len(shared) == len(g) - 2  # all but head.kernel and head.bias


def test_pretrained_path_from_a_jax_run(data, first_epochs, tmp_path):
    """A transformer checkpoint of JAX's trainer through both trainers'
    ``pretrained_path``: the same parameters, bit for bit."""
    from sciml_pde_tpu.train import transformer_train as jtt
    from sciml_pde_torch.train import transformer_train as ttt

    src = str(first_epochs("transformer", "jax") / "m_ckpt")
    common = dict(VMAE, base_path=f"{data}/", epochs=0, pretrained_path=src)
    want = jtt.run_transformer_training(run_dir=str(tmp_path / "j"), model_name="j", **common)
    got = ttt.run_transformer_training(run_dir=str(tmp_path / "t"), model_name="t",
                                       init_params=_vmae_init(), device="cpu", **common)
    g, w = jax_leaves(got.params), jax_leaves(to_numpy_tree(want.params))
    assert sorted(g) == sorted(w) and all(g[k].tobytes() == w[k].tobytes() for k in g)
    assert jax_leaves(tck.restore_params(src)[0]).keys() == g.keys()
