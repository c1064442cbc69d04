"""The port's checkpoints are the JAX package's: orbax ``StandardCheckpointer``
directories (OCDBT, zarr v2, zstd) read and written without orbax,
tensorstore or JAX (``utils/orbax_tree.py``, ``io/ocdbt.py``,
``io/zarr2.py``, ``io/zstd.py``).

JAX's ``save_checkpoint`` read by the port at the DR flagship width (width
20, modes 12) bit for bit; OCDBT B+trees of height 1 and more from
tensorstore's own writer (a small ``max_decoded_node_bytes``), and the
port's trees read back by tensorstore; corrupt OCDBT files raising; the
port's writes restored by JAX's ``restore_checkpoint`` (with its template)
and ``restore_params`` bit for bit; the embedded JAX checkpoint of
``chip_smoke.py`` phase 24b; the five optimizers' states mapped to optax's
trees and back, each held to optax's own state and update; and a restore
with orbax, tensorstore and zstandard blocked from import.  Resuming across
packages and ``pretrained_path``: ``test_torch_orbax_resume.py``."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sciml_pde_tpu.utils import checkpoint as jck
from sciml_pde_torch.io import ocdbt
from sciml_pde_torch.utils import checkpoint as tck

from _torch_orbax_fixture import LEAVES, MODEL, fixture_input, leaf_digest, output, write_checkpoint
from _torch_parity import (assert_bitwise, few_threads, jax_leaves, leaf_name,  # noqa: F401
                           port_leaves, to_numpy_tree)

ROOT = Path(__file__).resolve().parents[1]
ts = pytest.importorskip("tensorstore")


def _fno_params(width=20, modes=12, aux=False):
    from sciml_pde_tpu.models import FNO2d, FNO2dAux

    cls = FNO2dAux if aux else FNO2d
    model = cls(num_channels=2, modes1=modes, modes2=modes, width=width, initial_step=10)
    x, g = jnp.zeros((1, 32, 32, 10, 2)), jnp.zeros((1, 32, 32, 2))
    args = (x, g, x, g) if aux else (x, g)
    return to_numpy_tree(model.init(jax.random.PRNGKey(0), *args)["params"])


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(size=np.shape(a))).astype(np.asarray(a).dtype)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a) + 7, tree)


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", ["production", "fused"])
def test_jax_checkpoint_reads_bit_for_bit_at_the_flagship(tmp_path, step):
    from sciml_pde_tpu.train import fast_step as jfs
    from sciml_pde_tpu.train.optim import make_optimizer

    params = _fno_params()
    if step == "production":
        opt = _noisy(make_optimizer(1e-3, 100).init(params), 1)
    else:
        theta, _ = jfs.fast_state_from_tree(params, 12)
        opt = _noisy(jfs.init_opt(theta), 1)
    jck.save_checkpoint(tmp_path / "ck", params, opt, 7, 0.0123456789)
    got = tck.restore_checkpoint(tmp_path / "ck")
    want = {"params": params, "opt_state": opt,
            "meta": {"epoch": np.asarray(7), "loss": np.asarray(0.0123456789)}}
    assert_bitwise(got, want, step)
    p, loss = tck.restore_params(tmp_path / "ck")
    assert_bitwise({"params": p}, {"params": params})
    assert loss == 0.0123456789
    assert got["opt_state"][0] is None if step == "production" else set(got["opt_state"]) == {
        "m", "v", "count"}


def _ts_items(root) -> dict[str, bytes]:
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
    return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


@pytest.mark.parametrize("node_bytes", [200, 600])
def test_tensorstore_btrees_of_height_above_zero(tmp_path, node_bytes):
    """tensorstore's writer with a small node bound (orbax's 100,000,000
    keeps a checkpoint at height 0): interior nodes, prefix-compressed keys
    under a subtree prefix, values inline and in data files, several
    commits (versions) and uncompressed and zstd nodes, all read back."""
    rng = np.random.default_rng(node_bytes)
    want = {}
    for comp in (None, {"id": "zstd", "level": 3}):
        root = tmp_path / f"db{comp is None}"
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                              "config": {"max_decoded_node_bytes": node_bytes,
                                         "max_inline_value_bytes": 40,
                                         "compression": comp}}).result()
        for commit in range(3):
            with ts.Transaction() as txn:
                for i in range(30):
                    key = f"params.layer{i % 5}.w{i}/{commit}.0"
                    want[key] = bytes(rng.integers(0, 256, int(rng.integers(0, 90)), np.uint8))
                    kv.with_transaction(txn).write(key.encode(), want[key]).result()
        r = ocdbt.OcdbtReader(root)
        assert r.version.root_height >= 1 and r.version.generation >= 3
        assert r.keys() == sorted(want) and all(r.get(k) == v for k, v in want.items())
        assert r.get("no/such/key") is None
        want.clear()


@pytest.mark.parametrize("node_bytes", [250, 100_000_000])
def test_port_btrees_read_by_tensorstore(tmp_path, node_bytes):
    rng = np.random.default_rng(1)
    items = {f"opt_state.{i % 3}.mu.w{i}/{'.zarray' if i % 2 else '0.0'}":
             bytes(rng.integers(0, 256, int(rng.integers(0, 2500)), np.uint8)) for i in range(60)}
    ocdbt.write_database(tmp_path / "db", items, max_decoded_node_bytes=node_bytes)
    r = ocdbt.OcdbtReader(tmp_path / "db")
    assert (r.version.root_height > 0) == (node_bytes < 1000)
    assert {k: r.get(k) for k in r.keys()} == items == _ts_items(tmp_path / "db")


def test_corrupt_ocdbt_files_raise(tmp_path):
    ocdbt.write_database(tmp_path / "db", {"a/0": b"x" * 5000, "a/.zarray": b"{}"})
    man = tmp_path / "db" / "manifest.ocdbt"
    good = man.read_bytes()
    for i, what in ((0, "magic"), (len(good) // 2, "CRC"), (6, "length")):
        bad = bytearray(good)
        bad[i] ^= 1
        man.write_bytes(bytes(bad))
        with pytest.raises(ocdbt.OcdbtError, match=what):
            ocdbt.OcdbtReader(tmp_path / "db")
    import struct

    from sciml_pde_torch.io import zstd

    body = bytearray(good[:-4])
    body[12] = 3  # format version 3
    man.write_bytes(bytes(body) + struct.pack("<I", zstd.crc32c(bytes(body))))
    with pytest.raises(ocdbt.OcdbtError, match="unsupported format version 3"):
        ocdbt.OcdbtReader(tmp_path / "db")


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port writes the flagship tree with the production optimizer's
    optax state; JAX restores it against its template and without one, bit
    for bit."""
    from sciml_pde_tpu.train.optim import make_optimizer

    params = _fno_params()
    opt = _noisy(make_optimizer(1e-3, 100).init(params), 2)
    port_opt = [None, None, {"count": opt[2].count, "mu": opt[2].mu, "nu": opt[2].nu},
                {"count": opt[3].count}]
    tck.save_checkpoint(tmp_path / "ck", params, port_opt, 4, 0.5)
    like = {"params": params, "opt_state": opt, "meta": {"epoch": np.asarray(0),
                                                         "loss": np.asarray(0.0)}}
    got = jck.restore_checkpoint(tmp_path / "ck", like)
    want = dict(like, meta={"epoch": np.asarray(4), "loss": np.asarray(0.5)})
    for (pa, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                               jax.tree_util.tree_leaves_with_path(want)):
        assert np.asarray(a).dtype == np.asarray(b).dtype, leaf_name(pa)
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), leaf_name(pa)
    p, loss = jck.restore_params(tmp_path / "ck")
    assert loss == 0.5 and jax_leaves(p).keys() == jax_leaves(params).keys()
    assert all(np.array_equal(a, jax_leaves(params)[k]) for k, a in jax_leaves(p).items())


def test_fixture_checkpoint_and_forward():
    """The embedded JAX checkpoint (``chip_smoke.py`` phase 24b): every leaf
    against the hash recorded with it, and the port's forward of its
    parameters against JAX's stored output (1e-5, the CPU parity bound)."""
    import tempfile

    from sciml_pde_torch.models.fno import FNO2d
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.utils.weights import flax_to_state_dict

    with tempfile.TemporaryDirectory() as d:
        tree = tck.restore_checkpoint(write_checkpoint(Path(d) / "ck"))
    leaves = port_leaves(tree)
    assert {k: leaf_digest(k, a) for k, a in leaves.items()} == LEAVES
    model = FNO2d(**MODEL)
    model.load_state_dict(flax_to_state_dict(tree["params"]))
    x, grid = fixture_input()
    prev = spectral.get_dft_precision()
    spectral.set_dft_precision("highest")
    try:
        with torch.no_grad():
            y = model(torch.as_tensor(x), torch.as_tensor(grid)).numpy()
    finally:
        spectral.set_dft_precision(prev)
    np.testing.assert_allclose(y, output(), rtol=1e-5, atol=1e-5)


def test_restores_with_orbax_tensorstore_and_zstandard_blocked(tmp_path):
    write_checkpoint(tmp_path / "ck")
    code = (
        "import sys\n"
        "for m in ('orbax', 'tensorstore', 'zstandard', 'jax', 'sciml_pde_tpu'):\n"
        "    sys.modules[m] = None\n"
        "sys.path.insert(0, 'tests')\n"
        "from _torch_orbax_fixture import LEAVES, leaf_digest\n"
        "from sciml_pde_torch.utils.checkpoint import restore_checkpoint, restore_params\n"
        "from sciml_pde_torch.utils.orbax_tree import flatten\n"
        f"tree = restore_checkpoint({str(tmp_path / 'ck')!r})\n"
        "got = {'.'.join(p): leaf_digest('.'.join(p), v.numpy()) for p, v in "
        "flatten(tree).items() if v is not None}\n"
        "assert got == LEAVES, sorted(set(got.items()) ^ set(LEAVES.items()))[:4]\n"
        f"print('LOSS', restore_params({str(tmp_path / 'ck')!r})[1])\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOSS 0.1234567890123" in r.stdout


# ---------------------------------------------------------------------------
# the optimizers' states
# ---------------------------------------------------------------------------


def _torch_params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _grads(params, seed):
    g = torch.Generator().manual_seed(seed)
    return {n: torch.randn(p.shape, generator=g) for n, p in params.items()}


def _case(kind):
    """(port optimizer, params, to_tree, to_sd, optax transformation)."""
    from sciml_pde_tpu.train import optim as joptim
    from sciml_pde_tpu.train import transformer_train as jtt
    from sciml_pde_torch.models.fno import FNO2d, FNO2dAux
    from sciml_pde_torch.models.transformer import VideoMAEOperatorAux
    from sciml_pde_torch.train import optim
    from sciml_pde_torch.train import transformer_train as ttt
    from sciml_pde_torch.utils import weights as w

    fno = dict(num_channels=2, modes1=4, modes2=4, width=8, initial_step=5)
    if kind in ("production", "aux"):
        gen = torch.Generator().manual_seed(0)
        model = FNO2d(**fno, generator=gen) if kind == "production" else FNO2dAux(
            **fno, generator=gen)
        params = _torch_params(model)
        if kind == "production":
            return (optim.make_optimizer(params, 1e-3, 20), params, w.state_dict_to_flax,
                    w.flax_to_state_dict, joptim.make_optimizer(1e-3, 20))
        lrs = {"shared": 1e-3, "primary_head": 5e-4, "aux_head": 2e-3}
        return (optim.make_grouped_optimizer(params, optim.aux_group_of, lrs, 20), params,
                w.state_dict_to_flax, w.flax_to_state_dict,
                joptim.make_grouped_optimizer(joptim.aux_group_of, lrs, 20))
    vm = VideoMAEOperatorAux(img_size=16, patch_size=8, tubelet_size=2, in_chans=2,
                             num_frames=4, encoder_dim=16, encoder_depth=1, encoder_heads=2,
                             decoder_dim=16, decoder_depth=1, decoder_heads=1,
                             generator=torch.Generator().manual_seed(0))
    params = _torch_params(vm)
    to_tree, to_sd = w.transformer_state_dict_to_flax, w.transformer_flax_to_state_dict
    if kind == "adamw":
        return (optim.AdamW(params, optim.make_lr_schedule("cosine", 1e-3, 20)), params,
                to_tree, to_sd, optax.adamw(optax.cosine_decay_schedule(1e-3, 20)))
    k = int(kind[-1])
    return (ttt.make_transformer_optimizer(params, 1e-3, 5e-4, 20, clip=0.5, grad_accum=k),
            params, to_tree, to_sd,
            jtt.make_transformer_optimizer(1e-3, 5e-4, 20, clip=0.5, grad_accum=k))


@pytest.mark.parametrize("kind", ["production", "aux", "transformer1", "transformer3", "adamw"])
def test_optimizer_state_maps_both_ways(tmp_path, kind):
    """The port's state after some steps, as optax's tree: JAX restores it
    against ``tx.init``'s structure bit for bit, and one more step of optax
    from it meets one more step of the port (f32 rounding, 1e-6); JAX's
    save of that state reads back into a fresh port optimizer bit for bit."""
    opt, params, to_tree, to_sd, tx = _case(kind)
    for s in range(4 if kind == "transformer3" else 2):
        opt.step(params, _grads(params, s))
    tree = opt.optax_tree(opt.state_dict(), to_tree)
    jparams = to_tree(params)
    like = {"params": jparams, "opt_state": tx.init(jparams),
            "meta": {"epoch": np.asarray(0), "loss": np.asarray(0.0)}}
    tck.save_checkpoint(tmp_path / "t", jparams, tree, 1, 0.25)
    restored = jck.restore_checkpoint(tmp_path / "t", like)
    assert_bitwise(tree, restored["opt_state"], kind)
    assert jax.tree_util.tree_structure(restored["opt_state"]) == \
        jax.tree_util.tree_structure(like["opt_state"])
    # one more step in both packages from the same state
    g = _grads(params, 99)
    upd, jstate = tx.update(to_tree(g), restored["opt_state"], jparams)
    jnew = optax.apply_updates(jparams, upd)
    opt.step(params, g)
    got, want = jax_leaves(to_tree(params)), jax_leaves(jnew)
    for k, a in want.items():
        np.testing.assert_allclose(got[k], a, rtol=1e-6, atol=1e-6 * np.abs(a).max(),
                                   err_msg=f"{kind} {k}")
    got_s = port_leaves(opt.optax_tree(opt.state_dict(), to_tree))
    want_s = jax_leaves(jstate)
    assert sorted(got_s) == sorted(want_s)
    for k, a in want_s.items():  # the moments, counts and accumulator after the step
        np.testing.assert_allclose(got_s[k], a, rtol=1e-6, atol=1e-6 * np.abs(a).max(),
                                   err_msg=f"{kind} {k}")
    # JAX's save of the state into a fresh port optimizer
    jck.save_checkpoint(tmp_path / "j", jnew, jstate, 2, 0.125)
    fresh = _case(kind)[0]
    fresh.load_state_dict(fresh.state_from_optax(tck.restore_checkpoint(tmp_path / "j")
                                                 ["opt_state"], to_sd))
    assert_bitwise(fresh.optax_tree(fresh.state_dict(), to_tree),
                   jax.tree_util.tree_map(np.asarray, jstate), kind)


@pytest.mark.parametrize("width,modes", [(8, 4), (20, 12)])
def test_fused_state_maps_both_ways(tmp_path, width, modes):
    """The fused step's flat moments: JAX pads its mode-mix blocks to tiles
    of 8 (zeros in the pad slots), the port does not; ``opt_tree`` writes
    JAX's packing, which JAX restores against ``init_opt``'s template bit
    for bit, and ``opt_from_tree`` reads JAX's save back."""
    from sciml_pde_tpu.train import fast_step as jfs
    from sciml_pde_torch.train import fast_step as tfs

    params = _fno_params(width=width, modes=modes)
    jtheta, _ = jfs.fast_state_from_tree(params, modes)
    ttheta, spec = tfs.fast_state_from_tree(params, modes)
    assert np.asarray(jtheta).tobytes() == tfs.to_jax_packing(ttheta, spec).numpy().tobytes()
    assert torch.equal(tfs.from_jax_packing(np.asarray(jtheta), spec), ttheta)
    rng = np.random.default_rng(3)
    opt = tfs.FlatOptState(torch.as_tensor(rng.normal(size=ttheta.shape).astype(np.float32)),
                           torch.as_tensor(rng.random(ttheta.shape).astype(np.float32)), 11)
    tck.save_checkpoint(tmp_path / "t", params, tfs.opt_tree(opt, spec), 1, 0.5)
    like = {"params": params, "opt_state": jfs.init_opt(jtheta),
            "meta": {"epoch": np.asarray(0), "loss": np.asarray(0.0)}}
    got = jck.restore_checkpoint(tmp_path / "t", like)["opt_state"]
    assert_bitwise(tfs.opt_tree(opt, spec), got)
    jck.save_checkpoint(tmp_path / "j", params, got, 1, 0.5)
    back = tfs.opt_from_tree(tck.restore_checkpoint(tmp_path / "j")["opt_state"], spec)
    assert torch.equal(back.m, opt.m) and torch.equal(back.v, opt.v) and back.count == 11
    with pytest.raises(ValueError, match="fast_step"):
        tfs.opt_from_tree([None, None, {}, {}], spec)
