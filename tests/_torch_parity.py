"""Helpers shared by the port's parity tests (tests/test_torch_*.py): pin
f32 products in both packages, move trees between them, and load
chip_smoke.py for the bounds the card checks use."""

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch


@contextlib.contextmanager
def precision(name: str):
    """Set SCIML_DFT_PRECISION's value in both packages for the block."""
    from sciml_pde_tpu.ops import spectral as jspec
    from sciml_pde_torch.ops import spectral as tspec

    prev_j, prev_t = jspec._PRECISION, tspec.get_dft_precision()
    jspec.set_dft_precision(name)
    tspec.set_dft_precision(name)
    try:
        yield
    finally:
        jspec._PRECISION = prev_j
        tspec.set_dft_precision(prev_t)


def to_numpy_tree(tree):
    """Flax/JAX tree -> nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def assert_trees_close(got, want, rtol, atol, what=""):
    """Every leaf of ``want`` (a flax tree) against the same path of ``got``."""
    flat_got = {
        tuple(getattr(k, "key", k) for k in path): leaf
        for path, leaf in jax.tree_util.tree_leaves_with_path(got)
    }
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        key = tuple(getattr(k, "key", k) for k in path)
        have = flat_got[key]
        if isinstance(have, torch.Tensor):
            have = have.detach().cpu().numpy()
        np.testing.assert_allclose(np.asarray(have), np.asarray(leaf), rtol=rtol, atol=atol,
                                   err_msg=f"{what} mismatch at {'/'.join(key)}")


@functools.lru_cache(maxsize=None)
def chip_smoke():
    """chip_smoke.py as a module, for the bounds and shapes it holds the
    kernels to on the card (importing it runs nothing); loaded once a
    process."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def logged(run_dir, name: str, key: str) -> list:
    """The ``key`` values of ``{run_dir}/{name}.jsonl``, as both packages'
    ``MetricLogger`` write it, in step order."""
    import json
    from pathlib import Path

    lines = (Path(run_dir) / f"{name}.jsonl").read_text().splitlines()
    return [json.loads(line)[key] for line in lines]


def assert_losses_close(got, want, n: int = 3, rtol: float = 1e-4):
    """The first ``n`` losses of two runs within ``rtol`` of each other."""
    assert len(got) >= n and len(want) >= n, (got, want)
    np.testing.assert_allclose(got[:n], want[:n], rtol=rtol)


@pytest.fixture(autouse=True)
def few_threads():
    """Torch on two threads for each test of a module that imports this
    fixture: the tier runs six workers on the host's cores, and small-op
    CPU runs lose to oversubscription."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- checkpoint trees (tests/test_torch_orbax_*.py) --------------------------------------


def leaf_name(path) -> str:
    """A JAX key path as orbax names the leaf: its keys joined with dots."""
    return ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path)


def jax_leaves(tree) -> dict:
    """{dotted path: numpy array} of a JAX pytree's leaves."""
    return {leaf_name(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def port_leaves(tree) -> dict:
    """{dotted path: numpy array} of a port checkpoint tree's array leaves
    (optax's empty states and masked nodes, None or empty, left out)."""
    from sciml_pde_torch.utils.orbax_tree import flatten

    out = {}
    for path, leaf in flatten(tree).items():
        if leaf is None or isinstance(leaf, (tuple, list, dict)):
            continue
        out[".".join(path)] = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    return out


def assert_bitwise(port_tree, jax_tree, what=""):
    """The same leaves, dtypes, shapes and bytes in a port tree and a JAX one."""
    got, want = port_leaves(port_tree), jax_leaves(jax_tree)
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), (what, k)

