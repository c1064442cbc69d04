"""The port's process group and mesh (``sciml_pde_torch/parallel``): JAX's
two-process check (``tests/test_distributed.py``) in the port's terms --
two spawned CPU processes join a gloo group through ``distributed_init``
(a second call returns at once), ``make_mesh`` spans both, and
``host_local_array`` assembles each rank's 4 rows into the global batch of
8, total 36.0 -- with ``shard_batch``, ``replicate``, ``mean_over_ranks``
and ``local_batch_size``; and the one-rank mesh and its refusals without a
process group.  Exact values throughout."""

import numpy as np
import pytest
import torch

from sciml_pde_torch import parallel

from _torch_dist_worker import collectives, spawn


def test_two_process_cpu_group():
    res = spawn(collectives, 2)
    for rank, r in enumerate(res):
        assert r["shape"] == {"data": 2, "model": 1} and r["rank"] == rank
        assert r["global_shape"] == (8, 3) and r["total"] == 36.0
        assert list(r["rows"]["a"]) == list(range(4 * rank, 4 * rank + 4))
        assert list(r["rows"]["b"]) == [0, 1, 2]  # 3 rows do not divide: all of them
        assert r["replicated"] == [7.0, 7.0, 7.0]  # rank 0's
        assert r["mean"] == [0.5, 1.0] and r["local_batch"] == 4


def test_one_rank_mesh_without_a_group():
    mesh = parallel.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    x = np.arange(6)
    assert parallel.shard_batch((x,), mesh)[0] is x
    assert parallel.host_local_array(x, mesh).tolist() == x.tolist()
    t = torch.ones(2)
    assert parallel.mean_over_ranks(t, mesh) is t and parallel.replicate(t, mesh) is t
    assert parallel.batch_sharding(mesh, 3).spec == ("data", None, None)
    assert parallel.replicated_sharding(mesh).spec == ()
    assert parallel.trajectory_sharding(mesh).spec == ("data",)


@pytest.mark.parametrize("kw,err", [
    (dict(data=2), "mesh 2x1 != 1 devices"),
    (dict(data=-1, devices=[0, 1, 2]), None),
])
def test_mesh_sizes_as_jax(kw, err):
    """JAX's divisibility words; an explicit device list sizes the mesh."""
    from sciml_pde_tpu.parallel.mesh import make_mesh as jax_make_mesh
    import jax

    if err:
        with pytest.raises(ValueError, match=err):
            parallel.make_mesh(**kw)
        with pytest.raises(ValueError, match=err):
            jax_make_mesh(devices=jax.devices()[:1], **kw)
    else:
        assert parallel.make_mesh(**kw).shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError, match="not divisible by data axis 3"):
        parallel.local_batch_size(4, parallel.make_mesh(devices=[0, 1, 2]))


def test_torchrun_starts_a_data_parallel_cli_run(tmp_path):
    """``torchrun --nproc-per-node 2 -m sciml_pde_torch.train.cli train ...
    device=cpu shard_store=True``: both ranks join one gloo group, each
    trains on its half of the trajectories, both end at the same validation
    loss, and rank 0 alone writes the checkpoint."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from sciml_pde_tpu.io.h5 import write_seed_group

    rng = np.random.default_rng(0)
    lin = np.linspace(0, 1, 16, dtype=np.float32)
    for s in range(10):  # 9 train seeds, the first 4 trained on
        write_seed_group(tmp_path / "2D_diff-react_test_all.h5", s,
                         rng.normal(size=(8, 16, 16, 2)).astype(np.float32), lin, lin,
                         np.linspace(0, 1, 8, dtype=np.float32))
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "sciml_pde_torch.train.cli", "train", "--config", "config_dr",
           f"base_path={tmp_path}/", "device=cpu", "shard_store=True", "epochs=1", "width=8",
           "modes=4", "initial_step=5", "batch_size=4", "train_subsample=[4, 4, 4]",
           "log_every=0", f"run_dir={tmp_path / 'run'}", "model_name=DR_tr_FNO"]
    r = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    vals = [line for line in r.stdout.splitlines() if line.startswith("best_val=")]
    assert len(vals) == 2 and vals[0] == vals[1], r.stdout[-2000:]
    assert (tmp_path / "run" / "DR_tr_FNO_ckpt").exists()
