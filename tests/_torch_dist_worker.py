"""Worker functions of the port's multi-process CPU tests
(``test_torch_distributed.py``, ``test_torch_shard_store.py``): each runs in
a process started with the ``spawn`` method, joins a gloo process group
through ``sciml_pde_torch.parallel.distributed_init`` on a local TCP port,
and writes what it found to ``out`` (a pickle per rank).  Imports torch and
the port only."""

import pickle


def collectives(rank: int, world: int, port: int, out: str) -> None:
    """The JAX package's two-process check in the port's terms, and the
    helpers the trainers use."""
    import numpy as np
    import torch

    from sciml_pde_torch import parallel

    parallel.distributed_init(f"localhost:{port}", world, rank, device="cpu")
    parallel.distributed_init(f"localhost:{port}", world, rank, device="cpu")  # idempotent
    mesh = parallel.make_mesh()
    local = np.full((4, 3), float(rank + 1), np.float32)
    g = parallel.host_local_array(local, mesh)
    p = torch.full((3,), float(rank + 7))
    parallel.replicate({"w": [p]}, mesh)
    m = parallel.mean_over_ranks(torch.tensor([float(rank), 2.0 * rank]), mesh)
    res = dict(shape=mesh.shape, rank=mesh.rank, global_shape=g.shape, total=float(g.sum()),
               rows=parallel.shard_batch({"a": np.arange(8), "b": np.arange(3)}, mesh),
               replicated=p.tolist(), mean=m.tolist(),
               local_batch=parallel.local_batch_size(8, mesh))
    torch.distributed.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)


def train(rank: int, world: int, port: int, runs: dict, out: str) -> None:
    """``run_training`` of each of ``runs`` (name -> keywords) over the
    process group; every rank records its history and trained tree."""
    import torch

    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.parallel import distributed_init
    from sciml_pde_torch.train.fno_train import run_training

    torch.set_num_threads(1)
    spectral.set_dft_precision("highest")
    distributed_init(f"localhost:{port}", world, rank, device="cpu")
    res = {}
    for name, kw in runs.items():
        r = run_training(device="cpu", **dict(kw, run_dir=f"{kw['run_dir']}/{rank}"))
        res[name] = dict(history=r.history, params=r.params)
    torch.distributed.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)


def tp_forward(rank: int, world: int, port: int, tree: dict, x, grid, cot, out: str) -> None:
    """The column-parallel FNO2d over a mesh of ``model=world`` (``highest``
    products): each rank's output, its shards' gradients of ``sum(out *
    cot)`` and the placements ``shard_params_tp`` gave."""
    import torch

    from sciml_pde_torch import parallel
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.parallel.tp import fno2d_tp_apply, shard_params_tp

    torch.set_num_threads(1)
    spectral.set_dft_precision("highest")
    parallel.distributed_init(f"localhost:{port}", world, rank, device="cpu")
    mesh = parallel.make_mesh(model=world)
    sharded = shard_params_tp(tree, mesh)
    leaves = []

    def track(node):
        if isinstance(node, dict):
            return {k: track(v) for k, v in node.items()}
        leaves.append(node.value.requires_grad_(True))
        return node
    track(sharded)
    y = fno2d_tp_apply(sharded, torch.as_tensor(x), torch.as_tensor(grid), mesh)
    (y * torch.as_tensor(cot)).sum().backward()

    def grads(node):
        if isinstance(node, dict):
            return {k: grads(v) for k, v in node.items()}
        return (node.value.grad.numpy(), node.sharding.spec)
    res = dict(shape=mesh.shape, rank=mesh.rank, model_rank=mesh.model_rank,
               out=y.detach().numpy(), grads=grads(sharded))
    torch.distributed.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)


def spawn(fn, world: int, *args, timeout: float = 240.0) -> list:
    """Run ``fn(rank, world, port, *args, out)`` in ``world`` spawned
    processes; returns each rank's pickle.  A process still alive after
    ``timeout`` seconds is killed and fails the call."""
    import socket
    import tempfile
    import time

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        out = f"{d}/res"
        procs = [ctx.Process(target=fn, args=(r, world, port, *args, out)) for r in range(world)]
        for p in procs:
            p.start()
        end = time.time() + timeout
        for p in procs:
            p.join(max(end - time.time(), 0.0))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        if alive:
            raise TimeoutError(f"{len(alive)} rank(s) still running after {timeout} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks exited with {codes}")
        results = []
        for r in range(world):
            with open(f"{out}.{r}", "rb") as f:
                results.append(pickle.load(f))
    return results
