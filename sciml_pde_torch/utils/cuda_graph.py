"""A fixed loop of device work replayed as a CUDA graph.

The simulators' inner loops (a plume frame's substeps, a run of airfoil
steps, a Burgers frame's substeps) issue hundreds of small PyTorch ops
with no host sync in between; issued one by one, their time on the card is
the host's.  ``graphed`` captures such a function once, on static copies of
its inputs, and replays it: the same kernels in the same order, so the
results of the eager calls, for one replay's cost on the host (the
counterpart of JAX compiling the loop into one program).
"""

from __future__ import annotations

import torch


def graphed(fn, *args: torch.Tensor):
    """``fn(*args)`` (CUDA tensors in, a tuple of CUDA tensors out, no host
    sync and no host-to-device copy inside) captured as a CUDA graph.
    Returns ``run(*args)``, which copies its arguments into the graph's
    inputs, replays it and returns the graph's outputs: buffers that the
    next replay overwrites, so a caller keeps what it needs by cloning.
    ``run`` holds ``fn``: the graph reads the tensors ``fn`` closes over
    (constants made outside it) at their addresses, so they must outlive
    every replay."""
    static = [a.clone() for a in args]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)  # warm-up: cached constants, FFT plans, library handles
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*static)

    def run(*a: torch.Tensor):
        for s, x in zip(static, a):
            s.copy_(x)
        graph.replay()
        return out

    run.fn = fn
    return run
