"""Profiling: a trace context, a step timer, and kernel timing on the card.

``trace(log_dir)`` records a ``torch.profiler`` trace of its block (the
CPU, and the card where there is one) into ``log_dir`` as a Chrome trace
that TensorBoard's profiler plugin reads; ``StepTimer`` gives steps per
second after a warm-up (port of ``sciml_pde_tpu/utils/profiling.py``).

On the card: ``cuda_ms`` times a call in CUDA events (host issue
included); ``profiler_ms`` reads the device time of the kernels a call
launches from ``torch.profiler``.  ``chip_smoke.py`` and the experiments
that compare kernels on the card take every time from here.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Record a trace of the block into ``log_dir`` (a
    ``*.pt.trace.json`` Chrome trace, TensorBoard's layout)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


class StepTimer:
    """Wall-clock steps per second, the first ``warmup`` ticks discarded:
    the clock starts at the ``warmup``-th tick."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.count = 0
        self.t0 = None

    def tick(self):
        self.count += 1
        if self.count == self.warmup:
            self.t0 = time.perf_counter()

    @property
    def steps_per_sec(self) -> float:
        if self.t0 is None or self.count <= self.warmup:
            return float("nan")
        return (self.count - self.warmup) / (time.perf_counter() - self.t0)


def cuda_ms(fn, reps: int = 20) -> float:
    """ms per call of ``fn``: CUDA events around ``reps`` calls, after one."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def profiled_kernels(run) -> list:
    """The device kernels (torch.profiler's key_averages, CUDA rows) of a
    second call of ``run()``: the profiler records a first call as a warm-up
    and keeps only the second (on an H100 a session that kept what it
    recorded from its start read isolated kernels at 0.69-0.73 of their
    CUDA-event times at times, at 0.94 at others).  Each call ends
    synchronised."""
    from torch.profiler import ProfilerActivity, profile, schedule

    got = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda prof: got.append(prof.key_averages())) as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    # the schedule's step annotation comes back as a CUDA row too
    return [ev for ev in (got[0] if got else [])
            if ev.device_type.name == "CUDA" and not ev.key.startswith("ProfilerStep")]


def profiler_ms(fn, kernel_key: str = "", reps: int = 20, bound_ms: float = 0.0,
                sessions: int = 1, reasons: list | None = None):
    """Device time per call of ``fn`` in kernels whose name holds
    ``kernel_key`` (all of its device time by default), from torch.profiler
    over ``reps`` back-to-back calls (no host issue gaps; ``profiled_kernels``):
    the median of the first ``sessions`` profiler sessions that record a
    whole number of those kernels a call and a time at or above
    ``bound_ms``, the least time the card could take for the call.  None
    ("not measured") when fewer than that many of ``sessions + 2`` sessions
    in a row do: a session can come back empty on the card (twice in a row
    once) or with events lost, below the bound (0.0019 ms for a 0.00353 ms
    bound once).  ``fn`` may launch other kernels beside the timed ones, so
    that two kernels interleaved in one ``fn`` are read under the same
    conditions, each by its own key.  ``reasons``, where given, gets one
    line for each session that was not kept, saying why."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    got = []
    for _ in range(sessions + 2):
        evs = [ev for ev in profiled_kernels(run) if kernel_key in ev.key]
        us, count = sum(ev.self_device_time_total for ev in evs), sum(ev.count for ev in evs)
        if us > 0 and count % reps == 0 and us / reps / 1e3 >= bound_ms:
            got.append(us / reps / 1e3)
            if len(got) == sessions:
                return statistics.median(got)
        elif reasons is not None:
            reasons.append("no device time recorded" if us == 0 else
                           f"{count} kernels for {reps} calls" if count % reps else
                           f"{us / reps / 1e3:.5f} ms a call, below the bound {bound_ms:.5f}")
    return None
