"""The device profiler of the port's process lifecycle helpers.

Counterpart of `seaweedfs_tpu/utils/grace.py`'s `jax_profile`:
`torch_profile` is a `torch.profiler` trace of the host and, on the card,
of every CUDA kernel and copy, written as a Chrome trace (open it in
chrome://tracing or Perfetto).  The shutdown hooks (`on_interrupt`), the
program-level profiler that writes its trace at exit
(`setup_jax_profile`'s counterpart), the stack dumps and the cProfile
hooks come with the CLI (ROADMAP 1.15a).
"""

from __future__ import annotations

import contextlib
import os
import time


def _activities(device):
    """CPU and CUDA activities for the card (None means the card, as the
    port's entry points do), CPU alone when the caller names the CPU."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device is None or torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _trace_path(trace_dir: str) -> str:
    os.makedirs(trace_dir, exist_ok=True)
    return os.path.join(trace_dir, f"torch_trace.{os.getpid()}."
                                   f"{time.time_ns()}.json")


@contextlib.contextmanager
def torch_profile(trace_dir: str | None, device=None):
    """A `torch.profiler.profile` over the block, its Chrome trace written
    into `trace_dir` when the block ends; yields the profiler (its
    `events()` and `key_averages()` stay readable after the block).
    Traces CPU and CUDA activity on the card, CPU activity only when
    `device` is the CPU.  A no-op yielding None for a falsy `trace_dir`,
    so a call site can pass its flag straight through.  Nothing is
    caught: a profiler that cannot start fails the caller."""
    if not trace_dir:
        yield None
        return
    import torch
    with torch.profiler.profile(activities=_activities(device)) as prof:
        yield prof
    prof.export_chrome_trace(_trace_path(trace_dir))
