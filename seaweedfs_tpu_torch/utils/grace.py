"""Process lifecycle helpers: shutdown hooks, stack dumps, profiling.

Counterpart of `seaweedfs_tpu/utils/grace.py` (reference:
weed/util/grace/: signal_handling.go:26-65 runs registered cleanup hooks
on SIGINT/SIGTERM, pprof.go:11 SetupProfiling writes a cpu profile):
`on_interrupt` hooks run on SIGINT, SIGTERM or exit; SIGUSR1 dumps every
thread's stack (`setup_stack_dumps`); `setup_profiling` wraps the process
in cProfile (the CLI's `-cpuprofile`).  `torch_profile`, the counterpart
of `jax_profile`, is a `torch.profiler` trace of the host and, on the
card, of every CUDA kernel and copy, written as a Chrome trace (open it
in chrome://tracing or Perfetto); `setup_torch_profile` is its
program-level form (the CLI's `--torch-profile`), written when the
process stops.
"""

from __future__ import annotations

import atexit
import contextlib
import cProfile
import faulthandler
import io
import logging
import os
import signal
import sys
import threading
import time

log = logging.getLogger("grace")

_hooks: list = []
_installed = False
_profiler: cProfile.Profile | None = None


def on_interrupt(hook) -> None:
    """Register a cleanup hook, run on SIGINT, SIGTERM or at exit, the
    last registered first (reference: grace.OnInterrupt)."""
    _hooks.append(hook)
    _install()


def _run_hooks(signum=None, frame=None) -> None:
    # drain the list, so a signal's exit does not run them again at exit
    hooks, _hooks[:] = list(_hooks), []
    for hook in reversed(hooks):
        try:
            hook()
        except Exception:
            log.warning("shutdown hook failed", exc_info=True)
    if signum is not None:
        # the handler runs between any two bytecodes of the main thread:
        # a SystemExit raised here can land in a weakref callback, which
        # swallows it and leaves the process running (the reference's
        # sys.exit does), so the signal ends the process outright
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(128 + signum)


def _install() -> None:
    global _installed
    if _installed or threading.current_thread() is not threading.main_thread():
        return
    _installed = True
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _run_hooks)
    atexit.register(_run_hooks)


def setup_stack_dumps() -> None:
    """SIGUSR1 prints every thread's stack to stderr: what the process is
    doing (the reference's pprof goroutine dump).  A caller whose stderr
    is no file (the CLI run in process under a capturing test) gets no
    dump: there is nowhere to write one."""
    try:
        faulthandler.register(signal.SIGUSR1, all_threads=True)
    except io.UnsupportedOperation:
        pass


def setup_profiling(cpu_profile_path: str | None) -> None:
    """cProfile over the process, dumped to `cpu_profile_path` when it
    stops (reference: grace.SetupProfiling's cpu profile)."""
    global _profiler
    if not cpu_profile_path or _profiler is not None:
        return
    _profiler = cProfile.Profile()
    _profiler.enable()

    def dump():
        global _profiler
        if _profiler is not None:
            _profiler.disable()
            _profiler.dump_stats(cpu_profile_path)
            log.info("cpu profile written to %s", cpu_profile_path)
            _profiler = None
    on_interrupt(dump)


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


def setup_torch_profile(trace_dir: str | None, device=None) -> None:
    """The program-level `torch_profile` (the CLI's `--torch-profile`): a
    trace started now and written into `trace_dir` when the process
    stops."""
    if not trace_dir:
        return
    ctx = torch_profile(trace_dir, device)
    ctx.__enter__()
    log.info("torch profiler trace started -> %s", trace_dir)

    def stop():
        ctx.__exit__(None, None, None)
        log.info("torch profiler trace written to %s", trace_dir)
    on_interrupt(stop)
