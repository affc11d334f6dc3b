"""Leveled verbosity logging in the style of the reference's vendored glog.

Counterpart of `seaweedfs_tpu/utils/weedlog.py`, whole.

Reference: weed/glog/glog.go — `glog.V(n).Infof(...)` gates chatty logs by a
`-v` flag; errors/warnings always print. Here `V(n)` returns a logger bound
to DEBUG when n <= the process verbosity, else a no-op, layered on stdlib
logging so handlers/formatting stay standard.

Per-module overrides mirror glog's `-vmodule`: `WEEDTPU_VMODULE=
ec_volume=2,http=1` (or `set_vmodule()`) raises the effective verbosity for
just those logger names, so trace-level logging can be turned on for one
subsystem without drowning the rest.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time

_verbosity = 0
_configured = False
_vmodule: dict[str, int] = {}


def set_vmodule(spec: str) -> None:
    """Parse a glog -vmodule spec (`name=level,name=level`).  Module names
    match the `name` argument of V().  Each named logger's stdlib level is
    pinned to DEBUG so its gated records pass even when the root logger
    sits at INFO; modules dropped from the spec revert to inheriting."""
    old = set(_vmodule)
    _vmodule.clear()
    for part in spec.split(","):
        name, sep, lvl = part.strip().partition("=")
        if not name or not sep:
            continue
        try:
            _vmodule[name] = int(lvl)
        except ValueError:
            continue
    for name in _vmodule:
        logging.getLogger(name).setLevel(logging.DEBUG)
    for name in old - set(_vmodule):
        logging.getLogger(name).setLevel(logging.NOTSET)


set_vmodule(os.environ.get("WEEDTPU_VMODULE", ""))


def setup(verbosity: int = 0, logfile: str | None = None) -> None:
    """Install the root handler (stderr or rotating file, glog_file.go)."""
    global _verbosity, _configured
    _verbosity = verbosity
    if _configured:
        return
    handler: logging.Handler
    if logfile:
        from logging.handlers import RotatingFileHandler
        handler = RotatingFileHandler(logfile, maxBytes=64 << 20, backupCount=5)
    else:
        handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(
        "%(levelname).1s%(asctime)s %(name)s %(filename)s:%(lineno)d] %(message)s",
        datefmt="%m%d %H:%M:%S"))
    root = logging.getLogger()
    root.addHandler(handler)
    # -vmodule does NOT raise the root level: set_vmodule pins the named
    # loggers to DEBUG and their records reach root's (level-less)
    # handler regardless — raising root would drown the log in every
    # third-party library's debug chatter
    root.setLevel(logging.DEBUG if verbosity > 0 else logging.INFO)
    _configured = True


def verbosity(name: str | None = None) -> int:
    """Process verbosity, or the effective verbosity for one module when
    a -vmodule override names it."""
    if name is not None and name in _vmodule:
        return _vmodule[name]
    return _verbosity


class _Noop:
    def infof(self, *a, **k): pass
    info = infof


class _V:
    def __init__(self, logger: logging.Logger):
        self._logger = logger

    def infof(self, fmt: str, *args, exc_info=None) -> None:
        self._logger.debug(fmt, *args, stacklevel=2, exc_info=exc_info)

    info = infof


_NOOP = _Noop()


def V(n: int, name: str = "weed"):
    """glog.V(n): chatty logging enabled only when -v >= n (or the module
    is raised to >= n via WEEDTPU_VMODULE / set_vmodule)."""
    if n <= _vmodule.get(name, _verbosity):
        return _V(logging.getLogger(name))
    return _NOOP


def info(fmt: str, *args, name: str = "weed", exc_info=None) -> None:
    """Always-on INFO line (glog.Infof): not gated by verbosity — used
    for operator-facing events like slow-request reports.  ``exc_info``
    forwards to stdlib logging (True inside an except block appends the
    traceback — background loops that must survive anything can still
    say where they failed)."""
    logging.getLogger(name).info(fmt, *args, stacklevel=2,
                                 exc_info=exc_info)


def warning(fmt: str, *args, name: str = "weed", exc_info=None) -> None:
    """Always-on WARNING line (glog.Warningf); ``exc_info`` as info()."""
    logging.getLogger(name).warning(fmt, *args, stacklevel=2,
                                    exc_info=exc_info)


# rate-limited warnings: key -> [monotonic ts of last emit, suppressed]
_rl_state: dict[str, list] = {}
_rl_lock = threading.Lock()
_RL_MAX_KEYS = 4096


def warn_ratelimited(key: str, interval_s: float, fmt: str, *args,
                     name: str = "weed") -> bool:
    """At most one WARNING per `key` per `interval_s` seconds — the
    hot-path guard: a single hot corrupt chunk served thousands of
    times a second must not storm the log with one line per read.
    Suppressed repeats are counted and reported on the next emitted
    line (`(N similar suppressed)`).  Returns True when the line was
    actually emitted."""
    now = time.monotonic()
    with _rl_lock:
        st = _rl_state.get(key)
        if st is not None and now - st[0] < interval_s:
            st[1] += 1
            return False
        suppressed = st[1] if st is not None else 0
        _rl_state[key] = [now, 0]
        if len(_rl_state) > _RL_MAX_KEYS:
            # keys can be client-influenced (per-volume, per-fid):
            # bound the table by dropping the stalest half
            for stale in sorted(_rl_state,
                                key=lambda q: _rl_state[q][0])[
                                    :_RL_MAX_KEYS // 2]:
                del _rl_state[stale]
    if suppressed:
        fmt += " (%d similar suppressed)"
        args = args + (suppressed,)
    logging.getLogger(name).warning(fmt, *args, stacklevel=2)
    return True
