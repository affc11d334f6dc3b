#!/usr/bin/env python3
"""Per-phase wall seconds of `chip_smoke.py`, for comparing two trees on
one host.

    python3 scripts/time_smoke.py --out ab_logs parent . . parent

Runs `python3 chip_smoke.py` from each directory in the order given, one
after another, stamps every line of its output with the seconds since
the run started, and splits the run into phases by the tag that opens
each line (`[build]`, `[encode cold]`, `[server] ...`).  Phases only
move forward: an untagged line, a `[path]` line, or a tag of an earlier
phase belongs to the phase it appears in.  Phase 10 runs in a child
process beside the records and phases 14 and 15, and its lines are
printed when the parent joins it, after phase 15's: its own seconds
show in none of the rows, and the parent's wait at the join counts in
phase 15's.  Phase 3 writes its volume while the kernels build: a wait
for it counts in phase 1's row.  A
phase's seconds run from the last line of the phase before it to its
own last line, so the phases add up to the run.  The same rule reads
every tree, whatever its script records of its own.  Each run's output
goes to `<out>/<i>_<name>.log`; one JSON line per run, then a table of
every phase over the runs, go to stdout.  Exits non-zero if a run did.

    python3 scripts/time_smoke.py --logs <out>/0_parent.log ...

reads the logs of such a run instead, running nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

# the first word of a line's tag -> the phase it opens, in run order
ORDER = ["device", "build", "kernel", "write", "encode", "degraded",
         "rebuild", "fleet", "scrub", "repair", "codecs", "native",
         "writer", "telemetry", "record", "store", "remote", "server",
         "maintenance", "admin", "mesh", "master", "planes", "heal",
         "shell", "filer", "filer-server", "s3", "webdav", "replication",
         "total"]
NAMES = ["0 start", "1 build", "2 kernel", "3 write", "4 encode",
         "5 degraded", "6 rebuild", "7 fleet", "8 scrub", "9 repair",
         "10 codecs", "11 native", "12 writer", "13 telemetry",
         "13r records", "14 store", "15 remote", "16 server",
         "17 maintenance", "18 admin", "19 mesh", "20 master",
         "21 planes", "22 heal", "23 shell", "24 filer",
         "25 filer server", "26 s3", "27 webdav", "28 replication",
         "29 report"]
TAG = re.compile(r"^\[([a-z0-9_-]+)")


def phase_seconds(stamped) -> dict:
    """Seconds per phase from (seconds since start, line) pairs."""
    ends: dict = {}
    at = 0
    for now, line in stamped:
        m = TAG.match(line)
        if m and m.group(1) in ORDER:
            at = max(at, ORDER.index(m.group(1)))
        ends[at] = now
    seconds, last = {}, 0.0
    for i in sorted(ends):
        seconds[NAMES[i]] = round(ends[i] - last, 3)
        last = ends[i]
    return seconds


def run(tree: str, log_path: str) -> dict:
    """One run of the tree's chip_smoke.py: its exit code, wall seconds
    and seconds per phase."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"],
                            cwd=tree, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    stamped = []
    with open(log_path, "w") as log:
        for line in proc.stdout:
            now = time.perf_counter() - t0
            log.write(f"{now:10.3f} {line}")
            stamped.append((now, line))
    rc = proc.wait()
    return {"tree": tree, "rc": rc,
            "wall_s": round(time.perf_counter() - t0, 3),
            "phase_s": phase_seconds(stamped)}


def read_log(path: str) -> dict:
    """A log `run` wrote: its seconds per phase."""
    stamped = []
    with open(path) as f:
        for raw in f:
            stamp, _, line = raw.lstrip().partition(" ")
            stamped.append((float(stamp), line))
    return {"tree": path, "rc": 0, "wall_s": stamped[-1][0],
            "phase_s": phase_seconds(stamped)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for the logs")
    ap.add_argument("--logs", action="store_true",
                    help="the arguments are logs of an earlier run")
    ap.add_argument("trees", nargs="+", help="checkouts to run, in order")
    args = ap.parse_args()
    if not args.logs and not args.out:
        ap.error("--out is needed to run the trees")
    runs = []
    for i, tree in enumerate(args.trees):
        if args.logs:
            rec = read_log(tree)
        else:
            os.makedirs(args.out, exist_ok=True)
            name = os.path.basename(os.path.abspath(tree))
            rec = run(tree, os.path.join(args.out, f"{i}_{name}.log"))
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    print("phase | " + " | ".join(os.path.basename(os.path.abspath(r["tree"]))
                                  for r in runs))
    for p in NAMES:
        if any(p in r["phase_s"] for r in runs):
            print(f"{p} | " + " | ".join(str(r["phase_s"].get(p, "-"))
                                         for r in runs))
    print("wall | " + " | ".join(str(r["wall_s"]) for r in runs))
    return int(any(r["rc"] for r in runs))


if __name__ == "__main__":
    sys.exit(main())
