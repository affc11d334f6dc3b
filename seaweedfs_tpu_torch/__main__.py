"""CLI entry point of the port, the `weed`-style launcher (reference:
weed/weed.go:46-85).

Counterpart of `seaweedfs_tpu/__main__.py`, cut to the `volume`
subcommand:

  python -m seaweedfs_tpu_torch volume -dir /data -mserver host:9333 \\
      -port 8080 [-device cpu]

The volume server runs its codecs on the card unless `-device cpu` asks
for the plain versions; without a card and without `-device cpu` it
raises.  `-cpuprofile FILE` writes a cProfile dump when the process
stops, `--torch-profile DIR` a `torch.profiler` Chrome trace (the
reference's `--jax-profile`), and SIGUSR1 dumps every thread's stack
(utils/grace.py).  The master, the shell and the other servers come with
ROADMAP 1.18 and 1.19.
"""

from __future__ import annotations

import argparse
import asyncio


def _add_common_flags(p):
    p.add_argument("-v", type=int, default=0, help="log verbosity")
    p.add_argument("-logFile", default=None)
    p.add_argument("-securityConfig", default=None,
                   help="security.toml path (default: standard search paths)")
    p.add_argument("-cpuprofile", default=None,
                   help="write a cProfile dump here on exit (grace/pprof.go)")
    p.add_argument("--torch-profile", dest="torchProfile", default=None,
                   help="write a torch.profiler trace into this directory "
                        "on exit (utils/grace.py; open it in Perfetto)")


def _security(args):
    from seaweedfs_tpu_torch.security.guard import SecurityConfig
    return SecurityConfig.load(args.securityConfig)


def _add_volume_flags(p):
    p.add_argument("-dir", action="append", required=True)
    p.add_argument("-publicUrl", default="")
    p.add_argument("-max", type=int, default=8)
    p.add_argument("-dataCenter", default="")
    p.add_argument("-rack", default="")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-mserver", default="127.0.0.1:9333")
    p.add_argument("-device", default=None,
                   help="where the codecs run: the card by default "
                        "(raising without one), `cpu` for the plain "
                        "versions")


async def _serve_forever():
    try:
        await asyncio.Event().wait()
    except (KeyboardInterrupt, asyncio.CancelledError):
        return


async def _run_volume(args) -> int:
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    # security.toml before any cluster URL is built: JWT keys and the
    # process-wide TLS (security/tls.py)
    security = _security(args)
    v = VolumeServer(args.dir, args.mserver, args.ip, args.port,
                     public_url=args.publicUrl, max_volumes=args.max,
                     data_center=args.dataCenter, rack=args.rack,
                     security=security, device=args.device)
    await v.start()
    await _serve_forever()
    await v.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="seaweedfs_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pv = sub.add_parser("volume")
    _add_volume_flags(pv)
    _add_common_flags(pv)
    args = ap.parse_args(argv)

    from seaweedfs_tpu_torch.utils import grace, weedlog
    weedlog.setup(args.v, args.logFile)
    grace.setup_stack_dumps()
    grace.setup_torch_profile(args.torchProfile, args.device)
    grace.setup_profiling(args.cpuprofile)
    return asyncio.run(_run_volume(args))


if __name__ == "__main__":
    raise SystemExit(main())
