"""CLI entry point of the port, the `weed`-style launcher (reference:
weed/weed.go:46-85, weed/command/server.go).

Counterpart of `seaweedfs_tpu/__main__.py`, cut to three subcommands:

  python -m seaweedfs_tpu_torch master -port 9333 [-peers a,b,c -mdir D]
  python -m seaweedfs_tpu_torch volume -dir /data -mserver host:9333 \\
      -port 8080 [-device cpu]
  python -m seaweedfs_tpu_torch server -dir /data [-volumePort 8080] \\
      [-device cpu]      # a master and one volume server in one process

The master has no device.  A volume server (`volume`, and `server`'s)
runs its codecs on the card unless `-device cpu` asks for the plain
versions; without a card and without `-device cpu` it raises.
`-cpuprofile FILE` writes a cProfile dump when the process stops,
`--torch-profile DIR` a `torch.profiler` Chrome trace (the reference's
`--jax-profile`), and SIGUSR1 dumps every thread's stack
(utils/grace.py).  The shell comes with ROADMAP 1.19a; `server`'s
`-filer`, `-s3`, `-webdav` and `-mq` with 1.20-1.22.
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


def _add_master_flags(p):
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=9333)
    p.add_argument("-volumeSizeLimitMB", type=int, default=30 * 1024)
    p.add_argument("-defaultReplication", default="000")
    p.add_argument("-peers", default="",
                   help="comma-separated master peers (raft HA), "
                        "including this node")
    p.add_argument("-mdir", default=None,
                   help="dir for raft state persistence")


def _add_volume_flags(p, with_master=True):
    p.add_argument("-dir", action="append", required=True)
    p.add_argument("-publicUrl", default="")
    p.add_argument("-max", type=int, default=8)
    p.add_argument("-dataCenter", default="")
    p.add_argument("-rack", default="")
    if with_master:
        # standalone volume server: its own ip/port + master address
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


def _master(args, security):
    from seaweedfs_tpu_torch.server.master import MasterServer
    peers = [p.strip() for p in args.peers.split(",")
             if p.strip()]
    return MasterServer(args.ip, args.port,
                        volume_size_limit=args.volumeSizeLimitMB << 20,
                        default_replication=args.defaultReplication,
                        security=security, peers=peers or None,
                        raft_state_dir=args.mdir)


async def _run_master(args) -> int:
    m = _master(args, _security(args))
    await m.start()
    await _serve_forever()
    await m.stop()
    return 0


async def _run_server(args) -> int:
    """A master and one volume server in one process (reference:
    `_run_server`, cut to those two)."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    security = _security(args)
    m = _master(args, security)
    await m.start()
    v = VolumeServer(args.dir, m.url, args.ip, args.volumePort,
                     public_url=args.publicUrl, max_volumes=args.max,
                     data_center=args.dataCenter, rack=args.rack,
                     security=security, device=args.device)
    await v.start()
    await _serve_forever()
    await v.stop()
    await m.stop()
    return 0


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
    pm = sub.add_parser("master")
    _add_master_flags(pm)
    _add_common_flags(pm)
    pv = sub.add_parser("volume")
    _add_volume_flags(pv)
    _add_common_flags(pv)
    ps = sub.add_parser("server")
    _add_master_flags(ps)
    _add_volume_flags(ps, with_master=False)
    ps.add_argument("-volumePort", type=int, default=8080)
    _add_common_flags(ps)
    args = ap.parse_args(argv)

    from seaweedfs_tpu_torch.utils import grace, weedlog
    weedlog.setup(args.v, args.logFile)
    grace.setup_stack_dumps()
    grace.setup_torch_profile(args.torchProfile, getattr(args, "device",
                                                         "cpu"))
    grace.setup_profiling(args.cpuprofile)
    run = {"master": _run_master, "volume": _run_volume,
           "server": _run_server}[args.cmd]
    return asyncio.run(run(args))


if __name__ == "__main__":
    raise SystemExit(main())
