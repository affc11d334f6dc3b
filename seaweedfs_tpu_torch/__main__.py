"""CLI entry point of the port, the `weed`-style launcher (reference:
weed/weed.go:46-85, weed/command/server.go).

Counterpart of `seaweedfs_tpu/__main__.py`, cut to these subcommands:

  python -m seaweedfs_tpu_torch master -port 9333 [-peers a,b,c -mdir D]
  python -m seaweedfs_tpu_torch volume -dir /data -mserver host:9333 \\
      -port 8080 [-device cpu]
  python -m seaweedfs_tpu_torch server -dir /data [-volumePort 8080] \\
      [-device cpu] [-filer [-filerPort 8888]] \\
      [-s3 [-s3Port 8333] [-s3Config s3.json]]
                         # a master, one volume server (a filer, and an
                         # S3 gateway, which implies -filer) in one process
  python -m seaweedfs_tpu_torch filer -master host:9333 [-port 8888] \\
      [-dir D]           # the filer server, sqlite store in D
  python -m seaweedfs_tpu_torch s3 -filer host:8888 [-port 8333] \\
      [-config s3.json]  # the S3 gateway; no -config allows all
  python -m seaweedfs_tpu_torch iam -filer host:8888 [-port 8111]
                         # the IAM API, identities in the filer
  python -m seaweedfs_tpu_torch master.follower -masters host:9333 \\
      [-port 9334]       # read-only lookups, writes proxied to the leader
  python -m seaweedfs_tpu_torch shell -master host:9333 [-c "cmd; cmd"]
  python -m seaweedfs_tpu_torch upload -master host:9333 FILE...
  python -m seaweedfs_tpu_torch download -master host:9333 [-dir D] FID...
  python -m seaweedfs_tpu_torch benchmark -master host:9333 [-n N]

The master, the follower, the filer, the S3 gateway, the IAM API, the
shell and the client tools have no device and load no torch.  A volume server (`volume`, and `server`'s)
runs its codecs on the card unless `-device cpu` asks for the plain
versions; without a card and without `-device cpu` it raises.  `-cpuprofile FILE`
writes a cProfile dump when the process stops, `--torch-profile DIR` a
`torch.profiler` Chrome trace (the reference's `--jax-profile`; it loads
torch), and SIGUSR1 dumps every thread's stack
(utils/grace.py).  `filer`'s `-notification.log` and
`-notification.webhook` come with ROADMAP 1.22a, `server`'s `-webdav`
and `-mq` with 1.21b-1.22b, the `webdav`, `mount` and `mq.broker`
subcommands with them, and `fix`, `compact`, `export`,
`backup`, `scaffold`, `version`, `autocomplete` and `certs` with 1.19c.
"""

from __future__ import annotations

import argparse
import asyncio
import json


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
    """A master, one volume server, with `-filer` a filer and with `-s3`
    a filer and an S3 gateway in one process (reference: `_run_server`,
    cut to those four)."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    security = _security(args)
    m = _master(args, security)
    await m.start()
    v = VolumeServer(args.dir, m.url, args.ip, args.volumePort,
                     public_url=args.publicUrl, max_volumes=args.max,
                     data_center=args.dataCenter, rack=args.rack,
                     security=security, device=args.device)
    await v.start()
    f = s3 = None
    if args.filer or args.s3:
        from seaweedfs_tpu_torch.server.filer_server import FilerServer
        f = FilerServer(m.url, args.ip, args.filerPort, data_dir=args.dir[0],
                        security=security)
        await f.start()
    if args.s3:
        from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
        s3 = S3ApiServer(f.url, args.ip, args.s3Port,
                         iam=_iam(args.s3Config), security=security,
                         master_url=m.url)
        await s3.start()
    await _serve_forever()
    for srv in (s3, f):
        if srv is not None:
            await srv.stop()
    await v.stop()
    await m.stop()
    return 0


async def _run_filer(args) -> int:
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    f = FilerServer(args.master, args.ip, args.port, data_dir=args.dir,
                    collection=args.collection,
                    replication=args.defaultReplication,
                    chunk_size=args.maxMB << 20, security=_security(args),
                    encrypt_data=args.encryptVolumeData,
                    chunk_cache_disk=args.cacheCapacityMB << 20,
                    store_kind=args.store, aggregate_peers=args.filerPeers)
    await f.start()
    await _serve_forever()
    await f.stop()
    return 0


def _iam(config):
    from seaweedfs_tpu_torch.s3.auth import IdentityAccessManagement
    return IdentityAccessManagement.from_file(config) if config \
        else IdentityAccessManagement()


async def _run_s3(args) -> int:
    from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
    s = S3ApiServer(args.filer, args.ip, args.port, iam=_iam(args.config),
                    security=_security(args))
    await s.start()
    await _serve_forever()
    await s.stop()
    return 0


async def _run_iam(args) -> int:
    from seaweedfs_tpu_torch.s3.iamapi_server import IamApiServer
    s = IamApiServer(args.filer, args.ip, args.port,
                     security=_security(args))
    await s.start()
    await _serve_forever()
    await s.stop()
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


async def _run_follower(args) -> int:
    from seaweedfs_tpu_torch.server.master_follower import MasterFollower
    _security(args)
    mf = MasterFollower(args.masters, host=args.ip, port=args.port)
    await mf.start()
    await _serve_forever()
    await mf.stop()
    return 0


def _run_benchmark(args) -> int:
    """Concurrent small-file write/read benchmark
    (reference: weed/command/benchmark.go:52-460)."""
    import concurrent.futures
    import time

    import numpy as np

    from seaweedfs_tpu_torch.client import WeedClient

    client = WeedClient(args.master)
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, args.size, dtype=np.uint8).tobytes()

    def write_one(i):
        t0 = time.perf_counter()
        fid = client.upload(payload, name=f"bench{i}")
        return fid, time.perf_counter() - t0

    t0 = time.perf_counter()
    fids, lat = [], []
    with concurrent.futures.ThreadPoolExecutor(args.concurrency) as ex:
        for fid, dt in ex.map(write_one, range(args.n)):
            fids.append(fid)
            lat.append(dt)
    wall = time.perf_counter() - t0
    lat_ms = sorted(x * 1e3 for x in lat)
    print(f"write: {args.n / wall:.1f} req/s, "
          f"{args.n * args.size / wall / 1e6:.2f} MB/s, "
          f"p50 {lat_ms[len(lat_ms)//2]:.2f}ms "
          f"p99 {lat_ms[int(len(lat_ms)*0.99)]:.2f}ms")

    def read_one(fid):
        t0 = time.perf_counter()
        data = client.download(fid)
        assert len(data) == args.size
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(args.concurrency) as ex:
        lat = list(ex.map(read_one, fids))
    wall = time.perf_counter() - t0
    lat_ms = sorted(x * 1e3 for x in lat)
    print(f"read:  {args.n / wall:.1f} req/s, "
          f"{args.n * args.size / wall / 1e6:.2f} MB/s, "
          f"p50 {lat_ms[len(lat_ms)//2]:.2f}ms "
          f"p99 {lat_ms[int(len(lat_ms)*0.99)]:.2f}ms")
    return 0


def _run_upload(args) -> int:
    import os

    from seaweedfs_tpu_torch.client import WeedClient
    client = WeedClient(args.master)
    results = []
    for path in args.files:
        with open(path, "rb") as f:
            data = f.read()
        fid = client.upload(data, name=os.path.basename(path),
                            collection=args.collection,
                            replication=args.replication)
        results.append({"fileName": os.path.basename(path), "fid": fid,
                        "size": len(data)})
    print(json.dumps(results, indent=1))
    return 0


def _run_download(args) -> int:
    import os

    from seaweedfs_tpu_torch.client import WeedClient
    client = WeedClient(args.master)
    for fid in args.fids:
        data = client.download(fid)
        out = os.path.join(args.dir, fid.replace(",", "_"))
        with open(out, "wb") as f:
            f.write(data)
        print(f"{fid} -> {out} ({len(data)} bytes)")
    return 0


def _run_shell(args) -> int:
    from seaweedfs_tpu_torch.shell.shell import repl
    return repl(args.master, args.script)


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
    ps.add_argument("-filer", action="store_true",
                    help="also run a filer (in-proc, sqlite store in -dir)")
    ps.add_argument("-filerPort", type=int, default=8888)
    ps.add_argument("-s3", action="store_true",
                    help="also run the S3 gateway (implies -filer)")
    ps.add_argument("-s3Port", type=int, default=8333)
    ps.add_argument("-s3Config", default=None)
    _add_common_flags(ps)
    pf = sub.add_parser("filer")
    pf.add_argument("-ip", default="127.0.0.1")
    pf.add_argument("-port", type=int, default=8888)
    pf.add_argument("-master", default="127.0.0.1:9333")
    pf.add_argument("-dir", default=None,
                    help="metadata dir (sqlite store); omit for in-memory")
    pf.add_argument("-collection", default="")
    pf.add_argument("-defaultReplication", default="")
    pf.add_argument("-maxMB", type=int, default=4)
    pf.add_argument("-peers", dest="filerPeers", action="store_true",
                    help="aggregate meta events from peer filers into this "
                         "filer's subscribe feed (meta_aggregator.go)")
    pf.add_argument("-store", default=None,
                    help="filer store driver (memory|sqlite|logstore|redis|"
                         "postgres|mysql; "
                         "default sqlite with -dir, memory without)")
    pf.add_argument("-encryptVolumeData", action="store_true",
                    help="AES-256-GCM encrypt chunks (cipher key in meta)")
    pf.add_argument("-cacheCapacityMB", type=int, default=0,
                    help="on-disk chunk cache size (0 = memory-only)")
    _add_common_flags(pf)
    p3 = sub.add_parser("s3")
    p3.add_argument("-ip", default="127.0.0.1")
    p3.add_argument("-port", type=int, default=8333)
    p3.add_argument("-filer", default="127.0.0.1:8888")
    p3.add_argument("-config", default=None,
                    help="s3.json identities file; omit = allow all")
    pi = sub.add_parser("iam")
    pi.add_argument("-ip", default="127.0.0.1")
    pi.add_argument("-port", type=int, default=8111)
    pi.add_argument("-filer", default="127.0.0.1:8888")

    pmf = sub.add_parser(
        "master.follower",
        help="read-only lookup-serving master follower "
             "(command/master_follower.go)")
    pmf.add_argument("-ip", default="127.0.0.1")
    pmf.add_argument("-port", type=int, default=9334)
    pmf.add_argument("-masters", default="127.0.0.1:9333",
                     help="comma-separated master list to track")
    psh = sub.add_parser("shell")
    psh.add_argument("-master", default="127.0.0.1:9333")
    psh.add_argument("-c", dest="script", default=None,
                     help="semicolon-separated commands; omit for a REPL")
    pb = sub.add_parser("benchmark")
    pb.add_argument("-master", default="127.0.0.1:9333")
    pb.add_argument("-n", type=int, default=10000)
    pb.add_argument("-size", type=int, default=1024)
    pb.add_argument("-c", type=int, dest="concurrency", default=16)
    pup = sub.add_parser("upload",
                         help="upload files via master assign "
                              "(command/upload.go)")
    pup.add_argument("-master", default="127.0.0.1:9333")
    pup.add_argument("-collection", default="")
    pup.add_argument("-replication", default="")
    pup.add_argument("files", nargs="+")
    pdl = sub.add_parser("download",
                         help="download blobs by fid (command/download.go)")
    pdl.add_argument("-master", default="127.0.0.1:9333")
    pdl.add_argument("-dir", default=".")
    pdl.add_argument("fids", nargs="+")
    for p in (p3, pi, pmf, psh, pb, pup, pdl):
        _add_common_flags(p)
    args = ap.parse_args(argv)

    from seaweedfs_tpu_torch.utils import grace, weedlog
    weedlog.setup(args.v, args.logFile)
    grace.setup_stack_dumps()
    grace.setup_torch_profile(args.torchProfile, getattr(args, "device",
                                                         "cpu"))
    grace.setup_profiling(args.cpuprofile)
    sync = {"shell": _run_shell, "benchmark": _run_benchmark,
            "upload": _run_upload, "download": _run_download}
    if args.cmd in sync:
        # the client tools load security.toml too, before any cluster URL
        # is built: the process-wide TLS
        _security(args)
        return sync[args.cmd](args)
    run = {"master": _run_master, "volume": _run_volume,
           "server": _run_server, "filer": _run_filer, "s3": _run_s3,
           "iam": _run_iam, "master.follower": _run_follower}[args.cmd]
    return asyncio.run(run(args))


if __name__ == "__main__":
    raise SystemExit(main())
