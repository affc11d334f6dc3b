"""CLI entry point of the port, the `weed`-style launcher (reference:
weed/weed.go:46-85, weed/command/server.go).

Counterpart of `seaweedfs_tpu/__main__.py`, with these subcommands:

  python -m seaweedfs_tpu_torch master -port 9333 [-peers a,b,c -mdir D]
  python -m seaweedfs_tpu_torch volume -dir /data -mserver host:9333 \\
      -port 8080 [-device cpu]
  python -m seaweedfs_tpu_torch server -dir /data [-volumePort 8080] \\
      [-device cpu] [-filer [-filerPort 8888]] \\
      [-s3 [-s3Port 8333] [-s3Config s3.json]] \\
      [-webdav [-webdavPort 7333]] [-mq [-mqPort 17777]]
                         # a master, one volume server (a filer, an S3
                         # gateway and a WebDAV gateway, each of which
                         # implies -filer, and an MQ broker) in one process
  python -m seaweedfs_tpu_torch filer -master host:9333 [-port 8888] \\
      [-dir D] [-notification.log F | -notification.webhook URL]
                         # the filer server, sqlite store in D, meta
                         # events published to a queue
  python -m seaweedfs_tpu_torch s3 -filer host:8888 [-port 8333] \\
      [-config s3.json]  # the S3 gateway; no -config allows all
  python -m seaweedfs_tpu_torch iam -filer host:8888 [-port 8111]
                         # the IAM API, identities in the filer
  python -m seaweedfs_tpu_torch webdav -filer host:8888 [-port 7333] \\
      [-filer.path /x]   # the WebDAV gateway
  python -m seaweedfs_tpu_torch mq.broker -master host:9333 [-port 17777]
                         # the MQ broker, registered with the master
  python -m seaweedfs_tpu_torch ftp -filer host:8888
                         # the FTP stub: exits 1 with the stub's text
  python -m seaweedfs_tpu_torch mount -filer host:8888 -dir /mnt \\
      [-filer.path /x]   # a FUSE mount (fusepy, else libfuse2)
  python -m seaweedfs_tpu_torch fuse SOURCE /mnt -o filer=host:8888
                         # the same, as /etc/fstab's mount(8) calls it
  python -m seaweedfs_tpu_torch master.follower -masters host:9333 \\
      [-port 9334]       # read-only lookups, writes proxied to the leader
  python -m seaweedfs_tpu_torch shell -master host:9333 [-c "cmd; cmd"]
  python -m seaweedfs_tpu_torch upload -master host:9333 FILE...
  python -m seaweedfs_tpu_torch download -master host:9333 [-dir D] FID...
  python -m seaweedfs_tpu_torch benchmark -master host:9333 [-n N]
  python -m seaweedfs_tpu_torch fix -dir D -volumeId N [-collection C]
  python -m seaweedfs_tpu_torch compact -dir D -volumeId N [-collection C]
  python -m seaweedfs_tpu_torch export -dir D -volumeId N -o out.tar
  python -m seaweedfs_tpu_torch backup -server host:8080 -volumeId N \\
      [-dir D]           # .dat and .idx from a volume server, resumed
  python -m seaweedfs_tpu_torch filer.sync -a host:8888 -b host:8889 \\
      [-filerPath /p] [-offsetFile F] [-oneway]   # keep two filers in step
  python -m seaweedfs_tpu_torch filer.replicate -filer host:8888 \\
      -notificationLog F -sink local:/dir|s3:endpoint=..,bucket=..|filer:h:p
  python -m seaweedfs_tpu_torch filer.backup -filer host:8888 -dir D
  python -m seaweedfs_tpu_torch filer.meta.backup -filer host:8888 \\
      -store sqlite:/path/meta.db
  python -m seaweedfs_tpu_torch filer.remote.sync -filer host:8888 \\
      -dir /mounted -remote s3:endpoint=..,bucket=..
  python -m seaweedfs_tpu_torch filer.remote.gateway -filer host:8888 \\
      -remote s3:endpoint=..
  python -m seaweedfs_tpu_torch filer.meta.tail -filer host:8888 [-timeAgo S]
  python -m seaweedfs_tpu_torch filer.cat -filer host:8888 /path [-o F]
  python -m seaweedfs_tpu_torch filer.copy -filer host:8888 SRC... /dir/
  python -m seaweedfs_tpu_torch scaffold -config filer|security|master|...
  python -m seaweedfs_tpu_torch certs [-dir ./certs] [-hosts a,b]
  python -m seaweedfs_tpu_torch version
  python -m seaweedfs_tpu_torch autocomplete

The master, the follower, the filer, the gateways, the mount, the
shell, the client tools, the filer's replication and client tools
(`filer.sync`, `filer.replicate`, `filer.backup`, `filer.meta.backup`,
`filer.remote.*`, `filer.meta.tail`, `filer.cat`, `filer.copy`) and the
offline tools (`fix`, `compact`, `export`, `backup`, on the port's
`storage/volume.py`) have no device and load no torch.  A volume server (`volume`, and `server`'s)
runs its codecs on the card unless `-device cpu` asks for the plain
versions; without a card and without `-device cpu` it raises.  `-cpuprofile FILE`
writes a cProfile dump when the process stops, `--torch-profile DIR` a
`torch.profiler` Chrome trace (the reference's `--jax-profile`; it loads
torch), and SIGUSR1 dumps every thread's stack
(utils/grace.py).  The MQ broker (`mq.broker`, and `server`'s `-mq`)
has no device and loads no torch either.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys


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
    """A master, one volume server, with `-filer` a filer, with `-s3` a
    filer and an S3 gateway, with `-webdav` a filer and a WebDAV gateway
    and with `-mq` an MQ broker in one process (reference: `_run_server`).
    The broker starts last and stops first."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    security = _security(args)
    m = _master(args, security)
    await m.start()
    v = VolumeServer(args.dir, m.url, args.ip, args.volumePort,
                     public_url=args.publicUrl, max_volumes=args.max,
                     data_center=args.dataCenter, rack=args.rack,
                     security=security, device=args.device)
    await v.start()
    f = s3 = dav = mq = None
    if args.filer or args.s3 or args.webdav:
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
    if args.webdav:
        from seaweedfs_tpu_torch.server.webdav_server import WebDavServer
        dav = WebDavServer(f.url, args.ip, args.webdavPort, security=security)
        await dav.start()
    if args.mq:
        from seaweedfs_tpu_torch.mq.broker import BrokerServer
        mq = BrokerServer(m.url, args.ip, args.mqPort)
        await mq.start()
    await _serve_forever()
    for srv in (mq, dav, s3, f):
        if srv is not None:
            await srv.stop()
    await v.stop()
    await m.stop()
    return 0


async def _run_mq_broker(args) -> int:
    from seaweedfs_tpu_torch.mq.broker import BrokerServer
    s = BrokerServer(args.master, args.ip, args.port)
    await s.start()
    await _serve_forever()
    await s.stop()
    return 0


async def _run_filer(args) -> int:
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    notification = None
    if args.notificationWebhook:
        from seaweedfs_tpu_torch.notification import WebhookQueue
        notification = WebhookQueue(args.notificationWebhook)
    elif args.notificationLog:
        from seaweedfs_tpu_torch.notification import LogQueue
        notification = LogQueue(args.notificationLog)
    f = FilerServer(args.master, args.ip, args.port, data_dir=args.dir,
                    collection=args.collection,
                    replication=args.defaultReplication,
                    chunk_size=args.maxMB << 20, security=_security(args),
                    encrypt_data=args.encryptVolumeData,
                    chunk_cache_disk=args.cacheCapacityMB << 20,
                    notification=notification, store_kind=args.store,
                    aggregate_peers=args.filerPeers)
    await f.start()
    await _serve_forever()
    await f.stop()
    if notification is not None:
        notification.close()
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


async def _run_webdav(args) -> int:
    from seaweedfs_tpu_torch.server.webdav_server import WebDavServer
    s = WebDavServer(args.filer, args.ip, args.port, prefix=args.filerPath,
                     security=_security(args))
    await s.start()
    await _serve_forever()
    await s.stop()
    return 0


def _run_ftp(args) -> int:
    from seaweedfs_tpu_torch.ftpd import FtpServer, FtpServerOption
    try:
        asyncio.run(FtpServer(FtpServerOption(
            args.filer, args.ip, args.port)).start())
    except NotImplementedError as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


def _run_mount(args) -> int:
    """`mount -filer -dir`, or `fuse SOURCE MOUNTPOINT -o filer=...`, the
    form mount(8) calls from /etc/fstab (reference: command/fuse.go)."""
    from seaweedfs_tpu_torch.mount.weedfs import mount
    if args.cmd == "fuse":
        # mount(8) passes the mountpoint positionally and config via -o
        opts = dict(p.partition("=")[::2]
                    for p in args.options.split(",") if p)
        filer = opts.get("filer", "127.0.0.1:8888")
        root = opts.get("filer.path", "/")
        target = args.mountpoint or args.source
        if not target:
            print("fuse: mountpoint required", file=sys.stderr)
            return 2
    else:
        filer, root, target = args.filer, args.filerPath, args.dir
    try:
        mount(filer, target, root=root)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


def _volume_name(args) -> str:
    return (f"{args.collection}_{args.volumeId}" if args.collection
            else str(args.volumeId))


def _run_fix(args) -> int:
    """Offline .idx reconstruction by scanning the .dat
    (reference: weed/command/fix.go:64 runFix)."""
    from seaweedfs_tpu_torch.storage import idx as idxf
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.volume import Volume

    name = _volume_name(args)
    dat = os.path.join(args.dir, name + ".dat")
    if not os.path.exists(dat):
        print(f"{dat} not found", file=sys.stderr)
        return 1
    idx_path = os.path.join(args.dir, name + ".idx")
    v = Volume(args.dir, args.collection, args.volumeId)
    try:
        # last write wins per needle id; a zero-size record is the
        # tombstone the delete path appends
        entries: dict[int, tuple[int, int]] = {}
        for offset, n in v.scan():
            if n.size == 0 and not n.data:
                entries.pop(n.id, None)
            else:
                entries[n.id] = (offset // t.NEEDLE_PADDING_SIZE, n.size)
        with open(idx_path + ".tmp", "wb") as f:
            for nid, (off_units, size) in sorted(entries.items()):
                f.write(idxf.pack_entry(nid, off_units, size))
        os.replace(idx_path + ".tmp", idx_path)
        print(f"rebuilt {idx_path}: {len(entries)} live entries")
        return 0
    finally:
        v.close()


def _run_compact(args) -> int:
    """Offline vacuum of one volume (reference: weed/command/compact.go)."""
    from seaweedfs_tpu_torch.storage.volume import Volume
    name = _volume_name(args)
    if not os.path.exists(os.path.join(args.dir, name + ".dat")):
        print(f"{name}.dat not found in {args.dir}", file=sys.stderr)
        return 1
    v = Volume(args.dir, args.collection, args.volumeId)
    try:
        before = v.data_size()
        ratio = v.garbage_ratio()
        v.compact()
        after = v.data_size()
        print(f"compacted volume {args.volumeId}: {before} -> {after} bytes "
              f"(garbage was {ratio:.1%})")
        return 0
    except PermissionError as e:
        print(str(e), file=sys.stderr)
        return 1
    finally:
        v.close()


def _run_export(args) -> int:
    """Export live needles of a volume into a tar file
    (reference: weed/command/export.go)."""
    import io
    import tarfile

    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.volume import Volume

    v = Volume(args.dir, args.collection, args.volumeId)
    count = 0
    try:
        with tarfile.open(args.output, "w") as tar:
            for offset, n in v.scan():
                # only the record the needle map points at is live; earlier
                # versions of an overwritten id are superseded
                live = v.nm.get(n.id)
                if not n.data or live is None or \
                        live[0] != offset // t.NEEDLE_PADDING_SIZE:
                    continue
                name = n.name.decode(errors="replace") or f"{n.id:x}"
                info = tarfile.TarInfo(name=f"{args.volumeId}/{n.id:x}_{name}")
                info.size = len(n.data)
                info.mtime = n.last_modified or 0
                tar.addfile(info, io.BytesIO(n.data))
                count += 1
    finally:
        v.close()
    print(f"exported {count} files to {args.output}")
    return 0


def _run_backup(args) -> int:
    """Pull a volume's .dat/.idx from a live volume server to a local dir
    (reference: weed/command/backup.go, via the server's /admin/file:
    the .dat resumes past the local copy's size with a Range request)."""
    import urllib.error
    import urllib.parse
    import urllib.request

    from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme

    name = _volume_name(args)
    os.makedirs(args.dir, exist_ok=True)
    for ext in (".dat", ".idx"):
        url = (f"{_tls_scheme()}://{args.server}/admin/file?"
               f"name={urllib.parse.quote(name + ext)}")
        out = os.path.join(args.dir, name + ext)
        # incremental: .dat is append-only, so resume past the local size
        # (reference: command/backup.go appends the remote tail)
        local_size = os.path.getsize(out) if ext == ".dat" and \
            os.path.exists(out) else 0
        headers = {"Range": f"bytes={local_size}-"} if local_size else {}
        try:
            req = urllib.request.Request(url, headers=headers)
            with urllib.request.urlopen(req, timeout=600) as r:
                mode = "ab" if local_size and r.status == 206 else "wb"
                target = out if mode == "ab" else out + ".tmp"
                with open(target, mode) as f:
                    while True:
                        chunk = r.read(1 << 20)
                        if not chunk:
                            break
                        f.write(chunk)
                if mode == "wb":
                    os.replace(out + ".tmp", out)
        except urllib.error.HTTPError as e:
            if e.code == 416 and local_size:  # already up to date
                print(f"{name}{ext}: up to date")
                continue
            try:
                os.remove(out + ".tmp")
            except OSError:
                pass
            print(f"backup {name}{ext} from {args.server}: HTTP {e.code}",
                  file=sys.stderr)
            return 1
        except urllib.error.URLError as e:
            print(f"backup: cannot reach {args.server}: {e}",
                  file=sys.stderr)
            return 1
        print(f"backed up {name}{ext} -> {out}")
    return 0


# the templates `scaffold` prints, the reference's own text
_SCAFFOLDS = {
    "filer": """\
# filer store configuration (reference: weed scaffold -config=filer)
[filer.options]
# directory to persist metadata; omit for in-memory
# dir = "/data/filer"

[memory]
enabled = false

[sqlite]
enabled = true
# dbFile = "/data/filer/filer.db"
""",
    "security": """\
# security.toml (reference: weed scaffold -config=security)
[jwt.signing]
key = ""
[jwt.signing.read]
key = ""
[jwt.filer.signing]
key = ""
[jwt.filer.signing.read]
key = ""
[access]
ui = false
[guard]
white_list = []

# cluster HTTPS/mTLS (reference wraps gRPC in mTLS, weed/security/tls.go);
# generate with: weedtpu certs -dir ./certs
[tls]
# ca = "certs/ca.crt"
# cert = "certs/server.crt"
# key = "certs/server.key"
# verify_client = true
""",
    "master": """\
# master.toml
[master.volume_growth]
copy_1 = 7
copy_2 = 6
copy_3 = 3
copy_other = 1
[master.maintenance]
garbage_threshold = 0.3
""",
    "replication": """\
# replication.toml (reference: weed scaffold -config=replication)
[source.filer]
enabled = true
grpcAddress = "localhost:8888"
directory = "/buckets"

[sink.filer]
enabled = false
grpcAddress = "localhost:8889"
directory = "/backup"

[sink.local]
enabled = false
directory = "/backup"
""",
    "notification": """\
# notification.toml (reference: weed scaffold -config=notification)
[notification.log]
enabled = false
path = "/tmp/filer_events.jsonl"

[notification.kafka]
enabled = false
hosts = ["kafka1:9092"]
topic = "seaweedfs_filer"
""",
    "shell": """\
# shell.toml
[cluster]
default = "localhost:9333"
""",
}


def _run_scaffold(args) -> int:
    print(_SCAFFOLDS[args.config], end="")
    return 0


def _run_version(args) -> int:
    """The package's version, and whether the host codec's library
    builds and loads (`native`, with GFNI where the CPU has it) and
    protobuf imports (`pb`), with the reference's fields."""
    import platform

    import seaweedfs_tpu_torch
    from seaweedfs_tpu_torch import native, pb
    try:
        impl = native.gf_impl()
    except (RuntimeError, OSError):
        impl = None
    print(f"weedtpu {seaweedfs_tpu_torch.__version__} "
          f"(python {platform.python_version()}, "
          f"native={'yes' if impl is not None else 'no'}"
          f"{', gfni' if impl == native.GF_IMPL_GFNI else ''}, "
          f"pb={'yes' if pb.available() else 'no'})")
    return 0


def _run_autocomplete(args, names) -> int:
    """A bash completion script over the parser's own subcommands
    (reference: weed autocomplete)."""
    cmds = " ".join(sorted(names))
    print(f"""_weedtpu_complete() {{
  local cur="${{COMP_WORDS[COMP_CWORD]}}"
  if [ "$COMP_CWORD" -eq 1 ]; then
    COMPREPLY=( $(compgen -W "{cmds}" -- "$cur") )
  fi
}}
complete -F _weedtpu_complete weedtpu""")
    return 0


def _run_certs(args) -> int:
    """A cluster CA and a node certificate and key under -dir, and the
    [tls] table for security.toml (security/tls.py)."""
    from seaweedfs_tpu_torch.security import tls
    table = tls.generate_certs(
        args.dir, [h.strip() for h in args.hosts.split(",") if h.strip()])
    print("[tls]")
    for k, v in table.items():
        val = str(v).lower() if isinstance(v, bool) else f'"{v}"'
        print(f"{k} = {val}")
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


def _run_filer_sync(args) -> int:
    from seaweedfs_tpu_torch.replication.filer_sync import FilerSync
    FilerSync(args.a, args.b, prefix=args.filerPath,
              offset_path=args.offsetFile,
              one_way=args.oneway).run_forever()
    return 0


def _run_filer_replicate(args) -> int:
    from seaweedfs_tpu_torch.replication.replicate_daemon import (
        LogFileSource, ReplicateDaemon, read_file_via_filer)
    from seaweedfs_tpu_torch.replication.sink import make_sink
    if args.sink.startswith("filer:"):
        sink = make_sink("filer", filer_url=args.sink[len("filer:"):])
    else:
        from seaweedfs_tpu_torch.remote_storage import parse_remote_spec
        kind, options = parse_remote_spec(args.sink)
        sink = make_sink(kind, **options)
    daemon = ReplicateDaemon(
        LogFileSource(args.notificationLog), sink,
        read_file_via_filer(args.filer), prefix=args.filerPath,
        offset_path=args.offsetFile)
    try:
        daemon.run()
    except KeyboardInterrupt:
        pass
    return 0


def _run_filer_remote_sync(args) -> int:
    from seaweedfs_tpu_torch.remote_storage import (make_remote,
                                                    parse_remote_spec,
                                                    remote_sync_loop)
    kind, options = parse_remote_spec(args.remote)
    remote = make_remote(kind, **options)
    try:
        remote_sync_loop(remote, args.filer, args.dir,
                         offset_file=args.offsetFile)
    except KeyboardInterrupt:
        pass
    return 0


def _run_filer_meta_backup(args) -> int:
    """Continuously replicate filer METADATA (entries incl. chunk refs,
    no blob content) into a local FilerStore, resumable via an offset kept
    in the store's own KV (reference: weed/command/filer_meta_backup.go —
    same restore story: point a filer at the backup store)."""
    import urllib.parse
    import urllib.request

    from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme

    from seaweedfs_tpu_torch.filer.entry import Entry
    from seaweedfs_tpu_torch.filer.filerstore import NotFound, make_store

    kind, _, opt = args.store.partition(":")
    if kind == "sqlite":
        from seaweedfs_tpu_torch.filer.abstract_sql import SqliteStore
        store = SqliteStore(opt)
    elif kind == "logstore":
        from seaweedfs_tpu_torch.filer.stores_extra import LogStore
        store = LogStore(opt)
    elif "=" in opt or not opt:
        # other store kinds take key=value options like remote specs; an
        # unparsed option string must never be silently dropped (it would
        # back up into the store's DEFAULT target)
        options = dict(p.partition("=")[::2]
                       for p in opt.split(",") if p)
        store = make_store(kind, **options)
    else:
        print(f"filer.meta.backup: cannot parse store spec "
              f"{args.store!r} (use kind:key=value,... or sqlite:/path "
              f"or logstore:/dir)", file=sys.stderr)
        return 2

    OFFSET_KEY = b"__meta_backup_offset__"
    CHECKPOINT_EVERY = 100  # events between offset commits
    since = 0
    if not args.restart:
        try:
            since = int(store.kv_get(OFFSET_KEY))
        except (NotFound, ValueError):
            since = 0
    if since == 0:
        # initial FULL traversal (reference: filer_meta_backup.go syncs
        # existing metadata first): the filer's event ring is bounded, so
        # subscribing from 0 alone would silently miss older entries
        import time as _time
        t0 = _time.time_ns()
        n = _meta_backup_traverse(args.filer, args.filerPath, store)
        since = t0 - 1
        store.kv_put(OFFSET_KEY, str(since).encode())
        print(f"filer.meta.backup: full sync copied {n} entr(ies); "
              f"tailing from there", flush=True)
    else:
        print(f"filer.meta.backup: resuming at offset {since}; tailing",
              flush=True)
    applied = 0
    dirty = 0
    try:
        while True:
            url = (f"{_tls_scheme()}://{args.filer}/__meta__/subscribe?"
                   + urllib.parse.urlencode({"since": str(since),
                                             "prefix": args.filerPath,
                                             "live": "true"}))
            try:
                with urllib.request.urlopen(url, timeout=3600) as r:
                    for raw in r:
                        line = raw.strip()
                        if not line:
                            continue
                        ev = json.loads(line)
                        old, new = ev.get("old_entry"), ev.get("new_entry")
                        if new is not None:
                            store.insert_entry(Entry.from_dict(new))
                            if old is not None and \
                                    old.get("full_path") != \
                                    new.get("full_path"):
                                try:
                                    store.delete_entry(old["full_path"])
                                except NotFound:
                                    pass
                        elif old is not None:
                            try:
                                store.delete_entry(old["full_path"])
                            except NotFound:
                                pass
                        applied += 1
                        dirty += 1
                        since = max(since, ev.get("ts_ns", since))
                        if dirty >= CHECKPOINT_EVERY:
                            store.kv_put(OFFSET_KEY, str(since).encode())
                            dirty = 0
            except OSError as e:
                import time as _time
                print(f"filer.meta.backup: subscribe to {args.filer} "
                      f"failed ({e}), retrying in 2s", file=sys.stderr)
                _time.sleep(2)
    except KeyboardInterrupt:
        print(f"filer.meta.backup: {applied} event(s) applied, "
              f"offset {since}")
    finally:
        store.kv_put(OFFSET_KEY, str(since).encode())
        if hasattr(store, "shutdown"):
            store.shutdown()
    return 0


def _meta_backup_traverse(filer: str, prefix: str, store) -> int:
    """Recursive listing walk copying every entry's metadata (incl. chunk
    refs) into the backup store."""
    import urllib.parse
    import urllib.request

    from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme

    from seaweedfs_tpu_torch.filer.entry import Entry

    n = 0
    stack = [prefix.rstrip("/") or "/"]
    while stack:
        d = stack.pop()
        url = (f"{_tls_scheme()}://{filer}"
               f"{urllib.parse.quote(d.rstrip('/') + '/')}?limit=100000")
        try:
            with urllib.request.urlopen(url, timeout=120) as r:
                listing = json.loads(r.read())
        except OSError:
            continue
        for e in listing.get("Entries") or []:
            full = e["FullPath"]
            try:
                with urllib.request.urlopen(
                        f"{_tls_scheme()}://{filer}"
                        f"{urllib.parse.quote(full)}?metadata=true",
                        timeout=120) as r:
                    meta = json.loads(r.read())
            except OSError:
                continue
            store.insert_entry(Entry.from_dict(meta))
            n += 1
            if e.get("IsDirectory"):
                stack.append(full)
    return n


def _run_filer_meta_tail(args) -> int:
    """Stream filer meta events as JSON lines (reference:
    weed/command/filer_meta_tail.go — same event shape, same fnmatch
    -pattern semantics: full-path match when the pattern contains '/')."""
    import fnmatch
    import time as _time
    import urllib.parse
    import urllib.request

    from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme

    since_ns = 0
    if args.timeAgo > 0:
        since_ns = int((_time.time() - args.timeAgo) * 1e9)
    until_ns = None
    if args.untilTimeAgo > 0:
        until_ns = int((_time.time() - args.untilTimeAgo) * 1e9)
        live = "false"
    else:
        live = "true"
    url = (f"{_tls_scheme()}://{args.filer}/__meta__/subscribe?"
           + urllib.parse.urlencode({"since": str(since_ns),
                                     "prefix": args.pathPrefix,
                                     "live": live}))

    def matches(ev: dict) -> bool:
        if not args.pattern:
            return True
        ent = ev.get("new_entry") or ev.get("old_entry") or {}
        full = ent.get("full_path", "")
        name = full.rsplit("/", 1)[-1]
        target = full if "/" in args.pattern else name
        return fnmatch.fnmatch(target, args.pattern)

    try:
        with urllib.request.urlopen(url, timeout=3600) as r:
            for raw in r:
                line = raw.strip()
                if not line:
                    continue
                ev = json.loads(line)
                if until_ns is not None and ev.get("ts_ns", 0) > until_ns:
                    break
                if matches(ev):
                    print(line.decode())
    except KeyboardInterrupt:
        pass
    return 0


def _run_filer_cat(args) -> int:
    """Stream one filer file to stdout / -o FILE (reference:
    weed/command/filer_cat.go)."""
    import shutil
    import urllib.parse
    import urllib.request

    from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme

    path = args.path if args.path.startswith("/") else "/" + args.path
    url = f"{_tls_scheme()}://{args.filer}{urllib.parse.quote(path)}"
    try:
        with urllib.request.urlopen(url, timeout=3600) as r:
            if args.output:
                with open(args.output, "wb") as f:
                    shutil.copyfileobj(r, f)
            else:
                shutil.copyfileobj(r, sys.stdout.buffer)
    except urllib.error.HTTPError as e:
        print(f"filer.cat: {path}: HTTP {e.code}", file=sys.stderr)
        return 1
    return 0


def _run_filer_copy(args) -> int:
    """Upload local files/directories into a filer directory (reference:
    weed/command/filer_copy.go — `weed filer.copy local... /target/dir/`)."""
    import os
    import urllib.parse
    import urllib.request

    from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme

    if len(args.sources) < 2:
        print("filer.copy: need SOURCE... TARGET_DIR", file=sys.stderr)
        return 1
    *sources, target = args.sources
    # accept both /dir and http://filer:port/dir target forms
    if "://" in target:
        parsed = urllib.parse.urlparse(target)
        filer, target = parsed.netloc, parsed.path or "/"
    else:
        filer = args.filer
    target = target.rstrip("/") + "/"

    def put(local: str, remote: str) -> None:
        size = os.path.getsize(local)
        with open(local, "rb") as f:
            # stream the file object: a multi-GB source must not be
            # buffered whole in this process (the filer chunks it anyway)
            req = urllib.request.Request(
                f"{_tls_scheme()}://{filer}{urllib.parse.quote(remote)}",
                data=f, method="POST",
                headers={"Content-Length": str(size)})
            with urllib.request.urlopen(req, timeout=600):
                pass
        print(f"copied {local} -> {remote} ({size} bytes)")

    n = 0
    for src in sources:
        if os.path.isdir(src):
            base = os.path.basename(src.rstrip("/"))
            for root, _, files in os.walk(src):
                rel = os.path.relpath(root, src)
                for fn in files:
                    dst = target + base + "/" + \
                        (fn if rel == "." else f"{rel}/{fn}")
                    put(os.path.join(root, fn), dst)
                    n += 1
        else:
            put(src, target + os.path.basename(src))
            n += 1
    print(f"filer.copy: {n} file(s) uploaded")
    return 0


def _run_filer_remote_gateway(args) -> int:
    """Mirror bucket-level events under -buckets.dir to the remote:
    creating a bucket in the filer creates it on the remote, deleting
    removes it, and object writes inside a bucket sync through the same
    event-applier filer.remote.sync uses (reference:
    weed/command/filer_remote_gateway.go)."""
    import urllib.parse
    import urllib.request

    from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme

    from seaweedfs_tpu_torch.remote_storage import make_remote, parse_remote_spec
    from seaweedfs_tpu_torch.replication.filer_sync import SyncOffsetStore

    kind, options = parse_remote_spec(args.remote)
    offsets = SyncOffsetStore(args.offsetFile)
    okey = f"remote-gateway:{args.remote}"
    buckets_dir = args.bucketsDir.rstrip("/")

    def bucket_remote(bucket: str):
        opt = dict(options)
        opt["bucket"] = bucket
        return make_remote(kind, **opt)

    while True:
        since = offsets.get(okey)
        url = (f"{_tls_scheme()}://{args.filer}/__meta__/subscribe?"
               + urllib.parse.urlencode({"since": str(since),
                                         "prefix": buckets_dir,
                                         "live": "true"}))
        try:
            with urllib.request.urlopen(url, timeout=3600) as r:
                for raw in r:
                    line = raw.strip()
                    if not line:
                        continue
                    ev = json.loads(line)
                    _apply_gateway_event(ev, buckets_dir, bucket_remote,
                                         args.filer)
                    offsets.put(okey, ev.get("ts_ns", since))
        except KeyboardInterrupt:
            offsets.flush()
            return 0
        except OSError:
            import time as _time
            _time.sleep(2)


def _apply_gateway_event(ev: dict, buckets_dir: str, bucket_remote,
                         filer: str) -> None:
    """One meta event -> remote bucket/object action."""
    from seaweedfs_tpu_torch.remote_storage import _apply_local_event_to_remote
    ent = ev.get("new_entry") or ev.get("old_entry") or {}
    full = ent.get("full_path", "")
    if not full.startswith(buckets_dir + "/"):
        return
    rel = full[len(buckets_dir) + 1:]
    bucket, _, inner = rel.partition("/")
    if not bucket:
        return
    remote = bucket_remote(bucket)
    if not inner:
        # bucket-level create/delete
        import stat as _stat
        is_dir = bool(ent.get("is_directory")) or _stat.S_ISDIR(
            (ent.get("attr") or {}).get("mode", 0))
        if not is_dir:
            return
        if ev.get("new_entry") is None and hasattr(remote, "delete_bucket"):
            remote.delete_bucket()
        elif ev.get("old_entry") is None and hasattr(remote, "create_bucket"):
            remote.create_bucket()
        return
    # object-level event inside the bucket: reuse the remote.sync applier
    _apply_local_event_to_remote(remote, filer, f"{buckets_dir}/{bucket}",
                                 ev, 60.0)


def _run_filer_backup(args) -> int:
    """One-way filer -> local directory mirror with resume offsets
    (reference: weed/command/filer_backup.go over the LocalSink)."""
    import threading

    from seaweedfs_tpu_torch.replication.filer_sync import (SyncDirection,
                                                      SyncOffsetStore)
    from seaweedfs_tpu_torch.replication.sink import LocalSink
    offsets = SyncOffsetStore(args.offsetFile)
    d = SyncDirection(args.filer, f"local:{args.dir}", prefix=args.filerPath,
                      offsets=offsets, sink=LocalSink(args.dir))
    try:
        d.run(threading.Event(), live=True)
    except KeyboardInterrupt:
        pass
    offsets.flush()
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
    ps.add_argument("-webdav", action="store_true",
                    help="also run the WebDAV gateway (implies -filer)")
    ps.add_argument("-webdavPort", type=int, default=7333)
    ps.add_argument("-mq", action="store_true",
                    help="also run the MQ broker")
    ps.add_argument("-mqPort", type=int, default=17777)
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
    pf.add_argument("-notification.log", dest="notificationLog", default=None,
                    help="append meta events to this JSONL file")
    pf.add_argument("-notification.webhook", dest="notificationWebhook",
                    default=None,
                    help="POST meta events to this HTTP endpoint")
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
    pfx = sub.add_parser("fix",
                         help="rebuild .idx from a .dat offline "
                              "(command/fix.go:64)")
    pfx.add_argument("-dir", required=True)
    pfx.add_argument("-volumeId", type=int, required=True)
    pfx.add_argument("-collection", default="")
    pcp = sub.add_parser("compact",
                         help="offline volume vacuum (command/compact.go)")
    pcp.add_argument("-dir", required=True)
    pcp.add_argument("-volumeId", type=int, required=True)
    pcp.add_argument("-collection", default="")
    pex = sub.add_parser("export",
                         help="export volume needles to a tar "
                              "(command/export.go)")
    pex.add_argument("-dir", required=True)
    pex.add_argument("-volumeId", type=int, required=True)
    pex.add_argument("-collection", default="")
    pex.add_argument("-o", dest="output", required=True, help="output .tar")
    pbk = sub.add_parser("backup",
                         help="incremental volume backup from a volume "
                              "server (command/backup.go)")
    pbk.add_argument("-server", required=True, help="volume server host:port")
    pbk.add_argument("-volumeId", type=int, required=True)
    pbk.add_argument("-collection", default="")
    pbk.add_argument("-dir", default=".")
    prs = sub.add_parser(
        "filer.remote.sync",
        help="continuously push local changes under a mounted dir to its "
             "remote (command/filer_remote_sync.go)")
    prs.add_argument("-filer", default="127.0.0.1:8888")
    prs.add_argument("-dir", required=True, help="mounted directory")
    prs.add_argument("-remote", required=True,
                     help="kind:spec, e.g. s3:endpoint=..,bucket=..")
    prs.add_argument("-offsetFile", default=None,
                     help="resume-offset persistence path")
    psy = sub.add_parser("filer.sync",
                         help="continuous filer A<->B sync (command/filer_sync.go)")
    psy.add_argument("-a", required=True, help="filer A host:port")
    psy.add_argument("-b", required=True, help="filer B host:port")
    psy.add_argument("-filerPath", default="/")
    psy.add_argument("-offsetFile", default=".filer_sync_offsets.json")
    psy.add_argument("-oneway", action="store_true")
    pmt2 = sub.add_parser(
        "filer.meta.tail",
        help="stream continuous meta changes on a filer as JSON lines "
             "(command/filer_meta_tail.go)")
    pmt2.add_argument("-filer", default="127.0.0.1:8888")
    pmt2.add_argument("-pathPrefix", default="/")
    pmt2.add_argument("-timeAgo", type=float, default=0.0,
                      help="start this many seconds before now")
    pmt2.add_argument("-untilTimeAgo", type=float, default=0.0,
                      help="stop after reaching this many seconds ago")
    pmt2.add_argument("-pattern", default="",
                      help="fnmatch on the file name (or full path when "
                           "it contains '/')")
    pct = sub.add_parser(
        "filer.cat",
        help="stream one filer file to stdout or -o FILE "
             "(command/filer_cat.go)")
    pct.add_argument("-filer", default="127.0.0.1:8888")
    pct.add_argument("-o", dest="output", default="",
                     help="write to file instead of stdout")
    pct.add_argument("path", help="file path on the filer")
    pcpy = sub.add_parser(
        "filer.copy",
        help="upload local files/directories to a filer path "
             "(command/filer_copy.go)")
    pcpy.add_argument("-filer", default="127.0.0.1:8888")
    pcpy.add_argument("sources", nargs="+",
                      help="local files/dirs, last arg = target filer dir")
    prg = sub.add_parser(
        "filer.remote.gateway",
        help="mirror bucket creation/deletion under -buckets.dir to the "
             "remote storage (command/filer_remote_gateway.go)")
    prg.add_argument("-filer", default="127.0.0.1:8888")
    prg.add_argument("-remote", required=True,
                     help="kind:spec of the remote (bucket field ignored; "
                          "buckets are created per filer bucket)")
    prg.add_argument("-buckets.dir", dest="bucketsDir", default="/buckets")
    prg.add_argument("-offsetFile", default=None)
    prp = sub.add_parser(
        "filer.replicate",
        help="consume filer meta events from a notification queue and "
             "apply them to a replication sink "
             "(command/filer_replicate.go)")
    prp.add_argument("-filer", default="127.0.0.1:8888",
                     help="filer to read file content from")
    prp.add_argument("-notificationLog", required=True,
                     help="JSONL file written by the filer's `log` "
                          "notification queue")
    prp.add_argument("-sink", required=True,
                     help="kind:spec, e.g. local:/mirror or "
                          "s3:endpoint=..,bucket=..,access_key=..,"
                          "secret_key=.. or filer:host:port")
    prp.add_argument("-filerPath", default="/",
                     help="only replicate events under this prefix")
    prp.add_argument("-offsetFile", default=".filer_replicate_offsets.json")
    pfb = sub.add_parser("filer.backup",
                         help="continuously mirror a filer subtree into a "
                              "local directory (command/filer_backup.go)")
    pfb.add_argument("-filer", required=True, help="source filer host:port")
    pfb.add_argument("-dir", required=True, help="local target directory")
    pfb.add_argument("-filerPath", default="/")
    pfb.add_argument("-offsetFile", default=".filer_backup_offsets.json")
    pmb = sub.add_parser(
        "filer.meta.backup",
        help="continuously back up filer METADATA (entries + chunk refs) "
             "into a local store (command/filer_meta_backup.go)")
    pmb.add_argument("-filer", default="127.0.0.1:8888")
    pmb.add_argument("-filerPath", default="/")
    pmb.add_argument("-store", required=True,
                     help="target store spec: sqlite:/path/meta.db or "
                          "logstore:/dir")
    pmb.add_argument("-restart", action="store_true",
                     help="resync from scratch instead of resuming")
    pwd = sub.add_parser("webdav",
                         help="WebDAV gateway over a filer (webdav_server.go)")
    pwd.add_argument("-ip", default="127.0.0.1")
    pwd.add_argument("-port", type=int, default=7333)
    pwd.add_argument("-filer", default="127.0.0.1:8888")
    pwd.add_argument("-filer.path", dest="filerPath", default="/")
    pmq = sub.add_parser("mq.broker",
                         help="message queue broker (weed/mq/broker)")
    pmq.add_argument("-ip", default="127.0.0.1")
    pmq.add_argument("-port", type=int, default=17777)
    pmq.add_argument("-master", default="127.0.0.1:9333")
    pft = sub.add_parser("ftp",
                         help="FTP gateway (stub, like the reference's "
                              "weed/ftpd)")
    pft.add_argument("-ip", default="127.0.0.1")
    pft.add_argument("-port", type=int, default=8021)
    pft.add_argument("-filer", default="127.0.0.1:8888")
    pmt = sub.add_parser("mount",
                         help="FUSE-mount a filer path "
                              "(weed/command/mount_std.go)")
    pmt.add_argument("-filer", default="127.0.0.1:8888")
    pmt.add_argument("-dir", required=True, help="mountpoint")
    pmt.add_argument("-filer.path", dest="filerPath", default="/")
    psc = sub.add_parser("scaffold",
                         help="print a config template "
                              "(command/scaffold.go:33)")
    psc.add_argument("-config", default="filer", choices=list(_SCAFFOLDS))
    # fstab-style alias for mount (reference: command/fuse.go lets
    # /etc/fstab say `weed fuse /mnt -o "filer=..."`)
    pfu = sub.add_parser(
        "fuse",
        help="fstab-style mount: `weedtpu fuse SOURCE MOUNTPOINT -o "
             "filer=host:port,filer.path=/x` (command/fuse.go)")
    pfu.add_argument("source", nargs="?", default="",
                     help="fstab device field (informational)")
    pfu.add_argument("mountpoint", nargs="?", default="")
    pfu.add_argument("-o", dest="options", default="",
                     help="comma-separated mount options: "
                          "filer=host:port, filer.path=/subdir")
    pver = sub.add_parser("version", help="print version and build info")
    pac = sub.add_parser(
        "autocomplete",
        help="print a bash completion script (source it or install to "
             "/etc/bash_completion.d)")
    pcrt = sub.add_parser(
        "certs", help="generate a cluster CA + node cert/key and print the "
                      "[tls] table for security.toml (security/tls.py)")
    pcrt.add_argument("-dir", default="./certs")
    pcrt.add_argument("-hosts", default="localhost,127.0.0.1",
                      help="comma-separated SAN hosts/IPs")
    for p in (p3, pi, pmf, psh, pb, pup, pdl, pfx, pcp, pex, pbk, prs, psy,
              pmt2, pct, pcpy, prg, prp, pfb, pmb, pwd, pmq, pft, pmt, psc,
              pfu, pver, pac, pcrt):
        _add_common_flags(p)
    args = ap.parse_args(argv)

    from seaweedfs_tpu_torch.utils import grace, weedlog
    weedlog.setup(args.v, args.logFile)
    grace.setup_stack_dumps()
    grace.setup_torch_profile(args.torchProfile, getattr(args, "device",
                                                         "cpu"))
    grace.setup_profiling(args.cpuprofile)
    # the bootstrap tools (and `version`, the diagnostic) run even where
    # the configured cert files are missing: they load no security.toml
    bootstrap = {"certs": _run_certs, "scaffold": _run_scaffold,
                 "version": _run_version,
                 "autocomplete": lambda a: _run_autocomplete(a, sub.choices)}
    if args.cmd in bootstrap:
        return bootstrap[args.cmd](args)
    sync = {"shell": _run_shell, "benchmark": _run_benchmark,
            "upload": _run_upload, "download": _run_download,
            "fix": _run_fix, "compact": _run_compact, "export": _run_export,
            "backup": _run_backup, "ftp": _run_ftp, "mount": _run_mount,
            "fuse": _run_mount, "filer.sync": _run_filer_sync,
            "filer.replicate": _run_filer_replicate,
            "filer.remote.sync": _run_filer_remote_sync,
            "filer.remote.gateway": _run_filer_remote_gateway,
            "filer.meta.tail": _run_filer_meta_tail,
            "filer.cat": _run_filer_cat, "filer.copy": _run_filer_copy,
            "filer.meta.backup": _run_filer_meta_backup,
            "filer.backup": _run_filer_backup}
    if args.cmd in sync:
        # the client tools load security.toml too, before any cluster URL
        # is built: the process-wide TLS
        _security(args)
        return sync[args.cmd](args)
    run = {"master": _run_master, "volume": _run_volume,
           "server": _run_server, "filer": _run_filer, "s3": _run_s3,
           "iam": _run_iam, "webdav": _run_webdav,
           "mq.broker": _run_mq_broker,
           "master.follower": _run_follower}[args.cmd]
    return asyncio.run(run(args))


if __name__ == "__main__":
    raise SystemExit(main())
