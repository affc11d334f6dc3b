"""Admin shell command environment + commands.

Counterpart of `seaweedfs_tpu/shell/commands.py`, with all of its 95
commands: `help`, `lock`,
`unlock`, the `volume.*` commands with `volume.tier.move`, `.upload` and
`.download` (a volume's `.dat` to a `local`, `s3`, `gcs` or `azure`
remote and back), the `collection.*`, `ec.*` and `cluster.*` commands
with `cluster.geo` (the master's `/cluster/geo`), `maintenance.status`,
`chaos.status`, the 18 `fs.*` commands, which drive the first filer
registered with the master over its HTTP API (`volume.fsck` lists that
filer's tree too; `fs.meta.notify` needs a filer started with a
notification queue), the 7 `remote.*` commands, which mount, cache,
reconcile and unmount a remote store under that filer through
`remote_storage`, the 8 `s3.*` commands, which keep the gateways'
buckets, identities, quotas and circuit breaker in that filer, and
`mount.configure`, which talks to a running mount over its admin
socket, and the 4 `mq.*` commands, which configure, list and describe
the topics of the first broker registered with the master and show the
ring's partition layout.

The shell drives the cluster purely over the master/volume-server HTTP
APIs, holding the master's exclusive admin lock while mutating — same
operating model as the reference shell (weed/shell/commands.go:23-60,
command_ec_encode.go, command_ec_rebuild.go, command_ec_decode.go,
command_ec_balance.go), synchronous code for operator predictability.
It has no device and loads no torch: `ec.encode`, `ec.rebuild` and
`ec.decode` reach the card through the volume servers' /admin/ec routes,
and the codec tags come from `ops/codec_tags.py`.
"""

from __future__ import annotations

import json
import shlex
import urllib.parse
import urllib.request

from seaweedfs_tpu_torch.ops import codec_tags
from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme
from seaweedfs_tpu_torch.stats import netflow
from seaweedfs_tpu_torch.stats.history import FORECAST_CAP_S
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.ec import layout


class CommandEnv:
    def __init__(self, master: str):
        self.master = master
        self.lock_token: str | None = None
        self.cwd = "/"  # fs.cd / fs.pwd working directory

    def resolve(self, path: str) -> str:
        """Join a possibly-relative shell path against the REPL cwd."""
        if not path or path == ".":
            return self.cwd
        if not path.startswith("/"):
            path = self.cwd.rstrip("/") + "/" + path
        import posixpath
        return posixpath.normpath(path)

    # -- http helpers --------------------------------------------------

    def _call(self, url: str, body: dict | None = None,
              method: str | None = None, timeout: float = 600.0) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} \
            if body is not None else {}
        # byte-flow class: an ec.rebuild's shard copies must book as
        # class=repair whether the planner or an operator drove them
        netflow.inject(headers, "/" + url.partition("/")[2], "shell")
        req = urllib.request.Request(
            f"{_tls_scheme()}://{url}", data=data,
            method=method or ("POST" if body is not None else "GET"),
            headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                raw = r.read()
                return json.loads(raw) if raw else {}
        except urllib.error.HTTPError as e:
            try:
                err = json.loads(e.read()).get("error", str(e))
            except Exception:
                err = str(e)
            raise RuntimeError(f"{url}: {err}") from None

    def master_get(self, path: str, **params) -> dict:
        qs = ("?" + urllib.parse.urlencode(params)) if params else ""
        return self._call(f"{self.master}{path}{qs}")

    def master_post(self, path: str, body: dict | None = None, **params) -> dict:
        qs = ("?" + urllib.parse.urlencode(params)) if params else ""
        return self._call(f"{self.master}{path}{qs}", body or {})

    def vs_post(self, url: str, path: str, body: dict) -> dict:
        return self._call(f"{url}{path}", body)

    def master_get_raw(self, node_url: str, path: str, **params) -> dict:
        """GET a JSON endpoint on an arbitrary cluster node."""
        qs = ("?" + urllib.parse.urlencode(params)) if params else ""
        return self._call(f"{node_url}{path}{qs}")

    # -- filer helpers ---------------------------------------------------

    def find_filer(self) -> str:
        members = self.master_get("/cluster/status").get("Members", {})
        filers = members.get("filer", [])
        if not filers:
            raise RuntimeError("no filer registered with the master")
        return filers[0]

    def filer_list(self, filer: str, dir_path: str) -> list[dict]:
        d = dir_path.rstrip("/") + "/"
        r = self._call(f"{filer}{urllib.parse.quote(d)}?limit=100000")
        return r.get("Entries") or []

    def filer_read(self, filer: str, path: str) -> bytes:
        req = urllib.request.Request(
            f"{_tls_scheme()}://{filer}{urllib.parse.quote(path)}")
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.read()

    def filer_delete(self, filer: str, path: str,
                     recursive: bool = False) -> None:
        qs = "?recursive=true" if recursive else ""
        self._call(f"{filer}{urllib.parse.quote(path)}{qs}", method="DELETE")

    # -- lock -----------------------------------------------------------

    def acquire_lock(self, owner: str = "shell") -> None:
        if self.lock_token:
            return
        self.lock_token = self.master_post("/admin/lock", {"owner": owner})["token"]

    def release_lock(self) -> None:
        if self.lock_token:
            self.master_post("/admin/unlock", {"token": self.lock_token})
            self.lock_token = None

    def require_lock(self) -> None:
        if not self.lock_token:
            raise RuntimeError("this command requires `lock` first")

    # -- topology helpers -----------------------------------------------

    def topology(self) -> dict:
        return self.master_get("/cluster/status")["Topology"]

    def volume_locations(self, vid: int) -> list[str]:
        try:
            r = self.master_get("/dir/lookup", volumeId=str(vid))
        except RuntimeError:
            return []
        return [l["url"] for l in r.get("locations", [])]

    def ec_shard_locations(self, vid: int) -> dict[int, list[str]]:
        try:
            r = self.master_get("/dir/ec/lookup", volumeId=str(vid))
        except RuntimeError:
            return {}
        return {int(s): [l["url"] for l in locs]
                for s, locs in r.get("shards", {}).items()}


# ---- commands ---------------------------------------------------------

COMMANDS: dict[str, callable] = {}


def command(name):
    def deco(fn):
        COMMANDS[name] = fn
        return fn
    return deco


def parse_flags(args: list[str]) -> dict[str, str]:
    out = {}
    i = 0
    while i < len(args):
        a = args[i]
        if a.startswith("-"):
            key = a.lstrip("-")
            if "=" in key:
                k, _, v = key.partition("=")
                out[k] = v
            elif i + 1 < len(args) and not args[i + 1].startswith("-"):
                out[key] = args[i + 1]
                i += 1
            else:
                out[key] = "true"
        i += 1
    return out


@command("help")
def cmd_help(env: CommandEnv, args, out):
    """List commands, or show one command's doc: help [name]."""
    if args:
        fn = COMMANDS.get(args[0])
        if fn is None:
            print(f"unknown command {args[0]!r}", file=out)
            return
        import inspect
        doc = inspect.cleandoc(fn.__doc__) if fn.__doc__ else "(no help)"
        print(f"{args[0]}: {doc}", file=out)
        return
    for name in sorted(COMMANDS):
        doc = (COMMANDS[name].__doc__ or "").strip().splitlines()
        print(f"{name:28s} {doc[0] if doc else ''}", file=out)


@command("lock")
def cmd_lock(env: CommandEnv, args, out):
    env.acquire_lock()
    print("locked", file=out)


@command("unlock")
def cmd_unlock(env: CommandEnv, args, out):
    env.release_lock()
    print("unlocked", file=out)


@command("cluster.status")
def cmd_cluster_status(env: CommandEnv, args, out):
    print(json.dumps(env.master_get("/cluster/status"), indent=2), file=out)


@command("volume.list")
def cmd_volume_list(env: CommandEnv, args, out):
    topo = env.topology()
    for nid, node in sorted(topo["nodes"].items()):
        print(f"node {nid} dc={node['dc']} rack={node['rack']} "
              f"free={node['free_slots']}", file=out)
        for vid in node["volumes"]:
            print(f"  volume {vid}", file=out)
        for vid, shards in sorted(node["ec_shards"].items()):
            print(f"  ec volume {vid} shards {shards}", file=out)


@command("volume.vacuum")
def cmd_volume_vacuum(env: CommandEnv, args, out):
    env.require_lock()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    for url in env.volume_locations(vid):
        r = env.vs_post(url, "/admin/volume/vacuum", {"volume": vid})
        print(f"vacuumed {vid} on {url} (garbage was "
              f"{r.get('garbage_ratio', 0):.2%})", file=out)


@command("volume.delete")
def cmd_volume_delete(env: CommandEnv, args, out):
    env.require_lock()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    for url in env.volume_locations(vid):
        env.vs_post(url, "/admin/volume/delete", {"volume": vid})
        print(f"deleted {vid} on {url}", file=out)


@command("volume.mark")
def cmd_volume_mark(env: CommandEnv, args, out):
    env.require_lock()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    readonly = flags.get("writable", "false") != "true"
    for url in env.volume_locations(vid):
        env.vs_post(url, "/admin/volume/readonly",
                    {"volume": vid, "readonly": readonly})
        print(f"marked {vid} readonly={readonly} on {url}", file=out)


def balanced_ec_distribution(nodes: list[str],
                             racks: dict[str, str] | None = None,
                             n_shards: int = layout.TOTAL_SHARDS
                             ) -> dict[str, list[int]]:
    """Spread the volume's n shards rack-aware: each shard goes to the
    rack with the fewest shards so far, then the least-loaded node
    inside it — a rack loss never takes more shards than necessary
    (reference: command_ec_encode.go:272 balancedEcDistribution + the
    rack spread of command_ec_balance.go)."""
    racks = racks or {}
    alloc: dict[str, list[int]] = {n: [] for n in nodes}
    rack_of = {n: racks.get(n, n) for n in nodes}  # rackless: node = rack
    rack_load: dict[str, int] = {r: 0 for r in rack_of.values()}
    for sid in range(n_shards):
        # fewest-loaded rack, then fewest-loaded node within it; sorted
        # keys make ties deterministic
        rack = min(sorted(rack_load), key=lambda r: rack_load[r])
        target = min(sorted(n for n in nodes if rack_of[n] == rack),
                     key=lambda n: len(alloc[n]))
        alloc[target].append(sid)
        rack_load[rack] += 1
    return alloc


def parse_duration(s: str) -> float:
    """'1h' / '30m' / '45s' / plain seconds -> seconds."""
    s = s.strip()
    mult = {"s": 1, "m": 60, "h": 3600, "d": 86400}.get(s[-1:], None)
    if mult is not None:
        return float(s[:-1]) * mult
    return float(s)


def collect_volume_ids_for_ec_encode(topo: dict, collection: str,
                                     full_percent: float,
                                     quiet_seconds: float) -> list[int]:
    """Pick quiet+full candidate volumes from the topology snapshot
    (reference: command_ec_encode.go:290-321
    collectVolumeIdsForEcEncode).  Pure function over the snapshot, so
    it is testable without a cluster (SURVEY §4 topology-test pattern)."""
    import time as _time
    limit = topo.get("volume_size_limit", 0) or 0
    now = _time.time()
    vids: set[int] = set()
    for node in topo["nodes"].values():
        for v in node.get("volume_infos", []):
            if v.get("collection", "") != collection:
                continue
            if v.get("modified_at", 0) + quiet_seconds >= now:
                continue  # written too recently
            if limit and v.get("size", 0) <= full_percent / 100.0 * limit:
                continue  # not full enough
            vids.add(v["id"])
    return sorted(vids)


@command("ec.encode")
def cmd_ec_encode(env: CommandEnv, args, out):
    """Convert volumes to EC shards and spread them (reference:
    command_ec_encode.go:58-321).  With -volumeId, encodes that volume;
    without it, scans the topology for candidates that are at least
    -fullPercent full (default 95) and write-quiet for -quietFor
    (default 1h) — the reference's fleet-wide operational loop."""
    env.require_lock()
    flags = parse_flags(args)
    collection = flags.get("collection", "")
    codec = flags.get("codec", "")
    if "volumeId" in flags:
        vids = [int(flags["volumeId"])]
    else:
        full_percent = float(flags.get("fullPercent", "95"))
        quiet = parse_duration(flags.get("quietFor", "1h"))
        vids = collect_volume_ids_for_ec_encode(
            env.topology(), collection, full_percent, quiet)
        print(f"{len(vids)} volume(s) ≥{full_percent}% full and quiet "
              f"for {quiet:.0f}s: {vids}", file=out)
    for vid in vids:
        _ec_encode_one(env, vid, collection, out, codec=codec)


def _ec_encode_one(env: CommandEnv, vid: int, collection: str, out,
                   codec: str = ""):
    locations = env.volume_locations(vid)
    if not locations:
        raise RuntimeError(f"volume {vid} not found")
    source = locations[0]

    # 1. freeze writes on every replica
    for url in locations:
        env.vs_post(url, "/admin/volume/readonly", {"volume": vid, "readonly": True})
    # 2. generate shards on the source (TPU codec); -codec picks the
    # erasure-code family (rs/lrc/msr tag), default per WEEDTPU_CODEC_*
    spec = codec_tags.parse_tag(codec or codec_tags.default_tag())
    env.vs_post(source, "/admin/ec/generate",
                {"volume": vid, "collection": collection,
                 **({"codec": spec.tag} if codec else {})})
    print(f"generated {spec.n} {spec.tag} shards of volume {vid} "
          f"on {source}", file=out)

    # 3. spread shards over the cluster; copies fan out in parallel
    # (reference: command_ec_encode.go:213 parallelCopyEcShardsFromSource)
    import concurrent.futures
    topo = env.topology()
    nodes = sorted(topo["nodes"])
    racks = {nid: f"{nd['dc']}/{nd['rack']}"
             for nid, nd in topo["nodes"].items()}
    alloc = balanced_ec_distribution(nodes, racks, n_shards=spec.n)

    def place(target_shards):
        target, shards = target_shards
        if target != source:
            env.vs_post(target, "/admin/ec/copy",
                        {"volume": vid, "collection": collection,
                         "source": source, "shards": shards, "copy_ecx": True})
        env.vs_post(target, "/admin/ec/mount",
                    {"volume": vid, "collection": collection})
        return target, shards

    work = [(t, ss) for t, ss in alloc.items() if ss]
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        for target, shards in ex.map(place, work):
            print(f"  shards {shards} -> {target}", file=out)
    # 4. delete moved shard files from source, and the original volume
    moved = [s for tgt, ss in alloc.items() if tgt != source for s in ss]
    if moved:
        env.vs_post(source, "/admin/ec/delete_shards",
                    {"volume": vid, "shards": moved})
        env.vs_post(source, "/admin/ec/mount",
                    {"volume": vid, "collection": collection})
    for url in locations:
        env.vs_post(url, "/admin/volume/delete", {"volume": vid})
    print(f"ec.encode {vid} done", file=out)


@command("ec.rebuild")
def cmd_ec_rebuild(env: CommandEnv, args, out):
    """Rebuild missing shards (reference: command_ec_rebuild.go:58-281)."""
    env.require_lock()
    with netflow.flow("repair"):
        _ec_rebuild_all(env, out)


def _ec_rebuild_all(env: CommandEnv, out) -> None:
    topo = env.topology()
    ec_vids = {int(v) for node in topo["nodes"].values()
               for v in node["ec_shards"]}
    for vid in sorted(ec_vids):
        # the survivors' copies name the volume's collection, so that a
        # volume in one is rebuilt too (ROADMAP fault 3.9: the
        # reference's copies name none and cannot pull its shard files)
        col = topo.get("ec_collections", {}).get(str(vid), "")
        shard_locs = env.ec_shard_locations(vid)
        present = set(shard_locs)
        try:
            health = env.master_get("/maintenance/status")
            spec = codec_tags.parse_tag(
                (health.get("volumes", {}).get(str(vid)) or
                 {}).get("codec"))
        except RuntimeError:
            spec = codec_tags.parse_tag(None)
        missing = [s for s in range(spec.n) if s not in present]
        if not missing:
            continue
        if len(present) < spec.k:
            print(f"volume {vid}: only {len(present)} shards left, "
                  f"cannot rebuild", file=out)
            continue
        # rebuilder = node holding the most shards
        counts: dict[str, int] = {}
        for locs in shard_locs.values():
            for url in locs:
                counts[url] = counts.get(url, 0) + 1
        rebuilder = max(counts, key=counts.get)
        local = {s for s, locs in shard_locs.items() if rebuilder in locs}
        # pull missing survivors to the rebuilder
        borrowed = []
        for s, locs in shard_locs.items():
            if s in local:
                continue
            env.vs_post(rebuilder, "/admin/ec/copy",
                        {"volume": vid, "source": locs[0], "shards": [s],
                         "copy_ecx": False,
                         **({"collection": col} if col else {})})
            borrowed.append(s)
        r = env.vs_post(rebuilder, "/admin/ec/rebuild", {"volume": vid})
        env.vs_post(rebuilder, "/admin/ec/delete_shards",
                    {"volume": vid, "shards": borrowed})
        env.vs_post(rebuilder, "/admin/ec/mount", {"volume": vid})
        print(f"volume {vid}: rebuilt {r.get('rebuilt')} on {rebuilder}",
              file=out)


@command("ec.codecs")
def cmd_ec_codecs(env: CommandEnv, args, out):
    """List the registered erasure-codec family as configured right now
    (tag, geometry, sub-packetization, worst-case loss tolerance) plus
    the fleet's per-codec volume mix from the maintenance ledger.
    -json emits the raw spec rows."""
    flags = parse_flags(args)
    specs = [s.describe() for s in codec_tags.registered()]
    mix: dict[str, int] = {}
    try:
        st = env.master_get("/maintenance/status")
        for v in (st.get("volumes") or {}).values():
            if v.get("kind") == "ec":
                tag = codec_tags.parse_tag(v.get("codec")).tag
                mix[tag] = mix.get(tag, 0) + 1
    except RuntimeError:
        pass
    if "json" in flags:
        print(json.dumps({"codecs": specs, "default":
                          codec_tags.default_tag(), "mix": mix},
                         separators=(",", ":")), file=out)
        return
    print(f"default: {codec_tags.default_tag()}", file=out)
    for s in specs:
        extra = f" alpha={s['alpha']}" if s["alpha"] > 1 else ""
        print(f"{s['tag']:12s} family={s['family']:4s} k={s['k']:2d} "
              f"m={s['m']:2d} n={s['n']:2d}{extra} "
              f"tolerates={s['tolerance']} loss(es)"
              + (f"  volumes={mix[s['tag']]}" if s["tag"] in mix
                 else ""), file=out)
    stray = {t: c for t, c in mix.items()
             if t not in {s["tag"] for s in specs}}
    for tag, c in sorted(stray.items()):
        print(f"{tag:12s} (not in the configured family)  "
              f"volumes={c}", file=out)


@command("ec.decode")
def cmd_ec_decode(env: CommandEnv, args, out):
    """EC shards -> normal volume (reference: command_ec_decode.go:40-292).
    -collection defaults to the volume's own (ROADMAP fault 3.9)."""
    env.require_lock()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    collection = flags["collection"] if "collection" in flags else \
        env.topology().get("ec_collections", {}).get(str(vid), "")
    shard_locs = env.ec_shard_locations(vid)
    if not shard_locs:
        raise RuntimeError(f"no ec shards for volume {vid}")
    counts: dict[str, int] = {}
    for locs in shard_locs.values():
        for url in locs:
            counts[url] = counts.get(url, 0) + 1
    collector = max(counts, key=counts.get)
    local = {s for s, locs in shard_locs.items() if collector in locs}
    for s, locs in shard_locs.items():
        if s not in local and locs:
            env.vs_post(collector, "/admin/ec/copy",
                        {"volume": vid, "collection": collection,
                         "source": locs[0], "shards": [s], "copy_ecx": False})
    env.vs_post(collector, "/admin/ec/to_volume",
                {"volume": vid, "collection": collection})
    # drop shards everywhere
    all_nodes = {url for locs in shard_locs.values() for url in locs} | {collector}
    for url in all_nodes:
        env.vs_post(url, "/admin/ec/unmount", {"volume": vid})
        env.vs_post(url, "/admin/ec/delete_shards",
                    {"volume": vid,
                     "shards": sorted(set(range(layout.TOTAL_SHARDS)) |
                                      {int(s) for s in shard_locs})})
    print(f"ec.decode {vid} -> normal volume on {collector}", file=out)


@command("ec.balance")
def cmd_ec_balance(env: CommandEnv, args, out):
    """Even shard spread (reference: command_ec_balance.go, simplified to
    per-volume round-robin re-placement)."""
    env.require_lock()
    topo = env.topology()
    nodes = sorted(topo["nodes"])
    racks = {nid: f"{nd['dc']}/{nd['rack']}"
             for nid, nd in topo["nodes"].items()}
    ec_vids = {int(v) for node in topo["nodes"].values()
               for v in node["ec_shards"]}
    for vid in sorted(ec_vids):
        shard_locs = env.ec_shard_locations(vid)
        want = balanced_ec_distribution(nodes, racks)
        want_by_shard = {s: tgt for tgt, ss in want.items() for s in ss}
        for s, locs in shard_locs.items():
            tgt = want_by_shard.get(s)
            if tgt is None or tgt in locs:
                continue
            src = locs[0]
            env.vs_post(tgt, "/admin/ec/copy",
                        {"volume": vid, "source": src, "shards": [s],
                         "copy_ecx": True})
            env.vs_post(tgt, "/admin/ec/mount", {"volume": vid})
            env.vs_post(src, "/admin/ec/delete_shards",
                        {"volume": vid, "shards": [s]})
            env.vs_post(src, "/admin/ec/mount", {"volume": vid})
            print(f"volume {vid} shard {s}: {src} -> {tgt}", file=out)
    print("ec.balance done", file=out)


# ---- volume maintenance (reference: weed/shell/command_volume_*.go) ----


@command("volume.balance")
def cmd_volume_balance(env: CommandEnv, args, out):
    """Even out volume counts across nodes by moving volumes from the most
    to the least loaded (reference: command_volume_balance.go)."""
    env.require_lock()
    flags = parse_flags(args)
    apply = flags.get("force", "false") == "true" or \
        flags.get("apply", "false") == "true"
    topo = env.topology()
    counts = {nid: len(n["volumes"]) for nid, n in topo["nodes"].items()}
    if len(counts) < 2:
        print("volume.balance: nothing to do (single node)", file=out)
        return
    moves: list[tuple[int, str, str]] = []
    while True:
        hi = max(counts, key=counts.get)
        lo = min(counts, key=counts.get)
        if counts[hi] - counts[lo] <= 1:
            break
        movable = [v for v in topo["nodes"][hi]["volumes"]
                   if v not in set(topo["nodes"][lo]["volumes"])]
        if not movable:
            break
        vid = movable[0]
        moves.append((vid, hi, lo))
        topo["nodes"][hi]["volumes"].remove(vid)
        topo["nodes"][lo]["volumes"].append(vid)
        counts[hi] -= 1
        counts[lo] += 1
    cols = {vid: rec.get("collection", "")
            for vid, rec in collect_volume_infos(topo).items()}
    for vid, src, dst in moves:
        print(f"move volume {vid}: {src} -> {dst}"
              + ("" if apply else " (dry run, -apply to move)"), file=out)
        if apply:
            move_volume(env, vid, src, dst, cols.get(vid, ""))
    print(f"volume.balance: {len(moves)} move(s)"
          + ("" if apply else " planned"), file=out)


def move_volume(env: "CommandEnv", vid: int, source: str, target: str,
                collection: str = "") -> None:
    """Copy-then-delete volume move, the one protocol both volume.move and
    volume.balance use (reference: command_volume_move.go LiveMoveVolume).

    Live-safe: the bulk copy and tail drains run in STAGING mode — the
    target copy is read-only, hidden from heartbeats, and marked on disk,
    so neither lookups nor replicate fan-out can reach it and a crash
    mid-move can never boot it as live data. Then the source is frozen
    read-only, one finalizing catch-up closes the race window and flips
    the target live, and only then is the source deleted. If anything
    fails after the freeze, the source is made writable again before the
    error propagates (the reference rolls back the same way via a
    deferred VolumeMarkWritable, command_volume_move.go)."""
    import time as _time
    body = {"volume": vid, "source": source, "collection": collection,
            "staging": True}
    env.vs_post(target, "/admin/volume/copy", body)
    # drain the append tail while the source is still live; stop early
    # when the tail stops shrinking — the post-freeze copy closes whatever
    # remains, so chasing a write-hot volume here is wasted round-trips
    last = None
    for _ in range(10):
        r = env.vs_post(target, "/admin/volume/copy", body)
        appended = r.get("appended_bytes", 0)
        if appended == 0 or (last is not None and appended >= last):
            break
        last = appended
        _time.sleep(0.2)
    # freeze writes, then the finalizing catch-up closes the race window
    env.vs_post(source, "/admin/volume/readonly",
                {"volume": vid, "readonly": True})
    try:
        env.vs_post(target, "/admin/volume/copy",
                    dict(body, finalize=True))
    except Exception:
        # finalize failed: the target never went live, so re-enabling the
        # source is safe and restores service
        try:
            env.vs_post(source, "/admin/volume/readonly",
                        {"volume": vid, "readonly": False})
        except Exception:
            pass  # rollback is best-effort; the original error matters more
        raise
    # past this point the target IS live: never unfreeze the source (two
    # writable copies would silently diverge) — a failed delete leaves a
    # read-only source replica the operator can delete by hand
    env.vs_post(source, "/admin/volume/delete", {"volume": vid})


def collect_volume_infos(topo: dict) -> dict[int, dict]:
    """vid -> {collection, replica_placement, nodes: [node ids], ...} from
    the per-node volume_infos in a topology snapshot."""
    vols: dict[int, dict] = {}
    for nid, node in topo["nodes"].items():
        for vi in node.get("volume_infos", []):
            rec = vols.setdefault(vi["id"], dict(vi, nodes=[]))
            rec["nodes"].append(nid)
    return vols


@command("volume.fix.replication")
def cmd_volume_fix_replication(env: CommandEnv, args, out):
    """Re-replicate under-replicated volumes / purge over-replicated ones
    (reference: command_volume_fix_replication.go:36-55)."""
    env.require_lock()
    flags = parse_flags(args)
    apply = flags.get("apply", "false") == "true" or \
        flags.get("force", "false") == "true"
    topo = env.topology()
    fixed = 0
    for vid, rec in sorted(collect_volume_infos(topo).items()):
        nodes = rec["nodes"]
        rp = t.ReplicaPlacement.parse(rec.get("replica_placement", "000"))
        want = rp.copy_count
        if len(nodes) == want:
            continue
        if len(nodes) > want:
            for extra in nodes[want:]:
                print(f"volume {vid}: over-replicated, delete from {extra}"
                      + ("" if apply else " (dry run)"), file=out)
                if apply:
                    env.vs_post(extra, "/admin/volume/delete", {"volume": vid})
                fixed += 1
        else:
            targets = [nid for nid in topo["nodes"]
                       if nid not in nodes and
                       topo["nodes"][nid]["free_slots"] > 0]
            for dst in targets[: want - len(nodes)]:
                print(f"volume {vid}: under-replicated ({len(nodes)}/{want}), "
                      f"copy {nodes[0]} -> {dst}"
                      + ("" if apply else " (dry run)"), file=out)
                if apply:
                    with netflow.flow("replication"):
                        env.vs_post(dst, "/admin/volume/copy",
                                    {"volume": vid, "source": nodes[0],
                                     "collection":
                                     rec.get("collection", "")})
                fixed += 1
    print(f"volume.fix.replication: {fixed} action(s)"
          + ("" if apply else " planned"), file=out)


@command("volume.check.disk")
def cmd_volume_check_disk(env: CommandEnv, args, out):
    """Compare replicas of each volume by needle set and report divergence
    (reference: command_volume_check_disk.go)."""
    env.require_lock()
    topo = env.topology()
    locs: dict[int, list[str]] = {}
    for nid, node in topo["nodes"].items():
        for vid in node["volumes"]:
            locs.setdefault(vid, []).append(nid)
    issues = 0
    for vid, nodes in sorted(locs.items()):
        if len(nodes) < 2:
            continue
        sets = {}
        for url in nodes:
            r = env.master_get_raw(url, "/admin/volume/needles", volume=vid)
            sets[url] = set(r.get("needles", []))
        base = sets[nodes[0]]
        for url in nodes[1:]:
            if sets[url] != base:
                only_a = len(base - sets[url])
                only_b = len(sets[url] - base)
                print(f"volume {vid}: {nodes[0]} vs {url} differ "
                      f"(+{only_a}/-{only_b})", file=out)
                issues += 1
    print(f"volume.check.disk: {issues} divergent replica pair(s)", file=out)


@command("maintenance.status")
def cmd_maintenance_status(env: CommandEnv, args, out):
    """Cluster self-healing status from the master's health ledger:
    per-volume state (healthy/degraded/under_replicated/corrupt/critical),
    last-scrub time, quarantined ranges, and repair-planner state.
    -json emits the raw machine-readable ledger for CI assertions."""
    flags = parse_flags(args)
    st = env.master_get("/maintenance/status")
    if "json" in flags:
        print(json.dumps(st, separators=(",", ":")), file=out)
        return
    import datetime as _dt
    for vid, v in sorted(st.get("volumes", {}).items(),
                         key=lambda kv: int(kv[0])):
        if v.get("kind") == "ec":
            spec = codec_tags.parse_tag(v.get("codec"))
            present = v.get("shards_present", [])
            detail = f"{spec.tag} shards {len(present)}/{spec.n}"
            if v.get("shards_missing"):
                detail += f" missing {v['shards_missing']}"
            if v.get("corrupt"):
                detail += " corrupt " + str(
                    sorted({c.get('shard', -1) for c in v['corrupt']}))
            nq = sum(len(r) for q in (v.get("quarantined") or {}).values()
                     for r in q.values())
            if nq:
                detail += f" quarantined {nq} range(s)"
        else:
            detail = (f"replicas {len(v.get('replicas', []))}"
                      f"/{v.get('want_replicas', 1)}")
            if v.get("crc_mismatches"):
                detail += f" crc_mismatches {v['crc_mismatches']}"
        ls = v.get("last_scrub")
        scrub = _dt.datetime.fromtimestamp(ls).isoformat(" ", "seconds") \
            if ls else "never"
        print(f"volume {vid} [{v.get('kind')}]: {v.get('state'):16s} "
              f"{detail}  last-scrub {scrub}", file=out)
    states = st.get("states", {})
    print("states: " + " ".join(f"{k}={v}" for k, v in sorted(
        states.items()) if v), file=out)
    pl = st.get("planner", {})
    print(f"planner: tokens={pl.get('tokens')} active={pl.get('active')} "
          f"backoffs={len(pl.get('backoffs', {}))}", file=out)
    _print_repair_plane(pl, out)
    _print_slo(st.get("slo") or {}, out)
    _print_alerts(st.get("alerts") or {}, out)
    cap = st.get("capacity") or {}
    soon = [d for d in cap.get("disks", [])
            if d.get("predicted_full_seconds", FORECAST_CAP_S)
            < FORECAST_CAP_S]
    if soon:
        print("capacity: " + " ".join(
            f"{d['vs']}:{d['dir']}={_fmt_eta(d['predicted_full_seconds'])}"
            for d in soon[:5]), file=out)
    itf = st.get("interference") or {}
    gov = itf.get("governor") or {}
    if gov:
        rates = " ".join(
            f"{n}={t.get('rate'):g}/{t.get('ceiling'):g}"
            for n, t in sorted((gov.get("targets") or {}).items()))
        idx = " ".join(f"{c}={r.get('index'):g}" for c, r in
                       sorted((itf.get("classes") or {}).items()))
        print(f"governor: {'on' if gov.get('enabled') else 'OFF'} "
              f"retunes={gov.get('retunes', 0)} {rates}"
              + (f"  index: {idx}" if idx else ""), file=out)
    ge = st.get("geo") or {}
    if ge.get("directions"):
        # geo-replication one-liner (cluster.geo for the full observatory)
        dirs = " ".join(
            f"{d}={v.get('lag_s', 0):.2f}s"
            + ("[STALLED]" if v.get("stalled") else "")
            for d, v in sorted(ge["directions"].items()))
        wan = ge.get("wan") or {}
        print(f"geo: region={ge.get('region') or '-'} {dirs} "
              f"wan sent={_fmt_bytes(wan.get('sent_bytes', 0))} "
              f"recv={_fmt_bytes(wan.get('recv_bytes', 0))}", file=out)
    lp = st.get("loops") or {}
    if lp.get("headline"):
        # control-plane loops one-liner (cluster.loops for per-loop detail)
        print(f"loops: {lp['headline']}", file=out)


def _fmt_bytes(n: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if n >= div:
            return f"{n / div:.1f}{unit}"
    return f"{n:.0f}B"


def _print_repair_plane(pl: dict, out) -> None:
    """Reduced-read repair plane lines shared by maintenance.status and
    chaos.status: cross-rack budget state, repair bytes by locality
    class (the cluster.heat-style one-liner), and the last
    survivor-selection decisions."""
    xr = pl.get("xrack") or {}
    if xr:
        waiting = xr.get("waiting") or []
        print(f"xrack budget: {_fmt_bytes(xr.get('tokens', 0))} of "
              f"{_fmt_bytes(xr.get('burst_bytes', 0))} "
              f"(+{_fmt_bytes(xr.get('budget_bytes_per_s', 0))}/s)"
              + (f" waiting={waiting}" if waiting else ""), file=out)
    by_loc = pl.get("repair_bytes_by_locality") or {}
    if by_loc:
        print("repair bytes: " + " ".join(
            f"{name}={_fmt_bytes(by_loc[name])}"
            for name in ("node", "rack", "dc", "remote")
            if name in by_loc), file=out)
    for d in (pl.get("decisions") or [])[-3:]:
        helpers = " ".join(
            f"{h['node']}(loc{h['locality']}x{len(h['shards'])})"
            for h in d.get("helpers", []))
        actual = d.get("actual_bytes")
        print(f"  repair vid={d['vid']} {d['mode']:14s} "
              f"lost={d.get('lost')} via {helpers or '-'} "
              f"est={_fmt_bytes(d.get('est_remote_bytes', 0))}"
              + (f" actual={_fmt_bytes(actual)}"
                 if actual is not None else "")
              + (f" replans={d['replans']}" if d.get("replans") else "")
              + (f" naive={_fmt_bytes(d.get('naive_remote_bytes', 0))}"),
              file=out)


def _fmt_eta(s: float) -> str:
    for unit, div in (("d", 86400.0), ("h", 3600.0), ("m", 60.0)):
        if s >= div:
            return f"{s / div:.1f}{unit}"
    return f"{s:.0f}s"


def _print_alerts(alerts: dict, out) -> None:
    """Shared alert pretty-printer for maintenance.status /
    cluster.alerts: one line per rule, firing groups expanded."""
    if not alerts.get("rules"):
        return
    firing = [r for r in alerts["rules"] if r["state"] == "firing"]
    print(f"alerts: {alerts.get('state', 'ok')} "
          f"({len(firing)} rule(s) firing)", file=out)
    for r in alerts["rules"]:
        if r["state"] == "ok":
            continue
        for g in r.get("groups", []):
            if g["state"] == "ok":
                continue
            lbl = ",".join(f"{k}={v}" for k, v in
                           sorted(g.get("labels", {}).items())) or "-"
            val = "stale" if g.get("stale") else g.get("value")
            ex = f" trace={g['exemplar']}" if g.get("exemplar") else ""
            print(f"  {r['name']:24s} {g['state'].upper():8s} {lbl} "
                  f"value={val}{ex}", file=out)


def _print_slo(slo: dict, out) -> None:
    """Shared SLO pretty-printer for maintenance.status / cluster.slo:
    one line per rule with its per-window burn rates."""
    if not slo.get("rules"):
        return
    print(f"slo: {slo.get('state', 'unknown')} "
          f"(nodes={len(slo.get('nodes', []))} "
          f"scrape_errors={len(slo.get('scrape_errors', {}))})", file=out)
    for r in slo["rules"]:
        detail = " ".join(
            f"{w}:burn={win.get('burn_rate')}"
            + (f",p99={win['p99_ms']}ms" if win.get("p99_ms") is not None
               else "")
            for w, win in sorted(r.get("windows", {}).items()))
        if r["kind"] == "backlog":
            detail = f"value={r.get('value')}"
        print(f"  {r['name']:24s} {r['state']:9s} {detail}", file=out)


@command("cluster.slo")
def cmd_cluster_slo(env: CommandEnv, args, out):
    """Cluster SLO burn-rate status from the master's metrics aggregator
    (/cluster/slo): per-rule state + multi-window burn rates.
    -refresh forces a fleet /metrics pull first; -json emits the raw
    engine output for CI assertions."""
    flags = parse_flags(args)
    params = {"refresh": "1"} if "refresh" in flags else {}
    st = env.master_get("/cluster/slo", **params)
    if "json" in flags:
        print(json.dumps(st, separators=(",", ":")), file=out)
        return
    _print_slo(st, out)
    if not st.get("rules"):
        print(f"slo: {st.get('state', 'unknown')} (no data yet — "
              "try -refresh)", file=out)


@command("cluster.perf")
def cmd_cluster_perf(env: CommandEnv, args, out):
    """Fleet performance observatory (/cluster/perf): per-pipeline stage
    occupancy, the bottleneck verdict per pipeline kind (the stage whose
    busy fraction bounds throughput, with its achieved-vs-ceiling
    fraction when the resource's roofline is measured), the worst
    roofline offenders fleet-wide, and every node's tile-drift verdict.
    -top N offender rows (default 5); -json dumps the raw merge.
    Runbook: a bench trajectory regression names WHAT got slower —
    this names WHERE (stage + node + distance from the hardware)."""
    flags = parse_flags(args)
    st = env.master_get("/cluster/perf")
    if "json" in flags:
        print(json.dumps(st, separators=(",", ":")), file=out)
        return
    try:
        top_n = max(1, int(flags.get("top", "5")))
    except ValueError:
        top_n = 5
    print(f"perf: nodes={len(st.get('nodes', []))} "
          f"running={len(st.get('running', []))}"
          + (f" node_errors={len(st['node_errors'])}"
             if st.get("node_errors") else ""), file=out)
    occ = st.get("occupancy") or {}
    bns = st.get("bottlenecks") or {}
    for kind in sorted(occ):
        bn = bns.get(kind) or {}
        verdict = ""
        if bn:
            verdict = (f"  << bottleneck: {bn.get('stage')} "
                       f"busy={bn.get('busy_frac', 0):.0%}")
            if bn.get("ceiling_frac") is not None:
                verdict += (f" @ {bn['ceiling_frac']:.0%} of "
                            f"{bn.get('resource')} ceiling")
        print(f"{kind}:{verdict}", file=out)
        stages = occ[kind]
        for stage in sorted(stages,
                            key=lambda s: -stages[s]["busy_s"]):
            row = stages[stage]
            bar = "#" * min(20, int(20 * row["max_busy_frac"]))
            print(f"  {stage:16s} {row['busy_s']:9.3f}s busy "
                  f"[{bar:20s}] max={row['max_busy_frac']:.0%} "
                  f"{row['bytes'] / 1e9:8.3f} GB over "
                  f"{row['jobs']} jobs", file=out)
    offenders = (st.get("offenders") or [])[:top_n]
    if offenders:
        print("roofline offenders (furthest from their ceiling, "
              "busiest first):", file=out)
        for r in offenders:
            print(f"  {r.get('node', '?'):22s} {r['kernel']:14s} "
                  f"{r['resource']:6s} {r['achieved_gbps']:9.3f} GB/s "
                  f"= {r['ceiling_frac']:.0%} of "
                  f"{r.get('ceiling_gbps', 0):.3f}", file=out)
    for node, tile in sorted((st.get("tiles") or {}).items()):
        line = f"tile {node}: {tile.get('state')}"
        if tile.get("pinned_tile") is not None:
            line += (f" pinned={tile['pinned_tile']} "
                     f"best={tile.get('best_tile')} "
                     f"drift={tile.get('drift', 0):+.1%}")
        print(line, file=out)
    cx = st.get("codecs") or {}
    if cx.get("mix"):
        print("codecs: " + " ".join(
            f"{tag}={n}" for tag, n in sorted(cx["mix"].items()))
            + f" ({len(cx.get('volumes', {}))} ec volumes)", file=out)
    hot = st.get("hot_tier") or {}
    if hot:
        ev = hot.get("events") or {}
        ratio = hot.get("hit_ratio")
        print(f"hot tier: hit_ratio="
              + (f"{ratio:.1%}" if ratio is not None else "n/a")
              + f" local={ev.get('hit_local', 0)} "
              f"routed={ev.get('route_out', 0)} "
              f"served_for_peers={ev.get('route_in', 0)} "
              f"direct={ev.get('direct', 0)} "
              f"seeded={ev.get('seeded', 0)} "
              f"route_fail={ev.get('route_fail', 0)}", file=out)
        for n in hot.get("nodes") or []:
            nev = n.get("events") or {}
            vc = n.get("vid_cache") or {}
            print(f"  {n.get('node', '?'):22s} "
                  f"ring={len(n.get('ring') or [])} "
                  f"local={nev.get('hit_local', 0)} "
                  f"routed={nev.get('route_out', 0)} "
                  f"in={nev.get('route_in', 0)} "
                  f"vid_cache h/m={vc.get('hits', 0)}/"
                  f"{vc.get('misses', 0)}"
                  + (" stream" if n.get("vid_stream_live") else ""),
                  file=out)


@command("cluster.metrics")
def cmd_cluster_metrics(env: CommandEnv, args, out):
    """Dump the federated cluster exposition (/cluster/metrics): every
    node's /metrics merged with a `node` label per sample.  -refresh
    forces a fleet pull; -grep STR filters sample lines."""
    flags = parse_flags(args)
    qs = "?refresh=1" if "refresh" in flags else ""
    req = urllib.request.Request(
        f"{_tls_scheme()}://{env.master}/cluster/metrics{qs}")
    with urllib.request.urlopen(req, timeout=60) as r:
        text = r.read().decode("utf-8", "replace")
    needle = flags.get("grep")
    for line in text.splitlines():
        if needle and needle not in line:
            continue
        print(line, file=out)


@command("cluster.trace")
def cmd_cluster_trace(env: CommandEnv, args, out):
    """Cross-node trace waterfall.  `cluster.trace <trace_id>` stitches
    one trace id from every node's span ring into a parent-ordered tree
    with per-hop network time; with no id (optionally -min_ms N) it
    lists recent traces fleet-wide.  -json emits the raw assembly."""
    flags = parse_flags(args)
    tid = next((a for a in args if not a.startswith("-")
                and a not in flags.values()), None)
    if tid is None:
        qs = urllib.parse.urlencode(
            {"min_ms": flags.get("min_ms", "0"),
             "limit": flags.get("limit", "20")})
        listing = env.master_get(f"/cluster/traces?{qs}")
        for rec in listing.get("traces", []):
            mark = " ERR" if rec.get("error") else ""
            print(f"  {rec['trace_id']} {rec['ms']:10.1f}ms "
                  f"spans={rec['spans']:<4d} "
                  f"servers={','.join(rec['servers'])}{mark}", file=out)
        if not listing.get("traces"):
            print("no traces (raise the sample rate or lower -min_ms)",
                  file=out)
        return
    wf = env.master_get(f"/cluster/trace/{tid}")
    if "json" in flags:
        print(json.dumps(wf, separators=(",", ":")), file=out)
        return
    print(f"trace {wf['trace_id']}: {wf['ms']}ms, "
          f"{wf['span_count']} spans across "
          f"{', '.join(wf['servers']) or 'unknown servers'}"
          + (" [ERROR]" if wf.get("error") else ""), file=out)
    for sp in wf.get("spans", []):
        pad = "  " * (sp.get("depth", 0) + 1)
        net = f" net={sp['net_ms']}ms" if "net_ms" in sp else ""
        err = " ERR" if sp.get("error") else ""
        node = f" @{sp['node']}" if sp.get("node") else ""
        print(f"{pad}{sp['name']:<28s} {sp['ms']:9.2f}ms"
              f"{net}{node}{err}", file=out)


@command("cluster.canary")
def cmd_cluster_canary(env: CommandEnv, args, out):
    """Canary prober status (/cluster/canary): per-gateway-path probe
    outcomes, latency quantiles, and the pinned trace id of the last
    probe (feed it to cluster.trace).  -probe runs one round now;
    -json dumps the raw status."""
    flags = parse_flags(args)
    params = {"probe": "1"} if "probe" in flags else {}
    st = env.master_get("/cluster/canary", **params)
    if "json" in flags:
        print(json.dumps(st, separators=(",", ":")), file=out)
        return
    print(f"canary: interval={st.get('interval_s')}s "
          f"running={st.get('running')} "
          f"paths={','.join(st.get('enabled_paths', []))}", file=out)
    if not st.get("paths"):
        print("  no probes recorded yet (try -probe)", file=out)
    for path, rec in sorted(st.get("paths", {}).items()):
        p99 = f" p99={rec['p99_ms']:.1f}ms" if rec.get("p99_ms") else ""
        err = f" error={rec['error']}" if rec.get("error") else ""
        print(f"  {path:9s} {rec['outcome']:5s} {rec['ms']:8.1f}ms"
              f"{p99} trace={rec['trace_id']}{err}", file=out)


_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def _ascii_spark(points: list) -> str:
    """Unicode sparkline over [ts, value|None] points (gaps become
    spaces) — the terminal twin of the dashboard's SVG lines."""
    vals = [v for _, v in points if v is not None]
    if not vals:
        return "(no data)"
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        " " if v is None else
        _SPARK_CHARS[min(len(_SPARK_CHARS) - 1,
                         int((v - lo) / span * len(_SPARK_CHARS)))]
        for _, v in points)


@command("cluster.history")
def cmd_cluster_history(env: CommandEnv, args, out):
    """Range query over the master's embedded history store
    (/cluster/history).  cluster.history -series NAME [-labels k=v,k2=v2]
    [-range SECONDS] [-step SECONDS] [-agg min|max|last|sum|avg|rate|p99]
    [-refresh] [-json].  One sparkline per label set; `-agg p99` reads a
    histogram family's quantile over time (e.g. -series
    weedtpu_volume_request_seconds -agg p99).  Runbook: an alert names
    the series — this shows WHEN it started moving, and cluster.trace
    shows why."""
    flags = parse_flags(args)
    if "series" not in flags:
        raise RuntimeError("cluster.history requires -series NAME")
    params = {"series": flags["series"],
              "range": flags.get("range", "600")}
    for k in ("labels", "step", "agg"):
        if k in flags:
            params[k] = flags[k]
    if "refresh" in flags:
        params["refresh"] = "1"
    res = env.master_get("/cluster/history", **params)
    if "json" in flags:
        print(json.dumps(res, separators=(",", ":")), file=out)
        return
    print(f"{res['series']} agg={res['agg']} range="
          f"{int(res['end'] - res['start'] + res['step'])}s "
          f"step={res['step']:g}s"
          + (f" res={res['resolution_s']:g}s"
             if "resolution_s" in res else ""), file=out)
    for vec in res.get("vectors", []):
        lbl = ",".join(f"{k}={v}" for k, v in
                       sorted(vec["labels"].items())) or "(all)"
        pts = vec["points"]
        last = next((v for _, v in reversed(pts) if v is not None), None)
        last_s = "-" if last is None else f"{last:.4g}"
        print(f"  {lbl:44s} {_ascii_spark(pts)} {last_s}", file=out)
    if not res.get("vectors"):
        print("  no matching series (check -series/-labels; the store "
              "records on aggregator ticks — try -refresh)", file=out)


@command("cluster.alerts")
def cmd_cluster_alerts(env: CommandEnv, args, out):
    """Alert-rule engine state (/cluster/alerts): per-rule, per-label-set
    ok/pending/firing with hysteresis timestamps and the pinned exemplar
    trace of whatever fired.  -refresh runs one scrape+evaluate tick
    first; -json dumps the raw status.  Runbook: alert fires ->
    cluster.history -series <its series> (when did it start) ->
    cluster.trace <exemplar> (why)."""
    flags = parse_flags(args)
    params = {"refresh": "1"} if "refresh" in flags else {}
    st = env.master_get("/cluster/alerts", **params)
    if "json" in flags:
        print(json.dumps(st, separators=(",", ":")), file=out)
        return
    if not st.get("rules"):
        print("no alert rules configured (WEEDTPU_ALERT_RULES)", file=out)
        return
    print(f"alerts: {st.get('state', 'ok')}", file=out)
    for r in st["rules"]:
        n_fire = sum(1 for g in r.get("groups", [])
                     if g["state"] == "firing")
        print(f"  {r['name']:24s} {r['state']:8s} [{r['kind']}] "
              f"series={r['series']} window={r['window_s']:g}s "
              f"for={r['for_s']:g}s groups={len(r.get('groups', []))} "
              f"firing={n_fire}", file=out)
        for g in r.get("groups", []):
            if g["state"] == "ok":
                continue
            lbl = ",".join(f"{k}={v}" for k, v in
                           sorted(g.get("labels", {}).items())) or "-"
            val = "stale" if g.get("stale") else g.get("value")
            ex = f" trace={g['exemplar']}" if g.get("exemplar") else ""
            print(f"    {g['state'].upper():8s} {lbl} value={val}{ex}",
                  file=out)


@command("cluster.geo")
def cmd_cluster_geo(env: CommandEnv, args, out):
    """Geo-replication observatory (/cluster/geo): per sync direction,
    replication lag (seconds since the last applied event's mtime),
    source backlog depth, applied/skipped/error counters and the stall
    flag; plus the divergence auditor's verdict per prefix, WAN byte
    totals by region, registered peer masters, and the geo alert
    states.  -refresh runs one scrape tick first; -json dumps raw.
    Runbook: replication_stalled fires -> cluster.geo (which direction?
    backlog growing means the WAN link or the remote filer; errors
    growing with zero backlog means a poisoned event) -> cluster.trace
    <its last_trace_id> (where the apply died, which region's hop)."""
    flags = parse_flags(args)
    params = {"refresh": "1"} if "refresh" in flags else {}
    st = env.master_get("/cluster/geo", **params)
    if "json" in flags:
        print(json.dumps(st, separators=(",", ":")), file=out)
        return
    region = st.get("region") or "-"
    peers = ",".join(st.get("peers") or []) or "-"
    print(f"region: {region}  peer_masters: {peers}", file=out)
    dirs = st.get("directions") or {}
    if not dirs:
        print("no replication pumps reporting (FilerSync not running,"
              " or no scrape yet: try -refresh)", file=out)
    for d, rec in sorted(dirs.items()):
        stall = "  STALLED" if rec.get("stalled") else ""
        rate = rec.get("apply_rate_eps")
        rate_s = f" rate={rate:.2f}/s" if rate is not None else ""
        print(f"  {d:10s} lag={rec.get('lag_s', 0.0):8.2f}s "
              f"backlog={rec.get('backlog_events', 0.0):g} "
              f"applied={rec.get('applied', 0.0):g} "
              f"skipped={rec.get('skipped', 0.0):g} "
              f"errors={rec.get('errors', 0.0):g}"
              f"{rate_s}{stall}", file=out)
    div = st.get("divergence") or {}
    for prefix, v in sorted((div.get("prefixes") or {}).items()):
        verdict = "DIVERGED" if v else "clean"
        print(f"  divergence {prefix}: {verdict}", file=out)
    audits = div.get("audits") or {}
    if audits:
        print("  audits: " + " ".join(
            f"{k}={v:g}" for k, v in sorted(audits.items())), file=out)
    wan = st.get("wan") or {}
    print(f"  wan: sent={wan.get('sent_bytes', 0.0):g}B "
          f"recv={wan.get('recv_bytes', 0.0):g}B", file=out)
    for region_, by_dir in sorted((wan.get("by_region") or {}).items()):
        for direction, by_cls in sorted(by_dir.items()):
            tot = sum(by_cls.values())
            print(f"    -> {region_} {direction}={tot:g}B", file=out)
    alerts = st.get("alerts") or {}
    if alerts:
        print("  alerts: " + " ".join(
            f"{k}={v}" for k, v in sorted(alerts.items())), file=out)


@command("cluster.loops")
def cmd_cluster_loops(env: CommandEnv, args, out):
    """Control-plane observatory (/cluster/loops): per master background
    loop, tick wall time (last/EMA/max vs its interval), CPU seconds,
    items processed, backlog depth, overrun and error counts — plus
    live subsystem cardinality (registry/history/alert/interference/
    heat/trace entries).  -refresh runs one scrape tick first; -json
    dumps raw.  Runbook: loop_overrun fires -> cluster.loops (which
    loop, how far past its interval, does wall time track node count?)
    -> if it's the aggregator/fan-out plane, raise WEEDTPU_FANOUT_POOL;
    otherwise raise that loop's own interval knob or shed its input."""
    flags = parse_flags(args)
    params = {"refresh": "1"} if "refresh" in flags else {}
    st = env.master_get("/cluster/loops", **params)
    if "json" in flags:
        print(json.dumps(st, separators=(",", ":")), file=out)
        return
    print(f"loops: {st.get('headline', '')}", file=out)
    loops = st.get("loops") or {}
    for name, lp in sorted(loops.items()):
        iv = lp.get("interval")
        iv_s = f"{iv:g}s" if iv else "-"
        flag = ""
        if iv and lp.get("wall_last", 0.0) > iv:
            flag = "  OVERRUN"
        elif lp.get("overruns"):
            flag = f"  overruns={lp['overruns']}"
        err = lp.get("last_error")
        err_s = f"  last_error={err['error']}" if err else ""
        print(f"  {name:16s} ticks={lp.get('ticks', 0):<6d} "
              f"last={lp.get('wall_last', 0.0) * 1000:8.2f}ms "
              f"ema={lp.get('wall_ema', 0.0) * 1000:8.2f}ms "
              f"max={lp.get('wall_max', 0.0) * 1000:8.2f}ms "
              f"interval={iv_s:6s} cpu={lp.get('cpu_total', 0.0):.3f}s "
              f"items={lp.get('items_total', 0.0):g} "
              f"backlog={lp.get('backlog', 0.0):g}"
              f"{flag}{err_s}", file=out)
    subs = st.get("subsystems") or {}
    if subs:
        print("entries: " + " ".join(f"{k}={v}" for k, v in
                                     sorted(subs.items())), file=out)


@command("cluster.interference")
def cmd_cluster_interference(env: CommandEnv, args, out):
    """Live interference observatory + governor (/cluster/interference):
    per background traffic class, the fleet foreground-impact index
    (fractional foreground read-p99 inflation, worst node shown), the
    governed rates (repair cross-rack budget, conversion pacing, fleet
    scrub) against their floors/ceilings, and the last retune decisions
    with their pinned traces.  -refresh runs one scrape+observe+retune
    tick first; -json dumps raw.  Runbook: interference_high fires ->
    cluster.interference (which class, which node, is the rate at its
    floor) -> cluster.trace <retune trace_id> (what the governor did and
    when)."""
    flags = parse_flags(args)
    params = {"refresh": "1"} if "refresh" in flags else {}
    st = env.master_get("/cluster/interference", **params)
    if "json" in flags:
        print(json.dumps(st, separators=(",", ":")), file=out)
        return
    obs = st.get("interference") or {}
    gov = st.get("governor") or {}
    print(f"interference: {'on' if obs.get('enabled') else 'OFF'} "
          f"ticks={obs.get('ticks', 0)} · governor: "
          f"{'on' if gov.get('enabled') else 'OFF'} "
          f"target={gov.get('target_index')} "
          f"retunes={gov.get('retunes', 0)}", file=out)
    classes = obs.get("classes") or {}
    if classes:
        for cls, rec in sorted(classes.items()):
            print(f"  index {cls:12s} {rec.get('index', 0.0):7.4f}  "
                  f"worst {rec.get('node', '-')}", file=out)
    else:
        print("  no impact measured yet (quiet fleet or no baseline)",
              file=out)
    for name, t in sorted((gov.get("targets") or {}).items()):
        at = ""
        if t.get("rate", 0) <= t.get("floor", 0):
            at = "  [AT FLOOR]"
        elif t.get("rate", 0) >= t.get("ceiling", 0):
            at = "  [at ceiling]"
        print(f"  rate  {name:12s} {t.get('rate'):>12g} "
              f"(floor {t.get('floor'):g}, ceiling {t.get('ceiling'):g}, "
              f"class {t.get('class')}, index {t.get('index')}){at}",
              file=out)
    for d in (gov.get("decisions") or [])[-5:]:
        print(f"  retune {d.get('target'):12s} {d.get('direction'):4s} "
              f"{d.get('from'):g} -> {d.get('to'):g} "
              f"index={d.get('index')} trace={d.get('trace_id')}",
              file=out)
    nodes = obs.get("nodes") or {}
    for node, rec in sorted(nodes.items()):
        busy = {c: v for c, v in (rec.get("index") or {}).items()
                if v > 0.001}
        idx = " ".join(f"{c}={v:g}" for c, v in sorted(busy.items())) \
            or "-"
        print(f"  node {node}: quiet_p99="
              f"{rec.get('quiet_p99_ms')}ms last_p99="
              f"{rec.get('last_p99_ms')}ms index {idx}", file=out)


@command("cluster.autopilot")
def cmd_cluster_autopilot(env: CommandEnv, args, out):
    """Autopilot decision plane (/cluster/autopilot): mode
    (plan/execute/off), per-policy pacing buckets, hysteresis clocks,
    and the plan ledger with states and pinned trace ids.  -tick runs
    one policy pass first; -approve <id> executes one plan (the
    plan-mode runbook step); -abort <id> kills a not-yet-executing
    plan; -wait blocks until launched executions settle; -json dumps
    raw.  Runbook: cluster.autopilot -> inspect a plan's reason ->
    cluster.autopilot -approve <id> (or -abort) -> cluster.trace
    <trace_id> for the full planning+execution waterfall."""
    flags = parse_flags(args)
    body = {}
    if "tick" in flags:
        body["tick"] = True
    if "approve" in flags:
        body["approve"] = flags["approve"]
    if "abort" in flags:
        body["abort"] = flags["abort"]
    if "wait" in flags:
        body["wait"] = True
    if body:
        resp = env.master_post("/cluster/autopilot", body)
        st = resp.get("status") or {}
    else:
        resp = {}
        st = env.master_get("/cluster/autopilot")
    if "json" in flags:
        print(json.dumps(resp or st, separators=(",", ":")), file=out)
        return
    counts = st.get("states") or {}
    print(f"autopilot: mode={st.get('mode')} ticks={st.get('ticks', 0)} "
          f"actuator_calls={st.get('actuator_calls', 0)} · plans "
          + " ".join(f"{s}={counts.get(s, 0)}"
                     for s in ("planned", "approved", "executing",
                               "done", "aborted")), file=out)
    for name, b in sorted((st.get("buckets") or {}).items()):
        print(f"  bucket {name:8s} rate={b.get('rate_per_s'):g}/s "
              f"burst={b.get('burst'):g} tokens={b.get('tokens'):g}",
              file=out)
    hys = st.get("hysteresis") or {}
    cold = hys.get("cold_tracking") or {}
    if cold:
        line = " ".join(f"v{v}:{s:.0f}s" for v, s in
                        sorted(cold.items())[:8])
        print(f"  cold-tracking {line}", file=out)
    for p in (st.get("plans") or [])[-10:]:
        reason = p.get("reason") or {}
        why = " ".join(f"{k}={v}" for k, v in sorted(reason.items()))
        where = p.get("node") or (f"{p.get('source')} -> "
                                  f"{p.get('target')}"
                                  if p.get("source") else "")
        print(f"  {p.get('id'):>6s} {p.get('policy'):16s} "
              f"vid={p.get('vid')} [{p.get('state')}] {where} {why} "
              f"trace={p.get('trace_id')}", file=out)
        if p.get("error"):
            print(f"         error: {p['error']}", file=out)
    if resp.get("approved"):
        print(f"approved {resp['approved']['id']}", file=out)
    if resp.get("aborted"):
        print(f"aborted {resp['aborted']['id']}", file=out)


@command("chaos.status")
def cmd_chaos_status(env: CommandEnv, args, out):
    """Resilience-plane status: per-peer circuit-breaker states, the
    retry-budget fill, hedging config, armed chaos faults (partitions /
    injected latency / error rates / disk faults), and the canary's
    last outcomes — the operator's one-stop "what is broken vs what did
    we break on purpose" view.  -json dumps the raw snapshot.  Runbook:
    SLO burn alert -> cluster.canary (which path) -> cluster.trace
    (which hop) -> chaos.status (is a breaker open / a fault armed)."""
    flags = parse_flags(args)
    st = env.master_get("/maintenance/status")
    res = st.get("resilience") or {}
    try:
        canary = env.master_get("/cluster/canary")
    except RuntimeError:
        canary = {}
    pl = st.get("planner") or {}
    if "json" in flags:
        print(json.dumps({"resilience": res,
                          "states": st.get("states", {}),
                          "canary": canary.get("paths", {}),
                          "xrack": pl.get("xrack", {}),
                          "decisions": pl.get("decisions", []),
                          "repair_bytes_by_locality":
                              pl.get("repair_bytes_by_locality", {})},
                         separators=(",", ":")), file=out)
        return
    breakers = res.get("breakers") or {}
    if breakers:
        for peer, b in sorted(breakers.items()):
            extra = f" reopens_in={b['open_for_s']}s" \
                if "open_for_s" in b else ""
            print(f"breaker {peer}: {b.get('state'):9s} "
                  f"failures={b.get('failures')} trips={b.get('trips')}"
                  f"{extra}", file=out)
    else:
        print("breakers: all closed", file=out)
    budget = res.get("retry_budget") or {}
    classes = budget.get("classes") or {}
    print(f"retry budget: rate={budget.get('rate')}/s "
          f"burst={budget.get('burst')}"
          + ("".join(f" {c}={v}" for c, v in sorted(classes.items()))
             if classes else ""), file=out)
    print(f"hedge: pct={res.get('hedge_pct')}", file=out)
    faults = res.get("faults") or {}
    armed = [f"partition {a}<->{b}"
             for a, b in faults.get("partitions", [])]
    armed += [f"latency {d}={ms[0]}ms±{ms[1]}"
              for d, ms in (faults.get("latency_ms") or {}).items()]
    armed += [f"error_rate {d}={p}%"
              for d, p in (faults.get("error_rate") or {}).items()]
    if faults.get("shard_write_error"):
        armed.append(f"shard_write_error={faults['shard_write_error']}")
    print("faults: " + ("; ".join(armed) if armed else "none armed"),
          file=out)
    _print_repair_plane(pl, out)
    states = st.get("states", {})
    if any(v for k, v in states.items() if k != "healthy"):
        print("volume states: " + " ".join(
            f"{k}={v}" for k, v in sorted(states.items()) if v),
            file=out)
    for path, rec in sorted((canary.get("paths") or {}).items()):
        print(f"canary {path:9s} {rec.get('outcome'):5s} "
              f"{rec.get('ms', 0):8.1f}ms trace={rec.get('trace_id')}",
              file=out)


@command("cluster.heat")
def cmd_cluster_heat(env: CommandEnv, args, out):
    """Fleet workload heat (/cluster/heat): top-K hot chunks, volumes,
    and tenants from the decayed streaming sketches, with estimated RPS,
    byte rates, read/write mix, and per-volume degraded-read fraction.
    -refresh forces a fresh fleet fan-out; -top N rows per dimension
    (default 10); -json dumps the raw merge.  Runbook: an SLO burn alert
    names the symptom — this names the tenant/volume driving it, and
    cluster.trace shows where its requests spend their time."""
    flags = parse_flags(args)
    params = {"refresh": "1"} if "refresh" in flags else {}
    st = env.master_get("/cluster/heat", **params)
    if "json" in flags:
        print(json.dumps(st, separators=(",", ":")), file=out)
        return
    try:
        top_n = max(1, int(flags.get("top", "10")))
    except ValueError:
        top_n = 10
    print(f"heat: k={st.get('k')} halflife={st.get('halflife_s')}s "
          f"nodes={len(st.get('nodes', []))}"
          + (f" node_errors={len(st['node_errors'])}"
             if st.get("node_errors") else ""), file=out)
    for dim in ("chunks", "volumes", "tenants"):
        d = st.get(dim, {})
        rows = d.get("top", [])[:top_n]
        print(f"{dim}: total ~{d.get('total_rps', 0)} rps", file=out)
        if not rows:
            print("  (no samples yet)", file=out)
            continue
        for r in rows:
            extras = []
            if r.get("read_fraction") is not None:
                extras.append(f"read%={100 * r['read_fraction']:.0f}")
            if r.get("degraded_fraction") is not None:
                extras.append(
                    f"degraded%={100 * r['degraded_fraction']:.1f}")
            print(f"  {r['key']:32s} ~{r['rps']:9.2f} rps "
                  f"~{r['bytes_rate'] / 1e6:8.3f} MB/s "
                  f"(est={r['est']:.1f}±{r['err']:.1f}) "
                  + " ".join(extras), file=out)


@command("volume.fsck")
def cmd_volume_fsck(env: CommandEnv, args, out):
    """Cross-check filer chunk references against volume needles
    (reference: command_volume_fsck.go:60-75).  Reports orphan needles
    (in volumes but unreferenced) and broken refs (referenced but gone).
    -json emits a machine-readable report including each volume's health
    state, last-scrub time, and quarantined ranges from the master's
    maintenance ledger."""
    env.require_lock()
    flags = parse_flags(args)
    as_json = "json" in flags
    filer = env.find_filer()
    # collect all chunk fids from the filer
    referenced: dict[int, set[int]] = {}
    stack = ["/"]
    while stack:
        d = stack.pop()
        listing = env.filer_list(filer, d)
        for e in listing:
            if e.get("IsDirectory"):
                stack.append(e["FullPath"])
                continue
            if not e.get("chunks"):
                continue
            # raw chunks (incl. manifest-blob fids) + manifest-resolved data
            # chunk fids are all legitimately referenced needles
            raw = env._call(
                f"{filer}{urllib.parse.quote(e['FullPath'])}?metadata=true")
            chunks = list(raw.get("chunks") or [])
            if any(c.get("is_chunk_manifest") for c in chunks):
                resolved = env._call(
                    f"{filer}{urllib.parse.quote(e['FullPath'])}"
                    "?metadata=true&resolveManifest=true")
                chunks += resolved.get("chunks") or []
            for c in chunks:
                try:
                    f = t.FileId.parse(c.get("fid", ""))
                    referenced.setdefault(f.volume_id, set()).add(f.key)
                except ValueError:
                    pass
    topo = env.topology()
    stored: dict[int, set[int]] = {}
    vol_nodes: dict[int, str] = {}
    for nid_, node in topo["nodes"].items():
        for vid in node["volumes"]:
            r = env.master_get_raw(nid_, "/admin/volume/needles", volume=vid)
            stored.setdefault(vid, set()).update(r.get("needles", []))
            vol_nodes[vid] = nid_
    report: dict[str, dict] = {}
    orphans = broken = 0
    for vid, needles in sorted(stored.items()):
        refs = referenced.get(vid, set())
        o = needles - refs
        b = refs - needles
        orphans += len(o)
        broken += len(b)
        report[str(vid)] = {"orphans": len(o), "broken_refs": len(b),
                            "needles": len(needles), "node": vol_nodes[vid]}
        if (o or b) and not as_json:
            print(f"volume {vid}: {len(o)} orphan needle(s), "
                  f"{len(b)} broken ref(s)", file=out)
    # refs into volumes that no longer exist anywhere are all broken —
    # but a volume converted to EC shards still exists (its needles just
    # can't be enumerated over /admin/volume/needles), so refs into it
    # are fine, not broken
    ec_vids = {int(v) for node in topo["nodes"].values()
               for v in node.get("ec_shards", {})}
    for vid in sorted(set(referenced) - set(stored)):
        if vid in ec_vids:
            report[str(vid)] = {"ec": True, "refs": len(referenced[vid])}
            continue
        b = len(referenced[vid])
        broken += b
        report[str(vid)] = {"missing": True, "broken_refs": b}
        if not as_json:
            print(f"volume {vid}: MISSING, {b} broken ref(s)", file=out)
    # fold in the master's health ledger so both output modes gate on
    # cluster health (state / quarantined ranges), not just refs
    try:
        health = env.master_get("/maintenance/status")
    except RuntimeError:
        health = {}
    for vid, v in (health.get("volumes") or {}).items():
        rec = report.setdefault(vid, {})
        rec["health"] = {
            "state": v.get("state"), "kind": v.get("kind"),
            "last_scrub": v.get("last_scrub"),
            "quarantined": v.get("quarantined") or {},
            "shards_missing": v.get("shards_missing", []),
        }
        if v.get("kind") == "ec":
            rec["codec"] = v.get("codec", "rs_10_4")
    # `ok` is the chaos/CI gate: false — and a nonzero shell exit — on
    # anything that means data is damaged or being served around damage
    # (broken refs, corrupt/critical state, quarantined ranges).
    # Degraded/under-replicated volumes still read correctly, and
    # orphans are garbage not damage: neither flips it.  `healthy`
    # stays the stricter everything-is-green bit.  BOTH output modes
    # return the same exit code — a gate written without -json must not
    # quietly pass on a quarantined cluster.
    damaged = broken > 0
    for r in report.values():
        h = r.get("health") or {}
        if h.get("state") in ("corrupt", "critical") or \
                h.get("quarantined"):
            damaged = True
    if as_json:
        print(json.dumps({
            "volumes": report, "orphans": orphans, "broken_refs": broken,
            "states": health.get("states", {}),
            "ok": not damaged,
            "healthy": broken == 0 and all(
                (r.get("health") or {}).get("state") in (None, "healthy")
                for r in report.values()),
        }, separators=(",", ":")), file=out)
        return 1 if damaged else 0
    print(f"volume.fsck: {orphans} orphan(s), {broken} broken ref(s) "
          f"across {len(stored)} volume(s)"
          + ("" if not damaged else " — DAMAGED (corrupt/quarantined "
             "state; see maintenance.status)"), file=out)
    return 1 if damaged else 0


@command("collection.list")
def cmd_collection_list(env: CommandEnv, args, out):
    topo = env.topology()
    cols = {rec.get("collection", "")
            for rec in collect_volume_infos(topo).values()}
    for name in sorted(cols):
        print(f"collection {name or '(default)'}", file=out)
    if not cols:
        print("no collections", file=out)


@command("collection.delete")
def cmd_collection_delete(env: CommandEnv, args, out):
    """Delete every volume of a collection, writable or not (reference:
    command_collection_delete.go)."""
    env.require_lock()
    flags = parse_flags(args)
    name = flags.get("collection", flags.get("name", ""))
    topo = env.topology()
    deleted = 0
    for vid, rec in sorted(collect_volume_infos(topo).items()):
        if rec.get("collection", "") != name:
            continue
        for url in rec["nodes"]:
            env.vs_post(url, "/admin/volume/delete", {"volume": vid})
            deleted += 1
    print(f"collection.delete {name!r}: {deleted} volume replica(s) removed",
          file=out)


# ---- filesystem commands over the filer (reference:
# weed/shell/command_fs_*.go)


@command("fs.ls")
def cmd_fs_ls(env: CommandEnv, args, out):
    flags = parse_flags(args)
    path = env.resolve(
        (args and not args[-1].startswith("-") and args[-1]) or ".")
    long = "l" in flags or "long" in flags
    filer = env.find_filer()
    for e in env.filer_list(filer, path):
        name = e["FullPath"].rsplit("/", 1)[-1]
        if e.get("IsDirectory"):
            name += "/"
        if long:
            print(f"{e.get('FileSize', 0):>12} {name}", file=out)
        else:
            print(name, file=out)


@command("fs.cat")
def cmd_fs_cat(env: CommandEnv, args, out):
    path = env.resolve(args[-1])
    filer = env.find_filer()
    data = env.filer_read(filer, path)
    out.write(data.decode(errors="replace"))


@command("fs.rm")
def cmd_fs_rm(env: CommandEnv, args, out):
    flags = parse_flags(args)
    path = env.resolve(args[-1])
    filer = env.find_filer()
    env.filer_delete(filer, path, recursive="r" in flags or "rf" in flags)
    print(f"removed {path}", file=out)


@command("fs.mkdir")
def cmd_fs_mkdir(env: CommandEnv, args, out):
    path = env.resolve(args[-1]).rstrip("/") + "/"
    filer = env.find_filer()
    env._call(f"{filer}{urllib.parse.quote(path)}", {}, method="POST")
    print(f"created {path}", file=out)


@command("fs.mv")
def cmd_fs_mv(env: CommandEnv, args, out):
    src, dst = env.resolve(args[-2]), env.resolve(args[-1])
    filer = env.find_filer()
    env._call(f"{filer}{urllib.parse.quote(dst)}?mv.from="
              f"{urllib.parse.quote(src)}", {}, method="POST")
    print(f"moved {src} -> {dst}", file=out)


@command("fs.du")
def cmd_fs_du(env: CommandEnv, args, out):
    path = env.resolve(
        (args and not args[-1].startswith("-") and args[-1]) or ".")
    filer = env.find_filer()
    total = [0]
    files = [0]

    def walk(d):
        for e in env.filer_list(filer, d):
            if e.get("IsDirectory"):
                walk(e["FullPath"])
            else:
                total[0] += e.get("FileSize", 0)
                files[0] += 1
    walk(path.rstrip("/") or "/")
    print(f"{total[0]} bytes in {files[0]} file(s) under {path}", file=out)


@command("fs.meta.cat")
def cmd_fs_meta_cat(env: CommandEnv, args, out):
    path = env.resolve(args[-1])
    filer = env.find_filer()
    meta = env._call(f"{filer}{urllib.parse.quote(path)}?metadata=true")
    print(json.dumps(meta, indent=2, default=str), file=out)


@command("s3.bucket.list")
def cmd_s3_bucket_list(env: CommandEnv, args, out):
    filer = env.find_filer()
    for e in env.filer_list(filer, "/buckets"):
        if e.get("IsDirectory"):
            print(e["FullPath"].rsplit("/", 1)[-1], file=out)


@command("s3.bucket.create")
def cmd_s3_bucket_create(env: CommandEnv, args, out):
    flags = parse_flags(args)
    name = flags.get("name", args[-1] if args else "")
    filer = env.find_filer()
    env._call(f"{filer}/buckets/{name}/", {}, method="POST")
    print(f"created bucket {name}", file=out)


@command("s3.bucket.delete")
def cmd_s3_bucket_delete(env: CommandEnv, args, out):
    env.require_lock()
    flags = parse_flags(args)
    name = flags.get("name", args[-1] if args else "")
    filer = env.find_filer()
    env.filer_delete(filer, f"/buckets/{name}", recursive=True)
    print(f"deleted bucket {name}", file=out)


@command("volume.tier.move")
def cmd_volume_tier_move(env: CommandEnv, args, out):
    """Move a volume's data file to a remote tier (reference:
    command_volume_tier_move.go).  -dest kind:option, e.g.
    -dest local:/cold-storage."""
    env.require_lock()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    from seaweedfs_tpu_torch.remote_storage import parse_remote_spec
    kind, options = parse_remote_spec(flags.get("dest", ""))
    if kind == "local" and not options.get("directory"):
        raise RuntimeError(
            "volume.tier.move needs -dest local:<directory> or "
            "-dest s3:endpoint=..,bucket=..")
    for url in env.volume_locations(vid):
        r = env.vs_post(url, "/admin/volume/tier_move",
                        {"volume": vid, "kind": kind,
                         "options": options})
        print(f"volume {vid} on {url} -> tier {kind} "
              f"(backend={r.get('backend')})", file=out)


@command("remote.mount")
def cmd_remote_mount(env: CommandEnv, args, out):
    """Mount a remote store's objects under a filer directory (reference:
    command_remote_mount.go).  -remote kind:option -dir /mounted"""
    flags = parse_flags(args)
    from seaweedfs_tpu_torch.remote_storage import (make_remote,
                                              parse_remote_spec,
                                              sync_remote_to_filer)
    kind, options = parse_remote_spec(flags.get("remote", ""))
    mount_dir = flags.get("dir", "/remote")
    cache = flags.get("cache", "false") == "true"
    remote = make_remote(kind, **options)
    filer = env.find_filer()
    n = sync_remote_to_filer(remote, filer, mount_dir, cache=cache)
    # record the mapping so the filer can read placeholders THROUGH the
    # remote on demand (reference: remote_mapping.go + read_remote.go)
    env._call(f"{filer}/__admin__/remote_mounts",
              {"set": {mount_dir: flags.get("remote", "")}})
    print(f"remote.mount: {n} object(s) from {kind} -> {mount_dir}"
          + ("" if cache else " (placeholders; read-through live, "
                              "remote.cache to pin)"),
          file=out)


@command("remote.cache")
def cmd_remote_cache(env: CommandEnv, args, out):
    """Pull remote object content into the mounted directory (reference:
    command_remote_cache.go)."""
    flags = parse_flags(args)
    from seaweedfs_tpu_torch.remote_storage import (make_remote,
                                              parse_remote_spec,
                                              sync_remote_to_filer)
    kind, options = parse_remote_spec(flags.get("remote", ""))
    mount_dir = flags.get("dir", "/remote")
    remote = make_remote(kind, **options)
    filer = env.find_filer()
    n = sync_remote_to_filer(remote, filer, mount_dir, cache=True)
    print(f"remote.cache: {n} object(s) cached under {mount_dir}", file=out)


@command("volume.grow")
def cmd_volume_grow(env: CommandEnv, args, out):
    """Pre-allocate writable volumes (reference: command_volume_grow /
    the master /vol/grow endpoint)."""
    env.require_lock()
    flags = parse_flags(args)
    r = env.master_post("/vol/grow",
                        count=flags.get("count", "1"),
                        collection=flags.get("collection", ""),
                        replication=flags.get("replication", ""),
                        ttl=flags.get("ttl", ""))
    print(f"grew {r.get('count', 0)} volume(s)", file=out)


@command("volume.move")
def cmd_volume_move(env: CommandEnv, args, out):
    """Move one volume between servers: copy to target, delete from
    source (reference: command_volume_move.go)."""
    env.require_lock()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    target = flags["target"]
    locs = env.volume_locations(vid)
    if not locs:
        raise RuntimeError(f"volume {vid} not found")
    source = flags.get("source", locs[0])
    col = collect_volume_infos(env.topology()).get(vid, {})
    move_volume(env, vid, source, target, col.get("collection", ""))
    print(f"moved volume {vid}: {source} -> {target}", file=out)


@command("volume.mount")
def cmd_volume_mount(env: CommandEnv, args, out):
    env.require_lock()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    node = flags["node"]
    env.vs_post(node, "/admin/volume/mount",
                {"volume": vid, "collection": flags.get("collection", "")})
    print(f"mounted volume {vid} on {node}", file=out)


@command("volume.unmount")
def cmd_volume_unmount(env: CommandEnv, args, out):
    env.require_lock()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    node = flags.get("node")
    if not node:
        locs = env.volume_locations(vid)
        if not locs:
            raise RuntimeError(f"volume {vid} not found")
        node = locs[0]
    env.vs_post(node, "/admin/volume/unmount", {"volume": vid})
    print(f"unmounted volume {vid} on {node}", file=out)


@command("fs.tree")
def cmd_fs_tree(env: CommandEnv, args, out):
    """Recursive directory tree (reference: command_fs_tree.go)."""
    path = (args and not args[-1].startswith("-") and args[-1]) or "/"
    filer = env.find_filer()

    def walk(d, depth):
        for e in env.filer_list(filer, d):
            name = e["FullPath"].rsplit("/", 1)[-1]
            print("  " * depth + ("+" if e.get("IsDirectory") else "-")
                  + " " + name, file=out)
            if e.get("IsDirectory"):
                walk(e["FullPath"], depth + 1)
    print(path, file=out)
    walk(path.rstrip("/") or "/", 1)


@command("s3.clean.uploads")
def cmd_s3_clean_uploads(env: CommandEnv, args, out):
    """Purge abandoned multipart uploads older than -timeAgo (reference:
    command_s3_clean_uploads.go)."""
    env.require_lock()
    flags = parse_flags(args)
    max_age = parse_duration(flags.get("timeAgo", "24h") or "0")
    filer = env.find_filer()
    import time as _time
    cutoff = _time.time() - max_age
    removed = 0
    for bucket in env.filer_list(filer, "/buckets"):
        if not bucket.get("IsDirectory"):
            continue
        uploads_dir = bucket["FullPath"] + "/.uploads"
        for up in env.filer_list(filer, uploads_dir):
            if up.get("Mtime", 0) < cutoff:
                env.filer_delete(filer, up["FullPath"], recursive=True)
                removed += 1
                print(f"removed {up['FullPath']}", file=out)
    print(f"s3.clean.uploads: {removed} abandoned upload(s) removed",
          file=out)


@command("fs.meta.save")
def cmd_fs_meta_save(env: CommandEnv, args, out):
    """Dump a filer subtree's metadata (entries incl. chunk refs) to a
    local JSONL file (reference: command_fs_meta_save.go).
      fs.meta.save -o meta.jsonl [/path]"""
    flags = parse_flags(args)
    # first token that is neither a flag nor a flag's value is the path
    path = flags.get("path", "/")
    skip_next = False
    for tok in args:
        if skip_next:
            skip_next = False
            continue
        if tok.startswith("-"):
            skip_next = "=" not in tok
            continue
        path = tok
        break
    out_path = flags.get("o", "filer_meta.jsonl")
    filer = env.find_filer()
    count = 0
    with open(out_path, "w", encoding="utf-8") as f:
        stack = [path.rstrip("/") or "/"]
        while stack:
            d = stack.pop()
            for e in env.filer_list(filer, d):
                if e.get("IsDirectory"):
                    stack.append(e["FullPath"])
                meta = env._call(
                    f"{filer}{urllib.parse.quote(e['FullPath'])}"
                    "?metadata=true")
                f.write(json.dumps(meta, separators=(",", ":")) + "\n")
                count += 1
    print(f"fs.meta.save: {count} entr(ies) -> {out_path}", file=out)


@command("fs.meta.load")
def cmd_fs_meta_load(env: CommandEnv, args, out):
    """Restore entries from an fs.meta.save dump via the filer raw-entry
    API (reference: command_fs_meta_load.go).  Chunk refs are restored
    as-is — blob data must still exist on the volume servers."""
    flags = parse_flags(args)
    in_path = flags.get("i", args[-1] if args else "filer_meta.jsonl")
    filer = env.find_filer()
    count = 0
    with open(in_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            entry = json.loads(line)
            env._call(f"{filer}/__admin__/entry", {"entry": entry})
            count += 1
    print(f"fs.meta.load: {count} entr(ies) restored", file=out)


@command("volume.configure.replication")
def cmd_volume_configure_replication(env: CommandEnv, args, out):
    """Change a volume's replica placement in its super block
    (reference: command_volume_configure_replication.go)."""
    env.require_lock()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    rp = flags.get("replication", "000")
    t.ReplicaPlacement.parse(rp)  # validate
    for url in env.volume_locations(vid):
        env.vs_post(url, "/admin/volume/configure_replication",
                    {"volume": vid, "replication": rp})
        print(f"volume {vid} on {url}: replication -> {rp}", file=out)


@command("s3.configure")
def cmd_s3_configure(env: CommandEnv, args, out):
    """Manage S3 identities in the filer-stored identity.json, which
    running gateways hot-reload (reference: command_s3_configure.go).
      s3.configure -user NAME -access_key AK -secret_key SK -actions Admin
      s3.configure -user NAME -delete
      s3.configure -list"""
    env.require_lock()
    flags = parse_flags(args)
    filer = env.find_filer()
    from seaweedfs_tpu_torch.s3.iamapi_server import IDENTITY_PATH
    try:
        cfg = json.loads(env.filer_read(filer, IDENTITY_PATH))
    except Exception:
        cfg = {"identities": []}
    idents = cfg.setdefault("identities", [])
    if flags.get("list"):
        for i in idents:
            keys = ",".join(c.get("accessKey", "") for c in
                            i.get("credentials", []))
            print(f"{i.get('name')}: actions={i.get('actions')} "
                  f"keys=[{keys}]", file=out)
        if not idents:
            print("no identities configured", file=out)
        return
    user = flags.get("user", "")
    if not user:
        raise RuntimeError("s3.configure needs -user (or -list)")
    existing = next((i for i in idents if i.get("name") == user), None)
    if flags.get("delete"):
        if existing:
            idents.remove(existing)
            print(f"deleted identity {user}", file=out)
    else:
        if existing is None:
            existing = {"name": user, "credentials": [], "actions": []}
            idents.append(existing)
        if flags.get("access_key"):
            existing["credentials"] = [{
                "accessKey": flags["access_key"],
                "secretKey": flags.get("secret_key", "")}]
        if flags.get("actions"):
            existing["actions"] = flags["actions"].split(",")
        print(f"configured identity {user}: {existing['actions']}", file=out)
    payload = json.dumps(cfg, indent=1).encode()
    req = urllib.request.Request(
        f"{_tls_scheme()}://{filer}{urllib.parse.quote(IDENTITY_PATH)}",
        data=payload, method="PUT")
    with urllib.request.urlopen(req, timeout=30):
        pass


@command("cluster.ps")
def cmd_cluster_ps(env: CommandEnv, args, out):
    """List non-volume cluster processes (reference: command_cluster_ps.go)."""
    members = env.master_get("/cluster/status").get("Members", {})
    if not members:
        print("no registered cluster processes", file=out)
    for kind, addrs in sorted(members.items()):
        for a in addrs:
            print(f"{kind} {a}", file=out)


@command("volume.vacuum.all")
def cmd_volume_vacuum_all(env: CommandEnv, args, out):
    """Master-driven vacuum scan (reference: topology_vacuum.go)."""
    env.require_lock()
    flags = parse_flags(args)
    r = env.master_post("/vol/vacuum",
                        garbageThreshold=flags.get("garbageThreshold", "0.3"))
    print(f"vacuumed {r.get('vacuumed', 0)} volume(s)", file=out)


def run_command(env: CommandEnv, line: str, out) -> int:
    """Run one shell line; returns the command's exit code (commands
    return None for success — a nonzero int marks an assertion-style
    failure, e.g. volume.fsck finding corruption, so scripted/CI
    invocations can gate on it)."""
    parts = shlex.split(line)
    if not parts:
        return 0
    fn = COMMANDS.get(parts[0])
    if fn is None:
        raise RuntimeError(f"unknown command {parts[0]!r} "
                           f"(have: {', '.join(sorted(COMMANDS))})")
    rc = fn(env, parts[1:], out)
    return int(rc) if rc else 0


@command("cluster.raft.ps")
def cmd_cluster_raft_ps(env: CommandEnv, args, out):
    """Show each master's raft state (reference: command_cluster_raft_ps)."""
    masters = {env.master}
    try:
        st = env.master_get("/raft/status")
        masters.update(st.get("peers", []))
        rows = [st]
    except RuntimeError:
        rows = []
    for m in sorted(masters - {env.master}):
        try:
            rows.append(env.master_get_raw(m, "/raft/status"))
        except RuntimeError as e:
            rows.append({"node_id": m, "state": f"unreachable ({e})"})
    for r in rows:
        print(f"{r.get('node_id', env.master):24s} state={r.get('state')} "
              f"term={r.get('term', '-')} leader={r.get('leader', '-')} "
              f"log={r.get('log_len', '-')} snap@{r.get('snap_index', '-')}",
              file=out)


@command("cluster.raft.add")
def cmd_cluster_raft_add(env: CommandEnv, args, out):
    """Add a master peer to every member's raft config:
    cluster.raft.add -peer host:port (reference: command_cluster_raft_add)."""
    env.require_lock()
    flags = parse_flags(args)
    peer = flags["peer"]
    st = env.master_get("/raft/status")
    members = set(st.get("peers", [])) | {st.get("node_id", env.master)}
    for m in sorted(members):
        r = env._call(f"{m}/raft/peers/add", {"peer": peer})
        print(f"{m}: peers now {r.get('peers')}", file=out)
    # the new member must also learn every existing peer, or it sees a
    # single-node cluster, elects itself, and split-brains
    for m in sorted(members):
        r = env._call(f"{peer}/raft/peers/add", {"peer": m})
    print(f"{peer}: peers now {r.get('peers')}", file=out)


@command("cluster.raft.remove")
def cmd_cluster_raft_remove(env: CommandEnv, args, out):
    """Remove a master peer from every member's raft config
    (reference: command_cluster_raft_remove)."""
    env.require_lock()
    flags = parse_flags(args)
    peer = flags["peer"]
    st = env.master_get("/raft/status")
    members = set(st.get("peers", [])) | {st.get("node_id", env.master)}
    for m in sorted(members - {peer}):
        r = env._call(f"{m}/raft/peers/remove", {"peer": peer})
        print(f"{m}: peers now {r.get('peers')}", file=out)


@command("cluster.leader")
def cmd_cluster_leader(env: CommandEnv, args, out):
    """Print the master leader address."""
    st = env.master_get("/cluster/status")
    print(st.get("Leader") or env.master, file=out)


@command("cluster.check")
def cmd_cluster_check(env: CommandEnv, args, out):
    """Reachability sweep over every registered cluster process
    (reference: command_cluster_check)."""
    st = env.master_get("/cluster/status")
    print(f"master {env.master:24s} ok (leader={st.get('Leader')})",
          file=out)
    topo = st.get("Topology", {})
    for nid in sorted(topo.get("nodes", {})):
        try:
            env.master_get_raw(nid, "/status")
            print(f"volume {nid:24s} ok", file=out)
        except RuntimeError as e:
            print(f"volume {nid:24s} UNREACHABLE: {e}", file=out)
    for kind, members in sorted(
            (st.get("Members") or {}).items()):
        for m in members:
            try:
                env.master_get_raw(m, "/status")
                print(f"{kind:6s} {m:24s} ok", file=out)
            except RuntimeError as e:
                print(f"{kind:6s} {m:24s} UNREACHABLE: {e}", file=out)


@command("fs.pwd")
def cmd_fs_pwd(env: CommandEnv, args, out):
    """Print the shell's filer working directory."""
    print(env.cwd, file=out)


@command("fs.cd")
def cmd_fs_cd(env: CommandEnv, args, out):
    """Change the shell's filer working directory: fs.cd /buckets"""
    target = env.resolve(args[0] if args else "/")
    filer = env.find_filer()
    if target != "/":
        env.filer_list(filer, target)  # raises if missing
    env.cwd = target
    print(env.cwd, file=out)


@command("fs.cp")
def cmd_fs_cp(env: CommandEnv, args, out):
    """Copy one filer file: fs.cp /src/path /dst/path."""
    if len(args) < 2:
        raise RuntimeError("fs.cp needs <src> <dst>")
    src, dst = env.resolve(args[0]), env.resolve(args[1])
    filer = env.find_filer()
    data = env.filer_read(filer, src)
    req = urllib.request.Request(
        f"{_tls_scheme()}://{filer}{urllib.parse.quote(dst)}",
        data=data, method="PUT")
    with urllib.request.urlopen(req, timeout=600):
        pass
    print(f"copied {src} -> {dst} ({len(data)} bytes)", file=out)


@command("fs.verify")
def cmd_fs_verify(env: CommandEnv, args, out):
    """Verify every chunk of a file (or tree) is readable on its volume
    server (reference: command_fs_verify)."""
    path = env.resolve(args[0] if args and not args[0].startswith("-")
                       else ".")
    filer = env.find_filer()

    def chunks_of(p):
        with urllib.request.urlopen(
                f"{_tls_scheme()}://{filer}{urllib.parse.quote(p)}"
                "?metadata=true&resolveManifest=true", timeout=60) as r:
            meta = json.loads(r.read())
        return meta.get("chunks") or []

    bad = ok = 0
    for ck in chunks_of(path):
        fid = ck.get("fid", "")
        vid = fid.split(",")[0]
        locs = env.volume_locations(int(vid)) if vid.isdigit() else []
        readable = False
        for url in locs:
            try:
                req = urllib.request.Request(
                    f"{_tls_scheme()}://{url}/{fid}", method="HEAD")
                with urllib.request.urlopen(req, timeout=30):
                    readable = True
                    break
            except Exception:
                continue
        if readable:
            ok += 1
        else:
            bad += 1
            print(f"  missing chunk {fid} ({path})", file=out)
    print(f"fs.verify: {ok} chunk(s) ok, {bad} missing", file=out)


@command("fs.configure")
def cmd_fs_configure(env: CommandEnv, args, out):
    """Show or set per-path filer rules (reference: command_fs_configure +
    filer.conf): fs.configure [-locationPrefix /p -collection c
    -replication 010 -ttl 1d -readOnly true -apply]"""
    flags = parse_flags(args)
    filer = env.find_filer()
    conf = env.master_get_raw(filer, "/__admin__/filer_conf")
    if not flags.get("locationPrefix"):
        print(json.dumps(conf, indent=2), file=out)
        return
    rule = {"location_prefix": flags["locationPrefix"]}
    for src, dst in (("collection", "collection"),
                     ("replication", "replication"), ("ttl", "ttl")):
        if flags.get(src):
            rule[dst] = flags[src]
    if flags.get("readOnly"):
        rule["read_only"] = flags["readOnly"] == "true"
    rules = [r for r in conf.get("locations", [])
             if r.get("location_prefix") != rule["location_prefix"]]
    if not flags.get("delete"):
        rules.append(rule)
    if flags.get("apply"):
        env._call(f"{filer}/__admin__/filer_conf", {"locations": rules})
        print(f"applied {len(rules)} rule(s)", file=out)
    else:
        print(json.dumps({"locations": rules}, indent=2), file=out)
        print("(dry run; add -apply)", file=out)


@command("volume.tier.upload")
def cmd_volume_tier_upload(env: CommandEnv, args, out):
    """Upload a volume's data to a remote tier — alias of volume.tier.move
    matching the reference's command name (command_volume_tier_upload)."""
    cmd_volume_tier_move(env, args, out)


@command("volume.tier.download")
def cmd_volume_tier_download(env: CommandEnv, args, out):
    """Bring a tiered volume's data back to local disk (reference:
    command_volume_tier_download): volume.tier.download -volumeId N
    [-deleteRemote true]"""
    env.require_lock()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    for url in env.volume_locations(vid):
        r = env.vs_post(url, "/admin/volume/tier_download",
                        {"volume": vid,
                         "delete_remote":
                             flags.get("deleteRemote", "false") == "true"})
        print(f"volume {vid} on {url} back on local disk "
              f"(backend={r.get('backend')})", file=out)


@command("volume.deleteEmpty")
def cmd_volume_delete_empty(env: CommandEnv, args, out):
    """Delete volumes holding no live needles (reference:
    command_volume_delete_empty): volume.deleteEmpty [-apply]"""
    env.require_lock()
    flags = parse_flags(args)
    apply = flags.get("apply", "false") == "true" or "apply" in args
    topo = env.topology()
    n = 0
    for vid, rec in sorted(collect_volume_infos(topo).items()):
        if rec.get("file_count", 0) - rec.get("delete_count", 0) > 0:
            continue
        if rec.get("size", 0) <= 64 * 1024:  # header-only .dat
            n += 1
            print(f"empty volume {vid} on {rec['nodes']}"
                  + ("" if apply else " (dry run, -apply to delete)"),
                  file=out)
            if apply:
                for url in rec["nodes"]:
                    env.vs_post(url, "/admin/volume/delete", {"volume": vid})
    print(f"volume.deleteEmpty: {n} volume(s)"
          + ("" if apply else " planned"), file=out)


@command("remote.meta.sync")
def cmd_remote_meta_sync(env: CommandEnv, args, out):
    """Reconcile a mounted directory's metadata against the remote's
    current object list (reference: command_remote_meta_sync):
    remote.meta.sync -remote kind:spec -dir /mounted"""
    flags = parse_flags(args)
    from seaweedfs_tpu_torch.remote_storage import (make_remote,
                                              meta_sync_remote_to_filer,
                                              parse_remote_spec)
    kind, options = parse_remote_spec(flags.get("remote", ""))
    remote = make_remote(kind, **options)
    filer = env.find_filer()
    changed, deleted, same = meta_sync_remote_to_filer(
        remote, filer, flags.get("dir", "/remote"))
    print(f"remote.meta.sync: {changed} updated, {deleted} deleted, "
          f"{same} unchanged", file=out)


@command("remote.uncache")
def cmd_remote_uncache(env: CommandEnv, args, out):
    """Drop cached content under a mounted directory, reverting entries to
    placeholders (reference: command_remote_uncache):
    remote.uncache -dir /mounted"""
    flags = parse_flags(args)
    mount = flags.get("dir", "/remote")
    filer = env.find_filer()
    from seaweedfs_tpu_torch.remote_storage import _filer_walk
    import urllib.request
    n = 0
    for path, meta in _filer_walk(filer, mount):
        ext = {k.lower(): v
               for k, v in (meta.get("extended") or {}).items()}
        if "remote-key" not in ext or \
                ext.get("remote-placeholder") == "true":
            continue
        headers = {
            "Seaweed-remote-size": ext.get("remote-size", "0"),
            "Seaweed-remote-mtime": ext.get("remote-mtime", "0"),
            "Seaweed-remote-key": ext["remote-key"],
            "Seaweed-remote-placeholder": "true",
        }
        req = urllib.request.Request(
            f"{_tls_scheme()}://{filer}{urllib.parse.quote(path)}",
            data=b"", method="POST", headers=headers)
        with urllib.request.urlopen(req, timeout=60):
            pass
        n += 1
    print(f"remote.uncache: {n} file(s) reverted to placeholders", file=out)


@command("remote.configure")
def cmd_remote_configure(env: CommandEnv, args, out):
    """Store named remote specs on the filer (reference:
    command_remote_configure): remote.configure -name cold
    -spec s3:endpoint=..,bucket=.. | -list | -delete -name cold"""
    flags = parse_flags(args)
    filer = env.find_filer()
    path = "/etc/remote.conf"
    import urllib.error
    import urllib.request
    try:
        conf = json.loads(env.filer_read(filer, path) or b"{}")
    except urllib.error.HTTPError as e:
        if e.code != 404:
            raise  # a transient failure must NOT read as "no remotes"
        conf = {}
    mutated = False
    if flags.get("name") and flags.get("spec"):
        conf[flags["name"]] = flags["spec"]
        mutated = True
    elif flags.get("delete") and flags.get("name"):
        mutated = conf.pop(flags["name"], None) is not None
    if mutated:  # plain listing never rewrites the config file
        req = urllib.request.Request(
            f"{_tls_scheme()}://{filer}{urllib.parse.quote(path)}",
            data=json.dumps(conf, indent=2).encode(), method="PUT")
        with urllib.request.urlopen(req, timeout=60):
            pass
    for name, spec in sorted(conf.items()):
        print(f"{name:16s} {spec}", file=out)
    if not conf:
        print("(no remotes configured)", file=out)


@command("volume.copy")
def cmd_volume_copy(env: CommandEnv, args, out):
    """Copy a volume to another server WITHOUT deleting the source
    (reference: command_volume_copy): volume.copy -volumeId N -target url"""
    env.require_lock()
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    target = flags["target"]
    locs = env.volume_locations(vid)
    if not locs:
        raise RuntimeError(f"volume {vid} not found")
    source = flags.get("source", locs[0])
    cols = {v: rec.get("collection", "")
            for v, rec in collect_volume_infos(env.topology()).items()}
    r = env.vs_post(target, "/admin/volume/copy",
                    {"volume": vid, "source": source,
                     "collection": cols.get(vid, "")})
    print(f"copied volume {vid}: {source} -> {target} "
          f"({r.get('file_count', r.get('appended_bytes', 0))})", file=out)


@command("volume.vacuum.disable")
def cmd_volume_vacuum_disable(env: CommandEnv, args, out):
    """Pause the master's automatic vacuum scan (reference:
    command_volume_vacuum_disable)."""
    env.require_lock()
    env.master_post("/vol/vacuum_toggle", {"enabled": False})
    print("automatic vacuum disabled", file=out)


@command("volume.vacuum.enable")
def cmd_volume_vacuum_enable(env: CommandEnv, args, out):
    """Resume the master's automatic vacuum scan (reference:
    command_volume_vacuum_enable)."""
    env.require_lock()
    env.master_post("/vol/vacuum_toggle", {"enabled": True})
    print("automatic vacuum enabled", file=out)


def _find_broker(env: CommandEnv) -> str:
    members = env.master_get("/cluster/status").get("Members", {})
    brokers = members.get("broker", [])
    if not brokers:
        raise RuntimeError("no mq broker registered with the master")
    return brokers[0]


@command("mq.topic.list")
def cmd_mq_topic_list(env: CommandEnv, args, out):
    """List MQ topics with partition next-offsets (reference:
    command_mq_topic_list)."""
    broker = _find_broker(env)
    r = env.master_get_raw(broker, "/topics/list")
    for t_ in r.get("topics", []):
        print(f"{t_['name']:32s} partitions={t_['partition_count']} "
              f"next_offsets={t_['next_offsets']}", file=out)
    if not r.get("topics"):
        print("(no topics)", file=out)


@command("mq.topic.configure")
def cmd_mq_topic_configure(env: CommandEnv, args, out):
    """Create/configure an MQ topic (reference: command_mq_topic_configure):
    mq.topic.configure -topic ns.name -partitionCount 4"""
    flags = parse_flags(args)
    broker = _find_broker(env)
    r = env._call(f"{broker}/topics/configure",
                  {"topic": flags["topic"],
                   "partition_count": int(flags.get("partitionCount", "4"))})
    print(f"topic {r.get('topic')} partitions={r.get('partition_count')}",
          file=out)


@command("mq.topic.desc")
def cmd_mq_topic_desc(env: CommandEnv, args, out):
    """Describe one topic's partitions and broker assignment (reference:
    command_mq_topic_describe)."""
    flags = parse_flags(args)
    topic = flags["topic"]
    broker = _find_broker(env)
    r = env.master_get_raw(broker, "/topics/list")
    brokers = r.get("brokers", [broker])
    for t_ in r.get("topics", []):
        if t_["name"] != topic:
            continue
        for pi, nxt in enumerate(t_["next_offsets"]):
            owner = brokers[pi % len(brokers)]
            print(f"partition {pi}: owner={owner} next_offset={nxt}",
                  file=out)
        return
    raise RuntimeError(f"topic {topic!r} not found")


@command("ec.cleanup")
def cmd_ec_cleanup(env: CommandEnv, args, out):
    """Remove leftover EC shards for volumes that are back to normal
    replication (post-decode orphans): ec.cleanup [-apply]"""
    env.require_lock()
    flags = parse_flags(args)
    apply = flags.get("apply", "false") == "true" or "apply" in args
    topo = env.topology()
    normal_vids = {vid for node in topo["nodes"].values()
                   for vid in node["volumes"]}
    n = 0
    for nid, node in sorted(topo["nodes"].items()):
        for vid_s, shards in sorted(node.get("ec_shards", {}).items()):
            vid = int(vid_s)
            if vid not in normal_vids:
                continue
            n += 1
            print(f"orphan ec shards of volume {vid} on {nid}: {shards}"
                  + ("" if apply else " (dry run, -apply to delete)"),
                  file=out)
            if apply:
                env.vs_post(nid, "/admin/ec/delete_shards",
                            {"volume": vid, "shards": shards})
    print(f"ec.cleanup: {n} orphan group(s)"
          + ("" if apply else " planned"), file=out)


@command("ec.progress")
def cmd_ec_progress(env: CommandEnv, args, out):
    """Watch a running EC encode: ec.progress -volumeId N [-server url]
    [-cancel true]"""
    flags = parse_flags(args)
    vid = int(flags["volumeId"])
    if flags.get("cancel") == "true":
        # cancelling aborts another operator's encode: single-writer rule
        env.require_lock()
    urls = [flags["server"]] if flags.get("server") else \
        env.volume_locations(vid) or \
        [n for n in env.topology()["nodes"]]
    cancelled = 0
    for url in urls:
        try:
            if flags.get("cancel") == "true":
                env.vs_post(url, "/admin/ec/cancel", {"volume": vid})
                print(f"{url}: cancel requested", file=out)
                cancelled += 1
                continue
            r = env.master_get_raw(url, "/admin/ec/progress",
                                   volumeId=str(vid))
        except RuntimeError:
            continue
        pct = 100.0 * r.get("bytes_done", 0) / max(1, r.get("total", 1))
        print(f"{url}: {r.get('state')} {pct:.1f}% "
              f"({r.get('bytes_done', 0)}/{r.get('total', 0)} bytes)"
              + (f" error={r['error']}" if r.get("error") else ""),
              file=out)
        return
    if flags.get("cancel") != "true" or not cancelled:
        print(f"no encode job found for volume {vid}", file=out)


@command("volume.delete.empty")
def cmd_volume_delete_empty(env: CommandEnv, args, out):
    """Delete volumes holding zero live files, fleet-wide (reference:
    command_volume_delete_empty.go).  Dry-run unless -force; -quietFor
    (default 24h) keeps freshly-created volumes safe."""
    env.require_lock()
    flags = parse_flags(args)
    force = "force" in flags
    quiet = parse_duration(flags.get("quietFor", "24h"))
    import time as _time
    now = _time.time()
    topo = env.topology()
    victims: dict[int, list[str]] = {}
    for nid, node in topo["nodes"].items():
        for v in node.get("volume_infos", []):
            if v.get("file_count", 0) - v.get("delete_count", 0) > 0:
                continue
            if v.get("modified_at", 0) + quiet >= now:
                continue
            victims.setdefault(v["id"], []).append(nid)
    for vid in sorted(victims):
        if force:
            for nid in victims[vid]:
                env.vs_post(nid, "/admin/volume/delete", {"volume": vid})
            print(f"deleted empty volume {vid} from "
                  f"{len(victims[vid])} node(s)", file=out)
        else:
            print(f"would delete empty volume {vid} on "
                  f"{victims[vid]} (use -force)", file=out)
    if not victims:
        print("no empty volumes", file=out)


@command("volume.server.evacuate")
def cmd_volume_server_evacuate(env: CommandEnv, args, out):
    """Move every volume and EC shard off -node onto the least-loaded
    other servers (reference: command_volume_server_evacuate.go) — drain
    before maintenance/decommission."""
    env.require_lock()
    flags = parse_flags(args)
    node = flags["node"]
    topo = env.topology()
    if node not in topo["nodes"]:
        raise RuntimeError(f"unknown volume server {node}")
    others = {nid: nd for nid, nd in topo["nodes"].items() if nid != node}
    if not others:
        raise RuntimeError("no other servers to evacuate onto")
    load = {nid: len(nd.get("volumes", [])) for nid, nd in others.items()}
    free = {nid: nd.get("free_slots", 0) for nid, nd in others.items()}
    moved = 0
    for v in topo["nodes"][node].get("volume_infos", []):
        vid = v["id"]
        # a target must have a slot and must not already hold a replica
        candidates = sorted(
            (nid for nid in others
             if free.get(nid, 0) > 0
             and vid not in others[nid].get("volumes", [])),
            key=lambda nid: load[nid])
        if not candidates:
            print(f"  volume {vid}: no target with free slots", file=out)
            continue
        target = candidates[0]
        move_volume(env, vid, node, target,
                    v.get("collection", ""))
        load[target] += 1
        free[target] -= 1
        moved += 1
        print(f"  volume {vid} -> {target}", file=out)
    # EC shards: copy to the least-loaded target, mount there, drop here
    ec = topo["nodes"][node].get("ec_shards", {})
    ec_cols = topo.get("ec_collections", {})
    for vid_s, shards in sorted(ec.items()):
        vid = int(vid_s)
        if not shards:
            continue
        col = ec_cols.get(vid_s, "")
        target = min(sorted(others), key=lambda nid: load[nid])
        env.vs_post(target, "/admin/ec/copy",
                    {"volume": vid, "collection": col, "source": node,
                     "shards": shards, "copy_ecx": True})
        env.vs_post(target, "/admin/ec/mount",
                    {"volume": vid, "collection": col})
        env.vs_post(node, "/admin/ec/delete_shards",
                    {"volume": vid, "shards": shards})
        # ALL shards left the node: unmount clears the empty EcVolume (a
        # re-mount would 404 on the missing files and abort the drain)
        env.vs_post(node, "/admin/ec/unmount", {"volume": vid})
        load[target] += 1
        moved += 1
        print(f"  ec shards {shards} of {vid} -> {target}", file=out)
    print(f"evacuated {moved} volume(s)/shard set(s) off {node}", file=out)


@command("volume.server.leave")
def cmd_volume_server_leave(env: CommandEnv, args, out):
    """Ask a volume server to stop heartbeating so the master drops it
    from placement (reference: command_volume_server_leave.go); pair with
    volume.server.evacuate for a clean decommission."""
    env.require_lock()
    flags = parse_flags(args)
    node = flags["node"]
    env.vs_post(node, "/admin/leave", {})
    print(f"{node} is leaving the cluster (heartbeats stopped)", file=out)


@command("mq.balance")
def cmd_mq_balance(env: CommandEnv, args, out):
    """Show the deterministic partition->broker assignment for every topic
    (reference: command_mq_balance.go triggers the balancer; this ring
    balances continuously, so the command reports the settled layout)."""
    brokers = env.master_get_raw(env.master, "/cluster/status") \
        .get("Members", {}).get("broker", [])
    if not brokers:
        print("no brokers registered", file=out)
        return
    listing = env.master_get_raw(sorted(brokers)[0], "/topics/list")
    # the queried broker's ring can momentarily be [] during a master
    # heartbeat lapse; fall back to the registry view
    ring = listing.get("brokers") or sorted(brokers)
    print(f"broker ring: {ring}", file=out)
    for t in listing.get("topics", []):
        n = t["partition_count"]
        print(f"{t['name']}: {n} partition(s)", file=out)
        for pi in range(n):
            follower = ring[(pi + 1) % len(ring)] if len(ring) > 1 else "-"
            print(f"  p{pi}: owner {ring[pi % len(ring)]} "
                  f"follower {follower} "
                  f"next_offset {t['next_offsets'][pi]}", file=out)


@command("fs.meta.notify")
def cmd_fs_meta_notify(env: CommandEnv, args, out):
    """Recursively re-send a directory's metadata to the filer's
    notification queue (reference: command_fs_meta_notify.go) — primes a
    replication consumer with the existing tree."""
    path = env.resolve(
        (args and not args[-1].startswith("-") and args[-1]) or ".")
    filer = env.find_filer()
    r = env._call(f"{filer}/__admin__/notify", {"prefix": path})
    print(f"notified {r.get('sent', 0)} entr(ies) under {path}", file=out)


@command("fs.meta.change.volume.id")
def cmd_fs_meta_change_volume_id(env: CommandEnv, args, out):
    """Rewrite chunk fids from one volume id to another across a subtree
    (reference: command_fs_meta_change_volume_id.go) — the metadata half
    of renumbering a volume.  -dir / -fromVolumeId X -toVolumeId Y
    [-mapping file-with-x=>y-lines] [-force to apply]."""
    flags = parse_flags(args)
    mapping: dict[int, int] = {}
    if flags.get("mapping"):
        with open(flags["mapping"]) as f:
            for line in f:
                line = line.strip()
                if not line or "=>" not in line:
                    continue
                a, b = line.split("=>", 1)
                mapping[int(a)] = int(b)
    else:
        src, dst = int(flags.get("fromVolumeId", "0")), \
            int(flags.get("toVolumeId", "0"))
        if not src or not dst or src == dst:
            raise RuntimeError("-fromVolumeId and -toVolumeId must be "
                               "distinct and non-zero (or use -mapping)")
        mapping[src] = dst
    force = "force" in flags
    root = flags.get("dir", "/")
    filer = env.find_filer()
    changed = 0

    def walk(d: str) -> None:
        nonlocal changed
        for e in env.filer_list(filer, d):
            if e.get("IsDirectory"):
                walk(e["FullPath"])
                continue
            entry = env.master_get_raw(
                filer, urllib.parse.quote(e["FullPath"]), metadata="true")
            dirty = False
            for c in entry.get("chunks", []):
                if c.get("is_chunk_manifest"):
                    print(f"  skip manifest file {e['FullPath']} "
                          "(not implemented)", file=out)
                    break
                vid_s, _, rest = c.get("fid", "").partition(",")
                try:
                    vid = int(vid_s)
                except ValueError:
                    continue
                if vid in mapping:
                    c["fid"] = f"{mapping[vid]},{rest}"
                    dirty = True
            else:
                if dirty:
                    changed += 1
                    print(f"  {'updating' if force else 'would update'} "
                          f"{e['FullPath']}", file=out)
                    if force:
                        env._call(f"{filer}/__admin__/entry",
                                  {"entry": entry})

    walk(root.rstrip("/") or "/")
    print(f"{changed} file(s) {'updated' if force else 'need updating'}"
          + ("" if force else " (dry run; add -force)"), file=out)


@command("fs.merge.volumes")
def cmd_fs_merge_volumes(env: CommandEnv, args, out):
    """Re-upload the chunks of files under -dir that live on
    -fromVolumeId into freshly assigned volumes, consolidating data off
    small/fragmented volumes so they can be deleted (reference:
    command_fs_merge_volumes.go).  Dry-run by default; -apply commits.
    -dir /path -fromVolumeId N [-collection c] [-apply]"""
    flags = parse_flags(args)
    root = env.resolve(flags.get("dir", "/"))
    src_vid = int(flags.get("fromVolumeId", "0"))
    if not src_vid:
        raise RuntimeError("-fromVolumeId is required")
    apply = "apply" in flags
    filer = env.find_filer()
    from seaweedfs_tpu_torch.client import WeedClient
    client = WeedClient(env.master) if apply else None
    files = chunks = 0
    try:
        def walk(d: str) -> None:
            nonlocal files, chunks
            for e in env.filer_list(filer, d):
                if e.get("IsDirectory"):
                    walk(e["FullPath"])
                    continue
                entry = env.master_get_raw(
                    filer, urllib.parse.quote(e["FullPath"]),
                    metadata="true")
                dirty = False
                for c in entry.get("chunks", []):
                    fid = c.get("fid", "")
                    vid_s = fid.split(",")[0]
                    if not vid_s.isdigit() or int(vid_s) != src_vid:
                        continue
                    chunks += 1
                    if not apply:
                        dirty = True
                        continue
                    data = None
                    for u in env.volume_locations(src_vid):
                        try:
                            with urllib.request.urlopen(
                                    f"{_tls_scheme()}://{u}/{fid}",
                                    timeout=120) as r:
                                data = r.read()
                            break
                        except Exception:
                            continue
                    if data is None:
                        raise RuntimeError(f"chunk {fid} unreadable on "
                                           f"volume {src_vid}")
                    # the point is moving OFF the source volume: retry
                    # assign past it, growing fresh volumes if the source
                    # is the only writable one (a grown volume becomes
                    # assignable only after it registers — wait that
                    # window out instead of burning the retries)
                    import time as _time
                    a = None
                    for attempt in range(20):
                        cand = client.assign(
                            collection=flags.get("collection", ""))
                        if int(cand["fid"].split(",")[0]) != src_vid:
                            a = cand
                            break
                        if attempt == 3:
                            env.master_post(
                                "/vol/grow", count="1",
                                collection=flags.get("collection", ""))
                        if attempt >= 3:
                            _time.sleep(0.2)
                    if a is None:
                        raise RuntimeError(
                            f"could not assign a target volume != "
                            f"{src_vid}")
                    client.upload_to(a["url"], a["fid"], data)
                    c["fid"] = a["fid"]
                    dirty = True
                if dirty:
                    files += 1
                    print(f"  {'moved' if apply else 'would move'} "
                          f"{e['FullPath']}", file=out)
                    if apply:
                        env._call(f"{filer}/__admin__/entry",
                                  {"entry": entry})

        walk(root.rstrip("/") or "/")
    finally:
        if client is not None:
            client.close()
    print(f"fs.merge.volumes: {chunks} chunk(s) in {files} file(s) "
          f"{'moved off' if apply else 'on'} volume {src_vid}"
          + ("" if apply else " (dry run; add -apply)"), file=out)


@command("remote.unmount")
def cmd_remote_unmount(env: CommandEnv, args, out):
    """Detach a remote mapping from a directory (reference:
    command_remote_unmount.go).  Cached/placeholder entries under the
    directory stay unless -deleteEntries."""
    flags = parse_flags(args)
    mount_dir = flags.get("dir", "/remote")
    filer = env.find_filer()
    env._call(f"{filer}/__admin__/remote_mounts",
              {"remove": [mount_dir]})
    if flags.get("deleteEntries", "false") == "true":
        try:
            env.filer_delete(filer, mount_dir, recursive=True)
        except Exception as e:
            print(f"  entry cleanup failed: {e}", file=out)
    print(f"remote.unmount: {mount_dir} detached", file=out)


@command("s3.bucket.quota")
def cmd_s3_bucket_quota(env: CommandEnv, args, out):
    """Set/clear a bucket's byte quota, stored on the bucket entry
    (reference: command_s3_bucket_quota.go).  -name b -quotaMB 100 |
    -name b -delete; s3.bucket.quota.check enforces."""
    flags = parse_flags(args)
    name = flags.get("name", "")
    if not name:
        raise RuntimeError("-name required")
    filer = env.find_filer()
    entry = env.master_get_raw(filer, f"/buckets/{name}",
                               metadata="true")
    if "delete" in flags:
        entry["quota"] = 0
    elif "quotaMB" not in flags:
        raise RuntimeError("-quotaMB <megabytes> or -delete required")
    else:
        entry["quota"] = int(float(flags["quotaMB"]) * 1024 * 1024)
    env._call(f"{filer}/__admin__/entry", {"entry": entry})
    q = entry["quota"]
    print(f"bucket {name}: quota "
          + (f"{q} bytes" if q else "removed"), file=out)


@command("s3.bucket.quota.check")
def cmd_s3_bucket_quota_check(env: CommandEnv, args, out):
    """Walk each bucket's usage and enforce its quota by toggling a
    read-only filer rule on the bucket prefix (reference:
    command_s3_bucket_quota_check.go; the reference emails/flips
    read-only the same way).  Dry-run unless -apply."""
    flags = parse_flags(args)
    apply = "apply" in flags
    filer = env.find_filer()

    def usage(d: str) -> int:
        total = 0
        for e in env.filer_list(filer, d):
            if e.get("IsDirectory"):
                total += usage(e["FullPath"])
            else:
                total += e.get("FileSize", 0)
        return total

    conf = env.master_get_raw(filer, "/__admin__/filer_conf")
    rules = conf.get("locations", [])
    changed = 0
    for b in env.filer_list(filer, "/buckets"):
        if not b.get("IsDirectory"):
            continue
        name = b["FullPath"].rsplit("/", 1)[-1]
        entry = env.master_get_raw(filer, f"/buckets/{name}",
                                   metadata="true")
        quota = int(entry.get("quota", 0) or 0)
        if quota <= 0:
            continue
        used = usage(f"/buckets/{name}")
        prefix = f"/buckets/{name}/"
        rule = next((r for r in rules
                     if r.get("location_prefix") == prefix), None)
        over = used > quota
        state = "OVER" if over else "ok"
        print(f"bucket {name}: {used}/{quota} bytes [{state}]", file=out)
        # merge into any existing rule at this prefix: a lifecycle TTL
        # (or other settings) at /buckets/<b>/ must survive the toggle
        if over and not (rule and rule.get("read_only")):
            if apply:
                merged = dict(rule or {"location_prefix": prefix,
                                       "collection": name})
                merged["read_only"] = True
                env._call(f"{filer}/__admin__/filer_conf", merged)
                changed += 1
            else:
                print(f"  would mark {prefix} read-only (-apply)",
                      file=out)
        elif not over and rule and rule.get("read_only"):
            if apply:
                keeps_other = any(rule.get(k) for k in
                                  ("ttl", "replication", "fsync",
                                   "disk_type"))
                if keeps_other:
                    env._call(f"{filer}/__admin__/filer_conf",
                              dict(rule, read_only=False))
                else:
                    env._call(f"{filer}/__admin__/filer_conf",
                              {"delete_prefix": prefix})
                changed += 1
            else:
                print(f"  would clear read-only on {prefix} (-apply)",
                      file=out)
    if apply:
        print(f"{changed} rule change(s) applied", file=out)


@command("s3.circuitbreaker")
def cmd_s3_circuitbreaker(env: CommandEnv, args, out):
    """Show or set the S3 gateway circuit-breaker limits, stored in the
    filer at /etc/s3/circuit_breaker.json and hot-reloaded by every
    gateway (reference: command_s3_circuitbreaker.go).
    [-global.requests N] [-global.uploadBytes N] [-bucket.requests N]
    [-apply]   (without -apply: print the stored config)"""
    flags = parse_flags(args)
    from seaweedfs_tpu_torch.s3.s3api_server import CIRCUIT_BREAKER_PATH
    filer = env.find_filer()
    if "apply" not in flags:
        try:
            raw = env.filer_read(filer, CIRCUIT_BREAKER_PATH)
            print(raw.decode(), file=out)
        except Exception:
            print("no circuit breaker configured", file=out)
        return
    cfg = {
        "global_max_requests": int(flags.get("global.requests", "0")),
        "global_max_upload_bytes": int(flags.get("global.uploadBytes", "0")),
        "bucket_max_requests": int(flags.get("bucket.requests", "0")),
    }
    req = urllib.request.Request(
        f"{_tls_scheme()}://{filer}"
        + urllib.parse.quote(CIRCUIT_BREAKER_PATH),
        data=json.dumps(cfg).encode(), method="PUT")
    with urllib.request.urlopen(req, timeout=60):
        pass
    print(f"s3.circuitbreaker applied: {json.dumps(cfg)}", file=out)


@command("remote.mount.buckets")
def cmd_remote_mount_buckets(env: CommandEnv, args, out):
    """Mount every bucket of an S3-class remote under -dir (reference:
    command_remote_mount_buckets.go): one subdirectory per bucket, each
    with placeholder entries + a recorded read-through mapping.
    -remote s3:endpoint=..,access_key=..,secret_key=.. [-dir /buckets]
    [-bucketPattern glob]"""
    import fnmatch
    flags = parse_flags(args)
    from seaweedfs_tpu_torch.remote_storage import (make_remote,
                                              parse_remote_spec,
                                              sync_remote_to_filer)
    kind, options = parse_remote_spec(flags.get("remote", ""))
    options.pop("bucket", None)
    base_dir = flags.get("dir", "/buckets").rstrip("/")
    pattern = flags.get("bucketPattern", "")
    probe = make_remote(kind, bucket="", **options)
    if not hasattr(probe, "list_buckets"):
        raise RuntimeError(f"remote kind {kind!r} cannot list buckets")
    filer = env.find_filer()
    mounted = 0
    for bucket in probe.list_buckets():
        if pattern and not fnmatch.fnmatch(bucket, pattern):
            continue
        remote = make_remote(kind, bucket=bucket, **options)
        mount_dir = f"{base_dir}/{bucket}"
        n = sync_remote_to_filer(remote, filer, mount_dir, cache=False)
        spec = f"{kind}:bucket={bucket}," + ",".join(
            f"{k}={v}" for k, v in options.items())
        env._call(f"{filer}/__admin__/remote_mounts",
                  {"set": {mount_dir: spec}})
        print(f"  {bucket}: {n} object(s) -> {mount_dir}", file=out)
        mounted += 1
    print(f"remote.mount.buckets: {mounted} bucket(s) mounted", file=out)


@command("mount.configure")
def cmd_mount_configure(env: CommandEnv, args, out):
    """Configure a RUNNING weedtpu mount through its admin unix socket
    (reference: command_mount_configure.go over the mount's local socket).
    -dir /mountpoint [-quotaMB N]  (0 clears the quota; no -quotaMB just
    prints the mount's current state)"""
    import socket as _socket
    flags = parse_flags(args)
    mountpoint = flags.get("dir")
    if not mountpoint:
        raise RuntimeError("-dir (the mountpoint) is required")
    from seaweedfs_tpu_torch.mount.weedfs import admin_socket_path
    payload: dict = {}
    if "quotaMB" in flags:
        payload["quota"] = int(float(flags["quotaMB"]) * 1024 * 1024)
    sock = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
    try:
        sock.settimeout(10)
        sock.connect(admin_socket_path(mountpoint))
        sock.sendall(json.dumps(payload).encode())
        sock.shutdown(_socket.SHUT_WR)
        resp = json.loads(sock.recv(65536))
    except (OSError, ValueError) as e:
        raise RuntimeError(
            f"no responding mount at {mountpoint} ({e})") from None
    finally:
        sock.close()
    if not resp.get("ok"):
        raise RuntimeError(f"mount.configure: {resp.get('error')}")
    quota = resp.get("quota", 0)
    print(f"mount at {mountpoint}: root={resp.get('root')} quota="
          + (f"{quota / (1024 * 1024):.0f}MB" if quota else "unlimited"),
          file=out)
