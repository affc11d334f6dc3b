"""The port's replication, notification and remote sinks on port clusters
(the port's master, port volume servers with `device="cpu"` and port
`FilerServer`s, in process on one asyncio loop in a thread with real
sockets).

- Twins of tests/test_replication.py that had none: the sync pump both
  ways and its resume, the local, cloud (S3 through the port's gateway,
  incremental, Azure) sinks, the CLI's filer client tools, the remote
  gateway's event applier, the notification queues and the filer's
  wiring, `filer.backup`'s mirror and `filer.meta.backup`'s resume.
  Each keeps its reference twin's name and checks.
- Across the packages: a port `FilerSync` between two reference filers
  and a reference `FilerSync` between two port filers; one package's
  pump resuming from the other's offsets file; each package's
  `LogFileSource` reading the other's `LogQueue`, whose lines are the
  same bytes.
- Kept apart from the reference on purpose: a malformed sync or audit
  knob raises where the pump or auditor is built; a stop cuts the
  pumps' live streams at once.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from tests.test_torch_master_cluster import Cluster, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _quiet_cluster(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")


def wait_for(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return False


def put(filer_url, path, data: bytes):
    req = urllib.request.Request(f"http://{filer_url}{path}", data=data,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status in (200, 201)


def get(filer_url, path) -> bytes | None:
    try:
        with urllib.request.urlopen(f"http://{filer_url}{path}",
                                    timeout=30) as r:
            return r.read()
    except urllib.error.HTTPError:
        return None


def delete(filer_url, path):
    req = urllib.request.Request(f"http://{filer_url}{path}",
                                 method="DELETE")
    urllib.request.urlopen(req, timeout=30).read()


@pytest.fixture()
def two_filers(tmp_path):
    """The port's master and one port volume server, two port filers on
    it (sync replicates metadata and content between them)."""
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    fa = FilerServer(c.master.url, port=free_port(),
                     data_dir=str(tmp_path / "fa"))
    fb = FilerServer(c.master.url, port=free_port(),
                     data_dir=str(tmp_path / "fb"))
    c.submit(fa.start())
    c.submit(fb.start())
    yield c, fa, fb
    c.submit(fa.stop())
    c.submit(fb.stop())
    c.stop()


@pytest.fixture()
def ref_two_filers(tmp_path):
    """The reference's cluster with two reference filers."""
    from seaweedfs_tpu.server.filer_server import FilerServer
    from tests.test_cluster import Cluster as RefCluster
    c = RefCluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    fa = FilerServer(c.master.url, port=free_port(),
                     data_dir=str(tmp_path / "rfa"))
    fb = FilerServer(c.master.url, port=free_port(),
                     data_dir=str(tmp_path / "rfb"))
    c.submit(fa.start())
    c.submit(fb.start())
    yield c, fa, fb
    c.submit(fa.stop())
    c.submit(fb.stop())
    c.stop()


# ---- twins of tests/test_replication.py -----------------------------------

def test_filer_sync_bidirectional(two_filers, tmp_path):
    from seaweedfs_tpu_torch.replication.filer_sync import FilerSync
    c, fa, fb = two_filers
    put(fa.url, "/pre/existing.txt", b"replayed")

    sync = FilerSync(fa.url, fb.url,
                     offset_path=str(tmp_path / "offsets.json"))
    sync.start()
    try:
        # replay of history
        assert wait_for(lambda: get(fb.url, "/pre/existing.txt")
                        == b"replayed")
        # live A -> B
        put(fa.url, "/live/a.txt", b"from-a")
        assert wait_for(lambda: get(fb.url, "/live/a.txt") == b"from-a")
        # live B -> A
        put(fb.url, "/live/b.txt", b"from-b")
        assert wait_for(lambda: get(fa.url, "/live/b.txt") == b"from-b")
        # no echo storm: applied counts settle
        time.sleep(1.0)
        applied = (sync.a2b.applied, sync.b2a.applied)
        time.sleep(1.0)
        assert (sync.a2b.applied, sync.b2a.applied) == applied
        # deletion propagates
        delete(fa.url, "/live/a.txt")
        assert wait_for(lambda: get(fb.url, "/live/a.txt") is None)
    finally:
        sync.stop()


def test_sync_resume_offsets(two_filers, tmp_path):
    from seaweedfs_tpu_torch.replication.filer_sync import FilerSync
    c, fa, fb = two_filers
    offsets = str(tmp_path / "off.json")
    put(fa.url, "/r1.txt", b"one")
    s1 = FilerSync(fa.url, fb.url, offset_path=offsets, one_way=True)
    s1.start()
    assert wait_for(lambda: get(fb.url, "/r1.txt") == b"one")
    s1.stop()
    # new events while sync is down
    put(fa.url, "/r2.txt", b"two")
    s2 = FilerSync(fa.url, fb.url, offset_path=offsets, one_way=True)
    s2.start()
    assert wait_for(lambda: get(fb.url, "/r2.txt") == b"two")
    s2.stop()
    assert json.load(open(offsets))


def test_local_sink_replicator(tmp_path):
    from seaweedfs_tpu_torch.replication.sink import LocalSink, Replicator
    sink = LocalSink(str(tmp_path / "mirror"))
    data_by_path = {"/x/f.txt": b"content"}
    rep = Replicator(sink, lambda p: data_by_path[p], "/")
    rep.replicate({"new_entry": {"full_path": "/x/f.txt",
                                 "is_directory": False}, "old_entry": None})
    assert (tmp_path / "mirror/x/f.txt").read_bytes() == b"content"
    # rename = delete old + create new
    data_by_path["/x/g.txt"] = b"content"
    rep.replicate({"old_entry": {"full_path": "/x/f.txt",
                                 "is_directory": False},
                   "new_entry": {"full_path": "/x/g.txt",
                                 "is_directory": False}})
    assert not (tmp_path / "mirror/x/f.txt").exists()
    assert (tmp_path / "mirror/x/g.txt").exists()
    rep.replicate({"old_entry": {"full_path": "/x/g.txt",
                                 "is_directory": False}, "new_entry": None})
    assert not (tmp_path / "mirror/x/g.txt").exists()


def test_cloud_sink_s3_mirror_with_resume(tmp_path):
    """filer tree -> S3 bucket through the queue-driven replicate daemon,
    against the port's SigV4-verifying gateway, with offset resume across
    a daemon restart."""
    from seaweedfs_tpu_torch.notification import LogQueue
    from seaweedfs_tpu_torch.replication.replicate_daemon import (
        LogFileSource, ReplicateDaemon, read_file_via_filer)
    from seaweedfs_tpu_torch.replication.sink import make_sink
    from tests.test_torch_s3 import CRED, S3Stack

    events_path = str(tmp_path / "events.jsonl")
    stack = S3Stack(tmp_path).start()
    queue = LogQueue(events_path)
    try:
        # wire the notification queue into the running filer (the CLI
        # does this at construction; the seam is the same attribute)
        stack.filer.notification = queue
        stack.filer.filer.meta_log.subscribe(stack.filer._notify_queue)
        st, _, _ = stack.req("PUT", "/mirror-bucket")
        assert st == 200

        put(stack.filer.url, "/src/a.txt", b"alpha")
        put(stack.filer.url, "/src/sub/b.txt", b"beta")
        put(stack.filer.url, "/other/ignored.txt", b"out of scope")

        def make_daemon():
            sink = make_sink("s3", endpoint=stack.s3.url,
                             bucket="mirror-bucket",
                             access_key=CRED.access_key,
                             secret_key=CRED.secret_key)
            return ReplicateDaemon(
                LogFileSource(events_path, poll_interval=0.05), sink,
                read_file_via_filer(stack.filer.url), prefix="/src",
                offset_path=str(tmp_path / "rep_offsets.json"),
                offset_key="test")

        d1 = make_daemon()
        d1.run_in_thread()
        assert wait_for(lambda: stack.req(
            "GET", "/mirror-bucket/src/a.txt")[1] == b"alpha")
        assert wait_for(lambda: stack.req(
            "GET", "/mirror-bucket/src/sub/b.txt")[1] == b"beta")
        # out-of-scope file is not mirrored
        st, _, _ = stack.req("GET", "/mirror-bucket/other/ignored.txt")
        assert st == 404
        d1.stop()
        time.sleep(0.2)

        # events while the daemon is down; a fresh daemon resumes from the
        # stored offset and applies only the new ones
        put(stack.filer.url, "/src/c.txt", b"gamma")
        d2 = make_daemon()
        d2.run_in_thread()
        assert wait_for(lambda: stack.req(
            "GET", "/mirror-bucket/src/c.txt")[1] == b"gamma")
        assert d2.applied <= 2, "resume must not replay applied events"

        # deletion propagates to the bucket
        delete(stack.filer.url, "/src/a.txt")
        assert wait_for(lambda: stack.req(
            "GET", "/mirror-bucket/src/a.txt")[0] == 404)
        d2.stop()
    finally:
        stack.stop()
        queue.close()


def test_cloud_sink_incremental_and_dir_delete(tmp_path):
    """CloudSink over the local-dir remote: incremental mode date-prefixes
    keys and never deletes; normal mode deletes recursively via traverse
    (object stores have no rmdir)."""
    from seaweedfs_tpu_torch.remote_storage import LocalDirRemote
    from seaweedfs_tpu_torch.replication.sink import CloudSink, Replicator

    store = str(tmp_path / "store")
    sink = CloudSink(LocalDirRemote(store))
    rep = Replicator(sink, lambda p: b"data", "/")
    rep.replicate({"new_entry": {"full_path": "/d/x.txt",
                                 "is_directory": False}, "old_entry": None})
    rep.replicate({"new_entry": {"full_path": "/d/y.txt",
                                 "is_directory": False}, "old_entry": None})
    assert (tmp_path / "store/d/x.txt").exists()
    # directory delete fans out over traverse
    rep.replicate({"old_entry": {"full_path": "/d", "is_directory": True},
                   "new_entry": None})
    assert not (tmp_path / "store/d/x.txt").exists()
    assert not (tmp_path / "store/d/y.txt").exists()

    inc = CloudSink(LocalDirRemote(store), incremental=True)
    rep2 = Replicator(inc, lambda p: b"data", "/")
    rep2.replicate({"new_entry": {"full_path": "/d/z.txt",
                                  "is_directory": False},
                    "old_entry": None})
    dated = time.strftime("%Y-%m-%d")
    assert (tmp_path / f"store/{dated}/d/z.txt").exists()
    # incremental never deletes (Replicator guards on is_incremental)
    rep2.replicate({"old_entry": {"full_path": "/d/z.txt",
                                  "is_directory": False}, "new_entry": None})
    assert (tmp_path / f"store/{dated}/d/z.txt").exists()


def test_azure_sink_wire(tmp_path):
    """AzureSink = CloudSink over the port's AzureRemote, against the
    reference tests' SharedKey-verifying fake endpoint."""
    import base64

    from seaweedfs_tpu_torch.replication.sink import Replicator, make_sink
    from tests.test_backend_tier import _FakeAzure

    key = base64.b64encode(b"0123456789abcdef0123456789abcdef").decode()
    fake = _FakeAzure("acct", key)
    endpoint = fake.start()
    try:
        sink = make_sink("azure", account="acct", container="backup",
                         account_key=key, endpoint=endpoint)
        rep = Replicator(sink, lambda p: b"azure-bytes", "/")
        rep.replicate({"new_entry": {"full_path": "/docs/f.bin",
                                     "is_directory": False},
                       "old_entry": None})
        assert fake.blobs.get("docs/f.bin") == b"azure-bytes"
        rep.replicate({"old_entry": {"full_path": "/docs/f.bin",
                                     "is_directory": False},
                       "new_entry": None})
        assert "docs/f.bin" not in fake.blobs
    finally:
        fake.stop()


def _cli(*argv, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", *argv], cwd=REPO,
        capture_output=True, text=True, timeout=timeout)


def test_cli_filer_tools(two_filers, tmp_path):
    """The port CLI's filer.copy / filer.cat / filer.meta.tail round trip
    against a live port filer."""
    c, fa, _ = two_filers
    src = tmp_path / "up"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(b"alpha")
    (src / "sub" / "b.txt").write_bytes(b"beta")

    r = _cli("filer.copy", "-filer", fa.url, str(src), "/dst/")
    assert r.returncode == 0, r.stderr
    assert "2 file(s) uploaded" in r.stdout
    assert get(fa.url, "/dst/up/a.txt") == b"alpha"
    assert get(fa.url, "/dst/up/sub/b.txt") == b"beta"

    out = tmp_path / "cat.out"
    r = _cli("filer.cat", "-filer", fa.url, "-o", str(out), "/dst/up/a.txt")
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == b"alpha"
    r = _cli("filer.cat", "-filer", fa.url, "/dst/up/missing.txt")
    assert r.returncode == 1 and "HTTP 404" in r.stderr

    # meta.tail replay: -untilTimeAgo ~now makes the stream finite
    r = _cli("filer.meta.tail", "-filer", fa.url, "-timeAgo", "300",
             "-untilTimeAgo", "0.001", "-pattern", "*.txt")
    assert r.returncode == 0, r.stderr
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.strip()]
    paths = {(e.get("new_entry") or {}).get("full_path") for e in lines}
    assert "/dst/up/a.txt" in paths


def test_remote_gateway_event_mapping(two_filers, tmp_path):
    """filer.remote.gateway's event applier: bucket dirs -> remote bucket
    create/delete, object writes -> remote object writes."""
    import seaweedfs_tpu_torch.__main__ as main_mod
    c, fa, _ = two_filers

    class RecordingRemote:
        def __init__(self):
            self.calls = []
            self.objects = {}

        def create_bucket(self):
            self.calls.append("create_bucket")

        def delete_bucket(self):
            self.calls.append("delete_bucket")

        def write_file(self, key, data):
            self.objects[key] = data

        def delete_file(self, key):
            self.objects.pop(key, None)

    remotes: dict = {}

    def bucket_remote(bucket):
        return remotes.setdefault(bucket, RecordingRemote())

    # generate real events through the filer, then replay them
    req = urllib.request.Request(f"http://{fa.url}/buckets/b1/",
                                 data=b"", method="POST")
    urllib.request.urlopen(req, timeout=30)
    put(fa.url, "/buckets/b1/obj.txt", b"payload")
    delete(fa.url, "/buckets/b1/obj.txt")

    with urllib.request.urlopen(
            f"http://{fa.url}/__meta__/subscribe?since=0&prefix=/buckets"
            "&live=false", timeout=30) as r:
        events = [json.loads(ln) for ln in r.read().splitlines()
                  if ln.strip()]
    assert events, "no bucket events replayed"
    for ev in events:
        main_mod._apply_gateway_event(ev, "/buckets", bucket_remote, fa.url)
    assert "create_bucket" in remotes["b1"].calls
    assert "obj.txt" not in remotes["b1"].objects  # written then deleted


def test_notification_queue(tmp_path):
    from seaweedfs_tpu_torch.notification import make_queue
    q = make_queue("log", path=str(tmp_path / "events.jsonl"))
    q.send("/dir", {"ts_ns": 1, "directory": "/dir"})
    q.send("/dir2", {"ts_ns": 2, "directory": "/dir2"})
    q.close()
    lines = open(tmp_path / "events.jsonl").read().splitlines()
    assert len(lines) == 2 and json.loads(lines[0])["key"] == "/dir"
    mq = make_queue("memory")
    mq.send("k", {"a": 1})
    assert list(mq.messages) == [("k", {"a": 1})]
    with pytest.raises(ValueError):
        make_queue("kafka")


def test_filer_notification_wiring(tmp_path):
    from seaweedfs_tpu_torch.notification import MemoryQueue
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    q = MemoryQueue()
    f = FilerServer(c.master.url, port=free_port(), notification=q)
    c.submit(f.start())
    try:
        put(f.url, "/n/file.txt", b"x")
        assert wait_for(lambda: any(
            (m.get("new_entry") or {}).get("full_path") == "/n/file.txt"
            for _, m in list(q.messages)))
    finally:
        c.submit(f.stop())
        c.stop()


def test_filer_backup_to_local_dir(two_filers, tmp_path):
    """filer.backup: one-way mirror into a local directory with resume
    offsets."""
    from seaweedfs_tpu_torch.replication.filer_sync import (SyncDirection,
                                                            SyncOffsetStore)
    from seaweedfs_tpu_torch.replication.sink import LocalSink
    c, fa, _ = two_filers
    put(fa.url, "/bk/one.txt", b"mirror me")
    target = tmp_path / "mirror"
    d = SyncDirection(fa.url, f"local:{target}",
                      offsets=SyncOffsetStore(str(tmp_path / "off.json")),
                      sink=LocalSink(str(target)))
    stop = threading.Event()
    th = threading.Thread(target=d.run, args=(stop,), daemon=True)
    th.start()
    try:
        assert wait_for(
            lambda: (target / "bk/one.txt").exists() and
            (target / "bk/one.txt").read_bytes() == b"mirror me")
        put(fa.url, "/bk/two.txt", b"live")
        assert wait_for(lambda: (target / "bk/two.txt").exists())
    finally:
        stop.set()
        d.abort()
        th.join(5)
    assert not th.is_alive()
    # resume: a fresh direction on the same offset store skips already-
    # applied events and picks up new ones
    d.offsets.flush()
    put(fa.url, "/bk/three.txt", b"after-restart")
    d2 = SyncDirection(fa.url, f"local:{target}",
                       offsets=SyncOffsetStore(str(tmp_path / "off.json")),
                       sink=LocalSink(str(target)))
    stop2 = threading.Event()
    th2 = threading.Thread(target=d2.run, args=(stop2,), daemon=True)
    th2.start()
    try:
        assert wait_for(lambda: (target / "bk/three.txt").exists())
        assert d2.applied <= 2  # dir event + new file; no full replay
    finally:
        stop2.set()
        d2.abort()
        th2.join(5)
    assert not th2.is_alive()


def test_webhook_notification_queue():
    """The SDK-free webhook backend POSTs each meta event as JSON (with
    sink-style retry), verified against a local collector; its close
    ends the drain thread."""
    import http.server

    from seaweedfs_tpu_torch.notification import make_queue

    got = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            got.append(json.loads(body))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        q = make_queue("webhook",
                       url=f"http://127.0.0.1:{srv.server_port}/events")
        q.send("/dir/f.txt", {"event": "create", "size": 12})
        # delivery is asynchronous (worker thread): poll for arrival
        deadline = time.time() + 10
        while time.time() < deadline and not got:
            time.sleep(0.05)
        assert got == [{"key": "/dir/f.txt", "event": "create", "size": 12}]
        q.close()
        assert not q._worker.is_alive()
    finally:
        srv.shutdown()
        srv.server_close()


def test_filer_meta_backup_resume(two_filers, tmp_path):
    """The port CLI's filer.meta.backup mirrors metadata into a local
    sqlite store with offset resume; the backup store holds the chunk
    refs a filer would serve the tree from."""
    from seaweedfs_tpu_torch.filer.abstract_sql import SqliteStore
    c, fa, _ = two_filers
    put(fa.url, "/mb/one.txt", b"1" * 100)
    put(fa.url, "/mb/two.txt", b"2" * 100)
    db = str(tmp_path / "meta-backup.db")

    def run_backup(seconds: float):
        p = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch",
             "filer.meta.backup", "-filer", fa.url, "-store",
             f"sqlite:{db}"], cwd=REPO, stdout=subprocess.PIPE)
        try:
            line = p.stdout.readline()  # blocks until the child is tailing
            assert b"tailing" in line, f"no readiness marker: {line!r}"
            time.sleep(seconds)
            p.send_signal(2)  # SIGINT: flush + exit
            p.wait(timeout=40)
        finally:
            if p.poll() is None:
                p.kill()
            p.stdout.close()

    run_backup(1.5)
    s = SqliteStore(db)
    assert s.find_entry("/mb/one.txt").attr.file_size == 100
    offset1 = int(s.kv_get(b"__meta_backup_offset__"))
    assert offset1 > 0
    s.shutdown()
    # events while backup is down; resumed run picks them up
    put(fa.url, "/mb/three.txt", b"3" * 100)
    run_backup(1.5)
    s = SqliteStore(db)
    assert s.find_entry("/mb/three.txt").attr.file_size == 100
    assert int(s.kv_get(b"__meta_backup_offset__")) > offset1
    # the backup store IS a filer store: chunk refs survive
    assert s.find_entry("/mb/one.txt").chunks
    s.shutdown()


# ---- across the packages ----------------------------------------------------

@pytest.mark.parametrize("pump", ["port_over_reference", "reference_over_port"])
def test_sync_between_the_other_packages_filers(pump, request, tmp_path):
    """A port `FilerSync` keeps two reference filers in step, and a
    reference `FilerSync` two port filers: history replayed, live writes
    both ways, a delete, no echo, equal digests."""
    if pump == "port_over_reference":
        from seaweedfs_tpu_torch.replication.filer_sync import FilerSync
        c, fa, fb = request.getfixturevalue("ref_two_filers")
    else:
        from seaweedfs_tpu.replication.filer_sync import FilerSync
        c, fa, fb = request.getfixturevalue("two_filers")
    put(fa.url, "/x/pre.txt", b"history")
    sync = FilerSync(fa.url, fb.url, prefix="/x",
                     offset_path=str(tmp_path / "off.json"))
    sync.start()
    try:
        assert wait_for(lambda: get(fb.url, "/x/pre.txt") == b"history")
        put(fa.url, "/x/a.txt", b"from-a" * 50)
        put(fb.url, "/x/b.txt", b"from-b" * 50)
        assert wait_for(lambda: get(fb.url, "/x/a.txt") == b"from-a" * 50)
        assert wait_for(lambda: get(fa.url, "/x/b.txt") == b"from-b" * 50)
        delete(fa.url, "/x/pre.txt")
        assert wait_for(lambda: get(fb.url, "/x/pre.txt") is None)

        def digest(u):
            with urllib.request.urlopen(
                    f"http://{u}/__meta__/digest?prefix=/x",
                    timeout=30) as r:
                return json.loads(r.read())["digest"]
        assert wait_for(lambda: digest(fa.url) == digest(fb.url), 15)
        assert wait_for(lambda: sync.a2b.skipped > 0 and
                        sync.b2a.skipped > 0, 15)
        applied = (sync.a2b.applied, sync.b2a.applied)
        time.sleep(1.0)
        assert (sync.a2b.applied, sync.b2a.applied) == applied
    finally:
        sync.stop()


@pytest.mark.parametrize("first", ["reference", "port"])
def test_pump_resumes_from_the_other_packages_offsets(first, two_filers,
                                                      tmp_path):
    """One package's one-way pump writes the offsets file; the other
    package's resumes from it, applying only what came after."""
    from seaweedfs_tpu.replication import filer_sync as ref_sync
    from seaweedfs_tpu_torch.replication import filer_sync as port_sync
    a, b = (ref_sync, port_sync) if first == "reference" else \
        (port_sync, ref_sync)
    c, fa, fb = two_filers
    offsets = str(tmp_path / "off.json")
    for i in range(4):
        put(fa.url, f"/o/a{i}.txt", b"%d" % i * 20)
    s1 = a.FilerSync(fa.url, fb.url, prefix="/o", offset_path=offsets,
                     one_way=True)
    s1.start()
    assert wait_for(lambda: all(get(fb.url, f"/o/a{i}.txt") is not None
                                for i in range(4)))
    s1.stop()
    off = json.load(open(offsets))
    assert list(off) == [f"{fa.url}=>{fb.url}"] and off[s1.a2b.key] > 0
    for i in range(3):
        put(fa.url, f"/o/gap{i}.txt", b"g%d" % i * 20)
    s2 = b.FilerSync(fa.url, fb.url, prefix="/o", offset_path=offsets,
                     one_way=True)
    s2.start()
    try:
        assert wait_for(lambda: all(
            get(fb.url, f"/o/gap{i}.txt") == b"g%d" % i * 20
            for i in range(3)))
        time.sleep(0.5)
        assert 3 <= s2.a2b.applied < 4 + 3 + 1
    finally:
        s2.stop()
    assert json.load(open(offsets))[s2.a2b.key] > off[s1.a2b.key]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_log_queue_lines_cross_the_packages(writer, tmp_path):
    """Both packages' `LogQueue`s write the same bytes for the same
    events, and each package's `LogFileSource` reads the other's log:
    the same (offset, event) pairs, the offsets byte positions."""
    from seaweedfs_tpu import notification as ref_notification
    from seaweedfs_tpu.replication import replicate_daemon as ref_daemon
    from seaweedfs_tpu_torch import notification
    from seaweedfs_tpu_torch.replication import replicate_daemon

    events = [("/d", {"ts_ns": 10 + i, "directory": "/d",
                      "new_entry": {"full_path": f"/d/f{i}.bin",
                                    "attr": {"mode": 0o644}},
                      "old_entry": None, "signatures": [i]})
              for i in range(5)]
    paths = {}
    for name, mod in (("reference", ref_notification),
                      ("port", notification)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        q = mod.LogQueue(paths[name])
        for key, msg in events:
            q.send(key, msg)
        q.close()
    with open(paths["reference"], "rb") as f:
        ref_bytes = f.read()
    with open(paths["port"], "rb") as f:
        assert f.read() == ref_bytes
    reader = replicate_daemon if writer == "reference" else ref_daemon
    got = []
    stop = threading.Event()
    for offset, ev in reader.LogFileSource(paths[writer],
                                           poll_interval=0.01).receive(
                                               0, stop):
        got.append((offset, ev))
        if len(got) == len(events):
            stop.set()
    want_offsets = [ref_bytes.index(b"\n", ref_bytes.index(
        f'/d/f{i}.bin"'.encode())) + 1 for i in range(5)]
    assert [o for o, _ in got] == want_offsets
    assert [ev["new_entry"]["full_path"] for _, ev in got] == \
        [f"/d/f{i}.bin" for i in range(5)]
    assert all(ev["key"] == "/d" for _, ev in got)


def test_daemon_replicates_the_other_packages_log(two_filers, tmp_path):
    """The reference's `ReplicateDaemon` applies a port filer's
    `LogQueue` to a local mirror, and the port's daemon resumes from the
    reference's offsets file."""
    from seaweedfs_tpu.replication import replicate_daemon as ref_daemon
    from seaweedfs_tpu.replication.sink import LocalSink as RefLocalSink
    from seaweedfs_tpu_torch.notification import LogQueue
    from seaweedfs_tpu_torch.replication import replicate_daemon
    from seaweedfs_tpu_torch.replication.sink import LocalSink
    c, fa, _ = two_filers
    log_path = str(tmp_path / "events.jsonl")
    q = LogQueue(log_path)
    fa.notification = q
    fa.filer.meta_log.subscribe(fa._notify_queue)
    mirror = tmp_path / "mirror"
    offsets = str(tmp_path / "rep.json")
    try:
        put(fa.url, "/l/one.txt", b"one" * 10)
        d1 = ref_daemon.ReplicateDaemon(
            ref_daemon.LogFileSource(log_path, poll_interval=0.05),
            RefLocalSink(str(mirror)),
            ref_daemon.read_file_via_filer(fa.url), prefix="/l",
            offset_path=offsets, offset_key="x")
        th = d1.run_in_thread()
        assert wait_for(lambda: (mirror / "l/one.txt").exists())
        d1.stop()
        th.join(5)
        put(fa.url, "/l/two.txt", b"two" * 10)
        d2 = replicate_daemon.ReplicateDaemon(
            replicate_daemon.LogFileSource(log_path, poll_interval=0.05),
            LocalSink(str(mirror)),
            replicate_daemon.read_file_via_filer(fa.url), prefix="/l",
            offset_path=offsets, offset_key="x")
        d2.run_in_thread()
        try:
            assert wait_for(lambda: (mirror / "l/two.txt").exists())
            assert (mirror / "l/two.txt").read_bytes() == b"two" * 10
            assert d2.applied == 1  # resumed: one.txt not applied again
        finally:
            d2.stop()
        assert not d2._thread.is_alive()
    finally:
        q.close()


# ---- kept apart from the reference on purpose -------------------------------

KNOBS = [("WEEDTPU_GEO_OBS", "yes"), ("WEEDTPU_SYNC_STALL_AFTER", "soon"),
         ("WEEDTPU_SYNC_BACKLOG_INTERVAL", "often"),
         ("WEEDTPU_SYNC_BACKOFF_BASE", "half"),
         ("WEEDTPU_SYNC_BACKOFF_CAP", "lots")]


@pytest.mark.parametrize("name,value", KNOBS)
def test_malformed_sync_knob_raises_unlike_the_reference(name, value,
                                                         monkeypatch):
    """A malformed sync knob raises ValueError where the port's pump is
    built, before a thread starts.  The reference builds its pump and
    reads anything but "0" as on (GEO_OBS), or raises only later, inside
    its pump thread (STALL_AFTER, BACKLOG_INTERVAL); its backoff knobs
    raise at construction too."""
    from seaweedfs_tpu.replication import filer_sync as ref_sync
    from seaweedfs_tpu_torch.replication import filer_sync
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=name):
        filer_sync.SyncDirection("127.0.0.1:1", "127.0.0.1:2")
    if "BACKOFF" in name:
        with pytest.raises(ValueError):
            ref_sync.SyncDirection("127.0.0.1:1", "127.0.0.1:2")
    else:
        ref_sync.SyncDirection("127.0.0.1:1", "127.0.0.1:2")
    if name == "WEEDTPU_GEO_OBS":
        assert ref_sync.geo_obs_enabled()


def test_malformed_audit_interval_raises_unlike_the_reference(monkeypatch):
    from seaweedfs_tpu.stats import canary as ref_canary
    from seaweedfs_tpu_torch.stats import canary
    monkeypatch.setenv("WEEDTPU_GEO_AUDIT_INTERVAL", "hourly")
    assert ref_canary.geo_audit_interval() == 30.0
    ref_canary.DivergenceAuditor("127.0.0.1:1", "127.0.0.1:2")
    with pytest.raises(ValueError, match="WEEDTPU_GEO_AUDIT_INTERVAL"):
        canary.DivergenceAuditor("127.0.0.1:1", "127.0.0.1:2")


def test_stop_ends_the_live_streams_at_once(two_filers, tmp_path):
    """With both pumps caught up and parked in their live streams, the
    port's `FilerSync.stop` returns at once with every thread ended (the
    filers' keepalive comes every 5 s, which the reference's pumps wait
    for: it has no `abort`)."""
    from seaweedfs_tpu.replication import filer_sync as ref_sync
    from seaweedfs_tpu_torch.replication.filer_sync import FilerSync
    c, fa, fb = two_filers
    put(fa.url, "/s/a.txt", b"a")
    sync = FilerSync(fa.url, fb.url, prefix="/s",
                     offset_path=str(tmp_path / "off.json"))
    sync.start()
    assert wait_for(lambda: get(fb.url, "/s/a.txt") == b"a")
    assert wait_for(lambda: all(d._resp is not None
                                for d in sync.directions()))
    t0 = time.perf_counter()
    sync.stop()
    took = time.perf_counter() - t0
    assert not any(th.is_alive() for th in sync._threads)
    assert took < 2.0, took
    assert not hasattr(ref_sync.SyncDirection, "abort")
