"""The port's read-only master follower (`seaweedfs_tpu_torch/server/
master_follower.py`) held against the reference's.

A twin of tests/test_replication.py's `test_master_follower_lookup_and_proxy`
on a port cluster.  The reference's test seeds a volume through a filer;
the port has none yet, so a client upload seeds it here.
"""

import json
import urllib.error
import urllib.request

import pytest

from seaweedfs_tpu.server.master_follower import \
    MasterFollower as RefFollower

from seaweedfs_tpu_torch.client import WeedClient
from seaweedfs_tpu_torch.server.master_follower import MasterFollower
from tests.test_torch_master_cluster import Cluster, free_port


@pytest.fixture(autouse=True)
def _quiet_cluster(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")


def _get(url: str):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


def test_master_follower_lookup_and_proxy(tmp_path):
    """master.follower serves lookups from the streamed vid map and
    proxies assigns to the leader (reference: command/master_follower.go)."""
    c = Cluster(tmp_path, n_volume_servers=2).start()
    c.wait_heartbeats()
    seeder = WeedClient(c.master.url)
    seeder.upload(b"x" * 500, name="seed.txt")  # ensure a volume exists
    mf = MasterFollower(c.master.url, port=free_port())
    c.submit(mf.start())
    try:
        # assign THROUGH the follower, upload, then look the vid up on
        # the follower itself
        cl = WeedClient(mf.url)
        fid = cl.upload(b"via-follower", name="f.bin")
        vid = int(fid.split(",")[0])
        locs = json.loads(urllib.request.urlopen(
            f"http://{mf.url}/dir/lookup?volumeId={vid}",
            timeout=30).read())
        assert locs["locations"], locs
        assert cl.download(fid) == b"via-follower"
        cl.close()
        page = urllib.request.urlopen(f"http://{mf.url}/",
                                      timeout=30).read().decode()
        assert "master follower" in page
    finally:
        c.submit(mf.stop())
        seeder.close()
        c.stop()


def test_follower_answers_as_the_leader_and_the_reference_follower(tmp_path):
    """The proxied GETs answer what the leader answers; a miss is the
    reference follower's 404, a malformed id its 400; /metrics is the
    process's exposition.  The reference's follower, on the same
    cluster, answers the same lookup the same way."""
    c = Cluster(tmp_path, n_volume_servers=2).start()
    c.wait_heartbeats()
    seeder = WeedClient(c.master.url)
    fid = seeder.upload(b"y" * 700, name="seed.txt")
    vid = int(fid.split(",")[0])
    mf = MasterFollower(c.master.url, port=free_port())
    c.submit(mf.start())
    # drawn once mf holds its port: two draws in a row may name one port
    ref = RefFollower(c.master.url, port=free_port())
    c.submit(ref.start())
    try:
        for path in ("/dir/status", "/dir/ec/lookup?volumeId=%d" % vid):
            try:
                want = _get(f"http://{c.master.url}{path}")
            except urllib.error.HTTPError as e:
                want = (e.code, e.read())
            try:
                got = _get(f"http://{mf.url}{path}")
            except urllib.error.HTTPError as e:
                got = (e.code, e.read())
            assert got[0] == want[0], path
            if got[0] == 200 and path == "/dir/status":
                assert json.loads(got[1])["Topology"]["nodes"].keys() == \
                    json.loads(want[1])["Topology"]["nodes"].keys()
        status, body = _get(f"http://{mf.url}/cluster/status")
        assert json.loads(body)["Leader"] == c.master.url
        port_ans = json.loads(_get(
            f"http://{mf.url}/dir/lookup?volumeId={vid}")[1])
        ref_ans = json.loads(_get(
            f"http://{ref.url}/dir/lookup?volumeId={vid}")[1])
        assert port_ans == ref_ans
        for follower in (mf, ref):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(f"http://{follower.url}/dir/lookup?volumeId=x")
            assert ei.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(f"http://{follower.url}/dir/lookup?volumeId=4242")
            assert ei.value.code == 404
        status, body = _get(f"http://{mf.url}/metrics")
        assert status == 200 and b"# TYPE" in body
        # /vol/grow goes to the leader
        req = urllib.request.Request(f"http://{mf.url}/vol/grow?count=1",
                                     data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["count"] == 1
    finally:
        c.submit(mf.stop())
        c.submit(ref.stop())
        seeder.close()
        c.stop()


def test_follower_route_table_equals_the_reference():
    def routes(app):
        return sorted((r.method, r.resource.canonical)
                      for r in app.router.routes())
    port = MasterFollower("127.0.0.1:1", port=1)
    ref = RefFollower("127.0.0.1:1", port=1)
    try:
        assert routes(port.app) == routes(ref.app)
    finally:
        port.client.close()
        ref.client.close()
