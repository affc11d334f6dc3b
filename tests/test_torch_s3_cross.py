"""The port's S3 gateway held to the reference's, side by side:

- **Same requests, same answers.**  One signed request script (a bucket,
  a PUT, an aws-chunked PUT, a copy, tagging, a 3-part multipart upload,
  ListObjectsV2 with a delimiter and continuation, ListObjects V1 with a
  marker, a Range GET, HEADs, a batch delete, a bucket policy and its
  403s, the 404 and 403 error bodies) runs against a reference stack
  (reference master, volume server, `FilerServer`, `S3ApiServer`) and a
  port stack.  Status codes, XML bodies, object bytes, `ETag` (the
  multipart `-N` form too), `Content-Range`, `Content-Length`,
  `Content-Type` and the user metadata headers are equal.  Masked, as
  they differ by time, port or random id: the XML elements
  `LastModified`, `CreationDate`, `Initiated` (times), `UploadId` and
  `RequestId` (random ids) and `Location` (the gateway's host:port).
- **Signatures cross.**  For fixed inputs each package's `sign_v4` and
  `sign_v4_chunked` give the other's headers and body byte for byte, and
  a request signed by either package's function verifies in both
  gateways.
- **Buckets cross.**  A bucket written through one package's stack
  (objects, a multi-chunk object, a multipart object, metadata, tags)
  is served byte for byte by the other package's stack started over the
  same volume and filer directories, both ways.
- **The canary's s3 path.**  A master's canary, run once with
  `paths=("s3",)`, gives `ok` against a gateway without IAM that
  registered through `master_url` and `skip` against one with IAM (the
  auth wall), for the port's master over either package's gateway and
  for the reference master over the port's.
"""

import hashlib
import re
import time
import urllib.error
import urllib.parse
import urllib.request
from unittest import mock

import numpy as np
import pytest

from seaweedfs_tpu.s3 import auth as ref_auth
from tests import test_cluster as ref_cluster
from tests.test_s3 import S3Stack as RefS3Stack

from seaweedfs_tpu_torch.s3 import auth
from tests.test_torch_master_cluster import Cluster, free_port
from tests.test_torch_s3 import CRED, QUIET_ENV, READER
from tests.test_torch_s3 import S3Stack as PortS3Stack

PACKAGES = {"reference": ref_auth, "port": auth}


def _send(host, method, path, query=None, data=None, headers=None):
    qs = urllib.parse.urlencode(query or {})
    url = f"http://{host}{urllib.parse.quote(path)}" + (f"?{qs}" if qs else "")
    r = urllib.request.Request(url, data=data, method=method,
                               headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _signed(signer, host, method, path, query=None, data=None,
            headers=None, cred=CRED):
    cred = signer.Credential(cred.access_key, cred.secret_key)
    h = dict(headers or {})
    h.update(signer.sign_v4(cred, method, host, path, query or {},
                            payload=data or b""))
    return _send(host, method, path, query, data, h)


# ---- same requests, same answers --------------------------------------------

MASKED = ("LastModified", "CreationDate", "Initiated", "UploadId",
          "RequestId", "Location")
_MASK = re.compile(r"<(%s)>[^<]*</\1>" % "|".join(MASKED))
KEPT_HEADERS = ("ETag", "Content-Range", "Content-Length", "Content-Type",
                "Accept-Ranges")


def _record(resp):
    status, body, headers = resp
    kept = {h: headers[h] for h in KEPT_HEADERS if h in headers}
    kept.update({h.lower(): v for h, v in headers.items()
                 if h.lower().startswith("x-amz-meta-")})
    if body.startswith(b"<?xml"):
        body = _MASK.sub(lambda m: f"<{m.group(1)}>*</{m.group(1)}>",
                         body.decode())
    return status, body, kept


def _part(n):
    return np.random.default_rng(n).bytes((300_000, 200_000, 1_000)[n])


def _script(host):
    """The request script through one gateway, signed by that package's
    own signer, as `(step, status, body, headers)` records."""
    signer = PACKAGES["port"]
    out = []

    def step(name, resp):
        out.append((name,) + _record(resp))
        return resp

    def s(*a, **k):
        return _signed(signer, host, *a, **k)

    step("create", s("PUT", "/xbkt"))
    step("create-again", s("PUT", "/xbkt"))
    step("bad-name", s("PUT", "/XB"))
    step("put", s("PUT", "/xbkt/a.txt", data=b"hello cross",
                  headers={"Content-Type": "text/plain",
                           "x-amz-meta-color": "blue"}))
    payload = bytes(range(256)) * 700
    h, body = signer.sign_v4_chunked(
        signer.Credential(CRED.access_key, CRED.secret_key), "PUT", host,
        "/xbkt/dir/chunked.bin", {}, payload, chunk_size=64 * 1024)
    step("chunked-put", _send(host, "PUT", "/xbkt/dir/chunked.bin",
                              data=body, headers=h))
    step("chunked-get", s("GET", "/xbkt/dir/chunked.bin"))
    step("copy", s("PUT", "/xbkt/dir/copy.txt",
                   headers={"x-amz-copy-source": "/xbkt/a.txt"}))
    step("get-copy", s("GET", "/xbkt/dir/copy.txt"))
    tags = (b"<Tagging><TagSet><Tag><Key>env</Key><Value>prod</Value></Tag>"
            b"</TagSet></Tagging>")
    step("tag", s("PUT", "/xbkt/a.txt", query={"tagging": ""}, data=tags))
    step("get-tags", s("GET", "/xbkt/a.txt", query={"tagging": ""}))
    st, body, _ = step("initiate", s("POST", "/xbkt/mp/big.bin",
                                     query={"uploads": ""}, data=b""))
    upload_id = re.search(rb"<UploadId>([^<]+)</UploadId>", body).group(1)
    upload_id = upload_id.decode()
    etags = []
    for n in range(3):
        _, _, ph = step(f"part{n + 1}", s(
            "PUT", "/xbkt/mp/big.bin", data=_part(n),
            query={"partNumber": str(n + 1), "uploadId": upload_id}))
        etags.append(ph["ETag"])
    step("list-parts", s("GET", "/xbkt/mp/big.bin",
                         query={"uploadId": upload_id}))
    step("list-uploads", s("GET", "/xbkt", query={"uploads": ""}))
    complete = ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n + 1}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in enumerate(etags)) + "</CompleteMultipartUpload>")
    step("complete", s("POST", "/xbkt/mp/big.bin",
                       query={"uploadId": upload_id},
                       data=complete.encode()))
    step("get-multipart", s("GET", "/xbkt/mp/big.bin"))
    step("head-multipart", s("HEAD", "/xbkt/mp/big.bin"))
    step("range", s("GET", "/xbkt/mp/big.bin",
                    headers={"Range": "bytes=299990-300009"}))
    step("range-suffix", s("GET", "/xbkt/mp/big.bin",
                           headers={"Range": "bytes=-7"}))
    step("head", s("HEAD", "/xbkt/a.txt"))
    step("get-meta", s("GET", "/xbkt/a.txt"))
    for k in ("z.txt", "dir/e.txt", "dir/sub/f.txt", "b.txt"):
        step(f"put-{k}", s("PUT", f"/xbkt/{k}", data=k.encode()))
    token = ""
    for page in range(6):
        q = {"list-type": "2", "delimiter": "/", "max-keys": "2"}
        if token:
            q["continuation-token"] = token
        _, body, _ = step(f"list-v2-{page}", s("GET", "/xbkt", query=q))
        m = re.search(rb"<NextContinuationToken>([^<]*)<", body)
        if m is None:
            break
        token = urllib.parse.unquote(m.group(1).decode())
    step("list-v2-prefix", s("GET", "/xbkt", query={
        "list-type": "2", "prefix": "dir/", "start-after": "dir/copy.txt"}))
    step("list-v1-marker", s("GET", "/xbkt", query={"marker": "dir/e.txt",
                                                     "max-keys": "3"}))
    step("batch-delete", s("POST", "/xbkt", query={"delete": ""}, data=(
        b"<Delete><Object><Key>dir/copy.txt</Key></Object>"
        b"<Object><Key>never-was.txt</Key></Object></Delete>")))
    step("get-deleted", s("GET", "/xbkt/dir/copy.txt"))
    policy = (b'{"Version": "2012-10-17", "Statement": [{"Effect": "Deny",'
              b' "Principal": "*", "Action": "s3:GetObject", "Resource":'
              b' "arn:aws:s3:::xbkt/a.txt"}]}')
    step("no-policy", s("GET", "/xbkt", query={"policy": ""}))
    step("put-policy", s("PUT", "/xbkt", query={"policy": ""}, data=policy))
    step("get-policy", s("GET", "/xbkt", query={"policy": ""}))
    step("denied", s("GET", "/xbkt/a.txt", cred=READER))
    step("reader-ok", s("GET", "/xbkt/z.txt", cred=READER))
    step("reader-put", s("PUT", "/xbkt/r.txt", data=b"r", cred=READER))
    step("unsigned", _send(host, "GET", "/xbkt/z.txt"))
    step("missing", s("GET", "/xbkt/nope.txt"))
    step("acl", s("GET", "/xbkt", query={"acl": ""}))
    step("location", s("GET", "/xbkt", query={"location": ""}))
    step("versioning", s("GET", "/xbkt", query={"versioning": ""}))
    step("cors", s("GET", "/xbkt", query={"cors": ""}))
    step("list-buckets", s("GET", "/"))
    return out


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    with mock.patch.dict("os.environ", QUIET_ENV):
        ref = RefS3Stack(tmp_path_factory.mktemp("ref-s3")).start()
    port = PortS3Stack(tmp_path_factory.mktemp("port-s3")).start()
    yield {"reference": ref, "port": port}
    port.stop()
    ref.stop()


def test_same_requests_same_answers(stacks):
    ref = _script(stacks["reference"].s3.url)
    mine = _script(stacks["port"].s3.url)
    assert [r[0] for r in mine] == [r[0] for r in ref]
    for got, want in zip(mine, ref):
        assert got == want, got[0]
    by = {r[0]: r for r in mine}
    # the checks the script is there for, on the port's answers
    md5s = b"".join(hashlib.md5(_part(n)).digest() for n in range(3))
    multipart_md5 = hashlib.md5(md5s).hexdigest()
    # the completion answers the -N form; a GET carries the filer's ETag,
    # the same MD5 of the parts' MD5s without the suffix (both packages)
    assert f'<ETag>"{multipart_md5}-3"</ETag>' in by["complete"][2]
    assert by["get-multipart"][3]["ETag"] == f'"{multipart_md5}"'
    assert by["get-multipart"][2] == b"".join(_part(n) for n in range(3))
    assert by["range"][1] == 206 and \
        by["range"][3]["Content-Range"] == "bytes 299990-300009/501000"
    assert by["chunked-get"][2] == bytes(range(256)) * 700
    assert by["denied"][1] == 403 and b"AccessDenied" in \
        by["denied"][2].encode()
    assert by["reader-put"][1] == 403 and by["unsigned"][1] == 403
    assert by["missing"][1] == 404 and "NoSuchKey" in by["missing"][2]
    assert "<UploadId>*</UploadId>" in by["initiate"][2]


# ---- signatures cross -------------------------------------------------------

@pytest.mark.parametrize("method,path,query,payload", [
    ("GET", "/", {}, b""),
    ("PUT", "/bkt/a b/ü+x=y&z.txt", {}, b"data"),
    ("GET", "/bkt", {"list-type": "2", "prefix": "a/b c",
                     "continuation-token": "x%2Fy=", "max-keys": "7"}, b""),
    ("POST", "/bkt/k", {"uploads": ""}, b""),
    ("PUT", "/bkt/k~._-", {"partNumber": "3", "uploadId": "abc"},
     bytes(range(256))),
])
def test_sign_v4_equals_reference(method, path, query, payload):
    when = "20260803T101112Z"
    mine = auth.sign_v4(auth.Credential("AK", "S/K+"), method, "h:1", path,
                        query, payload=payload, amz_date=when,
                        extra_headers={"x-amz-meta-a": " b  c "})
    ref = ref_auth.sign_v4(ref_auth.Credential("AK", "S/K+"), method,
                           "h:1", path, query, payload=payload,
                           amz_date=when,
                           extra_headers={"x-amz-meta-a": " b  c "})
    assert mine == ref


@pytest.mark.parametrize("size,chunk", [(0, 64), (1, 64), (200_000, 65536),
                                        (131072, 65536)])
def test_sign_v4_chunked_equals_reference(size, chunk):
    payload = np.random.default_rng(size).bytes(size)
    when = "20260803T101112Z"
    mine = auth.sign_v4_chunked(auth.Credential("AK", "SK"), "PUT", "h:1",
                                "/b/k", {}, payload, chunk_size=chunk,
                                amz_date=when)
    ref = ref_auth.sign_v4_chunked(ref_auth.Credential("AK", "SK"), "PUT",
                                   "h:1", "/b/k", {}, payload,
                                   chunk_size=chunk, amz_date=when)
    assert mine == ref
    ctx = auth.IdentityAccessManagement(
        [auth.Identity("a", [auth.Credential("AK", "SK")], ["Admin"])]
    ).chunked_context({k.lower(): v for k, v in mine[0].items()} |
                      {"Authorization": mine[0]["Authorization"]})
    assert auth.decode_aws_chunked(mine[1], ctx, size) == payload


@pytest.mark.parametrize("signer", ["reference", "port"])
@pytest.mark.parametrize("gateway", ["reference", "port"])
def test_signed_requests_verify_in_both_gateways(stacks, signer, gateway):
    """A request signed by either package's `sign_v4` (a PUT with a
    quoted key and a listing with a query) or `sign_v4_chunked`, and a
    presigned-style V2 request, verify in either gateway."""
    sg, host = PACKAGES[signer], stacks[gateway].s3.url
    bucket = f"sig-{signer[:3]}"
    assert _signed(sg, host, "PUT", f"/{bucket}")[0] in (200, 409)
    key = f"/{bucket}/dir/a b+c=ü.txt"
    assert _signed(sg, host, "PUT", key, data=b"signed")[0] == 200
    assert _signed(sg, host, "GET", key)[1] == b"signed"
    st, body, _ = _signed(sg, host, "GET", f"/{bucket}", query={
        "list-type": "2", "prefix": "dir/a b", "max-keys": "5"})
    assert st == 200 and "a b+c=ü.txt".encode() in body
    h, body = sg.sign_v4_chunked(sg.Credential(CRED.access_key,
                                               CRED.secret_key), "PUT",
                                 host, f"/{bucket}/chunked", {},
                                 b"c" * 100_000, chunk_size=65536)
    assert _send(host, "PUT", f"/{bucket}/chunked", data=body,
                 headers=h)[0] == 200
    # a tampered body fails the same way in both
    h = sg.sign_v4(sg.Credential(CRED.access_key, CRED.secret_key), "PUT",
                   host, f"/{bucket}/t", {}, payload=b"original")
    st, body, _ = _send(host, "PUT", f"/{bucket}/t", data=b"TAMPERED",
                        headers=h)
    assert st == 400 and b"XAmzContentSHA256Mismatch" in body


# ---- buckets cross ----------------------------------------------------------

def _servers(package):
    if package == "port":
        from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
        from seaweedfs_tpu_torch.server.filer_server import FilerServer
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        return (MasterServer, lambda *a, **k: VolumeServer(
            *a, device="cpu", **k), FilerServer, S3ApiServer, auth)
    from seaweedfs_tpu.s3.s3api_server import S3ApiServer
    from seaweedfs_tpu.server.filer_server import FilerServer
    from seaweedfs_tpu.server.master import MasterServer
    from seaweedfs_tpu.server.volume_server import VolumeServer
    return MasterServer, VolumeServer, FilerServer, S3ApiServer, ref_auth


class _Stack:
    """One package's master, volume server, filer and gateway over the
    given volume and filer directories (the port's with `device="cpu"`),
    on the loop of a `Cluster` with no volume servers of its own."""

    def __init__(self, tmp, package):
        master_cls, vs_cls, filer_cls, gw_cls, a = _servers(package)
        self.loop_owner = Cluster(tmp / f"loop-{package}",
                                  n_volume_servers=0)
        self.loop_owner.thread.start()
        run = self.run = self.loop_owner.submit
        with mock.patch.dict("os.environ", QUIET_ENV):
            self.master = master_cls("127.0.0.1", free_port())
            self.vs = vs_cls([str(tmp / "v")], self.master.url,
                             port=free_port(), heartbeat_interval=0.2,
                             max_volumes=16)
            self.filer = filer_cls(self.master.url, port=free_port(),
                                   data_dir=str(tmp / "f"),
                                   chunk_size=256 * 1024)
            iam = a.IdentityAccessManagement(
                [a.Identity("admin", [a.Credential(CRED.access_key,
                                                   CRED.secret_key)],
                            ["Admin"])])
            self.s3 = gw_cls(self.filer.url, port=free_port(), iam=iam)
            run(self.master.start())
            run(self.vs.start())
            deadline = time.time() + 10
            while not self.master.topo.nodes:
                assert time.time() < deadline
                time.sleep(0.05)
            run(self.filer.start())
            run(self.s3.start())

    def stop(self):
        for srv in (self.s3, self.filer, self.vs, self.master):
            self.run(srv.stop())
        self.loop_owner.loop.call_soon_threadsafe(self.loop_owner.loop.stop)
        self.loop_owner.thread.join(5)


def _bucket_view(host):
    """What a client sees of bucket `cbk`: every object's bytes and
    headers, its tags, and the listings."""
    out = {}
    for k in ("small.txt", "big/multi.bin", "mp.bin", "meta.txt"):
        st, body, h = _signed(auth, host, "GET", f"/cbk/{k}")
        out[k] = (st, hashlib.sha256(body).hexdigest(), len(body),
                  h.get("ETag"), h.get("Content-Type"),
                  h.get("x-amz-meta-owner"))
        out[k + "?range"] = _record(_signed(
            auth, host, "GET", f"/cbk/{k}", headers={"Range": "bytes=3-9"}))
        out[k + "?head"] = _record(_signed(auth, host, "HEAD", f"/cbk/{k}"))
    out["tags"] = _record(_signed(auth, host, "GET", "/cbk/small.txt",
                                  query={"tagging": ""}))
    out["list"] = _record(_signed(auth, host, "GET", "/cbk",
                                  query={"list-type": "2"}))
    out["list-delim"] = _record(_signed(auth, host, "GET", "/cbk", query={
        "delimiter": "/"}))
    return out


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_buckets_cross_between_packages(tmp_path, writer, reader):
    w = _Stack(tmp_path, writer)
    try:
        host = w.s3.url
        assert _signed(auth, host, "PUT", "/cbk")[0] == 200
        _signed(auth, host, "PUT", "/cbk/small.txt", data=b"small object",
                headers={"Content-Type": "text/plain"})
        _signed(auth, host, "PUT", "/cbk/small.txt", query={"tagging": ""},
                data=b"<Tagging><TagSet><Tag><Key>k</Key><Value>v</Value>"
                     b"</Tag></TagSet></Tagging>")
        big = np.random.default_rng(11).bytes(700_000)  # three chunks
        _signed(auth, host, "PUT", "/cbk/big/multi.bin", data=big)
        _signed(auth, host, "PUT", "/cbk/meta.txt", data=b"m",
                headers={"x-amz-meta-owner": "ops"})
        _, body, _ = _signed(auth, host, "POST", "/cbk/mp.bin",
                             query={"uploads": ""}, data=b"")
        uid = re.search(rb"<UploadId>([^<]+)<", body).group(1).decode()
        parts = [np.random.default_rng(20 + n).bytes(300_000 - n)
                 for n in range(2)]
        for n, p in enumerate(parts):
            _signed(auth, host, "PUT", "/cbk/mp.bin", data=p,
                    query={"partNumber": str(n + 1), "uploadId": uid})
        assert _signed(auth, host, "POST", "/cbk/mp.bin",
                       query={"uploadId": uid},
                       data=b"<CompleteMultipartUpload>"
                            b"<Part><PartNumber>1</PartNumber></Part>"
                            b"<Part><PartNumber>2</PartNumber></Part>"
                            b"</CompleteMultipartUpload>")[0] == 200
        written = _bucket_view(host)
    finally:
        w.stop()
    assert written["mp.bin"][1] == hashlib.sha256(b"".join(parts)) \
        .hexdigest()
    assert written["big/multi.bin"][1] == hashlib.sha256(big).hexdigest()
    r = _Stack(tmp_path, reader)
    try:
        assert _bucket_view(r.s3.url) == written
        # the bucket stays live under the other package
        assert _signed(auth, r.s3.url, "PUT", "/cbk/later.txt",
                       data=b"later")[0] == 200
        assert _signed(auth, r.s3.url, "GET", "/cbk/later.txt")[1] == \
            b"later"
    finally:
        r.stop()


# ---- the canary's s3 path ---------------------------------------------------

@pytest.mark.parametrize("master_pkg,gateway_pkg", [
    ("port", "port"), ("port", "reference"), ("reference", "port")])
@pytest.mark.parametrize("with_iam", [False, True])
def test_canary_s3_path(tmp_path, monkeypatch, master_pkg, gateway_pkg,
                        with_iam):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_CANARY_INTERVAL", "0")
    if master_pkg == "port":
        c = Cluster(tmp_path, n_volume_servers=1).start()
    else:
        c = ref_cluster.Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    filer_cls = _servers(master_pkg)[2]
    _, _, _, gw_cls, a = _servers(gateway_pkg)
    filer = filer_cls(c.master.url, port=free_port(),
                      data_dir=str(tmp_path / "f"))
    c.submit(filer.start())
    iam = a.IdentityAccessManagement(
        [a.Identity("admin", [a.Credential("AK", "SK")], ["Admin"])]) \
        if with_iam else None
    gw = gw_cls(filer.url, port=free_port(), iam=iam,
                master_url=c.master.url)
    c.submit(gw.start())
    try:
        deadline = time.time() + 10
        while gw.url not in c.master.cluster_members.get("s3", {}):
            assert time.time() < deadline, "the gateway never registered"
            time.sleep(0.05)
        st = c.submit(c.master.canary.run_once(paths=("s3",)))
        rec = st["paths"]["s3"]
        assert rec["outcome"] == ("skip" if with_iam else "ok"), rec
    finally:
        c.submit(gw.stop())
        c.submit(filer.stop())
        c.stop()
