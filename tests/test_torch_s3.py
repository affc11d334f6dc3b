"""Twins of tests/test_s3.py on a port stack: the port's master, one port
volume server (`device="cpu"`), the port's `FilerServer` and the port's
`S3ApiServer`, in process on one asyncio loop in a thread with real
sockets, driven over HTTP and signed by the port's `sign_v4` like an
external client: buckets, objects, listing, multipart, tagging, auth,
chunked upload, POST policy and the breaker, lifecycle, bucket policy,
pagination, policy privilege, and the pure-function tests of
`decode_aws_chunked` and scoped identity actions.  Each test keeps its
reference twin's name and body.
"""

from __future__ import annotations

import asyncio
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from unittest import mock

import pytest

from seaweedfs_tpu_torch.s3.auth import (Credential, Identity,
                                         IdentityAccessManagement, sign_v4)
from tests.test_torch_master_cluster import free_port

CRED = Credential("AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY")
READER = Credential("READONLY", "rsecret")

# no scrubber and no repair loop in the stack's servers, as in the other
# port cluster tests
QUIET_ENV = {"WEEDTPU_SCRUB_MBPS": "0", "WEEDTPU_REPAIR_INTERVAL": "0"}


class S3Stack:
    """The port's master, volume server, filer server and S3 gateway on
    one loop thread.  `iam` defaults to the reference test's two
    identities (an admin and a Read/List reader), or none with
    `with_auth=False`."""

    def __init__(self, tmp, with_auth=True, iam=None, master_url=False):
        self.tmp = tmp
        self.with_auth = with_auth
        self.iam = iam
        self.register = master_url
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def start(self):
        from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
        from seaweedfs_tpu_torch.server.filer_server import FilerServer
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer

        with mock.patch.dict(os.environ, QUIET_ENV):
            self.master = MasterServer("127.0.0.1", free_port())
            (self.tmp / "v").mkdir(exist_ok=True)
            self.vs = VolumeServer([str(self.tmp / "v")], self.master.url,
                                   port=free_port(), heartbeat_interval=0.2,
                                   max_volumes=48, device="cpu")
            self.filer = FilerServer(self.master.url, port=free_port(),
                                     data_dir=str(self.tmp / "f"))
            iam = self.iam
            if iam is None:
                iam = IdentityAccessManagement([
                    Identity("admin", [CRED], ["Admin"]),
                    Identity("reader", [READER], ["Read", "List"]),
                ]) if self.with_auth else IdentityAccessManagement()
            self.s3 = S3ApiServer(
                self.filer.url, port=free_port(), iam=iam,
                master_url=self.master.url if self.register else None)
            self.run(self.master.start())
            self.run(self.vs.start())
            self.run(self.filer.start())
            self.run(self.s3.start())
        return self

    def stop(self):
        self.run(self.s3.stop())
        self.run(self.filer.stop())
        self.run(self.vs.stop())
        self.run(self.master.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)

    # -- signed http ---------------------------------------------------

    def req(self, method, path, data=None, query=None, headers=None,
            cred=CRED):
        query = query or {}
        host = self.s3.url
        all_headers = dict(headers or {})
        if cred is not None:
            all_headers.update(sign_v4(cred, method, host, path, query,
                                       payload=data or b""))
        qs = urllib.parse.urlencode(query)
        url = f"http://{host}{urllib.parse.quote(path)}" + \
            (f"?{qs}" if qs else "")
        r = urllib.request.Request(url, data=data, method=method,
                                   headers=all_headers)
        try:
            with urllib.request.urlopen(r, timeout=30) as resp:
                return resp.status, resp.read(), dict(resp.headers)
        except urllib.error.HTTPError as e:
            return e.code, e.read(), dict(e.headers)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    s = S3Stack(tmp_path_factory.mktemp("s3stack")).start()
    yield s
    s.stop()


def _xml(body: bytes) -> ET.Element:
    return ET.fromstring(body.decode())


def _strip(tag: str) -> str:
    return tag.rpartition("}")[2]


def _find_all(root, name):
    return [e for e in root.iter() if _strip(e.tag) == name]


def _text(root, name, default=""):
    els = _find_all(root, name)
    return els[0].text or default if els else default


class TestBuckets:
    def test_create_list_head_delete(self, stack):
        st, _, _ = stack.req("PUT", "/test-bucket")
        assert st == 200
        st, body, _ = stack.req("GET", "/")
        names = [b.text for b in _find_all(_xml(body), "Name")]
        assert "test-bucket" in names
        st, _, _ = stack.req("HEAD", "/test-bucket")
        assert st == 200
        st, _, _ = stack.req("DELETE", "/test-bucket")
        assert st == 204
        st, _, _ = stack.req("HEAD", "/test-bucket")
        assert st == 404

    def test_invalid_bucket_name(self, stack):
        st, body, _ = stack.req("PUT", "/XX")
        assert st == 400 and b"InvalidBucketName" in body

    def test_duplicate_bucket(self, stack):
        stack.req("PUT", "/dup-bucket")
        st, body, _ = stack.req("PUT", "/dup-bucket")
        assert st == 409 and b"BucketAlreadyExists" in body
        stack.req("DELETE", "/dup-bucket")


class TestObjects:
    def test_put_get_roundtrip(self, stack):
        stack.req("PUT", "/obj-bucket")
        payload = b"x" * 100_000
        st, _, hdrs = stack.req("PUT", "/obj-bucket/dir/a.bin", data=payload)
        assert st == 200 and hdrs.get("ETag")
        st, body, _ = stack.req("GET", "/obj-bucket/dir/a.bin")
        assert st == 200 and body == payload
        st, body, _ = stack.req(
            "GET", "/obj-bucket/dir/a.bin",
            headers={"Range": "bytes=10-19"})
        assert st == 206 and body == payload[10:20]
        st, _, _ = stack.req("HEAD", "/obj-bucket/dir/a.bin")
        assert st == 200

    def test_get_missing_is_nosuchkey(self, stack):
        stack.req("PUT", "/obj-bucket")
        st, body, _ = stack.req("GET", "/obj-bucket/nope.txt")
        assert st == 404 and b"NoSuchKey" in body

    def test_delete_object(self, stack):
        stack.req("PUT", "/obj-bucket")
        stack.req("PUT", "/obj-bucket/del.txt", data=b"bye")
        st, _, _ = stack.req("DELETE", "/obj-bucket/del.txt")
        assert st == 204
        st, _, _ = stack.req("GET", "/obj-bucket/del.txt")
        assert st == 404

    def test_copy_object(self, stack):
        stack.req("PUT", "/obj-bucket")
        stack.req("PUT", "/obj-bucket/src.txt", data=b"copy me")
        st, body, _ = stack.req(
            "PUT", "/obj-bucket/dst.txt",
            headers={"x-amz-copy-source": "/obj-bucket/src.txt"})
        assert st == 200 and b"CopyObjectResult" in body
        st, body, _ = stack.req("GET", "/obj-bucket/dst.txt")
        assert body == b"copy me"

    def test_user_metadata(self, stack):
        stack.req("PUT", "/obj-bucket")
        stack.req("PUT", "/obj-bucket/meta.txt", data=b"m",
                  headers={"x-amz-meta-color": "blue"})
        st, _, hdrs = stack.req("GET", "/obj-bucket/meta.txt")
        lower = {k.lower(): v for k, v in hdrs.items()}
        assert lower.get("x-amz-meta-color") == "blue"

    def test_batch_delete(self, stack):
        stack.req("PUT", "/obj-bucket")
        for i in range(3):
            stack.req("PUT", f"/obj-bucket/batch/{i}.txt", data=b"d")
        xml_body = (b'<Delete>' +
                    b''.join(f"<Object><Key>batch/{i}.txt</Key></Object>".encode()
                             for i in range(3)) + b'</Delete>')
        st, body, _ = stack.req("POST", "/obj-bucket", data=xml_body,
                                query={"delete": ""})
        assert st == 200
        assert len(_find_all(_xml(body), "Deleted")) == 3


class TestListing:
    @pytest.fixture(autouse=True, scope="class")
    def _fill(self, stack):
        stack.req("PUT", "/list-bucket")
        for key in ("a.txt", "b/one.txt", "b/two.txt", "b/c/deep.txt",
                    "z.txt"):
            stack.req("PUT", f"/list-bucket/{key}", data=b"x")

    def test_flat_list_v2(self, stack):
        st, body, _ = stack.req("GET", "/list-bucket",
                                query={"list-type": "2"})
        keys = [k.text for k in _find_all(_xml(body), "Key")]
        assert keys == ["a.txt", "b/c/deep.txt", "b/one.txt", "b/two.txt",
                        "z.txt"]

    def test_delimiter_common_prefixes(self, stack):
        st, body, _ = stack.req("GET", "/list-bucket",
                                query={"list-type": "2", "delimiter": "/"})
        root = _xml(body)
        keys = [k.text for k in _find_all(root, "Key")]
        cps = [p.text for p in _find_all(root, "Prefix")
               if p.text and p.text != ""]
        assert keys == ["a.txt", "z.txt"]
        assert "b/" in cps

    def test_prefix(self, stack):
        st, body, _ = stack.req("GET", "/list-bucket",
                                query={"list-type": "2", "prefix": "b/"})
        keys = [k.text for k in _find_all(_xml(body), "Key")]
        assert keys == ["b/c/deep.txt", "b/one.txt", "b/two.txt"]

    def test_pagination(self, stack):
        st, body, _ = stack.req("GET", "/list-bucket",
                                query={"list-type": "2", "max-keys": "2"})
        root = _xml(body)
        assert _text(root, "IsTruncated") == "true"
        token = _text(root, "NextContinuationToken")
        keys1 = [k.text for k in _find_all(root, "Key")]
        st, body, _ = stack.req(
            "GET", "/list-bucket",
            query={"list-type": "2", "max-keys": "10",
                   "continuation-token": token})
        keys2 = [k.text for k in _find_all(_xml(body), "Key")]
        assert keys1 + keys2 == ["a.txt", "b/c/deep.txt", "b/one.txt",
                                 "b/two.txt", "z.txt"]

    def test_marker_v1(self, stack):
        st, body, _ = stack.req("GET", "/list-bucket",
                                query={"marker": "b/one.txt"})
        keys = [k.text for k in _find_all(_xml(body), "Key")]
        assert keys == ["b/two.txt", "z.txt"]


class TestMultipart:
    def test_multipart_roundtrip(self, stack):
        stack.req("PUT", "/mp-bucket")
        st, body, _ = stack.req("POST", "/mp-bucket/big.bin",
                                query={"uploads": ""})
        assert st == 200
        upload_id = _text(_xml(body), "UploadId")
        assert upload_id

        part1 = bytes(range(256)) * 40000   # ~10MB: chunked by the filer
        part2 = b"tail-part" * 1000
        st, _, h1 = stack.req("PUT", "/mp-bucket/big.bin", data=part1,
                              query={"partNumber": "1",
                                     "uploadId": upload_id})
        assert st == 200
        st, _, h2 = stack.req("PUT", "/mp-bucket/big.bin", data=part2,
                              query={"partNumber": "2",
                                     "uploadId": upload_id})
        assert st == 200

        st, body, _ = stack.req("GET", "/mp-bucket/big.bin",
                                query={"uploadId": upload_id})
        assert st == 200
        assert len(_find_all(_xml(body), "Part")) == 2

        complete = (
            "<CompleteMultipartUpload>"
            f"<Part><PartNumber>1</PartNumber><ETag>{h1['ETag']}</ETag></Part>"
            f"<Part><PartNumber>2</PartNumber><ETag>{h2['ETag']}</ETag></Part>"
            "</CompleteMultipartUpload>").encode()
        st, body, _ = stack.req("POST", "/mp-bucket/big.bin", data=complete,
                                query={"uploadId": upload_id})
        assert st == 200, body
        etag = _text(_xml(body), "ETag")
        assert etag.endswith('-2"') or etag.endswith("-2")

        st, body, _ = stack.req("GET", "/mp-bucket/big.bin")
        assert st == 200 and body == part1 + part2
        # range across the part boundary
        lo = len(part1) - 5
        st, body, _ = stack.req(
            "GET", "/mp-bucket/big.bin",
            headers={"Range": f"bytes={lo}-{lo + 9}"})
        assert st == 206 and body == (part1 + part2)[lo:lo + 10]

    def test_abort_multipart(self, stack):
        stack.req("PUT", "/mp-bucket")
        st, body, _ = stack.req("POST", "/mp-bucket/gone.bin",
                                query={"uploads": ""})
        upload_id = _text(_xml(body), "UploadId")
        stack.req("PUT", "/mp-bucket/gone.bin", data=b"x",
                  query={"partNumber": "1", "uploadId": upload_id})
        st, _, _ = stack.req("DELETE", "/mp-bucket/gone.bin",
                             query={"uploadId": upload_id})
        assert st == 204
        st, body, _ = stack.req("POST", "/mp-bucket/gone.bin", data=b"",
                                query={"uploadId": upload_id})
        assert st == 404 and b"NoSuchUpload" in body

    def test_list_uploads(self, stack):
        stack.req("PUT", "/mp-bucket")
        st, body, _ = stack.req("POST", "/mp-bucket/pending.bin",
                                query={"uploads": ""})
        upload_id = _text(_xml(body), "UploadId")
        st, body, _ = stack.req("GET", "/mp-bucket", query={"uploads": ""})
        assert upload_id in body.decode()
        stack.req("DELETE", "/mp-bucket/pending.bin",
                  query={"uploadId": upload_id})


class TestTagging:
    def test_tag_roundtrip(self, stack):
        stack.req("PUT", "/tag-bucket")
        stack.req("PUT", "/tag-bucket/t.txt", data=b"t")
        tags = (b'<Tagging><TagSet>'
                b'<Tag><Key>env</Key><Value>prod</Value></Tag>'
                b'<Tag><Key>team</Key><Value>infra</Value></Tag>'
                b'</TagSet></Tagging>')
        st, _, _ = stack.req("PUT", "/tag-bucket/t.txt", data=tags,
                             query={"tagging": ""})
        assert st == 200
        st, body, _ = stack.req("GET", "/tag-bucket/t.txt",
                                query={"tagging": ""})
        root = _xml(body)
        got = {_text(t, "Key"): _text(t, "Value")
               for t in _find_all(root, "Tag")}
        assert got == {"env": "prod", "team": "infra"}
        st, _, _ = stack.req("DELETE", "/tag-bucket/t.txt",
                             query={"tagging": ""})
        assert st == 204
        st, body, _ = stack.req("GET", "/tag-bucket/t.txt",
                                query={"tagging": ""})
        assert not _find_all(_xml(body), "Tag")


class TestAuth:
    def test_unsigned_rejected(self, stack):
        st, body, _ = stack.req("GET", "/", cred=None)
        assert st == 403 and b"AccessDenied" in body

    def test_bad_secret_rejected(self, stack):
        bad = Credential(CRED.access_key, "wrong-secret")
        st, body, _ = stack.req("GET", "/", cred=bad)
        assert st == 403 and b"SignatureDoesNotMatch" in body

    def test_unknown_access_key(self, stack):
        st, body, _ = stack.req(
            "GET", "/", cred=Credential("NOPE", "nope"))
        assert st == 403 and b"InvalidAccessKeyId" in body

    def test_v2_signature_verified(self, stack):
        # access key alone must NOT authenticate (V2 needs a valid HMAC-SHA1)
        import email.utils
        st, body, _ = stack.req(
            "GET", "/", cred=None,
            headers={"Authorization": f"AWS {CRED.access_key}:garbage",
                     "Date": email.utils.formatdate(usegmt=True)})
        assert st == 403 and b"SignatureDoesNotMatch" in body

    def test_v2_missing_date_rejected(self, stack):
        st, body, _ = stack.req(
            "GET", "/", cred=None,
            headers={"Authorization": f"AWS {CRED.access_key}:garbage"})
        assert st == 403

    def test_v2_stale_date_rejected(self, stack):
        import email.utils
        old = email.utils.formatdate(time.time() - 3600, usegmt=True)
        st, body, _ = stack.req(
            "GET", "/", cred=None,
            headers={"Authorization": f"AWS {CRED.access_key}:garbage",
                     "Date": old})
        assert st == 403 and b"RequestTimeTooSkewed" in body

    def test_v2_valid_signature_accepted(self, stack):
        import base64
        import email.utils
        import hashlib
        import hmac as hmac_mod
        date = email.utils.formatdate(usegmt=True)
        sts = f"GET\n\n\n{date}\n/"
        sig = base64.b64encode(hmac_mod.new(
            CRED.secret_key.encode(), sts.encode(),
            hashlib.sha1).digest()).decode()
        st, _, _ = stack.req(
            "GET", "/", cred=None,
            headers={"Authorization": f"AWS {CRED.access_key}:{sig}",
                     "Date": date})
        assert st == 200

    def test_tampered_body_rejected(self, stack):
        # signature carries x-amz-content-sha256 of the original body; a
        # swapped body must be rejected
        from seaweedfs_tpu_torch.s3.auth import sign_v4
        stack.req("PUT", "/tamper-bucket")
        headers = sign_v4(CRED, "PUT", stack.s3.url,
                          "/tamper-bucket/t.txt", {}, payload=b"original")
        qs_url = f"http://{stack.s3.url}/tamper-bucket/t.txt"
        r = urllib.request.Request(qs_url, data=b"TAMPERED", method="PUT",
                                   headers=headers)
        try:
            with urllib.request.urlopen(r, timeout=30) as resp:
                st, body = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            st, body = e.code, e.read()
        assert st == 400 and b"XAmzContentSHA256Mismatch" in body

    def test_stale_date_rejected(self, stack):
        from seaweedfs_tpu_torch.s3.auth import sign_v4
        old = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(time.time() - 3600))
        headers = sign_v4(CRED, "GET", stack.s3.url, "/", {}, amz_date=old)
        r = urllib.request.Request(f"http://{stack.s3.url}/", headers=headers)
        try:
            with urllib.request.urlopen(r, timeout=30) as resp:
                st, body = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            st, body = e.code, e.read()
        assert st == 403 and b"RequestTimeTooSkewed" in body

    def test_malformed_presigned_params_is_400(self, stack):
        st, body, _ = stack.req(
            "GET", "/", cred=None,
            query={"X-Amz-Algorithm": "AWS4-HMAC-SHA256",
                   "X-Amz-Credential": f"{CRED.access_key}/x/us-east-1/s3/aws4_request",
                   "X-Amz-SignedHeaders": "host",
                   "X-Amz-Signature": "0" * 64,
                   "X-Amz-Date": "not-a-date",
                   "X-Amz-Expires": "abc"})
        assert st == 400 and b"AuthorizationQueryParametersError" in body

    def test_readonly_identity_cannot_write(self, stack):
        ro = Credential("READONLY", "rsecret")
        st, body, _ = stack.req("PUT", "/ro-bucket", cred=ro)
        assert st == 403 and b"AccessDenied" in body
        stack.req("PUT", "/ro-ok-bucket")
        stack.req("PUT", "/ro-ok-bucket/r.txt", data=b"r")
        st, body, _ = stack.req("GET", "/ro-ok-bucket/r.txt", cred=ro)
        assert st == 200 and body == b"r"


class TestChunkedUpload:
    """STREAMING-AWS4-HMAC-SHA256-PAYLOAD uploads: the per-chunk signature
    chain must be verified, not just stripped (reference:
    chunked_reader_v4.go:38-60,170-214)."""

    def _send(self, stack, path, headers, body):
        r = urllib.request.Request(f"http://{stack.s3.url}{path}",
                                   data=body, method="PUT", headers=headers)
        try:
            with urllib.request.urlopen(r, timeout=30) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def test_chunked_put_roundtrips(self, stack):
        from seaweedfs_tpu_torch.s3.auth import sign_v4_chunked
        stack.req("PUT", "/chunked-bucket")
        payload = bytes(range(256)) * 1000  # 256000 bytes, several chunks
        headers, body = sign_v4_chunked(
            CRED, "PUT", stack.s3.url, "/chunked-bucket/big.bin", {},
            payload, chunk_size=64 * 1024)
        st, resp = self._send(stack, "/chunked-bucket/big.bin", headers, body)
        assert st == 200, resp
        st, got, _ = stack.req("GET", "/chunked-bucket/big.bin")
        assert st == 200 and got == payload

    def test_forged_chunk_signature_is_403(self, stack):
        from seaweedfs_tpu_torch.s3.auth import sign_v4_chunked
        stack.req("PUT", "/chunked-bucket")
        payload = b"x" * 100_000
        headers, body = sign_v4_chunked(
            CRED, "PUT", stack.s3.url, "/chunked-bucket/forged.bin", {},
            payload, chunk_size=64 * 1024)
        # flip one hex digit inside the SECOND chunk's signature so the
        # seed-signature (header auth) still verifies
        marker = b"chunk-signature="
        second = body.index(marker, body.index(marker) + 1)
        sig_off = second + len(marker)
        flipped = b"0" if body[sig_off:sig_off + 1] != b"0" else b"1"
        body = body[:sig_off] + flipped + body[sig_off + 1:]
        st, resp = self._send(stack, "/chunked-bucket/forged.bin",
                              headers, body)
        assert st == 403 and b"SignatureDoesNotMatch" in resp
        st, _, _ = stack.req("GET", "/chunked-bucket/forged.bin")
        assert st == 404  # nothing committed

    def test_swapped_chunk_data_is_403(self, stack):
        from seaweedfs_tpu_torch.s3.auth import sign_v4_chunked
        stack.req("PUT", "/chunked-bucket")
        payload = b"a" * 65536 + b"b" * 65536
        headers, body = sign_v4_chunked(
            CRED, "PUT", stack.s3.url, "/chunked-bucket/swap.bin", {},
            payload, chunk_size=64 * 1024)
        body = body.replace(b"a" * 65536, b"c" * 65536)
        st, resp = self._send(stack, "/chunked-bucket/swap.bin",
                              headers, body)
        assert st == 403 and b"SignatureDoesNotMatch" in resp

    def test_truncated_stream_is_400(self, stack):
        from seaweedfs_tpu_torch.s3.auth import sign_v4_chunked
        stack.req("PUT", "/chunked-bucket")
        payload = b"z" * 100_000
        headers, body = sign_v4_chunked(
            CRED, "PUT", stack.s3.url, "/chunked-bucket/trunc.bin", {},
            payload, chunk_size=64 * 1024)
        # drop the final 0-size chunk record
        cut = body.rindex(b"0;chunk-signature=")
        st, resp = self._send(stack, "/chunked-bucket/trunc.bin",
                              headers, body[:cut])
        assert st == 400 and b"IncompleteBody" in resp


def test_decode_aws_chunked_unit():
    """Pure-function coverage of decode_aws_chunked: unsigned framing strip,
    signed chain, trailer signature (the shapes aws clients produce)."""
    import hashlib
    import hmac as hmac_mod
    from seaweedfs_tpu_torch.s3 import auth as a

    # unsigned stream (ctx=None): framing stripped, length enforced
    raw = b"5;chunk-signature=abc\r\nhello\r\n0;chunk-signature=d\r\n\r\n"
    assert a.decode_aws_chunked(raw, None, 5) == b"hello"
    with pytest.raises(a.AuthError):
        a.decode_aws_chunked(raw, None, 6)  # decoded-length mismatch
    with pytest.raises(a.AuthError):
        a.decode_aws_chunked(raw[:10], None)  # truncated

    # signed stream incl. trailer signature
    ctx = a.StreamingContext(sig_key=b"k" * 32, seed_sig="00" * 32,
                             amz_date="20260730T000000Z",
                             scope="20260730/us-east-1/s3/aws4_request")
    c1 = a._chunk_signature(ctx, ctx.seed_sig, b"hello")
    c2 = a._chunk_signature(ctx, c1, b"")
    trailer = b"x-amz-checksum-crc32c:AAAAAA==\r\n"
    tsts = "\n".join([
        "AWS4-HMAC-SHA256-TRAILER", ctx.amz_date, ctx.scope, c2,
        hashlib.sha256(b"x-amz-checksum-crc32c:AAAAAA==\n").hexdigest()])
    tsig = hmac_mod.new(ctx.sig_key, tsts.encode(),
                        hashlib.sha256).hexdigest()
    body = (f"5;chunk-signature={c1}\r\n".encode() + b"hello\r\n" +
            f"0;chunk-signature={c2}\r\n".encode() + b"\r\n" + trailer +
            f"x-amz-trailer-signature:{tsig}\r\n".encode())
    assert a.decode_aws_chunked(body, ctx, 5) == b"hello"
    bad = body.replace(tsig.encode(), b"0" * 64)
    with pytest.raises(a.AuthError):
        a.decode_aws_chunked(bad, ctx, 5)


def test_identity_scoped_actions():
    ident = Identity("x", [], ["Read:public-*", "Write:mine"])
    assert ident.can_do("Read", "public-data")
    assert not ident.can_do("Read", "private")
    assert ident.can_do("Write", "mine")
    assert not ident.can_do("Write", "public-data")
    admin = Identity("a", [], ["Admin"])
    assert admin.can_do("Write", "anything")


class TestPostPolicyAndBreaker:
    def test_post_policy_upload(self, stack):
        """Browser form upload with a signed V4 POST policy
        (reference: s3api_object_handlers_postpolicy.go)."""
        import base64
        import hashlib
        import hmac as hmac_mod
        import json as json_mod

        stack.req("PUT", "/form-bucket")
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        datestamp = amz_date[:8]
        cred = f"{CRED.access_key}/{datestamp}/us-east-1/s3/aws4_request"
        policy = {
            "expiration": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                        time.gmtime(time.time() + 3600)),
            "conditions": [{"bucket": "form-bucket"},
                           ["starts-with", "$key", ""]],
        }
        policy_b64 = base64.b64encode(
            json_mod.dumps(policy).encode()).decode()
        skey = IdentityAccessManagement._sig_key(
            CRED.secret_key, datestamp, "us-east-1", "s3")
        sig = hmac_mod.new(skey, policy_b64.encode(),
                           hashlib.sha256).hexdigest()

        boundary = "----weedform"
        parts = []
        for name, value in [
                ("key", "uploads/${filename}"),
                ("policy", policy_b64),
                ("x-amz-credential", cred),
                ("x-amz-date", amz_date),
                ("x-amz-signature", sig),
                ("success_action_status", "201")]:
            parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                         f"name=\"{name}\"\r\n\r\n{value}\r\n".encode())
        parts.append(
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f"name=\"file\"; filename=\"pic.bin\"\r\n"
            f"Content-Type: application/octet-stream\r\n\r\n".encode()
            + b"form-body" + b"\r\n")
        parts.append(f"--{boundary}--\r\n".encode())
        body = b"".join(parts)
        r = urllib.request.Request(
            f"http://{stack.s3.url}/form-bucket", data=body, method="POST",
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(r, timeout=30) as resp:
            assert resp.status == 201
            assert b"uploads/pic.bin" in resp.read()
        st, got, _ = stack.req("GET", "/form-bucket/uploads/pic.bin")
        assert st == 200 and got == b"form-body"

    def test_post_policy_bad_signature_rejected(self, stack):
        boundary = "----weedform2"
        body = (
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f"name=\"key\"\r\n\r\nx.bin\r\n"
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f"name=\"policy\"\r\n\r\neyJ9\r\n"
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f"name=\"x-amz-credential\"\r\n\r\n{CRED.access_key}/20260101/"
            f"us-east-1/s3/aws4_request\r\n"
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f"name=\"x-amz-signature\"\r\n\r\nbadsig\r\n"
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f"name=\"file\"; filename=\"x\"\r\n\r\nzz\r\n"
            f"--{boundary}--\r\n").encode()
        r = urllib.request.Request(
            f"http://{stack.s3.url}/form-bucket", data=body, method="POST",
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
        try:
            with urllib.request.urlopen(r, timeout=30) as resp:
                raise AssertionError(f"accepted: {resp.status}")
        except urllib.error.HTTPError as e:
            assert e.code == 403

    def test_circuit_breaker_sheds_load(self):
        from seaweedfs_tpu_torch.s3.circuit_breaker import CircuitBreaker
        cb = CircuitBreaker(global_max_requests=2, bucket_max_requests=1)
        assert cb.acquire("a")
        assert not cb.acquire("a")  # bucket limit
        assert cb.acquire("b")
        assert not cb.acquire("c")  # global limit
        cb.release("a")
        assert cb.acquire("c")
        cb.release("b"); cb.release("c")
        # upload byte budget
        cb2 = CircuitBreaker(global_max_upload_bytes=100)
        assert cb2.acquire("x", 60)
        assert not cb2.acquire("y", 60)
        cb2.release("x", 60)
        assert cb2.acquire("y", 60)

    def test_post_policy_conditions_enforced(self, stack):
        """A policy scoped to one bucket must not authorize another
        (reference: policy/post-policy.go condition matching)."""
        import base64
        import hashlib
        import hmac as hmac_mod
        import json as json_mod
        stack.req("PUT", "/scoped-bucket")
        stack.req("PUT", "/other-bucket")
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        datestamp = amz_date[:8]
        cred = f"{CRED.access_key}/{datestamp}/us-east-1/s3/aws4_request"
        policy = {"expiration": time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() + 3600)),
            "conditions": [{"bucket": "scoped-bucket"},
                           ["starts-with", "$key", "up/"],
                           ["content-length-range", 0, 4]]}
        policy_b64 = base64.b64encode(
            json_mod.dumps(policy).encode()).decode()
        skey = IdentityAccessManagement._sig_key(
            CRED.secret_key, datestamp, "us-east-1", "s3")
        sig = hmac_mod.new(skey, policy_b64.encode(),
                           hashlib.sha256).hexdigest()

        def form(bucket, key, content=b"ab"):
            b = "----cond"
            parts = []
            for n, v in [("key", key), ("policy", policy_b64),
                         ("x-amz-credential", cred),
                         ("x-amz-date", amz_date),
                         ("x-amz-signature", sig)]:
                parts.append(
                    f"--{b}\r\nContent-Disposition: form-data; "
                    f"name=\"{n}\"\r\n\r\n{v}\r\n".encode())
            parts.append(f"--{b}\r\nContent-Disposition: form-data; "
                         f"name=\"file\"; filename=\"f\"\r\n\r\n".encode()
                         + content + b"\r\n")
            parts.append(f"--{b}--\r\n".encode())
            r = urllib.request.Request(
                f"http://{stack.s3.url}/{bucket}", data=b"".join(parts),
                method="POST",
                headers={"Content-Type":
                         f"multipart/form-data; boundary={b}"})
            try:
                with urllib.request.urlopen(r, timeout=30) as resp:
                    return resp.status
            except urllib.error.HTTPError as e:
                return e.code
        assert form("scoped-bucket", "up/ok.bin") == 204
        # replay against another bucket -> bucket condition fails
        assert form("other-bucket", "up/x.bin") == 403
        # key outside the starts-with scope
        assert form("scoped-bucket", "elsewhere/x.bin") == 403
        # over the content-length-range
        assert form("scoped-bucket", "up/big.bin", b"12345") == 400
        # missing expiration policy rejected
        pol2 = base64.b64encode(json_mod.dumps(
            {"conditions": []}).encode()).decode()
        sig2 = hmac_mod.new(skey, pol2.encode(),
                            hashlib.sha256).hexdigest()
        policy_b64_save, sig_save = policy_b64, sig
        try:
            policy_b64, sig = pol2, sig2
            assert form("scoped-bucket", "up/z.bin") == 403
        finally:
            policy_b64, sig = policy_b64_save, sig_save


class TestBucketLifecycle:
    """Expiry rules mapped to filer-conf TTLs (reference:
    s3api_bucket_handlers.go:313-400 Get/PutBucketLifecycleConfiguration)."""

    LIFECYCLE = (b'<LifecycleConfiguration>'
                 b'<Rule><ID>logs</ID><Status>Enabled</Status>'
                 b'<Filter><Prefix>logs/</Prefix></Filter>'
                 b'<Expiration><Days>1</Days></Expiration></Rule>'
                 b'<Rule><ID>off</ID><Status>Disabled</Status>'
                 b'<Filter><Prefix>keep/</Prefix></Filter>'
                 b'<Expiration><Days>2</Days></Expiration></Rule>'
                 b'</LifecycleConfiguration>')

    def test_lifecycle_roundtrip_and_expiry(self, stack):
        stack.req("PUT", "/lc-bucket")
        # no config yet
        st, body, _ = stack.req("GET", "/lc-bucket", query={"lifecycle": ""})
        assert st == 404 and b"NoSuchLifecycleConfiguration" in body
        # put: only the Enabled rule lands
        st, _, _ = stack.req("PUT", "/lc-bucket", data=self.LIFECYCLE,
                             query={"lifecycle": ""})
        assert st == 200
        st, body, _ = stack.req("GET", "/lc-bucket", query={"lifecycle": ""})
        assert st == 200
        root = _xml(body)
        prefixes = [e.text for e in _find_all(root, "Prefix")]
        days = [e.text for e in _find_all(root, "Days")]
        assert prefixes == ["logs/"] and days == ["1"]
        # new objects under the rule prefix inherit the TTL...
        st, body, _ = stack.req("PUT", "/lc-bucket/logs/app.log",
                                data=b"expiring")
        assert st == 200, body
        st, body, _ = stack.req("PUT", "/lc-bucket/other.txt",
                                data=b"durable")
        assert st == 200, body
        meta = stack.filer.filer.find_entry(
            "/buckets/lc-bucket/logs/app.log")
        assert meta.attr.ttl_sec == 86400
        assert stack.filer.filer.find_entry(
            "/buckets/lc-bucket/other.txt").attr.ttl_sec == 0
        # ...and age out: push the object's birth past its TTL and it
        # vanishes from GET and listings
        meta.attr.crtime -= 86401
        stack.filer.filer.store.update_entry(meta)
        st, _, _ = stack.req("GET", "/lc-bucket/logs/app.log")
        assert st == 404
        st, body, _ = stack.req("GET", "/lc-bucket")
        keys = [e.text for e in _find_all(_xml(body), "Key")]
        assert "logs/app.log" not in keys and "other.txt" in keys
        # delete config
        st, _, _ = stack.req("DELETE", "/lc-bucket",
                             query={"lifecycle": ""})
        assert st == 204
        st, _, _ = stack.req("GET", "/lc-bucket", query={"lifecycle": ""})
        assert st == 404
        # objects written after the delete carry no TTL
        stack.req("PUT", "/lc-bucket/logs/later.log", data=b"kept")
        assert stack.filer.filer.find_entry(
            "/buckets/lc-bucket/logs/later.log").attr.ttl_sec == 0


class TestBucketPolicy:
    """Bucket policy storage + AWS evaluation order (deny wins > allow >
    identity actions), and the unreadable-policy fail-closed path
    (reference: weed/s3api/policy/)."""

    READER = Credential("READONLY", "rsecret")

    def test_policy_crud_and_enforcement(self, stack):
        import json as json_mod
        stack.req("PUT", "/pol-bucket")
        stack.req("PUT", "/pol-bucket/secret.txt", data=b"classified")
        stack.req("PUT", "/pol-bucket/open.txt", data=b"public-ish")
        # no policy yet
        st, body, _ = stack.req("GET", "/pol-bucket", query={"policy": ""})
        assert st == 404 and b"NoSuchBucketPolicy" in body
        # malformed policy -> 400
        st, body, _ = stack.req("PUT", "/pol-bucket", data=b"not-json",
                                query={"policy": ""})
        assert st == 400 and b"MalformedPolicy" in body
        # deny reader the secret object; allow reader writes to /open*
        doc = json_mod.dumps({
            "Version": "2012-10-17",
            "Statement": [
                {"Effect": "Deny", "Principal": "*",
                 "Action": "s3:GetObject",
                 "Resource": "arn:aws:s3:::pol-bucket/secret.txt"},
                {"Effect": "Allow",
                 "Principal": {"AWS": "arn:aws:iam:::user/reader"},
                 "Action": ["s3:PutObject"],
                 "Resource": "arn:aws:s3:::pol-bucket/open*"},
            ]}).encode()
        st, body, _ = stack.req("PUT", "/pol-bucket", data=doc,
                                query={"policy": ""})
        assert st == 204, body
        st, body, _ = stack.req("GET", "/pol-bucket", query={"policy": ""})
        assert st == 200 and b"2012-10-17" in body
        # explicit deny beats even the Admin identity
        st, body, _ = stack.req("GET", "/pol-bucket/secret.txt")
        assert st == 403 and b"bucket policy" in body
        # other objects unaffected
        assert stack.req("GET", "/pol-bucket/open.txt")[0] == 200
        # policy Allow grants beyond the identity's own actions: reader
        # has no Write action, but the policy allows puts under /open*
        st, _, _ = stack.req("PUT", "/pol-bucket/open2.txt",
                             data=b"by-reader", cred=self.READER)
        assert st == 200
        # ...while un-allowed writes still fail on the identity
        st, _, _ = stack.req("PUT", "/pol-bucket/other.txt",
                             data=b"nope", cred=self.READER)
        assert st == 403
        # delete policy: the deny lifts
        assert stack.req("DELETE", "/pol-bucket",
                         query={"policy": ""})[0] == 204
        assert stack.req("GET", "/pol-bucket/secret.txt")[0] == 200

    def test_unreadable_policy_fails_closed_except_admin(self, stack):
        stack.req("PUT", "/brk-bucket")
        stack.req("PUT", "/brk-bucket/x.txt", data=b"x")
        # corrupt policy written straight to the filer (bypassing PUT
        # validation, as the advisor scenario describes)
        urllib.request.urlopen(urllib.request.Request(
            f"http://{stack.filer.url}/etc/s3/policies/brk-bucket.json",
            data=b'{"Statement": "garbage"}', method="PUT"), timeout=15)
        stack.s3.policies._cache.pop("brk-bucket", None)  # force re-read
        # non-admin is denied outright (the lost document may have held
        # Deny statements)
        st, body, _ = stack.req("GET", "/brk-bucket/x.txt",
                                cred=self.READER)
        assert st == 403 and b"unreadable" in body
        # the bucket admin still gets through to repair things
        assert stack.req("GET", "/brk-bucket/x.txt")[0] == 200
        assert stack.req("DELETE", "/brk-bucket",
                         query={"policy": ""})[0] == 204
        stack.s3.policies._cache.pop("brk-bucket", None)
        st, _, _ = stack.req("GET", "/brk-bucket/x.txt", cred=self.READER)
        assert st == 200


class TestListPagination:
    def test_marker_seeded_continuation(self, stack):
        """Multi-page ListObjects via marker returns every key exactly
        once, including nested directories straddling page boundaries."""
        stack.req("PUT", "/page-bucket")
        keys = []
        for i in range(7):
            keys.append(f"a{i:02d}.txt")
        for d in ("mid", "zed"):
            for i in range(4):
                keys.append(f"{d}/k{i}.txt")
        for k in sorted(keys):
            st, _, _ = stack.req("PUT", f"/page-bucket/{k}", data=b"v")
            assert st == 200
        got = []
        marker = ""
        for _ in range(30):
            q = {"max-keys": "3"}
            if marker:
                q["marker"] = marker
            st, body, _ = stack.req("GET", "/page-bucket", query=q)
            assert st == 200
            root = _xml(body)
            page = [e.text for e in _find_all(root, "Key")]
            got.extend(page)
            if _text(root, "IsTruncated") != "true":
                break
            marker = _text(root, "NextMarker") or (page[-1] if page else "")
        assert got == sorted(keys)


class TestPolicyPrivilege:
    READER = Credential("READONLY", "rsecret")

    def test_policy_management_needs_admin(self, stack):
        import json as json_mod
        stack.req("PUT", "/priv-bucket")
        doc = json_mod.dumps({"Statement": [
            {"Effect": "Allow", "Principal": "*", "Action": "s3:*",
             "Resource": "*"}]}).encode()
        # a Read/List identity can neither write, read, nor delete policies
        assert stack.req("PUT", "/priv-bucket", data=doc,
                         query={"policy": ""}, cred=self.READER)[0] == 403
        assert stack.req("GET", "/priv-bucket",
                         query={"policy": ""}, cred=self.READER)[0] == 403
        assert stack.req("DELETE", "/priv-bucket",
                         query={"policy": ""}, cred=self.READER)[0] == 403

    def test_start_after_directory_name_descends(self, stack):
        """marker == a directory name (no trailing slash) must still
        return the directory's subtree (it sorts after the marker)."""
        stack.req("PUT", "/sa-bucket")
        stack.req("PUT", "/sa-bucket/mid/k0.txt", data=b"v")
        stack.req("PUT", "/sa-bucket/aaa.txt", data=b"v")
        st, body, _ = stack.req("GET", "/sa-bucket",
                                query={"marker": "mid"})
        assert st == 200
        keys = [e.text for e in _find_all(_xml(body), "Key")]
        assert keys == ["mid/k0.txt"]


class TestDelimiterPagination:
    def test_common_prefix_continuation_no_duplicates(self, stack):
        """Delimiter listings paginating by NextMarker: each CommonPrefix
        appears exactly once and the walk never re-descends a served
        prefix's subtree."""
        stack.req("PUT", "/delim-bucket")
        for d in ("alpha", "beta", "gamma"):
            for i in range(3):
                stack.req("PUT", f"/delim-bucket/{d}/f{i}.txt", data=b"v")
        stack.req("PUT", "/delim-bucket/zz-root.txt", data=b"v")
        seen_prefixes, seen_keys = [], []
        marker = ""
        for _ in range(20):
            q = {"delimiter": "/", "max-keys": "1"}
            if marker:
                q["marker"] = marker
            st, body, _ = stack.req("GET", "/delim-bucket", query=q)
            assert st == 200
            root = _xml(body)
            seen_prefixes.extend(
                e.text for p in _find_all(root, "CommonPrefixes")
                for e in p if e.tag.endswith("Prefix"))
            seen_keys.extend(e.text for e in _find_all(root, "Key"))
            if _text(root, "IsTruncated") != "true":
                break
            marker = _text(root, "NextMarker")
            assert marker
        assert seen_prefixes == ["alpha/", "beta/", "gamma/"]
        assert seen_keys == ["zz-root.txt"]


# ---- the gateway's loopback surfaces ----------------------------------------

def test_debug_surface_shares_the_loopback_guard():
    """Twin of tests/test_observability.py's check: the gateway's debug
    surface uses `trace.debug_guard` itself."""
    from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
    from seaweedfs_tpu_torch.stats import trace
    assert S3ApiServer._debug_local is trace.debug_guard


def test_qos_surface_sheds_a_tenant_into_429s(stack):
    """/__qos__ (loopback) retunes the admission plane; a tenant over its
    share is shed with 429 SlowDown before any filer work, and the rest
    of the stack is untouched once the rate is 0 again."""
    import json as json_mod

    def qos(body=None):
        r = urllib.request.Request(
            f"http://{stack.s3.url}/__qos__", method="POST" if body else "GET",
            data=json_mod.dumps(body).encode() if body else None)
        with urllib.request.urlopen(r, timeout=30) as resp:
            return json_mod.loads(resp.read())

    assert qos()["enabled"] is False
    st = qos({"rate": 2.0, "burst_s": 0.5})
    assert st["enabled"] and st["total_rate"] == 2.0
    try:
        codes = [stack.req("GET", "/")[0] for _ in range(12)]
        assert 429 in codes and 200 in codes
        st, body, _ = next((s, b, h) for s, b, h in
                           (stack.req("GET", "/") for _ in range(12))
                           if s == 429)
        assert b"SlowDown" in body
        assert qos()["shed_by_tenant"].get(CRED.access_key, 0) > 0
    finally:
        qos({"rate": 0})
    assert stack.req("GET", "/")[0] == 200
