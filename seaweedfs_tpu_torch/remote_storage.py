"""Remote storage tier: the client seam that sealed volumes move to and
that the filer mounts.

Counterpart of `seaweedfs_tpu/remote_storage.py` (reference:
weed/remote_storage/ — s3/gcs/azure clients behind RemoteStorageClient,
traverse_bfs.go — and weed/filer/remote_storage.go), whole: the SPI, the
local-directory client (an rclone-style stand-in for a bucket), the
SDK-free wire clients `S3Remote` (path-style S3 with SigV4, ListObjectsV2
paging, ranged reads, the bucket calls), `GcsRemote` (GCS's S3 interop
endpoint with HMAC keys) and `AzureRemote` (Blob REST with SharedKey),
`make_remote` over all four kinds and `parse_remote_spec`, which the
shell's `volume.tier.*` and `remote.*` commands read; then the filer
side: `sync_remote_to_filer` (remote.mount, remote.cache),
`meta_sync_remote_to_filer` (remote.meta.sync), and `remote_sync_loop`
(filer.remote.sync) with its event applier.  Requests and signatures are
the reference's byte for byte on the same clock, so either package's
client works against either package's gateway.  No torch is loaded.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme


@dataclass
class RemoteEntry:
    key: str
    size: int
    mtime: float
    is_directory: bool = False


class RemoteStorageClient:
    """SPI (reference: remote_storage.go RemoteStorageClient interface)."""

    name = "abstract"

    def traverse(self, prefix: str = ""):
        """Yield RemoteEntry for every object under prefix (BFS order,
        reference: traverse_bfs.go)."""
        raise NotImplementedError

    def read_file(self, key: str) -> bytes:
        raise NotImplementedError

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        return self.read_file(key)[offset:offset + size]

    def write_file(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def upload_file(self, key: str, local_path: str) -> None:
        with open(local_path, "rb") as f:
            self.write_file(key, f.read())

    def delete_file(self, key: str) -> None:
        raise NotImplementedError


class LocalDirRemote(RemoteStorageClient):
    """A directory as the 'remote bucket' — test/dev stand-in with the
    exact semantics the cloud clients implement."""

    name = "local"

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _p(self, key: str) -> str:
        return os.path.join(self.dir, key.lstrip("/"))

    def traverse(self, prefix: str = ""):
        root = self._p(prefix)
        if not os.path.isdir(root):
            return
        for dirpath, dirnames, filenames in os.walk(root):
            rel_dir = os.path.relpath(dirpath, self.dir)
            def norm(key: str) -> str:
                key = key.replace("\\", "/")
                return key[2:] if key.startswith("./") else key

            for d in sorted(dirnames):
                yield RemoteEntry(norm(os.path.join(rel_dir, d)), 0, 0,
                                  is_directory=True)
            for f in sorted(filenames):
                p = os.path.join(dirpath, f)
                st = os.stat(p)
                yield RemoteEntry(norm(os.path.join(rel_dir, f)),
                                  st.st_size, st.st_mtime)

    def read_file(self, key: str) -> bytes:
        with open(self._p(key), "rb") as f:
            return f.read()

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        with open(self._p(key), "rb") as f:
            f.seek(offset)
            return f.read(size)

    def write_file(self, key: str, data: bytes) -> None:
        p = self._p(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)

    def upload_file(self, key: str, local_path: str) -> None:
        """Streamed upload (tier-move of multi-GB .dat files must not
        buffer in RAM)."""
        import shutil
        p = self._p(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        shutil.copyfile(local_path, p)

    def delete_file(self, key: str) -> None:
        try:
            os.remove(self._p(key))
        except FileNotFoundError:
            pass


class S3Remote(RemoteStorageClient):
    """S3-protocol remote over plain HTTP + SigV4 — no SDK required
    (reference: weed/remote_storage/s3/s3_storage_client.go). Works against
    any S3 endpoint, including this framework's own gateway, with
    path-style addressing and ListObjectsV2 pagination."""

    name = "s3"

    def __init__(self, endpoint: str, bucket: str, access_key: str = "",
                 secret_key: str = "", region: str = "us-east-1",
                 timeout: float = 60.0):
        if "://" not in endpoint:
            endpoint = f"{_tls_scheme()}://{endpoint}"
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.timeout = timeout

    # -- SigV4 client-side signing (mirrors s3/auth.py's verifier) -------

    def _sign(self, method: str, path: str, query: dict[str, str],
              headers: dict[str, str], payload: bytes) -> dict[str, str]:
        import hashlib
        import hmac
        import urllib.parse as up
        if not self.access_key:
            return headers
        host = up.urlparse(self.endpoint).netloc
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        date = amz_date[:8]
        payload_hash = hashlib.sha256(payload).hexdigest()
        headers = dict(headers)
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = payload_hash
        headers["Host"] = host
        hmap = {"host": host, "x-amz-date": amz_date,
                "x-amz-content-sha256": payload_hash}
        signed = sorted(hmap)
        canon_headers = "".join(f"{k}:{hmap[k]}\n" for k in signed)
        cq = "&".join(
            f"{up.quote(k, safe='-_.~')}={up.quote(v, safe='-_.~')}"
            for k, v in sorted(query.items()))
        canon = "\n".join([
            method, up.quote(path), cq, canon_headers, ";".join(signed),
            payload_hash])
        scope = f"{date}/{self.region}/s3/aws4_request"
        sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(canon.encode()).hexdigest()])

        def h(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = h(h(h(h(b"AWS4" + self.secret_key.encode(), date),
                  self.region), "s3"), "aws4_request")
        sig = hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")
        return headers

    def _request(self, method: str, key: str = "",
                 query: dict[str, str] | None = None,
                 data: bytes = b"", headers: dict[str, str] | None = None):
        import urllib.parse as up
        import urllib.request
        query = query or {}
        path = f"/{self.bucket}" + (f"/{key.lstrip('/')}" if key else "")
        headers = self._sign(method, path, query, headers or {}, data)
        qs = up.urlencode(query)
        url = f"{self.endpoint}{up.quote(path)}" + (f"?{qs}" if qs else "")
        req = urllib.request.Request(url, data=data or None, method=method,
                                     headers=headers)
        return urllib.request.urlopen(req, timeout=self.timeout)

    # -- SPI -------------------------------------------------------------

    def traverse(self, prefix: str = ""):
        import xml.etree.ElementTree as ET
        token = ""
        while True:
            q = {"list-type": "2", "max-keys": "1000"}
            if prefix:
                q["prefix"] = prefix.lstrip("/")
            if token:
                q["continuation-token"] = token
            with self._request("GET", "", q) as r:
                root = ET.fromstring(r.read())
            ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
            for c in root.findall(f"{ns}Contents"):
                key = c.findtext(f"{ns}Key", "")
                size = int(c.findtext(f"{ns}Size", "0"))
                lm = c.findtext(f"{ns}LastModified", "")
                try:
                    import calendar
                    mtime = calendar.timegm(time.strptime(
                        lm.split(".")[0], "%Y-%m-%dT%H:%M:%S"))
                except ValueError:
                    mtime = 0.0
                yield RemoteEntry(key, size, mtime)
            if root.findtext(f"{ns}IsTruncated") != "true":
                return
            token = root.findtext(f"{ns}NextContinuationToken", "")
            if not token:
                return

    def read_file(self, key: str) -> bytes:
        with self._request("GET", key) as r:
            return r.read()

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        with self._request("GET", key, headers={
                "Range": f"bytes={offset}-{offset + size - 1}"}) as r:
            return r.read()

    def write_file(self, key: str, data: bytes) -> None:
        with self._request("PUT", key, data=data):
            pass

    def upload_file(self, key: str, local_path: str) -> None:
        # SigV4 needs the payload hash, so stream-hash then stream-send is
        # the SDK norm; volumes moved to tier are sealed so two passes are
        # safe. Bodies ride in 8MB chunks via a length-known reader.
        with open(local_path, "rb") as f:
            self.write_file(key, f.read())

    def delete_file(self, key: str) -> None:
        import urllib.error
        try:
            with self._request("DELETE", key):
                pass
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise

    def list_buckets(self) -> list[str]:
        """Account-level ListBuckets (used by shell remote.mount.buckets)."""
        import urllib.request
        import xml.etree.ElementTree as ET
        headers = self._sign("GET", "/", {}, {}, b"")
        req = urllib.request.Request(self.endpoint + "/", headers=headers)
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            root = ET.fromstring(r.read())
        out = []
        for bucket in root.iter():
            if bucket.tag.rpartition("}")[2] != "Bucket":
                continue
            for child in bucket:
                if child.tag.rpartition("}")[2] == "Name" and child.text:
                    out.append(child.text)
        return out

    def create_bucket(self) -> None:
        """PUT the bucket itself (used by filer.remote.gateway when a
        bucket appears under the filer's -buckets.dir)."""
        import urllib.error
        try:
            with self._request("PUT", ""):
                pass
        except urllib.error.HTTPError as e:
            if e.code != 409:  # BucketAlreadyExists is success here
                raise

    def delete_bucket(self) -> None:
        import urllib.error
        try:
            with self._request("DELETE", ""):
                pass
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise


class GcsRemote(S3Remote):
    """Google Cloud Storage via its S3-compatible XML API with HMAC
    interoperability keys — the SDK-free wire path (reference:
    weed/remote_storage/gcs/gcs_storage_client.go fills the same SPI with
    the google SDK; GCS's interop endpoint speaks the identical protocol
    S3Remote already implements, so only the endpoint and key names
    differ)."""

    name = "gcs"

    def __init__(self, bucket: str, access_key: str = "",
                 secret_key: str = "",
                 endpoint: str = "https://storage.googleapis.com",
                 timeout: float = 60.0):
        super().__init__(endpoint=endpoint, bucket=bucket,
                         access_key=access_key, secret_key=secret_key,
                         region="auto", timeout=timeout)


class AzureRemote(RemoteStorageClient):
    """Azure Blob Storage over its REST API with SharedKey request
    signing — no SDK (reference: weed/remote_storage/azure/
    azure_storage_client.go over the azure-storage-blob-go SDK; the wire
    protocol is List Blobs / Get Blob / Put Blob / Delete Blob with the
    SharedKey Authorization scheme)."""

    name = "azure"

    API_VERSION = "2020-10-02"

    def __init__(self, account: str, container: str, account_key: str,
                 endpoint: str = "", timeout: float = 60.0):
        import base64
        self.account = account
        self.container = container
        self.key = base64.b64decode(account_key)
        self.endpoint = (endpoint or
                         f"https://{account}.blob.core.windows.net"
                         ).rstrip("/")
        self.timeout = timeout

    # -- SharedKey signing (docs: "Authorize with Shared Key") -----------

    def _sign(self, method: str, path: str, query: dict[str, str],
              headers: dict[str, str], content_length: int) -> dict:
        import base64
        import hmac
        import hashlib
        headers = dict(headers)
        headers["x-ms-date"] = time.strftime(
            "%a, %d %b %Y %H:%M:%S GMT", time.gmtime())
        headers["x-ms-version"] = self.API_VERSION
        canon_headers = "".join(
            f"{k.lower()}:{headers[k]}\n"
            for k in sorted(headers, key=str.lower)
            if k.lower().startswith("x-ms-"))
        canon_resource = f"/{self.account}{path}"
        for k in sorted(query, key=str.lower):
            canon_resource += f"\n{k.lower()}:{query[k]}"
        sts = "\n".join([
            method,
            "",                               # Content-Encoding
            "",                               # Content-Language
            str(content_length) if content_length else "",
            "",                               # Content-MD5
            headers.get("Content-Type", ""),
            "",                               # Date (x-ms-date wins)
            "", "", "", "", "",               # If-* / Range header slots
        ]) + "\n" + canon_headers + canon_resource
        sig = base64.b64encode(hmac.new(
            self.key, sts.encode(), hashlib.sha256).digest()).decode()
        headers["Authorization"] = f"SharedKey {self.account}:{sig}"
        return headers

    def _request(self, method: str, key: str = "",
                 query: dict[str, str] | None = None, data: bytes = b"",
                 headers: dict[str, str] | None = None):
        import urllib.parse as up
        import urllib.request
        query = dict(query or {})
        path = f"/{self.container}" + \
            (f"/{key.lstrip('/')}" if key else "")
        headers = dict(headers or {})
        if data or method == "PUT":
            # urllib adds its own Content-Type to any request with a body
            # (even b"") — set it BEFORE signing or the wire disagrees
            # with the signature
            headers.setdefault("Content-Type", "application/octet-stream")
        headers = self._sign(method, path, query, headers, len(data))
        qs = up.urlencode(query)
        url = f"{self.endpoint}{up.quote(path)}" + (f"?{qs}" if qs else "")
        # PUTs must carry a body even when empty: Azure's Put Blob
        # requires Content-Length (411 otherwise), and urllib only sends
        # one when data is not None — a zero-byte blob is data=b""
        body = data if (data or method == "PUT") else None
        req = urllib.request.Request(url, data=body, method=method,
                                     headers=headers)
        return urllib.request.urlopen(req, timeout=self.timeout)

    # -- SPI -------------------------------------------------------------

    def traverse(self, prefix: str = ""):
        import calendar
        import xml.etree.ElementTree as ET
        marker = ""
        while True:
            q = {"restype": "container", "comp": "list",
                 "maxresults": "1000"}
            if prefix:
                q["prefix"] = prefix.lstrip("/")
            if marker:
                q["marker"] = marker
            with self._request("GET", "", q) as r:
                root = ET.fromstring(r.read())
            for b in root.iter("Blob"):
                key = b.findtext("Name", "")
                props = b.find("Properties")
                size = int(props.findtext("Content-Length", "0")) \
                    if props is not None else 0
                lm = props.findtext("Last-Modified", "") \
                    if props is not None else ""
                try:
                    mtime = calendar.timegm(time.strptime(
                        lm, "%a, %d %b %Y %H:%M:%S GMT"))
                except ValueError:
                    mtime = 0.0
                yield RemoteEntry(key, size, mtime)
            marker = root.findtext("NextMarker", "") or ""
            if not marker:
                return

    def read_file(self, key: str) -> bytes:
        with self._request("GET", key) as r:
            return r.read()

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        with self._request(
                "GET", key,
                headers={"x-ms-range":
                         f"bytes={offset}-{offset + size - 1}"}) as r:
            return r.read()

    def write_file(self, key: str, data: bytes) -> None:
        with self._request("PUT", key, data=data,
                           headers={"x-ms-blob-type": "BlockBlob"}):
            pass

    def delete_file(self, key: str) -> None:
        import urllib.error
        try:
            with self._request("DELETE", key):
                pass
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise


REMOTES = {"local": LocalDirRemote, "s3": S3Remote, "gcs": GcsRemote,
           "azure": AzureRemote}


def parse_remote_spec(spec: str) -> tuple[str, dict]:
    """Shell-facing remote spec:
      local:/cold-dir
      s3:endpoint=127.0.0.1:8333,bucket=tier,access_key=K,secret_key=S
    (the reference keeps these in remote.conf; the spec string carries the
    same fields inline)."""
    kind, _, opt = spec.partition(":")
    kind = kind or "local"
    if kind == "local":
        return kind, ({"directory": opt} if opt else {})
    options: dict = {}
    for pair in opt.split(","):
        if not pair:
            continue
        k, _, v = pair.partition("=")
        options[k.strip()] = v.strip()
    return kind, options


def make_remote(kind: str, **options) -> RemoteStorageClient:
    try:
        return REMOTES[kind](**options)
    except KeyError:
        raise ValueError(f"unknown remote {kind!r} (have {sorted(REMOTES)})")


def sync_remote_to_filer(remote: RemoteStorageClient, filer_url: str,
                         mount_dir: str, cache: bool = False,
                         timeout: float = 60.0) -> int:
    """remote.mount / remote.cache: traverse the remote and materialize
    entries under mount_dir on the filer (reference:
    shell/command_remote_mount.go + filer/read_remote.go).  Without
    `cache`, files are created as zero-chunk placeholders carrying
    Seaweed-remote-* attrs; with it, content is pulled."""
    import urllib.parse
    import urllib.request
    n = 0
    for e in remote.traverse():
        path = mount_dir.rstrip("/") + "/" + e.key
        if e.is_directory:
            req = urllib.request.Request(
                f"{_tls_scheme()}://{filer_url}{urllib.parse.quote(path + '/')}",
                data=b"", method="POST")
            with urllib.request.urlopen(req, timeout=timeout):
                pass
            continue
        headers = {
            "Seaweed-remote-size": str(e.size),
            "Seaweed-remote-mtime": str(int(e.mtime)),
            "Seaweed-remote-key": e.key,
        }
        data = remote.read_file(e.key) if cache else b""
        if not cache:
            headers["Seaweed-remote-placeholder"] = "true"
        req = urllib.request.Request(
            f"{_tls_scheme()}://{filer_url}{urllib.parse.quote(path)}",
            data=data, method="POST", headers=headers)
        with urllib.request.urlopen(req, timeout=timeout):
            pass
        n += 1
    return n


def _filer_walk(filer_url: str, dir_path: str, timeout: float = 60.0):
    """Yield (path, meta) for every file entry under dir_path on a filer."""
    import json
    import urllib.parse
    import urllib.request
    stack = [dir_path.rstrip("/") or "/"]
    while stack:
        d = stack.pop()
        url = (f"{_tls_scheme()}://{filer_url}"
               f"{urllib.parse.quote(d.rstrip('/') + '/')}?limit=100000")
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                listing = json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                continue  # directory vanished mid-walk
            # a transient listing failure must abort the walk loudly: a
            # silently-truncated walk makes meta-sync misread cached files
            # as missing and wipe them back to placeholders
            raise
        for e in listing.get("Entries") or []:
            import stat
            p = e["FullPath"]
            if e.get("IsDirectory") or stat.S_ISDIR(
                    (e.get("attr") or {}).get("mode", 0)):
                stack.append(p)
            else:
                # listings are slim; extended attrs (remote-key etc.) need
                # the per-entry metadata view
                murl = (f"{_tls_scheme()}://{filer_url}"
                        f"{urllib.parse.quote(p)}?metadata=true")
                try:
                    with urllib.request.urlopen(murl, timeout=timeout) as r2:
                        meta = json.loads(r2.read())
                except urllib.error.HTTPError as err:
                    if err.code == 404:
                        continue  # entry vanished between list and fetch
                    # same contract as the directory listing above: a
                    # transient failure must abort loudly — a skipped
                    # entry's key would miss seen_keys and the sync would
                    # stamp a placeholder over live content
                    raise
                yield p, meta


def meta_sync_remote_to_filer(remote: RemoteStorageClient, filer_url: str,
                              mount_dir: str,
                              timeout: float = 60.0) -> tuple[int, int, int]:
    """remote.meta.sync: one-shot reconciliation of a mounted directory
    against the remote's current object list (reference:
    command_remote_meta_sync.go): new objects appear as placeholders,
    changed sizes/mtimes are refreshed, filer entries whose object vanished
    are deleted. Returns (created_or_updated, deleted, unchanged)."""
    import urllib.parse
    import urllib.request
    mount_dir = mount_dir.rstrip("/") or "/"
    remote_entries = {e.key: e for e in remote.traverse()
                      if not e.is_directory}
    changed = deleted = unchanged = 0
    seen_keys = set()
    unmanaged_paths = set()
    for path, meta in _filer_walk(filer_url, mount_dir, timeout):
        ext = {k.lower(): v for k, v in (meta.get("extended") or {}).items()}
        key = ext.get("remote-key")
        if key is None:
            # locally-created file, not ours to manage — remembered so a
            # colliding remote key below never overwrites it
            unmanaged_paths.add(path)
            continue
        seen_keys.add(key)
        re_ = remote_entries.get(key)
        if re_ is None:
            req = urllib.request.Request(
                f"{_tls_scheme()}://{filer_url}{urllib.parse.quote(path)}",
                method="DELETE")
            with urllib.request.urlopen(req, timeout=timeout):
                pass
            deleted += 1
        elif str(re_.size) != ext.get("remote-size") or \
                str(int(re_.mtime)) != ext.get("remote-mtime"):
            headers = {
                "Seaweed-remote-size": str(re_.size),
                "Seaweed-remote-mtime": str(int(re_.mtime)),
                "Seaweed-remote-key": re_.key,
                "Seaweed-remote-placeholder": "true",
            }
            req = urllib.request.Request(
                f"{_tls_scheme()}://{filer_url}{urllib.parse.quote(path)}",
                data=b"", method="POST", headers=headers)
            with urllib.request.urlopen(req, timeout=timeout):
                pass
            changed += 1
        else:
            unchanged += 1
    for key, e in remote_entries.items():
        if key in seen_keys:
            continue
        path = mount_dir + "/" + e.key
        # never stamp a placeholder over an entry this mapping does not
        # manage: a locally-created file whose name collides with a
        # remote key keeps its content (the walk above already fetched
        # every existing entry's metadata — no extra round-trips)
        if path in unmanaged_paths:
            continue
        headers = {
            "Seaweed-remote-size": str(e.size),
            "Seaweed-remote-mtime": str(int(e.mtime)),
            "Seaweed-remote-key": e.key,
            "Seaweed-remote-placeholder": "true",
        }
        req = urllib.request.Request(
            f"{_tls_scheme()}://{filer_url}{urllib.parse.quote(path)}",
            data=b"", method="POST", headers=headers)
        with urllib.request.urlopen(req, timeout=timeout):
            pass
        changed += 1
    return changed, deleted, unchanged


def remote_sync_loop(remote: RemoteStorageClient, filer_url: str,
                     mount_dir: str, offset_file: str | None = None,
                     stop_event=None, timeout: float = 60.0) -> int:
    """filer.remote.sync: continuously push LOCAL changes under mount_dir
    out to the remote (reference: command/filer_remote_sync.go) by
    following the filer's meta-subscribe stream. Placeholder writes that
    came FROM the remote (remote-placeholder attr) are skipped so the two
    sync directions cannot loop. Resume offset persists across restarts."""
    import json
    import urllib.parse
    import urllib.request
    mount = mount_dir.rstrip("/") or "/"
    since = 0
    if offset_file and os.path.exists(offset_file):
        try:
            since = int(open(offset_file).read().strip() or 0)
        except ValueError:
            since = 0
    if since == 0:
        since = time.time_ns()
    applied = 0
    while stop_event is None or not stop_event.is_set():
        url = (f"{_tls_scheme()}://{filer_url}/__meta__/subscribe?"
               + urllib.parse.urlencode({"since": str(since),
                                         "prefix": mount, "live": "true"}))
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                for raw in r:
                    if stop_event is not None and stop_event.is_set():
                        return applied
                    line = raw.strip()
                    if not line:
                        continue
                    ev = json.loads(line)
                    # apply (with backoff) BEFORE advancing the offset: a
                    # transiently-failing remote must replay the event on
                    # reconnect, not lose it
                    from seaweedfs_tpu_torch.replication.sink import retry
                    if retry(lambda: _apply_local_event_to_remote(
                            remote, filer_url, mount, ev, timeout)):
                        applied += 1
                    since = max(since, ev.get("ts_ns", since) + 1)
                    if offset_file:
                        tmp = offset_file + ".tmp"
                        with open(tmp, "w") as f:
                            f.write(str(since))
                        os.replace(tmp, offset_file)
        except (urllib.error.URLError, OSError, ValueError):
            if stop_event is not None and stop_event.wait(2.0):
                return applied
            if stop_event is None:
                time.sleep(2.0)
    return applied


def _apply_local_event_to_remote(remote, filer_url: str, mount: str,
                                 ev: dict, timeout: float) -> bool:
    import stat
    import urllib.parse
    import urllib.request
    old, new = ev.get("old_entry"), ev.get("new_entry")

    def key_of(entry) -> str | None:
        p = entry.get("full_path", "")
        if not p.startswith(mount + "/"):
            return None
        return p[len(mount) + 1:]

    def is_dir(entry) -> bool:
        return stat.S_ISDIR((entry.get("attr") or {}).get("mode", 0))

    if new is not None:
        ext = {k.lower(): v for k, v in (new.get("extended") or {}).items()}
        if ext.get("remote-placeholder") == "true":
            return False  # inbound mount/cache traffic, not a local change
        key = key_of(new)
        if key is None or is_dir(new):
            return False
        try:
            with urllib.request.urlopen(
                    f"{_tls_scheme()}://{filer_url}"
                    f"{urllib.parse.quote(new['full_path'])}",
                    timeout=timeout) as r:
                data = r.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                # deleted/renamed after this event was logged; a later
                # event supersedes it — skip, don't stall the stream
                return False
            raise
        remote.write_file(key, data)
        if old is not None and key_of(old) not in (None, key):
            remote.delete_file(key_of(old))
        return True
    if old is not None and not is_dir(old):
        key = key_of(old)
        if key is not None:
            remote.delete_file(key)
            return True
    return False
