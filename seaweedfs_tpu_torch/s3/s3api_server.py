"""S3-compatible REST gateway over the filer.

Reference: weed/s3api/ — s3api_server.go (router), s3api_bucket_handlers.go,
s3api_object_handlers.go (+_put/_copy/_multipart/_tagging),
filer_multipart.go (multipart assembly by chunk-list splice, no data copy),
s3api_object_handlers_list.go (ListObjects V1/V2 with prefix/delimiter/
marker), s3err/ (XML error bodies). Buckets are directories under
`/buckets/{bucket}` on the filer; each bucket doubles as a collection name
for its blob chunks so bucket deletion can reclaim volumes.

The gateway holds no object state of its own: object data flows through the
filer's auto-chunking upload path, multipart parts are normal filer files
under `/buckets/{bucket}/.uploads/{uploadId}/`, and CompleteMultipartUpload
splices the parts' chunk lists into one entry via the filer raw-entry API,
then deletes part entries with skipChunkDeletion.

Counterpart of `seaweedfs_tpu/s3/s3api_server.py`, whole: the same
routes, XML bodies, ETags and filer layout, so a bucket written through
either package's gateway serves through the other's.  Like the port's
filer server it has no device and loads no torch: an object GET proxies
the filer, whose chunk reads from an EC volume with lost data shards are
degraded reads that the card servers decode.
"""

from __future__ import annotations

import asyncio
import base64
import calendar
import hashlib
import hmac
import json
import logging
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET

import aiohttp
from aiohttp import web

from seaweedfs_tpu_torch.maintenance import faults
from seaweedfs_tpu_torch.s3.auth import (ACTION_ADMIN, ACTION_LIST,
                                         ACTION_READ, ACTION_TAGGING,
                                         ACTION_WRITE, AuthError, Identity,
                                         IdentityAccessManagement,
                                         decode_aws_chunked)
from seaweedfs_tpu_torch.s3.circuit_breaker import CircuitBreaker
from seaweedfs_tpu_torch.s3.iamapi_server import IDENTITY_PATH
from seaweedfs_tpu_torch.s3.policy import BucketPolicyStore, PolicyError
from seaweedfs_tpu_torch.s3.qos import TenantQoS
from seaweedfs_tpu_torch.security import jwt
from seaweedfs_tpu_torch.security import tls as _tls
from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme
from seaweedfs_tpu_torch.stats import heat, netflow, pipeline, profile, trace
from seaweedfs_tpu_torch.storage import types as _t
from seaweedfs_tpu_torch.utils import resilience
from seaweedfs_tpu_torch.utils.http import aiohttp_trace_config

log = logging.getLogger("s3")

BUCKETS_DIR = "/buckets"
UPLOADS_SUBDIR = ".uploads"
TAG_PREFIX = "x-amz-tag-"
CIRCUIT_BREAKER_PATH = "/etc/s3/circuit_breaker.json"
S3_XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"


def _xml(root: ET.Element) -> bytes:
    return b'<?xml version="1.0" encoding="UTF-8"?>' + \
        ET.tostring(root, encoding="unicode").encode()


def _el(parent: ET.Element, tag: str, text: str | None = None) -> ET.Element:
    e = ET.SubElement(parent, tag)
    if text is not None:
        e.text = text
    return e


def _is_aws_chunked(req) -> bool:
    """Single source of truth for the chunked-upload body encoding check."""
    return req.headers.get("x-amz-content-sha256", "").startswith("STREAMING-") \
        or "aws-chunked" in req.headers.get("Content-Encoding", "")


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts))


def _ttl_days(ttl: str) -> int:
    """Filer ttl string -> whole lifecycle days (rounded up)."""
    try:
        minutes = _t.TTL.parse(ttl).minutes
    except (KeyError, ValueError):
        return 1
    return max(1, -(-minutes // (24 * 60)))


def _error_response(code: str, message: str, status: int,
                    resource: str = "") -> web.Response:
    root = ET.Element("Error")
    _el(root, "Code", code)
    _el(root, "Message", message)
    _el(root, "Resource", resource)
    _el(root, "RequestId", uuid.uuid4().hex[:16])
    return web.Response(body=_xml(root), status=status,
                        content_type="application/xml")


class S3ApiServer:
    def __init__(self, filer_url: str, host: str = "127.0.0.1",
                 port: int = 8333, iam: IdentityAccessManagement | None = None,
                 buckets_dir: str = BUCKETS_DIR, security=None,
                 breaker=None, master_url: str | None = None):
        self.filer_url = filer_url
        # optional master registration: announces this gateway in the
        # cluster-member registry so /cluster/metrics federates it and
        # the canary prober can exercise the s3 path
        self.master_url = master_url
        self.host, self.port = host, port
        self.iam = iam or IdentityAccessManagement()
        self._PolicyError = PolicyError
        self.policies = BucketPolicyStore(
            lambda method, path, data=None:
                self._filer(method, path, data=data))
        self.breaker = breaker or CircuitBreaker()
        # per-tenant token-bucket admission (s3/qos.py): heat-weighted
        # shares of WEEDTPU_S3_QOS_RATE, shed as 429 before any work
        self.qos = TenantQoS()
        self.buckets_dir = buckets_dir.rstrip("/")
        self.security = security
        self.app = web.Application(
            client_max_size=5 * 1024 * 1024 * 1024,
            # trust_flow="loopback": this is the one PUBLIC server —
            # a remote client's X-Weedtpu-Class/-Role headers must not
            # reclassify its requests out of the SLO denominators or
            # poison the per-class byte ledger, while the same-host
            # master's canary probes stay class=internal.  The same
            # loopback rule covers X-Weedtpu-Tenant: a remote caller
            # cannot bill its traffic to another tenant — the gateway
            # resolves identity from the request itself (access key,
            # else bucket, else anonymous) once per request, and heat,
            # per-tenant counters, and future QoS all read that field.
            middlewares=[trace.aiohttp_middleware(
                "s3", trust_flow="loopback",
                tenant_resolver=lambda req: heat.resolve_tenant(
                    req.headers, req.query, req.path))])
        netflow.install(self.app, "s3")
        # the gateway is the one PUBLIC server: its debug surface answers
        # loopback operators only (debug_routes ships every handler
        # pre-wrapped in the shared guard), so /debug/* can't leak
        # presigned-URL query strings, trace paths, or stack contents
        # past the SigV4 wall — and a bucket literally named "debug"
        # still 403s rather than being shadowed for remote clients
        self.app.add_routes(trace.debug_routes())
        # workload heat sketch: loopback-only on the public gateway (it
        # names tenants and object fids), like the rest of the debug
        # surface; a bucket literally named "heat" still 403s remotely
        # rather than being shadowed
        self.app.add_routes([web.get("/heat",
                                     trace.debug_guard(heat.handle_heat)),
                             web.get("/perf",
                                     trace.debug_guard(
                                         pipeline.handle_perf)),
                             web.route("*", "/__qos__",
                                       trace.debug_guard(
                                           self.handle_qos))])
        self.app.add_routes([web.route("*", "/{tail:.*}", self.dispatch)])
        self._runner: web.AppRunner | None = None
        self._session: aiohttp.ClientSession | None = None

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    # the shared loopback gate (stats/trace.py): same 403 semantics on
    # every server's debug surface, one copy of the check
    _debug_local = staticmethod(trace.debug_guard)

    async def start(self) -> None:
        self._session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(ssl=_tls.client_ssl()),
            timeout=aiohttp.ClientTimeout(total=3600),
            trace_configs=[aiohttp_trace_config("s3")])
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port,
                           ssl_context=_tls.server_ssl("s3"))
        await site.start()
        self._ident_task = asyncio.create_task(self._identity_sync())
        self._register_task = None
        if self.master_url:
            self._register_task = asyncio.create_task(self._register_loop())
        profile.ensure_started()  # WEEDTPU_PROFILE_HZ, process-wide
        faults.register_node(self.url, "s3")
        log.info("s3 gateway on %s -> filer %s", self.url, self.filer_url)

    async def _identity_sync(self) -> None:
        """Load IAM-API-managed identities from the filer and hot-reload on
        meta events (reference: s3api/auth_credentials_subscribe.go).  A
        static -config file still wins if the filer has no identity.json."""
        # watch /etc: covers both /etc/iam/identity.json and
        # /etc/s3/circuit_breaker.json (shell s3.circuitbreaker writes the
        # latter; reference stores its config at the same filer path)
        prefix = "/etc"

        async def load_once() -> None:
            st, body = await self._filer("GET", IDENTITY_PATH)
            if st == 200 and body:
                loaded = IdentityAccessManagement.from_config(
                    json.loads(body))
                # an identity store exists: auth stays on even if the list
                # is (or becomes) empty — deleting the last IAM user means
                # deny-all, never open access
                self.iam.replace_identities(loaded.identities)
                self.iam.mark_configured()
                log.info("loaded %d identities from filer",
                         len(loaded.identities))
            st, body = await self._filer("GET", CIRCUIT_BREAKER_PATH)
            if st == 200 and body:
                try:
                    cfg = json.loads(body)
                except ValueError:
                    log.warning("malformed circuit breaker config ignored")
                else:
                    # per-field coercion: one non-numeric value (e.g.
                    # "global_max_requests": "abc") is logged and skipped
                    # instead of crashing the watch iteration that also
                    # performs identity hot-reload
                    for field in ("global_max_requests",
                                  "global_max_upload_bytes",
                                  "bucket_max_requests"):
                        try:
                            setattr(self.breaker, field,
                                    int(cfg.get(field, 0)))
                        except (ValueError, TypeError):
                            log.warning(
                                "circuit breaker config %s=%r is not a "
                                "number; keeping previous value",
                                field, cfg.get(field))
                    log.info("loaded circuit breaker config: %s", cfg)

        while True:
            try:
                await load_once()
                url = f"{_tls_scheme()}://{self.filer_url}/__meta__/subscribe"
                async with self._session.get(
                        url, params={"prefix": prefix, "live": "true"},
                        headers=self._filer_auth(write=False)) as r:
                    async for line in r.content:
                        if line.strip():  # skip keepalive blank lines
                            await load_once()
            except (aiohttp.ClientError, json.JSONDecodeError, KeyError,
                    TypeError, ValueError, ConnectionError, OSError):
                log.warning("identity sync error", exc_info=True)
            await asyncio.sleep(5)

    async def stop(self) -> None:
        if getattr(self, "_register_task", None):
            self._register_task.cancel()
        if getattr(self, "_ident_task", None):
            self._ident_task.cancel()
        if self._session:
            await self._session.close()
        if self._runner:
            await self._runner.cleanup()

    async def _register_loop(self) -> None:
        """Announce this gateway to the master every 10s (the same
        cadence and registry the filer uses — cluster.go in the
        reference); members expire 30s after the last beat."""
        bo = resilience.Backoff(base=2.0, cap=30.0)
        while True:
            try:
                async with self._session.post(
                        f"{_tls_scheme()}://{self.master_url}"
                        f"/cluster/register",
                        json={"type": "s3", "address": self.url}) as r:
                    await r.read()
            except asyncio.CancelledError:
                raise
            except Exception:
                # same contract as the filer's loop: registration must
                # survive anything (incl. session-recreate races) — a
                # dead loop silently ages the gateway out of the
                # cluster-member registry within 30s.  Failed beats
                # retry on the shared jittered backoff instead of the
                # full steady-state cadence
                await asyncio.sleep(bo.next())
                continue
            bo.reset()
            await asyncio.sleep(10)

    # -- filer client --------------------------------------------------

    def _fp(self, bucket: str, key: str = "") -> str:
        p = f"{self.buckets_dir}/{bucket}"
        if key:
            p += "/" + key.lstrip("/")
        return p

    def _filer_auth(self, write: bool) -> dict:
        """Sign gateway->filer calls when the filer enforces its JWT keys."""
        if self.security is None:
            return {}
        key = self.security.filer_write if write else self.security.filer_read
        if not key:
            return {}
        return {"Authorization": "Bearer " + jwt.gen_jwt(key, "")}

    async def _filer(self, method: str, path: str, *, params=None, data=None,
                     headers=None, ok=(200, 201, 204)) -> tuple[int, bytes]:
        url = f"{_tls_scheme()}://{self.filer_url}{urllib.parse.quote(path)}"
        headers = dict(headers or {})
        headers.update(self._filer_auth(write=method not in ("GET", "HEAD")))
        async with self._session.request(method, url, params=params,
                                         data=data, headers=headers) as r:
            body = await r.read()
            return r.status, body

    async def _filer_meta(self, path: str) -> dict | None:
        st, body = await self._filer("GET", path, params={"metadata": "true"})
        if st != 200:
            return None
        return json.loads(body)

    async def _filer_list(self, dir_path: str, last: str = "",
                          limit: int = 1000, prefix: str = "",
                          include_last: bool = False) -> dict:
        params = {"limit": str(limit)}
        if last:
            params["lastFileName"] = last
            if include_last:
                params["includeLastFile"] = "true"
        if prefix:
            params["prefix"] = prefix
        st, body = await self._filer("GET", dir_path.rstrip("/") + "/",
                                     params=params)
        if st != 200:
            return {"Entries": []}
        return json.loads(body)

    # -- dispatch ------------------------------------------------------

    async def handle_qos(self, req: web.Request) -> web.Response:
        """Loopback-only QoS surface: GET returns the live per-tenant
        admission state; POST {"rate"|"burst_s"|"weights"} retunes it —
        the operator/governor seam (qos.set_rate is the same contract
        every governed TokenBucket exposes)."""
        if req.method == "POST":
            try:
                body = await req.json()
            except ValueError:
                return web.json_response({"error": "bad json"}, status=400)
            weights = body.get("weights")
            if weights is not None and not isinstance(weights, dict):
                return web.json_response({"error": "weights must be a "
                                          "tenant->weight object"},
                                         status=400)
            self.qos.configure(rate=body.get("rate"),
                               burst_s=body.get("burst_s"),
                               weights=weights)
        return web.json_response(self.qos.status())

    async def dispatch(self, req: web.Request) -> web.StreamResponse:
        raw_path = req.raw_path.split("?", 1)[0]
        path = urllib.parse.unquote(raw_path)
        bucket, _, key = path.lstrip("/").partition("/")
        q = {k: req.query.get(k, "") for k in req.query}

        # tenant QoS admission: the middleware already resolved this
        # request's tenant; a dry tenant bucket sheds with 429 SlowDown
        # HERE, before auth or body buffering, so an abusive tenant
        # costs the gateway almost nothing per rejected request
        if self.qos.enabled:
            tenant = heat.current_tenant() or heat.resolve_tenant(
                req.headers, req.query, req.path)
            if not self.qos.admit(tenant):
                return _error_response(
                    "SlowDown",
                    "Your tenant is over its admission rate; "
                    "reduce your request rate.", 429, path)

        # circuit breaker (reference: s3api_circuit_breaker.go): shed load
        # with 503 SlowDown before doing any work
        if req.method in ("PUT", "POST"):
            upload_hint = req.content_length or 0
            if not upload_hint and self.breaker.global_max_upload_bytes:
                # chunked transfer hides the size; reserve a conservative
                # slice so the byte budget still bounds memory
                upload_hint = 64 * 1024 * 1024
        else:
            upload_hint = 0
        if not self.breaker.acquire(bucket, upload_hint):
            return _error_response(
                "SlowDown", "Please reduce your request rate.", 503, path)
        try:
            return await self._dispatch_inner(req, raw_path, path, bucket,
                                              key, q)
        finally:
            self.breaker.release(bucket, upload_hint)

    async def _dispatch_inner(self, req, raw_path, path, bucket, key,
                              q) -> web.StreamResponse:
        # browser form upload: the POST policy in the form IS the auth
        # (reference: s3api_object_handlers_postpolicy.go)
        if req.method == "POST" and bucket and not key and \
                req.headers.get("Content-Type", "").startswith(
                    "multipart/form-data"):
            return await self.post_policy_upload(req, bucket)

        # Authenticate BEFORE buffering the payload so an unauthenticated
        # client cannot make the gateway hold a multi-GB body in RAM.
        try:
            ident = self.iam.authenticate(req.method, raw_path, q,
                                          req.headers)
        except AuthError as e:
            return _error_response(e.code, str(e), e.status, path)

        body: bytes | None = None
        try:
            if req.method in ("PUT", "POST"):
                body = await self._read_body(req)
                # the signature covered x-amz-content-sha256; now that the
                # body is read, check the body actually matches it
                # (STREAMING-* uploads were verified chunk-by-chunk inside
                # _read_body; verify_payload_hash no-ops for those)
                if self.iam.enabled:
                    self.iam.verify_payload_hash(req.headers, body)
        except AuthError as e:
            return _error_response(e.code, str(e), e.status, path)

        try:
            if not bucket:
                return await self.list_buckets(ident)
            # bucket policies layer under the identity check (reference:
            # the policy engine in weed/s3api/policy/); refresh failure
            # degrades to identity-only auth, never a 500 per request
            try:
                await self.policies.refresh(bucket, time.time())
            except Exception:
                pass
            if not key:
                return await self.bucket_op(req, ident, bucket, q, body)
            return await self.object_op(req, ident, bucket, key, q, body)
        except AuthError as e:
            return _error_response(e.code, str(e), e.status, path)

    async def _read_body(self, req: web.Request) -> bytes:
        body = await req.read()
        if _is_aws_chunked(req):
            # signed streams get the full chunk-signature chain verified
            # (seed = the already-authenticated header signature); forged
            # or truncated chunks are rejected, not silently accepted
            # (reference: chunked_reader_v4.go:38-60,170-214)
            ctx = self.iam.chunked_context(req.headers) \
                if self.iam.enabled else None
            decoded_len = None
            dl_hdr = req.headers.get("x-amz-decoded-content-length")
            if dl_hdr and dl_hdr.isdigit():
                decoded_len = int(dl_hdr)
            body = decode_aws_chunked(body, ctx, decoded_len)
        return body

    def _require_admin(self, ident: Identity, bucket: str) -> None:
        """Policy management is AWS's s3:PutBucketPolicy-class privilege:
        only the Admin action grants it, and bucket policies themselves
        cannot (a policy-granted writer must never rewrite the policy)."""
        if not ident.can_do(ACTION_ADMIN, bucket):
            raise AuthError("AccessDenied", "Access Denied")

    def _require(self, ident: Identity, action: str, bucket: str,
                 key: str = "") -> None:
        """AWS evaluation order: explicit policy Deny always wins, a
        policy Allow grants, otherwise the identity's own action list
        decides.  An unreadable stored policy denies everyone but bucket
        admins (its Deny statements are unknown — failing open would be
        worse)."""
        verdict = self.policies.evaluate(bucket, ident.name, action, key)
        if verdict == "deny":
            raise AuthError("AccessDenied",
                            "Access Denied by bucket policy")
        if verdict == "broken":
            if ident.can_do(ACTION_ADMIN, bucket):
                return
            raise AuthError("AccessDenied",
                            "bucket policy unreadable; access restricted")
        if verdict == "allow":
            return
        if not ident.can_do(action, bucket):
            raise AuthError("AccessDenied", "Access Denied")

    # -- service level -------------------------------------------------

    async def list_buckets(self, ident: Identity) -> web.Response:
        listing = await self._filer_list(self.buckets_dir, limit=10000)
        root = ET.Element("ListAllMyBucketsResult", xmlns=S3_XMLNS)
        owner = _el(root, "Owner")
        _el(owner, "ID", ident.name)
        _el(owner, "DisplayName", ident.name)
        buckets = _el(root, "Buckets")
        for e in listing.get("Entries", []):
            if not e.get("IsDirectory"):
                continue
            name = e["FullPath"].rsplit("/", 1)[-1]
            if not ident.can_do(ACTION_LIST, name):
                continue
            b = _el(buckets, "Bucket")
            _el(b, "Name", name)
            _el(b, "CreationDate", _iso(e.get("Crtime", 0)))
        return web.Response(body=_xml(root), content_type="application/xml")

    def _check_post_policy(self, fields: dict, bucket: str,
                           key: str) -> tuple[int, int]:
        """Verify the POST policy signature, expiration, and conditions
        BEFORE any file bytes are buffered.  Returns the allowed
        (min, max) content-length range (max<0 = unlimited).  Raises
        AuthError on any failure."""
        policy_b64 = fields.get("policy", "")
        sig = fields.get("x-amz-signature", "")
        cred = fields.get("x-amz-credential", "")
        if not (policy_b64 and sig and cred):
            raise AuthError("AccessDenied", "missing policy signature")
        try:
            access_key, datestamp, region, service = cred.split("/")[:4]
            ident, c = self.iam.lookup(access_key)
            skey = IdentityAccessManagement._sig_key(
                c.secret_key, datestamp, region, service)
            want = hmac.new(skey, policy_b64.encode(),
                            hashlib.sha256).hexdigest()
            if not hmac.compare_digest(want, sig):
                raise AuthError("SignatureDoesNotMatch",
                                "post policy signature mismatch")
            policy = json.loads(base64.b64decode(policy_b64))
            expiration = policy.get("expiration", "")
            if not expiration:
                # AWS rejects never-expiring policies; a leaked signed
                # policy must not grant writes forever
                raise AuthError("AccessDenied", "policy has no expiration")
            exp = calendar.timegm(time.strptime(
                expiration.split(".")[0].rstrip("Z"), "%Y-%m-%dT%H:%M:%S"))
            if time.time() > exp:
                raise AuthError("AccessDenied", "policy expired")
            # enforce the signed conditions (policy/post-policy.go): the
            # narrowly-scoped policy must not authorize other buckets/keys
            length_min, length_max = 0, -1
            for cond in policy.get("conditions", []):
                if isinstance(cond, dict):
                    for f, want_v in cond.items():
                        f = f.lstrip("$").lower()
                        got = {"bucket": bucket, "key": key}.get(
                            f, fields.get(f, ""))
                        if got != str(want_v):
                            raise AuthError(
                                "AccessDenied",
                                f"policy condition failed: {f}")
                elif isinstance(cond, list) and len(cond) == 3:
                    op, f, want_v = cond[0], str(cond[1]), cond[2]
                    op = str(op).lower()
                    if op == "content-length-range":
                        length_min, length_max = int(cond[1]), int(cond[2])
                        continue
                    f = f.lstrip("$").lower()
                    got = {"bucket": bucket, "key": key}.get(
                        f, fields.get(f, ""))
                    if op == "eq" and got != str(want_v):
                        raise AuthError("AccessDenied",
                                        f"policy condition failed: {f}")
                    if op == "starts-with" and \
                            not got.startswith(str(want_v)):
                        raise AuthError("AccessDenied",
                                        f"policy condition failed: {f}")
            if not ident.can_do(ACTION_WRITE, bucket):
                raise AuthError("AccessDenied", "Access Denied")
            return length_min, length_max
        except AuthError:
            raise
        except (ValueError, IndexError, KeyError, TypeError):
            raise AuthError("InvalidPolicyDocument", "cannot parse policy",
                            400)

    async def post_policy_upload(self, req, bucket) -> web.Response:
        """Browser-based form upload with a signed POST policy
        (reference: s3api_object_handlers_postpolicy.go +
        policy/post-policy.go).  The form's policy document + signature
        authenticate the request; ${filename} in the key is substituted.
        S3 requires the file part last, so the policy is verified from the
        preceding fields BEFORE any file bytes are buffered."""
        fields: dict[str, str] = {}
        file_data: bytes | None = None
        filename = ""
        length_min, length_max = 0, -1
        reader = await req.multipart()
        while True:
            part = await reader.next()
            if part is None:
                break
            name = (part.name or "").lower()
            if name == "file":
                filename = part.filename or ""
                key = fields.get("key", "").replace("${filename}", filename)
                if not key:
                    return _error_response("InvalidArgument",
                                           "missing key field", 400, bucket)
                if self.iam.enabled:
                    try:
                        length_min, length_max = self._check_post_policy(
                            fields, bucket, key)
                    except AuthError as e:
                        return _error_response(e.code, str(e), e.status, key)
                file_data = await part.read(decode=False)
                break  # fields after the file part are ignored, per S3
            fields[name] = (await part.read(decode=False)).decode(
                errors="replace")
        if file_data is None:
            return _error_response("InvalidArgument",
                                   "POST requires a file field", 400, bucket)
        key = fields.get("key", "").replace("${filename}", filename)
        if length_max >= 0 and len(file_data) > length_max:
            return _error_response("EntityTooLarge",
                                   "upload exceeds the policy's "
                                   "content-length-range", 400, key)
        if length_min > 0 and len(file_data) < length_min:
            return _error_response("EntityTooSmall",
                                   "upload is under the policy's "
                                   "content-length-range", 400, key)

        headers = {"Content-Type": fields.get("content-type",
                                              "application/octet-stream")}
        for k, v in fields.items():
            if k.startswith("x-amz-meta-"):
                headers[f"Seaweed-{k}"] = v
        st, rbody = await self._filer("PUT", self._fp(bucket, key),
                                      params={"collection": bucket},
                                      data=file_data, headers=headers)
        if st >= 300:
            return _error_response("InternalError",
                                   f"filer: {st}", 500, key)
        try:
            status = int(fields.get("success_action_status", "204"))
        except ValueError:
            status = 204
        if status not in (200, 201, 204):
            status = 204
        if status == 201:
            root = ET.Element("PostResponse")
            _el(root, "Bucket", bucket)
            _el(root, "Key", key)
            return web.Response(status=201, body=_xml(root),
                                content_type="application/xml")
        return web.Response(status=status)

    # -- bucket level --------------------------------------------------

    async def bucket_op(self, req, ident, bucket, q, body) -> web.Response:
        m = req.method
        if m == "PUT":
            if "policy" in q:
                # rewriting the policy is privilege management, not an
                # object write: an object-writer identity must not be able
                # to grant itself (or everyone) the bucket
                self._require_admin(ident, bucket)
                return await self.put_bucket_policy(ident, bucket, body)
            self._require(ident, ACTION_WRITE, bucket)
            if "lifecycle" in q:
                return await self.put_bucket_lifecycle(bucket, body)
            return await self.put_bucket(bucket)
        if m == "DELETE":
            if "policy" in q:
                self._require_admin(ident, bucket)
                return await self.delete_bucket_policy(ident, bucket)
            self._require(ident, ACTION_WRITE, bucket)
            if "lifecycle" in q:
                return await self.delete_bucket_lifecycle(bucket)
            return await self.delete_bucket(bucket)
        if m == "HEAD":
            self._require(ident, ACTION_LIST, bucket)
            meta = await self._filer_meta(self._fp(bucket))
            if meta is None:
                return _error_response("NoSuchBucket",
                                       "The specified bucket does not exist",
                                       404, bucket)
            return web.Response()
        if m == "POST" and "delete" in q:
            self._require(ident, ACTION_WRITE, bucket)
            return await self.batch_delete(bucket, body)
        if m == "GET":
            if "location" in q:
                root = ET.Element("LocationConstraint", xmlns=S3_XMLNS)
                return web.Response(body=_xml(root),
                                    content_type="application/xml")
            if "uploads" in q:
                self._require(ident, ACTION_LIST, bucket)
                return await self.list_multipart_uploads(bucket)
            if "acl" in q:
                return self._canned_acl(ident)
            if "lifecycle" in q:
                self._require(ident, ACTION_LIST, bucket)
                return await self.get_bucket_lifecycle(bucket)
            if "policy" in q:
                # the document discloses principals/access structure
                self._require_admin(ident, bucket)
                return await self.get_bucket_policy(ident, bucket)
            for sub in ("cors", "website"):
                if sub in q:
                    return _error_response(
                        f"NoSuch{sub.capitalize()}Configuration",
                        f"The {sub} configuration does not exist", 404, bucket)
            if "versioning" in q:
                root = ET.Element("VersioningConfiguration", xmlns=S3_XMLNS)
                return web.Response(body=_xml(root),
                                    content_type="application/xml")
            if "tagging" in q:
                return await self.get_tagging(bucket, "")
            self._require(ident, ACTION_LIST, bucket)
            meta = await self._filer_meta(self._fp(bucket))
            if meta is None:
                return _error_response("NoSuchBucket",
                                       "The specified bucket does not exist",
                                       404, bucket)
            return await self.list_objects(bucket, q)
        return _error_response("MethodNotAllowed", "method not allowed", 405)

    def _canned_acl(self, ident: Identity) -> web.Response:
        root = ET.Element("AccessControlPolicy", xmlns=S3_XMLNS)
        owner = _el(root, "Owner")
        _el(owner, "ID", ident.name)
        acl = _el(root, "AccessControlList")
        grant = _el(acl, "Grant")
        grantee = _el(grant, "Grantee")
        grantee.set("xmlns:xsi", "http://www.w3.org/2001/XMLSchema-instance")
        grantee.set("xsi:type", "CanonicalUser")
        _el(grantee, "ID", ident.name)
        _el(grant, "Permission", "FULL_CONTROL")
        return web.Response(body=_xml(root), content_type="application/xml")

    # -- bucket lifecycle (reference: s3api_bucket_handlers.go:313-400 —
    #    expiry rules map onto per-prefix TTLs in the filer conf; the
    #    filer's TTL machinery then ages objects out) ---------------------

    async def _filer_conf(self) -> dict:
        async with self._session.get(
                f"{_tls_scheme()}://{self.filer_url}/__admin__/filer_conf",
                headers=self._filer_auth(write=False)) as r:
            return await r.json(content_type=None)

    async def _filer_conf_put(self, conf: dict) -> None:
        async with self._session.post(
                f"{_tls_scheme()}://{self.filer_url}/__admin__/filer_conf",
                json=conf, headers=self._filer_auth(write=True)) as r:
            if r.status >= 300:
                raise RuntimeError(f"filer conf update: {r.status}")

    async def _bucket_missing(self, bucket: str) -> web.Response | None:
        if await self._filer_meta(self._fp(bucket)) is None:
            return _error_response("NoSuchBucket",
                                   "The specified bucket does not exist",
                                   404, bucket)
        return None

    # -- bucket policy (reference: weed/s3api/policy/ + the
    #    Get/Put/DeleteBucketPolicy handlers) ----------------------------

    async def get_bucket_policy(self, ident: Identity,
                                bucket: str) -> web.Response:
        missing = await self._bucket_missing(bucket)
        if missing is not None:
            return missing
        st, body = await self._filer(
            "GET", f"{self.policies.PATH}/{bucket}.json")
        if st != 200 or not body:
            return _error_response("NoSuchBucketPolicy",
                                   "The bucket policy does not exist",
                                   404, bucket)
        return web.Response(body=body, content_type="application/json")

    async def put_bucket_policy(self, ident: Identity, bucket: str,
                                body: bytes) -> web.Response:
        missing = await self._bucket_missing(bucket)
        if missing is not None:
            return missing
        try:
            await self.policies.put(bucket, body or b"")
        except self._PolicyError as e:
            return _error_response("MalformedPolicy", str(e), 400, bucket)
        return web.Response(status=204)

    async def delete_bucket_policy(self, ident: Identity,
                                   bucket: str) -> web.Response:
        missing = await self._bucket_missing(bucket)
        if missing is not None:
            return missing
        await self.policies.delete(bucket)
        return web.Response(status=204)

    async def put_bucket_lifecycle(self, bucket: str,
                                   body: bytes) -> web.Response:
        missing = await self._bucket_missing(bucket)
        if missing is not None:
            return missing
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            return _error_response("MalformedXML", "bad lifecycle XML", 400,
                                   bucket)

        def _find(el, tag):
            # lifecycle docs come with or without the S3 namespace
            found = el.find(f"{{{S3_XMLNS}}}{tag}")
            return found if found is not None else el.find(tag)

        new_rules: list[tuple[str, int]] = []  # (prefix, days)
        for rule in list(root):
            status = _find(rule, "Status")
            if status is None or status.text != "Enabled":
                continue
            exp = _find(rule, "Expiration")
            if exp is None:
                continue
            days_el = _find(exp, "Days")
            if days_el is None:
                continue
            try:
                days = int(days_el.text)
            except (TypeError, ValueError):
                return _error_response("MalformedXML", "bad Days", 400,
                                       bucket)
            if days <= 0:
                return _error_response(
                    "InvalidArgument", "Days must be positive", 400, bucket)
            prefix = ""
            filt = _find(rule, "Filter")
            pfx_el = _find(filt, "Prefix") if filt is not None else \
                _find(rule, "Prefix")
            if pfx_el is not None and pfx_el.text:
                prefix = pfx_el.text
            new_rules.append((prefix, days))

        # the put REPLACES this bucket's expiry rules via per-prefix
        # upserts/deletes, so concurrent lifecycle updates on OTHER
        # buckets/prefixes compose instead of clobbering each other
        conf = await self._filer_conf()
        bucket_root = f"{self.buckets_dir}/{bucket}/"
        old = {r["location_prefix"]: r for r in conf.get("locations", [])
               if r.get("location_prefix", "").startswith(bucket_root)
               and r.get("ttl")}
        new_prefixes = {bucket_root + p for p, _ in new_rules}
        for stale in set(old) - new_prefixes:
            await self._filer_conf_put({"delete_prefix": stale})
        for prefix, days in new_rules:
            loc_prefix = bucket_root + prefix
            merged = dict(old.get(loc_prefix)
                          or {"location_prefix": loc_prefix,
                              "collection": bucket})
            merged["ttl"] = f"{days}d"
            await self._filer_conf_put(merged)
        return web.Response(status=200)

    async def get_bucket_lifecycle(self, bucket: str) -> web.Response:
        missing = await self._bucket_missing(bucket)
        if missing is not None:
            return missing
        conf = await self._filer_conf()
        bucket_root = f"{self.buckets_dir}/{bucket}/"
        rules = [(r["location_prefix"][len(bucket_root):], r["ttl"])
                 for r in conf.get("locations", [])
                 if r.get("location_prefix", "").startswith(bucket_root)
                 and r.get("ttl")]
        if not rules:
            return _error_response(
                "NoSuchLifecycleConfiguration",
                "The lifecycle configuration does not exist", 404, bucket)
        root = ET.Element("LifecycleConfiguration", xmlns=S3_XMLNS)
        for prefix, ttl in sorted(rules):
            rule = _el(root, "Rule")
            _el(rule, "ID", prefix or bucket)
            filt = _el(rule, "Filter")
            _el(filt, "Prefix", prefix)
            _el(rule, "Status", "Enabled")
            exp = _el(rule, "Expiration")
            _el(exp, "Days", str(_ttl_days(ttl)))
        return web.Response(body=_xml(root),
                            content_type="application/xml")

    async def delete_bucket_lifecycle(self, bucket: str) -> web.Response:
        missing = await self._bucket_missing(bucket)
        if missing is not None:
            return missing
        conf = await self._filer_conf()
        bucket_root = f"{self.buckets_dir}/{bucket}/"
        for r in conf.get("locations", []):
            if not (r.get("location_prefix", "").startswith(bucket_root)
                    and r.get("ttl")):
                continue
            keeps_other_settings = any(
                r.get(k) for k in ("replication", "fsync", "disk_type",
                                   "read_only")) or \
                r.get("collection") not in ("", bucket)
            if keeps_other_settings:
                await self._filer_conf_put(dict(r, ttl=""))
            else:  # the rule only carried the ttl: drop it entirely
                await self._filer_conf_put(
                    {"delete_prefix": r["location_prefix"]})
        return web.Response(status=204)

    async def put_bucket(self, bucket: str) -> web.Response:
        if not _valid_bucket_name(bucket):
            return _error_response("InvalidBucketName",
                                   "The specified bucket is not valid", 400,
                                   bucket)
        meta = await self._filer_meta(self._fp(bucket))
        if meta is not None:
            return _error_response("BucketAlreadyExists",
                                   "The requested bucket name already exists",
                                   409, bucket)
        st, _ = await self._filer("POST", self._fp(bucket) + "/")
        if st >= 300:
            return _error_response("InternalError", f"filer: {st}", 500)
        return web.Response(headers={"Location": "/" + bucket})

    async def delete_bucket(self, bucket: str) -> web.Response:
        meta = await self._filer_meta(self._fp(bucket))
        if meta is None:
            return _error_response("NoSuchBucket",
                                   "The specified bucket does not exist",
                                   404, bucket)
        st, _ = await self._filer("DELETE", self._fp(bucket),
                                  params={"recursive": "true"})
        if st >= 300 and st != 404:
            return _error_response("InternalError", f"filer: {st}", 500)
        return web.Response(status=204)

    async def batch_delete(self, bucket: str, body: bytes) -> web.Response:
        try:
            root_in = ET.fromstring(body.decode())
        except ET.ParseError:
            return _error_response("MalformedXML", "cannot parse body", 400)
        quiet = (root_in.findtext("Quiet") or "").lower() == "true"
        keys = [o.findtext("Key") or ""
                for o in root_in.iter() if o.tag.endswith("Object")]
        root = ET.Element("DeleteResult", xmlns=S3_XMLNS)
        for k in keys:
            if not k:
                continue
            st, _ = await self._filer("DELETE", self._fp(bucket, k),
                                      params={"recursive": "true"})
            if st in (204, 404, 200):  # S3 delete is idempotent
                if not quiet:
                    d = _el(root, "Deleted")
                    _el(d, "Key", k)
            else:
                e = _el(root, "Error")
                _el(e, "Key", k)
                _el(e, "Code", "InternalError")
                _el(e, "Message", f"filer status {st}")
        return web.Response(body=_xml(root), content_type="application/xml")

    # -- listing -------------------------------------------------------

    async def list_objects(self, bucket: str, q: dict) -> web.Response:
        v2 = q.get("list-type") == "2"
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        max_keys = min(int(q.get("max-keys", "1000") or "1000"), 1000)
        if v2:
            marker = q.get("start-after", "")
            token = q.get("continuation-token", "")
            if token:
                marker = urllib.parse.unquote(token)
        else:
            marker = q.get("marker", "")

        contents, prefixes, truncated, next_marker = \
            await self._collect_keys(bucket, prefix, delimiter, marker,
                                     max_keys)

        root = ET.Element("ListBucketResult", xmlns=S3_XMLNS)
        _el(root, "Name", bucket)
        _el(root, "Prefix", prefix)
        _el(root, "MaxKeys", str(max_keys))
        if delimiter:
            _el(root, "Delimiter", delimiter)
        _el(root, "IsTruncated", "true" if truncated else "false")
        if v2:
            _el(root, "KeyCount", str(len(contents) + len(prefixes)))
            if q.get("continuation-token"):
                _el(root, "ContinuationToken", q["continuation-token"])
            if truncated:
                _el(root, "NextContinuationToken",
                    urllib.parse.quote(next_marker))
        else:
            _el(root, "Marker", marker)
            if truncated:
                _el(root, "NextMarker", next_marker)
        for key, e in contents:
            c = _el(root, "Contents")
            _el(c, "Key", key)
            _el(c, "LastModified", _iso(e.get("Mtime", 0)))
            _el(c, "ETag", f'"{e.get("Md5") or ""}"')
            _el(c, "Size", str(e.get("FileSize", 0)))
            _el(c, "StorageClass", "STANDARD")
        for p in prefixes:
            cp = _el(root, "CommonPrefixes")
            _el(cp, "Prefix", p)
        return web.Response(body=_xml(root), content_type="application/xml")

    async def _collect_keys(self, bucket: str, prefix: str, delimiter: str,
                            marker: str, max_keys: int):
        """Walk the bucket subtree in key order, applying prefix/delimiter/
        marker the way s3api_object_handlers_list.go does over filer
        listings."""
        contents: list[tuple[str, dict]] = []
        prefixes: list[str] = []
        seen_prefixes: set[str] = set()
        state = {"count": 0, "truncated": False, "next_marker": "",
                 "pages": 0, "scan_cursor": ""}
        # per-request filer-page budget: a prefix that matches nothing in
        # a huge bucket must return a truncated page the client can
        # continue from, not scan millions of rows in one request
        PAGE_BUDGET = 64

        async def emit(key: str, entry: dict) -> bool:
            """Returns False when the listing is full."""
            if state["count"] >= max_keys:
                state["truncated"] = True
                return False
            if delimiter:
                rest = key[len(prefix):]
                di = rest.find(delimiter)
                if di >= 0:
                    common = prefix + rest[: di + len(delimiter)]
                    if marker and common <= marker:
                        return True  # served as a CommonPrefix last page
                    if common not in seen_prefixes:
                        seen_prefixes.add(common)
                        prefixes.append(common)
                        state["count"] += 1
                        state["next_marker"] = common
                    return True
            contents.append((key, entry))
            state["count"] += 1
            state["next_marker"] = key
            return True

        async def walk(dir_path: str, key_base: str) -> bool:
            # continuation discipline (the reference's cursor model,
            # s3api_objects_list_handlers.go): seed each directory's
            # listing AT the marker's component instead of re-walking
            # every already-served row from the filer — without this a
            # many-page listing re-lists O(pages * keys) rows
            last = ""
            include_last = False
            if marker and marker.startswith(key_base):
                rest = marker[len(key_base):]
                comp = rest.split("/", 1)[0]
                if comp:
                    last = comp
                    # always re-include the marker component: it may be a
                    # DIRECTORY whose subtree sorts after the marker (e.g.
                    # start-after=mid with mid/k0.txt present) — emit's
                    # own `key <= marker` filter drops the already-served
                    # file case
                    include_last = True
            elif marker and key_base.startswith(marker):
                pass  # whole directory is past the marker: list it all
            while True:
                if state["pages"] >= PAGE_BUDGET:
                    state["truncated"] = True
                    # the continuation should advance to the last SCANNED
                    # key — but never lexically BEHIND the client's
                    # marker, which would re-emit already-served keys
                    # (a stalled-but-duplicate-free page is the lesser
                    # failure in that pathological ordering)
                    cursor = (key_base + last if last
                              else state["scan_cursor"]) \
                        or state["next_marker"]
                    state["next_marker"] = max(cursor, marker or "")
                    return False
                state["pages"] += 1
                listing = await self._filer_list(dir_path, last=last,
                                                 limit=1000,
                                                 include_last=include_last)
                include_last = False
                entries = listing.get("Entries", [])
                if not entries:
                    return True
                for e in entries:
                    name = e["FullPath"].rsplit("/", 1)[-1]
                    last = name
                    if name.startswith("."):
                        continue  # .uploads and friends stay hidden
                    key = key_base + name
                    state["scan_cursor"] = key
                    if e.get("IsDirectory"):
                        sub_key = key + "/"
                        # prune subtrees that cannot match the prefix
                        if prefix and not (sub_key.startswith(prefix)
                                           or prefix.startswith(sub_key)):
                            continue
                        if marker and marker >= sub_key and \
                                not marker.startswith(sub_key):
                            continue
                        if delimiter and sub_key.startswith(prefix):
                            rest_d = sub_key[len(prefix):]
                            di = rest_d.find(delimiter)
                            if di >= 0:
                                common = prefix + rest_d[:di + len(delimiter)]
                                if marker and common <= marker:
                                    # the whole subtree folds into a
                                    # CommonPrefix already served — a
                                    # continuation from NextMarker=
                                    # "photos/" must not re-walk photos/
                                    continue
                        if not await walk(dir_path + "/" + name, sub_key):
                            return False
                    else:
                        if prefix and not key.startswith(prefix):
                            continue
                        if marker and key <= marker:
                            continue
                        if not await emit(key, e):
                            return False
                if not listing.get("ShouldDisplayLoadMore"):
                    return True

        await walk(self._fp(bucket), "")
        return contents, prefixes, state["truncated"], state["next_marker"]

    # -- object level --------------------------------------------------

    async def object_op(self, req, ident, bucket, key, q, body):
        m = req.method
        if m == "GET" and "uploadId" in q:
            self._require(ident, ACTION_READ, bucket, key)
            return await self.list_parts(bucket, key, q["uploadId"])
        if "tagging" in q:
            if m in ("PUT", "DELETE"):
                self._require(ident, ACTION_TAGGING, bucket, key)
                return await self.put_tagging(
                    bucket, key, body if m == "PUT" else None)
            self._require(ident, ACTION_READ, bucket, key)
            return await self.get_tagging(bucket, key)
        if m == "PUT":
            self._require(ident, ACTION_WRITE, bucket, key)
            if "partNumber" in q:
                return await self.put_part(req, bucket, key, q, body)
            if "x-amz-copy-source" in req.headers:
                return await self.copy_object(req, ident, bucket, key)
            return await self.put_object(req, bucket, key, body)
        if m == "POST":
            if "uploads" in q:
                self._require(ident, ACTION_WRITE, bucket, key)
                return await self.initiate_multipart(req, bucket, key)
            if "uploadId" in q:
                self._require(ident, ACTION_WRITE, bucket, key)
                return await self.complete_multipart(bucket, key,
                                                     q["uploadId"], body)
        if m == "DELETE":
            if "uploadId" in q:
                self._require(ident, ACTION_WRITE, bucket, key)
                return await self.abort_multipart(bucket, key, q["uploadId"])
            self._require(ident, ACTION_WRITE, bucket, key)
            st, _ = await self._filer("DELETE", self._fp(bucket, key),
                                      params={"recursive": "true"})
            return web.Response(status=204)
        if m in ("GET", "HEAD"):
            self._require(ident, ACTION_READ, bucket, key)
            return await self.get_object(req, bucket, key)
        return _error_response("MethodNotAllowed", "method not allowed", 405)

    async def put_object(self, req, bucket, key, body,
                         override_headers: dict | None = None) -> web.Response:
        """`override_headers` replaces the request's Content-Type and
        x-amz-meta-* source (used by CopyObject's COPY metadata directive)."""
        src_headers = override_headers if override_headers is not None \
            else req.headers
        headers = {"Content-Type": src_headers.get(
            "Content-Type", "application/octet-stream")}
        md5 = hashlib.md5(body).hexdigest()
        params = {"collection": bucket}
        # x-amz-meta-* / tag attrs -> extended attrs via Seaweed- headers
        for h, v in src_headers.items():
            if h.lower().startswith("x-amz-meta-") or h.startswith(TAG_PREFIX):
                headers[f"Seaweed-{h}"] = v
        st, rbody = await self._filer("PUT", self._fp(bucket, key),
                                      params=params, data=body,
                                      headers=headers)
        if st >= 300:
            return _error_response("InternalError",
                                   f"filer: {st} {rbody[:200]!r}", 500)
        return web.Response(headers={"ETag": f'"{md5}"'})

    async def get_object(self, req, bucket, key) -> web.StreamResponse:
        headers = self._filer_auth(write=False)
        if "Range" in req.headers:
            headers["Range"] = req.headers["Range"]
        url = f"{_tls_scheme()}://{self.filer_url}{urllib.parse.quote(self._fp(bucket, key))}"
        async with self._session.request(req.method, url,
                                         headers=headers) as r:
            if r.status == 404:
                return _error_response("NoSuchKey",
                                       "The specified key does not exist",
                                       404, key)
            if r.status >= 300 and r.status not in (206, 304):
                return _error_response("InternalError", f"filer {r.status}",
                                       500, key)
            out_headers = {}
            for h in ("Content-Range", "Accept-Ranges", "Last-Modified",
                      "ETag", "Content-Type"):
                if h in r.headers:
                    out_headers[h] = r.headers[h]
            for h, v in r.headers.items():
                if h.lower().startswith("seaweed-x-amz-"):
                    out_headers[h[len("Seaweed-"):]] = v
            resp = web.StreamResponse(status=r.status, headers=out_headers)
            if r.headers.get("Content-Length"):
                resp.content_length = int(r.headers["Content-Length"])
            await resp.prepare(req)
            if req.method != "HEAD":
                async for chunk in r.content.iter_chunked(1 << 20):
                    # streamed reads bypass the aiohttp trace hooks:
                    # book the proxied object bytes explicitly
                    netflow.account("recv", netflow.current_class(),
                                    "filer", len(chunk))
                    await resp.write(chunk)
            await resp.write_eof()
            return resp

    async def copy_object(self, req, ident, bucket, key) -> web.Response:
        src = urllib.parse.unquote(req.headers["x-amz-copy-source"])
        src_bucket, _, src_key = src.lstrip("/").partition("/")
        self._require(ident, ACTION_READ, src_bucket)
        st, data = await self._filer("GET", self._fp(src_bucket, src_key))
        if st != 200:
            return _error_response("NoSuchKey", "copy source missing", 404,
                                   src)
        # S3 copies source metadata (content-type, x-amz-meta-*, tags) by
        # default; x-amz-metadata-directive: REPLACE takes the request's
        if req.headers.get("x-amz-metadata-directive", "COPY").upper() \
                == "REPLACE":
            put = await self.put_object(req, bucket, key, data)
        else:
            src_meta = await self._filer_meta(self._fp(src_bucket, src_key)) or {}
            hdrs: dict[str, str] = {}
            attrs = src_meta.get("attr") or {}
            if attrs.get("mime"):
                hdrs["Content-Type"] = attrs["mime"]
            for k, v in (src_meta.get("extended") or {}).items():
                if k.lower().startswith("x-amz-meta-") or \
                        k.startswith(TAG_PREFIX):
                    hdrs[k] = v
            put = await self.put_object(req, bucket, key, data,
                                        override_headers=hdrs)
        if put.status >= 300:
            return put
        root = ET.Element("CopyObjectResult", xmlns=S3_XMLNS)
        _el(root, "LastModified", _iso(time.time()))
        _el(root, "ETag", put.headers.get("ETag", ""))
        return web.Response(body=_xml(root), content_type="application/xml")

    # -- tagging (stored as extended attrs, reference:
    # s3api_object_tagging_handlers.go + filer extended attrs) ----------

    async def get_tagging(self, bucket, key) -> web.Response:
        meta = await self._filer_meta(self._fp(bucket, key))
        if meta is None:
            return _error_response("NoSuchKey", "not found", 404, key)
        root = ET.Element("Tagging", xmlns=S3_XMLNS)
        ts = _el(root, "TagSet")
        for k, v in (meta.get("extended") or meta.get("Extended") or {}).items():
            if k.startswith(TAG_PREFIX):
                t = _el(ts, "Tag")
                _el(t, "Key", k[len(TAG_PREFIX):])
                _el(t, "Value", v)
        return web.Response(body=_xml(root), content_type="application/xml")

    async def put_tagging(self, bucket, key, body) -> web.Response:
        meta = await self._filer_meta(self._fp(bucket, key))
        if meta is None:
            return _error_response("NoSuchKey", "not found", 404, key)
        tags: dict[str, str] = {}
        if body is not None:
            try:
                root_in = ET.fromstring(body.decode())
            except ET.ParseError:
                return _error_response("MalformedXML", "bad tagging", 400)
            for t in root_in.iter():
                if t.tag.endswith("Tag"):
                    tk = t.findtext("Key") or t.findtext(
                        f"{{{S3_XMLNS}}}Key") or ""
                    tv = t.findtext("Value") or t.findtext(
                        f"{{{S3_XMLNS}}}Value") or ""
                    if tk:
                        tags[tk] = tv
        ext = {k: v for k, v in (meta.get("extended") or {}).items()
               if not k.startswith(TAG_PREFIX)}
        ext.update({TAG_PREFIX + k: v for k, v in tags.items()})
        meta["extended"] = ext
        st, _ = await self._filer("POST", "/__admin__/entry",
                                  data=json.dumps({"entry": meta}),
                                  headers={"Content-Type": "application/json"})
        if st >= 300:
            return _error_response("InternalError", f"filer {st}", 500)
        return web.Response(status=200 if body is not None else 204)

    # -- multipart -----------------------------------------------------

    def _upload_dir(self, bucket: str, upload_id: str) -> str:
        return f"{self.buckets_dir}/{bucket}/{UPLOADS_SUBDIR}/{upload_id}"

    async def initiate_multipart(self, req, bucket, key) -> web.Response:
        upload_id = uuid.uuid4().hex
        # remember the object key + content-type in the upload dir entry
        st, _ = await self._filer(
            "POST", self._upload_dir(bucket, upload_id) + "/",
            headers={"Seaweed-s3-key": urllib.parse.quote(key),
                     "Seaweed-s3-mime": req.headers.get("Content-Type", "")})
        if st >= 300:
            return _error_response("InternalError", f"filer {st}", 500)
        root = ET.Element("InitiateMultipartUploadResult", xmlns=S3_XMLNS)
        _el(root, "Bucket", bucket)
        _el(root, "Key", key)
        _el(root, "UploadId", upload_id)
        return web.Response(body=_xml(root), content_type="application/xml")

    async def put_part(self, req, bucket, key, q, body) -> web.Response:
        part_num = int(q["partNumber"])
        upload_id = q.get("uploadId", "")
        meta = await self._filer_meta(self._upload_dir(bucket, upload_id))
        if meta is None:
            return _error_response("NoSuchUpload", "upload not found", 404)
        md5 = hashlib.md5(body).hexdigest()
        path = f"{self._upload_dir(bucket, upload_id)}/{part_num:04d}.part"
        st, _ = await self._filer("PUT", path, data=body,
                                  params={"collection": bucket})
        if st >= 300:
            return _error_response("InternalError", f"filer {st}", 500)
        return web.Response(headers={"ETag": f'"{md5}"'})

    async def list_parts(self, bucket, key, upload_id) -> web.Response:
        listing = await self._filer_list(self._upload_dir(bucket, upload_id),
                                         limit=10000)
        root = ET.Element("ListPartsResult", xmlns=S3_XMLNS)
        _el(root, "Bucket", bucket)
        _el(root, "Key", key)
        _el(root, "UploadId", upload_id)
        _el(root, "IsTruncated", "false")
        for e in listing.get("Entries", []):
            name = e["FullPath"].rsplit("/", 1)[-1]
            if not name.endswith(".part"):
                continue
            p = _el(root, "Part")
            _el(p, "PartNumber", str(int(name[:-5])))
            _el(p, "LastModified", _iso(e.get("Mtime", 0)))
            _el(p, "ETag", f'"{e.get("Md5") or ""}"')
            _el(p, "Size", str(e.get("FileSize", 0)))
        return web.Response(body=_xml(root), content_type="application/xml")

    async def list_multipart_uploads(self, bucket) -> web.Response:
        listing = await self._filer_list(
            f"{self.buckets_dir}/{bucket}/{UPLOADS_SUBDIR}", limit=10000)
        root = ET.Element("ListMultipartUploadsResult", xmlns=S3_XMLNS)
        _el(root, "Bucket", bucket)
        _el(root, "IsTruncated", "false")
        for e in listing.get("Entries", []):
            if not e.get("IsDirectory"):
                continue
            upload_id = e["FullPath"].rsplit("/", 1)[-1]
            u = _el(root, "Upload")
            ext = e.get("Extended") or {}
            _el(u, "Key", urllib.parse.unquote(ext.get("s3-key", "")))
            _el(u, "UploadId", upload_id)
            _el(u, "Initiated", _iso(e.get("Crtime", 0)))
        return web.Response(body=_xml(root), content_type="application/xml")

    async def complete_multipart(self, bucket, key, upload_id,
                                 body) -> web.Response:
        """Splice part chunk lists into the final entry — no data copy
        (reference: filer_multipart.go completeMultipartUpload)."""
        updir = self._upload_dir(bucket, upload_id)
        upload_meta = await self._filer_meta(updir)
        if upload_meta is None:
            return _error_response("NoSuchUpload", "upload not found", 404)

        wanted: list[int] | None = None
        if body:
            try:
                root_in = ET.fromstring(body.decode())
                wanted = sorted(
                    int(p.findtext("PartNumber")
                        or p.findtext(f"{{{S3_XMLNS}}}PartNumber"))
                    for p in root_in.iter()
                    if p.tag.endswith("Part") and p.tag != "CompleteMultipartUpload")
            except (ET.ParseError, TypeError, ValueError):
                return _error_response("MalformedXML", "bad complete body", 400)

        listing = await self._filer_list(updir, limit=10000)
        parts: dict[int, dict] = {}
        for e in listing.get("Entries", []):
            name = e["FullPath"].rsplit("/", 1)[-1]
            if name.endswith(".part"):
                meta = await self._filer_meta(e["FullPath"])
                if meta is not None:
                    parts[int(name[:-5])] = meta
        order = wanted if wanted is not None else sorted(parts)
        if not order or any(p not in parts for p in order):
            return _error_response("InvalidPart", "missing part", 400)

        chunks: list[dict] = []
        offset = 0
        etags = []
        for pn in order:
            pmeta = parts[pn]
            psize = 0
            for c in pmeta.get("chunks", []):
                c = dict(c)
                c["offset"] = offset + c["offset"]
                chunks.append(c)
                psize = max(psize, c["offset"] - offset + c["size"])
            psize = max(psize, pmeta.get("attr", {}).get("file_size", 0))
            offset += psize
            etags.append(pmeta.get("attr", {}).get("md5", ""))

        final_etag = hashlib.md5(
            b"".join(bytes.fromhex(e) for e in etags if e)).hexdigest() + \
            f"-{len(order)}"
        ext = upload_meta.get("extended") or {}
        mime = ext.get("s3-mime", "") or "application/octet-stream"
        entry = {
            "full_path": self._fp(bucket, key),
            "attr": {"mtime": time.time(), "crtime": time.time(),
                     "mode": 0o660, "mime": mime, "file_size": offset,
                     "md5": final_etag.partition("-")[0]},
            "chunks": chunks,
            "extended": {"s3-etag": final_etag},
        }
        st, rbody = await self._filer(
            "POST", "/__admin__/entry", data=json.dumps({"entry": entry}),
            headers={"Content-Type": "application/json"})
        if st >= 300:
            return _error_response("InternalError",
                                   f"filer {st} {rbody[:200]!r}", 500)
        # drop part entries but keep their (now shared) chunks
        await self._filer("DELETE", updir,
                          params={"recursive": "true",
                                  "skipChunkDeletion": "true"})
        root = ET.Element("CompleteMultipartUploadResult", xmlns=S3_XMLNS)
        _el(root, "Location", f"{_tls_scheme()}://{self.url}/{bucket}/{key}")
        _el(root, "Bucket", bucket)
        _el(root, "Key", key)
        _el(root, "ETag", f'"{final_etag}"')
        return web.Response(body=_xml(root), content_type="application/xml")

    async def abort_multipart(self, bucket, key, upload_id) -> web.Response:
        await self._filer("DELETE", self._upload_dir(bucket, upload_id),
                          params={"recursive": "true"})
        return web.Response(status=204)


def _valid_bucket_name(name: str) -> bool:
    if not 3 <= len(name) <= 63:
        return False
    if not all(c.islower() or c.isdigit() or c in ".-" for c in name):
        return False
    return name[0] not in ".-" and name[-1] not in ".-"


