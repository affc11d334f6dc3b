"""S3 identity + AWS signature verification (V4, presigned V4, V2 subset).

Reference: weed/s3api/auth_credentials.go (identities + action model),
auth_signature_v4.go (SigV4 canonical request / string-to-sign / signing
key), auth_presigned_url.go, auth_signature_v2.go. Identities come from an
s3.json-style config (`{"identities": [{"name", "credentials":
[{"accessKey","secretKey"}], "actions": ["Admin","Read","Write", ...]}]}`)
or the IAM API; when no identities are configured every request is allowed
(the reference behaves the same without -s3.config).

Counterpart of `seaweedfs_tpu/s3/auth.py`, whole: the same canonical
requests, string-to-sign and signatures, so a request signed by either
package's `sign_v4` or `sign_v4_chunked` verifies in either gateway.
"""

from __future__ import annotations

import base64
import calendar
import hashlib
import hmac
import json
import time
import urllib.parse
from dataclasses import dataclass, field

# Max clock skew accepted on signed requests, like the reference's 15-minute
# window (auth_signature_v4.go).
MAX_SKEW_SECONDS = 15 * 60

# Sub-resources included in the V2 canonicalized resource string
# (auth_signature_v2.go resourceList).
_V2_SUBRESOURCES = frozenset((
    "acl", "delete", "lifecycle", "location", "logging", "notification",
    "partNumber", "policy", "requestPayment", "response-cache-control",
    "response-content-disposition", "response-content-encoding",
    "response-content-language", "response-content-type", "response-expires",
    "tagging", "torrent", "uploadId", "uploads", "versionId", "versioning",
    "versions", "website"))

ACTION_ADMIN = "Admin"
ACTION_READ = "Read"
ACTION_WRITE = "Write"
ACTION_LIST = "List"
ACTION_TAGGING = "Tagging"


class AuthError(Exception):
    def __init__(self, code: str, message: str, status: int = 403):
        super().__init__(message)
        self.code, self.status = code, status


@dataclass
class Credential:
    access_key: str
    secret_key: str


@dataclass
class Identity:
    name: str
    credentials: list[Credential] = field(default_factory=list)
    actions: list[str] = field(default_factory=list)

    def can_do(self, action: str, bucket: str = "") -> bool:
        """Actions may be bare ("Read") or bucket-scoped ("Read:images")
        like the reference (auth_credentials.go canDo)."""
        if ACTION_ADMIN in self.actions:
            return True
        for a in self.actions:
            act, _, scope = a.partition(":")
            if act != action:
                continue
            if not scope or scope == bucket or \
                    scope.endswith("*") and bucket.startswith(scope[:-1]):
                return True
        return False


class IdentityAccessManagement:
    def __init__(self, identities: list[Identity] | None = None):
        self.identities = identities or []
        # once auth has ever been configured, an empty identity list means
        # "deny everyone", not "back to open access"
        self._ever_configured = bool(self.identities)

    @property
    def enabled(self) -> bool:
        return bool(self.identities) or self._ever_configured

    @classmethod
    def from_config(cls, data: dict) -> "IdentityAccessManagement":
        idents = []
        for i in data.get("identities", []):
            idents.append(Identity(
                name=i.get("name", ""),
                credentials=[Credential(c["accessKey"], c["secretKey"])
                             for c in i.get("credentials", [])],
                actions=list(i.get("actions", []))))
        return cls(idents)

    @classmethod
    def from_file(cls, path: str) -> "IdentityAccessManagement":
        with open(path) as f:
            return cls.from_config(json.load(f))

    def replace_identities(self, identities: list[Identity]) -> None:
        self.identities = identities
        if identities:
            self._ever_configured = True

    def mark_configured(self) -> None:
        """Force auth on even with zero identities (an identity store exists
        but is empty -> deny-all, not open access)."""
        self._ever_configured = True

    def lookup(self, access_key: str) -> tuple[Identity, Credential]:
        for ident in self.identities:
            for cred in ident.credentials:
                if cred.access_key == access_key:
                    return ident, cred
        raise AuthError("InvalidAccessKeyId",
                        "The AWS access key Id you provided does not exist")

    # -- request authentication ---------------------------------------

    def authenticate(self, method: str, raw_path: str, query: dict[str, str],
                     headers, payload_hash: str | None = None) -> Identity:
        """Returns the matched identity; raises AuthError. `query` must hold
        raw (url-decoded) single values."""
        if not self.enabled:
            return Identity(name="anonymous", actions=[ACTION_ADMIN])
        auth = headers.get("Authorization", "")
        if auth.startswith("AWS4-HMAC-SHA256"):
            return self._auth_v4_header(method, raw_path, query, headers,
                                        payload_hash)
        if "X-Amz-Signature" in query or "X-Amz-Algorithm" in query:
            return self._auth_v4_presigned(method, raw_path, query, headers)
        if auth.startswith("AWS "):
            return self._auth_v2_header(auth, method, raw_path, query, headers)
        raise AuthError("AccessDenied", "no signature provided")

    @staticmethod
    def verify_payload_hash(headers, body: bytes) -> None:
        """Compare the signed x-amz-content-sha256 against the actual body.
        Called by the gateway after it has read the body (kept separate from
        authenticate() so auth happens before buffering the payload).
        STREAMING-* bodies are NOT skipped silently: their integrity is
        enforced per chunk by decode_aws_chunked + chunked_context."""
        sha_hdr = headers.get("x-amz-content-sha256", "")
        if not sha_hdr or sha_hdr == "UNSIGNED-PAYLOAD" or \
                sha_hdr.startswith("STREAMING-"):
            return
        if hashlib.sha256(body).hexdigest() != sha_hdr.lower():
            raise AuthError("XAmzContentSHA256Mismatch",
                            "The provided 'x-amz-content-sha256' header does "
                            "not match what was computed.", 400)

    def chunked_context(self, headers) -> "StreamingContext | None":
        """Per-chunk signature context for a STREAMING-AWS4-HMAC-SHA256
        upload (reference: chunked_reader_v4.go:38-60).  The seed signature
        is the (already verified) Authorization header signature; each chunk
        then chains off it.  Returns None for unsigned streaming variants
        (STREAMING-UNSIGNED-PAYLOAD-TRAILER — integrity there is the
        trailing checksum, not a signature chain)."""
        sha_hdr = headers.get("x-amz-content-sha256", "")
        if not sha_hdr.startswith("STREAMING-AWS4-HMAC-SHA256"):
            return None
        auth = headers.get("Authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256"):
            raise AuthError("AccessDenied",
                            "streaming upload requires V4 header auth")
        try:
            parts = dict(
                p.strip().split("=", 1)
                for p in auth[len("AWS4-HMAC-SHA256"):].strip().split(","))
            cred_scope = parts["Credential"].split("/")
            access_key, datestamp, region, service = (
                cred_scope[0], cred_scope[1], cred_scope[2], cred_scope[3])
            seed_sig = parts["Signature"]
        except (KeyError, IndexError, ValueError):
            raise AuthError("AuthorizationHeaderMalformed",
                            "cannot parse Authorization header", 400)
        _, cred = self.lookup(access_key)
        amz_date = headers.get("x-amz-date", headers.get("X-Amz-Date", ""))
        return StreamingContext(
            sig_key=self._sig_key(cred.secret_key, datestamp, region,
                                  service),
            seed_sig=seed_sig,
            amz_date=amz_date,
            scope=f"{datestamp}/{region}/{service}/aws4_request")

    @staticmethod
    def _check_skew(amz_date: str) -> None:
        try:
            t0 = calendar.timegm(time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
        except ValueError:
            raise AuthError("AuthorizationHeaderMalformed",
                            "invalid x-amz-date", 400)
        if abs(time.time() - t0) > MAX_SKEW_SECONDS:
            raise AuthError("RequestTimeTooSkewed",
                            "The difference between the request time and the "
                            "server's time is too large.")

    # -- V4 ------------------------------------------------------------

    @staticmethod
    def _sig_key(secret: str, date: str, region: str, service: str) -> bytes:
        k = hmac.new(("AWS4" + secret).encode(), date.encode(),
                     hashlib.sha256).digest()
        for part in (region, service, "aws4_request"):
            k = hmac.new(k, part.encode(), hashlib.sha256).digest()
        return k

    @staticmethod
    def _canonical_query(query: dict[str, str],
                         drop: tuple[str, ...] = ()) -> str:
        pairs = []
        for k in sorted(query):
            if k in drop:
                continue
            pairs.append(f"{urllib.parse.quote(k, safe='-_.~')}="
                         f"{urllib.parse.quote(query[k], safe='-_.~')}")
        return "&".join(pairs)

    @staticmethod
    def _canonical_uri(raw_path: str) -> str:
        # S3-style: each path segment uri-encoded once, '/' preserved
        return urllib.parse.quote(urllib.parse.unquote(raw_path),
                                  safe="/-_.~")

    def _canonical_request(self, method: str, raw_path: str, cq: str,
                           signed_headers: list[str], headers,
                           payload_hash: str) -> str:
        canon_headers = "".join(
            f"{h}:{' '.join(headers.get(h, '').split())}\n"
            for h in signed_headers)
        return "\n".join([method, self._canonical_uri(raw_path), cq,
                          canon_headers, ";".join(signed_headers),
                          payload_hash])

    def _auth_v4_header(self, method, raw_path, query, headers,
                        payload_hash) -> Identity:
        auth = headers["Authorization"]
        try:
            parts = dict(
                p.strip().split("=", 1)
                for p in auth[len("AWS4-HMAC-SHA256"):].strip().split(","))
            cred_scope = parts["Credential"].split("/")
            access_key, datestamp, region, service = (
                cred_scope[0], cred_scope[1], cred_scope[2], cred_scope[3])
            signed_headers = parts["SignedHeaders"].lower().split(";")
            got_sig = parts["Signature"]
        except (KeyError, IndexError, ValueError):
            raise AuthError("AuthorizationHeaderMalformed",
                            "cannot parse Authorization header", 400)
        ident, cred = self.lookup(access_key)
        amz_date = headers.get("x-amz-date", headers.get("X-Amz-Date", ""))
        self._check_skew(amz_date)
        if payload_hash is None:
            payload_hash = headers.get("x-amz-content-sha256",
                                       "UNSIGNED-PAYLOAD")
        creq = self._canonical_request(
            method, raw_path, self._canonical_query(query),
            signed_headers, headers, payload_hash)
        sts = "\n".join([
            "AWS4-HMAC-SHA256", amz_date,
            f"{datestamp}/{region}/{service}/aws4_request",
            hashlib.sha256(creq.encode()).hexdigest()])
        key = self._sig_key(cred.secret_key, datestamp, region, service)
        want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, got_sig):
            raise AuthError("SignatureDoesNotMatch",
                            "The request signature we calculated does not "
                            "match the signature you provided")
        return ident

    def _auth_v4_presigned(self, method, raw_path, query, headers) -> Identity:
        try:
            cred_scope = query["X-Amz-Credential"].split("/")
            access_key, datestamp, region, service = (
                cred_scope[0], cred_scope[1], cred_scope[2], cred_scope[3])
            signed_headers = query["X-Amz-SignedHeaders"].lower().split(";")
            got_sig = query["X-Amz-Signature"]
            amz_date = query["X-Amz-Date"]
        except (KeyError, IndexError):
            raise AuthError("AuthorizationQueryParametersError",
                            "incomplete presigned query", 400)
        try:
            expires = int(query.get("X-Amz-Expires", "604800"))
            t0 = calendar.timegm(time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
        except ValueError:
            raise AuthError("AuthorizationQueryParametersError",
                            "malformed X-Amz-Expires or X-Amz-Date", 400)
        if time.time() > t0 + expires:
            raise AuthError("AccessDenied", "Request has expired")
        ident, cred = self.lookup(access_key)
        creq = self._canonical_request(
            method, raw_path,
            self._canonical_query(query, drop=("X-Amz-Signature",)),
            signed_headers, headers, "UNSIGNED-PAYLOAD")
        sts = "\n".join([
            "AWS4-HMAC-SHA256", amz_date,
            f"{datestamp}/{region}/{service}/aws4_request",
            hashlib.sha256(creq.encode()).hexdigest()])
        key = self._sig_key(cred.secret_key, datestamp, region, service)
        want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, got_sig):
            raise AuthError("SignatureDoesNotMatch",
                            "presigned signature mismatch")
        return ident

    # -- V2 (HMAC-SHA1 over the canonicalized resource,
    # auth_signature_v2.go) --------------------------------------------

    def _auth_v2_header(self, auth: str, method: str, raw_path: str,
                        query: dict[str, str], headers) -> Identity:
        try:
            access_key, got_sig = auth[4:].split(":", 1)
        except ValueError:
            raise AuthError("AuthorizationHeaderMalformed", "bad V2 header", 400)
        ident, cred = self.lookup(access_key)
        # CanonicalizedAmzHeaders: sorted lowercase x-amz-* headers
        amz = sorted((k.lower(), " ".join(v.split()))
                     for k, v in headers.items()
                     if k.lower().startswith("x-amz-"))
        canon_amz = "".join(f"{k}:{v}\n" for k, v in amz)
        # CanonicalizedResource: the ENCODED Request-URI path as the client
        # sent it + signed sub-resources (V2 clients sign the escaped path,
        # reference: auth_signature_v2.go)
        subs = sorted(k for k in query if k in _V2_SUBRESOURCES)
        resource = raw_path
        if subs:
            resource += "?" + "&".join(
                f"{k}={query[k]}" if query[k] else k for k in subs)
        # freshness: V2 requests carry an RFC1123 date in x-amz-date or Date;
        # enforce the same 15-minute window as V4 so captured requests can't
        # replay forever
        import email.utils
        date_hdr = headers.get("x-amz-date") or headers.get("Date", "")
        try:
            when = email.utils.parsedate_to_datetime(date_hdr)
        except (TypeError, ValueError):
            when = None
        if when is None:
            raise AuthError("AccessDenied", "missing or malformed Date", 403)
        if abs(time.time() - when.timestamp()) > MAX_SKEW_SECONDS:
            raise AuthError("RequestTimeTooSkewed",
                            "The difference between the request time and the "
                            "server's time is too large.")
        # Date line is empty when x-amz-date is signed among the amz headers
        date_line = "" if any(k.lower() == "x-amz-date" for k in headers) \
            else headers.get("Date", "")
        sts = "\n".join([
            method,
            headers.get("Content-MD5", ""),
            headers.get("Content-Type", ""),
            date_line,
        ]) + "\n" + canon_amz + resource
        want = base64.b64encode(
            hmac.new(cred.secret_key.encode(), sts.encode(),
                     hashlib.sha1).digest()).decode()
        if not hmac.compare_digest(want, got_sig):
            raise AuthError("SignatureDoesNotMatch",
                            "The request signature we calculated does not "
                            "match the signature you provided")
        return ident


@dataclass
class StreamingContext:
    """Everything decode_aws_chunked needs to verify a signed chunk chain."""
    sig_key: bytes
    seed_sig: str
    amz_date: str
    scope: str


_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _chunk_signature(ctx: StreamingContext, prev_sig: str,
                     data: bytes) -> str:
    sts = "\n".join([
        "AWS4-HMAC-SHA256-PAYLOAD", ctx.amz_date, ctx.scope, prev_sig,
        _EMPTY_SHA256, hashlib.sha256(data).hexdigest()])
    return hmac.new(ctx.sig_key, sts.encode(), hashlib.sha256).hexdigest()


def decode_aws_chunked(body: bytes, ctx: StreamingContext | None,
                       decoded_length: int | None = None) -> bytes:
    """Decode an aws-chunked streaming payload
    (`hex-size;chunk-signature=...\\r\\n<data>\\r\\n ... 0;...\\r\\n`),
    cryptographically verifying every chunk-signature against the chain
    seeded by the header signature when `ctx` is given (reference:
    chunked_reader_v4.go:170-214 — a forged or reordered chunk is a 403,
    and truncated/malformed framing is a 400, never a silently shortened
    object).  With ctx=None (unsigned streaming / auth disabled) the
    framing is stripped and only well-formedness + decoded length are
    enforced.  Trailing `x-amz-trailer-signature` is verified when the
    stream is signed; other trailers (checksums) are accepted."""
    out = bytearray()
    prev_sig = ctx.seed_sig if ctx else ""
    i = 0
    final_seen = False
    while i < len(body):
        nl = body.find(b"\r\n", i)
        if nl < 0:
            raise AuthError("IncompleteBody", "truncated chunk header", 400)
        header = body[i:nl]
        fields = header.split(b";")
        try:
            size = int(fields[0], 16)
        except ValueError:
            raise AuthError("IncompleteBody", "malformed chunk size", 400)
        chunk_sig = None
        for f in fields[1:]:
            name, _, val = f.partition(b"=")
            if name.strip() == b"chunk-signature":
                chunk_sig = val.strip().decode("ascii", "replace")
        start = nl + 2
        data = body[start:start + size]
        if len(data) != size:
            raise AuthError("IncompleteBody", "truncated chunk data", 400)
        if ctx is not None:
            if chunk_sig is None:
                raise AuthError("AccessDenied",
                                "missing chunk-signature in signed stream")
            want = _chunk_signature(ctx, prev_sig, data)
            if not hmac.compare_digest(want, chunk_sig):
                raise AuthError("SignatureDoesNotMatch",
                                "chunk signature mismatch")
            prev_sig = want
        out += data
        i = start + size
        if body[i:i + 2] == b"\r\n":
            i += 2
        if size == 0:
            final_seen = True
            break
    if not final_seen:
        raise AuthError("IncompleteBody", "missing final chunk", 400)
    # trailing headers (checksum trailers and/or x-amz-trailer-signature).
    # The trailer signature chains off the final chunk signature and covers
    # sha256 of the canonicalized trailer lines ("name:value\n" each).
    trailer_canon = bytearray()
    while i < len(body):
        nl = body.find(b"\r\n", i)
        line = body[i:nl] if nl >= 0 else body[i:]
        i = nl + 2 if nl >= 0 else len(body)
        if not line:
            continue
        name, _, val = line.partition(b":")
        if name.strip() == b"x-amz-trailer-signature":
            if ctx is not None:
                sts = "\n".join([
                    "AWS4-HMAC-SHA256-TRAILER", ctx.amz_date, ctx.scope,
                    prev_sig,
                    hashlib.sha256(bytes(trailer_canon)).hexdigest()])
                want = hmac.new(ctx.sig_key, sts.encode(),
                                hashlib.sha256).hexdigest()
                got = val.strip().decode("ascii", "replace")
                if not hmac.compare_digest(want, got):
                    raise AuthError("SignatureDoesNotMatch",
                                    "trailer signature mismatch")
        else:
            trailer_canon += name.strip().lower() + b":" + val.strip() + b"\n"
    if decoded_length is not None and len(out) != decoded_length:
        raise AuthError(
            "IncompleteBody",
            "You did not provide the number of bytes specified by the "
            "x-amz-decoded-content-length header", 400)
    return bytes(out)


def sign_v4(cred: Credential, method: str, host: str, path: str,
            query: dict[str, str], region: str = "us-east-1",
            payload: bytes = b"", amz_date: str | None = None,
            payload_hash: str | None = None,
            extra_headers: dict | None = None) -> dict:
    """Client-side V4 signer (for tests and the replication sink client).
    Returns headers to attach.  `payload_hash` overrides the computed sha256
    (for STREAMING-* uploads); `extra_headers` are signed along."""
    if amz_date is None:
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    datestamp = amz_date[:8]
    if payload_hash is None:
        payload_hash = hashlib.sha256(payload).hexdigest()
    headers = {"Host": host, "x-amz-date": amz_date,
               "x-amz-content-sha256": payload_hash}
    if extra_headers:
        headers.update(extra_headers)
    signed = sorted(h.lower() for h in headers)
    iam = IdentityAccessManagement
    creq = "\n".join([
        method, iam._canonical_uri(path), iam._canonical_query(query),
        "".join(f"{h}:{' '.join(str(headers[next(k for k in headers if k.lower() == h)]).split())}\n"
                for h in signed),
        ";".join(signed), payload_hash])
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date,
                     f"{datestamp}/{region}/s3/aws4_request",
                     hashlib.sha256(creq.encode()).hexdigest()])
    key = iam._sig_key(cred.secret_key, datestamp, region, "s3")
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={cred.access_key}/{datestamp}/{region}"
        f"/s3/aws4_request, SignedHeaders={';'.join(signed)}, Signature={sig}")
    return headers


def sign_v4_chunked(cred: Credential, method: str, host: str, path: str,
                    query: dict[str, str], payload: bytes,
                    region: str = "us-east-1",
                    chunk_size: int = 64 * 1024,
                    amz_date: str | None = None) -> tuple[dict, bytes]:
    """Client-side STREAMING-AWS4-HMAC-SHA256-PAYLOAD signer: returns
    (headers, aws-chunked body with a verified chunk-signature chain) — the
    wire format aws-cli/SDKs produce for streaming PUTs."""
    if amz_date is None:
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    datestamp = amz_date[:8]
    headers = sign_v4(
        cred, method, host, path, query, region=region, amz_date=amz_date,
        payload_hash="STREAMING-AWS4-HMAC-SHA256-PAYLOAD",
        extra_headers={"Content-Encoding": "aws-chunked",
                       "x-amz-decoded-content-length": str(len(payload))})
    seed_sig = headers["Authorization"].rsplit("Signature=", 1)[1]
    ctx = StreamingContext(
        sig_key=IdentityAccessManagement._sig_key(
            cred.secret_key, datestamp, region, "s3"),
        seed_sig=seed_sig, amz_date=amz_date,
        scope=f"{datestamp}/{region}/s3/aws4_request")
    body = bytearray()
    prev = seed_sig
    chunks = [payload[i:i + chunk_size]
              for i in range(0, len(payload), chunk_size)] + [b""]
    for data in chunks:
        sig = _chunk_signature(ctx, prev, data)
        body += f"{len(data):x};chunk-signature={sig}\r\n".encode()
        body += data + b"\r\n"
        prev = sig
    return headers, bytes(body)
