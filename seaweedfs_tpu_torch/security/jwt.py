"""JWT signing for volume writes and filer access.

Counterpart of `seaweedfs_tpu/security/jwt.py`, whole.

Reference: weed/security/jwt.go — `GenJwtForVolumeServer` (jwt.go:30) signs a
short-lived HS256 token over the file id; the volume server checks it on
writes (volume_server_handlers_write.go:33) and the filer issues/forwards
tokens per chunk. Implemented on the stdlib (hmac/hashlib/base64) — no
external jwt dependency.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import hmac
import json
import time


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    pad = -len(s) % 4
    return base64.urlsafe_b64decode(s + "=" * pad)


class SigningKey:
    """One HS256 key with a token lifetime (0 lifetime = tokens never expire,
    matching the reference's expires_after_seconds=0 behavior)."""

    def __init__(self, key: str | bytes = "", expires_after_seconds: int = 10):
        if isinstance(key, str):
            key = key.encode()
        self.key = key
        self.expires_after_seconds = expires_after_seconds

    def __bool__(self) -> bool:
        return bool(self.key)


def gen_jwt(key: SigningKey, fid: str) -> str:
    """Sign a token authorizing one operation on `fid` (empty fid = filer
    token covering any path)."""
    if not key:
        return ""
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"},
                             separators=(",", ":")).encode())
    claims: dict = {"fid": fid}
    if key.expires_after_seconds != 0:
        claims["exp"] = int(time.time()) + key.expires_after_seconds
    payload = _b64(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = _b64(hmac.new(key.key, signing_input, hashlib.sha256).digest())
    return f"{header}.{payload}.{sig}"


class JwtError(Exception):
    pass


def decode_jwt(key: SigningKey, token: str, expected_fid: str | None = None) -> dict:
    """Verify signature + expiry (+ fid claim when expected); returns claims."""
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        sig = _unb64(sig_b64)
    except (ValueError, binascii.Error):
        raise JwtError("malformed token")
    signing_input = f"{header_b64}.{payload_b64}".encode()
    want = hmac.new(key.key, signing_input, hashlib.sha256).digest()
    if not hmac.compare_digest(want, sig):
        raise JwtError("bad signature")
    try:
        header = json.loads(_unb64(header_b64))
        claims = json.loads(_unb64(payload_b64))
    except (ValueError, UnicodeDecodeError):
        raise JwtError("malformed claims")
    if header.get("alg") != "HS256":
        raise JwtError(f"unsupported alg {header.get('alg')!r}")
    exp = claims.get("exp")
    if exp is not None and time.time() > exp:
        raise JwtError("token expired")
    if expected_fid is not None and claims.get("fid") not in ("", expected_fid):
        raise JwtError("token fid mismatch")
    return claims


def token_from_request(headers, query) -> str:
    """Authorization: Bearer <t> header, else ?jwt= query param (the
    reference accepts both: security/guard.go GetJwt)."""
    auth = headers.get("Authorization", "")
    if auth[:7].lower() == "bearer ":
        return auth[7:]
    return query.get("jwt", "")
