"""Cluster TLS/mTLS for the control and data plane.

Counterpart of `seaweedfs_tpu/security/tls.py` (reference:
weed/security/tls.go:26-60).  One process-wide TLS state is configured
from the [tls] table of security.toml (per-role cert overrides such as
[tls.volume]); servers take their context from `server_ssl(role)`, the
pooled client (utils/http.py) dials https with `client_ssl()`, and
`configure()` installs a urllib opener carrying the client context, so
every urllib call is covered too.  `scheme()` is "https" while TLS is on.
`verify_client = true` turns on mutual auth: the server requires a peer
certificate signed by the same CA.

`generate_certs()` writes a CA and a node certificate (SAN: localhost
and the given hosts; it serves as both server and client identity).  It
imports `cryptography` inside the function, so importing this module
needs nothing beyond the standard library.

[tls]
ca = "ca.crt"
cert = "server.crt"
key = "server.key"
verify_client = true     # optional mTLS
"""

from __future__ import annotations

import os
import ssl
import urllib.request


class _TlsState:
    def __init__(self) -> None:
        self.enabled = False
        self.ca: str | None = None
        self.cert: str | None = None
        self.key: str | None = None
        self.verify_client = False
        self.role_overrides: dict[str, dict] = {}
        self._server_ctx: dict[str, ssl.SSLContext] = {}
        self._client_ctx: ssl.SSLContext | None = None


_state = _TlsState()


_installed_opener = False


def configure(data: dict | None) -> None:
    """Install process-wide TLS from a security.toml [tls] table (or clear
    it when absent/empty). Safe to call multiple times; last call wins.

    Raises ValueError for a cert/key table with verify_client but no ca —
    mTLS without a CA to verify against would silently accept anyone."""
    global _state, _installed_opener
    st = _TlsState()
    data = data or {}
    st.cert = data.get("cert") or None
    st.key = data.get("key") or None
    st.ca = data.get("ca") or None
    st.verify_client = bool(data.get("verify_client", False))
    st.role_overrides = {k: v for k, v in data.items() if isinstance(v, dict)}
    st.enabled = bool(st.cert and st.key)
    if st.enabled and st.verify_client and not st.ca:
        raise ValueError(
            "[tls] verify_client = true requires `ca` — without it the "
            "server cannot verify any client certificate")
    _state = st
    if st.enabled:
        ctx = client_ssl()
        opener = urllib.request.build_opener(
            urllib.request.HTTPSHandler(context=ctx))
        urllib.request.install_opener(opener)
        _installed_opener = True
    elif _installed_opener:
        # only undo an opener WE installed — never clobber an embedding
        # application's own opener on a plain-config load
        urllib.request.install_opener(urllib.request.build_opener())
        _installed_opener = False


def enabled() -> bool:
    return _state.enabled


def scheme() -> str:
    """URL scheme for intra-cluster calls."""
    return "https" if _state.enabled else "http"


def _role_paths(role: str | None) -> tuple[str | None, str | None]:
    ov = _state.role_overrides.get(role or "", {})
    return ov.get("cert", _state.cert), ov.get("key", _state.key)


def server_ssl(role: str | None = None) -> ssl.SSLContext | None:
    """Server-side context for aiohttp TCPSite; None when TLS is off."""
    if not _state.enabled:
        return None
    key = role or ""
    ctx = _state._server_ctx.get(key)
    if ctx is None:
        cert, pkey = _role_paths(role)
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, pkey)
        if _state.ca:
            ctx.load_verify_locations(_state.ca)
            if _state.verify_client:
                ctx.verify_mode = ssl.CERT_REQUIRED
        _state._server_ctx[key] = ctx
    return ctx


def client_ssl() -> ssl.SSLContext | None:
    """Client-side context (verifies the cluster CA, presents the client
    cert for mTLS); None when TLS is off."""
    if not _state.enabled:
        return None
    if _state._client_ctx is None:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        # hostname verification stays ON: node certs must carry their
        # host/IP in SAN (the `certs` subcommand's -hosts flag does this),
        # and since this context also serves process-global urllib traffic
        # (see configure()), system-CA endpoints keep full verification
        ctx.check_hostname = True
        ctx.load_default_certs()
        if _state.ca:
            ctx.load_verify_locations(_state.ca)
        if _state.cert and _state.key:
            ctx.load_cert_chain(_state.cert, _state.key)
        _state._client_ctx = ctx
    return _state._client_ctx


def generate_certs(out_dir: str, hosts: list[str] | None = None) -> dict:
    """Create ca + server cert/key PEMs under out_dir (the server cert
    doubles as the client identity for mTLS — every cluster node is both).
    Returns the [tls] table dict ready to feed `configure()` or write to
    security.toml."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    hosts = hosts or ["localhost", "127.0.0.1"]
    os.makedirs(out_dir, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)

    def _key():
        return ec.generate_private_key(ec.SECP256R1())

    def _write(name: str, key, cert) -> tuple[str, str]:
        kp = os.path.join(out_dir, f"{name}.key")
        cp = os.path.join(out_dir, f"{name}.crt")
        with open(kp, "wb") as f:
            f.write(key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption()))
        with open(cp, "wb") as f:
            f.write(cert.public_bytes(serialization.Encoding.PEM))
        return cp, kp

    ca_key = _key()
    ca_name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "seaweedfs-tpu-ca")])
    ca_cert = (x509.CertificateBuilder()
               .subject_name(ca_name).issuer_name(ca_name)
               .public_key(ca_key.public_key())
               .serial_number(x509.random_serial_number())
               .not_valid_before(now)
               .not_valid_after(now + datetime.timedelta(days=3650))
               .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                              critical=True)
               .sign(ca_key, hashes.SHA256()))
    ca_crt, _ = _write("ca", ca_key, ca_cert)

    import ipaddress

    def _alt(h: str):
        try:
            return x509.IPAddress(ipaddress.ip_address(h))
        except ValueError:
            return x509.DNSName(h)

    san = x509.SubjectAlternativeName([_alt(h) for h in hosts])

    def _leaf(cn: str):
        key = _key()
        cert = (x509.CertificateBuilder()
                .subject_name(x509.Name(
                    [x509.NameAttribute(NameOID.COMMON_NAME, cn)]))
                .issuer_name(ca_name)
                .public_key(key.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now)
                .not_valid_after(now + datetime.timedelta(days=3650))
                .add_extension(san, critical=False)
                .sign(ca_key, hashes.SHA256()))
        return key, cert

    leaf_key, leaf_cert = _leaf("seaweedfs-tpu-node")
    srv_crt, srv_key = _write("server", leaf_key, leaf_cert)
    return {
        "ca": ca_crt,
        "cert": srv_crt,
        "key": srv_key,
        "verify_client": True,
    }
