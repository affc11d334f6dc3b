"""Access guard: IP whitelist + per-role signing keys from security config.

Counterpart of `seaweedfs_tpu/security/guard.py`, whole; its `[tls]`
table configures the port's `security/tls.py`.

Reference: weed/security/guard.go (white-list check) and the `[jwt.signing]`
/ `[access]` sections of security.toml (command/scaffold/security.toml).
Config is TOML loaded via stdlib tomllib; env vars WEED_JWT_SIGNING_KEY /
WEED_JWT_SIGNING_READ_KEY override, mirroring the reference's viper
WEED_-prefix env override (util/config.go).
"""

from __future__ import annotations

import ipaddress
import os

from seaweedfs_tpu_torch.security.jwt import SigningKey


class Guard:
    def __init__(self, whitelist: list[str] | None = None):
        self.networks: list[ipaddress._BaseNetwork] = []
        self.exact: set[str] = set()
        for item in whitelist or []:
            item = item.strip()
            if not item:
                continue
            try:
                self.networks.append(ipaddress.ip_network(item, strict=False))
            except ValueError:
                self.exact.add(item)

    def __bool__(self) -> bool:
        return bool(self.networks or self.exact)

    def is_allowed(self, remote_ip: str) -> bool:
        if not self:
            return True
        if remote_ip in self.exact:
            return True
        try:
            addr = ipaddress.ip_address(remote_ip)
        except ValueError:
            return False
        return any(addr in net for net in self.networks)


class SecurityConfig:
    """Parsed security.toml: write/read JWT keys for volume + filer, and the
    master/shell IP whitelist."""

    def __init__(self, data: dict | None = None):
        data = data or {}

        def key(section: str) -> SigningKey:
            # TOML [jwt.signing.read] parses to nested dicts — walk the
            # dotted path under the "jwt" table
            sec: dict = data.get("jwt", {})
            for part in section.split("."):
                sec = sec.get(part, {}) if isinstance(sec, dict) else {}
            if not isinstance(sec, dict):
                sec = {}
            return SigningKey(sec.get("key", ""),
                              int(sec.get("expires_after_seconds", 10)))

        self.volume_write = key("signing")
        self.volume_read = key("signing.read")
        self.filer_write = key("filer.signing")
        self.filer_read = key("filer.signing.read")
        self.guard = Guard(data.get("access", {}).get("ui", {}).get(
            "white_list", data.get("access", {}).get("white_list")))
        # [tls] table: installs process-wide HTTPS/mTLS for every server
        # and client in this process (reference: weed/security/tls.go:26-60
        # wraps all gRPC ends the same way from [grpc] sections)
        from seaweedfs_tpu_torch.security import tls
        self.tls = data.get("tls") or {}
        tls.configure(self.tls)

    @classmethod
    def load(cls, path: str | None = None) -> "SecurityConfig":
        data: dict = {}
        candidates = [path] if path else [
            "./security.toml",
            os.path.expanduser("~/.seaweedfs/security.toml"),
            "/etc/seaweedfs/security.toml",
        ]
        for cand in candidates:
            if cand and os.path.exists(cand):
                try:
                    import tomllib
                except ImportError:  # Python < 3.11
                    import tomli as tomllib
                with open(cand, "rb") as f:
                    data = tomllib.load(f)
                break
        cfg = cls(data)
        env_key = os.environ.get("WEED_JWT_SIGNING_KEY")
        if env_key:
            cfg.volume_write = SigningKey(
                env_key, cfg.volume_write.expires_after_seconds)
        env_rkey = os.environ.get("WEED_JWT_SIGNING_READ_KEY")
        if env_rkey:
            cfg.volume_read = SigningKey(
                env_rkey, cfg.volume_read.expires_after_seconds)
        return cfg
