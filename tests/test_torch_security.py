"""The port's JWT and access guard, twins of tests/test_security.py's
TestJwt and TestGuard against `seaweedfs_tpu_torch.security`, tokens
crossing between the packages both ways, and JWT enforcement on the
port's volume server under the reference master.
"""

import asyncio
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from seaweedfs_tpu.security import jwt as ref_jwt

from seaweedfs_tpu_torch.security import jwt as sjwt
from seaweedfs_tpu_torch.security.guard import Guard, SecurityConfig


class TestJwt:
    def test_roundtrip(self):
        key = sjwt.SigningKey("sekrit", 10)
        tok = sjwt.gen_jwt(key, "3,01637037d6")
        claims = sjwt.decode_jwt(key, tok, expected_fid="3,01637037d6")
        assert claims["fid"] == "3,01637037d6"

    def test_wrong_key_rejected(self):
        tok = sjwt.gen_jwt(sjwt.SigningKey("a"), "3,xyz")
        with pytest.raises(sjwt.JwtError, match="signature"):
            sjwt.decode_jwt(sjwt.SigningKey("b"), tok)

    def test_fid_mismatch_rejected(self):
        key = sjwt.SigningKey("k")
        tok = sjwt.gen_jwt(key, "3,aaa")
        with pytest.raises(sjwt.JwtError, match="fid"):
            sjwt.decode_jwt(key, tok, expected_fid="4,bbb")

    def test_empty_fid_token_covers_any(self):
        key = sjwt.SigningKey("k")
        tok = sjwt.gen_jwt(key, "")
        sjwt.decode_jwt(key, tok, expected_fid="9,zzz")  # no raise

    def test_expiry(self):
        key = sjwt.SigningKey("k", expires_after_seconds=-5)
        tok = sjwt.gen_jwt(key, "1,a")
        # exp is already in the past
        with pytest.raises(sjwt.JwtError, match="expired"):
            sjwt.decode_jwt(key, tok)

    def test_no_expiry_when_zero(self):
        key = sjwt.SigningKey("k", expires_after_seconds=0)
        tok = sjwt.gen_jwt(key, "1,a")
        time.sleep(0.01)
        sjwt.decode_jwt(key, tok)  # no raise

    def test_header_extraction(self):
        assert sjwt.token_from_request(
            {"Authorization": "Bearer abc"}, {}) == "abc"
        assert sjwt.token_from_request(
            {"Authorization": "BEARER abc"}, {}) == "abc"
        assert sjwt.token_from_request({}, {"jwt": "q"}) == "q"
        assert sjwt.token_from_request({}, {}) == ""

    def test_empty_key_signs_nothing(self):
        assert sjwt.gen_jwt(sjwt.SigningKey(""), "1,a") == ""


class TestGuard:
    def test_empty_allows_all(self):
        assert Guard([]).is_allowed("10.1.2.3")

    def test_cidr_and_exact(self):
        g = Guard(["192.168.0.0/16", "10.0.0.1"])
        assert g.is_allowed("192.168.5.5")
        assert g.is_allowed("10.0.0.1")
        assert not g.is_allowed("10.0.0.2")

    def test_security_config_from_real_toml(self):
        import tomllib
        data = tomllib.loads(
            '[jwt.signing]\nkey = "w"\n'
            '[jwt.signing.read]\nkey = "r"\n'
            '[jwt.filer.signing]\nkey = "fw"\nexpires_after_seconds = 30\n')
        cfg = SecurityConfig(data)
        assert cfg.volume_write.key == b"w"
        assert cfg.volume_read.key == b"r"
        assert cfg.filer_write.key == b"fw"
        assert cfg.filer_write.expires_after_seconds == 30
        assert not cfg.filer_read

    def test_malformed_token_is_jwt_error(self):
        key = sjwt.SigningKey("k")
        for bad in ("a.b.A", "x", "..", "a.!!!.c"):
            with pytest.raises(sjwt.JwtError):
                sjwt.decode_jwt(key, bad)

    def test_security_config_from_toml_dict(self):
        cfg = SecurityConfig({
            "jwt": {"signing": {"key": "abc", "expires_after_seconds": 20}},
            "access": {"white_list": ["127.0.0.1"]},
        })
        assert cfg.volume_write and cfg.volume_write.expires_after_seconds == 20
        assert not cfg.filer_write
        assert cfg.guard.is_allowed("127.0.0.1")
        assert not cfg.guard.is_allowed("8.8.8.8")


@pytest.mark.parametrize("direction", ["port_signs", "reference_signs"])
@pytest.mark.parametrize("fid", ["3,01637037d6", ""])
def test_tokens_cross_between_packages(direction, fid):
    """A token one package signs verifies in the other, with the same
    claims; a wrong key fails in both."""
    sign, check = (sjwt, ref_jwt) if direction == "port_signs" \
        else (ref_jwt, sjwt)
    tok = sign.gen_jwt(sign.SigningKey("shared", 0), fid)
    assert check.decode_jwt(check.SigningKey("shared", 0), tok,
                            expected_fid="3,01637037d6") == {"fid": fid}
    with pytest.raises(check.JwtError, match="signature"):
        check.decode_jwt(check.SigningKey("other", 0), tok)


def test_security_config_load_reads_toml_and_env(tmp_path, monkeypatch):
    """`SecurityConfig.load` reads security.toml and lets the WEED_ env
    keys override, configuring the port's TLS from its [tls] table."""
    from seaweedfs_tpu_torch.security import tls
    p = tmp_path / "security.toml"
    p.write_text('[jwt.signing]\nkey = "file"\nexpires_after_seconds = 7\n')
    monkeypatch.setenv("WEED_JWT_SIGNING_READ_KEY", "envread")
    cfg = SecurityConfig.load(str(p))
    assert cfg.volume_write.key == b"file"
    assert cfg.volume_write.expires_after_seconds == 7
    assert cfg.volume_read.key == b"envread"
    assert cfg.tls == {} and not tls.enabled()
    monkeypatch.setenv("WEED_JWT_SIGNING_KEY", "envwrite")
    assert SecurityConfig.load(str(p)).volume_write.key == b"envwrite"


def test_volume_server_enforces_jwt(tmp_path):
    """End to end: the reference master signs assign tokens, the port's
    volume server rejects unsigned writes and deletes and accepts signed
    ones (volume_server_handlers_write.go:33)."""
    from seaweedfs_tpu.client import WeedClient
    from seaweedfs_tpu.security.guard import SecurityConfig as RefConfig
    from seaweedfs_tpu.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    ref_sec = RefConfig({"jwt": {"signing": {"key": "testkey"}}})
    sec = SecurityConfig({"jwt": {"signing": {"key": "testkey"}}})
    loop = asyncio.new_event_loop()
    loop_thread = threading.Thread(target=loop.run_forever, daemon=True)
    loop_thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(60)

    master = MasterServer("127.0.0.1", free_port(), security=ref_sec)
    vs = VolumeServer([str(tmp_path)], master_url=master.url,
                      port=free_port(), heartbeat_interval=0.2,
                      security=sec, device="cpu")
    run(master.start())
    run(vs.start())
    try:
        with urllib.request.urlopen(
                f"http://{master.url}/dir/assign") as r:
            a = json.load(r)
        assert a.get("auth"), a
        url = f"http://{a['url']}/{a['fid']}"

        def put(headers):
            req = urllib.request.Request(url, data=b"payload",
                                         method="PUT", headers=headers)
            try:
                with urllib.request.urlopen(req) as r:
                    return r.status
            except urllib.error.HTTPError as e:
                return e.code

        assert put({}) == 401
        assert put({"Authorization": "Bearer garbage"}) == 401
        assert put({"Authorization": "Bearer " + a["auth"]}) == 201
        # reads require no token
        with urllib.request.urlopen(url) as r:
            assert r.read() == b"payload"
        # deletes require a token too; WeedClient with a signer succeeds
        req = urllib.request.Request(url, method="DELETE")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 401
        wc = WeedClient(master.url,
                        jwt_signer=lambda f: ref_jwt.gen_jwt(
                            ref_sec.volume_write, f))
        wc.delete(a["fid"])
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url)
        assert ei.value.code == 404
    finally:
        run(vs.stop())
        run(master.stop())
        loop.call_soon_threadsafe(loop.stop)
        loop_thread.join(5)
        loop.close()


def test_volume_server_read_jwt(tmp_path):
    """With a [jwt.signing.read] key, reads need a token for their fid."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from aiohttp import web

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    async def heartbeat(req):
        return web.json_response({})

    app = web.Application()
    app.add_routes([web.post("/heartbeat", heartbeat)])
    loop = asyncio.new_event_loop()
    loop_thread = threading.Thread(target=loop.run_forever, daemon=True)
    loop_thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(60)

    runner = web.AppRunner(app)
    mport = free_port()
    run(runner.setup())
    run(web.TCPSite(runner, "127.0.0.1", mport).start())
    sec = SecurityConfig({"jwt": {"signing": {"read": {"key": "rk"}}}})
    vs = VolumeServer([str(tmp_path)], f"127.0.0.1:{mport}",
                      port=free_port(), security=sec, device="cpu")
    run(vs.start())
    try:
        base = f"http://{vs.url}"
        urllib.request.urlopen(urllib.request.Request(
            base + "/admin/assign_volume", data=b'{"volume": 1}',
            headers={"Content-Type": "application/json"})).close()
        f = "1,01637037d6"
        urllib.request.urlopen(urllib.request.Request(
            f"{base}/{f}", data=b"secret", method="PUT")).close()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/{f}")
        ei.value.close()
        assert ei.value.code == 401
        tok = sjwt.gen_jwt(sec.volume_read, f)
        with urllib.request.urlopen(f"{base}/{f}?jwt={tok}") as r:
            assert r.read() == b"secret"
        other = sjwt.gen_jwt(sec.volume_read, "1,02637037d6")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                f"{base}/{f}", headers={"Authorization": "Bearer " + other}))
        ei.value.close()
        assert ei.value.code == 401
    finally:
        run(vs.stop())
        run(runner.cleanup())
        loop.call_soon_threadsafe(loop.stop)
        loop_thread.join(5)
        loop.close()
