"""The launch tile's pin, its micro-sweep and the tile-drift sentinel
(ops/gf_cuda.py, stats/pipeline.py, stats/metrics.py, stats/profile.py,
server/volume_server.py) held against the JAX package's.

Twins of tests/test_perf_obs.py's pin and sentinel cases, on the port's
modules and, for the page, on the port's master and volume server.  The
sweep itself runs on the card only (tests/test_torch_cuda.py,
chip_smoke.py phase 31): here every sentinel is given its `measure`, as
the reference's tests give theirs, and every pin is taken for the CPU
(`device="cpu"`).  Every case points WEEDTPU_TILE_PIN into its own
temporary directory, so none reads or writes the home directory's pin.
"""

import asyncio
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import pallas_gf as ref_pallas
from seaweedfs_tpu.stats import pipeline as ref_pipeline

from seaweedfs_tpu_torch.models import rs
from seaweedfs_tpu_torch.ops import codecs, gf, gf_cuda
from seaweedfs_tpu_torch.server import volume_server as vsmod
from seaweedfs_tpu_torch.stats import history, metrics, pipeline, profile
from tests.test_maintenance import _get
from tests.test_torch_master_cluster import REPO, Cluster, free_port

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _own_pin(tmp_path, monkeypatch):
    """A pin path of the case's own, no WEEDTPU_EC_TILE, and the process-
    wide state the case may touch (the sentinel, the drift gauges, the
    ceilings' cache) put back after it."""
    monkeypatch.setenv("WEEDTPU_TILE_PIN", str(tmp_path / "pin.json"))
    monkeypatch.delenv("WEEDTPU_EC_TILE", raising=False)
    monkeypatch.delenv("WEEDTPU_TILE_SENTINEL_INTERVAL", raising=False)
    saved = pipeline._sentinel
    yield
    pipeline.set_sentinel(saved)
    metrics.TILE_DRIFT.labels().set(0.0)
    metrics.TILE_DRIFT_RATIO.labels().set(1.0)
    profile._ceilings_cache = None


# ---- twins of tests/test_perf_obs.py ---------------------------------------

def test_drift_gauge_clears_when_pin_goes_unmeasurable():
    """Twin of test_drift_gauge_clears_when_pin_goes_unmeasurable: after
    a stale verdict, deleting the pin zeroes weedtpu_tile_drift."""
    pin = gf_cuda.save_tile_pin(4096, 100.0, device="cpu")
    s = pipeline.TileDriftSentinel(
        measure=lambda: {4096: 100.0, 8192: 200.0}, device="cpu")
    assert s.run_once()["state"] == "stale"
    assert metrics.TILE_DRIFT.labels().value == pytest.approx(1.0)
    os.remove(pin)
    assert s.run_once()["state"] == "no_pin"
    assert metrics.TILE_DRIFT.labels().value == 0.0
    assert metrics.TILE_DRIFT_RATIO.labels().value == 1.0


def test_tile_pin_roundtrip_and_foreign_fingerprint_never_applies(tmp_path):
    """Twin of test_tile_pin_roundtrip_and_foreign_fingerprint_never_
    applies: a matching pin applies, one taken on a TPU never does, and
    the sentinel reads fingerprint_mismatch."""
    pin_path = os.environ["WEEDTPU_TILE_PIN"]
    gf_cuda.save_tile_pin(8192, 222.2, {"8192": 222.2}, device="cpu")
    pin = gf_cuda.load_tile_pin()
    assert pin["tile"] == 8192 and pin["gbps"] == 222.2
    assert pin["fingerprint"] == gf_cuda.chip_fingerprint("cpu")
    assert gf_cuda.resolved_tile(device="cpu") == 8192
    for foreign in ("tpu:v9:8", "tpu:TPU v5 lite:1", "cpu:cpu:1"):
        pin["fingerprint"] = foreign
        with open(pin_path, "w") as f:
            json.dump(pin, f)
        assert gf_cuda.resolved_tile(device="cpu") == gf_cuda.DEFAULT_TILE
        st = pipeline.TileDriftSentinel(
            measure=lambda: {8192: 1.0}, pin_path=pin_path,
            device="cpu").run_once()
        assert st["state"] == "fingerprint_mismatch", st
        assert st["pin"]["fingerprint"] == foreign
        assert st["fingerprint"] == gf_cuda.CPU_FINGERPRINT


def test_sentinel_verdicts_stale_ok_and_failed():
    """Twin of test_sentinel_verdicts_stale_ok_and_failed, with the
    reference's sentinel beside the port's on the same tables."""
    gf_cuda.save_tile_pin(4096, 100.0, device="cpu")
    s = pipeline.TileDriftSentinel(
        measure=lambda: {4096: 100.0, 8192: 150.0}, device="cpu")
    st = s.run_once()
    assert st["state"] == "stale" and st["best_tile"] == 8192
    assert st["drift"] == pytest.approx(0.5)
    assert st["sweep"]
    assert metrics.TILE_DRIFT.labels().value == pytest.approx(0.5)
    assert s.status() == st
    st = pipeline.TileDriftSentinel(
        measure=lambda: {4096: 150.0, 8192: 140.0}, device="cpu").run_once()
    assert st["state"] == "ok" and st["drift"] == 0.0
    st = pipeline.TileDriftSentinel(
        measure=lambda: {8192: 1.0}, device="cpu").run_once()
    assert st["state"] == "sweep_failed"
    st = pipeline.TileDriftSentinel(
        measure=lambda: (_ for _ in ()).throw(RuntimeError("boom")),
        device="cpu").run_once()
    assert st["state"] == "sweep_failed" and "boom" in st["error"]
    # without `measure` the sentinel sweeps, and the CPU has no launch tile
    st = pipeline.TileDriftSentinel(device="cpu").run_once()
    assert st["state"] == "sweep_failed" and "launch tile" in st["error"], st
    assert metrics.TILE_DRIFT.labels().value == 0.0


def test_no_pin_is_quiet_and_default_alert_rule_exists(monkeypatch):
    """Twin of test_no_pin_is_quiet_and_default_alert_rule_exists, and the
    rule equal to the reference's."""
    from seaweedfs_tpu.stats import history as ref_history
    st = pipeline.TileDriftSentinel(measure=lambda: {},
                                    device="cpu").run_once()
    assert st["state"] == "no_pin"
    monkeypatch.delenv("WEEDTPU_ALERT_RULES", raising=False)
    rules = {r["name"]: r for r in history.parse_alert_rules()}
    rule = rules["tile_pin_stale"]
    assert rule["series"] == "weedtpu_tile_drift"
    assert rule["op"] == "gt" and rule["value"] == pytest.approx(0.1)
    ref = {r["name"]: r for r in ref_history.parse_alert_rules()}
    assert rule == ref["tile_pin_stale"]


def _rule_state(st, name="tile_pin_stale"):
    return next(r for r in st["rules"] if r["name"] == name)["state"]


def _drift_on(url) -> float:
    import urllib.request
    with urllib.request.urlopen(f"http://{url}/metrics", timeout=30) as r:
        text = r.read().decode()
    line = next(ln for ln in text.splitlines()
                if ln.startswith("weedtpu_tile_drift "))
    return float(line.split()[1])


def test_forced_stale_tile_fires_then_clears_cluster_alert(tmp_path,
                                                          monkeypatch):
    """Twin of test_forced_stale_tile_fires_then_clears_cluster_alert on
    the port's master and volume server: a pin that no longer wins its
    sweep by more than 10 % fires tile_pin_stale on /cluster/alerts, its
    verdict is on /debug/pipeline, /cluster/perf, /metrics and the
    shell's cluster.perf, and the alert clears once the pin wins again."""
    from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    monkeypatch.setenv(
        "WEEDTPU_ALERT_RULES",
        "tile_pin_stale=threshold,series=weedtpu_tile_drift,"
        "agg=max,window=2,op=gt,value=0.1,for=0,clear_for=0.2")
    gf_cuda.save_tile_pin(4096, 300.0, device="cpu")
    sweeps = {"stale": {4096: 100.0, 8192: 330.0},
              "ok": {4096: 330.0, 8192: 100.0}}
    mode = {"m": "stale"}
    sentinel = pipeline.TileDriftSentinel(
        measure=lambda: sweeps[mode["m"]], device="cpu")
    pipeline.set_sentinel(sentinel)
    c = Cluster(tmp_path, n_volume_servers=1).start()
    try:
        c.wait_heartbeats()
        st = sentinel.run_once()
        assert st["state"] == "stale" and st["sweep"], st

        def alerts():
            return _get(c.master.url, "/cluster/alerts?refresh=1",
                        timeout=60)

        st_a = alerts()
        if _rule_state(st_a) != "firing":
            st_a = alerts()
        assert _rule_state(st_a) == "firing", st_a
        vs_url = c.volume_servers[0].url
        dbg = _get(vs_url, "/debug/pipeline")
        assert dbg["tile"]["state"] == "stale" and dbg["tile"]["sweep"]
        assert _get(vs_url, "/perf")["tile"] == dbg["tile"]
        perf = _get(c.master.url, "/cluster/perf")
        assert any(t.get("state") == "stale"
                   for t in perf["tiles"].values()), perf["tiles"]
        assert _drift_on(vs_url) == pytest.approx(st["drift"])
        out = io.StringIO()
        run_command(CommandEnv(c.master.url), "cluster.perf", out)
        assert "tile " in out.getvalue() and "stale pinned=4096 " \
            "best=8192" in out.getvalue(), out.getvalue()

        mode["m"] = "ok"
        assert sentinel.run_once()["state"] == "ok"
        assert _drift_on(vs_url) == 0.0
        deadline = time.time() + 20
        state = "firing"
        while time.time() < deadline:
            time.sleep(0.3)
            state = _rule_state(alerts())
            if state == "ok":
                break
        assert state == "ok", state
    finally:
        c.stop()


# ---- the verdict and the pin against the reference's ----------------------

@pytest.mark.parametrize("seed", range(8))
def test_verdict_equals_reference_on_seeded_tables(seed):
    """`_verdict` equal to the reference's on random sweep tables: int
    and str keys, int and float rates, the pinned tile present or not."""
    rng = np.random.default_rng(seed)
    tiles = [2048, 4096, 8192, 16384, 32768, 65536]
    for _ in range(64):
        pinned = int(rng.choice(tiles))
        pin = {"tile": pinned if rng.random() < 0.7 else str(pinned),
               "gbps": float(rng.uniform(1, 400)), "ts": 1.5,
               "fingerprint": "x"}
        sweep = {}
        for t in rng.choice(tiles, size=int(rng.integers(0, 6)),
                            replace=False):
            key = int(t) if rng.random() < 0.5 else str(int(t))
            v = float(rng.uniform(0, 500)) if rng.random() < 0.8 \
                else int(rng.integers(0, 500))
            sweep[key] = v
        if rng.random() < 0.5:
            sweep[pinned] = float(rng.uniform(0, 500))
        mine = pipeline.TileDriftSentinel._verdict(pin, dict(sweep), 7.0)
        ref = ref_pipeline.TileDriftSentinel._verdict(pin, dict(sweep), 7.0)
        assert mine == ref, (pin, sweep)


def test_pins_cross_between_packages():
    """A pin the reference writes loads in the port with the same
    fields, and the reverse; neither applies in the other package, whose
    fingerprint differs."""
    path = os.environ["WEEDTPU_TILE_PIN"]
    sweep = {65536: 222.25, 131072: 100.5}
    ref_pallas.save_tile_pin(65536, 222.25, sweep)
    mine, ref = gf_cuda.load_tile_pin(), ref_pallas.load_tile_pin()
    assert mine == ref and mine["sweep"] == {"65536": 222.25,
                                             "131072": 100.5}
    assert mine["fingerprint"] == ref_pallas.chip_fingerprint()
    assert gf_cuda.resolved_tile(device="cpu") == gf_cuda.DEFAULT_TILE
    st = pipeline.TileDriftSentinel(measure=lambda: sweep,
                                    device="cpu").run_once()
    assert st["state"] == "fingerprint_mismatch"
    os.remove(path)
    gf_cuda.save_tile_pin(8192, 333.5, {8192: 333.5, 2048: 12.0},
                          device="cpu")
    mine, ref = gf_cuda.load_tile_pin(), ref_pallas.load_tile_pin()
    assert ref == mine and set(ref) == {"tile", "gbps", "fingerprint",
                                        "ts", "sweep"}
    assert ref["fingerprint"] == gf_cuda.CPU_FINGERPRINT
    assert ref_pallas.resolved_tile() != 8192
    st = ref_pipeline.TileDriftSentinel(measure=lambda: {8192: 1.0}
                                        ).run_once()
    assert st["state"] == "fingerprint_mismatch"


def test_resolved_tile_precedence(monkeypatch):
    """The argument, then WEEDTPU_EC_TILE, then a matching pin, then the
    default, as the reference orders them."""
    assert gf_cuda.resolved_tile(device="cpu") == gf_cuda.DEFAULT_TILE
    gf_cuda.save_tile_pin(16384, 10.0, device="cpu")
    assert gf_cuda.resolved_tile(device="cpu") == 16384
    monkeypatch.setenv("WEEDTPU_EC_TILE", "32768")
    assert gf_cuda.resolved_tile(device="cpu") == 32768
    assert gf_cuda.resolved_tile(4096, device="cpu") == 4096
    monkeypatch.setenv("WEEDTPU_EC_TILE", "")  # empty is unset
    assert gf_cuda.resolved_tile(device="cpu") == 16384
    # the reference orders the same sources alike
    monkeypatch.setenv("WEEDTPU_EC_TILE", "32768")
    assert ref_pallas.resolved_tile() == 32768
    assert ref_pallas.resolved_tile(4096) == 4096


@pytest.mark.parametrize("value", ["big", "0", "-2048", "2048.0"])
def test_malformed_ec_tile_raises_unlike_the_reference(monkeypatch, value):
    """A WEEDTPU_EC_TILE that is not a positive integer raises where the
    reference falls back to the pin or its default."""
    monkeypatch.setenv("WEEDTPU_EC_TILE", value)
    with pytest.raises(ValueError, match="WEEDTPU_EC_TILE"):
        gf_cuda.resolved_tile(device="cpu")
    with pytest.raises(ValueError, match="WEEDTPU_EC_TILE"):
        gf_cuda.get_codec(10, 4, device="cpu")
    assert ref_pallas.resolved_tile() == ref_pallas.DEFAULT_TILE


def test_pin_cache_costs_a_stat_and_caches_a_corrupt_pin(monkeypatch):
    """A pin is parsed once per (mtime, size, inode); a rewrite is read
    again; a corrupt file is cached as None and not parsed again."""
    path = gf_cuda.save_tile_pin(4096, 50.0, device="cpu")
    parsed = []
    real_load = json.load

    def counting(f):
        parsed.append(f.name)
        return real_load(f)
    monkeypatch.setattr(gf_cuda.json, "load", counting)
    gf_cuda._pin_cache.pop(path, None)
    for _ in range(5):
        assert gf_cuda.load_tile_pin()["tile"] == 4096
    assert len(parsed) == 1
    pin = gf_cuda.load_tile_pin()
    pin["tile"] = 1  # a copy: the cache stays as it was
    assert gf_cuda.load_tile_pin()["tile"] == 4096
    gf_cuda.save_tile_pin(16384, 70.0, device="cpu")
    assert gf_cuda.load_tile_pin()["tile"] == 16384 and len(parsed) == 2
    with open(path, "w") as f:
        f.write("{not json")
    for _ in range(3):
        assert gf_cuda.load_tile_pin() is None
        assert gf_cuda.resolved_tile(device="cpu") == gf_cuda.DEFAULT_TILE
    assert len(parsed) == 3
    with open(path, "w") as f:
        json.dump({"gbps": 1.0}, f)  # no tile: not a pin
    assert gf_cuda.load_tile_pin() is None
    os.remove(path)
    assert gf_cuda.load_tile_pin() is None and path not in gf_cuda._pin_cache


@pytest.mark.parametrize("tile", [0, 1000, 3000, 2049, 1 << 21, -2048,
                                  True, 4096.0])
def test_tile_the_kernel_cannot_take_raises_before_any_launch(tile,
                                                              monkeypatch):
    """A tile that is not a multiple of 2048 from 2048 to 1 MiB raises in
    CudaGFMatrix and in the codec, on any device, before a launch."""
    C = rs.get_code(10, 4).parity_matrix
    before = dict(gf_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="launch tile"):
        gf_cuda.CudaGFMatrix(C, tile=tile)
    with pytest.raises(ValueError, match="launch tile"):
        gf_cuda.get_codec(10, 4, device="cpu", tile=tile)
    if isinstance(tile, int) and not isinstance(tile, bool) and tile > 0:
        monkeypatch.setenv("WEEDTPU_EC_TILE", str(tile))
        with pytest.raises(ValueError, match="launch tile"):
            gf_cuda.get_codec(10, 4, device="cpu")
    assert gf_cuda.LAUNCHES == before


@pytest.mark.parametrize("tile", gf_cuda.SWEEP_TILES)
def test_plain_version_ignores_the_tile(tile):
    """On the CPU every candidate tile gives the plain version's bytes,
    equal to numpy's GF product and the reference's encode."""
    code = rs.get_code(10, 4)
    x = np.random.default_rng(tile).integers(0, 256, (10, 5000),
                                             dtype=np.uint8)
    got = gf_cuda.CudaGFMatrix(code.parity_matrix, tile=tile)(
        torch.from_numpy(x)).numpy()
    assert np.array_equal(got, gf.gf_matmul(code.parity_matrix, x))
    codec = gf_cuda.get_codec(10, 4, device="cpu", tile=tile)
    assert codec.tile == tile and codec._parity.tile == tile
    assert np.array_equal(codec.encode(torch.from_numpy(x)).numpy()[10:],
                          got)


def test_get_codec_picks_up_a_pin_written_after_its_first_call():
    """The resolved tile is part of get_codec's cache key (and of the LRC
    and MSR codecs' builds), so a pin written after a first lookup
    reaches the next one."""
    first = gf_cuda.get_codec(10, 4, device="cpu")
    assert first.tile == gf_cuda.DEFAULT_TILE
    assert gf_cuda.get_codec(10, 4, device="cpu") is first
    lrc = codecs.make_codec("lrc_10_2_2", "cpu", "cuda")
    gf_cuda.save_tile_pin(8192, 99.0, device="cpu")
    second = gf_cuda.get_codec(10, 4, device="cpu")
    assert second is not first and second.tile == 8192
    assert second._parity.tile == 8192
    assert codecs.make_codec("rs_10_4", "cpu", "cuda") is second
    lrc2 = codecs.make_codec("lrc_10_2_2", "cpu", "cuda")
    assert lrc2 is not lrc and lrc2.tile == 8192
    # a matrix built with no tile takes the pin at its first launch on a
    # card; on the CPU it takes none
    mat = gf_cuda.CudaGFMatrix(rs.get_code(10, 4).parity_matrix)
    assert mat.tile is None and mat.tile_on(CPU) == 8192


def test_micro_sweep_needs_a_card():
    """The plain version has no launch tile: the sweep raises on the CPU,
    as the sentinel then reports (sweep_failed)."""
    with pytest.raises(ValueError, match="launch tile"):
        gf_cuda.micro_sweep(device="cpu")
    before = dict(gf_cuda.LAUNCHES)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gf_cuda.micro_sweep()
    assert gf_cuda.LAUNCHES == before


# ---- the volume server, the ceilings ---------------------------------------

@pytest.mark.parametrize("value", ["often", "-1"])
def test_malformed_sentinel_interval_raises_before_bind(tmp_path,
                                                        monkeypatch, value):
    """A malformed WEEDTPU_TILE_SENTINEL_INTERVAL fails VolumeServer.start
    before its socket binds; the reference reads it as off."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_TILE_SENTINEL_INTERVAL", value)
    assert ref_pipeline.TileDriftSentinel().interval <= 0.0
    with pytest.raises(ValueError, match="WEEDTPU_TILE_SENTINEL_INTERVAL"):
        pipeline.TileDriftSentinel()
    vs = vsmod.VolumeServer([str(tmp_path / "vs")], "127.0.0.1:1",
                            "127.0.0.1", free_port(), device="cpu")
    try:
        with pytest.raises(ValueError,
                           match="WEEDTPU_TILE_SENTINEL_INTERVAL"):
            asyncio.run(vs.start())
        assert vs._runner is None  # it failed before binding
    finally:
        vs.store.close()


def _sentinel_threads():
    return [t for t in threading.enumerate()
            if t.name == "weedtpu-tile-sentinel"]


def test_volume_server_starts_the_sentinel_only_when_asked(tmp_path,
                                                           monkeypatch):
    """At the default interval a started server runs no sentinel; with
    one set, its start installs the process-wide sentinel on the
    server's device, and its verdict rides /debug/pipeline."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    pipeline.set_sentinel(None)
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    c = Cluster(tmp_path / "a", n_volume_servers=1).start()
    try:
        c.wait_heartbeats()
        assert pipeline.sentinel_status() is None
        assert not _sentinel_threads()
        assert "tile" not in _get(c.volume_servers[0].url,
                                  "/debug/pipeline")
    finally:
        c.stop()
    monkeypatch.setenv("WEEDTPU_TILE_SENTINEL_INTERVAL", "3600")
    c = Cluster(tmp_path / "b", n_volume_servers=1).start()
    s = None
    try:
        c.wait_heartbeats()
        s = pipeline._sentinel
        assert s is not None and s.interval == 3600.0 and s.device == CPU
        assert len(_sentinel_threads()) == 1
        assert _get(c.volume_servers[0].url,
                    "/debug/pipeline")["tile"] == {"state": "idle"}
        # no pin: a tick reads no_pin without a sweep
        assert s.run_once()["state"] == "no_pin"
    finally:
        c.stop()
        if s is not None:
            s.stop()
        pipeline.set_sentinel(None)
    assert not _sentinel_threads()


def test_device_ceiling_from_a_matching_pin():
    """profile.ceilings() takes the pin's rate as the ``device`` ceiling
    when its fingerprint is one this process has taken, and not a
    foreign pin's; WEEDTPU_CEILINGS and set_ceiling still win."""
    gf_cuda.chip_fingerprint("cpu")
    gf_cuda.save_tile_pin(4096, 123.5, device="cpu")
    profile._ceilings_cache = None
    assert profile.ceilings()["device"] == 123.5
    path = os.environ["WEEDTPU_TILE_PIN"]
    with open(path) as f:
        pin = json.load(f)
    pin["fingerprint"] = "tpu:v9:8"
    with open(path, "w") as f:
        json.dump(pin, f)
    profile._ceilings_cache = None
    assert "device" not in profile.ceilings()


def test_ceilings_without_torch_import_neither_torch_nor_jax(tmp_path):
    """A process that never loaded torch (the CLI's offline tools) asks
    for its ceilings and loads neither torch nor JAX for it."""
    code = ("import sys\n"
            "from seaweedfs_tpu_torch.stats import profile\n"
            "c = profile.ceilings()\n"
            "assert c == {'disk': 2.0}, c\n"
            "bad = [m for m in ('torch', 'jax', 'seaweedfs_tpu') "
            "if m in sys.modules]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    pin = tmp_path / "pin.json"
    pin.write_text(json.dumps({"tile": 4096, "gbps": 9.0,
                               "fingerprint": gf_cuda.CPU_FINGERPRINT}))
    env = dict(os.environ, WEEDTPU_CEILINGS="disk=2",
               WEEDTPU_TILE_PIN=str(pin), PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_ensure_sentinel_is_process_wide(monkeypatch):
    """ensure_sentinel starts one sentinel when the interval asks for
    one, returns it to every later caller, and none at 0."""
    pipeline.set_sentinel(None)
    assert pipeline.ensure_sentinel("cpu") is None
    monkeypatch.setenv("WEEDTPU_TILE_SENTINEL_INTERVAL", "3600")
    s = pipeline.ensure_sentinel("cpu")
    try:
        assert s is pipeline.ensure_sentinel("cpu")
        assert pipeline.sentinel_status() == {"state": "idle"}
        assert len(_sentinel_threads()) == 1
    finally:
        s.stop()
        pipeline.set_sentinel(None)
    assert not _sentinel_threads() and pipeline.sentinel_status() is None
