"""The port's geo-replication observatory (ROADMAP 1.22a) on port
clusters: the filer's `/__meta__/digest` probe, the sync pump's resume
and loop prevention under churn, the master's `/cluster/geo` with the
shell's `cluster.geo`, and the `DivergenceAuditor`.

- Twins of tests/test_geo.py's `test_meta_digest_endpoint`,
  `test_sync_resume_mid_stream`, `test_bidirectional_churn_no_echo` and
  `test_geo_chaos_acceptance` (over the port's `GeoCluster`, its
  volume servers on the CPU), each keeping its name and checks.
- `/cluster/geo` and `cluster.geo` print what the reference's print for
  the same scraped series, and either shell prints alike on either
  master.
- The auditor's `weedtpu_geo_divergence` gauge goes to 1 while two port
  filers differ and back to 0 after a heal, with the reference's
  auditor agreeing on the same filers.
"""

import io
import json
import re
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from tests.test_torch_master import pair  # noqa: F401
from tests.test_torch_replication import (_quiet_cluster, get,  # noqa: F401
                                          put, two_filers, wait_for)

URL_TIMEOUT = 30


def _json_get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=URL_TIMEOUT) as r:
        return json.loads(r.read())


def _digest(filer_url: str, prefix: str = "/", since: int | None = None,
            want_digest: bool = True) -> dict:
    q = {"prefix": prefix}
    if since is not None:
        q["since"] = str(since)
    if not want_digest:
        q["digest"] = "0"
    return _json_get(f"http://{filer_url}/__meta__/digest?"
                     + urllib.parse.urlencode(q))


# ---- twins of tests/test_geo.py ---------------------------------------------

def test_meta_digest_endpoint(two_filers):
    c, fa, fb = two_filers
    put(fa.url, "/dg/x.txt", b"alpha")
    put(fa.url, "/dg/y.txt", b"beta")

    da = _digest(fa.url, "/dg")
    assert da["digest"] and da["entries"] >= 2
    assert da["head_ts_ns"] > 0
    # backlog `since` semantics: everything since 0, nothing since head
    assert _digest(fa.url, "/dg", since=0)["backlog_events"] >= 2
    assert _digest(fa.url, "/dg",
                   since=da["head_ts_ns"])["backlog_events"] == 0
    # digest=0 is the cheap head read (no tree walk)
    cheap = _digest(fa.url, "/dg", want_digest=False)
    assert "digest" not in cheap and "backlog_events" in cheap

    # empty peer differs; byte-identical content at the same paths agrees
    assert _digest(fb.url, "/dg")["digest"] != da["digest"]
    put(fb.url, "/dg/x.txt", b"alpha")
    put(fb.url, "/dg/y.txt", b"beta")
    assert _digest(fb.url, "/dg")["digest"] == da["digest"]
    # ...and content (not just names) is what's digested
    put(fb.url, "/dg/y.txt", b"BETA")
    assert _digest(fb.url, "/dg")["digest"] != da["digest"]

    # bad since -> 400, not a stack trace
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(
            f"http://{fa.url}/__meta__/digest?since=nope", timeout=10)
    assert ei.value.code == 400


def test_sync_resume_mid_stream(two_filers, tmp_path, monkeypatch):
    from seaweedfs_tpu_torch.replication.filer_sync import FilerSync
    monkeypatch.setenv("WEEDTPU_SYNC_BACKLOG_INTERVAL", "0.2")
    c, fa, fb = two_filers
    offsets = str(tmp_path / "geo_off.json")

    for i in range(6):
        put(fa.url, f"/res/a{i}.txt", f"payload-{i}".encode() * 64)
    s1 = FilerSync(fa.url, fb.url, prefix="/res", offset_path=offsets,
                   one_way=True)
    s1.start()
    # kill mid-stream: as soon as SOME (not necessarily all) landed
    assert wait_for(lambda: get(fb.url, "/res/a2.txt") is not None)
    s1.stop()  # flushes offsets
    applied1 = s1.a2b.applied
    assert applied1 > 0
    off1 = json.load(open(offsets))
    assert off1 and max(off1.values()) > 0

    # the gap: events logged while the pump is down
    for i in range(3):
        put(fa.url, f"/res/gap{i}.txt", f"gap-{i}".encode() * 64)
    gap = _digest(fa.url, "/res", since=max(off1.values()),
                  want_digest=False)["backlog_events"]
    assert gap >= 3  # the source's digest endpoint sees the backlog

    s2 = FilerSync(fa.url, fb.url, prefix="/res", offset_path=offsets,
                   one_way=True)
    s2.start()
    try:
        assert wait_for(lambda: all(
            get(fb.url, f"/res/gap{i}.txt") == f"gap-{i}".encode() * 64
            for i in range(3)), 20)
        # byte-identical convergence, proven by the digest the auditor uses
        assert wait_for(lambda: _digest(fa.url, "/res")["digest"]
                        == _digest(fb.url, "/res")["digest"], 15)
        # resumed from the offset, not a full replay
        total = _digest(fa.url, "/res", since=0,
                        want_digest=False)["backlog_events"]
        assert s2.a2b.applied < total
        assert s2.a2b.applied >= 3
        # lag plane caught up; backlog drains to 0 (keepalive-driven poll)
        assert wait_for(lambda: s2.a2b.backlog == 0, 15)
        assert s2.a2b.lag_s() < 10.0
        assert not s2.a2b.stalled
    finally:
        s2.stop()


def test_bidirectional_churn_no_echo(two_filers, tmp_path):
    from seaweedfs_tpu_torch.replication.filer_sync import FilerSync
    c, fa, fb = two_filers
    sync = FilerSync(fa.url, fb.url, prefix="/churn",
                     offset_path=str(tmp_path / "churn_off.json"))
    sync.start()
    try:
        def writer(filer_url, tag):
            for i in range(10):
                put(filer_url, f"/churn/{tag}{i}.txt",
                    f"{tag}-{i}".encode() * 32)
        ta = threading.Thread(target=writer, args=(fa.url, "a"))
        tb = threading.Thread(target=writer, args=(fb.url, "b"))
        ta.start()
        tb.start()
        ta.join()
        tb.join()

        assert wait_for(lambda: all(
            get(fb.url, f"/churn/a{i}.txt") is not None and
            get(fa.url, f"/churn/b{i}.txt") is not None
            for i in range(10)), 25)
        # loop prevention engaged: each pump saw (and skipped) the
        # other's signature-stamped writes instead of echoing them back
        assert wait_for(lambda: sync.a2b.skipped > 0
                        and sync.b2a.skipped > 0, 15)
        # no echo storm: applied counters settle
        assert wait_for(lambda: _digest(fa.url, "/churn")["digest"]
                        == _digest(fb.url, "/churn")["digest"], 15)
        applied = (sync.a2b.applied, sync.b2a.applied)
        time.sleep(1.2)
        assert (sync.a2b.applied, sync.b2a.applied) == applied
    finally:
        sync.stop()


# ---- /cluster/geo and cluster.geo against the reference's -------------------

def _series() -> dict:
    """One scrape's worth of the pumps' and the auditor's families, from
    two nodes sharing nothing (the master folds them by MAX)."""
    def fam(kind, samples):
        return {"type": kind, "help": "", "samples": samples}

    def node(scale):
        return {
            "weedtpu_replication_lag_seconds": fam("gauge", [
                ("weedtpu_replication_lag_seconds", {"direction": "a->b"},
                 1.25 * scale),
                ("weedtpu_replication_lag_seconds", {"direction": "b->a"},
                 0.5)]),
            "weedtpu_replication_backlog_events": fam("gauge", [
                ("weedtpu_replication_backlog_events",
                 {"direction": "a->b"}, 7.0 * scale)]),
            "weedtpu_replication_stalled": fam("gauge", [
                ("weedtpu_replication_stalled", {"direction": "a->b"},
                 float(scale > 1)),
                ("weedtpu_replication_stalled", {"direction": "b->a"},
                 0.0)]),
            "weedtpu_replication_applied_total": fam("counter", [
                ("weedtpu_replication_applied_total",
                 {"direction": "a->b"}, 40.0 * scale),
                ("weedtpu_replication_applied_total",
                 {"direction": "b->a"}, 3.0)]),
            "weedtpu_replication_skipped_total": fam("counter", [
                ("weedtpu_replication_skipped_total",
                 {"direction": "b->a"}, 40.0 * scale)]),
            "weedtpu_replication_errors_total": fam("counter", [
                ("weedtpu_replication_errors_total",
                 {"direction": "a->b"}, 2.0 * scale)]),
            "weedtpu_geo_divergence": fam("gauge", [
                ("weedtpu_geo_divergence", {"prefix": "/p"},
                 float(scale > 1))]),
            "weedtpu_geo_audits_total": fam("counter", [
                ("weedtpu_geo_audits_total", {"outcome": "clean"},
                 5.0 * scale),
                ("weedtpu_geo_audits_total", {"outcome": "diverged"},
                 1.0)]),
            "weedtpu_wan_bytes_total": fam("counter", [
                ("weedtpu_wan_bytes_total", {"direction": "sent",
                                             "class": "replication",
                                             "region": "b"},
                 1000.0 * scale),
                ("weedtpu_wan_bytes_total", {"direction": "recv",
                                             "class": "replication",
                                             "region": "b"}, 12.0)])}
    return {"127.0.0.1:1": node(1), "127.0.0.1:2": node(2),
            "__aggregator__": node(9)}


def _mask(text: str) -> str:
    """The WAN totals are each process registry's own ledger."""
    return re.sub(r"wan: sent=\S+ recv=\S+", "wan: sent=S recv=R", text)


def test_cluster_geo_equals_the_references(pair, monkeypatch):  # noqa: F811
    """The same scraped series in both masters' aggregators: the
    `/cluster/geo` payloads are equal but for the WAN totals, which read
    each package's own ledger, and the `geo` synthesis of a scrape tick
    writes the same `__geo__` series; both shells' `cluster.geo` print
    the same on either master."""
    from seaweedfs_tpu.server import master as ref_master_mod
    from seaweedfs_tpu.shell import commands as ref_commands
    from seaweedfs_tpu_torch.shell import commands
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    pair.start()
    synth = {}
    for m in (pair.mine, pair.ref):
        m.aggregator.per_node = _series()
        per_node = _series()
        m._geo_synth(per_node)
        synth[m is pair.mine] = per_node["__geo__"]
    assert synth[True] == synth[False]
    assert synth[True]["geo_replication_stalled"]["samples"] == [
        ("geo_replication_stalled", {"direction": "a->b"}, 1.0),
        ("geo_replication_stalled", {"direction": "b->a"}, 0.0)]
    assert ref_master_mod.MasterServer._GEO_SYNTH == \
        pair.mine._GEO_SYNTH
    (st1, mine), (st2, ref) = pair.both("/cluster/geo")
    assert st1 == st2 == 200
    for body in (mine, ref):
        body["wan"].pop("sent_bytes")
        body["wan"].pop("recv_bytes")
    assert mine == ref
    assert mine["directions"]["a->b"] == {
        "lag_s": 11.25, "backlog_events": 63.0, "stalled": 1.0,
        "applied": 360.0, "errors": 18.0}
    assert mine["divergence"]["prefixes"] == {"/p": 1.0}
    assert mine["wan"]["by_region"] == {"b": {"sent": {
        "replication": 9000.0}, "recv": {"replication": 12.0}}}
    printed = {}
    for shell_name, mod in (("port", commands), ("ref", ref_commands)):
        for master_name, m in (("port", pair.mine), ("ref", pair.ref)):
            for flags in ("", " -json"):
                buf = io.StringIO()
                mod.run_command(mod.CommandEnv(m.url),
                                "cluster.geo" + flags, buf)
                out = buf.getvalue()
                if flags:
                    d = json.loads(out)
                    d["wan"].pop("sent_bytes")
                    d["wan"].pop("recv_bytes")
                    out = json.dumps(d, sort_keys=True)
                printed[shell_name, master_name, flags] = \
                    _mask(out).replace(m.url, "M")
    for flags in ("", " -json"):
        assert len({v for k, v in printed.items() if k[2] == flags}) == 1
    text = printed["port", "port", ""]
    assert "a->b" in text and "STALLED" in text
    assert "divergence /p: DIVERGED" in text
    assert "    -> b recv=12B" in text and "    -> b sent=9000B" in text


def test_cluster_geo_without_pumps_prints_like_the_reference(pair):  # noqa: F811
    """No pump anywhere: both masters answer an empty view, and both
    shells print the reference's hint to refresh."""
    from seaweedfs_tpu.shell import commands as ref_commands
    from seaweedfs_tpu_torch.shell import commands
    pair.start()
    outs = []
    for mod, m in ((commands, pair.mine), (ref_commands, pair.ref)):
        buf = io.StringIO()
        mod.run_command(mod.CommandEnv(m.url), "cluster.geo", buf)
        outs.append(_mask(buf.getvalue()))
    assert outs[0] == outs[1]
    assert "no replication pumps reporting" in outs[0]


# ---- the divergence auditor --------------------------------------------------

def test_divergence_auditor_gauge_goes_to_one_and_back_after_a_heal(
        two_filers):
    """Two port filers differ under /au: both packages' auditors report
    `diverged` with the same digests, the port's gauge reads 1; a one-way
    sync heals the prefix and the gauge returns to 0."""
    from seaweedfs_tpu.stats import canary as ref_canary
    from seaweedfs_tpu_torch.replication.filer_sync import FilerSync
    from seaweedfs_tpu_torch.stats import canary, metrics
    c, fa, fb = two_filers
    put(fa.url, "/au/one.txt", b"1" * 300)
    put(fa.url, "/au/sub/two.txt", b"2" * 300)
    put(fb.url, "/au/one.txt", b"1" * 300)
    aud = canary.DivergenceAuditor(fa.url, fb.url, "/au")
    ref_aud = ref_canary.DivergenceAuditor(fa.url, fb.url, "/au")
    gauge = metrics.GEO_DIVERGENCE.labels("/au")
    audits = {o: metrics.GEO_AUDITS.labels(o).value
              for o in ("clean", "diverged")}
    try:
        st = aud.run_once()
        ref_st = ref_aud.run_once()
        assert st["outcome"] == ref_st["outcome"] == "diverged"
        assert st["digests"] == ref_st["digests"]
        assert gauge.value == 1
        sync = FilerSync(fa.url, fb.url, prefix="/au", one_way=True)
        sync.start()
        try:
            assert wait_for(lambda: get(fb.url, "/au/sub/two.txt")
                            == b"2" * 300)
            assert wait_for(lambda: aud.run_once()["outcome"] == "clean",
                            15)
        finally:
            sync.stop()
        assert gauge.value == 0
        assert ref_aud.run_once()["outcome"] == "clean"
        assert metrics.GEO_AUDITS.labels("diverged").value == \
            audits["diverged"] + 1
        assert metrics.GEO_AUDITS.labels("clean").value > audits["clean"]
        assert aud.status()["last"]["outcome"] == "clean"
    finally:
        aud.stop()
        ref_aud.stop()


# -- the acceptance run: two regions, WAN partition, heal, converge ------

def test_geo_chaos_acceptance(tmp_path, monkeypatch):
    """Partition the WAN, watch geo_replication_lag_s rise in
    /cluster/history and the replication_stalled rule fire on
    /cluster/alerts; heal, watch it clear; prove byte-identical digests
    via the divergence auditor; see one trace id span both regions on
    /cluster/trace/<tid>; and check the class=replication byte ledger
    conserves within 1%."""
    from seaweedfs_tpu_torch.maintenance.chaos import GeoCluster
    from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
    from seaweedfs_tpu_torch.stats import netflow
    from seaweedfs_tpu_torch.utils import resilience

    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0.5")
    monkeypatch.setenv("WEEDTPU_SYNC_STALL_AFTER", "1.5")
    monkeypatch.setenv("WEEDTPU_SYNC_BACKOFF_BASE", "0.2")
    monkeypatch.setenv("WEEDTPU_SYNC_BACKOFF_CAP", "1")
    monkeypatch.setenv("WEEDTPU_SYNC_BACKLOG_INTERVAL", "0.5")
    # deterministic audits: the test drives run_once() itself
    monkeypatch.setenv("WEEDTPU_GEO_AUDIT_INTERVAL", "0")
    # generous budget: this test proves the observatory, not the damper
    monkeypatch.setenv("WEEDTPU_RETRY_BUDGET", "20:40")
    resilience.reset_retry_budget()
    # the default rules' windows are operator-scale; shrink them so the
    # fire->clear cycle fits a test
    monkeypatch.setenv("WEEDTPU_ALERT_RULES", (
        "replication_stalled=threshold,series=geo_replication_stalled,"
        "agg=max,window=2,op=gt,value=0,for=0.4,clear_for=0.4;"
        "replication_lag_high=threshold,series=geo_replication_lag_s,"
        "agg=max,window=2,op=gt,value=1.0,for=0.4,clear_for=0.4"))

    geo = GeoCluster(tmp_path, device="cpu").start()
    try:
        ma = f"http://{geo.master('a').url}"
        sent0 = netflow.class_total("sent", "replication")
        recv0 = netflow.class_total("recv", "replication")
        wan0 = netflow.wan_total("sent")

        # healthy steady state: writes converge both ways
        geo.write("a", "/geo/from_a.txt", b"hello-from-a" * 100)
        geo.write("b", "/geo/from_b.txt", b"hello-from-b" * 100)
        assert wait_for(
            lambda: geo.read("b", "/geo/from_a.txt")[0] == 200, 20)
        assert wait_for(
            lambda: geo.read("a", "/geo/from_b.txt")[0] == 200, 20)

        # one write's trace spans BOTH regions (federated endpoint)
        assert wait_for(lambda: geo.sync.a2b.last_trace_id, 10)
        tid = geo.sync.a2b.last_trace_id
        tr = _json_get(f"{ma}/cluster/trace/{tid}")
        assert len(tr["spans"]) >= 2
        assert {"a", "b"} <= set(tr.get("regions", []))

        # /cluster/geo: both pumps reporting under region-pair labels
        st = _json_get(f"{ma}/cluster/geo?refresh=1")
        assert st["region"] == "a"
        assert geo.master("b").url in st["peers"]
        assert "a->b" in st["directions"] and "b->a" in st["directions"]
        assert "lag_s" in st["directions"]["a->b"]
        # ...and the maintenance roll-up carries the geo block
        assert "geo" in _json_get(f"{ma}/maintenance/status")
        # ...and the shell command renders it
        out = io.StringIO()
        run_command(CommandEnv(geo.master("a").url), "cluster.geo", out)
        assert "a->b" in out.getvalue()

        # -- partition the WAN, write during the outage ------------------
        geo.partition()
        geo.write("a", "/geo/during.txt", b"wrote-during-partition" * 50)

        def alert_state(name):
            st = _json_get(f"{ma}/cluster/alerts?refresh=1")
            return {r["name"]: r["state"] for r in st["rules"]}.get(name)

        # lag climbs, the pump flags itself stalled, the rule fires
        assert wait_for(lambda: alert_state("replication_stalled")
                        == "firing", 40)
        assert geo.sync.a2b.stalled
        assert geo.sync.a2b.backlog >= 1
        hist = _json_get(
            f"{ma}/cluster/history?"
            + urllib.parse.urlencode({
                "series": "geo_replication_lag_s", "range": "120",
                "agg": "max", "labels": "direction=a->b"}))
        peaks = [v for vec in hist["vectors"]
                 for _, v in vec["points"] if v is not None]
        assert peaks and max(peaks) > 1.0

        # the auditor sees the divergence (its probes aren't partitioned)
        assert geo.sync.auditor.run_once()["outcome"] == "diverged"

        # -- heal: catch up, clear, converge -----------------------------
        geo.heal()
        assert wait_for(
            lambda: geo.read("b", "/geo/during.txt")[0] == 200, 30)
        assert wait_for(lambda: alert_state("replication_stalled")
                        == "ok", 30)
        audit = geo.sync.auditor.run_once()
        assert audit["outcome"] == "clean"
        da, db = geo.digests()
        assert da == db  # byte-identical regions: the convergence proof

        # -- byte conservation: replication sent == recv within 1% -------
        time.sleep(0.5)
        sent_d = netflow.class_total("sent", "replication") - sent0
        recv_d = netflow.class_total("recv", "replication") - recv0
        assert sent_d > 0
        assert abs(sent_d - recv_d) <= 0.01 * max(sent_d, recv_d), \
            (sent_d, recv_d)
        # and the WAN ledger saw the cross-region bytes
        assert netflow.wan_total("sent") - wan0 > 0
    finally:
        geo.stop()
