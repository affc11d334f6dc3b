"""The port's chaos harness (seaweedfs_tpu_torch/maintenance/chaos.py) on
clusters that are all the port's, held to the reference's.

- The tables (`WORKLOADS`, `FAULTS`, `SELF_ENCODING_FAULTS`, `MATRIX`)
  equal the reference's by name and order, and each workload prepares
  the reference's bytes for the same seed.
- Twins of tests/test_chaos.py: the three resilience unit tests that
  had none (on the port's `resilience`), the nine tier-1 cluster tests,
  each keeping its name and its checks, and, under ``-m slow`` as in the
  reference, the whole matrix and the disk-fault encode.
- A `bit_rot` cell with every node's background scrubber on: the
  on-request scrub reads WEEDTPU_SCRUB_REMOTE at the request, so the
  flips on windows whose shards lie on other nodes are found and healed.
- After a `shard_loss` cell heals, every shard file equals what the
  reference's `write_ec_files` writes from a copy of the volume taken
  before the encode (GF arithmetic is exact: equality).

Every cluster runs its volume servers with `device="cpu"` (the plain
versions of the kernels).  `ChaosCluster.stop` clears the port's fault
plan, breakers, retry budget and latency trackers: they are module
globals that later tests in the worker would inherit.
"""

import glob
import hashlib
import io
import json
import shutil
import threading
import time

import pytest

from seaweedfs_tpu.maintenance import chaos as ref_chaos
from seaweedfs_tpu.storage.ec import ec_files as ref_ec_files

from seaweedfs_tpu_torch.maintenance import chaos, faults
from seaweedfs_tpu_torch.maintenance.chaos import (FAULTS, WORKLOADS,
                                                   encode_all_volumes,
                                                   fsck_report,
                                                   run_scenario)
from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.utils import resilience
from tests.test_chaos import _FlakyServer


def ChaosCluster(tmp_path, **kw):
    return chaos.ChaosCluster(tmp_path, device="cpu", **kw)


# ---- the tables and the workloads' bytes -----------------------------------

def test_tables_equal_reference():
    assert list(chaos.WORKLOADS) == list(ref_chaos.WORKLOADS)
    assert list(chaos.FAULTS) == list(ref_chaos.FAULTS)
    assert chaos.SELF_ENCODING_FAULTS == ref_chaos.SELF_ENCODING_FAULTS
    assert chaos.MATRIX == ref_chaos.MATRIX
    assert chaos.__all__ == ref_chaos.__all__


def _digests(name, state):
    """The sorted sha256 digests of what a workload's prepare wrote."""
    if name == "degraded_read":
        return sorted(state["blobs"].values())
    if name == "filer_stream":
        return sorted(hashlib.sha256(b).hexdigest()
                      for b in state["files"].values())
    if name == "s3_multipart":
        return [hashlib.sha256(state["content"]).hexdigest()]
    return state["sent"]


def test_workload_digests_equal_reference(tmp_path):
    """Both packages' prepares, on one port cluster, write the same
    bytes for the same seeds; the port's verify reads them back."""
    c = ChaosCluster(tmp_path, n_volume_servers=2, with_filer=True,
                     with_s3=True, with_mq=True).start()
    try:
        c.wait_heartbeats()
        for name in WORKLOADS:
            port = WORKLOADS[name][0](c)
            if name != "mq":  # a second prepare would double the topic
                WORKLOADS[name][1](c, port)
            ref = ref_chaos.WORKLOADS[name][0](c)
            assert _digests(name, port) == _digests(name, ref), name
    finally:
        c.stop()


# ---- resilience unit layer (twins of the three that had none) ---------------

def test_backoff_decorrelated_jitter_bounds():
    bo = resilience.Backoff(base=0.1, cap=2.0)
    prev = 0.1
    for _ in range(50):
        d = bo.next()
        assert 0.1 <= d <= 2.0
        assert d <= max(prev * 3.0, 0.1) + 1e-9
        prev = d
    bo.reset()
    assert bo.next() <= 0.3 + 1e-9  # back to uniform(base, 3*base)
    for n in range(1, 10):
        d = resilience.backoff_delay(n, base=0.5, cap=10.0)
        assert 0.5 <= d <= 10.0


def test_retry_call_spends_budget_and_stops(monkeypatch):
    monkeypatch.setenv("WEEDTPU_RETRY_BUDGET", "0.001:2")
    resilience.reset_retry_budget()
    try:
        calls = []

        def always_fails():
            calls.append(1)
            raise ConnectionError("nope")

        allowed0 = metrics.RETRY_TOTAL.labels("storm", "allowed").value
        denied0 = metrics.RETRY_TOTAL.labels("storm", "denied").value
        # 10 callers x attempts=5 would be 40 retries unbudgeted; the
        # 2-token budget caps TOTAL retries across all of them
        for _ in range(10):
            with pytest.raises(ConnectionError):
                resilience.retry_call(always_fails, attempts=5,
                                      base=0.001, cap=0.002, cls="storm",
                                      retry_on=(ConnectionError,))
        retries = len(calls) - 10
        assert retries <= 3, f"budget failed to cap retries: {retries}"
        allowed = metrics.RETRY_TOTAL.labels("storm", "allowed").value
        denied = metrics.RETRY_TOTAL.labels("storm", "denied").value
        assert allowed - allowed0 == retries
        assert denied - denied0 >= 7  # every later caller was refused
    finally:
        monkeypatch.delenv("WEEDTPU_RETRY_BUDGET")
        resilience.reset_retry_budget()


def test_retry_call_giveup_short_circuits():
    calls = []

    class Fatal(OSError):
        pass

    def fails():
        calls.append(1)
        raise Fatal("4xx-shaped")

    with pytest.raises(Fatal):
        resilience.retry_call(fails, attempts=5, base=0.001,
                              giveup=lambda e: isinstance(e, Fatal))
    assert len(calls) == 1


# ---- the harness without a card --------------------------------------------

def test_clusters_raise_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.ChaosCluster(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.GeoCluster(tmp_path)


# ---- deadline propagation (integration) ------------------------------------

def test_deadline_budget_fast_504(tmp_path):
    """A filer read with a 200ms budget against 500ms-delayed volume
    peers 504s fast (not a 30s hang) and books op=timeout in the trace;
    without a budget the same read succeeds (slowly)."""
    c = ChaosCluster(tmp_path, n_volume_servers=2, with_filer=True)
    c.start()
    try:
        c.wait_heartbeats()
        payload = b"deadline-test-payload " * 4096  # ~88KB, one chunk
        st, out, _ = chaos._req(f"http://{c.filer.url}/dl/test.bin",
                                method="PUT", data=payload)
        assert st in (200, 201), out
        # every hop toward a volume server now takes ~500ms
        faults.set_peer_latency("volume", 500.0)
        try:
            t0 = time.perf_counter()
            st, body, _ = chaos._req(
                f"http://{c.filer.url}/dl/test.bin",
                headers={resilience.DEADLINE_HEADER: "200"},
                timeout=30.0)
            elapsed = time.perf_counter() - t0
            assert st == 504, (st, body[:200])
            assert elapsed < 5.0, f"deadline 504 took {elapsed:.1f}s"
            assert b"deadline exceeded" in body
            # the trace booked the timeout on the filer hop
            st, tr, _ = chaos._req(
                f"http://{c.filer.url}/debug/traces?limit=200")
            spans = [s for rec in json.loads(tr)["traces"]
                     for s in rec["spans"]
                     if s["name"] == "filer.request"
                     and (s.get("attrs") or {}).get("op") == "timeout"]
            assert spans, "no filer.request span with op=timeout"
            # no budget -> the read still completes, just slowly
            st, body, _ = chaos._req(
                f"http://{c.filer.url}/dl/test.bin", timeout=30.0)
            assert st == 200 and body == payload
        finally:
            faults.clear_net()
    finally:
        c.stop()


def test_retry_storm_capped_under_total_failure(tmp_path, monkeypatch):
    """100% error-rate fault toward a peer: N concurrent retry_call
    users generate at most budget-many total retries (no storm)."""
    from seaweedfs_tpu_torch.utils.http import PooledHTTP
    monkeypatch.setenv("WEEDTPU_RETRY_BUDGET", "0.001:3")
    resilience.reset_retry_budget()
    srv = _FlakyServer()
    try:
        faults.set_peer_error_rate(f"127.0.0.1:{srv.port}", 100.0)
        pool = PooledHTTP(timeout=1.0)
        dials0 = len(srv.requests)
        attempts = []

        def one_call():
            def req():
                attempts.append(1)
                return pool.request(f"http://127.0.0.1:{srv.port}/x")
            try:
                resilience.retry_call(req, attempts=6, base=0.001,
                                      cap=0.01, cls="storm2",
                                      retry_on=(OSError,))
            except OSError:
                pass

        threads = [threading.Thread(target=one_call) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        # 12 callers x 6 attempts = 72 unbudgeted; the 3-token budget
        # bounds retries to first-attempts + ~burst
        assert len(attempts) <= 12 + 5, f"retry storm: {len(attempts)}"
        assert len(srv.requests) == dials0  # injected fault: no dial landed
        pool.close()
    finally:
        faults.clear_net()
        resilience.reset_retry_budget()
        srv.close()


# ---- partition hardening (aggregator + canary + trace fan-out) -------------

def test_partition_degrades_aggregator_and_canary(tmp_path):
    """A partitioned node costs the aggregator one timeout (not the
    pool), is marked stale via weedtpu_agg_scrape_age_seconds, the trace
    fan-out degrades to node_errors, and a canary probe failure during
    the partition still records its outcome + pinned trace."""
    c = ChaosCluster(tmp_path, n_volume_servers=2, with_filer=False)
    c.start()
    # the metrics registry is process-global: restore the canary probe
    # counters afterwards or this test's deliberate probe FAILURES leak
    # into later tests' fresh-cluster SLO evaluations as ambient 5xx
    probe_counts = [(metrics.CANARY_PROBES.labels("blob", cls),
                     metrics.CANARY_PROBES.labels("blob", cls).value)
                    for cls in ("2xx", "5xx")]
    try:
        c.wait_heartbeats()
        master = c.leader()
        agg = master.aggregator
        agg.scrape_once()
        assert not agg.errors, agg.errors
        # partition the master away from every volume server
        for vs in c.volume_servers:
            faults.add_partition("master", vs.url)
        t0 = time.perf_counter()
        agg.scrape_once()
        scrape_s = time.perf_counter() - t0
        assert scrape_s < 15.0, f"partitioned scrape took {scrape_s:.1f}s"
        assert set(agg.errors) == {vs.url for vs in c.volume_servers}
        time.sleep(0.4)
        render = agg.render()
        for vs in c.volume_servers:
            assert f'weedtpu_agg_scrape_age_seconds{{node="{vs.url}"}}' \
                in render
        # trace fan-out degrades, never raises
        wf = master.collect_trace("0" * 32)
        assert set(wf.get("node_errors", {})) == \
            {vs.url for vs in c.volume_servers}
        # a canary probe through the partition fails but is RECORDED,
        # with its pinned trace id ready for the waterfall
        import asyncio
        fut = asyncio.run_coroutine_threadsafe(
            master.canary.run_once(("blob",)), c.loop)
        fut.result(60)
        blob = master.canary.state.get("blob")
        assert blob is not None and blob["outcome"] == "fail", blob
        assert blob["trace_id"]
        from seaweedfs_tpu_torch.stats import trace as trace_mod
        assert blob["trace_id"] in trace_mod.pinned_ids()
    finally:
        for child, v0 in probe_counts:
            child.value = v0
        faults.clear_net()
        c.stop()


# ---- the fast smoke scenario (tier-1) --------------------------------------

def test_smoke_restart_during_degraded_read(tmp_path):
    """Volume server restarts mid-flight while degraded reads are being
    served; every read that succeeds is byte-identical, after recovery
    every read succeeds, and fsck ends clean."""
    c = ChaosCluster(tmp_path, n_volume_servers=2, with_filer=True)
    c.start()
    try:
        c.wait_heartbeats()
        state = WORKLOADS["degraded_read"][0](c)
        encode_all_volumes(c)
        # drop shards on vs0 so reads reconstruct (degraded path)
        vs = c.volume_servers[0]
        for vid in chaos._ec_vids_on(vs):
            ev = vs.store.get_ec_volume(vid)
            for sid in ev.shard_ids()[:2]:
                faults.delete_shard(vs.store, vid, sid)
        c.submit(vs._heartbeat_once())

        stop = threading.Event()
        wrong: list[str] = []

        def reader():
            client = c.client()
            fids = list(state["blobs"])
            i = 0
            while not stop.is_set():
                fid = fids[i % len(fids)]
                i += 1
                try:
                    got = client.download(fid)
                except Exception:
                    continue  # failing during the restart is allowed
                if hashlib.sha256(got).hexdigest() != state["blobs"][fid]:
                    wrong.append(fid)  # wrong BYTES never are

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        time.sleep(0.5)
        c.restart_volume_server(1, downtime=0.3)
        time.sleep(0.5)
        stop.set()
        t.join(10)
        assert not wrong, f"reads returned wrong bytes: {wrong}"
        c.wait_heartbeats()
        WORKLOADS["degraded_read"][1](c, state)  # all blobs, byte-identical
        rep = fsck_report(c)
        assert rep.get("ok") is True, rep.get("states")
    finally:
        c.stop()


# ---- reduced-read repair under correlated failure (tier-1) -----------------

def test_rack_loss_reduced_repair_traffic(tmp_path, monkeypatch):
    """Correlated rack-scoped loss (2 shards die together on one rack)
    on a rack-labeled cluster: the reduced-read heal moves <= 0.6x the
    repair bytes of the naive survivor-copy heal over the SAME loss
    shape, readback stays byte-identical, fsck ends clean, and the
    planner's survivor-selection decisions + cross-rack budget state
    surface in /maintenance/status."""
    c = ChaosCluster(tmp_path, n_volume_servers=3, with_filer=True,
                     racks=["r0", "r0", "r1"])
    c.start()
    try:
        c.wait_heartbeats()
        state = WORKLOADS["degraded_read"][0](c)
        encode_all_volumes(c)

        def lose_rack_pair() -> int:
            vids = sorted({vid for vs in c.volume_servers
                           if vs is not None
                           for vid in chaos._ec_vids_on(vs)})
            lost = 0
            for vid in vids:
                for svr, sid in chaos.shards_on_rack(c, vid, "r1")[:2]:
                    faults.delete_shard(svr.store, vid, sid)
                    lost += 1
            for vs in c.volume_servers:
                if vs is not None:
                    c.submit(vs._heartbeat_once())
            time.sleep(2 * c.heartbeat_interval + 0.2)
            return lost

        # reduced arm first (fresh, even shard layout)
        monkeypatch.setenv("WEEDTPU_REPAIR_REDUCED", "1")
        lost_reduced = lose_rack_pair()
        assert lost_reduced >= 2, "rack r1 held too few shards to lose"
        b0 = chaos.repair_recv_bytes()
        chaos.heal_until_clean(c)
        reduced = chaos.repair_recv_bytes() - b0
        WORKLOADS["degraded_read"][1](c, state)  # byte-identical

        st, body, _ = chaos._req(
            f"http://{c.leader().url}/maintenance/status")
        assert st == 200
        planner = json.loads(body)["planner"]
        modes = [d["mode"] for d in planner["decisions"]]
        assert "reduced" in modes, modes
        red_dec = [d for d in planner["decisions"]
                   if d["mode"] == "reduced"][-1]
        assert red_dec["helpers"], red_dec
        assert all("locality" in h for h in red_dec["helpers"])
        assert red_dec.get("actual_bytes", 0) > 0
        assert "xrack" in planner and \
            planner["xrack"]["burst_bytes"] > 0

        # naive arm over the same correlated-loss shape
        monkeypatch.setenv("WEEDTPU_REPAIR_REDUCED", "0")
        lost_naive = lose_rack_pair()
        assert lost_naive >= 2
        b0 = chaos.repair_recv_bytes()
        chaos.heal_until_clean(c)
        naive = chaos.repair_recv_bytes() - b0
        WORKLOADS["degraded_read"][1](c, state)

        # scale to equal losses before comparing (layout drift can vary
        # the per-arm loss count by a shard or two)
        ratio = (reduced / max(lost_reduced, 1)) / \
            max(naive / max(lost_naive, 1), 1e-9)
        assert ratio <= 0.6, \
            f"reduced heal moved {ratio:.2f}x naive repair bytes " \
            f"({reduced}B/{lost_reduced} vs {naive}B/{lost_naive})"

        rep = fsck_report(c)
        assert rep.get("ok") is True, rep.get("states")
    finally:
        c.stop()


def test_helper_death_mid_rebuild_replans(tmp_path):
    """A helper node dies while serving partial-sum fetches mid-rebuild:
    the repair re-plans (or backs off and retries) to convergence,
    readback is byte-identical, fsck is clean, and no partial .tmp
    shard survives anywhere (asserted inside the fault cell)."""
    c = ChaosCluster(tmp_path, n_volume_servers=2, with_filer=True)
    c.start()
    try:
        c.wait_heartbeats()
        report = run_scenario(c, "degraded_read",
                              "helper_death_mid_rebuild")
        assert report["fault"] == "helper_death_mid_rebuild"
    finally:
        c.stop()


def test_move_mid_failure_aborts_clean(tmp_path):
    """The autopilot balancing actuator's abort contract: killing the
    move target mid-transfer leaves no partial state on either side,
    the source keeps serving byte-identically, the restarted target
    boots with no orphan files, and the re-run move completes — all
    asserted inside the fault cell, plus run_scenario's byte-identical
    readback and clean fsck."""
    c = ChaosCluster(tmp_path, n_volume_servers=2, with_filer=True)
    c.start()
    try:
        c.wait_heartbeats()
        report = run_scenario(c, "degraded_read", "move_mid_failure")
        assert report["fault"] == "move_mid_failure"
    finally:
        c.stop()


# ---- chaos.status + fsck gate ----------------------------------------------

def test_chaos_status_and_fsck_gate(tmp_path):
    """chaos.status summarizes breakers/faults/budget; fsck -json flips
    ok:false (nonzero rc) when corruption is quarantined, and back to
    ok:true after the heal."""
    from seaweedfs_tpu_torch.shell.commands import run_command
    c = ChaosCluster(tmp_path, n_volume_servers=2, with_filer=True)
    c.start()
    try:
        c.wait_heartbeats()
        state = WORKLOADS["degraded_read"][0](c)
        encode_all_volumes(c)
        rep = fsck_report(c)
        assert rep["ok"] is True and rep["rc"] == 0

        # silent corruption: scrub quarantines it -> fsck must fail
        vs = c.volume_servers[0]
        vids = chaos._ec_vids_on(vs)
        assert vids
        ev = vs.store.get_ec_volume(vids[0])
        faults.flip_bit(vs.store, vids[0], ev.shard_ids()[0], offset=1 << 14)
        c.scrub_all()
        rep = fsck_report(c)
        assert rep["ok"] is False and rep["rc"] == 1, rep.get("states")

        # chaos.status shows the armed fault + budget + breaker summary
        faults.add_partition("filer", "volume")
        env = c.shell_env()
        out = io.StringIO()
        run_command(env, "chaos.status", out)
        text = out.getvalue()
        assert "retry budget" in text
        assert "partition filer<->volume" in text
        assert "xrack budget" in text  # reduced-repair plane state
        faults.clear_net()

        # heal and re-verify the gate goes green
        chaos.heal_until_clean(c)
        c.scrub_all()
        rep = fsck_report(c)
        assert rep["ok"] is True, rep.get("states")
        WORKLOADS["degraded_read"][1](c, state)
    finally:
        c.stop()


# ---- noisy-neighbor tenant QoS smoke ---------------------------------------

def test_noisy_neighbor_smoke(tmp_path):
    """Tier-1 smoke for the noisy-neighbor cell: one abusive tenant
    hammering the s3 edge is shed with 429s while the victim tenant's
    reads stay error-free inside their latency bound, and the scenario
    workload (a second tenant) verifies byte-identical during the noise.
    encode=False keeps it fast; the EC-encoded variants run in the slow
    matrix."""
    c = ChaosCluster(tmp_path, n_volume_servers=2, with_filer=True,
                     with_s3=True)
    c.start()
    try:
        c.wait_heartbeats()
        report = run_scenario(c, "s3_multipart", "noisy_neighbor",
                              encode=False)
        assert report["fault"] == "noisy_neighbor"
        # the per-tenant ledger survived the fault's config restore:
        # the abuser was shed at the edge, the victim never was
        assert c.s3.qos.shed_by_tenant.get("noisy-bucket", 0) > 10
        assert c.s3.qos.shed_by_tenant.get("victim-bucket", 0) == 0
        assert c.s3.qos.shed_by_tenant.get("chaos-bucket", 0) == 0
        # admission was restored to its pre-fault (disabled) state
        assert not c.s3.qos.enabled
    finally:
        c.stop()


# ---- the remote scrub under a background scrubber --------------------------

def test_bit_rot_found_by_remote_scrub_with_background_scrubber(
        tmp_path, monkeypatch):
    """Every node runs its background scrubber, built while
    WEEDTPU_SCRUB_REMOTE was unset.  The harness's scrub turns the
    switch on around each /admin/scrub; the pass reads it at the
    request, so every flip (on a window whose shards lie on two nodes)
    is localised, fsck flips to ok:false, and the heal restores the
    bytes.  A pass that kept the switch of construction scans no window
    and finds nothing."""
    monkeypatch.delenv("WEEDTPU_SCRUB_MBPS", raising=False)
    monkeypatch.delenv("WEEDTPU_SCRUB_REMOTE", raising=False)
    c = ChaosCluster(tmp_path, n_volume_servers=2, with_filer=True)
    c.start()
    try:
        c.wait_heartbeats()
        for vs in c.volume_servers:
            assert vs.scrubber is not None and not vs.scrubber.remote
        state = WORKLOADS["degraded_read"][0](c)
        vids = encode_all_volumes(c)
        vs = c.volume_servers[0]
        flipped = chaos._ec_vids_on(vs)
        assert flipped == vids
        for vid in flipped:
            ev = vs.store.get_ec_volume(vid)
            assert len(ev.shard_ids()) < 14  # the windows need a peer
            faults.flip_bit(vs.store, vid, ev.shard_ids()[0], offset=4096)
        c.scrub_all()
        led = c.leader().maintenance.ledger()
        assert all(led[vid]["state"] == "corrupt" for vid in flipped), led
        assert fsck_report(c)["ok"] is False
        chaos.heal_until_clean(c)
        c.scrub_all()
        WORKLOADS["degraded_read"][1](c, state)
        rep = fsck_report(c)
        assert rep.get("ok") is True, rep.get("states")
    finally:
        c.stop()


# ---- shard files against the reference's encoder ---------------------------

def test_healed_shards_equal_reference_encode(tmp_path, monkeypatch):
    """Copy every volume's .dat/.idx before the encode; after a
    `shard_loss` cell heals, each shard file on the cluster equals the
    reference's `write_ec_files` of that copy, byte for byte."""
    c = ChaosCluster(tmp_path, n_volume_servers=2, with_filer=True)
    c.start()
    try:
        c.wait_heartbeats()
        state = WORKLOADS["degraded_read"][0](c)
        ref_dir = tmp_path / "ref"
        ref_dir.mkdir()
        copied = []
        for vs in c.volume_servers:
            for loc in vs.store.locations:
                for vid, v in loc.volumes.items():
                    v.flush()
                    for ext in (".dat", ".idx"):
                        shutil.copy(v._base + ext, ref_dir / f"{vid}{ext}")
                    copied.append(vid)
        vids = encode_all_volumes(c)
        assert sorted(copied) == sorted(vids)
        chaos.FAULTS["shard_loss"](c, {})
        WORKLOADS["degraded_read"][1](c, state)
        assert fsck_report(c).get("ok") is True
        with monkeypatch.context() as mp:
            mp.setenv("WEEDTPU_EC_CODEC", "numpy")
            for vid in vids:
                ref_ec_files.write_ec_files(str(ref_dir / str(vid)))
        for vid in vids:
            found = {}
            for i in range(c.n):
                for p in glob.glob(str(tmp_path / f"vs{i}" / f"{vid}.ec[0-9][0-9]")):
                    found[int(p[-2:])] = p
            assert sorted(found) == list(range(14)), (vid, sorted(found))
            for sid, p in found.items():
                with open(p, "rb") as f, \
                        open(ref_dir / f"{vid}.ec{sid:02d}", "rb") as g:
                    assert f.read() == g.read(), (vid, sid)
    finally:
        c.stop()


# ---- the full scenario matrix (slow, as the reference's) -------------------

def _cluster_for(tmp_path, workload: str, fault: str):
    racks = ["r0", "r0", "r1"] if fault == "rack_loss" else None
    return ChaosCluster(
        tmp_path, n_volume_servers=3 if racks else 2,
        n_masters=3 if fault == "master_failover" else 1,
        with_filer=True,
        with_s3=workload == "s3_multipart",
        with_mq=workload == "mq",
        racks=racks)


@pytest.mark.slow
@pytest.mark.parametrize("workload,fault",
                         [(w, f) for w in WORKLOADS for f in FAULTS])
def test_chaos_matrix(tmp_path, workload, fault):
    c = _cluster_for(tmp_path, workload, fault).start()
    try:
        c.wait_heartbeats()
        report = run_scenario(c, workload, fault)
        assert report["workload"] == workload
    finally:
        c.stop()


@pytest.mark.slow
def test_disk_fault_encode_fails_clean(tmp_path):
    """shard_write_error makes EC encode fail like a dying disk; the
    volume keeps serving from its .dat and a later encode succeeds."""
    c = ChaosCluster(tmp_path, n_volume_servers=1, with_filer=True)
    c.start()
    try:
        c.wait_heartbeats()
        state = WORKLOADS["degraded_read"][0](c)
        vs = c.volume_servers[0]
        vids = sorted({vid for loc in vs.store.locations
                       for vid in loc.volumes})
        faults.set_shard_write_error("EIO")
        st, out, _ = chaos._req(
            f"http://{vs.url}/admin/ec/generate", method="POST",
            data=json.dumps({"volume": vids[0]}).encode(),
            headers={"Content-Type": "application/json"}, timeout=120.0)
        assert st >= 500, (st, out)
        faults.clear_net()
        WORKLOADS["degraded_read"][1](c, state)  # reads fine off the .dat
        encode_all_volumes(c)  # disarmed: encode succeeds now
        WORKLOADS["degraded_read"][1](c, state)
        rep = fsck_report(c)
        assert rep["ok"] is True, rep.get("states")
    finally:
        c.stop()
