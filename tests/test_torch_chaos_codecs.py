"""Twins of tests/test_codecs.py's chaos cells on port clusters: an LRC
volume losing a whole local-group slice, an MSR cluster whose helper
dies mid-repair, and a cluster mixing the three codec families healed
and fsck-clean.  Each keeps its reference's name and checks; the
harness is the port's (seaweedfs_tpu_torch/maintenance/chaos.py), its
volume servers on the CPU.
"""

import io

import numpy as np

from seaweedfs_tpu_torch.ops import lrc


# ---- cluster layer: chaos cells per codec ------------------------------


def test_lrc_group_loss_heals_clean(tmp_path, monkeypatch):
    """Chaos cell: an LRC volume loses a whole local-group slice (a
    data shard AND its group's local parity — the local-repair path is
    dead, global decode must carry the heal).  The cluster heals to
    byte-identical readback and a clean fsck."""
    from seaweedfs_tpu_torch.maintenance import chaos, faults
    from seaweedfs_tpu_torch.maintenance.chaos import (ChaosCluster, WORKLOADS,
                                                 encode_all_volumes,
                                                 fsck_report,
                                                 heal_until_clean)
    monkeypatch.setenv("WEEDTPU_CODEC_DEFAULT", "lrc_10_2_2")
    code = lrc.get_code(10, 2, 2)
    c = ChaosCluster(tmp_path, n_volume_servers=2, with_filer=True,
                     device="cpu")
    c.start()
    try:
        c.wait_heartbeats()
        state = WORKLOADS["degraded_read"][0](c)
        encode_all_volumes(c)
        # kill one group-0 data shard AND the group's local parity (10),
        # cluster-wide: two losses in ONE group — local repair is dead,
        # the heal must decode through the global parities.  Never more
        # than two (the fan-out would exceed LRC's tolerance of 3).
        doomed: dict[int, set[int]] = {}
        for vs in c.volume_servers:
            for vid in chaos._ec_vids_on(vs):
                ev = vs.store.get_ec_volume(vid)
                assert ev.codec_tag == "lrc_10_2_2"
                held = set(ev.shard_ids())
                kill = doomed.setdefault(vid, set())
                if code.k in held and code.k not in kill \
                        and len(kill) < 2:
                    kill.add(code.k)  # shard 10: group 0's local parity
                    faults.delete_shard(vs.store, vid, code.k)
                data = sorted(held & set(range(code.r)))
                if data and len(kill) < 2:
                    kill.add(data[0])
                    faults.delete_shard(vs.store, vid, data[0])
            c.submit(vs._heartbeat_once())
        assert any(len(k) == 2 for k in doomed.values()), doomed
        import time as _t
        _t.sleep(2 * c.heartbeat_interval + 0.2)
        heal_until_clean(c)
        WORKLOADS["degraded_read"][1](c, state)  # byte-identical
        rep = fsck_report(c)
        assert rep.get("ok") is True, rep.get("states")
    finally:
        c.stop()


def test_msr_helper_death_mid_repair(tmp_path, monkeypatch):
    """Chaos cell: an MSR-coded cluster loses shards, the regenerating
    repair launches, and a helper node dies mid-fetch.  The repair
    re-plans around the corpse (tmp+rename: no partial shard may
    survive), readback is byte-identical, fsck is clean."""
    from seaweedfs_tpu_torch.maintenance.chaos import ChaosCluster, run_scenario
    monkeypatch.setenv("WEEDTPU_CODEC_DEFAULT", "msr_9_16")
    c = ChaosCluster(tmp_path, n_volume_servers=2, with_filer=True,
                     device="cpu")
    c.start()
    try:
        c.wait_heartbeats()
        report = run_scenario(c, "degraded_read",
                              "helper_death_mid_rebuild")
        assert report["fault"] == "helper_death_mid_rebuild"
    finally:
        c.stop()


def test_mixed_codec_cluster_heal_and_fsck(tmp_path):
    """ACCEPTANCE: volumes carrying DIFFERENT codecs coexist on one
    cluster — each volume is encoded with its own family via
    `ec.encode -codec`, one shard of every volume dies, the heal
    converges per-codec, readback is byte-identical, fsck ends clean,
    and the master's perf report shows the codec mix."""
    from seaweedfs_tpu_torch.maintenance import chaos, faults
    from seaweedfs_tpu_torch.maintenance.chaos import (ChaosCluster, WORKLOADS,
                                                 fsck_report,
                                                 heal_until_clean)
    from seaweedfs_tpu_torch.shell.commands import run_command
    c = ChaosCluster(tmp_path, n_volume_servers=2, with_filer=True,
                     device="cpu")
    c.start()
    try:
        c.wait_heartbeats()
        state = WORKLOADS["degraded_read"][0](c)
        # two extra collections force extra volumes so all THREE codec
        # families actually coexist on the cluster
        import hashlib as _hl
        rng = np.random.default_rng(0x3C0)
        client = c.client()
        extra = {}
        for col in ("mixa", "mixb"):
            for i in range(6):
                data = rng.integers(0, 256, int(rng.integers(2000, 30000)),
                                    dtype=np.uint8).tobytes()
                fid = client.upload(data, name=f"{col}{i}.bin",
                                    collection=col)
                extra[fid] = _hl.sha256(data).hexdigest()
        with c.leader().topo._lock:
            vols = sorted({(vid, v.collection)
                           for node in c.leader().topo.nodes.values()
                           for vid, v in node.volumes.items()})
        assert len(vols) >= 3, vols
        rotation = ["lrc_10_2_2", "msr_9_16", "rs_10_4"]
        env = c.shell_env()
        out = io.StringIO()
        run_command(env, "lock", out)
        try:
            for i, (vid, col) in enumerate(vols):
                cmd = (f"ec.encode -volumeId {vid} "
                       f"-codec {rotation[i % 3]}")
                if col:
                    cmd += f" -collection {col}"
                run_command(env, cmd, out)
        finally:
            run_command(env, "unlock", out)
        import time as _t
        _t.sleep(2 * c.heartbeat_interval + 0.2)

        # every volume reports its own codec tag in the heartbeat
        want = {vid: rotation[i % 3] for i, (vid, _) in enumerate(vols)}
        seen = {}
        for vs in c.volume_servers:
            for vid in chaos._ec_vids_on(vs):
                ev = vs.store.get_ec_volume(vid)
                seen[vid] = ev.codec_tag
                faults.delete_shard(vs.store, vid, ev.shard_ids()[0])
            c.submit(vs._heartbeat_once())
        for vid, tag in seen.items():
            assert tag == want[vid], (vid, tag, want[vid])
        _t.sleep(2 * c.heartbeat_interval + 0.2)

        heal_until_clean(c)
        WORKLOADS["degraded_read"][1](c, state)  # byte-identical
        for fid, digest in extra.items():
            assert _hl.sha256(client.download(fid)).hexdigest() == digest
        rep = fsck_report(c)
        assert rep.get("ok") is True, rep.get("states")
        # fsck -json rows carry the per-volume codec tag...
        tagged = 0
        for vid_s, rec in rep.get("volumes", {}).items():
            if int(vid_s) in want and \
                    (rec.get("health") or {}).get("kind") == "ec":
                assert rec.get("codec") == want[int(vid_s)], (vid_s, rec)
                tagged += 1
        assert tagged == len(want), rep.get("volumes")
        # ...and the master's perf report aggregates the mix
        perf = c.leader().collect_perf()
        mix = perf.get("codecs", {}).get("mix", {})
        assert set(mix) == {want[v] for v in want}, mix
    finally:
        c.stop()
