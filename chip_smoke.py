#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: build the kernels, hold
each against its plain PyTorch version, then drive the EC data plane end
to end and check every byte.

    python3 chip_smoke.py [--seed N] [--volume-mib MIB] [--trace-dir DIR]

Phases (any failure ends the run with a non-zero exit and no result line):

  1 build      nvcc/g++ build of seaweedfs_tpu_torch/csrc, all at once
               (the GF kernel at the default launch tile and, tiled, at
               the others, the needle checksum, the native host codec,
               the chunk cipher), started before torch's import, which it
               overlaps
  2 kernel     the GF(2^8) kernel against gf_apply_plain, byte for byte:
               timed at the paths' shapes (encode, rebuild, degraded
               reads, the fleet's unit batches, repair's partials, MSR's
               [72,72] parity and [8,72] decode, LRC's [1,5] local
               decode, LRC's [1,4] repair partial, MSR repair's [6,48]
               helper partial and [8,6] post) with CUDA events beside its
               byte bound and the
               plain version's time; untimed at m = 1..16, k =
               1..9/17/32, m in {17, 32, 33, 72} x k in {33, 64, 72, 200}
               (row blocks of 16), MSR repair's [c,8c] and [8,c] for c =
               4..6, ragged n, strided and unaligned views,
               a batched [4,72,n], and the codec on a contiguous [10, 700]
  3 write      a volume of needles (sizes uniform in 4 KB..1 MB, data from
               --seed) through Volume.append_needle, on a thread while
               the kernels build (joined before phase 2)
  4 encode     write_ec_files + write_sorted_ecx; sampled stripe rows, cut
               by the layout's definition, held against the .dat (data
               shards) and the plain version (parity shards); sha256 of
               the 14 shards kept
  5 degraded   .ec00/.ec03/.ec10/.ec12 deleted; every needle touching a
               lost data shard (and more, >= 200) read through
               EcVolume.read_needle, CRC checked, bytes compared
  6 rebuild    rebuild_ec_files; rebuilt shards' sha256 == the originals'
  7 fleet      convert_volumes over four volumes (the phase-3 .dat and
               volumes of one needle of random bytes each, .dat of 256
               MiB, 100 MiB + 12 352 B and 65 536 B): one K2 launch per
               batch of 4 units, launches against the count the layout
               predicts, every stripe row of the three small volumes
               checked, the 1 GiB volume's shards sha256-equal to phase
               4's, each .vif byte-equal to the reference fleet's, every
               shard's sha256 kept for phase 17; then the 1 GiB volume
               again at 64 MiB large blocks (one large row: [4,10,16MiB]
               launches)
  8 scrub      syndrome_scan of the phase-4 shard set: clean, then with a
               byte flipped in shards 5 and 11 (two ranges, localised),
               then with shard 12 aside (a flip found, not localised)
  9 repair     rebuild_ec_reduced of the phase-4 shard set: the repairing node
               holds links of shards 0-5, helper "a:1" (same rack) 6-8 and
               "b:2" (other DC) 9-13, each helper's partial computed on
               the card by a stand-in of the volume server's; lost [3] at
               d = 10, at d = None, lost [1, 12], and [3] with "a:1" dying
               mid-repair; every rebuilt shard sha256-equal to phase 4's,
               measured bytes per node against the plan's prediction and
               the stand-in's own count, K1 launches against the count
               the segment-cut rule predicts
 10 codecs     the phase-3 .dat (linked) encoded as lrc_10_2_2 and as
               msr_9_16 (write_ec_files(codec_tag=...)): sampled stripe
               rows held against the .dat (data shards) and numpy's GF
               product of the code's parity matrix (parity shards, MSR
               after de-interleave); degraded reads (LRC: shard 2 alone,
               every gathered set inside its local group, then [2, 5, 11];
               MSR: [0, 13]); rebuild_ec_files sha256-equal to the encode;
               syndrome_scan clean, then a flip (LRC localised, MSR -1);
               K1 launches against the count the layout and the 16-row
               block split predict.  Right after each encode,
               rebuild_ec_reduced on links of its shards, the helpers a
               stand-in on the card reading sub-rows for MSR: LRC [2]
               inside its group, [12] at d = 10, [12] at d = None (the
               reference's ValueError, ROADMAP fault 3.5); MSR, on four
               nodes, [0], [0, 13], and [0] with "c:3" dying mid-repair;
               checked as phase 9's runs.  It runs in a child process of
               its own (`--codecs-worker`, its own launch counts, the
               needles drawn again from --seed) over a copy of the
               phase-3 .dat: started during phase 13, it waits for
               phase 13's end, then runs beside the records and phases
               14 and 15; its lines are printed when it is joined, after
               phase 15's
 11 native     the native host codec (WEEDTPU_EC_CODEC=native) on this
               card's host: the CPU's model, cores and auto impl; its
               product at [4,10]@[10,1MiB] and @[10,16MiB] under AVX2
               (and GFNI where the CPU has it) byte-equal to K1's output
               and the plain version's on phase 2's inputs, then timed;
               the reference's AVX2 baseline (256 KiB strips, 14 files
               written in the loop, best of 3: baseline_refshape_gbps);
               the phase-3 .dat encoded under AVX2 and under auto, each
               from no shard set and sha256-equal to phase 4's; phase
               5's degraded reads and phase 6's loss rebuilt
               host-serial, sha256-equal; no kernel launched;
               the card-vs-CPU ratios of this call (warm encode over
               native AVX2 pipelined and over the baseline, rebuild over
               host-serial) beside the card's name and power limit and
               the CPU's model
 12 writer    the host write engine (storage/aio.py) on this card's host:
               engine_info(), the work directory's filesystem and whether
               O_DIRECT opens and writes there; the phase-3 .dat encoded
               on the card (each from no shard set) under WEEDTPU_AIO =
               pwritev, uring and uring + WEEDTPU_AIO_DIRECT=1,
               and by the native codec under pwritev and uring + direct
               (its registered parity ring: WRITE_FIXED), each arm's shard
               set sha256-equal to phase 4's and phase 6's loss rebuilt
               under the same mode, sha256-equal; the arms that need the
               ring are skipped, and said so, where io_uring's probe
               fails; then phase 7's four volumes converted with the
               submission batcher (the default WEEDTPU_EC_FLUSH_BYTES)
               and without it (=1, a flush per unit), each arm in a child
               process of its own, interleaved A B A B, every shard
               set sha256-equal across runs and the phase-3 volume's to
               phase 4's; launches zeroed before the phase (the children
               report theirs) and held against the layout's count
 13 telemetry  under one sampled root trace (stats/trace.py): phase 4's
               warm encode from no shard set (host stacks sampled by
               stats/profile.SamplingProfiler), 50 of phase 5's degraded
               reads, phase 6's loss rebuilt, one fleet conversion of
               phase 7's four volumes and one scrub window; the spans
               counted by name; the kernel profile's rows held against
               the launches (encode_parity calls == K1, fleet_encode
               calls == K2) and the layout (encode_parity bytes == the
               padded .dat, shard_write bytes == the .dat and the parity
               columns written); the encode and the rebuild again under
               utils/grace.torch_profile, the trace's K1 kernel events
               held against the counted launches, and each one's device
               busy and idle share (the union of kernel and copy
               intervals over its wall clock) with its top device ops;
               the kernel table, the pipeline jobs with their bottleneck
               verdicts, the roofline against measured ceilings (device:
               K1 at [10,16MiB] from phase 2; h2d, d2h: the fastest of
               ten 256 MiB pinned copies), and the encode's and
               rebuild's K1, H2D and D2H shares from the trace's own
               device intervals against published peaks (HBM's byte
               bound, PCIe Gen5 x16), no share over 1.05; the seam's
               bookkeeping per dispatch timed alone; the warm encode
               with pipeline jobs on and off (WEEDTPU_PERF_OBS=1 and =0),
               A B A B A B, and the median ratio; every shard set
               sha256-equal to phase 4's; every line with the card's
               name and power limit
 14 store      one storage node's volume lifecycle through Store (device
               left at its default), after the records below: boot under
               the mmap backend over one crash leftover of each kind and
               a half-moved copy, with the phase-3 volume linked into
               location A, every needle read back (cookies checked) and
               those of 64 KB or less through read_needle_inline too;
               69 632 needles of 1 KiB (weed benchmark's -size 1024,
               reduced from its -n 1048576) written into location B, a
               merge of the compact needle map and 4096 past it, a
               reboot, 4096 sampled
               reads, the volume reopened sorted_file (reads equal, a
               write refused); every fourth needle of volume 1 deleted and
               the volume compacted (revision + 1, size = super block +
               the live records, every live needle equal, every deleted
               one KeyError); write_ec_files of the compacted volume, .dat
               and .idx removed, a reboot mounting the EcVolume, its
               heartbeat; shards 0, 3, 10, 12 lost, every needle on a
               lost data shard read degraded, 16 more deleted on the EC
               volume (.ecj); decode in handle_ec_to_volume's order
               (rebuild_ec_files, find_dat_file_size, write_dat_file,
               write_idx_from_ecx), the .dat sha256-equal to the
               compacted, the shard set dropped, a reboot mounting a
               Volume whose deleted needles all raise; tier_move to a
               local remote (reads through RemoteFile, writes refused),
               a reboot (the store leaves a .tier-only volume unmounted,
               as the reference: ROADMAP fault 3.6), the volume mounted
               from its marker, tier_download sha256-equal; K1 launches
               held against the layout's encode units, one per degraded
               read and the rebuild's chunks; every line with the card's
               name and power limit
 15 remote     degraded reads with shards on peers, through
               Store.read_needle(shard_reader=...) on the card, on nodes
               of hard links of phase 4's shard set; the peers are
               stand-ins of the volume server's shard-read endpoint
               (ThreadingHTTPServer on loopback), the reader a stand-in
               of its shard reader (a static table, the port's
               PooledHTTP): (1) A holds 4-13, B 0-3, every third needle
               on 0-3 read; (2) A 2-13, B 0-1 answering 0.35 s late, 16 needles
               (drawn from those whose bytes on 0-1 fit 1/16 of the
               reconstruction LRU), 4 of them with hedging off, then the
               16 with it on (WEEDTPU_HEDGE_PCT=99,
               WEEDTPU_HEDGE_MAX_MS=100); (3) the 16 again from the LRU;
               (4) 4 needles on 0 and 1 from a
               node holding 2-10, rescued by the abandoned fetches; (5) B
               down: the 16 reconstructed, B's breaker open; (6) 128
               bytes of shard 2 flipped, found by syndrome_scan,
               quarantined, the needles over it read, restored; (7)
               skip_shards={0} on 16 needles; (8) in 8 threads, 256 of
               step 1's needles with B up, then 384 with B down;
               K1 per step against its
               prediction, the hedge counters, rates and latencies, and
               whether aiohttp, google.protobuf and cryptography import
 16 server     two port VolumeServers (A, B) on the card, in process on
               one event-loop thread, behind the port's MasterServer
               (single, no raft, on the same loop, its canary and
               repair loop off: WEEDTPU_CANARY_INTERVAL=0 and
               WEEDTPU_REPAIR_INTERVAL=0, so no probe launches K1 and no
               planner rebuilds step 4's loss outside the steps)
               taking their protobuf
               heartbeats and answering /dir/lookup, /dir/ec/lookup and
               /dir/status; driven over loopback HTTP: (1) the
               phase-3 volume (a copy taken before phase 14) mounted on
               A with /admin/volume/mount, 256 needles (drawn with
               --seed) read; (2)
               /admin/volume/readonly and /admin/ec/generate, polling
               /admin/ec/progress: shards, .ecx and .vif sha256-equal to
               phase 4's, K1 == phase 4's; (3) B pulls 7-13 through A's
               /admin/file, both mount, A drops 7-13 and the volume, the
               master shows the split; (4) phase 5's losses deleted where
               they live, 256 needles on a lost data shard and 32
               others (drawn with --seed) read from A, B's shards through
               A's shard reader and B's /admin/ec/shard_read (hedging
               off), K1 == needles on lost data shards; (5) A borrows
               B's survivors (/admin/ec/copy), /admin/ec/rebuild (sha256
               == phase 4's, K1 == phase 6's), mounts, and keeps them
               for (6);
               (6) A, which holds every shard, decodes through
               /admin/ec/to_volume, the .dat sha256 ==
               phase 3's, 256 needles read back; (7) 1024 x 1 KiB
               objects on B at 16 clients (upstream's `weed benchmark`
               -size 1024 -c 16, cut), written then read, 256 deleted;
               128 writes to a 001 volume on A read back from A and B;
               (8) /metrics on A and B count the blob requests made;
               both beat in protobuf (`_wire_pb`) and the master's
               heartbeat counter rose; the servers start without a
               scrubber
               (WEEDTPU_SCRUB_MBPS=0); launches zeroed before and read
               after; every line with the card's name and power limit
 17 maintenance four port VolumeServers on the card (R, "a:1" in its
               rack, "c:3" in its data centre, "b:2" in another), in
               process on one loop thread behind the port's
               MasterServer (on the same loop; its repair loop, canary
               and aggregator loop off); scrubbers
               unthrottled and parked (WEEDTPU_SCRUB_INTERVAL=3600),
               hedging off: (1) /admin/scrub of links of phase 4's
               shard set on R, clean (K1 one per window), then bits of
               shards 5 and 11 (copies) flipped by /admin/faults, both
               found, localised and quarantined, the master's health
               ledger reading the volume corrupt with both verdicts; (2) /admin/scrub_rate to 8 MB/s on a:1 and one
               pass over 256 x 64 KiB needles, at least 0.9 x bytes /
               rate; (3) reduced rebuilds on R posted as the master's
               repair posts them, helpers answering /admin/ec/partial on
               the card: RS lost [3] at d = 10 and [1, 12] on phase 9's
               topology, MSR lost [0] on phase 10's msr_9_16 set and
               topology; every rebuilt shard sha256-equal to phase 4's
               or 10's, the remote bytes per node equal the plan's and
               the library run's, K1 equal to phases 9 and 10's; (4)
               /admin/ec/probe_read four times (K1 one each); (5)
               /admin/ec/recode rs_10_4 -> lrc_10_2_2 -> rs_10_4 on
               c:3: shards and .vif sha256-equal to phase 10's and 4's,
               K1 the layout's encode count each, needles read back;
               (6) /admin/ec/fleet_convert of links of phase 7's four
               volumes on b:2: K2 == phase 7's, shards sha256-equal to
               phase 7's, .ecx written, read-only in the beat, the
               shard sets in the next, the handler's own seconds beside
               the step's; (6b) the same conversion with nothing
               polling /admin/ec/progress, under other ids; (7)
               /metrics counts the scrub bytes, the fleet's encode
               bytes (both conversions), the repair bytes by
               locality and the blob requests made; launches zeroed
               before and read after; every line with the card's name
               and power limit
 18 admin      three port VolumeServers (A, B, C) on the card, in
               process on one loop thread behind the port's MasterServer
               (single, no raft, its canary and repair loop off),
               the continuous profiler on (WEEDTPU_PROFILE_HZ=49) for
               this phase only: (1) /admin/volume/move of the phase-3
               volume (links of the copy taken before phase 14) A -> B,
               its request sampled: B's .dat sha256 == phase 3's and its
               CRC32 == the move's, A's copy retired, the master shows
               it;
               64 x 64 KiB needles appended on B and A's replica (a file
               copy of phase 3's) caught up by /admin/volume/copy,
               appended_bytes == B's growth, the tails equal; a move of
               phase 7's 100 MiB volume B -> C with B's file pulls
               stalled (delay_file_pull) and C stopped mid-transfer:
               500, B serves its needle and stays writable, C's boot
               leaves nothing, a second move B -> C, sha256 and CRC32
               equal; (2) links of phase 4's shards, A 4-13 / B 0-3, the
               volume role partitioned from B through A's /admin/faults,
               256 of the needles on 0-3 (drawn with --seed) read from A
               at 16 clients, hedging off: K1 == those needles ==
               reconstruct batches, no remote read; /debug/pprof?seconds=1 meanwhile
               shows ec_volume frames; (3) peer_latency 350 ms toward B,
               16 needles, hedging on: K1 == hedges fired == won == 16;
               peer_error 100 %: K1 16, B's breaker open; (4)
               /admin/volume/unconvert of phase 4's shard set less
               0/3/10/12: K1 == phase 6's, .dat sha256 == phase 3's, the
               shard set, .ecx and .vif gone, writable, in the master's
               /dir/status; a
               one-needle volume of phase 7 through
               /admin/ec/fleet_convert (K2 as its units) and a thaw-only
               unconvert (no launch); (5) tier_move to a local
               directory and tier_download with delete_remote, sha256 ==
               phase 3's, a write after it; (6) /admin/volume/needles == the needle map,
               /admin/query over 512 JSON documents == plain Python's
               selection; (7) /perf lists the unconvert's rebuild, /heat
               ranks step 2's volume first, /debug/traces holds the
               move's volume.move span, the continuous profiler has
               samples; launches zeroed before and read after; every
               line with the card's name and power limit
 19 mesh       the multi-device mesh (parallel/) on positions of this
               card: (1) WEEDTPU_EC_CODEC=mesh on one position, the
               phase-3 volume (links of the copy taken before phase 14)
               encoded from no shard set, shards, .ecx and .vif sha256 ==
               phase 4's, K1 == phase 4's; (2) phase 5's losses rebuilt
               under mesh, K1 == phase 6's; (3) WEEDTPU_CONVERT_CODEC=mesh:
               links of phase 7's four volumes on one position, sha256 ==
               phase 7's, K2 == phase 7's; (4) the same on 4 positions of
               the card, K2 one per unit; (5) encode_batch_place of 4 and 6
               stripes [10, 1 MiB] of the .dat on (2, 2) and (3, 2) meshes,
               every position's block == the rows of the shard files it
               must hold, pad rows zero, and the column-split rebuild of
               shards 2 and 12 of volume 0; (6) dryrun_multichip(8) on 8
               positions; K1 and K2 per step against their prediction;
               launches zeroed before and read after
 20 master     the port's master with raft HA: three MasterServers with
               peers (canaries and repair loops off; raft state under
               the work
               directory) on one loop
               thread, two port VolumeServers A and B on the card on
               another, given the master list reversed: (1) one leader,
               named by both followers' /cluster/status, /raft/status on
               each; (2) A and B in the leader's topology through the
               follower's 409, beating in protobuf; (3) 256 x 1 KiB
               through the leader's /dir/assign in two collections, a
               volume grown on A and on B by /admin/assign_volume, read
               back; a follower's assign 409 naming the leader; every
               master's max_volume_id >= the grown vids; (4) links of
               phase 4's shard set, A 0-6 / B 7-13, mounted, the
               leader's /dir/ec/lookup equal to the split; (5) the leader
               stopped: a new leader, A's and B's beats at it, the split
               again; (6) shards 0 and 3 deleted on A, 128 needles on
               them (drawn with --seed) read from A at 16 clients,
               hedging off, B's survivors found through the new leader:
               K1 == needles, every payload equal; (7) an assign on the
               new leader grows a volume above every vid grown before,
               no file key repeated; K1 per step against its
               prediction; launches zeroed before and read after
 21 planes     the port's master with its planes (aggregator, SLOs,
               history, alerts, interference and the scrub governor, the
               canary, the loop monitor) on one loop thread, two port
               VolumeServers A and B on the card on another, linking
               phase 4's shard set A 0-6 / B 7-13, scrubbers at 64 MB/s
               passing only on request, every tick driven by the phase
               (WEEDTPU_AGG_INTERVAL=0, WEEDTPU_CANARY_INTERVAL=0,
               WEEDTPU_REPAIR_INTERVAL=0):
               (1) /cluster/metrics?refresh=1 federates A's and B's
               families under their node labels, scrape ages finite;
               (2) 16 canary rounds of the blob and degraded probes,
               all ok, K1 one per degraded probe, /cluster/canary and
               /cluster/slo ok; (3) /cluster/trace of the last degraded
               probe: one waterfall with canary.degraded,
               volume.probe_read and the reconstruct, pinned; (4)
               /cluster/perf merges the servers' payloads once, the
               card's reconstruct row calls == the phase's K1; (5)
               scrape ticks, /cluster/history of the canary counter in
               aligned points, an alert on the degraded probe's latency
               firing under delay_shard_read and clearing without it;
               (6) shards 0 and 3 deleted on A; a quiet tick and a busy
               one (B's shard reads delayed, scrub bytes booked): the
               scrub index over the governor's target, the governed
               rate pushed to A's and B's scrubbers, one /admin/scrub
               pass on A at that rate (K1 one per window, no faster
               than 0.9 x bytes / rate), quiet ticks ramping it back;
               (7) /cluster/loops, /cluster/dashboard, /cluster/heat,
               /cluster/geo with no sync direction; K1 per step against
               its prediction, K2 0; launches zeroed before and read
               after; every line with the card's name and power limit
 22 heal       the master's maintenance plane (repair planner and
               health ledger, conversion scheduler, autopilot, the
               governor's repair and convert targets) on one loop
               thread over phase 17's four servers on the card on
               another, every tick driven by the phase (repair loop,
               aggregator loop and canary off; the autopilot's clocks
               shortened): (1) /maintenance/status lists phase 4's set
               (221 on phase 9's topology, 222 whole on c:3) healthy,
               weedtpu_volume_health reads it; (2) shards 1 and 12
               deleted by /admin/faults, one /maintenance/tick: a
               reduced rebuild on R over a:1's and b:2's
               /admin/ec/partial, K1 == phase 9's [1, 12], sha256 ==
               phase 4's, its decision's bytes per helper == phase 9's
               run of the plan == the helpers' /metrics; (3) a bit of shard 5 flipped on c:3,
               /admin/scrub (K1 one per window), the ledger corrupt, one
               tick purges and rebuilds it (K1 == phase 6's), a clean
               scrub; (4) step 2's loss under WEEDTPU_REPAIR_REDUCED=0:
               survivor copies, /admin/ec/rebuild (K1 == phase 6's),
               the naive estimate booked; (5) phase 7's four volumes
               sealed through /maintenance/convert, one batch, K2 ==
               phase 7's, shards sha256 == phase 7's; (6) a baseline, a
               quiet and a busy tick of 8 degraded GETs each (K1 one
               each) with repair and convert bytes booked: the
               governor's repair_xrack and convert rates down, the
               planner's and the scheduler's buckets with them, quiet
               ticks back to the ceilings; (7) the autopilot in plan
               mode: 384 GETs make an EC volume hot, one tick plans its
               promote and a cold volume's demote, nothing runs before
               approval; the promote's unconvert (K1 == phase 6's,
               .dat == phase 3's), the demote's sealed conversion (K2
               its units); one round of the background loop; every
               volume healthy, /cluster/loops without error,
               /cluster/geo with no sync direction; K1 and K2 per step
               against their
               prediction; launches zeroed before and read after
 23 shell      the port's own client and shell (ROADMAP 1.19a) over
               three card servers in three racks on one loop thread,
               behind the port's master on another (repair loop,
               aggregator loop and canary off, scrubbers off, hedging
               off): (1) the port's `WeedClient` on the /cluster/stream
               feed writes 512 needles (log-uniform 1-256 KiB, from
               --seed) into collection p23 from 16 threads and reads
               them back; (2) a link of the phase-3 volume mounted as
               231, `lock` and `ec.encode -volumeId 231`: K1 == phase
               4's, the placement `balanced_ec_distribution`'s, every
               shard sha256 == phase 4's; (3) `ec.encode -collection p23
               -fullPercent 0 -quietFor 0s` once a beat reports the p23
               sizes: every p23 volume selected, K1 == their units by
               the layout; (4) shards 0/3/10/12 of 231 and 1 of a p23
               volume W deleted, 64 of 231's needles on its lost data
               shards and every needle of W read through the client, K1
               one per needle on a lost data shard; (5) `ec.rebuild`: K1
               == phase 6's plus W's chunks, the rebuilt shards sha256
               == phase 4's; (6) volume.list, cluster.status,
               cluster.ps, ec.codecs, maintenance.status (every EC
               volume healthy), cluster.autopilot and chaos.status; (7)
               `ec.decode -volumeId W` and `unlock`: .dat sha256 == its
               record, W read back; (8) `python -m seaweedfs_tpu_torch
               shell -c volume.list` as a child process; K1 per step
               against its prediction, K2 0; launches zeroed before and
               read after; every line with the card's name and power
               limit
 24 filer      the port's filer without its server (ROADMAP 1.20a) on
               phase 23's cluster of three card servers, kept up for
               it: the `Filer` over
               its `LogStore`, its `on_delete_chunks` feeding a
               `DeletionQueue` on the port's `WeedClient`, a `ChunkCache`
               of 32 MiB in memory and a disk tier; (1) 128 MiB of files
               from --seed (1 KiB-32 MiB) cut into 4 MiB chunks and
               uploaded into collection p24, those under /p24/enc sealed
               by the port's AES-GCM cipher; a file of 48 appended chunks
               manifestized at a batch of 16, a middle range overwritten,
               a hard link, a subtree rename; (2) `ec.encode -collection
               p24` through the port's shell, K1 == the layout's units;
               (3) data shards 0 and 3 of every p24 EC volume deleted; (4)
               every file read through `ChunkGroup.read_views`, the client
               and `decrypt`, sha256 == its draw, K1 one per download
               whose needle touches a lost data shard, sampled sealed
               chunks opened by `cryptography`'s AESGCM; (5) every file
               again from the cache, K1 0; (6) /p24/plain deleted: the
               queue frees its fids (the manifests' inner fids too), each
               404 on every holder, the /p24/enc files still equal read
               without the cache, K1 one per manifest and /p24/enc chunk
               on a lost shard; (7) the LogStore reopened, the same
               `subtree_digest`; K2 0; launches zeroed before and read
               after
 25 filer server  the port's `FilerServer` (ROADMAP 1.20b) on the same
               cluster, kept up for it: A and B (B sealing its chunks),
               each on a loop thread of its own with a 512 MiB chunk
               cache, over one SQLite store, the hot tier on; (1) 128 MiB
               of files from --seed PUT from 16 threads into collection
               p25, /p25/plain through A (a quarter of them gzipped
               text), /p25/enc through B, then a PATCH, a truncate and a
               move through A; (2) `ec.encode -collection p25`, K1 == the
               layout's units; (3) data shards 0 and 3 of every p25 EC
               volume deleted; (4) every file read through A and B in
               turn, sha256 == its draw, summed `direct` == the distinct
               chunks (each chunk to the volume tier once), K1 one per
               such fetch touching a lost data shard; (5) a Range GET
               and a HEAD of each through the other filer, no fetch, K1
               0, the master's /cluster/perf `hot_tier` the sum of A's
               and B's events; (6) `fs.ls`, `fs.du`, `fs.verify` of
               every /p25/enc file (K1 one per chunk on a lost shard),
               `fs.meta.save` and `fs.rm -r /p25/plain` through the
               port's shell, every freed fid 404 on every holder; (7)
               A's /__meta__/subscribe replays its events in order, the
               digest equal on A and B and after A's restart, 8 files
               read cold through the restarted A; K2 0; launches zeroed
               before and read after
 26 s3         the port's S3 gateway (ROADMAP 1.21a) on the same
               cluster, kept up for it: one port `FilerServer` F (a
               fresh SQLite store, a 512 MiB chunk cache, /buckets/p26/
               mapped to collection p26 by the shell's `fs.configure`)
               and one port `S3ApiServer` G over it, registered with the
               master, its identities W (Admin, Read, Write, List,
               Tagging) and R (Read, List) also stored by `s3.configure`;
               (1) bucket p26 and 128 MiB of objects from --seed PUT
               through G by W from 16 threads: signed PUTs, a quarter
               aws-chunked, two of about 24 MiB by multipart in 5 MiB
               parts, each ETag the MD5 (-5 for the multipart ones); (2)
               `ec.encode -collection p26`, K1 == the layout's units; (3)
               data shards 0 and 3 of every p26 EC volume deleted; (4)
               every object read in full through G, sha256 and ETag ==
               its draw's, F's `direct` == the distinct chunks, K1 one
               per such fetch touching a lost data shard, F's summed GET
               seconds beside the client's; (5) ListObjectsV2 at
               max-keys 7 with continuation, a Range GET presigned by R
               and a HEAD of each object, R's PUT 403, a bucket policy
               denying R one prefix (403 there, 200 elsewhere), K1 0;
               (6) the tenant counters of W's and R's keys == the
               phase's successful requests, tenant bytes against the
               byte ledger, `s3.bucket.list` and `s3.configure -list`
               through the port's shell; (7) a DeleteObjects of a
               quarter of the keys (a multipart object among them):
               every freed fid 404 on every holder, the other multipart
               object read whole, K1 0; K2 0; launches zeroed before and
               read after
 27 webdav     the port's WebDAV gateway and mount (ROADMAP 1.21b) and
               the CLI's offline tools (1.19c) on the same cluster, kept
               up for it: one port `FilerServer` F (a fresh SQLite store,
               collection p27, a 512 MiB chunk cache), one port
               `WebDavServer` D over F and one port `WFS` M over F, its
               meta subscription and admin socket live, driven through
               its VFS calls (no kernel mount); (1) a MKCOL tree and 128
               MiB of files from --seed PUT through D from 16 threads,
               36.5 MiB through M (256 KiB writes, a sparse file,
               appends, an overwrite in place, a truncate, a symlink, a
               hard link, an xattr); (2) `ec.encode -collection p27`, K1
               == the layout's units; (3) data shards 0 and 3 of every
               p27 EC volume deleted; (4) every file read in full
               through D, sha256 == its draw, F's `direct` == the
               distinct chunks, K1 one per such fetch touching a lost
               data shard, then ranged through D and at offsets through
               M, every byte equal; (5) PROPFIND at Depth 1 of each
               directory == F's listing, a MOVE and a COPY of subtrees
               through D, M's meta cache seeing the new names through
               its subscription, K1 0; (6) `mount.configure` through the
               port's shell: a quota under M's usage fails a write with
               EDQUOT, clearing it lets it through; (7) DELETE of a
               subtree, a copy and a file through D, every freed fid 404
               on every holder; (8) a child running the CLI's `backup` of a
               p27 volume from its card server, `fix`, `export` and
               `compact` of the copy, each checked against the server's
               volume, no torch loaded; K2 0; launches zeroed before and
               read after
 28 replication  the port's replication, notification and remote
               storage (ROADMAP 1.22a) on the same cluster, kept up for
               it: two port `FilerServer`s, A (region a, collection p28a,
               a `LogQueue` notification) and B (region b, collection
               p28b), each on a loop thread of its own with a fresh
               SQLite store, and one port `S3ApiServer` G over B with an
               identity file; (1) 128 MiB of files from --seed POSTed to
               A under /p28 from 16 threads; (2) `ec.encode -collection
               p28a`, K1 == the layout's units; (3) data shards 0 and 3
               of every p28a EC volume deleted; (4) a port `FilerSync(A,
               B)` until B's digest of /p28 equals A's: every file on B
               == its draw, the b->a pump skipping every echo, A's
               `direct` == the distinct chunks, K1 one per such fetch
               touching a lost data shard; (5) files PUT on B reach A,
               no echo; (6) the master's /cluster/geo with both
               directions unstalled, the applied counters == the pumps',
               `cluster.geo`, the auditor clean, the sync stopped at once;
               (7) two `ReplicateDaemon`s over A's log into a
               `LocalSink` and a `CloudSink` over `S3Remote` into G's
               bucket p28mirror, every file and object == its draw; (8)
               `volume.tier.upload` of B's p28b volume into G's p28tier,
               its needles read through G, `volume.tier.download`, the
               .dat unchanged; (9) `remote.mount` of p28mirror on A,
               read-through GETs, `remote.cache`, `remote.uncache`,
               `remote.meta.sync`, `remote.unmount`; (10) a child running
               the CLI's `filer.cat`, `filer.copy`, `filer.meta.tail`,
               `filer.meta.backup` and `filer.backup` against A, each
               output == what A holds, no torch loaded; K1 per step
               against its prediction from the run's own layout and A's
               cache, K2 0; launches zeroed before and read after
 29 mq         the port's message queue (ROADMAP 1.22b) on the same
               cluster, kept up for it: one port `FilerServer` F
               (collection p29, a fresh SQLite store) and two port
               `BrokerServer`s P and Q keeping their logs in it, each on
               a loop thread of its own; (1) `mq.topic.configure -topic
               chip.p29 -partitionCount 8` through the port's shell; (2)
               64 MiB of messages from --seed published through
               `MQClient` from 16 threads of a child process, each key
               on the partition the reference's `ring_slot` gives it;
               (3) a consumer group of two polls each message once, in
               order, and commits; (4) `/flush`, then `ec.encode
               -collection p29`, K1 == the layout's units; (5) data
               shards 0 and 3 of every p29 EC volume deleted, F's cache
               emptied; (6) both brokers stopped and two fresh ones
               started over F: their recovery reads every segment back
               (K1 one per chunk fetch touching a lost data shard),
               offsets, the replay and the group's commits kept; (7) one
               stopped, and once the survivor's ring has settled 256
               more published, `mq.balance`, `mq.topic.list` and
               `mq.topic.desc` show it owning every partition, nothing
               lost; (8) the master's epochs rose, a stale `/replicate`
               403 `fenced`; (9) a child running the CLI's `mq.broker`
               behind a master of its own, no torch loaded, serves
               `MQClient` byte for byte; K1 per step against its
               prediction, K2 0; launches zeroed before and read after
 30 chaos      the port's chaos harness and fleet simulator: four cells
               through `run_scenario`, each on a fresh `ChaosCluster` (the
               port's master, three card `VolumeServer`s in racks a, b
               and c, a `FilerServer`), the reference harness's sizes and
               seeds: degraded_read x shard_loss, x bit_rot (found by the
               on-request remote scrub of the background scrubbers, then
               healed), x convert_mid_failure (K2: the scheduler's batch,
               node 0 killed mid-flight) and filer_stream x rack_loss (a
               reduced repair); K1 and K2 per cell against the layout's
               prediction (units, scrub windows, degraded reads, the
               reduced rebuilds' applies; K2 ceil(units/4) per batch, once
               or twice), every healed shard set sha256-equal to before
               the fault (a converted one: to the plain encode of its
               .dat), fsck ok; `FleetSim` at its defaults (500 vnodes)
               against the last cell's master: beats, the aggregator's
               items and backlog, a rack failed and recovered, 50 nodes
               left, the median tick; a child running the CLI's
               `python -m seaweedfs_tpu_torch.maintenance.fleetsim`
               behind a master of its own: 500 vnodes registered, SIGINT
               exit 0, no torch, jax or reference package loaded;
               it runs in a child process, `chip_smoke.py --chaos-worker
               DIR`, started after phase 22 and told to go at phase 27's
               start, beside phases 27-29, its lines printed at the join
               after phase 29's; launches zeroed before and read after
 31 tile       the launch tile (ops/gf_cuda.py) and the tile-drift
               sentinel, after phase 30's join, with WEEDTPU_TILE_PIN in
               the work directory (set for the whole run: no pin applies
               before this phase, and none is read from or written to the
               home directory): micro_sweep at [10, 1 MiB], one line per
               candidate tile with its GB/s and the card's name and power
               limit, K1 candidates x (1 + 3); each candidate's product
               byte-equal to the plain version's and the default tile's;
               the winner pinned and resolved, a pin with another chip's
               fingerprint not applied, WEEDTPU_EC_TILE winning over the
               pin; the phase-3 volume (links of its copy) encoded at the
               pinned tile, sha256 == phase 4's, K1 phase 4's; a port
               master and a card VolumeServer with
               WEEDTPU_TILE_SENTINEL_INTERVAL=1: after two sweeps the
               sentinel is stopped, its verdict (ok or stale, held
               against its own sweep table) on /debug/pipeline, the
               master's /cluster/perf, /metrics (weedtpu_tile_drift) and
               the shell's cluster.perf, K1 one sweep per tick; the
               sentinel cleared (`set_sentinel(None)`); K2 0; launches
               zeroed before and read after
 32 report     {"kernels": [...]} line, the card's name and power limit,
               and the result line

Phases 4-6 each run twice: first "cold", with the files they read synced
and dropped from the page cache (posix_fadvise DONTNEED; mincore reports
the share still resident), then "warm", right after, with those files
cached; each encode run starts with no shard set on disk.  Launch
counts are zeroed just before phase 3 and read just after phase 9, and
zeroed again just before phase 10 and read just after it, and again
around phases 12-31, each on its own, so the reported launches are
the paths' own
(their sum); the run fails if
a path made the kernel wrapper stage a copy of any input
(`gf_cuda.STAGED`), since each hands the kernel rows it reads in place,
and if K2 was not launched.  After phase 13's window, two records: fleet
against one write_ec_files per volume over the same four volumes (fleet,
serial, serial, fleet), and rebuild_ec_files of phase 9's single loss;
then phases 14-23 (phases 16-19, 22 and 23 on a copy of the phase-3
volume taken before phase 14, whose appends go through links of it; phases
17, 18, 20, 21 and 22 also on links of phase 4's and (17) 10's shard
sets, 17, 18 and 22 on phase 7's volumes).  Every port master the
script starts runs with its repair loop off
(WEEDTPU_REPAIR_INTERVAL=0): phases 16-30 delete shards on purpose, and
a planner tick would rebuild them, launching K1 at times no step
predicts.
Needs one CUDA card; exits non-zero without one, and outside a checkout
of the repository.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import zlib

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# H100 SXM host link, PCIe Gen5 x16, each direction (NVIDIA data sheet:
# 128 GB/s both ways)
PCIE_BYTES_PER_S = 64e9
MIB = 1 << 20


_LAST_LINE = [time.perf_counter()]


def log(msg: str) -> None:
    """A line of the run, with the seconds since the line before it: the
    step it closes."""
    now = time.perf_counter()
    if not msg.startswith("{"):
        msg = f"{msg} (+{now - _LAST_LINE[0]:.2f} s)"
    _LAST_LINE[0] = now
    print(msg, flush=True)


def free_port() -> int:
    """A port of the loopback interface that was free a moment ago."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def loop_thread(loops: list, timeout: float = 600):
    """A new event loop running on a daemon thread, appended to `loops`
    as (loop, thread); returns a function that runs a coroutine there
    and waits for its result (`timeout` seconds at most)."""
    import asyncio
    loop = asyncio.new_event_loop()
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()
    loops.append((loop, th))
    return lambda coro: asyncio.run_coroutine_threadsafe(
        coro, loop).result(timeout)


def stop_loops(loops: list) -> None:
    """Stop the loops `loop_thread` started and join their threads."""
    for loop, th in loops:
        loop.call_soon_threadsafe(loop.stop)
        th.join(10)


def until(pred, what: str, timeout: float = 15.0):
    """`pred()`'s first true value, polled every 20 ms; AssertionError
    with `what` after `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(what)
        time.sleep(0.02)


def fan(fn, items, threads: int = 16) -> float:
    """`fn` over `items` from `threads` threads, each taking every
    `threads`-th item; the wall.  The first error is raised after the
    join."""
    errors: list = []

    def worker(c: int) -> None:
        try:
            for it in items[c::threads]:
                fn(it)
        except Exception as e:  # surfaced after the join
            errors.append(e)
    pool = [threading.Thread(target=worker, args=(c,))
            for c in range(threads)]
    t0 = time.perf_counter()
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    if errors:
        raise errors[0]
    return time.perf_counter() - t0


def gpu_ms(fn, flush, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over `runs` launches, each timed alone by
    CUDA events with L2 flushed first and the enqueue hidden behind a
    device-side sleep (so host launch overhead is not counted)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def kernel_cases(seed: int):
    """Phase 2's cases: (name, matrix, x shape, batched, timed).  Every one
    is held byte for byte against the plain version; the timed ones are
    the main path's shapes."""
    import numpy as np
    from seaweedfs_tpu_torch.models import rs
    from seaweedfs_tpu_torch.ops import gf_cuda, lrc, msr

    code = rs.get_code(10, 4)
    survivors = [1, 2, 4, 5, 6, 7, 8, 9, 11, 13]

    def decode(wanted):
        return gf_cuda.CudaGFMatrix(code.decode_matrix(survivors, wanted))
    parity = gf_cuda.CudaGFMatrix(code.parity_matrix)
    rebuild = decode([0, 3, 10, 12])
    g = np.random.default_rng(seed + 3)

    def rand(m, k):
        return gf_cuda.CudaGFMatrix(g.integers(0, 256, (m, k), np.uint8))
    cases = [
        ("parity [10,1MiB]", parity, (10, MIB), False, True),
        ("parity [10,16MiB]", parity, (10, 16 * MIB), False, True),
        ("decode [4,10]@[10,16MiB]", rebuild, (10, 16 * MIB), False, True),
        ("batch [4,10,1MiB]", parity, (4, 10, MIB), True, True),
        ("batch [4,10,16MiB]", parity, (4, 10, 16 * MIB), True, True),
        ("batch [8,10,1MiB]", parity, (8, 10, MIB), True, True),
        ("decode [1,10]@[10,4KiB]", decode([0]), (10, 4096), False, True),
        ("decode [1,10]@[10,512KiB]", decode([0]), (10, MIB // 2), False,
         True),
        ("decode [2,10]@[10,512KiB]", decode([0, 3]), (10, MIB // 2), False,
         True),
        # one block, 16 bytes: the launch and memory-latency floor
        ("floor [1,1]@[1,16]", rand(1, 1), (1, 16), False, True),
    ]
    # repair's partials (phase 9, lost [3] at d = 10): the repairing node's
    # own 5 shards, a:1's 3 and b:2's 2, slices of one [1, 10] decode
    # matrix, each through the kernel's generic (runtime k) instantiation
    window = [0, 1, 2, 4, 5, 6, 7, 8, 9, 10]
    lost3 = code.decode_matrix(window, [3])
    for name, cols in (("partial [1,5]@[5,16MiB]", slice(0, 5)),
                       ("partial [1,3]@[3,16MiB]", slice(5, 8)),
                       ("partial [1,2]@[2,16MiB]", slice(8, 10))):
        mat = gf_cuda.CudaGFMatrix(lost3[:, cols])
        cases.append((name, mat, (mat.k, 16 * MIB), False, True))
    # the codecs phase's shapes: MSR(9,16) parity on one 1 MiB unit and
    # on a 16 MiB batch (de-interleaved to 128 KiB / 2 MiB sub-rows, five
    # row-block launches each), its whole-file decode of one shard per
    # 16 MiB rebuild batch, and LRC's single-loss decode from its group
    mcode = msr.get_code(9, 16)
    mparity = gf_cuda.CudaGFMatrix(mcode.parity_matrix)
    mrows = [r for i in range(1, 10) for r in mcode.node_rows(i)]
    mdecode = gf_cuda.CudaGFMatrix(mcode.decode_matrix(
        mrows, mcode.node_rows(0)))
    # one 16-row block of the parity, alone: five launches' sum against
    # the [72,72] apply shows what the row-block split costs
    mblock = gf_cuda.CudaGFMatrix(mcode.parity_matrix[:16])
    lcode = lrc.get_code(10, 2, 2)
    llocal = gf_cuda.CudaGFMatrix(lcode.decode_matrix(
        [i for i in range(14) if i != 2], [2]))
    cases += [
        ("msr parity [72,72]@[72,128KiB]", mparity, (72, MIB // 8), False,
         True),
        ("msr parity [72,72]@[72,2MiB]", mparity, (72, 2 * MIB), False,
         True),
        ("msr block [16,72]@[72,128KiB]", mblock, (72, MIB // 8), False,
         True),
        ("msr block [16,72]@[72,2MiB]", mblock, (72, 2 * MIB), False, True),
        ("msr decode [8,72]@[72,2MiB]", mdecode, (72, 2 * MIB), False, True),
        ("lrc local [1,5]@[5,16MiB]", llocal, (5, 16 * MIB), False, True),
    ]
    # phase 10's repair applies: LRC's group-local partial of lost [2] on
    # the repairing node (shards 0, 1, 3, 4 of its basis 0, 1, 3, 4, 10),
    # and MSR's for lost [0] over helpers 1-16 at 2 MiB sub-rows: a:1's
    # six shards' block-diagonal [6,48] partial and its [8,6] post
    lrepair = lcode.decode_matrix([i for i in range(14) if i != 2], [2])
    mhelpers = list(range(1, 17))
    mcoeff = np.zeros((6, 48), np.uint8)
    for i in range(6):
        mcoeff[i, 8 * i:8 * (i + 1)] = mcode.repair_coeff(0)[0]
    mpost = mcode.repair_matrix(0, mhelpers)[:, 5:11]
    cases += [
        ("lrc partial [1,4]@[4,16MiB]",
         gf_cuda.CudaGFMatrix(lrepair[:, :4]), (4, 16 * MIB), False, True),
        ("msr helper [6,48]@[48,2MiB]", gf_cuda.CudaGFMatrix(mcoeff),
         (48, 2 * MIB), False, True),
        ("msr post [8,6]@[6,2MiB]",
         gf_cuda.CudaGFMatrix(np.ascontiguousarray(mpost)), (6, 2 * MIB),
         False, True),
    ]
    cases += [(f"parity n={n}", parity, (10, n), False, False)
              for n in (1, 15, 17, 255, 4097)]
    cases += [(f"random [{m},10] n=4097", rand(m, 10), (10, 4097), False,
               False) for m in range(1, 17)]
    cases += [(f"random [4,{k}] n={n}", rand(4, k), (k, n), False, False)
              for k in (1, 17, 32) for n in (1, 15, 17, 4097)]
    cases += [(f"random [1,{k}] n={n}", rand(1, k), (k, n), False, False)
              for k in range(2, 10) for n in (17, 4097)]
    # past 16 rows or 32 columns (fault 3.3): row blocks of 16, k at run
    # time, 100 KB of tables at k = 200 (past the 48 KB default)
    cases += [(f"random [{m},{k}] n={n}", rand(m, k), (k, n), False, False)
              for m in (17, 32, 33, 72) for k in (33, 64, 72, 200)
              if m + k <= 256 for n in (1, 17, 4097)]
    cases += [(f"batch [4,72,72] n={n}", mparity, (4, 72, n), True, False)
              for n in (17, 4097)]
    # MSR repair's helper partials [c, 8c] (k = 40, 48) and posts [8, c]
    # at ragged sub-row lengths: the byte tail past the last full word
    cases += [(f"random [{m},{k}] n={n}", rand(m, k), (k, n), False, False)
              for c in (4, 5, 6) for m, k in ((c, 8 * c), (8, c))
              for n in (17, 4097, 2 * MIB + 5)]
    # every candidate launch tile but the default, which the cases above
    # run: K1 at ragged n around the tile, K2 on [4, 10, n] units, and
    # the generic instantiation on a [16, 72] row block
    for tile in gf_cuda.SWEEP_TILES:
        if tile == gf_cuda.DEFAULT_TILE:
            continue
        tp = gf_cuda.CudaGFMatrix(code.parity_matrix, tile=tile)
        cases += [(f"tile {tile} parity n={n}", tp, (10, n), False, False)
                  for n in (17, tile - 16, tile + 17, 3 * tile + 5,
                            MIB + 5)]
        cases += [(f"tile {tile} batch [4,10] n={n}", tp, (4, 10, n), True,
                   False) for n in (tile + 17, MIB)]
        wide = gf_cuda.CudaGFMatrix(
            g.integers(0, 256, (16, 72), np.uint8), tile=tile)
        cases.append((f"tile {tile} random [16,72] n={2 * tile + 33}", wide,
                      (72, 2 * tile + 33), False, False))
    return cases


# phase 2's timed launches of each case's plain version (the kernel's: 20)
PLAIN_RUNS = 5

# phase 2's cases whose inputs and K1 outputs phase 11 holds the native
# host codec against
NATIVE_CASES = ("parity [10,1MiB]", "parity [10,16MiB]")


def phase_kernel(seed: int) -> tuple[list[dict], list[dict], dict]:
    """Kernel vs plain at the main path's shapes and the correctness cases;
    returns (rows, json, {case: (C, x, K1's output)} on the host for
    NATIVE_CASES)."""
    import torch
    from seaweedfs_tpu_torch.ops import gf_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(128 * MIB, dtype=torch.uint8, device="cuda")
    rows = []
    k1_io = {}

    def check(name, got, want):
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max().item()) \
            if got.numel() else 0
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at {name}: "
                                 f"max_abs_err {err}")
        return err

    for name, mat, shape, batched, timed in kernel_cases(seed):
        # rows 16 bytes apart, as the dispatch seam stages them
        *lead, n = shape
        x = torch.randint(0, 256, (*lead, gf_cuda.padded_width(n)),
                          dtype=torch.uint8, device="cuda",
                          generator=g)[..., :n]
        bit = mat.bitmat.cuda()
        if batched:
            def kern():
                return mat.apply_batch(x)
        else:
            def kern():
                return mat(x)

        def plain():
            return gf_cuda.gf_apply_plain(bit, x)
        got = kern()
        err = check(name, got, plain())
        if name in NATIVE_CASES:
            k1_io[name] = (mat.C, x.cpu().numpy(), got.cpu().numpy())
        del got
        units = shape[0] if batched else 1
        nbytes = units * (mat.k + mat.m) * n
        row = {"case": name, "max_abs_err": err, "bytes": nbytes,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        if timed:
            row["ms"] = gpu_ms(kern, flush)
            # the plain version's median of PLAIN_RUNS: its times are
            # tens of ms, steady to a few percent
            row["plain_ms"] = gpu_ms(plain, flush, runs=PLAIN_RUNS,
                                     warmup=1)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            log(f"[kernel] {name}: equal, {row['ms']:.5f} ms "
                f"({row['share_of_bound']:.1%} of the {row['bound_ms']:.5f} "
                f"ms byte bound), plain {row['plain_ms']:.4f} ms")
        rows.append(row)
        del x
    log(f"[kernel] {sum('ms' not in r for r in rows)} correctness cases "
        "equal (m 1..16, k 1..9/17/32; m 17..72, k 33..200; ragged n; "
        f"K1 and K2 at launch tiles {list(gf_cuda.SWEEP_TILES)})")
    rows += views_and_codec(seed)
    torch.cuda.empty_cache()

    def entry(name, replaces, case):
        r = next(r for r in rows if r["case"] == case)
        return {"name": name, "route": "cuda",
                "source": "seaweedfs_tpu_torch/csrc/gf_matmul.cu",
                "replaces": replaces, "launches": 0,
                "max_abs_err": max(x["max_abs_err"] for x in rows),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "shape": case,
                "share_of_bound": r["share_of_bound"]}
    kernels = [
        entry("gf_apply", "seaweedfs_tpu/ops/pallas_gf.py:268",
              "parity [10,1MiB]"),
        entry("gf_apply_batch", "seaweedfs_tpu/ops/pallas_gf.py:304",
              "batch [4,10,1MiB]"),
    ]
    return rows, kernels, k1_io


def views_and_codec(seed: int) -> list[dict]:
    """Inputs the kernel cannot all read in place, against the plain
    version: a [:, :n] view of a wider buffer, a view off the 16-byte grid,
    and the codec's encode / reconstruct on a contiguous [10, 700]."""
    import torch
    from seaweedfs_tpu_torch.models import rs
    from seaweedfs_tpu_torch.ops import gf_cuda, msr

    code = rs.get_code(10, 4)
    mat = gf_cuda.CudaGFMatrix(code.parity_matrix)
    bit = mat.bitmat.cuda()
    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    wide = torch.randint(0, 256, (10, 8192), dtype=torch.uint8,
                         device="cuda", generator=g)
    mmat = gf_cuda.CudaGFMatrix(msr.get_code(9, 16).parity_matrix)
    mbit = mmat.bitmat.cuda()
    mwide = torch.randint(0, 256, (72, 8192), dtype=torch.uint8,
                          device="cuda", generator=g)
    rows = []
    for name, x, m, b in (
            ("strided [:, :3000] of [10,8192]", wide[:, :3000], mat, bit),
            ("unaligned [:, 1:3001] of [10,8192]", wide[:, 1:3001], mat, bit),
            ("msr strided [:, :3000] of [72,8192]", mwide[:, :3000], mmat,
             mbit),
            ("msr unaligned [:, 1:3001] of [72,8192]", mwide[:, 1:3001],
             mmat, mbit)):
        got, want = m(x), gf_cuda.gf_apply_plain(b, x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at {name}")
        rows.append({"case": name, "max_abs_err": 0})
    codec = gf_cuda.get_codec(10, 4, device="cuda")
    data = wide[:, :700].contiguous()
    shards = codec.encode(data)
    want = torch.cat([data, gf_cuda.gf_apply_plain(bit, data)])
    lost = (0, 3, 10, 12)
    out = codec.reconstruct({i: shards[i] for i in range(14)
                             if i not in lost})
    torch.cuda.synchronize()
    if not torch.equal(shards, want) or \
            any(not torch.equal(out[i], want[i]) for i in lost):
        raise AssertionError("codec encode/reconstruct at contiguous "
                             "[10,700] != plain")
    rows.append({"case": "codec encode+reconstruct contiguous [10,700]",
                 "max_abs_err": 0})
    log("[kernel] strided and unaligned views ([10,k] and [72,72]) and the "
        "codec at contiguous [10,700]: equal to plain")
    return rows


def ptxas_report(log_text: str) -> list[str]:
    """ptxas registers, spills and shared memory of the instantiations
    the paths run: k = 10 with m = 1, 2, 4 (RS(10,4)), and k at run time
    with m = 1 (repair's partials, LRC's local decode), 8 (an MSR decode)
    and 16 (MSR's full row blocks)."""
    out = []
    entries = log_text.split("Compiling entry function")
    for label, needle in (("M=1,K=10", "gf_apply_kernelILi1ELi10E"),
                          ("M=2,K=10", "gf_apply_kernelILi2ELi10E"),
                          ("M=4,K=10", "gf_apply_kernelILi4ELi10E"),
                          ("M=1,K=any", "gf_apply_kernelILi1ELi0E"),
                          ("M=8,K=any", "gf_apply_kernelILi8ELi0E"),
                          ("M=16,K=any", "gf_apply_kernelILi16ELi0E")):
        for e in entries:
            if needle in e.split("\n", 1)[0]:
                facts = [ln.split(":", 1)[-1].strip() for ln in e.splitlines()
                         if "spill" in ln or "Used" in ln]
                out.append(f"{label}: {'; '.join(facts)}")
    return out


def build_volume(vdir: str, seed: int, target: int):
    """Phase 3: needles of uniform 4 KB..1 MB until the .dat reaches
    `target` bytes.  Returns (dat_path, {id: (cookie, lo, hi)}, blob)."""
    from seaweedfs_tpu_torch.storage import needle as ndl
    from seaweedfs_tpu_torch.storage.volume import Volume

    expect, blob = draw_needles(seed, target)
    v = Volume(vdir, "", 1)
    for nid, (cookie, lo, hi) in expect.items():
        v.append_needle(ndl.Needle(
            cookie=cookie, id=nid, data=blob[lo:hi],
            append_at_ns=1_700_000_000_000_000_000 + nid - 1))
    v.flush()
    v.close()
    return v.dat_path, expect, blob


def draw_needles(seed: int, target: int) -> tuple[dict, bytes]:
    """Phase 3's needles as `build_volume` draws them from `seed`:
    ({id: (cookie, lo, hi)}, blob), written nowhere."""
    import numpy as np
    from seaweedfs_tpu_torch.storage import types as t

    rng = np.random.default_rng(seed)
    sizes = []
    total = 8  # super block
    while total < target:
        s = int(rng.integers(4096, MIB + 1))
        sizes.append(s)
        total += t.actual_size(s + 5)  # DataSize(4) + data + flags(1)
    blob = rng.bytes(sum(sizes))
    cookies = rng.integers(0, 1 << 32, len(sizes)).tolist()
    expect = {}
    lo = 0
    for i, s in enumerate(sizes):
        expect[i + 1] = (cookies[i], lo, lo + s)
        lo += s
    return expect, blob


def stripe_rows(dat_size: int, large_block: int, small_block: int,
                k: int = 10):
    """(dat offset, block, shard offset) of every stripe row of a volume,
    by the layout's definition: rows of k large blocks while more than
    one such row remains, then rows of k small blocks to the end."""
    rows, start, off = [], 0, 0
    while dat_size - start > k * large_block:
        rows.append((start, large_block, off))
        start, off = start + k * large_block, off + large_block
    while start < dat_size:
        rows.append((start, small_block, off))
        start, off = start + k * small_block, off + small_block
    return rows


def predict_units(dat_size: int, large_block: int, small_block: int,
                  batch: int = 16 * MIB, k: int = 10) -> int:
    """Units of a volume that carry data: each stripe row cut into columns
    min(batch, block) wide, a column counting when its first data block
    holds .dat bytes."""
    return sum(start + col < dat_size
               for start, block, _ in stripe_rows(dat_size, large_block,
                                                  small_block, k)
               for col in range(0, block, min(batch, block)))


def row_blocks(rows: int) -> int:
    """Kernel launches of one apply of a matrix with `rows` rows: one per
    block of at most 16 rows, the kernel's largest m."""
    return -(-rows // 16)


def sample_rows(n: int, k: int, seed: int) -> list[int]:
    """k random row indices of n, and always the first and the last."""
    import numpy as np
    pick = np.random.default_rng(seed).choice(n, size=min(k, n),
                                              replace=False)
    return sorted(set(pick.tolist()) | {0, n - 1})


def check_stripes(base: str, dat_path: str, large_block: int,
                  small_block: int, rows=None) -> int:
    """Hold a shard set against its .dat, independently of how the port
    cuts units: each shard's size against `layout.shard_file_size`; for
    each stripe row in `rows` (indices into `stripe_rows`; None: all), the
    10 data shards against the .dat bytes, zero past its end, and the 4
    parity shards against the plain version on the card.  Returns the
    number of rows checked."""
    import numpy as np
    import torch
    from seaweedfs_tpu_torch.models import rs
    from seaweedfs_tpu_torch.ops import gf, gf_cuda
    from seaweedfs_tpu_torch.storage.ec import layout

    dat_size = os.path.getsize(dat_path)
    stripes = stripe_rows(dat_size, large_block, small_block)
    size = layout.shard_file_size(dat_size, large_block, small_block)
    if size != sum(block for _, block, _ in stripes):
        raise AssertionError(f"{base}: layout.shard_file_size {size} != "
                             f"the rows' {stripes[-1:]}")
    bit = torch.from_numpy(gf.gf_matrix_to_bitmatrix(
        rs.get_code(10, 4).parity_matrix)).float().cuda()
    fds = [os.open(p, os.O_RDONLY)
           for p in [base + layout.to_ext(i) for i in range(14)] + [dat_path]]
    try:
        for i, fd in enumerate(fds[:14]):
            if os.fstat(fd).st_size != size:
                raise AssertionError(f"{base} shard {i}: "
                                     f"{os.fstat(fd).st_size} B, layout "
                                     f"says {size}")
        picks = range(len(stripes)) if rows is None else rows
        for r in picks:
            start, block, off = stripes[r]
            data = np.zeros((10, block), np.uint8)
            for j in range(10):
                lo = start + j * block
                n = max(0, min(block, dat_size - lo))
                data[j, :n] = np.frombuffer(os.pread(fds[14], n, lo),
                                            np.uint8)
            parity = np.empty((4, block), np.uint8)
            for c in range(0, block, 4 * MIB):  # bounds the plain's memory
                x = torch.from_numpy(np.ascontiguousarray(
                    data[:, c:c + 4 * MIB])).cuda()
                parity[:, c:c + 4 * MIB] = \
                    gf_cuda.gf_apply_plain(bit, x).cpu().numpy()
            for i in range(14):
                got = np.frombuffer(os.pread(fds[i], block, off), np.uint8)
                want = data[i] if i < 10 else parity[i - 10]
                if not np.array_equal(got, want):
                    raise AssertionError(
                        f"{base} shard {i} differs in stripe row {r} "
                        f"(shard offset {off}, block {block})")
    finally:
        for fd in fds:
            os.close(fd)
    return len(picks)


def resident_share(paths) -> float:
    """Share of the files' pages in the page cache (mincore(2))."""
    import ctypes
    import mmap
    import numpy as np
    libc = ctypes.CDLL(None, use_errno=True)
    total = resident = 0
    for p in paths:
        size = os.path.getsize(p)
        if size == 0:
            continue
        npages = -(-size // mmap.PAGESIZE)
        vec = (ctypes.c_ubyte * npages)()
        with open(p, "rb") as f:
            mm = mmap.mmap(f.fileno(), size, prot=mmap.PROT_READ)
        view = np.frombuffer(mm, np.uint8)
        rc = libc.mincore(ctypes.c_void_p(view.ctypes.data),
                          ctypes.c_size_t(size), vec)
        del view
        mm.close()
        if rc != 0:
            raise OSError(ctypes.get_errno(), f"mincore {p}")
        resident += int((np.frombuffer(vec, np.uint8) & 1).sum())
        total += npages
    return resident / total if total else 0.0


def drop_cache(paths) -> float:
    """Write the files back and drop them from the page cache, so the next
    phase reads them from disk; returns the share still resident."""
    for p in paths:
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    return resident_share(paths)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(8 * MIB), b""):
            h.update(chunk)
    return h.hexdigest()


def link_volumes(srcs: list[str], dirname: str) -> list[str]:
    """Hard-link each .dat into a fresh directory; returns the new bases."""
    os.makedirs(dirname)
    bases = []
    for src in srcs:
        base = os.path.join(dirname, os.path.basename(src)[: -len(".dat")])
        os.link(src, base + ".dat")
        bases.append(base)
    return bases


def one_needle_volume(dirname: str, vid: int, size: int, rng) -> str:
    """A volume of one needle of random bytes whose .dat is exactly `size`
    bytes (a multiple of 8: the record's padding), written by the port's
    Volume with its .idx, so a volume server mounts it as it is.  Returns
    the .dat path."""
    from seaweedfs_tpu_torch.storage import needle as ndl
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.volume import Volume
    body = next(x for x in range(size - 48, size - 8)
                if 8 + t.actual_size(x) == size)  # DataSize + data + flags
    v = Volume(dirname, "", vid)
    v.append_needle(ndl.Needle(cookie=0x1234ABCD, id=1,
                               data=rng.bytes(body - 5),
                               append_at_ns=1_700_000_000_000_000_000))
    v.flush()
    v.close()
    if os.path.getsize(v.dat_path) != size:
        raise AssertionError(f"volume {vid}: {os.path.getsize(v.dat_path)} "
                             f"B, wanted {size}")
    return v.dat_path


def phase_fleet(vdir: str, dat_path: str, hashes: list[str], seed: int,
                launches: dict) -> tuple[dict, list[str]]:
    """Phase 7: fleet conversion of four volumes through K2, checked against
    the layout, phase 4's shards and the reference fleet's .vif; then the
    1 GiB volume at 64 MiB large blocks.  Returns (record, the four .dat
    paths)."""
    import numpy as np
    from seaweedfs_tpu_torch.ops import fleet_convert
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout

    large, small = layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE
    src = os.path.join(vdir, "fleet_src")
    os.makedirs(src)
    srcs = [os.path.join(src, "1.dat")]
    os.link(dat_path, srcs[0])
    rng = np.random.default_rng(seed + 5)
    for vid, size in ((2, 256 * MIB), (3, 100 * MIB + 12_352),
                      (4, 65_536)):
        srcs.append(one_needle_volume(src, vid, size, rng))
    sizes = [os.path.getsize(p) for p in srcs]
    units = [predict_units(s, large, small) for s in sizes]
    want = -(-sum(units) // fleet_convert.UNIT_BATCH)
    log(f"[fleet] predicted: {' + '.join(map(str, units))} = {sum(units)} "
        f"units, {want} launches of K2 [<=4,10,1MiB], none of K1")
    bases = link_volumes(srcs, os.path.join(vdir, "fleet"))
    before = dict(launches)
    st: dict = {}
    t0 = time.perf_counter()
    rep = fleet_convert.convert_volumes(bases, stats=st)
    dt = time.perf_counter() - t0
    got = {k: launches[k] - before[k] for k in launches}
    log(f"[fleet] {sum(sizes)} B in {dt:.3f} s: {sum(sizes) / dt / 1e9:.3f} "
        f"GB/s, {rep['units']} units, launches {got}")
    if got != {"gf_apply": 0, "gf_apply_batch": want} or \
            rep["units"] != sum(units):
        raise AssertionError(f"fleet launched {got} for {rep['units']} "
                             f"units; the layout predicts {want} K2 "
                             f"launches for {sum(units)}")
    checked = []
    for i, (base, size) in enumerate(zip(bases, sizes)):
        rows = None if i else sample_rows(len(stripe_rows(size, large,
                                                          small)),
                                          8, seed + 6)
        checked.append(check_stripes(base, base + ".dat", large, small,
                                     rows))
        with open(base + ".vif", "rb") as f:
            vif = f.read()
        if vif != json.dumps({"version": t.CURRENT_VERSION,
                              "dat_file_size": size}).encode():
            raise AssertionError(f"{base}.vif is {vif!r}")
    if sha256_many([bases[0] + layout.to_ext(i) for i in range(14)]) != \
            hashes:
        raise AssertionError("fleet shards of the phase-3 volume differ "
                             "from write_ec_files'")
    # phase 17 converts links of the same volumes through the server
    rest = sha256_many([b + layout.to_ext(i) for b in bases[1:]
                        for i in range(14)])
    fleet_hashes = [hashes] + [rest[j:j + 14]
                               for j in range(0, len(rest), 14)]
    log(f"[fleet] stripe rows checked {checked}; the phase-3 volume's 14 "
        f"shards sha256-equal to phase 4's; every .vif equal to the "
        f"reference fleet's")
    shutil.rmtree(os.path.join(vdir, "fleet"))

    # one large row: the 1 GiB volume at 64 MiB large blocks
    large64 = 64 * MIB
    units64 = predict_units(sizes[0], large64, small)
    want64 = -(-units64 // fleet_convert.UNIT_BATCH)
    log(f"[fleet 64MiB] predicted: {units64} units, {want64} launches of "
        f"K2 [<=4,10,16MiB]")
    (base,) = link_volumes(srcs[:1], os.path.join(vdir, "fleet64"))
    before = dict(launches)
    t0 = time.perf_counter()
    fleet_convert.convert_volumes([base], large_block=large64)
    dt64 = time.perf_counter() - t0
    got64 = {k: launches[k] - before[k] for k in launches}
    if got64 != {"gf_apply": 0, "gf_apply_batch": want64}:
        raise AssertionError(f"64 MiB fleet launched {got64}, the layout "
                             f"predicts {want64} of K2")
    n64 = len(stripe_rows(sizes[0], large64, small))
    rows64 = check_stripes(base, base + ".dat", large64, small,
                           sample_rows(n64, 4, seed + 7))
    log(f"[fleet 64MiB] {sizes[0]} B in {dt64:.3f} s, launches {got64}, "
        f"{rows64} of {n64} stripe rows checked (row 0 large)")
    shutil.rmtree(os.path.join(vdir, "fleet64"))
    return {"bytes": sum(sizes), "units": units, "s": dt,
            "gbps": sum(sizes) / dt / 1e9, "launches": got,
            "rows_checked": checked,
            "stages_s": {k: v for k, v in st.items() if k.endswith("_s")},
            "large64": {"units": units64, "launches": got64, "s": dt64},
            "sha256": fleet_hashes}, srcs


def flip(path: str, offset: int) -> None:
    """Flip bit 4 of one byte of a file (again to restore it)."""
    with open(path, "r+b") as f:
        b = os.pread(f.fileno(), 1, offset)
        os.pwrite(f.fileno(), bytes([b[0] ^ 0x10]), offset)


def phase_scrub(base: str, launches: dict) -> dict:
    """Phase 8: syndrome scans of a full shard set through K1: clean, two
    flips in different windows (localised), and a flip with a parity shard
    missing (found, not localised)."""
    from seaweedfs_tpu_torch.maintenance import scrub
    from seaweedfs_tpu_torch.storage.ec import ec_volume, layout

    W = scrub.DEFAULT_WINDOW
    passes = {}

    def scan(label, ev):
        st: dict = {}
        before = launches["gf_apply"]
        t0 = time.perf_counter()
        found = scrub.syndrome_scan(ev, stats=st)
        dt = time.perf_counter() - t0
        passes[label] = {"s": dt, "bytes": st["bytes"],
                         "gbps": st["bytes"] / dt / 1e9,
                         "windows": st.get("windows", 0),
                         "launches": launches["gf_apply"] - before,
                         "found": found}
        log(f"[scrub {label}] {st['bytes']} B of shards in {dt:.3f} s: "
            f"{st['bytes'] / dt / 1e9:.3f} GB/s, {st.get('windows', 0)} "
            f"windows, {passes[label]['launches']} K1 launches, {found}")
        if not st.get("windows") or \
                passes[label]["launches"] != st["windows"]:
            raise AssertionError(f"scrub {label}: {passes[label]}, want "
                                 f"one K1 launch per window checked")
        return found

    def window(w):
        return {"offset": w * W, "size": min(W, size - w * W), "columns": 1}
    ev = ec_volume.EcVolume(base)
    size = ev.shard_size
    nwin = -(-size // W)
    w5, w11, w2 = nwin // 4, 3 * nwin // 4, nwin // 2
    try:
        if scan("clean", ev) != []:
            raise AssertionError("scrub found corruption in a clean set")
        flips = [(base + layout.to_ext(5), w5 * W + 123),
                 (base + layout.to_ext(11), w11 * W + 4567 % (size - w11 * W))]
        for p, off in flips:
            flip(p, off)
        try:
            found = scan("flips in 5 and 11", ev)
        finally:
            for p, off in flips:
                flip(p, off)
        if found != [{"shard": 5, **window(w5)},
                     {"shard": 11, **window(w11)}]:
            raise AssertionError(f"scrub reported {found}")
    finally:
        ev.close()
    p12, p2 = base + layout.to_ext(12), base + layout.to_ext(2)
    os.rename(p12, p12 + ".aside")
    try:
        ev = ec_volume.EcVolume(base)
        flip(p2, w2 * W + 77)
        try:
            found = scan("shard 12 aside", ev)
        finally:
            flip(p2, w2 * W + 77)
            ev.close()
    finally:
        os.rename(p12 + ".aside", p12)
    if found != [{"shard": -1, **window(w2)}]:
        raise AssertionError(f"scrub with shard 12 aside reported {found}")
    return passes


# phase 9's topology, tests/test_regen.py's: the repairing node holds shards
# 0-5, a same-rack helper 6-8 and an other-DC helper 9-13
REPAIR_LOCAL = range(0, 6)
REPAIR_HELPERS = (("a:1", range(6, 9), 1), ("b:2", range(9, 14), 3))
REPAIR_BATCH = 16 * MIB  # ec_files.DEFAULT_BATCH
REPAIR_ALIGN = 4 * MIB  # regen.DEFAULT_SEG_ALIGN
# the repairing thread's stage seconds in rebuild_ec_reduced's stats
REPAIR_STAGES = ("read_s", "apply_s", "wait_s", "xor_s", "write_s")


class HelperStandIn:
    """The helper nodes of phases 9 and 10, computing a partial as the
    volume server's partial endpoint does: pread each asked-for shard
    range from the encode's files, stack the rows, apply the coefficient
    rows with the port's dispatch.apply_matrix on the card, return the
    bytes.  With alpha > 1 the ids are virtual (sub-row `sid % alpha` of
    file `sid // alpha`) and the range is in sub-row bytes: one pread of
    file bytes [off*alpha, (off+n)*alpha) per distinct file, then column
    `sid % alpha` of its [n, alpha] view.  Counts, per node, its calls,
    its applies (one K1 launch each), the bytes it read and the bytes it
    returned, and the seconds it spent reading (preads, columns and the
    stack) and applying (apply_matrix and `tobytes`); `die = (node, n)`
    makes `node` raise HelperDied at every call after its n-th."""

    def __init__(self, base: str, codec, n_shards: int = 14,
                 alpha: int = 1, die=None):
        from seaweedfs_tpu_torch.storage.ec import layout
        self.codec, self.alpha, self.die = codec, alpha, die
        self.fds = {i: os.open(base + layout.to_ext(i), os.O_RDONLY)
                    for i in range(n_shards)}
        self.lock = threading.Lock()
        self.calls: dict = {}
        self.applies: dict = {}
        self.read: dict = {}
        self.returned: dict = {}
        self.read_s: dict = {}
        self.apply_s: dict = {}

    def _add(self, counts: dict, node: str, v):
        with self.lock:
            counts[node] = counts.get(node, 0) + v
            return counts[node]

    def __call__(self, group, sids, coeff, off, n) -> bytes:
        import numpy as np
        from seaweedfs_tpu_torch.ops import dispatch, regen
        calls = self._add(self.calls, group.node, 1)
        if self.die and self.die[0] == group.node and calls > self.die[1]:
            raise regen.HelperDied(group.node, tuple(sids))
        a = self.alpha
        t0 = time.perf_counter()
        blocks = {}
        for fsid in sorted({s // a for s in sids}):
            data = os.pread(self.fds[fsid], n * a, off * a)
            if len(data) != n * a:
                raise regen.HelperDied(group.node, tuple(sids))
            blocks[fsid] = np.frombuffer(data, np.uint8).reshape(n, a)
        stack = np.stack([blocks[s // a][:, s % a] for s in sids])
        t1 = time.perf_counter()
        out = dispatch.apply_matrix(self.codec, coeff, stack).tobytes()
        self._add(self.read_s, group.node, t1 - t0)
        self._add(self.apply_s, group.node, time.perf_counter() - t1)
        self._add(self.applies, group.node, 1)
        self._add(self.read, group.node, n * a * len(blocks))
        self._add(self.returned, group.node, len(out))
        return out

    def close(self) -> None:
        for fd in self.fds.values():
            os.close(fd)


def repair_run(vdir: str, base: str, label: str, spec, codec, local,
               helpers, lost, hashes: list[str], launches: dict, d=None,
               die=None):
    """rebuild_ec_reduced of `lost` from a directory holding links of the
    repairing node's `local` shards (minus the lost) and the .vif, the
    `helpers` ((node, shards, locality)) answered by a HelperStandIn over
    `base`'s files.  Checks every rebuilt shard against `hashes` and that
    no .tmp is left; returns (result, stand-in, record).  A ValueError
    from the planner propagates after the .tmp check, its directory
    left for the caller to inspect."""
    from seaweedfs_tpu_torch.stats.profile import KERNELS
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    rdir = os.path.join(vdir, "repair_" + label.replace(" ", "_"))
    os.makedirs(rdir)
    rbase = os.path.join(rdir, os.path.basename(base))
    for s in local:  # only these links are the repairing node's own
        if s not in lost:
            os.link(base + layout.to_ext(s), rbase + layout.to_ext(s))
    os.link(base + ".vif", rbase + ".vif")
    groups = [{"node": node, "shards": [s for s in span if s not in lost],
               "locality": loc} for node, span, loc in helpers]
    helper = HelperStandIn(base, codec, spec.n, spec.alpha, die)
    st: dict = {}
    KERNELS.reset()
    before = launches["gf_apply"]
    t0 = time.perf_counter()
    try:
        res = ec_files.rebuild_ec_reduced(rbase, lost, groups, helper,
                                          d=d, stats=st)
    finally:
        helper.close()
        if any(p.endswith(".tmp") for p in os.listdir(rdir)):
            raise AssertionError(f"repair {label} left a .tmp file")
    dt = time.perf_counter() - t0
    got = launches["gf_apply"] - before
    for s, h in zip(lost, sha256_many([rbase + layout.to_ext(s)
                                       for s in lost])):
        if h != hashes[s]:
            raise AssertionError(f"repair {label}: shard {s} differs "
                                 f"from the encode's")
    shutil.rmtree(rdir)
    size = res["shard_size"]
    rec = {"lost": lost, "d": d, "s": dt,
           "rebuilt_gbps": len(lost) * size / dt / 1e9,
           "remote_bytes": sum(res["helper_bytes"].values()),
           "naive_remote": res["predicted"]["naive_remote"],
           "helper_bytes": res["helper_bytes"],
           "helper_reads": dict(helper.read),
           "helper_calls": dict(helper.calls), "launches": got,
           "helper_applies": sum(helper.applies.values()),
           "replans": res["replans"], "dead_helpers": res["dead_helpers"],
           "reconstruct_s": st["reconstruct_s"],
           "rebuilder_s": {k: st.get(k, 0.0) for k in REPAIR_STAGES},
           "counters": KERNELS.snapshot()["repair_partial[device]"],
           "helper_read_s": dict(helper.read_s),
           "helper_apply_s": dict(helper.apply_s)}
    return res, helper, rec


def repair_report(label: str, rec: dict, local_read=None) -> None:
    """Log a repair run; `local_read` is the repairing node's own survivor
    bytes, where the run reads all of them in every window."""
    gb = ""
    if local_read is not None:
        rec["survivors_read_gbps"] = (
            local_read + sum(rec["helper_reads"].values())) / \
            rec["s"] / 1e9
        gb = f", {rec['survivors_read_gbps']:.3f} GB/s of survivors read"
    log(f"[repair {label}] lost {rec['lost']} d={rec['d']}: "
        f"{rec['s']:.3f} s, {rec['rebuilt_gbps']:.3f} GB/s rebuilt"
        f"{gb}; remote {rec['remote_bytes']} B against naive "
        f"{rec['naive_remote']} B ({rec['helper_bytes']}); "
        f"{rec['launches']} K1 launches, {rec['helper_applies']} "
        f"by the helpers ({rec['helper_applies'] / rec['launches']:.0%})"
        f"; replans {rec['replans']}")
    c = rec["counters"]
    log(f"[repair {label}] seconds, summed over threads: every apply's "
        f"device wait {c['device_s']:.3f} / d2h "
        f"{c['d2h_s']:.3f} ({c['calls']} applies, "
        f"{c['h2d_bytes']} B in); helpers reading "
        f"{sum(rec['helper_read_s'].values()):.3f}, applying "
        f"{sum(rec['helper_apply_s'].values()):.3f}")
    log(f"[repair {label}] the rebuilder's own thread, of "
        f"{rec['reconstruct_s']:.3f} s: " + ", ".join(
            f"{k[:-2]} {v:.3f}" for k, v in rec["rebuilder_s"].items()))


def ledgers_agree(label: str, res: dict, helper) -> None:
    """Measured bytes per node == the plans' prediction == the stand-in's
    own count, exactly."""
    if not (res["helper_bytes"] == res["predicted"]["per_node"]
            == helper.returned):
        raise AssertionError(
            f"repair {label}: measured {res['helper_bytes']}, "
            f"predicted {res['predicted']['per_node']}, stand-in "
            f"{helper.returned}")


def repair_segments(size: int, n_local: int, n_remote: int) -> list[int]:
    """Segment sizes of one reduced-read pass of a `size`-byte shard, by
    the planner's rule as the reference documents it: with t = 10 -
    n_local remote shards needed and 0 < t < n_remote, n_remote rotating
    windows, else one; [0, size) cut into min(windows, ceil(size /
    align)) segments of floor(size / nseg) rounded down to the align, the
    last taking the rest, and one segment when that rounds to 0."""
    t = 10 - n_local
    windows = n_remote if 0 < t < n_remote else 1
    nseg = max(1, min(windows, -(-size // REPAIR_ALIGN)))
    seg = (size // nseg) // REPAIR_ALIGN * REPAIR_ALIGN if nseg > 1 else size
    if nseg > 1 and seg == 0:
        nseg, seg = 1, size
    return [seg] * (nseg - 1) + [size - seg * (nseg - 1)]


def repair_chunks(size: int, n_local: int, n_remote: int) -> int:
    """Batch chunks of one pass: one local apply (one K1 launch) each."""
    return sum(-(-s // REPAIR_BATCH)
               for s in repair_segments(size, n_local, n_remote))


def phase_repair(vdir: str, base: str, hashes: list[str],
                 launches: dict) -> dict:
    """Phase 9: reduced-read repair of the phase-4 shard set through
    rebuild_ec_reduced, helpers on the card (K1), four runs, each checked
    against phase 4's sha256, the plan's byte ledger and the stand-in's
    own counts."""
    from seaweedfs_tpu_torch.ops import codecs, gf_cuda, regen
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout

    if (ec_files.DEFAULT_BATCH, regen.DEFAULT_SEG_ALIGN) != \
            (REPAIR_BATCH, REPAIR_ALIGN):
        raise AssertionError("the port's repair batch or align moved; "
                             "phase 9's predictions assume 16 / 4 MiB")
    size = os.path.getsize(base + layout.to_ext(0))
    codec = gf_cuda.get_codec(10, 4)
    spec = codecs.parse_tag("rs_10_4")
    runs = {}

    def run(label, lost, d=None, die=None):
        res, helper, rec = repair_run(vdir, base, label, spec, codec,
                                      REPAIR_LOCAL, REPAIR_HELPERS, lost,
                                      hashes, launches, d=d, die=die)
        runs[label] = rec
        return res, helper, rec

    # (a) one window: the repairing node's 5 shards, a:1's 3 and b:2's 9, 10
    res, helper, rec = run("a", [3], d=10)
    ledgers_agree("a", res, helper)
    chunks = -(-size // REPAIR_BATCH)
    if rec["launches"] != 3 * chunks or \
            rec["helper_applies"] != 2 * chunks:
        raise AssertionError(f"repair a: {rec['launches']} K1 launches "
                             f"({rec['helper_applies']} by helpers), "
                             f"want 3 x {chunks}")
    if res["helper_bytes"] != {"a:1": size, "b:2": size} or \
            res["predicted"]["naive_remote"] != 5 * size:
        raise AssertionError(f"repair a: {res['helper_bytes']} remote, "
                             f"naive {res['predicted']['naive_remote']}")
    repair_report("a", rec, 5 * size)

    # (b) every survivor: 8 rotating windows over the 8 remote shards
    res, helper, rec = run("b", [3])
    ledgers_agree("b", res, helper)
    chunks = repair_chunks(size, 5, 8)
    if rec["launches"] != rec["helper_applies"] + chunks:
        raise AssertionError(f"repair b: {rec['launches']} K1 launches, "
                             f"want {rec['helper_applies']} helper + "
                             f"{chunks} local chunks")
    for node, span, _ in REPAIR_HELPERS:
        held = len([s for s in span if s != 3]) * size
        if not 0 < helper.read[node] < held:
            raise AssertionError(f"repair b: {node} read "
                                 f"{helper.read[node]} B of its {held}")
    rec["local_chunks"] = chunks
    repair_report("b", rec, 5 * size)

    # (c) two losses in sequence; shard 1 joins the repairing node's survivors
    res, helper, rec = run("c", [1, 12])
    ledgers_agree("c", res, helper)
    chunks = repair_chunks(size, 5, 7) + repair_chunks(size, 6, 7)
    if rec["launches"] != rec["helper_applies"] + chunks:
        raise AssertionError(f"repair c: {rec['launches']} K1 launches, "
                             f"want {rec['helper_applies']} helper + "
                             f"{chunks} local chunks")
    repair_report("c", rec, 11 * size)

    # (d) as (b), with a:1 dying at its third call (at its last one on a
    # volume too small for three): one replan onto the repairing node and b:2
    # alone.  The payload b:2 was computing when a:1 died may or may not
    # have been taken in before the replan
    res, helper, rec = run("d", [3], die=("a:1", min(
        2, runs["b"]["helper_calls"]["a:1"] - 1)))
    chunk = min(repair_segments(size, 5, 8)[0], REPAIR_BATCH)
    lag = helper.returned.get("b:2", 0) - res["helper_bytes"].get("b:2", 0)
    if res["replans"] < 1 or \
            [h["node"] for h in res["dead_helpers"]] != ["a:1"] or \
            res["predicted"]["per_node"] != {"b:2": size} or \
            res["helper_bytes"].get("a:1", 0) != \
            helper.returned.get("a:1", 0) or lag not in (0, chunk):
        raise AssertionError(f"repair d: {rec}, stand-in returned "
                             f"{helper.returned}")
    repair_report("d", rec)
    return runs


# phase 10's repair topologies: LRC on phase 9's; MSR on four nodes, where
# c:3 holds one shard so that losing it still leaves d = 16 survivors
CODEC_REPAIR_HELPERS = {
    "lrc": REPAIR_HELPERS,
    "msr": (("a:1", range(6, 12), 1), ("c:3", (12,), 2),
            ("b:2", range(13, 18), 3)),
}
LRC_UNDECODABLE = ("lrc: cannot reconstruct [12] from [0, 1, 2, 3, 4, 5, 7, "
                   "8, 9, 10] (undecodable loss pattern)")


def codec_repairs(vdir: str, base: str, spec, hashes: list[str],
                  launches: dict) -> dict:
    """Phase 10's reduced-read repairs of the encode's LRC or MSR shard
    set, each checked against the encode's sha256, the plan's byte
    ledger, the stand-in's own count and the K1 launches the plan
    predicts.  LRC: [2] inside its group, [12] (a global) at d = 10, and
    [12] at d = None, which must raise the reference's ValueError
    (ROADMAP fault 3.5).  MSR: [0], [0, 13], and [0] with c:3 dying at
    its third call."""
    from seaweedfs_tpu_torch.ops import codecs
    codec = codecs.make_codec(spec.tag)
    helpers = CODEC_REPAIR_HELPERS[spec.family]
    size = os.path.getsize(base + ".ec00")
    runs = {}

    def run(label, lost, d=None, die=None):
        res, helper, rec = repair_run(vdir, base, label, spec, codec,
                                      REPAIR_LOCAL, helpers, lost, hashes,
                                      launches, d=d, die=die)
        runs[label] = rec
        return res, helper, rec

    def expect(label, rec, res, per_node, naive, launched, applies):
        if res["predicted"]["per_node"] != per_node or \
                res["predicted"]["naive_remote"] != naive or \
                rec["launches"] != launched or \
                rec["helper_applies"] != applies:
            raise AssertionError(
                f"repair {label}: predicted {res['predicted']}, "
                f"{rec['launches']} K1 launches ({rec['helper_applies']} "
                f"by helpers); want {per_node}, naive {naive}, "
                f"{launched} ({applies})")

    if spec.family == "lrc":
        chunks = -(-size // REPAIR_BATCH)
        label = "lrc [2]"
        res, helper, rec = run(label, [2])
        ledgers_agree(label, res, helper)
        expect(label, rec, res, {"b:2": size}, 5 * size, 2 * chunks, chunks)
        repair_report(label, rec, 4 * size)
        label = "lrc [12] d=10"
        res, helper, rec = run(label, [12], d=10)
        ledgers_agree(label, res, helper)
        expect(label, rec, res, {"a:1": size, "b:2": size}, 4 * size,
               3 * chunks, 2 * chunks)
        repair_report(label, rec, 6 * size)
        if size > REPAIR_ALIGN:  # stripes over more than one window
            label = "lrc [12] d=None"
            before = launches["gf_apply"]
            try:
                run(label, [12])
            except ValueError as e:
                if str(e) != LRC_UNDECODABLE or \
                        launches["gf_apply"] != before or os.path.exists(
                            os.path.join(vdir, "repair_lrc_[12]_d=None",
                                         os.path.basename(base) + ".ec12")):
                    raise AssertionError(f"repair {label}: {e!r}") from e
                runs[label] = {"raised": str(e)}
                log(f"[repair {label}] ValueError as the reference: {e}")
            else:
                raise AssertionError(f"repair {label} planned; the "
                                     "reference's planner raises")
        return runs

    a = spec.alpha
    sub = size // a
    batch = REPAIR_BATCH // a
    chunks = -(-sub // batch)
    label = "msr [0]"
    res, helper, rec = run(label, [0])
    ledgers_agree(label, res, helper)
    expect(label, rec, res, {"a:1": 6 * sub, "c:3": sub, "b:2": 4 * sub},
           4 * size, 8 * chunks, 3 * chunks)
    repair_report(label, rec, 5 * size)
    label = "msr [0, 13]"
    res, helper, rec = run(label, [0, 13])
    ledgers_agree(label, res, helper)
    expect(label, rec, res, {"a:1": 12 * sub, "c:3": 2 * sub,
                             "b:2": 7 * sub}, 7 * size, 16 * chunks,
           6 * chunks)
    repair_report(label, rec, 11 * size)
    # c:3 dies at its third call (its last, on a volume of fewer chunks):
    # one replan over the repairing node, a:1 and b:2 (5 shards).  In the
    # dying chunk the repairing node applies its 2 local matrices and a:1
    # and b:2 their partials; a payload the rebuilder took in before it
    # met c:3's error costs a post apply and counts in helper_bytes
    label = "msr [0] c:3 dies"
    after = min(2, chunks - 1)
    res, helper, rec = run(label, [0], die=("c:3", after))
    done = sum(min(batch, sub - i * batch) for i in range(after))
    dying = min(batch, sub - after * batch)
    taken = 0
    for node, rows in (("a:1", 6), ("b:2", 4)):
        lag = helper.returned[node] - res["helper_bytes"][node]
        first = res["helper_bytes"][node] - res["predicted"]["per_node"][node]
        if (lag, first) == (0, rows * (done + dying)):
            taken += 1
        elif (lag, first) != (rows * dying, rows * done):
            raise AssertionError(f"repair {label}: {node} measured "
                                 f"{res['helper_bytes'][node]}, stand-in "
                                 f"{helper.returned[node]}")
    if res["replans"] != 1 or res["dead_helpers"] != [
            {"node": "c:3", "shards": [12]}] or \
            not res["helper_bytes"].get("c:3", 0) == \
            helper.returned.get("c:3", 0) == done:
        raise AssertionError(f"repair {label}: {res}")
    expect(label, rec, res, {"a:1": 6 * sub, "b:2": 5 * sub}, 4 * size,
           8 * after + 4 + taken + 6 * chunks, 3 * after + 2 + 2 * chunks)
    rec["payloads_taken_before_replan"] = taken
    repair_report(label, rec)
    return runs


# phase 10: (tag, loss sets read in turn, the data shard flipped for scrub)
CODEC_RUNS = (("lrc_10_2_2", ([2], [2, 5, 11]), 7),
              ("msr_9_16", ([0, 13],), 4))
CODEC_COLS = 64 * 1024  # parity bytes checked per sampled stripe row


def check_codec_stripes(base: str, dat_path: str, spec, parity, rows,
                        seed: int) -> int:
    """Hold an LRC or MSR shard set against its .dat: each shard's size
    against `layout.shard_file_size` at the code's k; for each stripe row
    in `rows` (indices into `stripe_rows`), the k data shards against the
    .dat bytes, zero past its end, and the m parity shards over a random
    CODEC_COLS-wide window against numpy's GF(2^8) product of the code's
    parity matrix (MSR: on the window's de-interleaved sub-rows, then
    interleaved back), which shares nothing with the kernel.  Returns the
    number of rows checked."""
    import numpy as np
    from seaweedfs_tpu_torch.ops import gf
    from seaweedfs_tpu_torch.storage.ec import layout

    large, small = layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE
    k, m, a = spec.k, spec.m, spec.alpha
    dat_size = os.path.getsize(dat_path)
    stripes = stripe_rows(dat_size, large, small, k)
    size = layout.shard_file_size(dat_size, large, small, data_shards=k)
    if size != sum(block for _, block, _ in stripes):
        raise AssertionError(f"{base}: layout.shard_file_size {size} != "
                             f"the rows' {stripes[-1:]}")
    rng = np.random.default_rng(seed)
    fds = [os.open(p, os.O_RDONLY) for p in
           [base + layout.to_ext(i) for i in range(spec.n)] + [dat_path]]
    try:
        for i, fd in enumerate(fds[:-1]):
            if os.fstat(fd).st_size != size:
                raise AssertionError(f"{base} shard {i}: "
                                     f"{os.fstat(fd).st_size} B, layout "
                                     f"says {size}")
        for r in rows:
            start, block, off = stripes[r]
            data = np.zeros((k, block), np.uint8)
            for j in range(k):
                lo = start + j * block
                n = max(0, min(block, dat_size - lo))
                data[j, :n] = np.frombuffer(os.pread(fds[-1], n, lo),
                                            np.uint8)
                got = np.frombuffer(os.pread(fds[j], block, off), np.uint8)
                if not np.array_equal(got, data[j]):
                    raise AssertionError(f"{base} data shard {j} differs "
                                         f"in stripe row {r}")
            w = min(CODEC_COLS, block)
            c0 = int(rng.integers(0, (block - w) // a + 1)) * a
            x = data[:, c0:c0 + w]
            if a > 1:
                virt = x.reshape(k, w // a, a).transpose(0, 2, 1).reshape(
                    k * a, w // a)
                want = gf.gf_matmul(parity, virt).reshape(
                    m, a, w // a).transpose(0, 2, 1).reshape(m, w)
            else:
                want = gf.gf_matmul(parity, x)
            for i in range(m):
                got = np.frombuffer(os.pread(fds[k + i], w, off + c0),
                                    np.uint8)
                if not np.array_equal(got, want[i]):
                    raise AssertionError(
                        f"{base} parity shard {k + i} differs in stripe "
                        f"row {r}, bytes [{c0}, {c0 + w}) of the block")
    finally:
        for fd in fds:
            os.close(fd)
    return len(rows)


def touching_needles(ev, expect, lost) -> list[int]:
    """Needles with a byte on one of the `lost` shards, by the layout."""
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout
    out = []
    for nid in expect:
        off, size = ev.find_needle(nid)
        ivs = layout.locate_data(ev.large_block, ev.small_block, ev.dat_size,
                                 off, t.actual_size(size, ev.version),
                                 data_shards=ev.spec.k)
        if any(iv.to_shard_id_and_offset()[0] in lost for iv in ivs):
            out.append(nid)
    return out


def phase_codecs(vdir: str, dat_path: str, expect: dict, blob: bytes,
                 seed: int, launches: dict) -> dict:
    """Phase 10: the phase-3 .dat encoded, read degraded, rebuilt and
    scrubbed as an lrc_10_2_2 and as an msr_9_16 volume, each step's K1
    launches against the count the layout and the row-block split
    predict.  The LRC shard set is deleted after its checks; the MSR one
    is kept for phase 17 (`kept_base`)."""
    from seaweedfs_tpu_torch.maintenance import scrub
    from seaweedfs_tpu_torch.ops import codecs, lrc
    from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume, layout

    large, small = layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE
    batch = ec_files.DEFAULT_BATCH
    dat_size = os.path.getsize(dat_path)
    out = {}
    for tag, loss_sets, flipped in CODEC_RUNS:
        spec = codecs.parse_tag(tag)
        code = codecs.make_codec(tag).code  # MSR: the inner [72, 72] code
        a = spec.alpha
        cdir = os.path.join(vdir, "codec_" + tag)
        os.makedirs(cdir)
        base = os.path.join(cdir, "1")
        os.link(dat_path, base + ".dat")
        os.link(dat_path[: -len(".dat")] + ".idx", base + ".idx")
        shard = [base + layout.to_ext(i) for i in range(spec.n)]
        rec: dict = {}

        # encode: one apply of the [m*a, k*a] parity matrix per unit
        units = predict_units(dat_size, large, small, k=spec.k)
        want = units * row_blocks(spec.m * a)
        st: dict = {}
        before = launches["gf_apply"]
        t0 = time.perf_counter()
        ec_files.write_ec_files(base, codec_tag=tag, stats=st)
        ec_files.write_sorted_ecx(base + ".idx")
        dt = time.perf_counter() - t0
        got = launches["gf_apply"] - before
        if got != want:
            raise AssertionError(f"{tag} encode: {got} K1 launches, the "
                                 f"layout predicts {units} units x "
                                 f"{row_blocks(spec.m * a)} row blocks")
        if (ec_files.read_vif(base) or {}).get("codec") != tag:
            raise AssertionError(f"{tag}: .vif {ec_files.read_vif(base)}")
        n_rows = len(stripe_rows(dat_size, large, small, spec.k))
        checked = check_codec_stripes(base, dat_path, spec,
                                      code.parity_matrix,
                                      sample_rows(n_rows, 8, seed + 8),
                                      seed + 9)
        hashes = sha256_many(shard)
        rec["encode"] = {"s": dt, "gbps": dat_size / dt / 1e9,
                         "launches": got, "units": units,
                         "rows_checked": checked, "sha256": hashes,
                         "vif_sha256": sha256(base + ".vif"),
                         "shard_bytes": os.path.getsize(shard[0]),
                         "stages_s": {k_: v for k_, v in st.items()
                                      if k_.endswith("_s")}}
        log(f"[codecs {tag} encode] {dat_size / dt / 1e9:.3f} GB/s "
            f"({dt:.2f} s), {got} K1 launches = {units} units x "
            f"{row_blocks(spec.m * a)} row blocks; {checked} of {n_rows} "
            f"stripe rows == .dat and numpy's parity; {spec.n} shards of "
            f"{os.path.getsize(shard[0])} B")

        # reduced-read repair, on links of the encode's shards
        rec["repair"] = codec_repairs(vdir, base, spec, hashes, launches)

        # degraded reads: one decode apply (of at most 16 rows: one
        # launch) per needle with a byte on a lost shard
        gone: list[int] = []
        for lost in loss_sets:
            for i in lost:
                if i not in gone:
                    os.remove(shard[i])
            gone = sorted(set(gone) | set(lost))
            ev = ec_volume.EcVolume(base)
            gathered: list = []
            orig = ev._gather_survivors

            def spy(exclude, segs, shard_reader=None, want=None, need=None,
                    orig=orig, gathered=gathered):
                rows = orig(exclude, segs, shard_reader, want=want,
                            need=need)
                gathered.append(sorted(rows))
                return rows
            ev._gather_survivors = spy
            try:
                reads = touching_needles(ev, expect, set(gone))
                before = launches["gf_apply"]
                t0 = time.perf_counter()
                for nid in reads:
                    n = ev.read_needle(nid)  # parses with the CRC checked
                    cookie, lo, hi = expect[nid]
                    if n.cookie != cookie or n.data != blob[lo:hi]:
                        raise AssertionError(f"{tag} degraded read of "
                                             f"needle {nid} differs")
                dt = time.perf_counter() - t0
            finally:
                ev.close()
            got = launches["gf_apply"] - before
            if not reads or got != len(reads) or len(gathered) != len(reads):
                raise AssertionError(f"{tag} lost {gone}: {len(reads)} reads, "
                                     f"{got} K1 launches, {len(gathered)} "
                                     f"gathers; want one each per read")
            widest = max(len(g) for g in gathered)
            if spec.family == "lrc" and len(gone) == 1:
                lc = lrc.get_code(*spec.params)
                members = set(lc.group_members(lc.group_of(gone[0])))
                if widest > lc.r + 1 or \
                        any(not set(g) <= members for g in gathered):
                    raise AssertionError(f"{tag} lost {gone}: a read left "
                                         f"group {sorted(members)}")
            rec[f"degraded_{'_'.join(map(str, gone))}"] = {
                "reads": len(reads), "s": dt, "reads_per_s": len(reads) / dt,
                "launches": got, "widest_gather": widest}
            log(f"[codecs {tag} degraded] lost {gone}: {len(reads)} needles "
                f"touching them equal, {len(reads) / dt:.1f} reads/s, "
                f"{got} K1 launches, at most {widest} shards gathered")

        # rebuild: one decode apply per batch of the shard
        size = os.path.getsize(shard[next(i for i in range(spec.n)
                                          if i not in gone)])
        want = -(-size // batch) * row_blocks(len(gone) * a)
        st = {}
        before = launches["gf_apply"]
        t0 = time.perf_counter()
        rebuilt = ec_files.rebuild_ec_files(base, stats=st)
        dt = time.perf_counter() - t0
        got = launches["gf_apply"] - before
        if sorted(rebuilt) != gone or got != want or st["codec"] != tag:
            raise AssertionError(f"{tag} rebuilt {rebuilt} in {got} K1 "
                                 f"launches ({st}); want {gone} in {want}")
        for i, h in zip(gone, sha256_many([shard[i] for i in gone])):
            if h != hashes[i]:
                raise AssertionError(f"{tag} rebuilt shard {i} differs")
        rec["rebuild"] = {"s": dt, "launches": got,
                          "read_gbps": st["bytes"] / dt / 1e9,
                          "rebuilt_gbps": len(gone) * size / dt / 1e9}
        log(f"[codecs {tag} rebuild] {gone} sha256-equal in {dt:.3f} s: "
            f"{st['bytes'] / dt / 1e9:.3f} GB/s survivors read, {got} K1 "
            f"launches")

        # scrub: one parity apply per window; a flip found, localised
        # only where a = 1
        W = scrub.DEFAULT_WINDOW - scrub.DEFAULT_WINDOW % a
        nwin = -(-size // W)
        w = nwin // 3
        passes = {}
        ev = ec_volume.EcVolume(base)
        try:
            for label in ("clean", f"flip in {flipped}"):
                off = w * W + 123
                if label != "clean":
                    flip(shard[flipped], off)
                st = {}
                before = launches["gf_apply"]
                t0 = time.perf_counter()
                try:
                    found = scrub.syndrome_scan(ev, st)
                finally:
                    if label != "clean":
                        flip(shard[flipped], off)
                dt = time.perf_counter() - t0
                got = launches["gf_apply"] - before
                want = st.get("windows", 0) * row_blocks(spec.m * a)
                if st.get("windows") != nwin or got != want:
                    raise AssertionError(f"{tag} scrub {label}: {st}, {got} "
                                         f"K1 launches; want {nwin} windows, "
                                         f"{want} launches")
                expect_found = [] if label == "clean" else [{
                    "shard": flipped if a == 1 else -1, "offset": w * W,
                    "size": min(W, size - w * W)}]
                if [{k_: f[k_] for k_ in ("shard", "offset", "size")}
                        for f in found] != expect_found or \
                        any(not 1 <= f["columns"] <= a for f in found):
                    raise AssertionError(f"{tag} scrub {label}: {found}")
                passes[label] = {"s": dt, "gbps": st["bytes"] / dt / 1e9,
                                 "windows": nwin, "launches": got,
                                 "found": found}
                log(f"[codecs {tag} scrub {label}] "
                    f"{st['bytes'] / dt / 1e9:.3f} GB/s, {nwin} windows, "
                    f"{got} K1 launches, {found}")
        finally:
            ev.close()
        rec["scrub"] = passes
        if spec.family == "msr":
            # phase 17 repairs links of it through the volume server
            rec["kept_base"] = base
        else:
            shutil.rmtree(cdir)
        out[tag] = rec
    return out


def codecs_worker(vdir: str, dat_path: str, seed: int, target: int) -> int:
    """Phase 10 in a process of its own (`--codecs-worker`): the needles
    drawn again from `seed` as phase 3 drew them and the card's context
    made, then, at a line on stdin (the parent's phase 13 done),
    `phase_codecs` over `dat_path` (a copy of the phase-3 .dat, which
    phase 14 appends to), and one JSON line: the phase's record, its
    launches and its staged copies."""
    import torch
    from seaweedfs_tpu_torch.ops import gf_cuda
    expect, blob = draw_needles(seed, target)
    torch.zeros(1, device="cuda")
    if not sys.stdin.readline():
        return 1  # the parent ended before its start signal
    gf_cuda.reset_launches()
    rec = phase_codecs(vdir, dat_path, expect, blob, seed, gf_cuda.LAUNCHES)
    print(json.dumps({"codecs": rec, "launches": dict(gf_cuda.LAUNCHES),
                      "staged": dict(gf_cuda.STAGED)}), flush=True)
    return 0


def start_worker(vdir: str, name: str, argv: list) -> subprocess.Popen:
    """A child running this script with `argv`, its output into
    `<vdir>/<name>.log` (read at the join, so a full pipe never stalls
    it)."""
    out = open(os.path.join(vdir, f"{name}.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *argv],
        stdin=subprocess.PIPE, stdout=out, stderr=subprocess.STDOUT,
        text=True)
    proc.out = out
    return proc


def go_worker(proc) -> None:
    """The child's start signal."""
    proc.t_go = time.perf_counter()
    try:
        proc.stdin.write("go\n")
        proc.stdin.close()
    except BrokenPipeError:
        pass  # the child died: the join says why


def join_worker(proc, key: str, phase: int) -> tuple[dict, dict, dict, float]:
    """Wait for the child, print its lines, and return its phase record
    (under `key`), launches, staged copies and the seconds the parent
    waited."""
    t0 = time.perf_counter()
    rc = proc.wait()
    waited = time.perf_counter() - t0
    proc.out.seek(0)
    lines = proc.out.read().splitlines()
    proc.out.close()
    if rc != 0 or not lines or not lines[-1].startswith(f'{{"{key}"'):
        raise AssertionError(f"phase {phase}'s child exited {rc}:\n" +
                             "\n".join(lines[-40:]))
    for line in lines[:-1]:
        print(line, flush=True)
    doc = json.loads(lines[-1])
    return doc[key], doc["launches"], doc["staged"], waited


def stop_worker(proc) -> None:
    """Kill the child on the way out of a failed run."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    if not proc.stdin.closed:
        proc.stdin.close()
    proc.out.close()


def cpu_model() -> str:
    """The host CPU's `model name` from /proc/cpuinfo; where it is absent
    or "unknown" (as on some virtualised hosts), its vendor, family,
    model and clock."""
    fields: dict = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, val = line.partition(":")
            fields.setdefault(key.strip(), val.strip())
            if not line.strip():
                break  # the first processor is enough
    name = fields.get("model name", "")
    if name and name != "unknown":
        return name
    return (f"{fields.get('vendor_id', '?')} family "
            f"{fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')}, {fields.get('cpu MHz', '?')} MHz "
            f"(model name {name or 'absent'})")


def card_name_power() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def baseline_refshape(ndir: str, seed: int) -> float:
    """The reference's CPU baseline (its bench's
    `_bench_baseline_refshape`, after ec_encoder.go:198-224): 256 KiB
    strips read from a file, parity by the native codec forced to AVX2,
    all 14 shard files written inside the timed loop; 16 stripes of 10
    strips a pass, best of 3.  Returns GB/s of volume data.  The written
    parity of the first stripe is checked against numpy's GF product."""
    import numpy as np
    from seaweedfs_tpu_torch import native
    from seaweedfs_tpu_torch.ops import gf, native_codec
    from seaweedfs_tpu_torch.ops.rows import device_empty

    codec = native_codec.get_codec(10, 4)
    strip, strips = 256 * 1024, 16
    payload = np.random.default_rng(seed + 11).integers(
        0, 256, strips * 10 * strip, dtype=np.uint8)
    bdir = os.path.join(ndir, "baseline")
    os.makedirs(bdir)
    dat = os.path.join(bdir, "v.dat")
    payload.tofile(dat)
    batch = device_empty((10, strip), codec.device)
    bn = batch.numpy()
    native.set_gf_impl(native.GF_IMPL_AVX2)
    best = float("inf")
    for _ in range(3):
        outs = [open(os.path.join(bdir, f"v.ec{i:02d}"), "wb")
                for i in range(14)]
        t0 = time.perf_counter()
        with open(dat, "rb") as f:
            for _ in range(strips):
                for j in range(10):
                    bn[j] = np.frombuffer(f.read(strip), np.uint8)
                parity = codec.encode_parity(batch).numpy()
                for j in range(10):
                    outs[j].write(bn[j].tobytes())
                for i in range(4):
                    outs[10 + i].write(parity[i].tobytes())
        for o in outs:
            o.close()
        best = min(best, time.perf_counter() - t0)
    first = payload[:10 * strip].reshape(10, strip)
    want = gf.gf_matmul(codec.code.parity_matrix, first)
    for i in range(4):
        with open(os.path.join(bdir, f"v.ec{10 + i:02d}"), "rb") as f:
            if f.read(strip) != want[i].tobytes():
                raise AssertionError(f"baseline parity shard {10 + i} "
                                     f"differs from numpy's")
    shutil.rmtree(bdir)
    return strips * 10 * strip / best / 1e9


def phase_native(vdir: str, dat_path: str, hashes: list[str], expect: dict,
                 blob: bytes, reads: list[int], k1_io: dict, card: dict,
                 seed: int, launches: dict) -> dict:
    """Phase 11: the native host codec on the card's host, held against
    the card.  Its product against K1's output and the plain version on
    phase 2's inputs, then timed; the reference's AVX2 baseline; the
    phase-3 .dat encoded with WEEDTPU_EC_CODEC=native under AVX2 and
    under auto, each run from no shard set as phase 4's are, each shard
    set sha256-equal to phase 4's; phase 5's degraded reads and phase 6's loss rebuilt
    host-serial; the card-vs-CPU ratios, all measured in this call.  The
    native paths launch no kernel (checked).  The GF impl and the
    environment are restored on the way out; a failure goes on up."""
    import numpy as np
    import torch
    from seaweedfs_tpu_torch import native
    from seaweedfs_tpu_torch.ops import gf, gf_cuda
    from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume, layout

    from seaweedfs_tpu_torch.ops.native_codec import NativeRSCodec

    saved = os.environ.get("WEEDTPU_EC_CODEC")
    before = dict(launches)
    names = native.IMPL_NAMES
    out: dict = {}
    try:
        native.set_gf_impl(native.GF_IMPL_AUTO)
        auto = native.gf_impl()
        impls = [native.GF_IMPL_AVX2] + \
            ([native.GF_IMPL_GFNI] if auto == native.GF_IMPL_GFNI else [])
        out["cpu"] = {"model": cpu_model(), "cores": os.cpu_count(),
                      "auto_impl": names[auto]}
        log(f"[native] CPU {out['cpu']['model']}, {os.cpu_count()} cores, "
            f"auto impl {names[auto]}")

        # the product, byte-equal to K1's and the plain version's, then
        # timed: GB/s of input, median of 7 calls after the checked one
        kern = []
        for case, (C, x, k1_out) in k1_io.items():
            m, (k, n) = C.shape[0], x.shape
            bit = torch.from_numpy(gf.gf_matrix_to_bitmatrix(C)).to(
                torch.float32).cuda()
            plain = gf_cuda.gf_apply_plain(bit, torch.from_numpy(
                np.ascontiguousarray(x)).cuda()).cpu().numpy()
            got = np.empty((m, n), np.uint8)
            rows, outs = list(x), list(got)
            for impl in impls:
                native.set_gf_impl(impl)
                got.fill(0)
                native.gf_matmul_ptrs(C, rows, outs, n)
                if not np.array_equal(got, k1_out) or \
                        not np.array_equal(got, plain):
                    raise AssertionError(f"native {names[impl]} != K1 / "
                                         f"plain at {case}")
                times = []
                for _ in range(7):
                    t0 = time.perf_counter()
                    native.gf_matmul_ptrs(C, rows, outs, n)
                    times.append(time.perf_counter() - t0)
                t = statistics.median(times)
                kern.append({"case": f"[{m},{k}]@[{k},{n}]",
                             "impl": names[impl], "ms": t * 1e3,
                             "gbps": k * n / t / 1e9})
                log(f"[native] {names[impl]} [{m},{k}]@[{k},{n // MIB}MiB]"
                    f": == K1 and plain; {t * 1e3:.3f} ms, "
                    f"{k * n / t / 1e9:.3f} GB/s of input")
            native.set_gf_impl(native.GF_IMPL_AUTO)
        out["kernel"] = kern

        ndir = os.path.join(vdir, "native")
        os.makedirs(ndir)
        out["baseline_refshape_gbps"] = baseline_refshape(ndir, seed)
        native.set_gf_impl(native.GF_IMPL_AUTO)
        log(f"[native] baseline_refshape_gbps "
            f"{out['baseline_refshape_gbps']:.4f} (256 KiB strips, AVX2, "
            f"14 shard files written in the loop, best of 3)")

        base = os.path.join(ndir, "1")
        os.link(dat_path, base + ".dat")
        os.link(dat_path[: -len(".dat")] + ".idx", base + ".idx")
        shard = [base + layout.to_ext(i) for i in range(14)]
        dat_size = os.path.getsize(dat_path)
        os.environ["WEEDTPU_EC_CODEC"] = "native"
        encodes = {}
        for impl in (native.GF_IMPL_AVX2, native.GF_IMPL_AUTO):
            label = names.get(impl, "auto")
            for p in shard:  # no shard set at the start, as in phase 4
                if os.path.exists(p):
                    os.remove(p)
            native.set_gf_impl(impl)
            st: dict = {}
            t0 = time.perf_counter()
            ec_files.write_ec_files(base, stats=st)
            ec_files.write_sorted_ecx(base + ".idx")
            dt = time.perf_counter() - t0
            native.set_gf_impl(native.GF_IMPL_AUTO)
            if sha256_many(shard) != hashes:
                raise AssertionError(f"native {label} encode: shards "
                                     f"differ from phase 4's")
            if st["mode"] != "pipelined":
                raise AssertionError(f"native {label}: mode {st['mode']}")
            stages = {k: v for k, v in st.items() if k.endswith("_s")}
            encodes[label] = {"s": dt, "gbps": dat_size / dt / 1e9,
                              "stream_gbps": dat_size / st["wall_s"] / 1e9,
                              "mode": st["mode"], "stages_s": stages}
            log(f"[native] encode {label}: 14 shards sha256 == phase 4's, "
                f"{dat_size / dt / 1e9:.3f} GB/s ({dt:.3f} s; the encode "
                f"stream {dat_size / st['wall_s'] / 1e9:.3f} GB/s), mode "
                f"{st['mode']}; " + ", ".join(
                    f"{k} {v:.3f}" for k, v in sorted(stages.items())))
        out["encode"] = encodes

        lost = [0, 3, 10, 12]
        for i in lost:
            os.remove(shard[i])
        ev = ec_volume.EcVolume(base)
        if not isinstance(ev.codec, NativeRSCodec):
            raise AssertionError("EcVolume did not take the native codec")
        t0 = time.perf_counter()
        for nid in reads:
            n = ev.read_needle(nid)  # parses with the CRC checked
            cookie, lo, hi = expect[nid]
            if n.cookie != cookie or n.data != blob[lo:hi]:
                raise AssertionError(f"native degraded read of needle "
                                     f"{nid} differs")
        dt = time.perf_counter() - t0
        batches = ev.read_stats["reconstruct_batches"]
        ev.close()
        out["degraded"] = {"reads": len(reads), "s": dt,
                           "reads_per_s": len(reads) / dt,
                           "reconstruct_batches": batches}
        log(f"[native] degraded: {len(reads)} needles equal (CRC and "
            f"bytes), {len(reads) / dt:.1f} reads/s, {batches} "
            f"reconstructions")

        shard_size = os.path.getsize(shard[1])
        st = {}
        t0 = time.perf_counter()
        rebuilt = ec_files.rebuild_ec_files(base, stats=st)
        dt = time.perf_counter() - t0
        if sorted(rebuilt) != lost or st["mode"] != "host-serial":
            raise AssertionError(f"native rebuild: {rebuilt}, {st['mode']}")
        if sha256_many([shard[i] for i in lost]) != \
                [hashes[i] for i in lost]:
            raise AssertionError("native rebuilt shards differ")
        out["rebuild"] = {"s": dt, "mode": st["mode"],
                          "read_gbps": 10 * shard_size / dt / 1e9,
                          "stages_s": {k: v for k, v in st.items()
                                       if k.endswith("_s")}}
        log(f"[native] rebuild host-serial: 4 shards sha256-equal in "
            f"{dt:.3f} s, {10 * shard_size / dt / 1e9:.3f} GB/s survivors "
            f"read; reconstruct {st['reconstruct_s']:.3f} s, write "
            f"{st.get('write_s', 0):.3f} s, stall "
            f"{st.get('stall_s', 0):.3f} s")
        if launches != before:
            raise AssertionError(f"the native paths launched kernels: "
                                 f"{before} -> {launches}")

        # end to end on both sides: write_ec_files and write_sorted_ecx,
        # each started with the .dat cached and no shard set on disk
        native_avx2 = encodes["avx2"]
        ratios = {
            "card_encode_over_native_avx2_pipelined":
                card["encode_gbps"] / native_avx2["gbps"],
            "card_encode_over_baseline_refshape":
                card["encode_gbps"] / out["baseline_refshape_gbps"],
            "card_rebuild_over_host_serial_rebuild":
                card["rebuild_gbps"] / out["rebuild"]["read_gbps"]}
        out["ratios"] = ratios
        out["card"] = card_name_power()
        log(f"[native] ratios, this call ({out['card']}; CPU "
            f"{out['cpu']['model']}): card warm encode "
            f"{card['encode_gbps']:.3f} GB/s over native AVX2 pipelined "
            f"{native_avx2['gbps']:.3f} = "
            f"{ratios['card_encode_over_native_avx2_pipelined']:.3f}; "
            f"over baseline_refshape "
            f"{out['baseline_refshape_gbps']:.3f} = "
            f"{ratios['card_encode_over_baseline_refshape']:.3f}; card "
            f"rebuild {card['rebuild_gbps']:.3f} over host-serial "
            f"{out['rebuild']['read_gbps']:.3f} GB/s survivors read = "
            f"{ratios['card_rebuild_over_host_serial_rebuild']:.3f}")
        shutil.rmtree(ndir)
    finally:
        native.set_gf_impl(native.GF_IMPL_AUTO)
        if saved is None:
            os.environ.pop("WEEDTPU_EC_CODEC", None)
        else:
            os.environ["WEEDTPU_EC_CODEC"] = saved
    return out

# phase 12's arms: (label, codec, WEEDTPU_AIO, WEEDTPU_AIO_DIRECT)
WRITER_ARMS = [("card pwritev", "cuda", "pwritev", "0"),
               ("card uring", "cuda", "uring", "0"),
               ("card uring+direct", "cuda", "uring", "1"),
               ("native pwritev", "native", "pwritev", "0"),
               ("native uring+direct", "native", "uring", "1")]
WRITER_KEYS = ("write_data_s", "write_parity_s", "write_s", "submit_s",
               "complete_s", "aio_mode", "aio_direct_bytes",
               "aio_degraded_engines", "overlap_frac")
FLEET_ARMS = {"A": {}, "B": {"WEEDTPU_EC_FLUSH_BYTES": "1"}}


def sha256_many(paths: list[str]) -> list[str]:
    """sha256 of each file, eight at a time (hashlib drops the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(8) as ex:
        return list(ex.map(sha256, paths))


def mount_of(path: str) -> tuple[str, str]:
    """(filesystem type, mount point) of the mount holding `path`, from
    /proc/mounts: the longest mount point that is a prefix of it."""
    real = os.path.realpath(path)
    best = ("?", "")
    with open("/proc/mounts") as f:
        for line in f:
            fields = line.split()
            mnt, fstype = fields[1].replace("\\040", " "), fields[2]
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best[1]):
                best = (fstype, mnt)
    return best


def odirect_probe(dirname: str) -> dict:
    """Whether an O_DIRECT open, and a 4 KiB aligned write through it,
    succeed in `dirname`."""
    from seaweedfs_tpu_torch.storage import aio
    path = os.path.join(dirname, "odirect_probe")
    out = {"open": "ok", "write": "not tried"}
    try:
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_DIRECT, 0o644)
    except OSError as e:
        out["open"] = f"refused: {e.strerror}"
    else:
        try:
            buf = aio.aligned_empty(aio.ALIGN)
            buf[:] = 1
            os.pwrite(fd, memoryview(buf), 0)
            out["write"] = "ok"
        except OSError as e:
            out["write"] = f"refused: {e.strerror}"
        finally:
            os.close(fd)
        os.remove(path)
    return out


def uring_refusal() -> str:
    """Why io_uring's probe fails on this host: the setup, or the NOP."""
    from seaweedfs_tpu_torch.storage import aio
    try:
        ring = aio._Ring(4)
    except OSError as e:
        return f"io_uring_setup: {e}"
    try:
        ring.push(aio._OP_NOP, -1, 0, 0, 0, 1)
        ring.enter(min_complete=1)
        return f"NOP completion {ring.pop()}"
    except OSError as e:
        return f"io_uring_enter: {e}"
    finally:
        ring.close()


def fleet_worker() -> int:
    """Child of phase 12's fleet A/B: warms up on a tiny volume, says
    "ready", then for each request line {"dir", "srcs"} on stdin converts
    links of the volumes in `dir` and answers one JSON line: seconds,
    launches, stage seconds.  Its environment (WEEDTPU_EC_FLUSH_BYTES)
    is the arm.  Ends at end of input."""
    from seaweedfs_tpu_torch.ops import fleet_convert, gf_cuda
    from seaweedfs_tpu_torch.storage.ec import ec_files

    def answer(doc: dict) -> None:
        sys.stdout.write(json.dumps(doc) + "\n")
        sys.stdout.flush()

    warm = True
    for line in sys.stdin:
        req = json.loads(line)
        gf_cuda.reset_launches()
        bases = link_volumes(req["srcs"], req["dir"])
        st: dict = {}
        t0 = time.perf_counter()
        fleet_convert.convert_volumes(bases, stats=st)
        dt = time.perf_counter() - t0
        if warm:
            shutil.rmtree(req["dir"])
        answer({"s": dt, "launches": dict(gf_cuda.LAUNCHES),
                "flush_bytes": ec_files.FLUSH_BYTES,
                "stats": {k: v for k, v in st.items()
                          if k in WRITER_KEYS or k.endswith("_s")}})
        warm = False
    return 0


def spawn_fleet_arms(vdir: str, srcs: list[str]) -> dict:
    """Phase 12's two fleet children, one per arm of FLEET_ARMS, started
    at once with their warm-up request (the CUDA context, the kernel
    library, pinned pools) on stdin, so their start-up and warm-up run
    while the phase's encode arms do; `fleet_ab` reads the warm-up's
    answers."""
    procs = {}
    for arm, extra in FLEET_ARMS.items():
        env = dict(os.environ)
        env.pop("WEEDTPU_EC_FLUSH_BYTES", None)
        env.update(extra)
        procs[arm] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--fleet-worker"],
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)
        procs[arm].stdin.write(json.dumps({
            "dir": os.path.join(vdir, f"warm{arm}"), "srcs": srcs[-1:]}) +
            "\n")
        procs[arm].stdin.flush()
    return procs


def stop_fleet_arms(procs: dict) -> None:
    """End each child at the end of its input (killed if it hangs)."""
    for proc in procs.values():
        try:
            proc.stdin.close()
            proc.wait(timeout=60)
        except Exception:
            proc.kill()
            proc.wait()


def fleet_ab(vdir: str, srcs: list[str], hashes: list[str],
             repeats: int, procs: dict) -> dict:
    """The fleet with the submission batcher (A: the default
    WEEDTPU_EC_FLUSH_BYTES) and without it (B: 1, a flush per unit), each
    arm a child process with its environment set, run A B A B ... with
    `repeats` runs each.  Every run's shards are sha256-equal to the
    first run's, and the phase-3 volume's to phase 4's.  `procs` are
    `spawn_fleet_arms`' children, stopped on the way out."""
    from seaweedfs_tpu_torch.storage.ec import layout
    out: dict = {"runs": [], "warmup_launches": {}}

    def send(arm: str, d: str, volumes: list[str]) -> None:
        procs[arm].stdin.write(json.dumps({"dir": d, "srcs": volumes}) +
                               "\n")
        procs[arm].stdin.flush()

    def answer(arm: str) -> dict:
        line = procs[arm].stdout.readline()
        if not line:
            raise AssertionError(f"fleet arm {arm}: the child died")
        return json.loads(line)

    try:
        # the warm-up run `spawn_fleet_arms` asked for
        for arm in procs:
            out["warmup_launches"][arm] = answer(arm)["launches"]
        first = None
        for r in range(repeats):
            for arm in procs:
                d = os.path.join(vdir, f"ab{r}{arm}")
                send(arm, d, srcs)
                doc = answer(arm)
                bases = [os.path.join(d, os.path.basename(p)[:-4])
                         for p in srcs]
                got = sha256_many([b + layout.to_ext(i) for b in bases
                                   for i in range(14)])
                shutil.rmtree(d)
                if got[:14] != hashes:
                    raise AssertionError(f"fleet arm {arm} run {r}: the "
                                         f"phase-3 volume's shards differ "
                                         f"from phase 4's")
                first = first or got
                if got != first:
                    raise AssertionError(f"fleet arm {arm} run {r}: shards "
                                         f"differ from the first run's")
                total = sum(os.path.getsize(p) for p in srcs)
                st = doc["stats"]
                run = {"arm": arm, "flush_bytes": doc["flush_bytes"],
                       "s": doc["s"], "gbps": total / doc["s"] / 1e9,
                       "launches": doc["launches"], "stats": st}
                out["runs"].append(run)
                log(f"[writer fleet {arm}] run {r}: FLUSH_BYTES "
                    f"{doc['flush_bytes']}, {total} B in {doc['s']:.3f} s: "
                    f"{run['gbps']:.3f} GB/s; " + ", ".join(
                        f"{k} {st[k]:.3f}" if isinstance(st[k], float)
                        else f"{k} {st[k]}"
                        for k in WRITER_KEYS + ("read_s", "d2h_s")
                        if k in st) + f"; launches {doc['launches']}")
    finally:
        stop_fleet_arms(procs)
    med = {arm: statistics.median(r["s"] for r in out["runs"]
                                  if r["arm"] == arm) for arm in FLEET_ARMS}
    out["median_s"] = med
    out["ratio_b_over_a_s"] = med["B"] / med["A"]
    log(f"[writer fleet] medians: A (batched) {med['A']:.3f} s, B (a flush "
        f"per unit) {med['B']:.3f} s; B / A = "
        f"{out['ratio_b_over_a_s']:.3f} (above 1: the batcher is faster); "
        f"every run's shards sha256-equal")
    return out


def phase_writer(vdir: str, dat_path: str, hashes: list[str],
                 srcs: list[str], launches: dict) -> dict:
    """Phase 12: the host write engine's modes on this card's host.  The
    filesystem and O_DIRECT; the phase-3 .dat encoded (card and native)
    and phase 6's loss rebuilt under each mode the host has, each shard
    set sha256-equal to phase 4's; the fleet A/B of the submission
    batcher in child processes.  Launches (this process's and the
    children's) against the layout's count.  The environment is restored
    on the way out; a failure goes on up.  The fleet's children start
    first, so their start-up and warm-up overlap the encode arms."""
    procs = spawn_fleet_arms(vdir, srcs)
    try:
        return _phase_writer(vdir, dat_path, hashes, srcs, launches, procs)
    finally:
        stop_fleet_arms(procs)


def _phase_writer(vdir: str, dat_path: str, hashes: list[str],
                  srcs: list[str], launches: dict, procs: dict) -> dict:
    from seaweedfs_tpu_torch import native
    from seaweedfs_tpu_torch.ops import fleet_convert
    from seaweedfs_tpu_torch.storage import aio
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout

    saved = {k: os.environ.get(k) for k in
             ("WEEDTPU_AIO", "WEEDTPU_AIO_DIRECT", "WEEDTPU_EC_CODEC")}
    wdir = os.path.join(vdir, "writer")
    os.makedirs(wdir)
    out: dict = {"engine_info": aio.engine_info(), "cpu": cpu_model(),
                 "card": card_name_power()}
    out["fs"], mnt = mount_of(wdir)
    out["odirect"] = odirect_probe(wdir)
    ring = aio.probe_uring()
    out["kernel_release"] = os.uname().release
    out["uring"] = "passed" if ring else \
        f"FAILED ({uring_refusal()}): ring arms skipped"
    arms = [a for a in WRITER_ARMS if ring or a[2] != "uring"]
    log(f"[writer] engine_info {out['engine_info']}; work dir on {out['fs']} "
        f"(mount {mnt}); O_DIRECT open {out['odirect']['open']}, aligned "
        f"write {out['odirect']['write']}; kernel {out['kernel_release']}; "
        f"io_uring probe {out['uring']}; arms: "
        f"{', '.join(a[0] for a in arms)}; {out['card']}; CPU {out['cpu']}")

    dat_size = os.path.getsize(dat_path)
    large, small = layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE
    shard_size = layout.shard_file_size(dat_size, large, small)
    lost = [0, 3, 10, 12]
    units = predict_units(dat_size, large, small)
    chunks = -(-shard_size // ec_files.DEFAULT_BATCH)
    fleet_units = sum(predict_units(os.path.getsize(p), large, small)
                      for p in srcs)
    fleet_launches = -(-fleet_units // fleet_convert.UNIT_BATCH)
    card_arms = sum(a[1] == "cuda" for a in arms)
    repeats = 2  # cut from 3: the script's time (PERF §4)
    want = {"gf_apply": repeats * card_arms *
            (units + chunks * row_blocks(len(lost))),
            "gf_apply_batch": 2 * (repeats * fleet_launches + 1)}
    log(f"[writer] predicted launches: K1 {repeats} rounds x {card_arms} "
        f"card arms x ({units} encode units + {chunks} rebuild chunks) = "
        f"{want['gf_apply']}; K2 2 arms x ({repeats} runs x {fleet_launches} "
        f"batches + 1 warm-up) = {want['gf_apply_batch']}")
    before = dict(launches)
    t_phase = time.perf_counter()
    try:
        base = os.path.join(wdir, "1")
        os.link(dat_path, base + ".dat")
        os.link(dat_path[: -len(".dat")] + ".idx", base + ".idx")
        shard = [base + layout.to_ext(i) for i in range(14)]
        native.set_gf_impl(native.GF_IMPL_AUTO)
        out["arms"] = {a[0]: [] for a in arms}
        # every arm once a round, `repeats` rounds: host rates drift
        # within a call, so the arms share it
        for (label, codec, mode, direct), r in (
                (a, r) for r in range(repeats) for a in arms):
            os.environ["WEEDTPU_AIO"] = mode
            os.environ["WEEDTPU_AIO_DIRECT"] = direct
            if codec == "native":
                os.environ["WEEDTPU_EC_CODEC"] = "native"
            else:
                os.environ.pop("WEEDTPU_EC_CODEC", None)
            for p in shard:  # no shard set at the start, as in phase 4
                if os.path.exists(p):
                    os.remove(p)
            st: dict = {}
            t0 = time.perf_counter()
            ec_files.write_ec_files(base, stats=st)
            ec_files.write_sorted_ecx(base + ".idx")
            dt = time.perf_counter() - t0
            if sha256_many(shard) != hashes:
                raise AssertionError(f"writer {label}: shards differ from "
                                     f"phase 4's")
            if st["aio_mode"] != mode:
                raise AssertionError(f"writer {label}: aio_mode "
                                     f"{st['aio_mode']}")
            for i in lost:
                os.remove(shard[i])
            rst: dict = {}
            t1 = time.perf_counter()
            ec_files.rebuild_ec_files(base, stats=rst)
            rdt = time.perf_counter() - t1
            if sha256_many([shard[i] for i in lost]) != \
                    [hashes[i] for i in lost]:
                raise AssertionError(f"writer {label}: rebuilt shards "
                                     f"differ")
            enc = {k: st.get(k, 0) for k in WRITER_KEYS if k != "write_s"}
            reb = {k: rst.get(k, 0) for k in WRITER_KEYS
                   if not k.startswith("write_") or k == "write_s"}
            out["arms"][label].append({
                "encode": {"s": dt, "gbps": dat_size / dt / 1e9, **enc},
                "rebuild": {"s": rdt, "mode": rst["mode"],
                            "read_gbps": 10 * shard_size / rdt / 1e9,
                            **reb}})

            def fmt(d: dict) -> str:
                return ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                                 else f"{k} {v}" for k, v in d.items())
            log(f"[writer encode {label}] round {r}: 14 shards sha256 == "
                f"phase 4's: {dat_size / dt / 1e9:.3f} GB/s ({dt:.3f} s); "
                f"{fmt(enc)}")
            log(f"[writer rebuild {label}] round {r}: {lost} sha256-equal, "
                f"{rst['mode']}: {10 * shard_size / rdt / 1e9:.3f} GB/s "
                f"survivors read ({rdt:.3f} s); {fmt(reb)}")
        for label, runs in out["arms"].items():
            log(f"[writer {label}] medians: encode "
                f"{statistics.median(x['encode']['gbps'] for x in runs):.3f}"
                f" GB/s, rebuild "
                f"{statistics.median(x['rebuild']['read_gbps'] for x in runs):.3f}"
                f" GB/s survivors read")
        shutil.rmtree(wdir)
    finally:
        native.set_gf_impl(native.GF_IMPL_AUTO)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["fleet_ab"] = fleet_ab(vdir, srcs, hashes, repeats, procs)
    got = {k: launches[k] - before[k] for k in launches}
    for counts in list(out["fleet_ab"]["warmup_launches"].values()) + \
            [run["launches"] for run in out["fleet_ab"]["runs"]]:
        for k in got:
            got[k] += counts[k]
    out["launches"] = got
    if got != want:
        raise AssertionError(f"phase 12 launched {got}; predicted {want}")
    out["s"] = time.perf_counter() - t_phase
    log(f"[writer] launches {got} == predicted; phase wall {out['s']:.1f} s")
    return out


def rebuild_record(vdir: str, base: str, hashes: list[str]) -> dict:
    """rebuild_ec_files of phase 9's single loss [3] from the 13 other
    shards: a record of its wall time, outside the counted window."""
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    rdir = os.path.join(vdir, "rebuild_record")
    os.makedirs(rdir)
    rbase = os.path.join(rdir, os.path.basename(base))
    for s in range(14):
        if s != 3:
            os.link(base + layout.to_ext(s), rbase + layout.to_ext(s))
    os.link(base + ".vif", rbase + ".vif")
    t0 = time.perf_counter()
    ec_files.rebuild_ec_files(rbase)
    dt = time.perf_counter() - t0
    if sha256(rbase + layout.to_ext(3)) != hashes[3]:
        raise AssertionError("rebuild_ec_files of [3] differs")
    size = os.path.getsize(rbase + layout.to_ext(3))
    shutil.rmtree(rdir)
    log(f"[record rebuild_ec_files] lost [3]: {dt:.3f} s, "
        f"{size / dt / 1e9:.3f} GB/s rebuilt")
    return {"s": dt, "rebuilt_gbps": size / dt / 1e9}


def fleet_record(vdir: str, srcs: list[str]) -> list[dict]:
    """Fleet conversion against one write_ec_files per volume over the
    same four volumes, in the order fleet, serial, serial, fleet, each on
    fresh output files.  A record, outside the counted window."""
    from seaweedfs_tpu_torch.ops import fleet_convert
    from seaweedfs_tpu_torch.storage.ec import ec_files

    total = sum(os.path.getsize(p) for p in srcs)
    out = []
    for i, mode in enumerate(("fleet", "serial", "serial", "fleet")):
        d = os.path.join(vdir, f"record{i}")
        bases = link_volumes(srcs, d)
        t0 = time.perf_counter()
        if mode == "fleet":
            fleet_convert.convert_volumes(bases)
        else:
            for base in bases:
                ec_files.write_ec_files(base)
        dt = time.perf_counter() - t0
        shutil.rmtree(d)
        out.append({"mode": mode, "s": dt, "gbps": total / dt / 1e9})
        log(f"[record {mode}] {total} B in {dt:.3f} s: "
            f"{total / dt / 1e9:.3f} GB/s")
    return out


# the trace's device activity: kernels, copies and fills on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
K1_TRACE_NAME = "gf_apply_kernel"  # the kernel's symbol (csrc/gf_matmul.cu)


def trace_events(trace_dir: str) -> list[dict]:
    """The events of the one Chrome trace `grace.torch_profile` wrote into
    trace_dir."""
    (name,) = [p for p in os.listdir(trace_dir) if p.endswith(".json")]
    with open(os.path.join(trace_dir, name)) as f:
        return json.load(f)["traceEvents"]


def device_busy(events: list[dict], op: str) -> dict:
    """Device busy share of the annotated operation `op` (a
    `record_function` range): the union of the card's kernel, copy and
    fill intervals clipped to the range, over its wall clock; the
    busiest device operations by their time inside it."""
    (ann,) = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == op]
    lo, hi = float(ann["ts"]), float(ann["ts"]) + float(ann["dur"])
    spans, by_op = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), lo), min(float(e["ts"]) + e["dur"], hi)
        if b <= a:
            continue
        spans.append((a, b))
        key = f"{e['cat']}: {e['name']}"
        n, t = by_op.get(key, (0, 0.0))
        by_op[key] = (n + 1, t + b - a)
    busy, end = 0.0, lo
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    wall = hi - lo
    top = sorted(by_op.items(), key=lambda kv: -kv[1][1])[:6]
    return {"wall_ms": wall / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / wall, "idle_share": 1 - busy / wall,
            "top": [{"op": k, "events": n, "ms": t / 1e3}
                    for k, (n, t) in top]}


def device_seconds(events: list[dict], op: str) -> dict:
    """Device seconds of the card's work that starts inside the annotated
    operation `op`, from the profiler's own intervals: K1's kernel
    events, and the host-to-card and card-to-host copies."""
    (ann,) = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == op]
    lo, hi = float(ann["ts"]), float(ann["ts"]) + float(ann["dur"])
    out = {"kernel_s": 0.0, "h2d_s": 0.0, "d2h_s": 0.0}
    for e in events:
        if not lo <= float(e.get("ts", -1)) < hi:
            continue
        name = e.get("name", "")
        if e.get("cat") == "kernel" and K1_TRACE_NAME in name:
            out["kernel_s"] += float(e["dur"]) / 1e6
        elif e.get("cat") == "gpu_memcpy" and "HtoD" in name:
            out["h2d_s"] += float(e["dur"]) / 1e6
        elif e.get("cat") == "gpu_memcpy" and "DtoH" in name:
            out["d2h_s"] += float(e["dur"]) / 1e6
    return out


def seam_us(n: int = 20000) -> float:
    """Host microseconds per card dispatch of the bookkeeping that the
    kernel profile and the spans add to it and to its sync point, outside
    any sampled trace: two unsampled spans, two `KernelProfile.record`
    calls and the clock reads around them, timed alone in a loop (so a
    floor of what they cost inside a busy pipeline)."""
    from seaweedfs_tpu_torch.stats import profile, trace
    prof = profile.KernelProfile()
    t0 = time.perf_counter()
    for _ in range(n):
        with trace.span("codec.dispatch_parity", backend="device", bytes=1):
            a = time.perf_counter()
            prof.record("encode_parity", "device",
                        wall_s=time.perf_counter() - a, h2d_bytes=1,
                        nbytes=1)
        with trace.span("codec.d2h", bytes=1):
            a = time.perf_counter()
            b = time.perf_counter()
            prof.record("encode_parity", "device", calls=0,
                        device_s=b - a, d2h_s=time.perf_counter() - b,
                        d2h_bytes=1)
    return (time.perf_counter() - t0) / n * 1e6


def copy_rates(nbytes: int = 256 * MIB, runs: int = 10) -> tuple:
    """(H2D, D2H) GB/s of one `nbytes` copy between pinned host memory and
    the card, the fastest of `runs` timed by CUDA events (a ceiling:
    noise only slows a copy)."""
    import torch
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    out = []
    for dst, src in ((dev, host), (host, dev)):
        dst.copy_(src, non_blocking=True)  # warm-up
        torch.cuda.synchronize()
        ms = []
        for _ in range(runs):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            dst.copy_(src, non_blocking=True)
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
        out.append(nbytes / (min(ms) * 1e-3) / 1e9)
    return tuple(out)


def unit_steps(dat_size: int, large_block: int, small_block: int,
               batch: int = 16 * MIB, k: int = 10) -> list[int]:
    """The column width of every unit that carries data, as
    predict_units counts them."""
    return [min(batch, block)
            for start, block, _ in stripe_rows(dat_size, large_block,
                                               small_block, k)
            for col in range(0, block, min(batch, block))
            if start + col < dat_size]


def phase_telemetry(vdir: str, dat_path: str, hashes: list[str],
                    reads: list[int], expect: dict, blob: bytes,
                    srcs: list[str], kernel_rows: list[dict],
                    launches: dict, trace_dir: str | None) -> dict:
    """Phase 13: the port's telemetry on the card.  One sampled root
    trace over phase 4's warm encode (from no shard set), 50 of phase 5's
    degraded reads, phase 6's loss rebuilt, one fleet conversion of phase
    7's four volumes and one scrub window; kernel rows held against the
    launches and the layout; the encode and the rebuild again under
    torch.profiler, their device busy share; the roofline against
    measured ceilings; the WEEDTPU_PERF_OBS A/B.  Every shard set
    sha256-equal to phase 4's."""
    import torch
    from seaweedfs_tpu_torch.maintenance import scrub
    from seaweedfs_tpu_torch.ops import fleet_convert
    from seaweedfs_tpu_torch.stats import metrics, pipeline, profile, trace
    from seaweedfs_tpu_torch.stats.profile import KERNELS
    from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume, layout
    from seaweedfs_tpu_torch.utils import grace

    card = card_name_power()

    def tlog(msg: str) -> None:
        log(f"[telemetry] {msg} [{card}]")

    base = dat_path[: -len(".dat")]
    shard = [base + layout.to_ext(i) for i in range(14)]
    lost = [0, 3, 10, 12]
    dat_size = os.path.getsize(dat_path)
    large, small = layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE
    steps = unit_steps(dat_size, large, small)
    k, m = layout.DATA_SHARDS, layout.PARITY_SHARDS
    out: dict = {"card": card}

    def same_shards(label, ids=range(14)):
        got = sha256_many([shard[i] for i in ids])
        for i, h in zip(ids, got):
            if h != hashes[i]:
                raise AssertionError(f"telemetry {label}: shard {i} "
                                     f"differs from phase 4's")

    def encode(stats=None) -> float:
        for p in shard:
            if os.path.exists(p):
                os.remove(p)
        t0 = time.perf_counter()
        ec_files.write_ec_files(base, stats=stats)
        return time.perf_counter() - t0

    def row(snap, key):
        return snap.get(key, {})

    def delta(after, before, key):
        a, b = row(after, key), row(before, key)
        return {f: a.get(f, 0.0) - b.get(f, 0.0) for f in a}

    # -- the traced workload -------------------------------------------------
    KERNELS.reset()
    pipeline.reset()
    trace.reset_ring()
    root = trace.new_root()
    sampler = profile.SamplingProfiler(hz=97)
    t_phase = time.perf_counter()
    with trace.span("chip_smoke.telemetry", parent=root):
        k1 = launches["gf_apply"]
        sampler.start()
        try:
            enc_s = encode()
        finally:
            sampler.stop()
        enc_k1 = launches["gf_apply"] - k1
        after_enc = KERNELS.snapshot()
        same_shards("encode")
        for i in lost:
            os.remove(shard[i])
        ev = ec_volume.EcVolume(base)
        try:
            for nid in reads[:50]:
                n = ev.read_needle(nid)
                cookie, lo, hi = expect[nid]
                if n.cookie != cookie or n.data != blob[lo:hi]:
                    raise AssertionError(f"telemetry: degraded read of "
                                         f"needle {nid} differs")
        finally:
            ev.close()
        ec_files.rebuild_ec_files(base)
        same_shards("rebuild", lost)
        before_fleet = KERNELS.snapshot()
        k2 = launches["gf_apply_batch"]
        bases = link_volumes(srcs, os.path.join(vdir, "telemetry_fleet"))
        fleet_convert.convert_volumes(bases)
        fleet_k2 = launches["gf_apply_batch"] - k2
        fleet_row = delta(KERNELS.snapshot(), before_fleet,
                          "fleet_encode[device]")
        if sha256_many([bases[0] + layout.to_ext(i)
                        for i in range(14)]) != hashes:
            raise AssertionError("telemetry: the fleet's shards of the "
                                 "phase-3 volume differ from phase 4's")
        shutil.rmtree(os.path.join(vdir, "telemetry_fleet"))
        ev = ec_volume.EcVolume(base)
        try:
            ev.shard_size = min(ev.shard_size, scrub.DEFAULT_WINDOW)
            if scrub.syndrome_scan(ev) != []:
                raise AssertionError("telemetry: scrub found corruption")
        finally:
            ev.close()
    out["workload_s"] = time.perf_counter() - t_phase
    tlog(f"workload under one sampled root trace in {out['workload_s']:.3f} "
         f"s: encode {enc_s:.3f} s ({dat_size / enc_s / 1e9:.3f} GB/s), 50 "
         f"degraded reads, rebuild of {lost}, fleet of {len(srcs)} volumes, "
         f"one {scrub.DEFAULT_WINDOW} B scrub window; every shard set "
         f"sha256-equal to phase 4's")
    log("[telemetry] host stacks of the encode, "
        f"{sampler.samples} samples at {sampler.hz:g} Hz:\n"
        + sampler.table(limit=30))
    spans = trace.traces(tid=root.trace_id)[0]
    names: dict = {}
    for rec in spans["spans"]:
        names[rec["name"]] = names.get(rec["name"], 0) + 1
    waterfall = trace.assemble(spans["spans"])
    out["spans"] = names
    tlog(f"trace {root.trace_id}: {waterfall['span_count']} spans over "
         f"{waterfall['ms']:.1f} ms, {waterfall['orphans']} orphans: "
         f"{json.dumps(names, sort_keys=True)}")

    # -- the kernel rows, held against the launches and the layout --------
    enc = row(after_enc, "encode_parity[device]")
    written = row(after_enc, "shard_write[host]")["bytes"]
    files = sum(os.path.getsize(p) for p in shard)
    want_written = dat_size + m * sum(steps)
    checks = {"encode_parity[device] calls == K1 launches of the encode":
              (enc["calls"], enc_k1),
              "encode_parity[device] bytes == the layout's padded .dat":
              (enc["bytes"], k * sum(steps)),
              "shard_write[host] bytes == .dat + parity columns written":
              (written, want_written),
              "fleet_encode[device] calls == K2 launches of the fleet":
              (fleet_row["calls"], fleet_k2)}
    for what, (got, want) in checks.items():
        tlog(f"{what}: {got:.0f} == {want:.0f}")
        if got != want:
            raise AssertionError(f"telemetry: {what}: {got} != {want}")
    tlog(f"the 14 shard files hold {files} B; the encode wrote {written:.0f}"
         f" B of them, {files - written:.0f} B are holes past the .dat")
    out["kernel_checks"] = {w: list(v) for w, v in checks.items()}

    # -- the encode and the rebuild again, under torch.profiler ------------
    marks = {"workload": time.perf_counter()}
    tdir = trace_dir or os.path.join(vdir, "telemetry_trace")
    shutil.rmtree(tdir, ignore_errors=True)
    k1 = launches["gf_apply"]
    for p in shard:
        os.remove(p)
    prof_rows = {}
    t_prof = time.perf_counter()
    with grace.torch_profile(tdir):
        t_in = time.perf_counter()
        before = KERNELS.snapshot()
        with torch.profiler.record_function("chip_smoke.encode"):
            ec_files.write_ec_files(base)
        prof_rows["encode"] = delta(KERNELS.snapshot(), before,
                                    "encode_parity[device]")
        for i in lost:
            os.remove(shard[i])
        before = KERNELS.snapshot()
        with torch.profiler.record_function("chip_smoke.rebuild"):
            ec_files.rebuild_ec_files(base)
        prof_rows["rebuild"] = delta(KERNELS.snapshot(), before,
                                     "reconstruct[device]")
        t_work = time.perf_counter()
    t_out = time.perf_counter()
    prof_k1 = launches["gf_apply"] - k1
    same_shards("profiled encode and rebuild")
    t_same = time.perf_counter()
    events = trace_events(tdir)
    t_read = time.perf_counter()
    traced_k1 = sum(1 for e in events if e.get("cat") == "kernel"
                    and K1_TRACE_NAME in e.get("name", ""))
    out["profile_s"] = {"start": t_in - t_prof, "workload": t_work - t_in,
                        "stop_and_export": t_out - t_work,
                        "shard_check": t_same - t_out,
                        "trace_read": t_read - t_same}
    tlog(f"trace: {traced_k1} K1 kernel events == {prof_k1} K1 launches "
         f"counted in the profiled encode and rebuild; {len(events)} "
         f"events; seconds: " + ", ".join(
             f"{k} {v:.2f}" for k, v in out["profile_s"].items()))
    if traced_k1 != prof_k1:
        raise AssertionError(f"telemetry: the trace holds {traced_k1} K1 "
                             f"events, the wrapper counted {prof_k1}")
    out["busy"] = {}
    for op in ("encode", "rebuild"):
        b = device_busy(events, f"chip_smoke.{op}")
        out["busy"][op] = b
        tlog(f"{op}: device busy share {b['busy_share']:.4f}, idle share "
             f"{b['idle_share']:.4f} ({b['busy_ms']:.2f} ms of "
             f"{b['wall_ms']:.2f} ms wall); top device ops: " + "; ".join(
                 f"{t['op']} x{t['events']} {t['ms']:.2f} ms"
                 for t in b["top"]))
    out["device_s"] = {op: device_seconds(events, f"chip_smoke.{op}")
                       for op in ("encode", "rebuild")}
    if not trace_dir:
        shutil.rmtree(tdir)

    marks["profiled"] = time.perf_counter()
    # -- the kernel profile, the jobs and the roofline ---------------------
    log("[telemetry] kernel profile (all of phase 13 so far):\n"
        + KERNELS.table())
    snap = pipeline.local_snapshot()
    out["jobs"] = []
    for job in snap["jobs"]:
        bn = job.get("bottleneck") or {}
        out["jobs"].append({"kind": job["kind"], "wall_s": job["wall_s"],
                            "bottleneck": bn})
        tlog(f"job {job['kind']} ({job['state']}): wall {job['wall_s']} s, "
             f"bottleneck {json.dumps(bn, sort_keys=True)}; busy_frac "
             + ", ".join(f"{s} {r['busy_frac']}"
                         for s, r in sorted(job["stages"].items())))
    r16 = next(r for r in kernel_rows if r["case"] == "parity [10,16MiB]")
    device_gbps = k * 16 * MIB / (r16["ms"] * 1e-3) / 1e9
    h2d_gbps, d2h_gbps = copy_rates()
    for resource, gbps in (("device", device_gbps), ("h2d", h2d_gbps),
                           ("d2h", d2h_gbps)):
        profile.set_ceiling(resource, gbps)
    tlog(f"ceilings: device {device_gbps:.1f} GB/s (K1 at [10,16MiB], data "
         f"bytes over phase 2's time), h2d {h2d_gbps:.2f} GB/s and d2h "
         f"{d2h_gbps:.2f} GB/s (the fastest of ten 256 MiB pinned copies, "
         f"CUDA events)")
    roof = profile.roofline_snapshot()
    out["roofline"] = roof
    for r in roof["rows"]:
        tlog(f"roofline {r['kernel']}[{r['backend']}] {r['resource']}: "
             f"{r['achieved_gbps']} GB/s over {r['busy_s']} s"
             + (f", {r['ceiling_frac']} of {r['ceiling_gbps']} GB/s"
                if "ceiling_frac" in r else ""))
    over = [r for r in roof["rows"] if r.get("ceiling_frac", 0) > 1.05]
    # the card's kernel and copy shares, from the profiled encode's and
    # rebuild's own device intervals (the kernel rows hold no device
    # interval: their device_s is a wait, and they book no h2d_s), held
    # against published peaks: K1 the HBM byte bound of what it reads and
    # writes, the copies the host link.  The lone copies' rates above are
    # printed beside them: they move with the host's load within a call,
    # and the pipeline's copies have outrun them
    ceil = {"kernel_s": HBM_BYTES_PER_S / 1e9,
            "h2d_s": PCIE_BYTES_PER_S / 1e9, "d2h_s": PCIE_BYTES_PER_S / 1e9}
    lone = {"h2d_s": h2d_gbps, "d2h_s": d2h_gbps}
    out["trace_roofline"] = []
    for op, secs in out["device_s"].items():
        r = prof_rows[op]
        moved = {"kernel_s": r.get("bytes", 0.0) + r.get("d2h_bytes", 0.0),
                 "h2d_s": r.get("h2d_bytes", 0.0),
                 "d2h_s": r.get("d2h_bytes", 0.0)}
        for field, s in secs.items():
            nbytes = moved[field]
            if s <= 0 or nbytes <= 0:
                raise AssertionError(f"telemetry: the profiled {op} shows "
                                     f"{s} s of {field} for {nbytes} B")
            gbps = nbytes / s / 1e9
            share = gbps / ceil[field]
            rec = {"op": op, "resource": field[:-2], "device_s": s,
                   "bytes": nbytes, "gbps": gbps, "share": share}
            note = ""
            if field in lone:
                rec["of_lone_copy"] = gbps / lone[field]
                note = (f"; {rec['of_lone_copy']:.4f} of the lone copy's "
                        f"{lone[field]:.2f} GB/s")
            out["trace_roofline"].append(rec)
            tlog(f"trace roofline {op} {field[:-2]}: {nbytes:.0f} B over "
                 f"{s * 1e3:.3f} ms of the trace's own intervals = "
                 f"{gbps:.2f} GB/s, {share:.4f} of the published "
                 f"{ceil[field]:.2f} GB/s{note}")
            if share > 1.05:
                over.append(out["trace_roofline"][-1])
    if over:
        raise AssertionError(f"telemetry: roofline shares over 1.05: {over}")
    profile.export_roofline()
    gauges = [ln for ln in metrics.REGISTRY.render().splitlines()
              if ln.startswith("weedtpu_roofline_frac{")]
    log("[telemetry] exported gauges:\n" + "\n".join(gauges))

    marks["roofline"] = time.perf_counter()
    # -- the seam's bookkeeping, alone, and the pipeline jobs' cost -------
    per = seam_us()
    out["seam_us_per_dispatch"] = per
    tlog(f"seam bookkeeping per card dispatch, timed alone: {per:.2f} us; "
         f"x {enc_k1} dispatches of the warm encode = "
         f"{per * enc_k1 / 1e3:.3f} ms of its {enc_s * 1e3:.1f} ms "
         f"({per * enc_k1 / 1e6 / enc_s:.4%})")
    # WEEDTPU_PERF_OBS gates the pipeline jobs only (on A, off B); the
    # kernel rows and the spans run in both arms
    saved = os.environ.get("WEEDTPU_PERF_OBS")
    times: dict = {"1": [], "0": []}
    try:
        for arm in ("1", "0") * 3:
            os.environ["WEEDTPU_PERF_OBS"] = arm
            pipeline._enabled_cache = (0.0, True)  # re-read the switch
            if pipeline.perf_obs_enabled() != (arm == "1"):
                raise AssertionError("WEEDTPU_PERF_OBS did not take")
            times[arm].append(encode())
            same_shards(f"encode with WEEDTPU_PERF_OBS={arm}")
    finally:
        if saved is None:
            os.environ.pop("WEEDTPU_PERF_OBS", None)
        else:
            os.environ["WEEDTPU_PERF_OBS"] = saved
    ratio = statistics.median(times["1"]) / statistics.median(times["0"])
    out["perf_obs_ab"] = {"on_s": times["1"], "off_s": times["0"],
                          "ratio": ratio}
    tlog(f"pipeline jobs (WEEDTPU_PERF_OBS) A/B, warm encode seconds, "
         f"A B A B A B: on "
         f"{['%.4f' % t for t in times['1']]}, off "
         f"{['%.4f' % t for t in times['0']]}; median on over off "
         f"{ratio:.4f}; every shard set sha256-equal to phase 4's")
    out["s"] = time.perf_counter() - t_phase
    marks["seam and A/B"] = time.perf_counter()
    last, out["steps_s"] = t_phase, {}
    for step, at in marks.items():
        out["steps_s"][step] = at - last
        last = at
    tlog(f"phase wall {out['s']:.1f} s: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in out["steps_s"].items()))
    return out


# phase 14's small objects: upstream's own `weed benchmark` defaults (-n
# 1048576 -size 1024, the SeaweedFS README's benchmark section), reduced
# by the run's time limit to one of the compact needle map's merges
# (CompactNeedleMap.MERGE_THRESHOLD is 65 536) and 4096 needles past it,
# in the map's unmerged tail
STORE_SMALL_N = 65536 + 4096
STORE_SMALL_SIZE = 1024
STORE_SAMPLES = 4096
# crash leftovers of each kind DiskLocation.load_existing removes
STORE_LEFTOVERS = ("1.cpd", "1.cpx", "1.cptail", "1.dat.unc", "1.idx.unc")


def boot_store(dirs: list[str]):
    """Store(dirs) on the card (EC volumes build their codec there).
    Returns the store, the seconds the call took and each location's
    `load_existing` seconds."""
    from seaweedfs_tpu_torch.storage import store as st
    t0 = time.perf_counter()
    s = st.Store(dirs)
    return s, time.perf_counter() - t0, [loc.load_s for loc in s.locations]


def phase_store(vdir: str, dat_path: str, expect: dict, blob: bytes,
                seed: int, launches: dict) -> dict:
    """Phase 14: one storage node's volume lifecycle through `Store`, on
    the card (device left at its default).  Boot over crash leftovers
    with the phase-3 volume in location A; small objects in location B
    across a reboot and a sorted-file reopen; vacuum of volume 1; its
    encode and the EC volume's mount; degraded reads and deletes on the
    EC volume; decode back to a volume (handle_ec_to_volume's order);
    the remote tier out and back.  K1's launches held against the
    layout's count."""
    import numpy as np
    from seaweedfs_tpu_torch.storage import needle as ndl
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.backend import RemoteFile
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    from seaweedfs_tpu_torch.storage.needle_map import CompactNeedleMap
    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE
    from seaweedfs_tpu_torch.storage.volume import Volume

    card = card_name_power()

    def slog(msg: str) -> None:
        log(f"[store] {msg} [{card}]")

    work = os.path.join(vdir, "store")
    a, b = os.path.join(work, "a"), os.path.join(work, "b")
    cold = os.path.join(work, "cold")
    os.makedirs(a)
    os.makedirs(b)
    base = os.path.join(a, "1")
    out: dict = {"card": card}
    k1 = launches["gf_apply"]
    t_phase = time.perf_counter()

    def check(n, nid):
        cookie, lo, hi = expect[nid]
        if n.id != nid or n.cookie != cookie or n.data != blob[lo:hi]:
            raise AssertionError(f"store read of needle {nid} differs")

    def read_all(s, nids) -> float:
        t0 = time.perf_counter()
        for nid in nids:
            check(s.read_needle(1, nid, expect[nid][0]), nid)
        return time.perf_counter() - t0

    def must_be_gone(s, nids, label):
        for nid in nids:
            try:
                s.read_needle(1, nid)
            except KeyError:
                continue
            raise AssertionError(f"{label}: needle {nid} still reads")

    # 1 boot over crash leftovers, the phase-3 volume in A
    for ext in (".dat", ".idx"):
        os.link(dat_path[: -len(".dat")] + ext, base + ext)
    for name in STORE_LEFTOVERS:
        with open(os.path.join(a, name), "wb") as f:
            f.write(b"leftover")
    half = Volume(a, "", 9)  # a half-moved copy: .staging beside it
    half.append_needle(ndl.Needle(id=1, cookie=1, data=b"half-moved"))
    half.close()
    open(os.path.join(a, "9.staging"), "w").close()
    s, boot_s, per = boot_store([a, b])
    if sorted(os.listdir(a)) != ["1.dat", "1.idx"]:
        raise AssertionError(f"boot left {sorted(os.listdir(a))}")
    v1 = s.get_volume(1)
    if v1 is None or s.location_of(1).directory != a or \
            v1.backend_kind != "mmap" or s.get_volume(9) is not None:
        raise AssertionError("boot did not mount volume 1 alone, on mmap")
    nids = sorted(expect)
    dt = read_all(s, nids)
    inline = 0
    for nid in nids:
        cookie, lo, hi = expect[nid]
        if t.actual_size(hi - lo + 5) <= 64 * 1024:
            n = s.read_needle_inline(1, nid, cookie)
            if n is None:
                raise AssertionError(f"inline read of needle {nid} refused")
            check(n, nid)
            inline += 1
    out["boot"] = {"s": boot_s, "location_s": per, "reads": len(nids),
                   "read_s": dt, "inline_reads": inline}
    slog(f"boot {boot_s:.4f} s (A {per[0]:.4f} s: volume 1 mounted, "
         f"{len(STORE_LEFTOVERS)} leftovers and a half-moved volume "
         f"removed; B {per[1]:.4f} s); {len(nids)} needles read back, "
         f"cookies checked, {len(nids) / dt:.1f} reads/s "
         f"({v1.data_size() / dt / 1e9:.3f} GB/s); {inline} of 64 KB or "
         f"less also through read_needle_inline")

    # 2 small objects in B: a merge of the compact map and a tail past
    # it, a reboot
    g = np.random.default_rng(seed + 14)
    small = g.bytes(STORE_SMALL_N * STORE_SMALL_SIZE)
    cookies = g.integers(0, 1 << 32, STORE_SMALL_N).tolist()
    v2 = s.allocate_volume(2)
    if s.location_of(2).directory != b:
        raise AssertionError("volume 2 was not allocated in location B")
    t0 = time.perf_counter()
    for i in range(STORE_SMALL_N):
        s.write_needle(2, ndl.Needle(
            cookie=cookies[i], id=i + 1,
            data=small[i * STORE_SMALL_SIZE:(i + 1) * STORE_SMALL_SIZE]))
    write_s = time.perf_counter() - t0
    merged = len(v2.nm._ids)
    if merged != STORE_SMALL_N - STORE_SMALL_N % \
            CompactNeedleMap.MERGE_THRESHOLD:
        raise AssertionError(f"the compact map merged {merged} entries")
    s.close()
    s, reboot_s, per = boot_store([a, b])
    pick = np.random.default_rng(seed + 15).choice(
        STORE_SMALL_N, STORE_SAMPLES, replace=False).tolist()

    def small_ok(n, i):
        if n.cookie != cookies[i] or n.data != \
                small[i * STORE_SMALL_SIZE:(i + 1) * STORE_SMALL_SIZE]:
            raise AssertionError(f"small object {i + 1} differs")

    t0 = time.perf_counter()
    for i in pick:
        small_ok(s.read_needle(2, i + 1, cookies[i]), i)
    sample_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sf = Volume(b, "", 2, needle_map_kind="sorted_file")
    sdx_s = time.perf_counter() - t0
    for i in pick:
        small_ok(sf.read_needle(i + 1, cookies[i]), i)
    try:
        sf.append_needle(ndl.Needle(id=STORE_SMALL_N + 1, data=b"x"))
    except PermissionError:
        pass
    else:
        raise AssertionError("the sorted-file volume took a write")
    sf.close()
    out["small"] = {"needles": STORE_SMALL_N, "write_s": write_s,
                    "needles_per_s": STORE_SMALL_N / write_s,
                    "reboot_s": reboot_s, "reboot_location_s": per,
                    "sample_reads_per_s": STORE_SAMPLES / sample_s,
                    "sdx_build_s": sdx_s}
    slog(f"small objects: {STORE_SMALL_N} x {STORE_SMALL_SIZE} B through "
         f"Store.write_needle in {write_s:.3f} s, "
         f"{STORE_SMALL_N / write_s:.0f} needles/s ({merged} merged into "
         f"the compact map's columns); reboot {reboot_s:.4f} s (A "
         f"{per[0]:.4f} s, B {per[1]:.4f} s); {STORE_SAMPLES} sampled "
         f"reads equal, {STORE_SAMPLES / sample_s:.0f} reads/s; sorted_file "
         f"reopen {sdx_s:.4f} s (.sdx built), the same reads equal, a "
         f"write refused")

    # 3 vacuum volume 1
    gone = [nid for nid in nids if nid % 4 == 0]
    live = [nid for nid in nids if nid % 4]
    for nid in gone:
        s.delete_needle(1, nid)
    v1 = s.get_volume(1)
    ratio = v1.garbage_ratio()
    rev = v1.super_block.compaction_revision
    t0 = time.perf_counter()
    v1.compact()
    compact_s = time.perf_counter() - t0
    size = v1.data_size()
    want = SUPER_BLOCK_SIZE + sum(t.actual_size(expect[nid][2] -
                                                expect[nid][1] + 5)
                                  for nid in live)
    if v1.super_block.compaction_revision != rev + 1 or size != want:
        raise AssertionError(f"compact: revision {rev} -> "
                             f"{v1.super_block.compaction_revision}, "
                             f"{size} B, want {want}")
    dt = read_all(s, live)
    must_be_gone(s, gone, "vacuum")
    s.close()
    compacted = sha256(base + ".dat")
    out["vacuum"] = {"deleted": len(gone), "garbage_ratio": ratio,
                     "compact_s": compact_s, "dat_bytes": size,
                     "gbps": size / compact_s / 1e9, "read_s": dt}
    slog(f"vacuum: {len(gone)} needles deleted through Store.delete_needle"
         f", garbage_ratio {ratio:.4f}; compact {compact_s:.3f} s, "
         f"{size / compact_s / 1e9:.3f} GB/s written; revision {rev} -> "
         f"{rev + 1}, .dat {size} B = super block + the live records; "
         f"{len(live)} live needles equal, every deleted one KeyError")

    # 4 encode (K1) and mount the shard set
    before = launches["gf_apply"]
    t0 = time.perf_counter()
    ec_files.write_ec_files(base)
    ec_files.write_sorted_ecx(base + ".idx")
    encode_s = time.perf_counter() - t0
    units = predict_units(size, layout.LARGE_BLOCK_SIZE,
                          layout.SMALL_BLOCK_SIZE)
    if launches["gf_apply"] - before != units:
        raise AssertionError(f"encode launched "
                             f"{launches['gf_apply'] - before}, the layout "
                             f"says {units}")
    os.remove(base + ".dat")
    os.remove(base + ".idx")
    s, mount_s, per = boot_store([a, b])
    shard_size = os.path.getsize(base + layout.to_ext(0))
    hb = s.collect_heartbeat()["ec_shards"]
    if s.get_volume(1) is not None or s.get_ec_volume(1) is None or \
            hb != [{"id": 1, "collection": "",
                    "shard_ids": list(range(14)), "shard_size": shard_size,
                    "codec": "rs_10_4"}] or shard_size != \
            layout.shard_file_size(size, layout.LARGE_BLOCK_SIZE,
                                   layout.SMALL_BLOCK_SIZE):
        raise AssertionError(f"EC mount: heartbeat {hb}")
    s.close()
    out["encode"] = {"s": encode_s, "gbps": size / encode_s / 1e9,
                     "launches": units, "mount_s": mount_s}
    slog(f"encode {encode_s:.3f} s, {size / encode_s / 1e9:.3f} GB/s, "
         f"{units} K1 launches == the layout's; reboot {mount_s:.4f} s "
         f"(A {per[0]:.4f} s) mounts an EcVolume: heartbeat 14 shard ids, "
         f"shard_size {shard_size}, rs_10_4")

    # 5 degraded reads (K1), then deletes on the EC volume
    lost = [0, 3, 10, 12]
    for i in lost:
        os.remove(base + layout.to_ext(i))
    s, _, _ = boot_store([a, b])
    touching = touching_needles(s.get_ec_volume(1), live, set(lost))
    before = launches["gf_apply"]
    dt = read_all(s, touching)
    if not touching or launches["gf_apply"] - before != len(touching):
        raise AssertionError(f"{len(touching)} degraded reads launched "
                             f"{launches['gf_apply'] - before}")
    more = np.random.default_rng(seed + 16).choice(
        live, 16, replace=False).tolist()
    for nid in more:
        s.delete_needle(1, nid)
    must_be_gone(s, more, "EC delete")
    s.close()
    if os.path.getsize(base + ".ecj") != 16 * 8:
        raise AssertionError("the .ecj does not hold the 16 deletes")
    out["degraded"] = {"reads": len(touching), "s": dt,
                       "reads_per_s": len(touching) / dt,
                       "launches": len(touching)}
    slog(f"degraded: .ec00/.ec03/.ec10/.ec12 gone; {len(touching)} needles "
         f"on a lost data shard read through Store.read_needle, equal, "
         f"{len(touching) / dt:.1f} reads/s, one K1 launch each; 16 more "
         f"deleted on the EC volume (.ecj 128 B)")

    # 6 decode back to a volume: handle_ec_to_volume's order
    before = launches["gf_apply"]
    missing = [i for i in range(10) if not os.path.exists(
        base + layout.to_ext(i))]
    t0 = time.perf_counter()
    rebuilt = ec_files.rebuild_ec_files(base) if missing else []
    rebuild_s = time.perf_counter() - t0
    chunks = -(-shard_size // ec_files.DEFAULT_BATCH)
    if missing != [0, 3] or sorted(rebuilt) != lost or \
            launches["gf_apply"] - before != chunks * row_blocks(len(lost)):
        raise AssertionError(f"decode's rebuild: missing {missing}, rebuilt "
                             f"{rebuilt}, {launches['gf_apply'] - before} "
                             f"launches")
    dat_size = ec_files.find_dat_file_size(base)
    t0 = time.perf_counter()
    ec_files.write_dat_file(base, dat_size)
    dat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ec_files.write_idx_from_ecx(base + ".ecx")
    idx_s = time.perf_counter() - t0
    if dat_size != size or sha256(base + ".dat") != compacted:
        raise AssertionError("the decoded .dat differs from the compacted")
    # the shell's ec.decode drops the shard set once the volume mounts
    for ext in [layout.to_ext(i) for i in range(14)] + [".ecx", ".ecj",
                                                        ".vif"]:
        os.remove(base + ext)
    s, decoded_boot_s, per = boot_store([a, b])
    if s.get_ec_volume(1) is not None or s.get_volume(1) is None:
        raise AssertionError("the decoded volume did not mount as a Volume")
    kept = [nid for nid in live if nid not in set(more)]
    read_all(s, kept)
    must_be_gone(s, gone + more, "decode")
    decode_s = rebuild_s + dat_s + idx_s
    out["decode"] = {"rebuild_s": rebuild_s, "write_dat_s": dat_s,
                     "write_idx_s": idx_s, "gbps": size / decode_s / 1e9,
                     "boot_s": decoded_boot_s, "boot_location_s": per,
                     "write_dat_gbps": size / dat_s / 1e9,
                     "launches": chunks * row_blocks(len(lost))}
    slog(f"decode {decode_s:.3f} s, {size / decode_s / 1e9:.3f} GB/s: "
         f"rebuild of {rebuilt} {rebuild_s:.3f} s "
         f"({chunks * row_blocks(len(lost))} K1 launches), write_dat_file "
         f"{dat_s:.3f} s ({size / dat_s / 1e9:.3f} GB/s), "
         f"write_idx_from_ecx {idx_s:.4f} s; .dat sha256 == the "
         f"compacted; reboot {decoded_boot_s:.4f} s (A {per[0]:.4f} s) "
         f"mounts it as a Volume: "
         f"{len(kept)} live needles equal, "
         f"{len(gone) + len(more)} deleted ones KeyError")

    # 7 the remote tier out and back
    v1 = s.get_volume(1)
    t0 = time.perf_counter()
    v1.tier_move("local", {"directory": cold})
    move_s = time.perf_counter() - t0
    if not isinstance(v1._dat, RemoteFile):
        raise AssertionError("a tiered volume does not read through "
                             "RemoteFile")
    sample = kept[:: max(1, len(kept) // 256)]
    read_all(s, sample)
    try:
        s.write_needle(1, ndl.Needle(id=10**9, data=b"x"))
    except PermissionError:
        pass
    else:
        raise AssertionError("a tiered volume took a write")
    s.close()
    s, tier_boot_s, per = boot_store([a, b])  # from the .tier marker (3.6)
    v1 = s.get_volume(1)
    hb = s.collect_heartbeat()["volumes"]
    if v1 is None or v1.backend_kind != "remote" or \
            [(h["id"], h["read_only"]) for h in hb
             if h["id"] == 1] != [(1, True)]:
        raise AssertionError(f"the reboot did not mount the tiered volume "
                             f"from its marker: heartbeat {hb}")
    read_all(s, sample)
    t0 = time.perf_counter()
    v1.tier_download()
    dl_s = time.perf_counter() - t0
    s.close()
    if sha256(base + ".dat") != compacted:
        raise AssertionError("the downloaded .dat differs")
    out["tier"] = {"move_s": move_s, "move_gbps": size / move_s / 1e9,
                   "download_s": dl_s, "download_gbps": size / dl_s / 1e9,
                   "reboot_s": tier_boot_s, "reboot_location_s": per,
                   "sample_reads": len(sample)}
    slog(f"tier: move {move_s:.3f} s ({size / move_s / 1e9:.3f} GB/s), "
         f"{len(sample)} reads through RemoteFile equal, a write refused; "
         f"reboot {tier_boot_s:.4f} s (A {per[0]:.4f} s): the store "
         f"mounts it from the .tier "
         f"marker, read-only "
         f"in the heartbeat (fault 3.6, repaired), the same reads equal "
         f"through Store.read_needle; download {dl_s:.3f} s "
         f"({size / dl_s / 1e9:.3f} GB/s), .dat sha256 == before the move")

    # 8 launches against the layout
    want = units + len(touching) + chunks * row_blocks(len(lost))
    got = launches["gf_apply"] - k1
    if got != want:
        raise AssertionError(f"phase 14 launched K1 {got}; predicted {want}")
    out["launches_k1"] = got
    out["s"] = time.perf_counter() - t_phase
    shutil.rmtree(work)
    slog(f"K1 launches {got} == {units} encode units + {len(touching)} "
         f"degraded reads + {chunks} rebuild chunks x "
         f"{row_blocks(len(lost))}; phase wall {out['s']:.1f} s")
    return out


# phase 15's remote reads.  Two stand-ins, scaffolding as phase 9's
# helpers are, for what the volume server brings (ROADMAP 1.15a.3):
# `ShardPeer` answers GET /admin/ec/shard_read from its store's EcVolume
# as handle_ec_shard_read does (seaweedfs_tpu/server/volume_server.py:
# 2156-2169), with a delay switch as its _fault_delay_shard_read;
# `ShardReaderStandIn` maps shard ids to peers with a static table where
# _shard_reader (volume_server.py:824-944) asks the master, and fetches
# through the port's PooledHTTP, so the breaker gate, the deadline and
# the trace and class headers run on the card's host.
REMOTE_SLOW_S = 0.35  # step 2's slow peer
# step 2's needles, read again in steps 3 and 5; cut from 32 for the
# script's time (PERF §4)
REMOTE_HEDGED = 16
# step 2's hedging-off arm reads the first 4 of them, each 0.35 s late: its
# p50 is the slow peer's delay, and the arm launches nothing
REMOTE_HEDGE_OFF = 4
# step 4's, each 0.35 s: the first 4 of a draw of 8, so that the draws
# after it stay the same
REMOTE_RESCUED = 4
REMOTE_RESCUE_DRAW = 8
REMOTE_SKIPPED = 16  # step 7's
REMOTE_STEP1_EVERY = 3  # step 1 reads every third needle on shards 0-3
REMOTE_THREADS = 8  # step 8's
# step 8's reads with B up, where they launch nothing: the first 256 of
# the permutation; with B down, the first REMOTE_DOWN_READS (K1 each)
REMOTE_UP_READS = 256
# step 8's reads with B down, each a decode: cut from all of step 1's
# (898 at seed 0) for the script's time (PERF §4)
REMOTE_DOWN_READS = 384
# the reconstruction LRU's default budget (ec_volume.RECONSTRUCT_CACHE_
# BYTES): step 2's needles are drawn among those whose bytes on shards 0
# and 1 fit 1/16 of it, so that step 3 finds all 16 in the cache
REMOTE_LRU_SHARE = 8 * MIB // REMOTE_HEDGED


class ShardPeer:
    """One peer volume server's shard-read endpoint on loopback, over a
    port `Store` holding some of the shard files."""

    def __init__(self, store):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlsplit
        self.store = store
        self.delay_s = 0.0
        self.requests = 0
        self.inflight = 0
        self.headers: dict = {}  # header name -> requests carrying it
        self._lock = threading.Lock()
        self._conns: set = set()
        peer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True  # the body is a write of its own

            def setup(self):
                super().setup()
                with peer._lock:
                    peer._conns.add(self.connection)

            def finish(self):
                with peer._lock:
                    peer._conns.discard(self.connection)
                super().finish()

            def do_GET(self):
                with peer._lock:
                    peer.requests += 1
                    peer.inflight += 1
                    for name in self.headers:
                        if name.lower().startswith("x-weedtpu-"):
                            peer.headers[name] = peer.headers.get(name, 0) + 1
                try:
                    if peer.delay_s:
                        time.sleep(peer.delay_s)
                    u = urlsplit(self.path)
                    q = {k: int(v[0]) for k, v in parse_qs(u.query).items()}
                    ev = peer.store.get_ec_volume(q["volume"]) \
                        if u.path == "/admin/ec/shard_read" else None
                    data = None if ev is None else ev._read_local(
                        q["shard"], q["offset"], q["size"])
                    body = data if data is not None else \
                        b'{"error": "shard not local"}'
                    self.send_response(200 if data is not None else 404)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                finally:
                    with peer._lock:
                        peer.inflight -= 1

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def quiet(self, timeout: float = 10.0) -> None:
        """Wait until no request is being served."""
        end = time.monotonic() + timeout
        while self.inflight and time.monotonic() < end:
            time.sleep(0.005)
        if self.inflight:
            raise AssertionError(f"peer {self.addr}: {self.inflight} "
                                 f"requests still in flight")

    def stop(self) -> None:
        """Refuse new dials and cut the keep-alive connections: the peer
        is down."""
        import socket
        self.server.shutdown()
        self.server.server_close()
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self.thread.join(timeout=10)


class ShardReaderStandIn:
    """Shard ids -> peer address, a static table.  `bind()` is called on
    the reading thread, as the volume server builds its reader per
    request: it captures that thread's trace, traffic class and deadline,
    and the fetch threads of the read engine re-enter them around each
    PooledHTTP request."""

    def __init__(self, vid: int, table: dict):
        from seaweedfs_tpu_torch.utils import http
        self.vid = vid
        self.table = dict(table)
        self.http = http.PooledHTTP(timeout=5.0, role="volume")
        self.calls = self.dialed_failed = self.fast_failed = 0
        self.inflight = 0
        self.bytes = 0
        self._lock = threading.Lock()

    def bind(self):
        from seaweedfs_tpu_torch.security import tls
        from seaweedfs_tpu_torch.stats import netflow, trace
        from seaweedfs_tpu_torch.utils import resilience
        tctx = trace.current()
        cls = netflow.current_class() or "data"
        dl = resilience.deadline()
        scheme = tls.scheme()

        def read(sid: int, off: int, size: int):
            peer = self.table.get(sid)
            if peer is None:
                return None
            with self._lock:
                self.calls += 1
                self.inflight += 1
            tok_dl = resilience.set_deadline(dl)
            tok_cls = netflow.set_class(cls)
            try:
                with trace.span("volume.shard_fetch", parent=tctx,
                                shard=sid, peer=peer, bytes=size):
                    st, _, body = self.http.request(
                        f"{scheme}://{peer}/admin/ec/shard_read?volume="
                        f"{self.vid}&shard={sid}&offset={off}&size={size}")
            except OSError as e:
                with self._lock:
                    if "circuit open" in str(e):
                        self.fast_failed += 1
                    else:
                        self.dialed_failed += 1
                return None
            finally:
                netflow.reset(tok_cls)
                resilience.reset_deadline(tok_dl)
                with self._lock:
                    self.inflight -= 1
            if st != 200 or len(body) != size:
                return None
            with self._lock:
                self.bytes += size
            return body

        return read

    def quiet(self, timeout: float = 10.0) -> None:
        """Wait until no fetch is in flight (the hedge's abandoned
        fetches included)."""
        end = time.monotonic() + timeout
        while self.inflight and time.monotonic() < end:
            time.sleep(0.005)
        if self.inflight:
            raise AssertionError(f"{self.inflight} shard fetches still in "
                                 f"flight")

    def close(self) -> None:
        self.http.close()


class scoped_env:
    """Set environment variables for a block; restore them after."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def server_packages() -> dict:
    """Whether the servers' packages can be imported on this host."""
    import importlib.util
    out = {}
    for name in ("aiohttp", "google.protobuf", "cryptography"):
        try:
            out[name] = importlib.util.find_spec(name) is not None
        except ModuleNotFoundError:
            out[name] = False
    return out


def intervals(ev, nid: int) -> list[tuple[int, int, int]]:
    """(shard, offset in the shard file, size) of each interval of a
    needle, by the layout."""
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout
    off, size = ev.find_needle(nid)
    return [iv.to_shard_id_and_offset() + (iv.size,)
            for iv in layout.locate_data(
                ev.large_block, ev.small_block, ev.dat_size, off,
                t.actual_size(size, ev.version), data_shards=ev.spec.k)]


def phase_remote(vdir: str, base: str, expect: dict, blob: bytes,
                 seed: int, launches: dict, device=None) -> dict:
    """Phase 15: degraded EC reads with shards on peers, through
    `Store.read_needle(shard_reader=...)` on the card (device left at its
    default), on nodes built from hard links of phase 4's shard set:
    remote reads, hedging against a slow peer (off and on), the
    reconstruction LRU, the rescue of abandoned fetches, a dead peer
    behind its breaker, a quarantined range, `skip_shards`, and eight
    reading threads with the peer up and down.  K1's launches held
    against each step's prediction."""
    import numpy as np
    from seaweedfs_tpu_torch.maintenance import scrub
    from seaweedfs_tpu_torch.stats import metrics, trace
    from seaweedfs_tpu_torch.storage import store as st
    from seaweedfs_tpu_torch.storage.ec import layout
    from seaweedfs_tpu_torch.utils import resilience

    card = card_name_power()

    def rlog(msg: str) -> None:
        log(f"[remote] {msg} [{card}]")

    work = os.path.join(vdir, "remote")
    os.makedirs(work)
    name = os.path.basename(base)
    vid = int(name)
    rng = np.random.default_rng(seed + 15)
    out: dict = {"card": card, "server_packages": server_packages()}
    rlog("server packages importable on this host: " + ", ".join(
        f"{k} {'yes' if v else 'no'}" for k, v in
        out["server_packages"].items()))
    k1_phase = launches["gf_apply"]
    t_phase = time.perf_counter()
    stores: list = []
    peers: list = []
    readers: list = []

    def node(label: str, keep) -> "st.Store":
        d = os.path.join(work, label)
        os.makedirs(d)
        for ext in [layout.to_ext(i) for i in keep] + [".ecx", ".vif"]:
            os.link(base + ext, os.path.join(d, name + ext))
        s = st.Store([d], device=device)
        stores.append(s)
        return s

    def peer(s) -> ShardPeer:
        p = ShardPeer(s)
        peers.append(p)
        return p

    def reader(table: dict) -> ShardReaderStandIn:
        r = ShardReaderStandIn(vid, table)
        readers.append(r)
        return r

    def read_one(s, nid: int, rd) -> float:
        """One read through Store.read_needle under a 30 s budget;
        returns its seconds."""
        tok = resilience.set_deadline(time.monotonic() + 30.0)
        try:
            t0 = time.perf_counter()
            n = s.read_needle(vid, nid, expect[nid][0],
                              shard_reader=rd.bind() if rd else None)
            dt = time.perf_counter() - t0
        finally:
            resilience.reset_deadline(tok)
        cookie, lo, hi = expect[nid]
        if n.id != nid or n.cookie != cookie or n.data != blob[lo:hi]:
            raise AssertionError(f"remote read of needle {nid} differs")
        return dt

    def read_all(s, nids, rd) -> list[float]:
        with trace.span("chip.remote_reads", parent=trace.new_root(),
                        reads=len(nids)):
            return [read_one(s, nid, rd) for nid in nids]

    def counters(s) -> dict:
        c = {"k1": launches["gf_apply"], "k2": launches["gf_apply_batch"]}
        c.update(s.get_ec_volume(vid).read_stats_snapshot())
        for o in ("fired", "hedge_won", "primary_rescued"):
            c[o] = int(metrics.HEDGE_TOTAL.labels(o).value)
        return c

    def grown(s, before: dict) -> dict:
        after = counters(s)
        return {k: after[k] - before[k] for k in before}

    def empty_lru(s) -> None:
        ev = s.get_ec_volume(vid)
        with ev._recon_lock:
            ev._recon_cache.clear()
            ev._recon_cache_bytes = 0

    def fresh_history() -> None:
        resilience.reset_latency_trackers()
        resilience.reset_breakers()

    def hold(step: str, got: dict, want: dict) -> None:
        for key, value in want.items():
            if got[key] != value:
                raise AssertionError(f"phase 15 {step}: {key} grew by "
                                     f"{got[key]}, predicted {value}")

    def lat(ts: list[float]) -> dict:
        return {"p50_s": statistics.median(ts), "max_s": max(ts),
                "mean_s": sum(ts) / len(ts), "n": len(ts)}

    steps: dict = {}
    k1_steps: dict = {}
    try:
        full = node("full", range(layout.TOTAL_SHARDS))
        fev = full.get_ec_volume(vid)
        ivs = {nid: intervals(fev, nid) for nid in expect}
        reads1 = [nid for nid, iv in ivs.items()
                  if any(s < 4 for s, _, _ in iv)]
        pair = [nid for nid, iv in ivs.items()
                if any(s < 2 for s, _, _ in iv)]
        both = [nid for nid in pair
                if {0, 1} <= {s for s, _, _ in ivs[nid]}]
        fit = [nid for nid in pair if sum(
            n for s, _, n in ivs[nid] if s < 2) <= REMOTE_LRU_SHARE]
        hedged = sorted(rng.choice(fit, REMOTE_HEDGED, replace=False)
                        .tolist())
        rescued = sorted(rng.choice(both, REMOTE_RESCUE_DRAW, replace=False)
                         .tolist()[:REMOTE_RESCUED])
        skipped = sorted(rng.choice(
            [nid for nid in pair if any(s == 0 for s, _, _ in ivs[nid])],
            REMOTE_SKIPPED, replace=False).tolist())
        out["needles"] = {"touching_0_3": len(reads1),
                          "touching_0_1": len(pair),
                          "touching_0_and_1": len(both),
                          "fit_lru_share": len(fit)}

        # 1 remote reads: A holds 4-13, B 0-3 and answers at once
        a = node("a", range(4, 14))
        pb = peer(node("b", range(4)))
        ra = reader({s: pb.addr for s in range(4)})
        fresh_history()
        before = counters(a)
        reads = reads1[::REMOTE_STEP1_EVERY]
        t0 = time.perf_counter()
        ts = read_all(a, reads, ra)
        dt = time.perf_counter() - t0
        g = grown(a, before)
        if g["remote_shard_reads"] <= 0:
            raise AssertionError("step 1 fetched nothing from the peer")
        if not g["k1"] == g["reconstruct_batches"] == g["fired"]:
            raise AssertionError(f"step 1: K1 {g['k1']}, reconstruct "
                                 f"batches {g['reconstruct_batches']}, "
                                 f"hedges fired {g['fired']}: not equal")
        k1_steps["1 remote"] = (g["k1"], 0)
        steps["remote"] = {"reads": len(reads), "s": dt,
                           "reads_per_s": len(reads) / dt,
                           "remote_mb_s": ra.bytes / dt / 1e6,
                           "remote_bytes": ra.bytes, "grown": g,
                           "latency": lat(ts), "peer_headers": dict(
                               pb.headers), "peer_requests": pb.requests}
        rlog(f"1 remote reads: {len(reads)} of the {len(reads1)} needles "
             f"on shards 0-3 equal, {len(reads) / dt:.1f} reads/s, "
             f"{ra.bytes / dt / 1e6:.1f} "
             f"MB/s fetched from B ({ra.bytes} B in {pb.requests} "
             f"requests, remote_shard_reads +{g['remote_shard_reads']}); "
             f"K1 +{g['k1']} == reconstruct batches == hedges fired "
             f"(predicted 0); B saw headers {dict(pb.headers)}")

        # 2 hedging against a slow peer: A2 holds 2-13, B2 0-1, 0.35 s late
        a2 = node("a2", range(2, 14))
        pb2 = peer(node("b2", range(2)))
        pb2.delay_s = REMOTE_SLOW_S
        ra2 = reader({0: pb2.addr, 1: pb2.addr})
        arms = {}
        for arm, env in (("off", {"WEEDTPU_HEDGE_PCT": "0"}),
                         ("on", {"WEEDTPU_HEDGE_PCT": "99",
                                 "WEEDTPU_HEDGE_MAX_MS": "100"})):
            needles = hedged[:REMOTE_HEDGE_OFF] if arm == "off" else hedged
            empty_lru(a2)
            fresh_history()
            with scoped_env(**env):
                before = counters(a2)
                ts = read_all(a2, needles, ra2)
                g = grown(a2, before)
            ra2.quiet()
            pb2.quiet()
            want = {"k1": 0, "fired": 0, "hedge_won": 0} if arm == "off" \
                else {"k1": REMOTE_HEDGED, "fired": REMOTE_HEDGED,
                      "hedge_won": REMOTE_HEDGED, "primary_rescued": 0}
            hold(f"step 2 ({arm})", g, want)
            k1_steps[f"2 hedge {arm}"] = (g["k1"], want["k1"])
            arms[arm] = {"latency": lat(ts), "grown": g}
            rlog(f"2 hedge {arm}: {len(needles)} needles on shards 0-1 "
                 f"equal, p50 {statistics.median(ts):.4f} s, max "
                 f"{max(ts):.4f} s; fired +{g['fired']}, hedge_won "
                 f"+{g['hedge_won']}, primary_rescued "
                 f"+{g['primary_rescued']}, K1 +{g['k1']} (predicted "
                 f"{want['k1']})")
        ratio = arms["off"]["latency"]["p50_s"] / \
            arms["on"]["latency"]["p50_s"]
        steps["hedge"] = dict(arms, p50_ratio_off_over_on=ratio,
                              slow_s=REMOTE_SLOW_S)
        rlog(f"2 hedge: p50 off / on {ratio:.3f}")

        # 3 the LRU: the on arm's needles again
        with scoped_env(WEEDTPU_HEDGE_PCT="99", WEEDTPU_HEDGE_MAX_MS="100"):
            r0 = pb2.requests
            before = counters(a2)
            ts = read_all(a2, hedged, ra2)
            g = grown(a2, before)
        hold("step 3", g, {"k1": 0})
        if pb2.requests != r0 or g["reconstruct_cache_hits"] < REMOTE_HEDGED:
            raise AssertionError(f"step 3: {pb2.requests - r0} requests to "
                                 f"B, {g['reconstruct_cache_hits']} LRU hits")
        k1_steps["3 lru"] = (g["k1"], 0)
        steps["lru"] = {"latency": lat(ts), "grown": g}
        rlog(f"3 LRU: {REMOTE_HEDGED} needles equal, p50 "
             f"{statistics.median(ts):.5f} s, max {max(ts):.5f} s, "
             f"reconstruct_cache_hits +{g['reconstruct_cache_hits']}, no "
             f"request to B, K1 +0")

        # 4 primary rescue: A4 holds 2-10, nobody 11-13
        a4 = node("a4", range(2, 11))
        fresh_history()
        with scoped_env(WEEDTPU_HEDGE_PCT="99", WEEDTPU_HEDGE_MAX_MS="100"):
            before = counters(a4)
            ts = read_all(a4, rescued, ra2)
            g = grown(a4, before)
        hold("step 4", g, {"k1": 0, "fired": REMOTE_RESCUED,
                           "primary_rescued": REMOTE_RESCUED,
                           "hedge_won": 0, "reconstruct_batches": 0})
        k1_steps["4 rescue"] = (g["k1"], 0)
        steps["rescue"] = {"latency": lat(ts), "grown": g}
        rlog(f"4 rescue: {REMOTE_RESCUED} needles on shards 0 and 1 equal "
             f"(9 survivors of 10), p50 {statistics.median(ts):.4f} s, "
             f"primary_rescued +{g['primary_rescued']}, K1 +0")

        # 5 dead peer: B2 down, A2's LRU emptied, the breakers reset
        ra2.quiet()
        pb2.stop()
        empty_lru(a2)
        fresh_history()
        threshold = resilience.CircuitBreaker().threshold
        with scoped_env(WEEDTPU_HEDGE_PCT="99", WEEDTPU_HEDGE_MAX_MS="100",
                        WEEDTPU_BREAKER_COOLDOWN="30"):
            c0 = (ra2.calls, ra2.dialed_failed, ra2.fast_failed)
            before = counters(a2)
            ts = read_all(a2, hedged, ra2)
            g = grown(a2, before)
            calls = ra2.calls - c0[0]
            dialed = ra2.dialed_failed - c0[1]
            fast = ra2.fast_failed - c0[2]
        hold("step 5", g, {"k1": REMOTE_HEDGED,
                           "reconstruct_batches": REMOTE_HEDGED})
        # every failed dial is a failure the breaker saw, and it saw none
        # after it opened: no read dialed B after that (two fetches of one
        # read can both pass the gate just before it opens)
        snap = resilience.breakers_snapshot().get(pb2.addr, {})
        if snap.get("state") != "open" or snap.get("trips") != 1 or \
                dialed != snap.get("failures") or dialed < threshold or \
                fast != calls - dialed:
            raise AssertionError(f"step 5: breaker {snap}, {calls} fetches, "
                                 f"{dialed} dialed, {fast} fast-failed; "
                                 f"threshold {threshold}")
        k1_steps["5 dead peer"] = (g["k1"], REMOTE_HEDGED)
        steps["dead_peer"] = {"latency": lat(ts), "grown": g,
                              "breaker": snap, "fetches": calls,
                              "dialed": dialed, "fast_failed": fast}
        rlog(f"5 dead peer: {REMOTE_HEDGED} needles equal, p50 "
             f"{statistics.median(ts):.4f} s; breaker {snap['state']} after "
             f"{dialed} failed dials (threshold {threshold}), {fast} of "
             f"{calls} fetches refused without a dial; K1 +{g['k1']}")

        # 6 quarantine: 128 bytes of shard 2 flipped, found, quarantined
        qev = full.get_ec_volume(vid)
        s2 = base + layout.to_ext(2)
        qoff = qev.shard_size // 3 // MIB * MIB + 4096  # inside one window
        with open(s2, "r+b") as f:
            orig = os.pread(f.fileno(), 128, qoff)
            os.pwrite(f.fileno(), bytes(b ^ 0xFF for b in orig), qoff)
        try:
            k1 = launches["gf_apply"]
            t0 = time.perf_counter()
            found = scrub.syndrome_scan(qev)
            scan_s = time.perf_counter() - t0
            scan_k1 = launches["gf_apply"] - k1
            windows = -(-qev.shard_size // scrub.DEFAULT_WINDOW)
            if [c["shard"] for c in found] != [2] or scan_k1 != windows:
                raise AssertionError(f"step 6: scan found {found} with "
                                     f"{scan_k1} launches")
            for c in found:
                qev.quarantine_range(c["shard"], c["offset"], c["size"])
            over = [nid for nid, iv in ivs.items()
                    if any(sid == 2 and c["offset"] < off + n and
                           off < c["offset"] + c["size"]
                           for c in found for sid, off, n in iv)]
            rq = reader({})
            before = counters(full)
            ts = read_all(full, over, rq)
            g = grown(full, before)
            if g["k1"] != g["reconstruct_batches"] or \
                    g["k1"] != len(over):
                raise AssertionError(f"step 6: K1 {g['k1']}, batches "
                                     f"{g['reconstruct_batches']}, "
                                     f"{len(over)} reads")
            qev.clear_quarantine(2)
        finally:
            with open(s2, "r+b") as f:
                os.pwrite(f.fileno(), orig, qoff)
        if qev._read_local(2, qoff, 128) != orig:
            raise AssertionError("step 6: shard 2 not restored")
        k1_steps["6 quarantine"] = (g["k1"], len(over))
        steps["quarantine"] = {"found": found, "reads": len(over),
                               "latency": lat(ts), "grown": g,
                               "scan_s": scan_s, "scan_k1": scan_k1}
        rlog(f"6 quarantine: the flip found in {scan_s:.3f} s "
             f"({scan_k1} windows, K1 each), range {found[0]['offset']}+"
             f"{found[0]['size']} of shard 2 quarantined; {len(over)} "
             f"needles over it equal through reconstruction, K1 "
             f"+{g['k1']} == reconstruct batches; cleared, restored")

        # 7 skip_shards on the node with every shard
        lru = (len(qev._recon_cache), qev._recon_cache_bytes)
        before = counters(full)
        bound = rq.bind()
        for nid in skipped:
            n = qev.read_needle(nid, bound, skip_shards={0})
            cookie, lo, hi = expect[nid]
            if n.cookie != cookie or n.data != blob[lo:hi]:
                raise AssertionError(f"skip_shards read of {nid} differs")
        g = grown(full, before)
        hold("step 7", g, {"k1": REMOTE_SKIPPED,
                           "reconstruct_batches": REMOTE_SKIPPED})
        if (len(qev._recon_cache), qev._recon_cache_bytes) != lru:
            raise AssertionError("step 7: skip_shards grew the volume's LRU")
        k1_steps["7 skip_shards"] = (g["k1"], REMOTE_SKIPPED)
        steps["skip_shards"] = {"reads": REMOTE_SKIPPED, "grown": g}
        rlog(f"7 skip_shards={{0}}: {REMOTE_SKIPPED} needles equal, K1 "
             f"+{g['k1']}, the volume's LRU unchanged ({lru[0]} ranges)")

        # 8 eight threads on A, B up then down
        order = rng.permutation(reads1).tolist()
        for label in ("peer up", "peer down"):
            arm = order[:REMOTE_UP_READS] if label == "peer up" else \
                order[:REMOTE_DOWN_READS]
            shares = [arm[i::REMOTE_THREADS] for i in range(REMOTE_THREADS)]
            if label == "peer down":
                empty_lru(a)
                ra.quiet()
                pb.stop()
            fresh_history()
            errors: list = []

            def run(share):
                try:
                    read_all(a, share, ra)
                except Exception as e:  # surfaced after the join
                    errors.append(e)

            before = counters(a)
            t0 = time.perf_counter()
            threads = [threading.Thread(target=run, args=(sh,))
                       for sh in shares]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            dt = time.perf_counter() - t0
            if errors or any(th.is_alive() for th in threads):
                raise AssertionError(f"step 8 ({label}): {errors[:3]}")
            g = grown(a, before)
            want = g["reconstruct_batches"] if label == "peer up" \
                else len(arm)
            if g["k1"] != g["reconstruct_batches"] or g["k1"] != want:
                raise AssertionError(f"step 8 ({label}): K1 {g['k1']}, "
                                     f"batches {g['reconstruct_batches']}, "
                                     f"{len(arm)} reads")
            k1_steps[f"8 threads, {label}"] = (g["k1"], 0 if
                                               label == "peer up" else
                                               len(arm))
            steps[f"threads_{label.replace(' ', '_')}"] = {
                "reads": len(arm), "s": dt,
                "reads_per_s": len(arm) / dt, "grown": g}
            rlog(f"8 {REMOTE_THREADS} threads, {label}: {len(arm)} "
                 f"needles equal, {len(arm) / dt:.1f} reads/s, K1 "
                 f"+{g['k1']} == reconstruct batches, hedges fired "
                 f"+{g['fired']}")
        ra.quiet()
    finally:
        for p in peers:
            if p.thread.is_alive():
                p.stop()
        for r in readers:
            r.close()
        for s in stores:
            s.close()
        shutil.rmtree(work, ignore_errors=True)

    got = launches["gf_apply"] - k1_phase
    want = sum(g for g, _ in k1_steps.values()) + \
        steps["quarantine"]["scan_k1"]
    if got != want:
        raise AssertionError(f"phase 15 launched K1 {got}; the steps "
                             f"count {want}")
    out.update(steps)
    out["k1_steps"] = {k: {"launched": g, "predicted": p}
                       for k, (g, p) in k1_steps.items()}
    out["launches_k1"] = got
    out["s"] = time.perf_counter() - t_phase
    rlog("K1 per step (launched / predicted): " + "; ".join(
        f"{k} {g} / {p}" for k, (g, p) in k1_steps.items()) +
        f"; scan {steps['quarantine']['scan_k1']}; total {got}; phase "
        f"wall {out['s']:.1f} s")
    return out


# phase 16's volume server, behind the port's master (single, no raft).
SERVER_LOSSES = (0, 3, 10, 12)  # phase 5's
SERVER_A_SHARDS = tuple(range(7))  # the spread: A 0-6, B 7-13
# upstream's `weed benchmark` defaults (-size 1024 -c 16; SeaweedFS
# README, weed/command/benchmark.go), cut from -n 1048576 (to 16384 for
# the script's time, then to 2048, then 1024: PERF §4)
SERVER_SMALL = 1024
SERVER_SMALL_SIZE = 1024
SERVER_CLIENTS = 16
SERVER_REPLICATED = 128  # cut from 1024 for the script's time (PERF §4)
SERVER_DELETES = 256
# step 4's needles off the lost data shards, drawn with --seed from the
# ~1400 of them (256 before, and every needle before that), and steps 1
# and 6's, drawn from all (each step read every needle before; PERF §4)
SERVER_DEGRADED_OTHERS = 32
# step 4's needles on a lost data shard, drawn with --seed: cut from all
# 602 for the script's time (PERF §4)
SERVER_DEGRADED_TOUCHING = 256
SERVER_READ_SAMPLE = 256


def master_split(client, master_url: str, vid: int) -> dict:
    """A master's /dir/ec/lookup of `vid` as node -> its sorted shard ids
    ({} while the master knows no such EC volume)."""
    st, _, raw = client.request(
        f"http://{master_url}/dir/ec/lookup?volumeId={vid}")
    split: dict = {}
    for sid, locs in (json.loads(raw)["shards"].items() if st == 200
                      else ()):
        for loc in locs:
            split.setdefault(loc["url"], []).append(int(sid))
    return {u: sorted(v) for u, v in sorted(split.items())}


def server_latency(ts: list[float]) -> dict:
    ts = sorted(ts)
    return {"p50_s": ts[len(ts) // 2], "p99_s": ts[min(len(ts) - 1,
                                                        len(ts) * 99 // 100)],
            "max_s": ts[-1], "n": len(ts)}


def small_objects(seed: int):
    """Step 7's objects: (payload of SERVER_SMALL x SERVER_SMALL_SIZE
    bytes, one cookie each), from the seed, the same in the parent and in
    the clients' child."""
    import numpy as np
    rng = np.random.default_rng(seed + 16)
    payload = rng.bytes(SERVER_SMALL * SERVER_SMALL_SIZE)
    return payload, rng.integers(0, 1 << 32, SERVER_SMALL).tolist()


def small_clients(url: str, vid: int, seed: int) -> int:
    """Child of phase 16's step 7, a process of its own as upstream's
    `weed benchmark` is: SERVER_CLIENTS threads write then read the
    SERVER_SMALL objects of `small_objects(seed)` on volume `vid` at
    `url` through the port's PooledHTTP, every read byte-equal; answers
    one JSON line of rates and latencies."""
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.utils import http

    payload, cookies = small_objects(seed)
    client = http.PooledHTTP(timeout=120.0,
                             max_idle_per_host=SERVER_CLIENTS)
    fids = [str(t.FileId(vid, i + 1, cookies[i]))
            for i in range(SERVER_SMALL)]

    def body(i: int) -> bytes:
        return payload[i * SERVER_SMALL_SIZE:(i + 1) * SERVER_SMALL_SIZE]

    def put(i: int) -> None:
        st, _, _ = client.request(f"http://{url}/{fids[i]}", method="PUT",
                                  body=body(i))
        if st != 201:
            raise AssertionError(f"small write {i}: HTTP {st}")

    def get(i: int) -> None:
        st, _, raw = client.request(f"http://{url}/{fids[i]}")
        if st != 200 or raw != body(i):
            raise AssertionError(f"small read {i}: HTTP {st}")

    def fan(fn) -> tuple[list[float], float]:
        ts: list = [[] for _ in range(SERVER_CLIENTS)]
        errors: list = []

        def worker(c: int) -> None:
            try:
                for i in range(c, SERVER_SMALL, SERVER_CLIENTS):
                    t0 = time.perf_counter()
                    fn(i)
                    ts[c].append(time.perf_counter() - t0)
            except Exception as e:  # surfaced after the join
                errors.append(e)
        threads = [threading.Thread(target=worker, args=(c,))
                   for c in range(SERVER_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        dt = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return [x for c in ts for x in c], dt

    wts, wdt = fan(put)
    rts, rdt = fan(get)
    client.close()
    print(json.dumps({"writes_per_s": SERVER_SMALL / wdt,
                      "write": server_latency(wts),
                      "reads_per_s": SERVER_SMALL / rdt,
                      "read": server_latency(rts)}), flush=True)
    return 0


def phase_server(vdir: str, src_base: str, expect: dict, blob: bytes,
                 hashes: list[str], aux_hashes: dict, dat_hash: str,
                 encode_k1: int, rebuild_k1: int, seed: int,
                 launches: dict, device=None) -> dict:
    """Phase 16: two port volume servers on the card, in process on one
    event-loop thread behind the port's master (single, no raft, on the
    same loop), driven over loopback HTTP as the reference shell and
    clients drive them: mount the phase-3 volume, encode it, spread the
    shards, read degraded, rebuild, decode, small objects, replicated
    writes, /metrics.  K1 per step held against its prediction, every
    byte against phases 3, 4 and 6.  The master's vacuum scan (every
    minute) never fires here: the phase takes under a minute, and its
    one volume with deletes holds 256 of 1024 needles deleted (25%,
    under the 0.3 garbage threshold)."""
    import aiohttp
    import numpy as np
    from google import protobuf
    from seaweedfs_tpu_torch.server import volume_server as vsmod
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.stats import metrics
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout
    from seaweedfs_tpu_torch.utils import http, resilience

    card = card_name_power()

    def slog(msg: str) -> None:
        log(f"[server] {msg} [{card}]")

    work = os.path.join(vdir, "server")
    dirs = [os.path.join(work, n) for n in ("a", "b")]
    for d in dirs:
        os.makedirs(d)
    vid = int(os.path.basename(src_base))
    out: dict = {"card": card, "aiohttp": aiohttp.__version__,
                 "protobuf": protobuf.__version__}
    slog(f"aiohttp {aiohttp.__version__}, protobuf {protobuf.__version__}; "
         f"the one-write response path "
         f"{'probed' if vsmod._ser_headers is not None else 'unavailable'}")
    loops: list = []
    run = loop_thread(loops)

    master = None
    servers: list = []
    client = http.PooledHTTP(timeout=120.0, max_idle_per_host=64)
    requests = {"read": 0, "write": 0, "delete": 0}
    steps: dict = {}
    k1: dict = {}
    t_phase = time.perf_counter()

    def call(url: str, path: str, body=None, method=None,
             data=None) -> tuple[int, bytes]:
        hdrs = {}
        if body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        st, _, raw = client.request(
            f"http://{url}{path}",
            method=method or ("POST" if data is not None else "GET"),
            body=data, headers=hdrs)
        return st, raw

    def admin(url: str, path: str, body=None) -> dict:
        st, raw = call(url, path, body)
        if st != 200:
            raise AssertionError(f"{url}{path}: HTTP {st} {raw[:300]!r}")
        return json.loads(raw) if raw else {}

    def blob_get(url: str, fid: str) -> bytes:
        st, raw = call(url, "/" + fid)
        requests["read"] += 1
        if st != 200:
            raise AssertionError(f"GET {url}/{fid}: HTTP {st}")
        return raw

    def needle_fid(nid: int) -> str:
        return str(t.FileId(vid, nid, expect[nid][0]))

    def read_needles(url: str, label: str, nids=None
                     ) -> tuple[list[float], float]:
        """Every needle (or those of `nids`), byte-equal, at
        SERVER_CLIENTS clients: (each read's seconds, the wall)."""
        nids = list(expect) if nids is None else nids
        ts: list = [[] for _ in range(SERVER_CLIENTS)]
        errors: list = []

        def worker(c: int) -> None:
            try:
                for nid in nids[c::SERVER_CLIENTS]:
                    cookie, lo, hi = expect[nid]
                    t0 = time.perf_counter()
                    st, raw = call(url, "/" + needle_fid(nid))
                    ts[c].append(time.perf_counter() - t0)
                    if st != 200 or raw != blob[lo:hi]:
                        raise AssertionError(f"{label}: needle {nid} "
                                             f"differs (HTTP {st})")
            except Exception as e:  # surfaced after the join
                errors.append(e)
        threads = [threading.Thread(target=worker, args=(c,))
                   for c in range(SERVER_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        dt = time.perf_counter() - t0
        if errors:
            raise errors[0]
        requests["read"] += len(nids)
        return [x for c in ts for x in c], dt

    def k1_step(name: str, k0: int, want: int) -> None:
        got = launches["gf_apply"] - k0
        k1[name] = got
        if got != want:
            raise AssertionError(f"phase 16 {name}: K1 launched {got}, "
                                 f"predicted {want}")

    def master_view() -> tuple[dict, bool]:
        """The master's shard split of the volume, and whether its
        /dir/status still lists the volume."""
        nodes = json.loads(call(master.url, "/dir/status")[1])[
            "Topology"]["nodes"]
        return (master_split(client, master.url, vid),
                any(vid in n["volumes"] for n in nodes.values()))

    try:
        beats0 = metrics.MASTER_RECEIVED_HEARTBEATS.labels().value
        # no canary and no repair loop: the blob and degraded probes would
        # write and launch K1, and the planner would rebuild the shards
        # step 4 deletes, at times no step predicts
        with scoped_env(WEEDTPU_CANARY_INTERVAL="0",
                        WEEDTPU_REPAIR_INTERVAL="0"):
            master = MasterServer("127.0.0.1", free_port())
            run(master.start())
        mport = master.port
        for d in dirs:
            # device left at its default (None): the card.  No scrubber:
            # a background pass would launch K1 inside the counted steps
            vs = vsmod.VolumeServer([d], f"127.0.0.1:{mport}", "127.0.0.1",
                                    free_port(), heartbeat_interval=0.5,
                                    device=device)
            with scoped_env(WEEDTPU_SCRUB_MBPS="0"):
                run(vs.start())
            if vs.scrubber is not None:
                raise AssertionError("a phase 16 server started a "
                                     "scrubber")
            servers.append(vs)
        a, b = servers
        slog(f"servers A {a.url} and B {b.url} on {a.device}")
        base_a = os.path.join(dirs[0], str(vid))
        base_b = os.path.join(dirs[1], str(vid))
        one_shot0 = dict(vsmod.ONE_SHOT)
        counter0 = {k: metrics.VOLUME_REQUEST_COUNTER.labels(k).value
                    for k in requests}
        dat_size = os.path.getsize(src_base + ".dat")

        # steps 1 and 6 read a draw of the needles: the .dat's sha256
        # holds every byte there (PERF §4)
        drawn = sorted(np.random.default_rng(seed + 15).choice(
            list(expect), size=min(len(expect), SERVER_READ_SAMPLE),
            replace=False).tolist())
        drawn_bytes = sum(expect[nid][2] - expect[nid][1] for nid in drawn)

        # 1 mount the phase-3 volume (a copy taken before phase 14) on A
        k0 = launches["gf_apply"]
        for ext in (".dat", ".idx"):
            shutil.copyfile(src_base + ext, base_a + ext)
        admin(a.url, "/admin/volume/mount", {"volume": vid})
        ts, dt = read_needles(a.url, "mounted read", drawn)
        k1_step("1 mount", k0, 0)
        steps["1 mount"] = {"reads": len(ts), "s": dt,
                            "reads_per_s": len(ts) / dt,
                            "gbps": drawn_bytes / dt / 1e9,
                            **server_latency(ts)}
        slog(f"1 mount: {len(ts)} needles over HTTP from the mounted "
             f"volume at {SERVER_CLIENTS} clients, {len(ts) / dt:.1f} "
             f"reads/s, "
             f"{drawn_bytes / dt / 1e9:.3f} GB/s, p50 "
             f"{steps['1 mount']['p50_s'] * 1e3:.2f} ms; K1 0")

        # 2 encode: readonly, generate, /admin/ec/progress polled
        k0 = launches["gf_apply"]
        admin(a.url, "/admin/volume/readonly", {"volume": vid})
        polls: list = []
        result: dict = {}

        def generate():
            result["reply"] = admin(a.url, "/admin/ec/generate",
                                    {"volume": vid})
        gen = threading.Thread(target=generate)
        t0 = time.perf_counter()
        gen.start()
        while gen.is_alive():
            st, raw = call(a.url, f"/admin/ec/progress?volumeId={vid}")
            if st == 200:
                polls.append(json.loads(raw)["bytes_done"])
            time.sleep(0.02)
        gen.join()
        dt = time.perf_counter() - t0
        if result.get("reply") != {"shards": list(range(14)),
                                   "codec": "rs_10_4"}:
            raise AssertionError(f"generate: {result.get('reply')}")
        prog = admin(a.url, f"/admin/ec/progress?volumeId={vid}")
        if prog["state"] != "done" or prog["bytes_done"] != dat_size:
            raise AssertionError(f"progress after generate: {prog}")
        if polls != sorted(polls):
            raise AssertionError(f"progress went backwards: {polls}")
        k1_step("2 encode", k0, encode_k1)
        got = sha256_many([base_a + layout.to_ext(i) for i in range(14)]
                          + [base_a + ext for ext in aux_hashes])
        for i in range(14):
            if got[i] != hashes[i]:
                raise AssertionError(f"server shard {i} differs from "
                                     f"phase 4's")
        for ext, h in zip(aux_hashes, got[14:]):
            if h != aux_hashes[ext]:
                raise AssertionError(f"server {ext} differs from phase 4's")
        steps["2 encode"] = {"s": dt, "gbps": dat_size / dt / 1e9,
                             "progress_polls": len(polls),
                             "stages_s": {k: v for k, v in
                                          prog["stages"].items()
                                          if k.endswith("_s")}}
        slog(f"2 encode: {dat_size / dt / 1e9:.3f} GB/s of .dat through "
             f"/admin/ec/generate ({dt:.3f} s, {len(polls)} progress polls); "
             f"14 shards, .ecx and .vif sha256 == phase 4's; K1 "
             f"{k1['2 encode']} == phase 4's")

        # 3 spread: B pulls 7-13 through A's /admin/file; both mount; A
        # drops its copies of 7-13 and the volume
        k0 = launches["gf_apply"]
        moved = [i for i in range(14) if i not in SERVER_A_SHARDS]
        t0 = time.perf_counter()
        admin(b.url, "/admin/ec/copy", {"volume": vid, "source": a.url,
                                        "shards": moved, "copy_ecx": True})
        dt_copy = time.perf_counter() - t0
        admin(b.url, "/admin/ec/mount", {"volume": vid})
        admin(a.url, "/admin/ec/mount", {"volume": vid})
        admin(a.url, "/admin/ec/delete_shards", {"volume": vid,
                                                  "shards": moved})
        admin(a.url, "/admin/volume/delete", {"volume": vid})
        want = {a.url: list(SERVER_A_SHARDS), b.url: moved}
        deadline = time.monotonic() + 10
        while (got := master_view()) != (want, False) and \
                time.monotonic() < deadline:
            time.sleep(0.05)  # the next beat
        split, still = got
        if split != want:
            raise AssertionError(f"the master shows {split}")
        if still:
            raise AssertionError("the master still lists the deleted "
                                 "volume")
        k1_step("3 spread", k0, 0)
        copied = sum(os.path.getsize(base_b + layout.to_ext(i))
                     for i in moved)
        steps["3 spread"] = {"copied_bytes": copied, "copy_s": dt_copy,
                             "copy_gbps": copied / dt_copy / 1e9,
                             "split": split}
        slog(f"3 spread: {copied} B of shards pulled by B through A's "
             f"/admin/file in {dt_copy:.3f} s "
             f"({copied / dt_copy / 1e9:.3f} GB/s); the master shows A "
             f"{split[a.url]}, B {split[b.url]}; K1 0")

        # 4 degraded reads: phase 5's losses deleted where they live; A
        # reads needles, B's shards through A's _shard_reader and B's
        # /admin/ec/shard_read.  Hedging off, so K1 is one launch per
        # needle on a lost data shard (a hedge would add reconstructs)
        admin(a.url, "/admin/ec/delete_shards",
              {"volume": vid, "shards": [s for s in SERVER_LOSSES
                                         if s in SERVER_A_SHARDS]})
        admin(b.url, "/admin/ec/delete_shards",
              {"volume": vid, "shards": [s for s in SERVER_LOSSES
                                         if s not in SERVER_A_SHARDS]})
        ev = a.store.get_ec_volume(vid)
        lost_data = {s for s in SERVER_LOSSES if s < layout.DATA_SHARDS}
        touching = [nid for nid in expect
                    if any(s in lost_data for s, _, _ in intervals(ev, nid))]
        # a draw of the needles on a lost data shard and of the others
        # (read through B's shards alone, without a decode), for the
        # script's time (PERF §4)
        rest = [nid for nid in expect if nid not in set(touching)]
        rng = np.random.default_rng(seed + 16)
        touching = rng.choice(
            touching, size=min(len(touching), SERVER_DEGRADED_TOUCHING),
            replace=False).tolist()
        sample = sorted(touching + rng.choice(
            rest, size=min(len(rest), SERVER_DEGRADED_OTHERS),
            replace=False).tolist())
        resilience.reset_latency_trackers()
        resilience.reset_breakers()
        k0 = launches["gf_apply"]
        s0 = ev.read_stats_snapshot()
        with scoped_env(WEEDTPU_HEDGE_PCT="0"):
            ts, dt = read_needles(a.url, "degraded read", sample)
        grew = {k: v - s0[k] for k, v in ev.read_stats_snapshot().items()}
        k1_step("4 degraded", k0, len(touching))
        if grew["reconstruct_batches"] != len(touching):
            raise AssertionError(f"reconstruct batches {grew}, "
                                 f"predicted {len(touching)}")
        if grew["remote_shard_reads"] <= 0:
            raise AssertionError("no shard came from B")
        steps["4 degraded"] = {"reads": len(ts), "touching_lost":
                               len(touching), "s": dt,
                               "reads_per_s": len(ts) / dt, **server_latency(ts),
                               "read_stats": grew}
        slog(f"4 degraded: {len(ts)} needles equal at {SERVER_CLIENTS} "
             f"clients, "
             f"{len(ts) / dt:.1f} reads/s, p50 "
             f"{steps['4 degraded']['p50_s'] * 1e3:.2f} ms, max "
             f"{steps['4 degraded']['max_s'] * 1e3:.2f} ms; remote shard "
             f"reads {grew['remote_shard_reads']}, reconstruct batches "
             f"{grew['reconstruct_batches']}; K1 {k1['4 degraded']} == "
             f"needles on shards {sorted(lost_data)}")

        # 5 rebuild through A's handlers: A copies B's surviving shards
        # (/admin/ec/copy, no .ecx), rebuilds the lost ones
        # (/admin/ec/rebuild) and mounts the set; it keeps the copied
        # shards, which step 6 decodes from
        k0 = launches["gf_apply"]
        borrowed = [s for s in moved if s not in SERVER_LOSSES]
        admin(a.url, "/admin/ec/copy", {"volume": vid, "source": b.url,
                                        "shards": borrowed,
                                        "copy_ecx": False})
        t0 = time.perf_counter()
        reply = admin(a.url, "/admin/ec/rebuild", {"volume": vid})
        dt = time.perf_counter() - t0
        if sorted(reply["rebuilt"]) != list(SERVER_LOSSES):
            raise AssertionError(f"rebuilt {reply}")
        for i, h in zip(SERVER_LOSSES, sha256_many(
                [base_a + layout.to_ext(i) for i in SERVER_LOSSES])):
            if h != hashes[i]:
                raise AssertionError(f"rebuilt shard {i} differs from "
                                     f"phase 4's")
        admin(a.url, "/admin/ec/mount", {"volume": vid})
        k1_step("5 rebuild", k0, rebuild_k1)
        shard_size = os.path.getsize(base_a + layout.to_ext(0))
        steps["5 rebuild"] = {"s": dt, "read_gbps":
                              10 * shard_size / dt / 1e9}
        slog(f"5 rebuild: shards {list(SERVER_LOSSES)} sha256 == phase "
             f"4's in {dt:.3f} s ({10 * shard_size / dt / 1e9:.3f} GB/s "
             f"of survivors read); K1 {k1['5 rebuild']} == phase 6's")

        # 6 decode through A's /admin/ec/to_volume: A, holding every
        # shard since step 5, writes the .dat and .idx back; every shard
        # then unmounted and deleted on A and B
        k0 = launches["gf_apply"]
        t0 = time.perf_counter()
        admin(a.url, "/admin/ec/to_volume", {"volume": vid})
        dt = time.perf_counter() - t0
        if sha256(base_a + ".dat") != dat_hash:
            raise AssertionError("decoded .dat differs from phase 3's")
        for url in (a.url, b.url):
            admin(url, "/admin/ec/unmount", {"volume": vid})
            admin(url, "/admin/ec/delete_shards",
                  {"volume": vid, "shards": list(range(14))})
        ts, dt_read = read_needles(a.url, "decoded read", drawn)
        k1_step("6 decode", k0, 0)
        steps["6 decode"] = {"s": dt, "gbps": dat_size / dt / 1e9,
                             "reads_per_s": len(ts) / dt_read}
        slog(f"6 decode: .dat sha256 == phase 3's in {dt:.3f} s "
             f"({dat_size / dt / 1e9:.3f} GB/s); {len(ts)} needles read "
             f"back from the normal volume, {len(ts) / dt_read:.1f} "
             f"reads/s at {SERVER_CLIENTS} clients; K1 0")

        # 7 small objects on B at 16 clients; then a 001 volume on A and
        # B, every acknowledged write read back from both
        k0 = launches["gf_apply"]
        small_vid, repl_vid = vid + 1, vid + 2
        admin(b.url, "/admin/assign_volume", {"volume": small_vid})
        payload, cookies = small_objects(seed)
        fids = [str(t.FileId(small_vid, i + 1, cookies[i]))
                for i in range(SERVER_SMALL)]

        def body(i: int) -> bytes:
            return payload[i * SERVER_SMALL_SIZE:(i + 1) * SERVER_SMALL_SIZE]

        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--small-clients",
             b.url, str(small_vid), "--seed", str(seed)],
            capture_output=True, text=True, timeout=900)
        if child.returncode != 0:
            raise AssertionError(f"small-object clients failed:\n"
                                 f"{child.stderr[-3000:]}")
        small = json.loads(child.stdout.strip().splitlines()[-1])
        requests["write"] += SERVER_SMALL
        requests["read"] += SERVER_SMALL
        for i in range(SERVER_DELETES):
            st, _ = call(b.url, "/" + fids[i], method="DELETE")
            if st != 200:
                raise AssertionError(f"delete {fids[i]}: HTTP {st}")
        requests["delete"] += SERVER_DELETES
        steps["7 small"] = {"writes": SERVER_SMALL,
                            "clients": SERVER_CLIENTS, **small}
        for url in (a.url, b.url):
            admin(url, "/admin/assign_volume",
                  {"volume": repl_vid, "replication": "001"})
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st, raw = call(f"127.0.0.1:{mport}",
                           f"/dir/lookup?volumeId={repl_vid}")
            if st == 200 and len(json.loads(raw)["locations"]) == 2:
                break
            time.sleep(0.1)
        else:
            raise AssertionError("the 001 volume never showed on both")
        repl = {str(t.FileId(repl_vid, i + 1, cookies[i])): body(i)
                for i in range(SERVER_REPLICATED)}
        for f, data in repl.items():
            st, _, _ = client.request(f"http://{a.url}/{f}", method="PUT",
                                      body=data)
            if st != 201:
                raise AssertionError(f"replicated write {f}: HTTP {st}")
        # A's writes, and the fan-out writes B received
        requests["write"] += 2 * SERVER_REPLICATED
        for url in (a.url, b.url):
            for f, data in repl.items():
                if blob_get(url, f) != data:
                    raise AssertionError(f"replica of {f} on {url} "
                                         f"differs")
        k1_step("7 small", k0, 0)
        w, r = steps["7 small"]["write"], steps["7 small"]["read"]
        slog(f"7 small: {SERVER_SMALL} x {SERVER_SMALL_SIZE} B at "
             f"{SERVER_CLIENTS} clients in a process of their own: "
             f"{small['writes_per_s']:.1f} writes/s "
             f"(p50 {w['p50_s'] * 1e3:.2f} ms, p99 {w['p99_s'] * 1e3:.2f} "
             f"ms), {small['reads_per_s']:.1f} reads/s (p50 "
             f"{r['p50_s'] * 1e3:.2f} ms, p99 {r['p99_s'] * 1e3:.2f} ms); "
             f"{SERVER_REPLICATED} writes to a 001 volume read back from "
             f"both servers; K1 0")

        # 8 /metrics: both servers share this process's registry, so
        # each scrape counts both servers' blob requests
        scraped = []
        for url in (a.url, b.url):
            st, raw = call(url, "/metrics")
            if st != 200:
                raise AssertionError(f"{url}/metrics: HTTP {st}")
            got = {}
            for line in raw.decode().splitlines():
                for k in requests:
                    if line.startswith("weedtpu_volume_request_total"
                                       f'{{type="{k}"}} '):
                        got[k] = float(line.split()[-1]) - counter0[k]
            scraped.append(got)
        if scraped[0] != scraped[1] or scraped[0] != \
                {k: float(v) for k, v in requests.items()}:
            raise AssertionError(f"/metrics counted {scraped}, the "
                                 f"requests made {requests}")
        one_shot = {k: vsmod.ONE_SHOT[k] - one_shot0[k]
                    for k in one_shot0}
        steps["8 metrics"] = {"requests": dict(requests),
                              "one_shot": one_shot}
        slog(f"8 metrics: /metrics on A and B count {requests} (the "
             f"requests made); responses in one write {one_shot}")
        # beats in protobuf: the servers' framing, and the master's count
        if not all(vs._wire_pb is True for vs in servers):
            raise AssertionError("a server beat in JSON")
        out["beats"] = metrics.MASTER_RECEIVED_HEARTBEATS.labels().value - \
            beats0
        if out["beats"] <= 0:
            raise AssertionError("the master counted no heartbeat")
    finally:
        for vs in servers:
            run(vs.stop())
        if master is not None:
            run(master.stop())
        stop_loops(loops)
        client.close()
        shutil.rmtree(work, ignore_errors=True)
    out.update({"steps": steps, "k1": k1, "s": time.perf_counter() - t_phase,
                "launches": dict(launches)})
    slog(f"K1 per step {k1}; {out['beats']:.0f} beats, all protobuf; "
         f"phase wall {out['s']:.1f} s")
    return out


# phase 17's maintenance through the server.  Its topology is phase 9's
# and phase 10's, on port volume servers: the repairing node "R" holds
# shards 0-5, "a:1" (its rack) 6-8 (MSR 6-11), "c:3" (its data centre,
# another rack; MSR only) 12, "b:2" (another data centre) 9-13 (MSR
# 13-17).  The master stand-in is the helpers' planner: it posts the
# reduced rebuilds the reference master's repair would post
# (maintenance/repair.py:735), with each helper's locality class from
# the nodes' data centre and rack.
MAINT_NODES = (("R", "dc1", "r1"), ("a:1", "dc1", "r1"),
               ("c:3", "dc1", "r2"), ("b:2", "dc2", "r1"))
MAINT_FAST_MBPS = 1e6  # a scrub rate no pass can reach: unthrottled
MAINT_RATE_MBPS = 8.0  # step 2's: its volume passes in about 2.1 s (cut from 4, PERF §4)
MAINT_RATE_NEEDLES = 256  # step 2's volume: 256 x 64 KiB needles
MAINT_PROBES = 4
MAINT_SAMPLE = 16  # needles read back after each recode
MAINT_VIDS = {"scrub": 171, "rate": 172, "rs": 173, "msr": 174,
              "recode": 175, "fleet": (176, 177, 178, 179),
              "fleet_quiet": (180, 181, 182, 183)}


def phase_maintenance(vdir: str, base: str, server_src: str, expect: dict,
                      blob: bytes, hashes: list[str], aux_hashes: dict,
                      phases: dict, srcs: list[str], seed: int,
                      launches: dict, device=None) -> dict:
    """Phase 17: the volume server's maintenance routes on the card, four
    port servers in process on one loop thread behind the port's
    `MasterServer` (on the same loop; its repair loop, canary and
    aggregator loop off, WEEDTPU_REPAIR_INTERVAL=0,
    WEEDTPU_CANARY_INTERVAL=0 and WEEDTPU_AGG_INTERVAL=0, so nothing
    rebuilds, probes or scrapes between the steps), driven over loopback
    HTTP as the master's repair planner drives them: /admin/scrub (clean,
    then two bits flipped by /admin/faults, the verdicts read from the
    master's health ledger), /admin/scrub_rate, reduced rebuilds through
    /admin/ec/partial, /admin/ec/probe_read, /admin/ec/recode there and
    back, /admin/ec/fleet_convert, /metrics.  K1 and K2 per step held
    against phases 4 and 7-10; every shard, .vif and .ecx against the
    phase it mirrors."""
    import numpy as np
    from seaweedfs_tpu_torch.maintenance import scrub
    from seaweedfs_tpu_torch.server import volume_server as vsmod
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.stats import metrics
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout
    from seaweedfs_tpu_torch.topology.topology import (locality_class,
                                                        locality_name)
    from seaweedfs_tpu_torch.utils import http

    card = card_name_power()

    def mlog(msg: str) -> None:
        log(f"[maintenance] {msg} [{card}]")

    work = os.path.join(vdir, "maintenance")
    names = [n for n, _, _ in MAINT_NODES]
    dirs = {n: os.path.join(work, n.replace(":", "_")) for n in names}
    for d in dirs.values():
        os.makedirs(d)
    loops: list = []
    run = loop_thread(loops)

    master = None
    servers: dict = {}
    client = http.PooledHTTP(timeout=600.0, max_idle_per_host=16)
    requests = {"read": 0, "write": 0, "delete": 0}
    steps: dict = {}
    counts: dict = {}
    t_phase = time.perf_counter()

    def call(url: str, path: str, body=None, method=None,
             data=None) -> tuple[int, bytes]:
        hdrs = {}
        if body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        st, _, raw = client.request(
            f"http://{url}{path}",
            method=method or ("POST" if data is not None else "GET"),
            body=data, headers=hdrs)
        return st, raw

    def admin(name: str, path: str, body=None) -> dict:
        st, raw = call(servers[name].url, path, body)
        if st != 200:
            raise AssertionError(f"{name}{path}: HTTP {st} {raw[:300]!r}")
        return json.loads(raw) if raw else {}

    def step_counts(name: str, k0: dict, k1: int, k2: int = 0) -> None:
        got = {k: launches[k] - k0[k] for k in launches}
        counts[name] = got
        want = {"gf_apply": k1, "gf_apply_batch": k2}
        if got != want:
            raise AssertionError(f"phase 17 {name}: launched {got}, "
                                 f"predicted {want}")

    def fleet_parts(srv: dict, dt: float) -> str:
        """The fleet handler's own seconds (its stages' `server`) and the
        step's time outside the handler."""
        return (f"handler {srv['handler_s']:.3f} s: flush "
                f"{srv['flush_s']:.4f}, convert_volumes "
                f"{srv['convert_s']:.3f}, .ecx {srv['ecx_s']:.4f}, beat "
                f"{srv['beat_s']:.4f}; outside the handler "
                f"{dt - srv['handler_s']:.3f} s")

    def place(name: str, vid: int, src: str, shards, copy=(),
              vif_copy: bool = False) -> str:
        """Links of `src`'s shards (copies of those in `copy`) and .ecx,
        the .vif linked or copied, as volume `vid` on node `name`."""
        dst = os.path.join(dirs[name], str(vid))
        for i in shards:
            (shutil.copyfile if i in copy else os.link)(
                src + layout.to_ext(i), dst + layout.to_ext(i))
        os.link(src + ".ecx", dst + ".ecx")
        (shutil.copyfile if vif_copy else os.link)(src + ".vif",
                                                   dst + ".vif")
        return dst

    def metric(raw: bytes, family: str, label: str) -> float:
        for line in raw.decode().splitlines():
            if line.startswith(f"{family}{{{label}}} "):
                return float(line.split()[-1])
        return 0.0

    scrape = {"weedtpu_scrub_bytes_total": ('kind="ec"', 'kind="volume"'),
              "weedtpu_ec_encode_bytes_total": ('codec="fleet"',),
              "weedtpu_repair_bytes_total": ('locality="rack"',
                                             'locality="dc"',
                                             'locality="remote"')}
    scrub_bytes = {"ec": 0, "volume": 0}
    repair_bytes: dict = {}
    try:
        # the loops read their intervals at construction and at start:
        # both inside the scope (a canary probe 30 s in would add a blob
        # write, read and delete to step 7's count)
        with scoped_env(WEEDTPU_REPAIR_INTERVAL="0",
                        WEEDTPU_CANARY_INTERVAL="0",
                        WEEDTPU_AGG_INTERVAL="0"):
            master = MasterServer("127.0.0.1", free_port())
            run(master.start())
        # every server with a scrubber that passes on request only, and
        # hedging off: a hedge could add a decode to the probe's count
        with scoped_env(WEEDTPU_SCRUB_MBPS=str(MAINT_FAST_MBPS),
                        WEEDTPU_SCRUB_INTERVAL="3600",
                        WEEDTPU_HEDGE_PCT="0"):
            for name, dc, rack in MAINT_NODES:
                vs = vsmod.VolumeServer(
                    [dirs[name]], master.url, "127.0.0.1",
                    free_port(), data_center=dc, rack=rack,
                    heartbeat_interval=0.5, device=device)
                run(vs.start())
                servers[name] = vs
            r_url = servers["R"].url
            loc = {n: locality_class("dc1", "r1", dc, rack)
                   for n, dc, rack in MAINT_NODES[1:]}
            if loc != {"a:1": 1, "c:3": 2, "b:2": 3}:
                raise AssertionError(f"localities {loc}")
            mlog(f"servers {', '.join(f'{n} {servers[n].url}' for n in names)}"
                 f" on {servers['R'].device}, scrubbers at "
                 f"{servers['R'].scrubber.mbps} MB/s every "
                 f"{servers['R'].scrubber.interval} s")
            m0 = call(r_url, "/metrics")[1]
            counter0 = {k: metrics.VOLUME_REQUEST_COUNTER.labels(k).value
                        for k in requests}
            if sha256(base + ".ecx") != aux_hashes[".ecx"] or \
                    sha256(base + ".vif") != aux_hashes[".vif"]:
                raise AssertionError("phase 4's .ecx or .vif changed")
            windows = phases["scrub"]["clean"]["windows"]
            size = os.path.getsize(base + layout.to_ext(0))
            W = scrub.DEFAULT_WINDOW  # the servers': no WEEDTPU_SCRUB_WINDOW

            # 1 scrub: clean, then bits flipped in shards 5 and 11
            vid = MAINT_VIDS["scrub"]
            place("R", vid, base, range(14), copy=(5, 11))
            admin("R", "/admin/ec/mount", {"volume": vid})
            k0 = dict(launches)
            t0 = time.perf_counter()
            clean = admin("R", "/admin/scrub", {})
            dt_clean = time.perf_counter() - t0
            res = clean["volumes"][str(vid)]
            if (res["windows"], res["windows_skipped"], res["corrupt"]) != \
                    (windows, 0, []) or res["bytes"] != 14 * size:
                raise AssertionError(f"clean scrub: {res}")
            step_counts("1 scrub clean", k0, windows)
            w5, w11 = windows // 4, 3 * windows // 4
            flips = [(5, w5 * W + 123),
                     (11, w11 * W + 4567 % (size - w11 * W))]
            got = admin("R", "/admin/faults", {"faults": [
                {"action": "flip_bit", "volume": vid, "shard": s,
                 "offset": off, "bit": 4} for s, off in flips]})
            if [a["ok"] for a in got["applied"]] != [True, True]:
                raise AssertionError(f"faults: {got}")
            k0 = dict(launches)
            t0 = time.perf_counter()
            flipped = admin("R", "/admin/scrub", {})
            dt_flip = time.perf_counter() - t0
            res = flipped["volumes"][str(vid)]

            def window(w):
                return {"offset": w * W, "size": min(W, size - w * W),
                        "columns": 1}
            want = [{"shard": 5, **window(w5)}, {"shard": 11, **window(w11)}]
            if res["corrupt"] != want or res["quarantined"] != {
                    "5": [[w5 * W, window(w5)["size"]]],
                    "11": [[w11 * W, window(w11)["size"]]]}:
                raise AssertionError(f"scrub after the flips: {res}")
            step_counts("1 scrub flipped", k0, windows)
            # the report reached the master's repair planner: its health
            # ledger holds both verdicts, the volume corrupt
            st, raw = call(master.url, "/maintenance/status")
            led = json.loads(raw)["volumes"].get(str(vid), {})
            if st != 200 or led.get("state") != "corrupt" or \
                    led["corrupt"] != [dict(c, node=r_url) for c in want] \
                    or led["quarantined"] != {r_url: res["quarantined"]}:
                raise AssertionError(f"the master's ledger of {vid}: {led}")
            scrub_bytes["ec"] += clean["bytes"] + flipped["bytes"]
            steps["1 scrub"] = {"bytes": clean["bytes"], "windows": windows,
                                "clean_s": dt_clean, "flipped_s": dt_flip,
                                "gbps": clean["bytes"] / dt_clean / 1e9,
                                "found": res["corrupt"]}
            mlog(f"1 scrub: {clean['bytes']} B of shards, {windows} windows "
                 f"clean in {dt_clean:.3f} s "
                 f"({clean['bytes'] / dt_clean / 1e9:.3f} "
                 f"GB/s), K1 {windows}; shard 5 and 11 bits flipped by "
                 f"/admin/faults, found, localised and quarantined in "
                 f"{dt_flip:.3f} s, K1 {windows}; the master's health "
                 f"ledger reads the volume corrupt, both verdicts and "
                 f"quarantines in it")
            admin("R", "/admin/ec/unmount", {"volume": vid})
            for ext in [layout.to_ext(i) for i in range(14)] + [".ecx",
                                                                ".vif"]:
                os.remove(os.path.join(dirs["R"], str(vid)) + ext)

            # 2 scrub rate: a needle volume on a:1, one pass at the set rate
            vid = MAINT_VIDS["rate"]
            a_url = servers["a:1"].url
            admin("a:1", "/admin/assign_volume", {"volume": vid})
            rng = np.random.default_rng(seed + 17)
            body = rng.bytes(64 * 1024)
            for i in range(MAINT_RATE_NEEDLES):
                st, _ = call(a_url, f"/{t.FileId(vid, i + 1, 0x5EED)}",
                             method="PUT", data=body)
                if st != 201:
                    raise AssertionError(f"rate step write {i}: HTTP {st}")
            requests["write"] += MAINT_RATE_NEEDLES
            set_to = admin("a:1", "/admin/scrub_rate",
                           {"mbps": MAINT_RATE_MBPS})
            if set_to != {"mbps": MAINT_RATE_MBPS, "operator_paused": False}:
                raise AssertionError(f"scrub_rate: {set_to}")
            k0 = dict(launches)
            t0 = time.perf_counter()
            rated = admin("a:1", "/admin/scrub", {})
            dt = time.perf_counter() - t0
            admin("a:1", "/admin/scrub_rate", {"mbps": MAINT_FAST_MBPS})
            res = rated["volumes"][str(vid)]
            floor = 0.9 * rated["bytes"] / (MAINT_RATE_MBPS * 1e6)
            if res["needles"] != MAINT_RATE_NEEDLES or \
                    res["crc_mismatches"] or dt < floor:
                raise AssertionError(f"rated scrub: {dt:.3f} s against a "
                                     f"floor of {floor:.3f}: {res}")
            step_counts("2 scrub rate", k0, 0)
            scrub_bytes["volume"] += rated["bytes"]
            steps["2 scrub rate"] = {
                "bytes": rated["bytes"], "mbps": MAINT_RATE_MBPS, "s": dt,
                "floor_s": floor, "rate_mbps": rated["bytes"] / dt / 1e6}
            mlog(f"2 scrub rate: {MAINT_RATE_NEEDLES} needles, "
                 f"{rated['bytes']} B verified by CRC at {MAINT_RATE_MBPS} "
                 f"MB/s set through /admin/scrub_rate: {dt:.3f} s "
                 f"(floor {floor:.3f} s; {rated['bytes'] / dt / 1e6:.3f} "
                 f"MB/s achieved); K1 0")
            admin("a:1", "/admin/volume/delete", {"volume": vid})

            # 3 reduced repair over HTTP, RS on phase 9's topology
            vid = MAINT_VIDS["rs"]
            place("R", vid, base, (0, 1, 2, 4, 5))
            place("a:1", vid, base, (6, 7, 8))
            place("b:2", vid, base, range(9, 14))
            for n in ("R", "a:1", "b:2"):
                admin(n, "/admin/ec/mount", {"volume": vid})
            node_url = {n: servers[n].url for n in names}
            label_of = {u: n for n, u in node_url.items()}
            repairs: dict = {}

            def repair(label, vid, tag, lost, helpers, ssize, twin, d=None):
                groups = [{"node": node_url[n], "shards": [
                    s for s in span if s not in lost], "locality": loc[n]}
                    for n, span in helpers]
                body = {"volume": vid, "codec": tag, "reduced": {
                    "lost": lost, "groups": groups, "shard_size": ssize}}
                if d is not None:
                    body["reduced"]["d"] = d
                k0 = dict(launches)
                t0 = time.perf_counter()
                res = admin("R", "/admin/ec/rebuild", body)
                dt = time.perf_counter() - t0
                measured = {label_of[u]: b
                            for u, b in res["helper_bytes"].items()}
                planned = {label_of[u]: b for u, b in
                           res["predicted"]["per_node"].items()}
                if measured != planned or measured != twin["helper_bytes"] \
                        or res["rebuilt"] != lost or res["replans"]:
                    raise AssertionError(
                        f"repair {label}: measured {measured}, planned "
                        f"{planned}, the library run's "
                        f"{twin['helper_bytes']}: {res}")
                step_counts(f"3 repair {label}", k0, twin["launches"])
                for n, b in measured.items():
                    name = locality_name(loc[n])
                    repair_bytes[name] = repair_bytes.get(name, 0) + b
                repairs[label] = {"s": dt, "bytes": ssize * len(lost),
                                  "rebuilt_gbps": ssize * len(lost) / dt
                                  / 1e9, "helper_bytes": measured,
                                  "naive_remote":
                                      res["predicted"]["naive_remote"]}
                mlog(f"3 repair {label}: lost {lost} rebuilt on R in "
                     f"{dt:.3f} s ({ssize * len(lost) / dt / 1e9:.3f} GB/s), "
                     f"remote {measured} == the plan's == phase "
                     f"{'10' if tag != 'rs_10_4' else '9'}'s, naive "
                     f"{res['predicted']['naive_remote']} B; K1 "
                     f"{twin['launches']} over the helpers and R")
                return res

            runs9 = phases["repair"]
            helpers9 = (("a:1", range(6, 9)), ("b:2", range(9, 14)))
            repair("[3] d=10", vid, "rs_10_4", [3], helpers9, size,
                   runs9["a"], d=10)
            admin("R", "/admin/ec/delete_shards", {"volume": vid,
                                                   "shards": [1]})
            repair("[1, 12]", vid, "rs_10_4", [1, 12], helpers9, size,
                   runs9["c"])
            rbase = os.path.join(dirs["R"], str(vid))
            for s, h in zip((3, 1, 12), sha256_many(
                    [rbase + layout.to_ext(s) for s in (3, 1, 12)])):
                if h != hashes[s]:
                    raise AssertionError(f"repaired shard {s} differs "
                                         f"from phase 4's")
            msr = phases["codecs"]["msr_9_16"]
            mbase = msr["kept_base"]
            msize = os.path.getsize(mbase + layout.to_ext(0))
            vid = MAINT_VIDS["msr"]
            for n, span in (("R", range(1, 6)), ("a:1", range(6, 12)),
                            ("c:3", (12,)), ("b:2", range(13, 18))):
                place(n, vid, mbase, span)
                admin(n, "/admin/ec/mount", {"volume": vid})
            repair("msr [0]", vid, "msr_9_16", [0],
                   (("a:1", range(6, 12)), ("c:3", (12,)),
                    ("b:2", range(13, 18))), msize, msr["repair"]["msr [0]"])
            if sha256(os.path.join(dirs["R"], str(vid)) + ".ec00") != \
                    msr["encode"]["sha256"][0]:
                raise AssertionError("repaired MSR shard 0 differs from "
                                     "phase 10's")
            steps["3 repair"] = repairs

            # 4 probe: the canary's degraded read of the first needle on R
            vid = MAINT_VIDS["rs"]
            admin("R", "/admin/ec/mount", {"volume": vid})
            ev = servers["R"].store.get_ec_volume(vid)
            first = int(ev.ids[0])
            cookie, lo, hi = expect[first]
            probes = []
            for i in range(MAINT_PROBES):
                k0 = dict(launches)
                t0 = time.perf_counter()
                st, raw = call(r_url, f"/admin/ec/probe_read?volume={vid}")
                probes.append(time.perf_counter() - t0)
                got = json.loads(raw)
                if st != 200 or got != {"needle": f"{first:x}",
                                        "bytes": hi - lo,
                                        "skipped_shard": 0}:
                    raise AssertionError(f"probe {i}: HTTP {st} {got}")
                step_counts(f"4 probe {i + 1}", k0, 1)
            steps["4 probe"] = {"probes": MAINT_PROBES, "s": probes}
            mlog(f"4 probe: {MAINT_PROBES} reads of needle {first:x} "
                 f"({hi - lo} B) with shard 0 withheld, each decoded (K1 1 "
                 f"each: the probe's read has an LRU of its own), p50 "
                 f"{sorted(probes)[len(probes) // 2] * 1e3:.2f} ms")

            # 5 recode: rs_10_4 -> lrc_10_2_2 -> rs_10_4 on c:3
            vid = MAINT_VIDS["recode"]
            place("c:3", vid, base, range(14), vif_copy=True)
            admin("c:3", "/admin/ec/mount", {"volume": vid})
            lrc = phases["codecs"]["lrc_10_2_2"]["encode"]
            cbase = os.path.join(dirs["c:3"], str(vid))
            sample = np.random.default_rng(seed + 18).choice(
                sorted(expect), MAINT_SAMPLE, replace=False).tolist()
            recodes = {}
            for to, want, vif, k1 in (
                    ("lrc_10_2_2", lrc["sha256"], lrc["vif_sha256"],
                     lrc["launches"]),
                    ("rs_10_4", hashes, aux_hashes[".vif"],
                     phases["encode_warm"]["launches"])):
                k0 = dict(launches)
                t0 = time.perf_counter()
                got = admin("c:3", "/admin/ec/recode",
                            {"volume": vid, "codec": to})
                dt = time.perf_counter() - t0
                step_counts(f"5 recode {to}", k0, k1)
                if got["codec"] != to or got["shards"] != list(range(14)) \
                        or sha256_many([cbase + layout.to_ext(i)
                                        for i in range(14)]) != want or \
                        sha256(cbase + ".vif") != vif:
                    raise AssertionError(f"recode to {to}: {got}")
                for nid in sample:
                    c, l_, h_ = expect[nid]
                    st, raw = call(servers["c:3"].url,
                                   f"/{t.FileId(vid, nid, c)}")
                    if st != 200 or raw != blob[l_:h_]:
                        raise AssertionError(f"recoded {to}: needle {nid}")
                requests["read"] += MAINT_SAMPLE
                recodes[to] = {"s": dt, "gbps": len(blob) / dt / 1e9}
                twin = "10" if to != "rs_10_4" else "4"
                mlog(f"5 recode to {to}: {dt:.3f} s, 14 shards and the .vif "
                     f"sha256-equal to phase {twin}'s, K1 {k1}; "
                     f"{MAINT_SAMPLE} needles read back")
            steps["5 recode"] = recodes

            # 6 fleet: links of phase 7's four volumes on b:2
            fvids = MAINT_VIDS["fleet"]
            fsrc = [server_src] + [p[: -len(".dat")] for p in srcs[1:]]
            bdir = dirs["b:2"]
            for fv, src in zip(fvids, fsrc):
                for ext in (".dat", ".idx"):
                    os.link(src + ext, os.path.join(bdir, f"{fv}{ext}"))
                admin("b:2", "/admin/volume/mount", {"volume": fv})
            total = sum(os.path.getsize(p + ".dat") for p in fsrc)
            k0 = dict(launches)
            polls: list = []
            result: dict = {}

            def convert():
                result["reply"] = admin("b:2", "/admin/ec/fleet_convert",
                                        {"volumes": list(fvids)})
            th = threading.Thread(target=convert)
            t0 = time.perf_counter()
            th.start()
            while th.is_alive():
                st, raw = call(servers["b:2"].url,
                               f"/admin/ec/progress?volumeId={fvids[-1]}")
                if st == 200:
                    polls.append(json.loads(raw)["bytes_done"])
                time.sleep(0.02)
            th.join()
            dt = time.perf_counter() - t0
            rep = result.get("reply") or {}
            want_k2 = phases["fleet"]["launches"]["gf_apply_batch"]
            step_counts("6 fleet", k0, 0, want_k2)
            if rep.get("converted") != list(fvids) or rep["bytes"] != total \
                    or polls != sorted(polls):
                raise AssertionError(f"fleet: {rep}, progress {polls}")
            prog = admin("b:2", f"/admin/ec/progress?volumeId={fvids[0]}")
            if (prog["state"], prog["kind"], prog["bytes_done"]) != \
                    ("done", "fleet_convert", total):
                raise AssertionError(f"fleet progress {prog}")
            for fv, want in zip(fvids, phases["fleet"]["sha256"]):
                fb = os.path.join(bdir, str(fv))
                if sha256_many([fb + layout.to_ext(i)
                                for i in range(14)]) != want:
                    raise AssertionError(f"fleet volume {fv}: shards "
                                         f"differ from phase 7's")
            if sha256(os.path.join(bdir, f"{fvids[0]}.ecx")) != \
                    aux_hashes[".ecx"]:
                raise AssertionError("fleet .ecx of the phase-3 volume")
            for fv in fvids[1:]:  # one needle each: the .ecx is the .idx
                with open(os.path.join(bdir, f"{fv}.ecx"), "rb") as f, \
                        open(os.path.join(bdir, f"{fv}.idx"), "rb") as g:
                    if f.read() != g.read():
                        raise AssertionError(f"fleet .ecx of {fv}")
            run(servers["b:2"]._heartbeat_once())
            st, raw = call(master.url, "/dir/status")
            infos = json.loads(raw)["Topology"]["nodes"][
                servers["b:2"].url]["volume_infos"]
            frozen = {v["id"]: v["read_only"] for v in infos
                      if v["id"] in fvids}
            if frozen != {fv: True for fv in fvids}:
                raise AssertionError(f"fleet volumes' beat: {frozen}")
            for fv in fvids:
                admin("b:2", "/admin/ec/mount", {"volume": fv})
            for fv in fvids:  # the beat after the mounts
                split = master_split(client, master.url, fv)
                if split.get(servers["b:2"].url) != list(range(14)):
                    raise AssertionError(f"fleet volume {fv} beat {split}")
            srv = prog["stages"]["server"]
            steps["6 fleet"] = {"bytes": total, "s": dt,
                                "gbps": total / dt / 1e9,
                                "units": rep["units"], "k2": want_k2,
                                "wall_s": rep["wall_s"], "server": srv,
                                "polls": len(polls)}
            mlog(f"6 fleet: {total} B of 4 volumes through "
                 f"/admin/ec/fleet_convert in {dt:.3f} s "
                 f"({total / dt / 1e9:.3f} GB/s; its own wall "
                 f"{rep['wall_s']:.3f} s; {fleet_parts(srv, dt)}; "
                 f"{len(polls)} progress polls), {rep['units']} units, K2 "
                 f"{want_k2} == phase 7's, K1 0; 56 shards sha256-equal to "
                 f"phase 7's, .ecx written, read-only in the beat, the "
                 f"shard sets in the next")

            # 6b the same conversion with nothing polling: links of the
            # same volumes under other ids on b:2, the step's time beside
            # the handler's own parts
            qvids = MAINT_VIDS["fleet_quiet"]
            for fv, src in zip(qvids, fsrc):
                for ext in (".dat", ".idx"):
                    os.link(src + ext, os.path.join(bdir, f"{fv}{ext}"))
                admin("b:2", "/admin/volume/mount", {"volume": fv})
            k0 = dict(launches)
            t0 = time.perf_counter()
            rep = admin("b:2", "/admin/ec/fleet_convert",
                        {"volumes": list(qvids)})
            dt = time.perf_counter() - t0
            step_counts("6b fleet unpolled", k0, 0, want_k2)
            if rep.get("converted") != list(qvids) or rep["bytes"] != total:
                raise AssertionError(f"unpolled fleet: {rep}")
            for fv, want in zip(qvids, phases["fleet"]["sha256"]):
                fb = os.path.join(bdir, str(fv))
                if sha256_many([fb + layout.to_ext(i)
                                for i in range(14)]) != want:
                    raise AssertionError(f"unpolled fleet volume {fv}: "
                                         f"shards differ from phase 7's")
            if sha256(os.path.join(bdir, f"{qvids[0]}.ecx")) != \
                    aux_hashes[".ecx"]:
                raise AssertionError("unpolled fleet .ecx of the phase-3 "
                                     "volume")
            srv = admin("b:2", f"/admin/ec/progress?volumeId={qvids[0]}"
                        )["stages"]["server"]
            steps["6b fleet unpolled"] = {"bytes": total, "s": dt,
                                          "gbps": total / dt / 1e9,
                                          "wall_s": rep["wall_s"],
                                          "server": srv}
            mlog(f"6b fleet unpolled: the same {total} B in {dt:.3f} s "
                 f"({total / dt / 1e9:.3f} GB/s; its own wall "
                 f"{rep['wall_s']:.3f} s; {fleet_parts(srv, dt)}), K2 "
                 f"{want_k2}, K1 0; 56 shards and the .ecx sha256-equal "
                 f"to phase 7's")

            # 7 /metrics
            m1 = call(r_url, "/metrics")[1]
            delta = {f"{fam}{{{lab}}}": metric(m1, fam, lab)
                     - metric(m0, fam, lab)
                     for fam, labs in scrape.items() for lab in labs}
            want = {'weedtpu_scrub_bytes_total{kind="ec"}':
                    float(scrub_bytes["ec"]),
                    'weedtpu_scrub_bytes_total{kind="volume"}':
                    float(scrub_bytes["volume"]),
                    'weedtpu_ec_encode_bytes_total{codec="fleet"}':
                    float(2 * total)}
            for name in ("rack", "dc", "remote"):
                want[f'weedtpu_repair_bytes_total{{locality="{name}"}}'] = \
                    float(repair_bytes.get(name, 0))
            made = {k: metrics.VOLUME_REQUEST_COUNTER.labels(k).value
                    - counter0[k] for k in requests}
            if delta != want or made != {k: float(v)
                                         for k, v in requests.items()}:
                raise AssertionError(f"/metrics counted {delta} and "
                                     f"{made}; the phase made {want} and "
                                     f"{requests}")
            steps["7 metrics"] = {"counters": delta, "requests": made}
            mlog(f"7 metrics: /metrics counts {delta} and the blob "
                 f"requests made, {requests}")
    finally:
        for vs in servers.values():
            run(vs.stop())
        if master is not None:
            run(master.stop())
        stop_loops(loops)
        client.close()
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "steps": steps, "counts": counts,
           "s": time.perf_counter() - t_phase}
    mlog(f"launches per step {counts}; phase wall {out['s']:.1f} s")
    return out


# phase 18's volume admin through the server: volume copy, move and
# incremental copy, the network faults under degraded reads, unconvert,
# tiering, needles and query, and the telemetry routes.  Three port
# servers A, B, C on one loop thread behind the master stand-in, hedging
# and scrubbing as each step sets them.  Its EC steps run on links of
# phase 4's shard set under volume ids of their own, its moves on the
# phase-3 volume (links of the copy taken before phase 14 as the first
# source, so no byte of that copy changes).
ADMIN_VIDS = {"partition": 181, "unconvert": 182, "thaw": 183,
              "query": 184, "kill": 185}
ADMIN_APPENDS = 64  # needles appended on B before the incremental copy
ADMIN_APPEND_SIZE = 64 * 1024
ADMIN_SAMPLE = 200  # needles read back after the move
# step 2's reads, drawn from the needles on shards 0-3 (898 at seed 0):
# cut for the script's time (PERF §4)
ADMIN_PARTITION_READS = 256
ADMIN_HEDGED = 16  # step 3's needles per arm
ADMIN_SLOW_MS = 350  # step 3's peer_latency, phase 15's slow peer
ADMIN_DOCS = 512  # step 6's JSON documents
ADMIN_PROFILE_HZ = "49"  # the continuous profiler of this phase only


def crc32(path: str) -> int:
    import zlib
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(8 * MIB), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


def sha256_crc32(path: str) -> tuple[str, int]:
    """The sha256 and the zlib CRC32 of a file, side by side on two
    threads (both drop the GIL on large buffers)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as ex:
        crc = ex.submit(crc32, path)
        return sha256(path), crc.result()


def phase_admin(vdir: str, base: str, server_src: str, expect: dict,
                blob: bytes, dat_hash: str, phases: dict, srcs: list[str],
                seed: int, launches: dict, device=None) -> dict:
    """Phase 18: the rest of the volume server on the card, three port
    servers in process on one loop thread behind the port's master
    (single, no raft, on the same loop; its vacuum scan, every minute,
    does not come round in the phase's ~25 s),
    driven over loopback HTTP as the reference master, autopilot and
    shell drive them: (1) /admin/volume/move of the 1 GiB volume A -> B,
    an incremental /admin/volume/copy of needles appended on B, a move
    killed mid-transfer and a second one; (2) a partition of B under
    degraded GETs from A; (3) a slow, then a failing B under hedged
    GETs; (4) /admin/volume/unconvert of a shard set missing four shards,
    and a thaw-only one after /admin/ec/fleet_convert; (5) tier_move and
    tier_download; (6) /admin/volume/needles and /admin/query; (7)
    /debug/pprof, /perf, /heat, /debug/traces.  K1 and K2 per step held
    against their predictions, every byte against phases 3, 4 and 7."""
    import numpy as np
    from seaweedfs_tpu_torch.maintenance import faults
    from seaweedfs_tpu_torch.ops import fleet_convert
    from seaweedfs_tpu_torch.server import volume_server as vsmod
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.stats import heat, metrics, profile, trace
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout
    from seaweedfs_tpu_torch.utils import http, resilience

    card = card_name_power()

    def alog(msg: str) -> None:
        log(f"[admin] {msg} [{card}]")

    work = os.path.join(vdir, "admin")
    dirs = {n: os.path.join(work, n) for n in ("a", "b", "c")}
    for d in dirs.values():
        os.makedirs(d)
    vid = int(os.path.basename(server_src))
    loops: list = []
    run = loop_thread(loops, 900)

    master = None
    servers: dict = {}
    client = http.PooledHTTP(timeout=900.0, max_idle_per_host=32)
    steps: dict = {}
    counts: dict = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 18)

    def call(name: str, path: str, body=None, method=None, data=None,
             headers=None) -> tuple[int, bytes]:
        hdrs = dict(headers or {})
        if body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        st, _, raw = client.request(
            f"http://{servers[name].url}{path}",
            method=method or ("POST" if data is not None else "GET"),
            body=data, headers=hdrs)
        return st, raw

    def admin(name: str, path: str, body=None, headers=None) -> dict:
        st, raw = call(name, path, body, headers=headers)
        if st != 200:
            raise AssertionError(f"{name}{path}: HTTP {st} {raw[:300]!r}")
        return json.loads(raw) if raw else {}

    def step_counts(name: str, k0: dict, k1: int, k2: int = 0) -> None:
        got = {k: launches[k] - k0[k] for k in launches}
        counts[name] = got
        want = {"gf_apply": k1, "gf_apply_batch": k2}
        if got != want:
            raise AssertionError(f"phase 18 {name}: launched {got}, "
                                 f"predicted {want}")

    def start(name: str) -> None:
        vs = vsmod.VolumeServer([dirs[name]], master.url,
                                "127.0.0.1", free_port(),
                                heartbeat_interval=0.5, device=device)
        with scoped_env(WEEDTPU_SCRUB_MBPS="0",
                        WEEDTPU_PROFILE_HZ=ADMIN_PROFILE_HZ):
            run(vs.start())
        servers[name] = vs

    def fid(v: int, nid: int) -> str:
        return str(t.FileId(v, nid, expect[nid][0]))

    def read_back(name: str, v: int, nids, label: str) -> float:
        """GET each needle of `nids` (volume `v`) from `name`, byte-equal;
        returns the seconds."""
        t0 = time.perf_counter()
        for nid in nids:
            cookie, lo, hi = expect[nid]
            st, raw = call(name, "/" + fid(v, nid))
            if st != 200 or raw != blob[lo:hi]:
                raise AssertionError(f"{label}: needle {nid} of {v} on "
                                     f"{name} differs (HTTP {st})")
        return time.perf_counter() - t0

    def topo_node(name: str) -> dict:
        """`name`'s entry in the master's /dir/status."""
        st, raw = client.request(f"http://{master.url}/dir/status")[::2]
        if st != 200:
            raise AssertionError(f"/dir/status: HTTP {st}")
        return json.loads(raw)["Topology"]["nodes"][servers[name].url]

    def in_beat(name: str, v: int) -> dict | None:
        return next((x for x in topo_node(name)["volume_infos"]
                     if x["id"] == v), None)

    def until(pred, what: str) -> None:
        """Poll the master's view until `pred()` (the next beat)."""
        deadline = time.monotonic() + 10
        while not pred():
            if time.monotonic() > deadline:
                raise AssertionError(what)
            time.sleep(0.05)

    def place_ec(name: str, v: int, shards) -> str:
        """Links of phase 4's shards `shards`, .ecx and .vif as volume
        `v` on `name`, mounted."""
        dst = os.path.join(dirs[name], str(v))
        for i in shards:
            os.link(base + layout.to_ext(i), dst + layout.to_ext(i))
        for ext in (".ecx", ".vif"):
            os.link(base + ext, dst + ext)
        admin(name, "/admin/ec/mount", {"volume": v})
        return dst

    sample = sorted(rng.choice(sorted(expect), ADMIN_SAMPLE,
                               replace=False).tolist())
    dat_size = os.path.getsize(server_src + ".dat")
    try:
        # no canary and no repair loop: a probe would launch K1, and the
        # planner would rebuild the degraded shard sets the steps mount,
        # at times no step predicts
        with scoped_env(WEEDTPU_CANARY_INTERVAL="0",
                        WEEDTPU_REPAIR_INTERVAL="0"):
            master = MasterServer("127.0.0.1", free_port())
            run(master.start())
        for name in ("a", "b", "c"):
            start(name)
        if profile.global_profiler() is None:
            raise AssertionError("WEEDTPU_PROFILE_HZ started no profiler")
        alog(f"servers A {servers['a'].url}, B {servers['b'].url}, C "
             f"{servers['c'].url} on {servers['a'].device}; the "
             f"continuous profiler at {ADMIN_PROFILE_HZ} Hz")

        # 1a move A -> B, its request sampled so /debug/traces holds it
        k0 = dict(launches)
        for ext in (".dat", ".idx"):
            os.link(server_src + ext, os.path.join(dirs["a"], f"{vid}{ext}"))
        admin("a", "/admin/volume/mount", {"volume": vid})
        tid = trace._new_trace_id()
        t0 = time.perf_counter()
        reply = admin("a", "/admin/volume/move",
                      {"volume": vid, "target": servers["b"].url},
                      headers={trace.TRACE_HEADER:
                               f"{tid}-{trace._new_span_id()}-1"})
        dt_move = time.perf_counter() - t0
        b_dat = os.path.join(dirs["b"], f"{vid}.dat")
        b_hash, b_crc = sha256_crc32(b_dat)
        if b_hash != dat_hash or reply["crc"] != b_crc:
            raise AssertionError(f"moved .dat: sha256 {b_hash} (phase 3's "
                                 f"{dat_hash}), CRC {b_crc} (the move's "
                                 f"{reply['crc']})")
        if servers["a"].store.get_volume(vid) is not None or \
                os.path.exists(os.path.join(dirs["a"], f"{vid}.dat")):
            raise AssertionError("A's copy was not retired")
        until(lambda: in_beat("a", vid) is None and
              not (in_beat("b", vid) or {}).get("read_only", True),
              "the master does not show the move")
        dt_read = read_back("b", vid, sample, "moved read")
        step_counts("1a move", k0, 0)
        steps["1a move"] = {"bytes": dat_size, "s": dt_move,
                            "gbps": dat_size / dt_move / 1e9,
                            "crc": reply["crc"],
                            "reads_per_s": len(sample) / dt_read}
        alog(f"1a move: {dat_size} B A -> B through /admin/volume/move in "
             f"{dt_move:.3f} s ({dat_size / dt_move / 1e9:.3f} GB/s, "
             f"staged copy, CRC {reply['crc']} on both sides, finalize); "
             f"B's .dat sha256 == phase 3's, A's retired, the master shows "
             f"it; {len(sample)} needles from B; K1 0, K2 0")

        # 1b append on B, catch A's replica (a file copy of phase 3's
        # volume) up incrementally
        k0 = dict(launches)
        for ext in (".dat", ".idx"):
            shutil.copyfile(server_src + ext,
                            os.path.join(dirs["a"], f"{vid}{ext}"))
        admin("a", "/admin/volume/mount", {"volume": vid})
        size0 = os.path.getsize(b_dat)
        appended: dict = {}
        top = max(expect) + 1
        for i in range(ADMIN_APPENDS):
            key = t.FileId(vid, top + i, 0x1234ABCD)
            data = rng.bytes(ADMIN_APPEND_SIZE)
            st, raw = call("b", f"/{key}", method="PUT", data=data)
            if st != 201:
                raise AssertionError(f"append {key}: HTTP {st}")
            appended[str(key)] = data
        grown = os.path.getsize(b_dat) - size0
        t0 = time.perf_counter()
        reply = admin("a", "/admin/volume/copy",
                      {"volume": vid, "source": servers["b"].url})
        dt = time.perf_counter() - t0
        if reply != {"incremental": True, "appended_bytes": grown}:
            raise AssertionError(f"incremental copy {reply}, B grew "
                                 f"{grown} B")
        for key, data in appended.items():
            st, raw = call("a", "/" + key)
            if st != 200 or raw != data:
                raise AssertionError(f"appended {key} on A differs")
        # the heads are phase 3's on both sides (1a's sha256 and the
        # file copy); the tails must match too
        with open(os.path.join(dirs["a"], f"{vid}.dat"), "rb") as fa, \
                open(b_dat, "rb") as fb:
            fa.seek(size0)
            fb.seek(size0)
            if fa.read() != fb.read() or fa.tell() != fb.tell():
                raise AssertionError("A's caught-up tail differs from B's")
        step_counts("1b incremental", k0, 0)
        steps["1b incremental"] = {"appended_bytes": grown, "s": dt}
        alog(f"1b incremental: {ADMIN_APPENDS} x {ADMIN_APPEND_SIZE} B "
             f"appended on B ({grown} B of .dat), A's replica caught up "
             f"by /admin/volume/copy in {dt:.3f} s, appended_bytes == "
             f"{grown}; A's tail == B's; K1 0")

        # 1c the source's pulls stalled, the target stopped mid-transfer;
        # then C again, empty, and a second move.  The volume: links of
        # phase 7's 100 MiB one-needle volume on B (cut from the 1 GiB
        # one for the script's time, PERF §4)
        k0 = dict(launches)
        kv = ADMIN_VIDS["kill"]
        ksrc = srcs[2][: -len(".dat")]
        for ext in (".dat", ".idx"):
            os.link(ksrc + ext, os.path.join(dirs["b"], f"{kv}{ext}"))
        admin("b", "/admin/volume/mount", {"volume": kv})
        kfid = f"/{t.FileId(kv, 1, 0x1234ABCD)}"
        st, kdata = call("b", kfid)
        k_hash, k_crc = sha256_crc32(ksrc + ".dat")
        if st != 200 or not kdata:
            raise AssertionError(f"GET {kfid} from B: HTTP {st}")
        admin("b", "/admin/faults", {"faults": [
            {"action": "delay_file_pull", "ms": 1500}]})
        result: dict = {}

        def doomed():
            result["st"] = call("b", "/admin/volume/move",
                                {"volume": kv,
                                 "target": servers["c"].url})
        th = threading.Thread(target=doomed)
        th.start()
        time.sleep(0.5)
        dead = servers.pop("c")
        run(dead.stop())
        th.join(120)
        if result.get("st", (0,))[0] != 500:
            raise AssertionError(f"the killed move answered {result}")
        admin("b", "/admin/faults", {"faults": [
            {"action": "delay_file_pull", "ms": 0}]})
        v = servers["b"].store.get_volume(kv)
        if v is None or v.read_only:
            raise AssertionError("B's volume is not writable after the "
                                 "killed move")
        if call("b", kfid) != (200, kdata):
            raise AssertionError("B's read after the killed move differs")
        leftovers = sorted(os.listdir(dirs["c"]))
        start("c")
        if os.listdir(dirs["c"]):
            raise AssertionError(f"C's boot left {os.listdir(dirs['c'])}")
        t0 = time.perf_counter()
        reply = admin("b", "/admin/volume/move",
                      {"volume": kv, "target": servers["c"].url})
        dt = time.perf_counter() - t0
        c_dat = os.path.join(dirs["c"], f"{kv}.dat")
        if sha256_crc32(c_dat) != (k_hash, k_crc) or reply["crc"] != k_crc:
            raise AssertionError("the second move's .dat differs")
        if call("c", kfid) != (200, kdata):
            raise AssertionError("C's read after the second move differs")
        step_counts("1c kill", k0, 0)
        size1 = os.path.getsize(c_dat)
        steps["1c kill"] = {"leftovers_at_kill": leftovers, "s": dt,
                            "gbps": size1 / dt / 1e9}
        alog(f"1c kill: a move of phase 7's {size1} B volume B -> C "
             f"answered 500 when C stopped mid-transfer (C left "
             f"{leftovers}); B served its needle byte-equal and stayed "
             f"writable; C's boot left nothing; the second move in "
             f"{dt:.3f} s ({size1 / dt / 1e9:.3f} GB/s), sha256 and CRC == "
             f"the source's; K1 0")

        # 2 partition: A holds 4-13, B 0-3 (phase 15's layout); the volume
        # role cut from B; every needle on 0-3 read from A, hedging off,
        # one reconstruct each; /debug/pprof sampled meanwhile
        pv = ADMIN_VIDS["partition"]
        place_ec("a", pv, range(4, 14))
        place_ec("b", pv, range(4))
        ev = servers["a"].store.get_ec_volume(pv)
        on_b = [nid for nid in expect
                if any(s < 4 for s, _, _ in intervals(ev, nid))]
        touching = sorted(rng.choice(
            on_b, min(ADMIN_PARTITION_READS, len(on_b)),
            replace=False).tolist())
        resilience.reset_latency_trackers()
        resilience.reset_breakers()
        heat.reset()  # step 7's /heat ranks from here
        k0 = dict(launches)
        s0 = ev.read_stats_snapshot()
        admin("a", "/admin/faults", {"faults": [
            {"action": "partition", "a": "volume",
             "b": servers["b"].url}]})
        pprof: dict = {}

        def sample_stacks():
            pprof["st"] = call("a", "/debug/pprof?seconds=1&hz=97")
        prof_th = threading.Thread(target=sample_stacks)
        errors: list = []

        def reader(c: int) -> None:
            try:
                for nid in touching[c::SERVER_CLIENTS]:
                    cookie, lo, hi = expect[nid]
                    st, raw = call("a", "/" + fid(pv, nid))
                    if st != 200 or raw != blob[lo:hi]:
                        raise AssertionError(f"partitioned read of {nid} "
                                             f"differs (HTTP {st})")
            except Exception as e:  # surfaced after the join
                errors.append(e)
        threads = [threading.Thread(target=reader, args=(c,))
                   for c in range(SERVER_CLIENTS)]
        with scoped_env(WEEDTPU_HEDGE_PCT="0"):
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            prof_th.start()
            for th in threads:
                th.join()
            dt = time.perf_counter() - t0
        prof_th.join()
        if errors:
            raise errors[0]
        grew = {k: x - s0[k] for k, x in ev.read_stats_snapshot().items()}
        admin("a", "/admin/faults", {"faults": [{"action": "clear_net"}]})
        if faults.NET_ACTIVE:
            raise AssertionError("clear_net left a fault armed")
        step_counts("2 partition", k0, len(touching))
        if grew["reconstruct_batches"] != len(touching) or \
                grew["remote_shard_reads"] != 0:
            raise AssertionError(f"partitioned reads grew {grew}, "
                                 f"predicted {len(touching)} reconstructs "
                                 f"and no remote read")
        st, prof = pprof["st"]
        frames = [line for line in prof.decode().splitlines()
                  if "ec_volume." in line]
        if st != 200 or not frames:
            raise AssertionError("/debug/pprof during the partitioned "
                                 "reads shows no ec_volume frame")
        steps["2 partition"] = {"reads": len(touching), "on_b": len(on_b),
                                "s": dt,
                                "reads_per_s": len(touching) / dt,
                                "read_stats": grew,
                                "pprof_ec_volume_stacks": len(frames)}
        alog(f"2 partition: volume <-> B armed through A's /admin/faults; "
             f"{len(touching)} of the {len(on_b)} needles on shards 0-3 "
             f"equal from A at "
             f"{SERVER_CLIENTS} clients, {len(touching) / dt:.1f} reads/s "
             f"({dt:.3f} s); reconstruct batches {grew['reconstruct_batches']}"
             f", remote shard reads 0; K1 {counts['2 partition']['gf_apply']}"
             f" == the needles read; /debug/pprof?seconds=1 meanwhile: "
             f"{len(frames)} stacks through ec_volume; clear_net")

        # 3 a slow, then a failing B, hedging on; the LRU emptied first
        def empty_lru():
            with ev._recon_lock:
                ev._recon_cache.clear()
                ev._recon_cache_bytes = 0

        def hedges() -> dict:
            return {o: int(metrics.HEDGE_TOTAL.labels(o).value)
                    for o in ("fired", "hedge_won", "primary_rescued")}

        picks = rng.choice(on_b, 2 * ADMIN_HEDGED, replace=False).tolist()
        arms = {}
        for arm, fault in (
                ("slow", {"action": "peer_latency",
                          "dst": servers["b"].url, "ms": ADMIN_SLOW_MS}),
                ("error", {"action": "peer_error",
                           "dst": servers["b"].url, "pct": 100})):
            nids = sorted(picks[:ADMIN_HEDGED] if arm == "slow"
                          else picks[ADMIN_HEDGED:])
            empty_lru()
            resilience.reset_latency_trackers()
            resilience.reset_breakers()
            admin("a", "/admin/faults", {"faults": [fault]})
            k0, h0 = dict(launches), hedges()
            s0 = ev.read_stats_snapshot()
            ts = []
            with scoped_env(WEEDTPU_HEDGE_PCT="99",
                            WEEDTPU_HEDGE_MAX_MS="100"):
                for nid in nids:
                    t0 = time.perf_counter()
                    read_back("a", pv, [nid], f"{arm} peer")
                    ts.append(time.perf_counter() - t0)
            if arm == "slow":
                # the abandoned primaries sleep out the latency
                time.sleep(ADMIN_SLOW_MS / 1000 + 0.2)
            admin("a", "/admin/faults", {"faults": [
                {"action": "clear_net"}]})
            hg = {k: x - h0[k] for k, x in hedges().items()}
            grew = {k: x - s0[k] for k, x in ev.read_stats_snapshot().items()}
            step_counts(f"3 {arm}", k0, ADMIN_HEDGED)
            want = {"fired": ADMIN_HEDGED, "hedge_won": ADMIN_HEDGED,
                    "primary_rescued": 0} if arm == "slow" else \
                {"fired": 0, "hedge_won": 0, "primary_rescued": 0}
            if hg != want or grew["reconstruct_batches"] != ADMIN_HEDGED:
                raise AssertionError(f"3 {arm}: hedges {hg} (predicted "
                                     f"{want}), read stats {grew}")
            br = resilience.breakers_snapshot().get(servers["b"].url, {})
            if arm == "error" and br.get("state") != "open":
                raise AssertionError(f"B's breaker {br}: not open")
            arms[arm] = {"p50_s": statistics.median(ts), "max_s": max(ts),
                         "hedges": hg, "breaker": br.get("state")}
            alog(f"3 {arm}: {fault['action']} toward B, {ADMIN_HEDGED} "
                 f"needles on 0-3 equal from A, hedging on; p50 "
                 f"{statistics.median(ts) * 1e3:.2f} ms, max "
                 f"{max(ts) * 1e3:.2f} ms; hedges {hg}; B's breaker "
                 f"{br.get('state')}; K1 {ADMIN_HEDGED}")
        steps["3 hedged"] = arms
        resilience.reset_breakers()

        # 4 unconvert: phase 4's shard set less 0/3/10/12 on A, decoded
        # back to a writable volume
        uv = ADMIN_VIDS["unconvert"]
        ubase = place_ec("a", uv, [i for i in range(14)
                                   if i not in SERVER_LOSSES])
        k0 = dict(launches)
        t_unconvert = time.time()
        t0 = time.perf_counter()
        reply = admin("a", "/admin/volume/unconvert", {"volume": uv})
        dt = time.perf_counter() - t0
        step_counts("4 unconvert", k0, phases["rebuild_warm"]["launches"])
        if not reply["decoded"] or \
                reply["shards_retired"] != list(range(14)):
            raise AssertionError(f"unconvert {reply}")
        if sha256(ubase + ".dat") != dat_hash:
            raise AssertionError("unconverted .dat differs from phase 3's")
        left = [p for p in os.listdir(dirs["a"])
                if p.startswith(f"{uv}.")]
        if sorted(left) != [f"{uv}.dat", f"{uv}.idx"]:
            raise AssertionError(f"unconvert left {left}")
        until(lambda: not (in_beat("a", uv) or {}).get("read_only", True)
              and not topo_node("a")["ec_shards"].get(str(uv)),
              "the master does not show the thawed volume")
        read_back("a", uv, sample[::4], "unconverted read")
        steps["4 unconvert"] = {"s": dt, "gbps": dat_size / dt / 1e9}
        alog(f"4 unconvert: shards {list(SERVER_LOSSES)} rebuilt and the "
             f"1 GiB volume decoded in {dt:.3f} s ({dat_size / dt / 1e9:.3f}"
             f" GB/s of .dat); .dat sha256 == phase 3's; shard set, .ecx "
             f"and .vif gone; writable in the master's view; K1 "
             f"{counts['4 unconvert']['gf_apply']} == phase 6's")

        # 4b the thaw-only promote: a one-needle volume of phase 7 through
        # /admin/ec/fleet_convert, then unconvert: no decode, no launch
        tv = ADMIN_VIDS["thaw"]
        src = srcs[-1][: -len(".dat")]
        for ext in (".dat", ".idx"):
            os.link(src + ext, os.path.join(dirs["a"], f"{tv}{ext}"))
        admin("a", "/admin/volume/mount", {"volume": tv})
        units = predict_units(os.path.getsize(src + ".dat"),
                              layout.LARGE_BLOCK_SIZE,
                              layout.SMALL_BLOCK_SIZE)
        k0 = dict(launches)
        admin("a", "/admin/ec/fleet_convert", {"volumes": [tv]})
        admin("a", "/admin/ec/mount", {"volume": tv})
        step_counts("4b fleet", k0, 0,
                    -(-units // fleet_convert.UNIT_BATCH))
        k0 = dict(launches)
        reply = admin("a", "/admin/volume/unconvert", {"volume": tv})
        step_counts("4b thaw", k0, 0)
        if reply["decoded"] or reply["shards_retired"] != list(range(14)) \
                or servers["a"].store.get_volume(tv).read_only:
            raise AssertionError(f"thaw-only unconvert {reply}")
        alog(f"4b thaw: /admin/ec/fleet_convert of a one-needle volume "
             f"(K2 {counts['4b fleet']['gf_apply_batch']} for {units} "
             f"unit), then /admin/volume/unconvert: decoded False, "
             f"thawed, 14 shards retired; K1 0, K2 0")

        # 5 tiering: the unconverted volume to a local-directory remote
        # and back through the server
        k0 = dict(launches)
        remote = os.path.join(work, "tier")
        t0 = time.perf_counter()
        reply = admin("a", "/admin/volume/tier_move",
                      {"volume": uv, "kind": "local",
                       "options": {"directory": remote}})
        dt_out = time.perf_counter() - t0
        if reply != {"backend": "remote"} or \
                os.path.exists(ubase + ".dat"):
            raise AssertionError(f"tier_move {reply}")
        dt_remote = read_back("a", uv, sample[::4], "tiered read")
        t0 = time.perf_counter()
        reply = admin("a", "/admin/volume/tier_download",
                      {"volume": uv, "delete_remote": True})
        dt_in = time.perf_counter() - t0
        if reply != {"backend": "disk"} or \
                sha256(ubase + ".dat") != dat_hash:
            raise AssertionError(f"tier_download {reply}")
        if any(files for _, _, files in os.walk(remote)):
            raise AssertionError("delete_remote left the remote copy")
        read_back("a", uv, sample[::4], "downloaded read")
        # writable after the round trip (the unconvert's thaw held)
        extra = t.FileId(uv, top, 0x1234ABCD)
        st, _ = call("a", f"/{extra}", method="PUT", data=b"thawed")
        if st != 201:
            raise AssertionError(f"write after the tier hop: HTTP {st}")
        step_counts("5 tier", k0, 0)
        steps["5 tier"] = {"out_gbps": dat_size / dt_out / 1e9,
                           "in_gbps": dat_size / dt_in / 1e9,
                           "remote_reads_per_s": len(sample[::4]) / dt_remote}
        alog(f"5 tier: tier_move {dat_size / dt_out / 1e9:.3f} GB/s, "
             f"{len(sample[::4])} needles through the remote at "
             f"{len(sample[::4]) / dt_remote:.1f} reads/s, tier_download "
             f"(delete_remote) {dat_size / dt_in / 1e9:.3f} GB/s, .dat "
             f"sha256 == phase 3's, writable; K1 0")

        # 6 needles and query
        k0 = dict(launches)
        reply = admin("a", f"/admin/volume/needles?volume={uv}")
        live = sorted(nid for nid, (_, size) in
                      servers["a"].store.get_volume(uv).nm.items()
                      if size >= 0)
        if sorted(reply["needles"]) != live or \
                live != sorted(list(expect) + [top]):
            raise AssertionError("/admin/volume/needles differs from the "
                                 "needle map")
        qv = ADMIN_VIDS["query"]
        admin("a", "/admin/assign_volume", {"volume": qv})
        docs: dict = {}
        for i in range(1, ADMIN_DOCS + 1):
            doc = {"name": f"user{i}", "age": int(rng.integers(18, 90)),
                   "city": ["oslo", "bergen", "tromso"][i % 3]} \
                if i % 7 else [i]
            key = t.FileId(qv, i, 0x1234ABCD)
            st, _ = call("a", f"/{key}", method="PUT",
                         data=json.dumps(doc).encode())
            if st != 201:
                raise AssertionError(f"document {key}: HTTP {st}")
            docs[i] = doc
        docs[3] = {"name": "user3", "age": 99, "city": "oslo"}
        call("a", f"/{t.FileId(qv, 3, 0x1234ABCD)}", method="PUT",
             data=json.dumps(docs[3]).encode())
        call("a", f"/{t.FileId(qv, 5, 0x1234ABCD)}", method="DELETE")
        del docs[5]
        order = sorted(docs, key=lambda i: (i == 3, i))  # 3 written last
        flt = {"field": "age", "op": ">=", "value": 50}
        want = [{"name": d["name"], "age": d["age"]}
                for d in (docs[i] for i in order)
                if isinstance(d, dict) and d["age"] >= 50]
        t0 = time.perf_counter()
        st, raw = call("a", "/admin/query",
                       {"volume": qv, "filter": flt,
                        "projections": ["name", "age"]})
        dt = time.perf_counter() - t0
        rows = [json.loads(line) for line in raw.splitlines()]
        if st != 200 or rows != want:
            raise AssertionError(f"/admin/query: {len(rows)} rows, plain "
                                 f"Python selects {len(want)}")
        step_counts("6 needles/query", k0, 0)
        steps["6 needles/query"] = {"needles": len(live), "rows": len(rows),
                                    "query_s": dt}
        alog(f"6 needles/query: /admin/volume/needles lists the "
             f"{len(live)} ids of the needle map; /admin/query over "
             f"{ADMIN_DOCS} documents (one rewritten, one deleted, every "
             f"seventh not an object): {len(rows)} rows == plain Python's, "
             f"{dt * 1e3:.2f} ms; K1 0")

        # 7 the telemetry routes
        perf = admin("a", "/perf")
        rebuilds = [j for j in perf["jobs"] if j["kind"] == "ec_rebuild"
                    and j["started"] >= t_unconvert - 1]
        if not rebuilds:
            raise AssertionError("/perf lists no rebuild of the unconvert")
        hot = admin("a", "/heat")["dims"]["volume"]["entries"]
        if hot[0][0] != str(pv):
            raise AssertionError(f"/heat ranks {hot[:3]}, not volume {pv}")
        spans = [s for tr in admin(
            "a", f"/debug/traces?tid={tid}&pin=1")["traces"]
            for s in tr["spans"]]
        if not any(s["name"] == "volume.move" for s in spans):
            raise AssertionError(f"/debug/traces of the move holds "
                                 f"{[s['name'] for s in spans]}")
        st, raw = call("a", "/debug/pprof?format=json")
        cont = json.loads(raw)
        if st != 200 or cont["samples"] <= 0:
            raise AssertionError("the continuous profiler holds no sample")
        if call("a", "/debug/pipeline")[0] != 200 or \
                call("a", "/debug/requests")[0] != 200:
            raise AssertionError("a /debug route failed")
        steps["7 telemetry"] = {"rebuild_jobs": len(rebuilds),
                                "hot": hot[0][:2], "move_spans": len(spans),
                                "profiler_samples": cont["samples"]}
        alog(f"7 telemetry: /perf lists the unconvert's rebuild (bottleneck "
             f"{rebuilds[0].get('bottleneck')}); /heat ranks volume "
             f"{hot[0][0]} first ({hot[0][1]:.1f}); /debug/traces holds "
             f"the move's {len(spans)} spans on A, volume.move among them; "
             f"the continuous profiler {cont['samples']} samples")
    finally:
        faults.clear_net()
        resilience.reset_breakers()
        for vs in servers.values():
            run(vs.stop())
        profile.shutdown()
        if master is not None:
            run(master.stop())
        stop_loops(loops)
        client.close()
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "steps": steps, "counts": counts,
           "s": time.perf_counter() - t_phase}
    alog(f"launches per step {counts}; phase wall {out['s']:.1f} s")
    return out


# phase 19's mesh: positions on the one card of this host (the mesh's
# positions may repeat a device; a mesh over distinct cards needs a host
# with more than one)
MESH_FLEET_POSITIONS = 4  # step 4's unit mesh
MESH_PLACE = ((2, 2), (3, 2))  # step 5's (vol, col) meshes
MESH_LOSSES = (2, 12)  # step 5's column-split rebuild, of volume 0


def phase_mesh(vdir: str, server_src: str, hashes: list[str],
               aux_hashes: dict, phases: dict, srcs: list[str],
               launches: dict, device=None) -> dict:
    """Phase 19: the multi-device mesh (seaweedfs_tpu_torch/parallel/) on
    the card, its positions repeating the card where a step names
    several.  (1) WEEDTPU_EC_CODEC=mesh on a one-position mesh:
    write_ec_files + write_sorted_ecx of links of the phase-3 volume
    (the copy taken before phase 14), from no shard set, shards, .ecx and
    .vif sha256 == phase 4's, K1 == phase 4's; (2) phase 5's losses
    rebuilt under mesh, sha256-equal, K1 == phase 6's; (3)
    WEEDTPU_CONVERT_CODEC=mesh: links of phase 7's four volumes on a
    one-position mesh, sha256 == phase 7's, K2 == phase 7's; (4) the same
    fleet on 4 positions of the card, K2 one per unit (a unit per
    position per batch); (5) encode_batch_place of 4 and 6 stripes
    [10, 1 MiB] of the .dat (its first small-block rows) on (2, 2) and
    (3, 2) meshes: every position's block byte-equal to the rows of
    step 1's shard files it must hold, pad rows zero, one K2 launch per
    position; the column-split reconstruct of shards 2 and 12 of volume 0
    equal to their files, one K1 launch per column position; (6)
    dryrun_multichip(8) on 8 positions of the card.  K1 and K2 per step
    against the prediction the layout and the positions make.  `device`
    (None: the card, every card for steps 1 and 3) is for a rehearsal on
    the CPU."""
    import numpy as np
    from seaweedfs_tpu_torch.models import rs
    from seaweedfs_tpu_torch.ops import fleet_convert
    from seaweedfs_tpu_torch.parallel import dryrun
    from seaweedfs_tpu_torch.parallel import mesh as pmesh
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout

    card = card_name_power()
    pos = device or "cuda:0"  # each position of steps 4-6

    def mlog(msg: str) -> None:
        log(f"[mesh] {msg} [{card}]")

    t_phase = time.perf_counter()
    work = os.path.join(vdir, "mesh")
    os.makedirs(work)
    steps: dict = {}

    def step(name: str, k0: dict, k1: int, k2: int, dt: float,
             **rec) -> dict:
        got = {k: launches[k] - k0[k] for k in launches}
        want = {"gf_apply": k1, "gf_apply_batch": k2}
        if got != want:
            raise AssertionError(f"mesh {name}: launched {got}, predicted "
                                 f"{want}")
        steps[name] = {"s": dt, "launches": got, **rec}
        return got

    # 1 the mesh EC codec on one position, from no shard set
    base = os.path.join(work, os.path.basename(server_src))
    for ext in (".dat", ".idx"):
        os.link(server_src + ext, base + ext)
    dat_size = os.path.getsize(base + ".dat")
    shard = [base + layout.to_ext(i) for i in range(14)]
    enc_k1 = phases["encode_warm"]["launches"]
    k0 = dict(launches)
    with scoped_env(WEEDTPU_EC_CODEC="mesh"):
        codec = ec_files._get_codec(device)
        if not isinstance(codec, pmesh.ShardedRSEncoder) or \
                codec.mesh.shape != {"data": 1}:
            raise AssertionError(f"WEEDTPU_EC_CODEC=mesh built {codec!r}")
        t0 = time.perf_counter()
        ec_files.write_ec_files(base, device=device)
        ec_files.write_sorted_ecx(base + ".idx")
        dt = time.perf_counter() - t0
    got = sha256_many(shard + [base + ".ecx", base + ".vif"])
    if got != hashes + [aux_hashes[".ecx"], aux_hashes[".vif"]]:
        raise AssertionError("mesh encode: shards, .ecx or .vif differ from "
                             "phase 4's")
    step("1 encode", k0, enc_k1, 0, dt, gbps=dat_size / dt / 1e9)
    mlog(f"1 encode: WEEDTPU_EC_CODEC=mesh, one position "
         f"({codec.mesh.devices.flat[0]}): {dat_size} B in {dt:.3f} s "
         f"({dat_size / dt / 1e9:.3f} GB/s); 14 shards, .ecx and .vif "
         f"sha256 == phase 4's; K1 {enc_k1} == phase 4's")

    # 2 phase 5's losses, rebuilt under mesh
    lost = [0, 3, 10, 12]
    for i in lost:
        os.remove(shard[i])
    reb_k1 = phases["rebuild_warm"]["launches"]
    k0 = dict(launches)
    with scoped_env(WEEDTPU_EC_CODEC="mesh"):
        t0 = time.perf_counter()
        rebuilt = ec_files.rebuild_ec_files(base, device=device)
        dt = time.perf_counter() - t0
    if rebuilt != lost or sha256_many([shard[i] for i in lost]) != \
            [hashes[i] for i in lost]:
        raise AssertionError(f"mesh rebuild: {rebuilt} differ")
    step("2 rebuild", k0, reb_k1, 0, dt)
    mlog(f"2 rebuild: {lost} under mesh sha256-equal in {dt:.3f} s; K1 "
         f"{reb_k1} == phase 6's")

    # 3, 4 the fleet on a unit mesh: one position, then four of the card
    fsrc = [server_src] + [p[: -len(".dat")] for p in srcs[1:]]
    units = sum(phases["fleet"]["units"])
    k2_one = phases["fleet"]["launches"]["gf_apply_batch"]
    for name, devices, want in (
            ("3 fleet", device, k2_one),
            ("4 fleet x4", [pos] * MESH_FLEET_POSITIONS, units)):
        fdir = os.path.join(work, name.split()[0])
        bases = link_volumes([p + ".dat" for p in fsrc], fdir)
        k0 = dict(launches)
        st: dict = {}
        with scoped_env(WEEDTPU_CONVERT_CODEC="mesh"):
            fc = fleet_convert.fleet_codec(device=devices)
            t0 = time.perf_counter()
            fleet_convert.convert_volumes(bases, device=devices, stats=st)
            dt = time.perf_counter() - t0
        for b, want_h in zip(bases, phases["fleet"]["sha256"]):
            if sha256_many([b + layout.to_ext(i) for i in range(14)]) != \
                    want_h:
                raise AssertionError(f"mesh {name}: {b} differs from "
                                     f"phase 7's shards")
        shutil.rmtree(fdir)
        total = sum(os.path.getsize(p + ".dat") for p in fsrc)
        step(name, k0, 0, want, dt, positions=fc.n_devices,
             unit_batch=st["unit_batch"], gbps=total / dt / 1e9)
        mlog(f"{name}: WEEDTPU_CONVERT_CODEC=mesh on {fc.n_devices} "
             f"position(s), {st['unit_batch']} units a batch: {total} B of "
             f"4 volumes in {dt:.3f} s ({total / dt / 1e9:.3f} GB/s); every "
             f"shard sha256 == phase 7's; K2 {want} "
             + ("== phase 7's" if name == "3 fleet" else
                f"== the {units} units, one per position per batch"))

    # 5 the shard-placement exchange on stripes of the .dat
    k, step_w = layout.DATA_SHARDS, layout.SMALL_BLOCK_SIZE
    stripes = np.fromfile(base + ".dat", dtype=np.uint8,
                          count=6 * k * step_w).reshape(6, k, step_w)
    rows = np.stack([np.fromfile(p, dtype=np.uint8, count=6 * step_w)
                     .reshape(6, step_w) for p in shard], axis=1)
    code = rs.get_code(layout.DATA_SHARDS, layout.PARITY_SHARDS)
    place_rec = {}
    for shape in MESH_PLACE:
        vol_dim, col_dim = shape
        V = 2 * vol_dim
        mesh = pmesh.make_mesh(vol_dim * col_dim, ("vol", "col"),
                               shape=shape,
                               devices=[pos] * (vol_dim * col_dim))
        enc = pmesh.ShardedRSEncoder(code, mesh, col_axis="col",
                                     vol_axis="vol")
        S = enc.placement_groups()
        G, nl = S // vol_dim, step_w // col_dim
        k0 = dict(launches)
        t0 = time.perf_counter()
        placed = enc.encode_batch_place(stripes[:V])
        checked = 0
        for sh in placed.shards:
            v, c = sh.position
            if sh.event is not None:
                sh.event.synchronize()
            block = sh.data.cpu().numpy()  # [V, G, nl]
            want = np.zeros((V, G, nl), dtype=np.uint8)
            real = min(G, 14 - v * G)
            want[:, :real] = rows[:V, v * G:v * G + real,
                                  c * nl:(c + 1) * nl]
            if block.shape != want.shape or not np.array_equal(block, want):
                raise AssertionError(f"mesh {shape}: position {(v, c)} "
                                     f"holds other bytes than rows "
                                     f"[{v * G}, {v * G + G}) of its "
                                     f"stripes")
            checked += 1
        survivors = {i: rows[0, i] for i in range(14)
                     if i not in MESH_LOSSES}
        back = enc.reconstruct(survivors)
        for i in MESH_LOSSES:
            if not np.array_equal(back[i].numpy(), rows[0, i]):
                raise AssertionError(f"mesh {shape}: rebuilt shard {i} of "
                                     f"volume 0 differs from its file")
        dt = time.perf_counter() - t0
        n_pos = vol_dim * col_dim
        step(f"5 place {shape}", k0, col_dim, n_pos, dt, S=S,
             positions=checked)
        place_rec[str(shape)] = S
        mlog(f"5 place {shape}: {V} stripes [10, {step_w}] through "
             f"encode_batch_place on {n_pos} positions of the card: S = "
             f"{S}, each position's [{V}, {G}, {nl}] block == rows "
             f"[v*{G}, v*{G}+{G}) of step 1's shard files (pad rows zero); "
             f"column-split rebuild of {list(MESH_LOSSES)} of volume 0 == "
             f"their files; K2 {n_pos}, K1 {col_dim}; {dt:.3f} s")

    # 6 the dry run on 8 positions of the card
    k0 = dict(launches)
    t0 = time.perf_counter()
    ran = dryrun.dryrun_multichip(8, devices=[pos] * 8)
    dt = time.perf_counter() - t0
    want_k1 = sum(col for _, col in ran)
    want_k2 = sum(vol * col for vol, col in ran)
    step("6 dry run", k0, want_k1, want_k2, dt, meshes=[list(s) for s in ran])
    mlog(f"6 dryrun_multichip(8) on 8 positions of the card: meshes "
         f"{sorted(ran)}, its asserts hold; K2 {want_k2}, K1 {want_k1}; "
         f"{dt:.3f} s")
    shutil.rmtree(work)
    out = {"steps": steps, "placement_groups": place_rec,
           "s": time.perf_counter() - t_phase}
    mlog("launches per step (launched == predicted): " + "; ".join(
        f"{k} {v['launches']}" for k, v in steps.items())
        + f"; phase wall {out['s']:.1f} s")
    return out


# phase 20's master HA: three port masters with raft, two volume servers
# on the card, a failover under degraded reads.  Phase 4's shard set
# goes in as MASTER_EC_VID, above any vid the masters grow here.
MASTER_SMALL = 256  # step 3's objects through the leader's /dir/assign
MASTER_SMALL_SIZE = 1024
MASTER_LOST = (0, 3)  # step 6's lost data shards, on A
MASTER_DEGRADED = 128  # step 6's needles on them, drawn with --seed (cut from 256, PERF §4)
MASTER_EC_VID = 201
MASTER_BEAT_S = 0.5  # the volume servers' heartbeat interval here
MASTER_LEADER_S = 15.0  # a leader's deadline, the reference tests'


def phase_master(vdir: str, base: str, expect: dict, blob: bytes,
                 seed: int, launches: dict, device=None) -> dict:
    """Phase 20: the port's master with raft HA, and a failover under
    degraded reads on the card.  Three port `MasterServer`s with
    `peers` (raft state under the work directory) on one loop thread,
    two port `VolumeServer`s A and B on the card on another, given the
    master list reversed with the leader moved last, so that they start
    at a follower: (1) one
    leader, named by both followers' /cluster/status, /raft/status on
    each; (2) A and B in the leader's topology (the follower's 409
    redirect), beating in protobuf; (3) MASTER_SMALL x 1 KiB objects
    through the leader's /dir/assign in two collections, so the master
    grows one volume on A and one on B by /admin/assign_volume, read
    back; a follower's assign answers 409 naming the leader; every
    master's max_volume_id covers the grown vids (raft); (4) links of
    phase 4's shard set as MASTER_EC_VID, A 0-6 / B 7-13, mounted, the
    leader's /dir/ec/lookup equal to that split; (5) the leader stopped:
    a new leader, A's and B's beats at it, its /dir/ec/lookup the split
    again; (6) shards 0 and 3 deleted on A, MASTER_DEGRADED needles on
    them (drawn with --seed) read from A at 16 clients with hedging off,
    B's survivors found through the new leader: K1 one per needle, every
    payload equal to phase 3's; (7) one more assign on the new leader
    that must grow a volume: its vid above every vid grown before the
    failover, no file key repeated.  K1 and K2 per step held against
    their prediction; nothing staged."""
    import numpy as np
    from seaweedfs_tpu_torch.server import volume_server as vsmod
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.stats import metrics
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout
    from seaweedfs_tpu_torch.utils import http, resilience

    card = card_name_power()

    def mlog(msg: str) -> None:
        log(f"[master] {msg} [{card}]")

    work = os.path.join(vdir, "master")
    dirs = {n: os.path.join(work, n) for n in ("a", "b")}
    for d in dirs.values():
        os.makedirs(d)
    loops = []

    mrun, vrun = loop_thread(loops), loop_thread(loops)  # masters', servers'
    client = http.PooledHTTP(timeout=120.0, max_idle_per_host=32)
    masters: list = []
    servers: dict = {}
    steps: dict = {}
    counts: dict = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 20)

    def call(url: str, path: str, body=None, method=None, data=None
             ) -> tuple[int, bytes]:
        hdrs = {}
        if body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        st, _, raw = client.request(
            f"http://{url}{path}",
            method=method or ("POST" if data is not None else "GET"),
            body=data, headers=hdrs)
        return st, raw

    def get_json(url: str, path: str) -> dict:
        st, raw = call(url, path)
        if st != 200:
            raise AssertionError(f"{url}{path}: HTTP {st} {raw[:300]!r}")
        return json.loads(raw)

    def step_counts(name: str, k0: dict, k1: int) -> None:
        got = {k: launches[k] - k0[k] for k in launches}
        counts[name] = got
        want = {"gf_apply": k1, "gf_apply_batch": 0}
        if got != want:
            raise AssertionError(f"phase 20 {name}: launched {got}, "
                                 f"predicted {want}")

    def until(pred, what: str, timeout: float = MASTER_LEADER_S):
        deadline = time.monotonic() + timeout
        while True:
            got = pred()
            if got:
                return got
            if time.monotonic() > deadline:
                raise AssertionError(what)
            time.sleep(0.02)

    def settled(live: list):
        """The one leader of `live`, once every other's /cluster/status
        names it (a re-election can move the crown right after one)."""
        leaders = [m for m in live if m.is_leader]
        if len(leaders) != 1:
            return None
        for m in live:
            if m is not leaders[0]:
                st = get_json(m.url, "/cluster/status")
                if st["IsLeader"] or st["Leader"] != leaders[0].url:
                    return None
        return leaders[0]

    def ec_split(m) -> dict:
        return master_split(client, m.url, MASTER_EC_VID)

    try:
        # 1 three masters with raft; one leader
        k0 = dict(launches)
        ports = [free_port() for _ in range(3)]
        peers = [f"127.0.0.1:{p}" for p in ports]
        t0 = time.perf_counter()
        for p in ports:
            # no canary and no repair loop: a probe would launch K1, and
            # the planner would rebuild step 6's lost shards, at times no
            # step predicts
            with scoped_env(WEEDTPU_CANARY_INTERVAL="0",
                            WEEDTPU_REPAIR_INTERVAL="0"):
                m = MasterServer("127.0.0.1", p, peers=peers,
                                 raft_state_dir=os.path.join(work, "raft"))
                mrun(m.start())
            masters.append(m)
        leader = until(lambda: settled(masters), "no settled leader")
        dt_elect = time.perf_counter() - t0
        raft_st = {m.url: get_json(m.url, "/raft/status") for m in masters}
        if sorted(st["state"] for st in raft_st.values()) != \
                ["follower", "follower", "leader"] or \
                {st["leader"] for st in raft_st.values()} != {leader.url}:
            raise AssertionError(f"/raft/status: {raft_st}")
        step_counts("1 elect", k0, 0)
        steps["1 elect"] = {"s": dt_elect, "leader": leader.url,
                            "term": raft_st[leader.url]["term"]}
        mlog(f"1 elect: three masters, {leader.url} leads term "
             f"{steps['1 elect']['term']} {dt_elect:.3f} s after the "
             f"first start; both followers' /cluster/status name it; K1 0")

        # 2 two volume servers on the card, given the master list
        # reversed with the leader moved last: both start at a follower
        # and reach the leader through its 409
        k0 = dict(launches)
        mlist = [p for p in peers[::-1] if p != leader.url] + [leader.url]
        refused = metrics.HTTP_REQUESTS.labels("master", "internal", "4xx")
        r0 = refused.value
        t0 = time.perf_counter()
        for name in ("a", "b"):
            vs = vsmod.VolumeServer([dirs[name]], ",".join(mlist),
                                    "127.0.0.1", free_port(),
                                    heartbeat_interval=MASTER_BEAT_S,
                                    device=device)
            with scoped_env(WEEDTPU_SCRUB_MBPS="0"):
                vrun(vs.start())
            servers[name] = vs
        a, b = servers["a"], servers["b"]
        until(lambda: {a.url, b.url} <= set(leader.topo.nodes),
              "A and B never reached the leader")
        dt_join = time.perf_counter() - t0
        n409 = refused.value - r0
        if n409 < 2:
            raise AssertionError(f"{n409} beats refused by a follower")
        if not (a._wire_pb is True and b._wire_pb is True):
            raise AssertionError("a server beat in JSON")
        step_counts("2 join", k0, 0)
        steps["2 join"] = {"s": dt_join, "started_at": mlist[0],
                           "refused": n409, "device": str(a.device)}
        mlog(f"2 join: A {a.url} and B {b.url} on {a.device}, started at "
             f"the follower {mlist[0]}: {n409:.0f} beats answered 409, "
             f"both in the leader's topology {dt_join:.3f} s after their "
             f"start, beating in protobuf; K1 0")

        # 3 small objects through the leader's /dir/assign, two
        # collections: a volume grown on each server
        k0 = dict(launches)
        payload = rng.bytes(MASTER_SMALL * MASTER_SMALL_SIZE)
        small: dict = {}  # fid -> (url, bytes)
        errors: list = []
        lock = threading.Lock()

        def writer(c: int) -> None:
            try:
                for i in range(c, MASTER_SMALL, SERVER_CLIENTS):
                    col = ("p20a", "p20b")[i % 2]
                    st, raw = call(leader.url,
                                   f"/dir/assign?collection={col}")
                    if st != 200:
                        raise AssertionError(f"assign: HTTP {st} {raw!r}")
                    a_ = json.loads(raw)
                    data = payload[i * MASTER_SMALL_SIZE:
                                   (i + 1) * MASTER_SMALL_SIZE]
                    st, _ = call(a_["url"], "/" + a_["fid"], data=data,
                                 method="PUT")
                    if st != 201:
                        raise AssertionError(f"write {a_['fid']}: HTTP {st}")
                    with lock:
                        small[a_["fid"]] = (a_["url"], data)
            except Exception as e:  # surfaced after the join
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=writer, args=(c,))
                   for c in range(SERVER_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        dt_assign = time.perf_counter() - t0
        if errors:
            raise errors[0]
        for f, (url, data) in small.items():
            st, raw = call(url, "/" + f)
            if st != 200 or raw != data:
                raise AssertionError(f"small read {f}: HTTP {st}")
        grown = sorted({int(f.split(",")[0]) for f in small})
        homes = {int(f.split(",")[0]): url for f, (url, _) in small.items()}
        if len(small) != MASTER_SMALL or len(grown) != 2 or \
                set(homes.values()) != {a.url, b.url}:
            raise AssertionError(f"assigns landed on {homes}")
        follower = next(m for m in masters if m is not leader)
        st, raw = call(follower.url, "/dir/assign?collection=p20a")
        if st != 409 or json.loads(raw) != {"error": "not the leader",
                                            "leader": leader.url}:
            raise AssertionError(f"a follower's assign: {st} {raw!r}")
        until(lambda: all(m.topo.max_volume_id >= grown[-1]
                          for m in masters),
              "the grown vids did not replicate", 10)
        keys = [t.FileId.parse(f).key for f in small]
        step_counts("3 assign", k0, 0)
        steps["3 assign"] = {"objects": MASTER_SMALL, "s": dt_assign,
                             "assigns_per_s": MASTER_SMALL / dt_assign,
                             "grown": homes}
        mlog(f"3 assign: {MASTER_SMALL} x {MASTER_SMALL_SIZE} B through the "
             f"leader's /dir/assign and a PUT each at {SERVER_CLIENTS} "
             f"clients, {MASTER_SMALL / dt_assign:.1f} assigns/s "
             f"({dt_assign:.3f} s); volumes {grown} grown on A and B, every "
             f"byte read back; a follower's assign 409 naming the leader; "
             f"every master's max_volume_id >= {grown[-1]}; K1 0")

        # 4 phase 4's shard set as MASTER_EC_VID, A 0-6 / B 7-13
        k0 = dict(launches)
        split = {a.url: list(SERVER_A_SHARDS),
                 b.url: [i for i in range(14) if i not in SERVER_A_SHARDS]}
        for name, vs in servers.items():
            dst = os.path.join(dirs[name], str(MASTER_EC_VID))
            for i in split[vs.url]:
                os.link(base + layout.to_ext(i), dst + layout.to_ext(i))
            for ext in (".ecx", ".vif"):
                os.link(base + ext, dst + ext)
            st, raw = call(vs.url, "/admin/ec/mount",
                           body={"volume": MASTER_EC_VID})
            if st != 200:
                raise AssertionError(f"mount on {name}: HTTP {st} {raw!r}")
        until(lambda: ec_split(leader) == split,
              f"the leader shows {ec_split(leader)}", 10)
        step_counts("4 place", k0, 0)
        mlog(f"4 place: links of phase 4's shards as volume "
             f"{MASTER_EC_VID}, A {split[a.url]} / B {split[b.url]}, "
             f"mounted; the leader's /dir/ec/lookup equals the split; K1 0")

        # 5 failover: the leader stopped
        k0 = dict(launches)
        old = leader
        t0 = time.perf_counter()
        mrun(old.stop())
        masters.remove(old)
        leader = until(lambda: settled(masters), "no new leader")
        dt_elect2 = time.perf_counter() - t0
        until(lambda: {a.url, b.url} <= set(leader.topo.nodes)
              and ec_split(leader) == split,
              "the servers' beats never reached the new leader")
        dt_failover = time.perf_counter() - t0
        if not (a.master_url == b.master_url == leader.url):
            raise AssertionError(f"A beats {a.master_url}, B "
                                 f"{b.master_url}: not {leader.url}")
        step_counts("5 failover", k0, 0)
        steps["5 failover"] = {"elect_s": dt_elect2, "s": dt_failover,
                               "old": old.url, "new": leader.url}
        mlog(f"5 failover: {old.url} stopped; {leader.url} leads "
             f"{dt_elect2:.3f} s later, A's and B's beats and the split "
             f"at it {dt_failover:.3f} s after the stop; K1 0")

        # 6 degraded reads from A through the new leader's shard map
        st, raw = call(a.url, "/admin/ec/delete_shards",
                       body={"volume": MASTER_EC_VID,
                             "shards": list(MASTER_LOST)})
        if st != 200:
            raise AssertionError(f"delete_shards: HTTP {st} {raw!r}")
        ev = a.store.get_ec_volume(MASTER_EC_VID)
        touching = [nid for nid in expect
                    if any(s in MASTER_LOST for s, _, _ in
                           intervals(ev, nid))]
        drawn = sorted(rng.choice(touching, size=min(len(touching),
                                                     MASTER_DEGRADED),
                                  replace=False).tolist())
        resilience.reset_latency_trackers()
        resilience.reset_breakers()
        k0 = dict(launches)
        s0 = ev.read_stats_snapshot()
        ts: list = [[] for _ in range(SERVER_CLIENTS)]

        def reader(c: int) -> None:
            try:
                for nid in drawn[c::SERVER_CLIENTS]:
                    cookie, lo, hi = expect[nid]
                    f = str(t.FileId(MASTER_EC_VID, nid, cookie))
                    t1 = time.perf_counter()
                    st, raw = call(a.url, "/" + f)
                    ts[c].append(time.perf_counter() - t1)
                    if st != 200 or raw != blob[lo:hi]:
                        raise AssertionError(f"degraded read of {nid}: "
                                             f"HTTP {st}")
            except Exception as e:  # surfaced after the join
                errors.append(e)

        t0 = time.perf_counter()
        with scoped_env(WEEDTPU_HEDGE_PCT="0"):
            threads = [threading.Thread(target=reader, args=(c,))
                       for c in range(SERVER_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        dt = time.perf_counter() - t0
        if errors:
            raise errors[0]
        grew = {k: v - s0[k] for k, v in ev.read_stats_snapshot().items()}
        step_counts("6 degraded", k0, len(drawn))
        if grew["reconstruct_batches"] != len(drawn) or \
                grew["remote_shard_reads"] <= 0:
            raise AssertionError(f"read stats {grew}")
        if a.master_url != leader.url:
            raise AssertionError("A's lookups went to another master")
        lat = server_latency([x for c in ts for x in c])
        steps["6 degraded"] = {"reads": len(drawn), "s": dt,
                               "reads_per_s": len(drawn) / dt, **lat,
                               "read_stats": grew}
        mlog(f"6 degraded: shards {list(MASTER_LOST)} gone on A; "
             f"{len(drawn)} needles on them from A at {SERVER_CLIENTS} "
             f"clients, B's survivors found through {leader.url}: "
             f"{len(drawn) / dt:.1f} GETs/s, p50 {lat['p50_s'] * 1e3:.2f} "
             f"ms, max {lat['max_s'] * 1e3:.2f} ms, every payload == "
             f"phase 3's; remote shard reads {grew['remote_shard_reads']}; "
             f"K1 {counts['6 degraded']['gf_apply']} == needles")

        # 7 a grow on the new leader
        k0 = dict(launches)
        st, raw = call(leader.url, "/dir/assign?collection=p20c")
        if st != 200:
            raise AssertionError(f"assign after the failover: HTTP {st} "
                                 f"{raw!r}")
        late = json.loads(raw)
        fid = t.FileId.parse(late["fid"])
        if fid.volume_id <= grown[-1] or fid.key in keys:
            raise AssertionError(f"after the failover {late['fid']}: vids "
                                 f"before {grown}, a key repeated")
        st, _ = call(late["url"], "/" + late["fid"], data=b"after failover",
                     method="PUT")
        if st != 201 or call(late["url"], "/" + late["fid"]) != \
                (200, b"after failover"):
            raise AssertionError("the write after the failover")
        step_counts("7 grow", k0, 0)
        steps["7 grow"] = {"fid": late["fid"], "before": grown}
        mlog(f"7 grow: the new leader grew volume {fid.volume_id} (before "
             f"the failover: {grown}), key {fid.key:x} new among "
             f"{len(keys) + 1}; K1 0")
    finally:
        for vs in servers.values():
            vrun(vs.stop())
        for m in masters:
            mrun(m.stop())
        stop_loops(loops)
        client.close()
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "steps": steps, "counts": counts,
           "s": time.perf_counter() - t_phase}
    k1 = {k: v["gf_apply"] for k, v in counts.items()}
    mlog(f"K1 per step {k1}; phase wall {out['s']:.1f} s")
    return out


# phase 21's cluster: the port's master with its planes, A and B on the card
PLANES_VID = 211  # phase 4's shard set, A 0-6 / B 7-13
PLANES_SCRUB_VID = 212  # the rated pass's small shard sets: 212, 213, ...
PLANES_MBPS = 64.0  # the scrubbers' configured rate, the governor's ceiling
PLANES_SMALL = 19 * MIB // 2  # the small set's .dat: one stripe row
PLANES_CANARY = 16  # step 2's canary rounds
PLANES_HISTORY = 3  # step 5's probes, a scrape tick after each
PLANES_DELAY_MS = 300  # steps 5 and 6: delay_shard_read
# step 5's alert: a degraded probe's latency, summed over the nodes that
# expose the process's one registry (the master, A and B): a delayed
# probe takes >= 0.3 s (x3), an undelayed one tens of ms
PLANES_SLOW_S = 0.6
PLANES_TICK_READS = 8  # step 6's degraded GETs per tick, one client
PLANES_BOOKED = 64 * MIB  # step 6's scrub-class bytes, booked
PLANES_SCRUB_S = 3.0  # the rated pass's least seconds at its rate
PLANES_NODE_TIMEOUT = 4.0  # the expire loop ticks every 2 s
PLANES_RECOVERY_TICKS = 60
# the governor's targets: the repair planner's cross-rack budget, the
# conversion scheduler's bucket, the autopilot's three plan buckets and
# the fleet scrub rate
GOVERNED = ["autopilot_balance", "autopilot_chunk", "autopilot_tier",
            "convert", "repair_xrack", "scrub"]


def phase_planes(vdir: str, base: str, expect: dict, blob: bytes,
                 seed: int, launches: dict, device=None) -> dict:
    """Phase 21: the port's master with its planes (ROADMAP 1.18c) over
    two card servers.  One port `MasterServer` on a loop thread, two
    port `VolumeServer`s A and B on the card on another, linking phase
    4's shard set as PLANES_VID, A 0-6 / B 7-13; the phase drives every
    tick itself (WEEDTPU_AGG_INTERVAL=0: ?refresh=1 scrapes;
    WEEDTPU_CANARY_INTERVAL=0: `run_once`); scrubbers at PLANES_MBPS
    that pass only on request (WEEDTPU_SCRUB_INTERVAL=3600), hedging
    off, one alert rule on the degraded probe's latency.  Set-up encodes
    a small shard set for step 6 (K1 its units).  Steps: (1) federate;
    (2) PLANES_CANARY canary rounds of the blob and degraded probes, K1
    one per degraded probe (its read has a reconstruction cache of its
    own); (3) the last degraded probe's stitched waterfall; (4)
    /cluster/perf; (5) history and the alert under delay_shard_read;
    (6) shards 0 and 3 deleted on A, a quiet and a busy tick of degraded
    GETs from A (B's shard reads delayed, scrub-class bytes booked with
    `netflow.account`, not read), the governed rate on A's and B's
    scrubbers, one /admin/scrub pass on A at that rate over small shard
    sets sized to take PLANES_SCRUB_S or more (K1 one per window), quiet
    ticks ramping the rate back; (7) /cluster/loops, the dashboard,
    /cluster/heat and /cluster/geo (no direction).  K1 and K2 per step held
    against their prediction; nothing staged."""
    import math

    import numpy as np
    from seaweedfs_tpu_torch.maintenance import scrub
    from seaweedfs_tpu_torch.server import volume_server as vsmod
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.stats import heat, metrics, netflow, trace
    from seaweedfs_tpu_torch.stats.aggregate import parse_exposition
    from seaweedfs_tpu_torch.stats.profile import KERNELS
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    from seaweedfs_tpu_torch.utils import http, resilience

    card = card_name_power()

    def plog(msg: str) -> None:
        log(f"[planes] {msg} [{card}]")

    work = os.path.join(vdir, "planes")
    dirs = {n: os.path.join(work, n) for n in ("a", "b", "small")}
    for d in dirs.values():
        os.makedirs(d)
    loops = []

    mrun, vrun = loop_thread(loops), loop_thread(loops)  # master, servers
    client = http.PooledHTTP(timeout=120.0, max_idle_per_host=8)
    master = None
    servers: dict = {}
    steps: dict = {}
    counts: dict = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 21)
    rule = ("canary_slow=threshold,series=weedtpu_canary_probe_seconds_sum,"
            f"label.path=degraded,agg=last,window=60,op=gt,"
            f"value={PLANES_SLOW_S},for=0,clear_for=0")
    env = scoped_env(
        WEEDTPU_AGG_INTERVAL="0", WEEDTPU_CANARY_INTERVAL="0",
        WEEDTPU_REPAIR_INTERVAL="0",
        WEEDTPU_SCRUB_MBPS=str(PLANES_MBPS), WEEDTPU_SCRUB_INTERVAL="3600",
        WEEDTPU_HEDGE_PCT="0",
        WEEDTPU_INTERF_MIN_SAMPLES=str(PLANES_TICK_READS // 2),
        WEEDTPU_ALERT_RULES=rule)

    def call(url: str, path: str, body=None) -> tuple[int, bytes]:
        hdrs = {}
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        st, _, raw = client.request(
            f"http://{url}{path}", method="POST" if data else "GET",
            body=data, headers=hdrs)
        return st, raw

    def get_json(url: str, path: str, body=None) -> dict:
        st, raw = call(url, path, body)
        if st != 200:
            raise AssertionError(f"{url}{path}: HTTP {st} {raw[:300]!r}")
        return json.loads(raw)

    def step_counts(name: str, k0: dict, k1: int) -> None:
        got = {k: launches[k] - k0[k] for k in launches}
        counts[name] = got
        want = {"gf_apply": k1, "gf_apply_batch": 0}
        if got != want:
            raise AssertionError(f"phase 21 {name}: launched {got}, "
                                 f"predicted {want}")

    def fault(vs, ms: int) -> None:
        get_json(vs.url, "/admin/faults", {"faults": [
            {"action": "delay_shard_read", "ms": ms}]})

    def place(vs, vid: int, src: str, shards) -> None:
        dst = os.path.join(vs.store.locations[0].directory, str(vid))
        for i in shards:
            os.link(src + layout.to_ext(i), dst + layout.to_ext(i))
        for ext in (".ecx", ".vif"):
            os.link(src + ext, dst + ext)
        get_json(vs.url, "/admin/ec/mount", {"volume": vid})

    def tick(view: str = "alerts") -> dict:
        """One scrape of the aggregator, through a ?refresh=1 view."""
        return get_json(master.url, f"/cluster/{view}?refresh=1")

    try:
        with env:
            # 0 set-up: the small shard set (one stripe row), the master,
            # A and B, phase 4's set linked A 0-6 / B 7-13
            k0 = dict(launches)
            t0 = time.perf_counter()
            small_dat, _, _ = build_volume(dirs["small"], seed + 21,
                                           PLANES_SMALL)
            sbase = small_dat[:-len(".dat")]
            ec_files.write_ec_files(sbase, device=device)
            ec_files.write_sorted_ecx(sbase + ".idx")
            small_units = predict_units(os.path.getsize(small_dat),
                                        layout.LARGE_BLOCK_SIZE,
                                        layout.SMALL_BLOCK_SIZE)
            small_shard = os.path.getsize(sbase + layout.to_ext(0))
            master = MasterServer("127.0.0.1", free_port(),
                                  node_timeout=PLANES_NODE_TIMEOUT)
            # the vacuum scan would compact the canary's blob volume
            master.vacuum_enabled = False
            mrun(master.start())
            for name in ("a", "b"):
                vs = vsmod.VolumeServer([dirs[name]], master.url,
                                        "127.0.0.1", free_port(),
                                        heartbeat_interval=0.5,
                                        device=device)
                vrun(vs.start())
                servers[name] = vs
            a, b = servers["a"], servers["b"]
            split = {a.url: list(SERVER_A_SHARDS),
                     b.url: [i for i in range(14)
                             if i not in SERVER_A_SHARDS]}
            place(a, PLANES_VID, base, split[a.url])
            place(b, PLANES_VID, base, split[b.url])
            until(lambda: master_split(client, master.url,
                                       PLANES_VID) == split,
                  "the master never showed the split")
            step_counts("0 setup", k0, small_units)
            KERNELS.reset()  # step 4 reads the reconstructs from here on
            plog(f"0 setup: master {master.url}, A {a.url} and B {b.url} on "
                 f"{a.device}, scrubbers at {a.scrubber.mbps} MB/s every "
                 f"{a.scrubber.interval:.0f} s; phase 4's set as "
                 f"{PLANES_VID}, A {split[a.url]} / B {split[b.url]}; a "
                 f"{os.path.getsize(small_dat)} B volume encoded for step "
                 f"6 ({small_shard} B shards), K1 {small_units}; "
                 f"{time.perf_counter() - t0:.3f} s")

            # 1 federate
            k0 = dict(launches)
            t0 = time.perf_counter()
            st, raw = call(master.url, "/cluster/metrics?refresh=1")
            dt = time.perf_counter() - t0
            fams = parse_exposition(raw.decode())
            nodes = {lab.get("node") for f in fams.values()
                     for _, lab, _ in f["samples"]}
            ages = {lab["node"]: v for _, lab, v in
                    fams["weedtpu_agg_scrape_age_seconds"]["samples"]}
            for vs in (a, b):
                if not any(lab.get("node") == vs.url and
                           lab.get("vs") == vs.url for _, lab, _ in
                           fams["weedtpu_disk_bytes"]["samples"]):
                    raise AssertionError(f"no disk gauges of {vs.url}")
            if st != 200 or not {a.url, b.url, master.url} <= nodes or \
                    not all(math.isfinite(ages.get(u, math.inf))
                            for u in (a.url, b.url, master.url)):
                raise AssertionError(f"/cluster/metrics: HTTP {st}, nodes "
                                     f"{nodes}, ages {ages}")
            step_counts("1 federate", k0, 0)
            steps["1 federate"] = {"s": dt, "families": len(fams),
                                   "ages": ages}
            plog(f"1 federate: /cluster/metrics?refresh=1 in {dt:.3f} s, "
                 f"{len(fams)} families under node labels {sorted(nodes)}; "
                 f"A's and B's disk gauges each under its own node; scrape "
                 f"ages {ages}; K1 0")

            # 2 canary rounds
            k0 = dict(launches)
            probes = metrics.CANARY_PROBES
            keys = [(p, c) for p in ("blob", "degraded")
                    for c in ("2xx", "5xx")]
            c0 = {k: probes.labels(*k).value for k in keys}
            t0 = time.perf_counter()
            for _ in range(PLANES_CANARY):
                st = mrun(master.canary.run_once(("blob", "degraded")))
                bad = {p: r for p, r in st["paths"].items()
                       if r["outcome"] != "ok"}
                if bad:
                    raise AssertionError(f"canary: {bad}")
            dt = time.perf_counter() - t0
            grew = {k: probes.labels(*k).value - c0[k] for k in keys}
            if grew != {("blob", "2xx"): PLANES_CANARY,
                        ("blob", "5xx"): 0,
                        ("degraded", "2xx"): PLANES_CANARY,
                        ("degraded", "5xx"): 0}:
                raise AssertionError(f"canary probes counted {grew}")
            step_counts("2 canary", k0, PLANES_CANARY)
            view = get_json(master.url, "/cluster/canary")
            slo = tick("slo")
            canary_rule = next(r for r in slo["rules"]
                               if r["name"] == "canary_availability")
            if slo["state"] != "ok" or canary_rule["state"] != "ok" or \
                    view["paths"]["degraded"]["samples"] != PLANES_CANARY:
                raise AssertionError(f"/cluster/slo {slo['state']}, "
                                     f"canary {canary_rule}")
            deg, blb = view["paths"]["degraded"], view["paths"]["blob"]
            steps["2 canary"] = {"s": dt, "rounds": PLANES_CANARY,
                                 "degraded_p50_ms": deg["p50_ms"],
                                 "degraded_p99_ms": deg["p99_ms"],
                                 "blob_p50_ms": blb["p50_ms"],
                                 "blob_p99_ms": blb["p99_ms"]}
            plog(f"2 canary: {PLANES_CANARY} rounds of the blob and "
                 f"degraded probes in {dt:.3f} s, every probe ok; degraded "
                 f"p50 {deg['p50_ms']:.2f} ms, p99 {deg['p99_ms']:.2f} ms; "
                 f"blob p50 {blb['p50_ms']:.2f} ms; /cluster/canary and "
                 f"/cluster/slo ok; K1 {PLANES_CANARY}, one per degraded "
                 f"probe")

            # 3 the last degraded probe's waterfall
            k0 = dict(launches)
            tid = deg["trace_id"]
            t0 = time.perf_counter()
            wf = get_json(master.url, f"/cluster/trace/{tid}")
            dt = time.perf_counter() - t0
            names = sorted({s["name"] for s in wf["spans"]})
            want = {"canary.degraded", "volume.probe_read",
                    "ec.reconstruct_batch", "codec.reconstruct"}
            if not want <= set(names) or "volume" not in wf["servers"] or \
                    tid not in trace.pinned_ids():
                raise AssertionError(f"waterfall {names}, servers "
                                     f"{wf['servers']}")
            for vs in (a, b):
                if not get_json(vs.url, f"/debug/traces?tid={tid}")[
                        "traces"]:
                    raise AssertionError(f"{vs.url} lost trace {tid}")
            step_counts("3 stitch", k0, 0)
            steps["3 stitch"] = {"s": dt, "spans": len(wf["spans"]),
                                 "names": names}
            plog(f"3 stitch: /cluster/trace/{tid} in {dt:.3f} s, one "
                 f"waterfall of {len(wf['spans'])} spans ({', '.join(names)}"
                 f"), servers {wf['servers']}; pinned, and in A's and B's "
                 f"/debug/traces (one process, one ring); K1 0")

            # 4 the fleet's perf view
            k0 = dict(launches)
            perf = get_json(master.url, "/cluster/perf")
            rows = [r for r in perf["roofline"]
                    if r["kernel"] == "reconstruct"]
            calls = KERNELS.snapshot().get("reconstruct[device]",
                                           {}).get("calls", 0)
            if perf["nodes"] != [master.url] or calls != PLANES_CANARY or \
                    perf["codecs"]["volumes"].get(str(PLANES_VID)) != \
                    "rs_10_4":
                raise AssertionError(f"/cluster/perf nodes {perf['nodes']}, "
                                     f"reconstruct[device] calls {calls}, "
                                     f"codecs {perf['codecs']}")
            step_counts("4 perf", k0, 0)
            steps["4 perf"] = {"reconstruct_calls": calls,
                               "reconstruct_rows": rows}
            plog(f"4 perf: /cluster/perf merges the master's, A's and B's "
                 f"payloads once (one process, one tracker: nodes "
                 f"{perf['nodes']}); reconstruct[device] calls {calls} == "
                 f"K1 since step 1; roofline rows of reconstruct {rows}; "
                 f"codec of {PLANES_VID} rs_10_4; K1 0")

            # 5 history and the alert
            k0 = dict(launches)
            t0 = time.perf_counter()
            tick()
            for _ in range(PLANES_HISTORY):
                mrun(master.canary.run_once(("degraded",)))
                tick()
            hist = get_json(master.url, "/cluster/history?series="
                            "weedtpu_canary_probes_total&labels=path="
                            "degraded,class=2xx&range=120&step=1&agg=sum")
            pts = hist["vectors"][0]["points"] if hist["vectors"] else []
            n_nodes = len(master.aggregator.per_node)
            total = sum(v for _, v in pts if v is not None)
            if len(pts) != 120 or any(q[0] - p[0] != 1.0 for p, q in
                                      zip(pts, pts[1:])) or \
                    total != PLANES_HISTORY * n_nodes:
                raise AssertionError(f"/cluster/history: {hist}")
            for vs in (a, b):
                fault(vs, PLANES_DELAY_MS)
            st = mrun(master.canary.run_once(("degraded",)))
            slow = st["paths"]["degraded"]
            firing = next(r for r in tick()["rules"]
                          if r["name"] == "canary_slow")
            for vs in (a, b):
                fault(vs, 0)
            st = mrun(master.canary.run_once(("degraded",)))
            fast = st["paths"]["degraded"]
            cleared = next(r for r in tick()["rules"]
                           if r["name"] == "canary_slow")
            dt = time.perf_counter() - t0
            group = firing["groups"][0] if firing["groups"] else {}
            if firing["state"] != "firing" or cleared["state"] != "ok" or \
                    group.get("exemplar") != slow["trace_id"] or \
                    slow["outcome"] != "ok" or fast["outcome"] != "ok":
                raise AssertionError(f"alert: firing {firing}, cleared "
                                     f"{cleared}, probes {slow} {fast}")
            step_counts("5 history", k0, PLANES_HISTORY + 2)
            steps["5 history"] = {"s": dt, "points": len(pts),
                                  "probes_summed": total,
                                  "slow_ms": slow["ms"],
                                  "fast_ms": fast["ms"],
                                  "alert_value": group.get("value")}
            plog(f"5 history: {PLANES_HISTORY} degraded probes, a scrape "
                 f"tick after each; /cluster/history of the probe counter: "
                 f"{len(pts)} points 1 s apart summing to {total:.0f} "
                 f"({PLANES_HISTORY} probes x {n_nodes} nodes exposing the "
                 f"one registry); delay_shard_read {PLANES_DELAY_MS} ms on A "
                 f"and B: the probe took {slow['ms']:.1f} ms and canary_slow "
                 f"fired at {group.get('value')} s (> {PLANES_SLOW_S}), its "
                 f"exemplar the probe's trace; lifted: {fast['ms']:.1f} ms "
                 f"and it cleared; {dt:.3f} s; K1 {PLANES_HISTORY + 2}")

            # 6 govern the scrub rate
            get_json(a.url, "/admin/ec/delete_shards",
                     {"volume": PLANES_VID, "shards": list(MASTER_LOST)})
            ev = a.store.get_ec_volume(PLANES_VID)
            touching = [nid for nid in expect
                        if any(s in MASTER_LOST for s, _, _ in
                               intervals(ev, nid))]
            drawn = rng.choice(touching, size=2 * PLANES_TICK_READS,
                               replace=False).tolist()
            resilience.reset_latency_trackers()
            resilience.reset_breakers()
            k0 = dict(launches)
            t_step = time.perf_counter()

            def reads(nids) -> list:
                out = []
                for nid in nids:
                    cookie, lo, hi = expect[nid]
                    t1 = time.perf_counter()
                    st, raw = call(a.url, "/" + str(
                        t.FileId(PLANES_VID, nid, cookie)))
                    out.append(time.perf_counter() - t1)
                    if st != 200 or raw != blob[lo:hi]:
                        raise AssertionError(f"degraded read of {nid}: "
                                             f"HTTP {st}")
                return out

            quiet_s = reads(drawn[:PLANES_TICK_READS])
            quiet = tick("interference")
            node_a = quiet["interference"]["nodes"][a.url]
            fault(b, PLANES_DELAY_MS)
            netflow.account("recv", "scrub", "volume", PLANES_BOOKED)
            busy_s = reads(drawn[PLANES_TICK_READS:])
            busy = tick("interference")
            fault(b, 0)
            itf = busy["interference"]["classes"].get("scrub", {})
            gov = busy["governor"]
            rate = gov["targets"]["scrub"]["rate"]
            down = [d for d in gov["decisions"]
                    if d["target"] == "scrub" and d["direction"] == "down"]
            governed = {n: vs.scrubber.mbps for n, vs in servers.items()}
            if node_a["quiet_p99_ms"] is None or \
                    itf.get("index", 0.0) <= gov["target_index"] or \
                    sorted(gov["targets"]) != GOVERNED or \
                    not rate < PLANES_MBPS or not down or \
                    any(abs(m - rate) > 1e-3 for m in governed.values()):
                raise AssertionError(f"governor: quiet {node_a}, index "
                                     f"{itf}, {gov}, scrubbers {governed}")
            # the rated pass: phase 4's set off A (its windows lack shards
            # and would pace the pass for nothing), small sets on
            get_json(a.url, "/admin/ec/unmount", {"volume": PLANES_VID})
            per_vol = 14 * small_shard
            n_sets = max(1, math.ceil(PLANES_SCRUB_S * rate * 1e6 / per_vol))
            vids = [PLANES_SCRUB_VID + i for i in range(n_sets)]
            for vid in vids:
                place(a, vid, sbase, range(14))
            W = scrub.DEFAULT_WINDOW  # the servers': no WEEDTPU_SCRUB_WINDOW
            windows = n_sets * -(-small_shard // W)
            k1 = dict(launches)
            t0 = time.perf_counter()
            passed = get_json(a.url, "/admin/scrub", {})
            dt_scrub = time.perf_counter() - t0
            got_k1 = launches["gf_apply"] - k1["gf_apply"]
            res = [passed["volumes"][str(v)] for v in vids]
            floor = 0.9 * passed["bytes"] / (rate * 1e6)
            if dt_scrub < floor or got_k1 != windows or \
                    sum(r["windows"] for r in res) != windows or \
                    any(r["corrupt"] or r["windows_skipped"] for r in res):
                raise AssertionError(f"rated scrub: {dt_scrub:.3f} s "
                                     f"against {floor:.3f}, K1 {got_k1} "
                                     f"of {windows}: {passed}")
            for vid in vids:
                get_json(a.url, "/admin/ec/unmount", {"volume": vid})
                for ext in [layout.to_ext(i) for i in range(14)] + [
                        ".ecx", ".vif"]:
                    os.remove(os.path.join(dirs["a"], str(vid)) + ext)
            get_json(a.url, "/admin/ec/mount", {"volume": PLANES_VID})
            # quiet ticks: the index decays, the rate ramps back
            rates = [rate]
            for _ in range(PLANES_RECOVERY_TICKS):
                st = tick("interference")
                rates.append(st["governor"]["targets"]["scrub"]["rate"])
                if rates[-1] >= PLANES_MBPS:
                    break
            ups = [d for d in st["governor"]["decisions"]
                   if d["target"] == "scrub" and d["direction"] == "up"]
            if not ups or rates[-1] <= rate or \
                    abs(a.scrubber.mbps - rates[-1]) > 1e-3:
                raise AssertionError(f"no recovery: rates {rates}")
            dt = time.perf_counter() - t_step
            step_counts("6 govern", k0, 2 * PLANES_TICK_READS + windows)
            steps["6 govern"] = {
                "s": dt, "quiet_p99_ms": node_a["quiet_p99_ms"],
                "quiet_read_s": server_latency(quiet_s),
                "busy_read_s": server_latency(busy_s),
                "index": itf.get("index"), "rate_mbps": rate,
                "scrub_bytes": passed["bytes"], "scrub_sets": n_sets,
                "scrub_s": dt_scrub, "floor_s": floor,
                "scrub_mbps": passed["bytes"] / dt_scrub / 1e6,
                "windows": windows, "recovery_ticks": len(rates) - 1,
                "recovered_mbps": rates[-1]}
            lat_q, lat_b = server_latency(quiet_s), server_latency(busy_s)
            plog(f"6 govern: shards {list(MASTER_LOST)} gone on A; quiet "
                 f"tick: {PLANES_TICK_READS} degraded GETs from A, p50 "
                 f"{lat_q['p50_s'] * 1e3:.1f} ms, A's quiet p99 "
                 f"{node_a['quiet_p99_ms']} ms; busy tick: B's shard reads "
                 f"delayed {PLANES_DELAY_MS} ms and {PLANES_BOOKED} B of "
                 f"scrub class booked (netflow.account, not read), "
                 f"{PLANES_TICK_READS} GETs p50 {lat_b['p50_s'] * 1e3:.1f} "
                 f"ms: scrub index {itf.get('index')} over the target "
                 f"{gov['target_index']}, the governor {PLANES_MBPS} -> "
                 f"{rate} MB/s, pushed: A {governed['a']}, B "
                 f"{governed['b']} MB/s; /admin/scrub on A over {n_sets} "
                 f"links of the small set: {passed['bytes']} B in "
                 f"{dt_scrub:.3f} s ({passed['bytes'] / dt_scrub / 1e6:.3f} "
                 f"MB/s; floor {floor:.3f} s), K1 {windows}, one per window; "
                 f"{len(rates) - 1} quiet ticks back to {rates[-1]} MB/s "
                 f"(A's scrubber {a.scrubber.mbps}); {dt:.3f} s; K1 "
                 f"{2 * PLANES_TICK_READS + windows}")

            # 7 operator views
            k0 = dict(launches)
            lp = tick("loops")
            want = {"expire", "aggregator", "history_record", "forecast",
                    "alerts", "interference", "governor", "canary"}
            bad = {n: r for n, r in lp["loops"].items() if r["errors"]}
            if not want <= set(lp["loops"]) or bad:
                raise AssertionError(f"/cluster/loops {sorted(lp['loops'])}"
                                     f", errors {bad}")
            st, raw = call(master.url, "/cluster/dashboard")
            if st != 200 or raw.count(b"<svg") < 5:
                raise AssertionError(f"/cluster/dashboard: HTTP {st}")
            hv = tick("heat")
            alone = heat.merge_serialized([heat.serialize()])
            top = {e["key"]: e for e in hv["volumes"]["top"]}
            one = {e["key"]: e for e in alone["volumes"]["top"]}
            vol = top.get(str(PLANES_VID), {})
            if hv["nodes"] != sorted([master.url, a.url, b.url]) or \
                    vol.get("degraded", 0) <= 0 or \
                    abs(vol["est"] - one[str(PLANES_VID)]["est"]) > \
                    0.01 * vol["est"]:
                raise AssertionError(f"/cluster/heat {hv}")
            st_geo, geo = call(master.url, "/cluster/geo")
            if st_geo != 200 or json.loads(geo)["directions"]:
                raise AssertionError(f"/cluster/geo: HTTP {st_geo} {geo!r}")
            step_counts("7 views", k0, 0)
            steps["7 views"] = {"loops": {n: {k: r[k] for k in (
                "ticks", "wall_ema", "wall_max", "errors")}
                for n, r in lp["loops"].items()},
                "headline": lp["headline"], "subsystems": lp["subsystems"],
                "heat_est": vol["est"]}
            plog(f"7 views: /cluster/loops {sorted(lp['loops'])}, no error, "
                 f"{lp['headline']}; subsystems {lp['subsystems']}; the "
                 f"dashboard's {raw.count(b'<svg')} sparklines; /cluster/"
                 f"heat of {hv['nodes']}: volume {PLANES_VID} est "
                 f"{vol['est']} (one tracker merged once: {one[str(PLANES_VID)]['est']}), "
                 f"degraded {vol['degraded']}; /cluster/geo answers with "
                 f"no sync direction; K1 0")
    finally:
        for vs in servers.values():
            vrun(vs.stop())
        if master is not None:
            mrun(master.stop())
        stop_loops(loops)
        client.close()
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "steps": steps, "counts": counts,
           "s": time.perf_counter() - t_phase}
    k1 = {k: v["gf_apply"] for k, v in counts.items()}
    plog(f"K1 per step {k1}; phase wall {out['s']:.1f} s")
    return out


# phase 22's cluster: the port's master with its maintenance plane over
# phase 17's four card servers (R, a:1 in its rack, c:3 in its DC, b:2 in
# another), every volume under an id of its own
HEAL_VIDS = {"loss": 221, "corrupt": 222, "govern": 223, "promote": 224,
             "convert": (225, 226, 227, 228), "demote": 229}
HEAL_LOST = (1, 12)  # phase 9's [1, 12], on phase 9's topology
HEAL_FLIP = 5  # step 3's corrupt shard, a copy on c:3
HEAL_TICK_READS = 8  # step 6's degraded GETs per tick, as phase 21's
HEAL_BOOKED = 64 * MIB  # step 6's repair- and convert-class bytes, booked
HEAL_HOT_READS = 384  # step 7's GETs making the promoted volume hot
# step 7's autopilot clocks, shortened: a plain volume is cold at once,
# an EC volume hot at once from 0.5 reads/s (the heat sketch's estimate:
# 384 reads read as ~0.89/s), and no codec_select plan
HEAL_AUTOPILOT = {"WEEDTPU_AUTOPILOT_COLD_S": "0",
                  "WEEDTPU_AUTOPILOT_HOT_S": "0",
                  "WEEDTPU_AUTOPILOT_HOT_RPS": "0.5",
                  "WEEDTPU_AUTOPILOT_CODEC_RATE": "0"}


def phase_heal(vdir: str, base: str, server_src: str, expect: dict,
               blob: bytes, hashes: list[str], aux_hashes: dict,
               dat_hash: str, phases: dict, srcs: list[str], seed: int,
               launches: dict, device=None) -> dict:
    """Phase 22: the master's maintenance plane (ROADMAP 1.18d) healing
    and converting on the card servers.  One port `MasterServer` on a
    loop thread (WEEDTPU_REPAIR_INTERVAL=0, WEEDTPU_AGG_INTERVAL=0 and
    WEEDTPU_CANARY_INTERVAL=0: the phase drives every tick through
    /maintenance/tick, /maintenance/convert, /cluster/autopilot and
    ?refresh=1 scrapes; the autopilot's clocks shortened by
    HEAL_AUTOPILOT), phase 17's four port `VolumeServer`s on the card on
    another, scrubbers unthrottled and parked, hedging off.  Steps: (1)
    the health ledger; (2) two shards of phase 4's set lost on phase 9's
    topology and one planner tick: a reduced rebuild (K1 and the bytes
    per helper == phase 9's [1, 12]); (3) a bit flipped on c:3, found by /admin/scrub (K1 one
    per window), purged and rebuilt by one tick (K1 == phase 6's), a
    clean scrub; (4) step 2's loss again under WEEDTPU_REPAIR_REDUCED=0:
    survivor copies and /admin/ec/rebuild (K1 == phase 6's); (5) phase
    7's volumes converted and sealed through the scheduler (K2 == phase
    7's); (6) a quiet and a busy tick of degraded GETs (K1 one each),
    repair- and convert-class bytes booked, after a baseline tick of as
    many: the governor's repair_xrack and convert rates down and back; (7) the autopilot in plan mode: a
    promote (K1 == phase 6's) and a sealed demote (K2 its units), then
    one round of the background loop.  Every rebuilt shard and every
    converted or decoded file sha256-equal to its source phase's; K1 and
    K2 per step held against their prediction."""
    import asyncio

    import numpy as np
    from seaweedfs_tpu_torch.maintenance import scrub
    from seaweedfs_tpu_torch.ops import fleet_convert
    from seaweedfs_tpu_torch.server import volume_server as vsmod
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.stats import heat, netflow
    from seaweedfs_tpu_torch.stats.aggregate import parse_exposition
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout
    from seaweedfs_tpu_torch.topology.topology import locality_class
    from seaweedfs_tpu_torch.utils import http, resilience

    card = card_name_power()

    def hlog(msg: str) -> None:
        log(f"[heal] {msg} [{card}]")

    work = os.path.join(vdir, "heal")
    names = [n for n, _, _ in MAINT_NODES]
    dirs = {n: os.path.join(work, n.replace(":", "_")) for n in names}
    for d in dirs.values():
        os.makedirs(d)
    loops = []

    mrun, vrun = loop_thread(loops), loop_thread(loops)  # master, servers
    client = http.PooledHTTP(timeout=600.0, max_idle_per_host=8)
    master = None
    servers: dict = {}
    steps: dict = {}
    counts: dict = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 22)
    env = scoped_env(
        WEEDTPU_REPAIR_INTERVAL="0", WEEDTPU_AGG_INTERVAL="0",
        WEEDTPU_CANARY_INTERVAL="0",
        WEEDTPU_SCRUB_MBPS=str(MAINT_FAST_MBPS),
        WEEDTPU_SCRUB_INTERVAL="3600", WEEDTPU_HEDGE_PCT="0",
        WEEDTPU_INTERF_MIN_SAMPLES=str(HEAL_TICK_READS // 2),
        **HEAL_AUTOPILOT)

    def call(url: str, path: str, body=None) -> tuple[int, bytes]:
        hdrs = {}
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        st, _, raw = client.request(
            f"http://{url}{path}", method="POST" if data else "GET",
            body=data, headers=hdrs)
        return st, raw

    def get_json(url: str, path: str, body=None) -> dict:
        st, raw = call(url, path, body)
        if st != 200:
            raise AssertionError(f"{url}{path}: HTTP {st} {raw[:300]!r}")
        return json.loads(raw)

    def admin(name: str, path: str, body=None) -> dict:
        return get_json(servers[name].url, path, body)

    def step_counts(name: str, k0: dict, k1: int, k2: int = 0) -> None:
        got = {k: launches[k] - k0[k] for k in launches}
        counts[name] = got
        want = {"gf_apply": k1, "gf_apply_batch": k2}
        if got != want:
            raise AssertionError(f"phase 22 {name}: launched {got}, "
                                 f"predicted {want}")

    def place(name: str, vid: int, src: str, shards, copy=()) -> str:
        """Links of `src`'s shards (copies of those in `copy`), .ecx and
        .vif as EC volume `vid` on node `name`, mounted."""
        dst = os.path.join(dirs[name], str(vid))
        for i in shards:
            (shutil.copyfile if i in copy else os.link)(
                src + layout.to_ext(i), dst + layout.to_ext(i))
        for ext in (".ecx", ".vif"):
            os.link(src + ext, dst + ext)
        admin(name, "/admin/ec/mount", {"volume": vid})
        return dst

    def status() -> dict:
        return get_json(master.url, "/maintenance/status")

    def ledger(vid: int) -> dict:
        return status()["volumes"].get(str(vid), {})

    def whole(vid: int) -> bool:
        v = ledger(vid)
        return v.get("state") == "healthy" and \
            v.get("shards_present") == list(range(14))

    def tick(body=None) -> list:
        return get_json(master.url, "/maintenance/tick",
                        dict(body or {}, wait=True))["actions"]

    def metric(family: str) -> dict:
        """{label value: sample} of one family on the master's /metrics
        (one process, one registry: every server's counters too)."""
        st, raw = call(master.url, "/metrics")
        fam = parse_exposition(raw.decode()).get(family, {"samples": []})
        return {next(iter(lab.values()), ""): v
                for _, lab, v in fam["samples"]}

    def read(name: str, vid: int, nids) -> list:
        out = []
        for nid in nids:
            cookie, lo, hi = expect[nid]
            t1 = time.perf_counter()
            st, raw = call(servers[name].url,
                           "/" + str(t.FileId(vid, nid, cookie)))
            out.append(time.perf_counter() - t1)
            if st != 200 or raw != blob[lo:hi]:
                raise AssertionError(f"GET of {vid}/{nid} on {name}: "
                                     f"HTTP {st}")
        return out

    size = os.path.getsize(base + layout.to_ext(0))
    rebuild_k1 = phases["rebuild_warm"]["launches"]
    try:
        with env:
            # 0 set-up: the master, the four servers, phase 4's set linked
            # on phase 9's topology (221) and whole on c:3 (222, shard 5 a
            # copy: step 3 flips it)
            k0 = dict(launches)
            master = MasterServer("127.0.0.1", free_port())
            master.vacuum_enabled = False
            mrun(master.start())
            for name, dc, rack in MAINT_NODES:
                vs = vsmod.VolumeServer(
                    [dirs[name]], master.url, "127.0.0.1", free_port(),
                    data_center=dc, rack=rack, heartbeat_interval=0.5,
                    device=device)
                vrun(vs.start())
                servers[name] = vs
            url = {n: servers[n].url for n in names}
            loc = {n: locality_class("dc1", "r1", dc, rack)
                   for n, dc, rack in MAINT_NODES[1:]}
            if loc != {"a:1": 1, "c:3": 2, "b:2": 3}:
                raise AssertionError(f"localities {loc}")
            heat.reset()  # step 7's heat is this phase's reads alone
            lv, cv = HEAL_VIDS["loss"], HEAL_VIDS["corrupt"]
            place("R", lv, base, range(0, 6))
            place("a:1", lv, base, range(6, 9))
            place("b:2", lv, base, range(9, 14))
            cbase = place("c:3", cv, base, range(14), copy=(HEAL_FLIP,))
            until(lambda: whole(lv) and whole(cv),
                  "the ledger never showed the two volumes whole")
            step_counts("0 setup", k0, 0)
            hlog(f"0 setup: master {master.url} (repair loop, aggregator "
                 f"loop and canary off; autopilot {HEAL_AUTOPILOT}); "
                 f"servers {', '.join(f'{n} {url[n]}' for n in names)} on "
                 f"{servers['R'].device}; phase 4's set as {lv} (R 0-5, "
                 f"a:1 6-8, b:2 9-13) and {cv} (c:3, 0-13)")

            # 1 the ledger
            k0 = dict(launches)
            st = status()
            vol = st["volumes"][str(lv)]
            health = metric("weedtpu_volume_health")
            gov = st["interference"]["governor"]
            if vol["state"] != "healthy" or vol["shard_size"] != size or \
                    vol["codec"] != "rs_10_4" or vol["urgency"] != 0 or \
                    st["states"]["healthy"] != 2 or \
                    health.get("healthy") != 2.0 or \
                    health.get("degraded") != 0.0 or \
                    st["autopilot"]["mode"] != "plan" or \
                    sorted(gov["targets"]) != GOVERNED or \
                    "geo" in st:
                raise AssertionError(f"the ledger: {vol}, states "
                                     f"{st['states']}, gauge {health}, "
                                     f"autopilot {st['autopilot']}, "
                                     f"governor {sorted(gov['targets'])}")
            step_counts("1 ledger", k0, 0)
            steps["1 ledger"] = {"states": st["states"], "health": health,
                                 "targets": gov["targets"]}
            hlog(f"1 ledger: /maintenance/status lists {lv} and {cv} "
                 f"healthy with 14 shards of {size} B, "
                 f"weedtpu_volume_health {health}; the autopilot's headline "
                 f"{st['autopilot']}; the governor's targets "
                 f"{sorted(gov['targets'])}; no geo block; K1 0")

            # 2 loss, reduced: [1, 12] deleted on their holders
            for name, sid in (("R", HEAL_LOST[0]), ("b:2", HEAL_LOST[1])):
                got = admin(name, "/admin/faults", {"faults": [
                    {"action": "delete_shard", "volume": lv,
                     "shard": sid}]})
                if not all(a["ok"] for a in got["applied"]):
                    raise AssertionError(f"delete_shard: {got}")
            until(lambda: ledger(lv).get("shards_missing") ==
                  list(HEAL_LOST), "the loss never reached the ledger")
            vol = ledger(lv)
            if (vol["state"], vol["urgency"]) != ("degraded", 2):
                raise AssertionError(f"the degraded volume: {vol}")
            bytes0 = metric("weedtpu_repair_bytes_total")
            by_loc0 = dict(status()["planner"]["repair_bytes_by_locality"])
            k0 = dict(launches)
            t0 = time.perf_counter()
            actions = tick()
            dt = time.perf_counter() - t0
            step_counts("2 loss reduced", k0,
                        phases["repair"]["c"]["launches"])
            if actions != [{"vid": lv, "kind": "ec", "state": "degraded",
                            "node": url["R"], "urgency": 2}]:
                raise AssertionError(f"tick: {actions}")
            until(lambda: whole(lv), "the volume never healed")
            rbase = os.path.join(dirs["R"], str(lv))
            if sha256_many([rbase + layout.to_ext(s) for s in HEAL_LOST]) \
                    != [hashes[s] for s in HEAL_LOST]:
                raise AssertionError("rebuilt shards differ from phase 4's")
            planner = status()["planner"]
            dec = planner["decisions"][-1]
            by_loc = {k: v - by_loc0.get(k, 0) for k, v in
                      planner["repair_bytes_by_locality"].items()}
            booked = {k: v - bytes0.get(k, 0.0) for k, v in
                      metric("weedtpu_repair_bytes_total").items()
                      if v - bytes0.get(k, 0.0)}
            helpers = [(h["node"], h["locality"]) for h in dec["helpers"]]
            # the plan is phase 9's run (c): its measured bytes per helper
            # are this repair's; the planner's estimate (n_lost x shard x
            # helpers, the reference's) is an upper bound, since shard 1
            # joins R's survivors for the second loss and its windows
            # rotate over the helpers
            twin = phases["repair"]["c"]["helper_bytes"]
            want_loc = {"rack": float(twin["a:1"]),
                        "remote": float(twin["b:2"])}
            if dec["mode"] != "reduced" or dec["lost"] != list(HEAL_LOST) \
                    or dec["rebuilder"] != url["R"] or \
                    helpers != [(url["a:1"], 1), (url["b:2"], 3)] or \
                    dec["actual_bytes"] != sum(twin.values()) or \
                    dec["actual_bytes"] > dec["est_remote_bytes"] or \
                    dec["replans"] or \
                    {k: float(v) for k, v in by_loc.items() if v} != booked \
                    or booked != want_loc or \
                    planner["history"][-1]["outcome"] != "ok":
                raise AssertionError(f"the decision {dec}, by locality "
                                     f"{by_loc}, /metrics {booked}, "
                                     f"history {planner['history'][-1:]}")
            steps["2 loss reduced"] = {"s": dt, "decision": dec,
                                       "by_locality": by_loc}
            hlog(f"2 loss, reduced: shards {list(HEAL_LOST)} deleted on R "
                 f"and b:2 by /admin/faults, the ledger degraded, urgency "
                 f"2; one /maintenance/tick: a reduced rebuild on R with "
                 f"helpers {helpers} in {dt:.3f} s, the volume healthy, "
                 f"both shards sha256-equal to phase 4's; actual "
                 f"{dec['actual_bytes']} B == phase 9's run of the plan "
                 f"(the planner's estimate {dec['est_remote_bytes']} B, "
                 f"an upper bound), by locality {by_loc} == the helpers' "
                 f"/metrics == phase 9's; K1 "
                 f"{counts['2 loss reduced']['gf_apply']} == phase 9's")

            # 3 corruption: a bit of shard 5 flipped on c:3, scrubbed,
            # purged and rebuilt, scrubbed clean
            W = scrub.DEFAULT_WINDOW  # the servers': no WEEDTPU_SCRUB_WINDOW
            windows = phases["scrub"]["clean"]["windows"]
            w = windows // 3
            got = admin("c:3", "/admin/faults", {"faults": [
                {"action": "flip_bit", "volume": cv, "shard": HEAL_FLIP,
                 "offset": w * W + 321, "bit": 4}]})
            if not all(a["ok"] for a in got["applied"]):
                raise AssertionError(f"flip_bit: {got}")
            k0 = dict(launches)
            t0 = time.perf_counter()
            res = admin("c:3", "/admin/scrub", {})["volumes"][str(cv)]
            dt_scrub = time.perf_counter() - t0
            step_counts("3 scrub", k0, windows)
            want = [{"shard": HEAL_FLIP, "offset": w * W,
                     "size": min(W, size - w * W), "columns": 1}]
            vol = ledger(cv)
            if res["corrupt"] != want or vol["state"] != "corrupt" or \
                    vol["corrupt"] != [dict(c, node=url["c:3"])
                                       for c in want]:
                raise AssertionError(f"scrub {res}, ledger {vol}")
            k0 = dict(launches)
            t0 = time.perf_counter()
            actions = tick()
            dt = time.perf_counter() - t0
            step_counts("3 purge and rebuild", k0, rebuild_k1)
            if [(a["vid"], a["state"], a["node"]) for a in actions] != \
                    [(cv, "corrupt", url["c:3"])]:
                raise AssertionError(f"tick: {actions}")
            until(lambda: whole(cv) and not ledger(cv)["corrupt"],
                  "the corrupt volume never healed")
            if sha256(cbase + layout.to_ext(HEAL_FLIP)) != \
                    hashes[HEAL_FLIP]:
                raise AssertionError("the rebuilt shard differs")
            k0 = dict(launches)
            res = admin("c:3", "/admin/scrub", {})["volumes"][str(cv)]
            step_counts("3 rescrub", k0, windows)
            if res["corrupt"] or res["windows"] != windows:
                raise AssertionError(f"the fresh scrub: {res}")
            steps["3 corrupt"] = {"scrub_s": dt_scrub, "repair_s": dt,
                                  "found": want}
            hlog(f"3 corruption: a bit of shard {HEAL_FLIP} flipped on "
                 f"c:3, /admin/scrub found and localised it in "
                 f"{dt_scrub:.3f} s (K1 {windows}, one per window), the "
                 f"ledger corrupt; one tick purged it "
                 f"(/admin/ec/delete_shards) and rebuilt it from c:3's 13 "
                 f"in {dt:.3f} s (K1 {rebuild_k1} == phase 6's), sha256 "
                 f"== phase 4's; a fresh scrub clean (K1 {windows})")

            # 4 loss, naive: [1, 12] again, now both on R
            for sid in HEAL_LOST:
                admin("R", "/admin/faults", {"faults": [
                    {"action": "delete_shard", "volume": lv, "shard": sid}]})
            until(lambda: ledger(lv).get("shards_missing") ==
                  list(HEAL_LOST), "the second loss never reached the "
                  "ledger")
            bytes0 = metric("weedtpu_repair_bytes_total")
            k0 = dict(launches)
            t0 = time.perf_counter()
            with scoped_env(WEEDTPU_REPAIR_REDUCED="0"):
                actions = tick()
            dt = time.perf_counter() - t0
            step_counts("4 loss naive", k0, rebuild_k1)
            until(lambda: whole(lv), "the volume never healed (naive)")
            if sha256_many([rbase + layout.to_ext(s) for s in HEAL_LOST]) \
                    != [hashes[s] for s in HEAL_LOST]:
                raise AssertionError("naive: shards differ from phase 4's")
            left = sorted(int(p.rsplit(".ec", 1)[1]) for p in
                          os.listdir(dirs["R"])
                          if p.startswith(f"{lv}.ec") and
                          p[-2:].isdigit())
            dec = status()["planner"]["decisions"][-1]
            booked = {k: v - bytes0.get(k, 0.0) for k, v in
                      metric("weedtpu_repair_bytes_total").items()
                      if v - bytes0.get(k, 0.0)}
            if [a["vid"] for a in actions] != [lv] or \
                    dec["mode"] != "naive" or \
                    left != sorted(list(range(6)) + [12]) or \
                    booked != {"rack": 3.0 * size, "remote": 4.0 * size}:
                raise AssertionError(f"naive repair: {actions}, decision "
                                     f"{dec}, R holds {left}, /metrics "
                                     f"{booked}")
            steps["4 loss naive"] = {"s": dt, "booked": booked}
            hlog(f"4 loss, naive: {list(HEAL_LOST)} deleted on R, one tick "
                 f"under WEEDTPU_REPAIR_REDUCED=0 in {dt:.3f} s: 7 "
                 f"survivors copied to R, /admin/ec/rebuild (K1 "
                 f"{rebuild_k1} == phase 6's), the borrowed shards "
                 f"deleted, mounted; sha256 == phase 4's; "
                 f"weedtpu_repair_bytes_total booked the naive estimate "
                 f"{booked}")

            # 5 convert: links of phase 7's four volumes on a:1, queued
            # sealed and converted in one tick
            fvids = list(HEAL_VIDS["convert"])
            fsrc = [server_src] + [p[: -len(".dat")] for p in srcs[1:]]
            adir = dirs["a:1"]
            for fv, src in zip(fvids, fsrc):
                for ext in (".dat", ".idx"):
                    os.link(src + ext, os.path.join(adir, f"{fv}{ext}"))
                admin("a:1", "/admin/volume/mount", {"volume": fv})
            until(lambda: all(ledger(v).get("kind") == "normal"
                              for v in fvids),
                  "the master never showed the plain volumes")
            want_k2 = phases["fleet"]["launches"]["gf_apply_batch"]
            k0 = dict(launches)
            t0 = time.perf_counter()
            rep = get_json(master.url, "/maintenance/convert",
                           {"volumes": fvids, "seal": True, "tick": True})
            dt = time.perf_counter() - t0
            step_counts("5 convert", k0, 0, want_k2)
            acts = rep["actions"]
            if rep["accepted"] != fvids or len(acts) != 1 or \
                    acts[0]["node"] != url["a:1"] or \
                    acts[0]["outcome"] != "ok" or \
                    acts[0]["converted"] != fvids or \
                    acts[0].get("sealed") != fvids or \
                    rep["status"]["converted"] != 4:
                raise AssertionError(f"/maintenance/convert: {rep}")
            for fv, want_h in zip(fvids, phases["fleet"]["sha256"]):
                fb = os.path.join(adir, str(fv))
                if sha256_many([fb + layout.to_ext(i) for i in range(14)]) \
                        != want_h or os.path.exists(fb + ".dat"):
                    raise AssertionError(f"converted {fv}: shards differ "
                                         f"from phase 7's or .dat left")
            if sha256(os.path.join(adir, f"{fvids[0]}.ecx")) != \
                    aux_hashes[".ecx"]:
                raise AssertionError("the converted phase-3 volume's .ecx "
                                     "differs from phase 4's")
            until(lambda: all(master_split(client, master.url, v) ==
                              {url["a:1"]: list(range(14))}
                              for v in fvids),
                  "the sealed shard sets never reached the master")
            steps["5 convert"] = {"s": dt, "action": acts[0]}
            hlog(f"5 convert: /maintenance/convert of {fvids} (links of "
                 f"phase 7's volumes on a:1), sealed, one tick in "
                 f"{dt:.3f} s: one /admin/ec/fleet_convert batch (its own "
                 f"wall {acts[0]['wall_s']:.3f} s), K2 {want_k2} == phase "
                 f"7's; 56 shards sha256-equal to phase 7's, the phase-3 "
                 f"volume's .ecx to phase 4's, each shard set mounted and "
                 f"its .dat deleted, EC in the next beat; "
                 f"converted {rep['status']['converted']}")

            # 6 govern: a quiet and a busy tick of degraded GETs on R
            gv = HEAL_VIDS["govern"]
            gbase = place("R", gv, base, range(7))
            place("b:2", gv, base, range(7, 14))
            until(lambda: whole(gv), "the govern volume never whole")
            admin("R", "/admin/ec/delete_shards",
                  {"volume": gv, "shards": list(MASTER_LOST)})
            ev = servers["R"].store.get_ec_volume(gv)
            touching = [nid for nid in expect
                        if any(s in MASTER_LOST for s, _, _ in
                               intervals(ev, nid))]
            drawn = rng.choice(touching, size=3 * HEAL_TICK_READS,
                               replace=False).tolist()
            resilience.reset_latency_trackers()
            resilience.reset_breakers()

            def scrape() -> dict:
                return get_json(master.url,
                                "/cluster/interference?refresh=1")

            k0 = dict(launches)
            t_step = time.perf_counter()
            # a first tick of reads: the baseline of every node's read
            # latency series (nothing before it counts), then the quiet one
            read("R", gv, drawn[:HEAL_TICK_READS])
            scrape()
            quiet_s = read("R", gv, drawn[HEAL_TICK_READS:
                                          2 * HEAL_TICK_READS])
            scrape()
            admin("b:2", "/admin/faults", {"faults": [
                {"action": "delay_shard_read", "ms": PLANES_DELAY_MS}]})
            for cls in ("repair", "convert"):
                netflow.account("recv", cls, "volume", HEAL_BOOKED)
            busy_s = read("R", gv, drawn[2 * HEAL_TICK_READS:])
            busy = scrape()
            admin("b:2", "/admin/faults", {"faults": [
                {"action": "delay_shard_read", "ms": 0}]})
            classes = busy["interference"]["classes"]
            gov = busy["governor"]
            targets = {n: gov["targets"][n] for n in ("repair_xrack",
                                                      "convert")}
            buckets = {"repair_xrack": master.maintenance.xrack_bucket.rate,
                       "convert": master.convert.bucket.rate}
            down = {d["target"] for d in gov["decisions"]
                    if d["direction"] == "down"}
            if any(classes.get(c, {}).get("index", 0.0) <=
                   gov["target_index"] for c in ("repair", "convert")) or \
                    any(r["rate"] >= r["ceiling"]
                        for r in targets.values()) or \
                    any(abs(buckets[n] - targets[n]["rate"]) > 1e-3
                        for n in targets) or \
                    not {"repair_xrack", "convert"} <= down:
                raise AssertionError(f"governor: classes {classes}, "
                                     f"targets {targets}, buckets "
                                     f"{buckets}, decisions "
                                     f"{gov['decisions']}")
            governed = {n: r["rate"] for n, r in targets.items()}
            rates = [governed]
            for _ in range(PLANES_RECOVERY_TICKS):
                st = scrape()["governor"]
                rates.append({n: st["targets"][n]["rate"]
                              for n in targets})
                if all(rates[-1][n] >= targets[n]["ceiling"]
                       for n in targets):
                    break
            ups = {d["target"] for d in st["decisions"]
                   if d["direction"] == "up"}
            if any(rates[-1][n] < targets[n]["ceiling"] for n in targets) \
                    or not {"repair_xrack", "convert"} <= ups or \
                    master.maintenance.xrack_bucket.rate != \
                    targets["repair_xrack"]["ceiling"] or \
                    master.convert.bucket.rate != \
                    targets["convert"]["ceiling"]:
                raise AssertionError(f"no recovery: rates {rates}")
            # the two shards back: the volume whole again
            admin("R", "/admin/ec/unmount", {"volume": gv})
            for s in MASTER_LOST:
                os.link(base + layout.to_ext(s), gbase + layout.to_ext(s))
            admin("R", "/admin/ec/mount", {"volume": gv})
            until(lambda: whole(gv), "the govern volume never whole again")
            dt = time.perf_counter() - t_step
            step_counts("6 govern", k0, 3 * HEAL_TICK_READS)
            lat_q, lat_b = server_latency(quiet_s), server_latency(busy_s)
            steps["6 govern"] = {
                "s": dt, "index": {c: classes[c]["index"]
                                   for c in ("repair", "convert")},
                "governed": governed, "ceilings": {
                    n: targets[n]["ceiling"] for n in targets},
                "recovery_ticks": len(rates) - 1,
                "quiet_read_s": lat_q, "busy_read_s": lat_b}
            hlog(f"6 govern: shards {list(MASTER_LOST)} of {gv} gone on R; "
                 f"quiet tick: {HEAL_TICK_READS} degraded GETs, p50 "
                 f"{lat_q['p50_s'] * 1e3:.1f} ms; busy tick: b:2's shard "
                 f"reads delayed {PLANES_DELAY_MS} ms, {HEAL_BOOKED} B each "
                 f"of repair and convert class booked (netflow.account, not "
                 f"moved), {HEAL_TICK_READS} GETs p50 "
                 f"{lat_b['p50_s'] * 1e3:.1f} ms: index "
                 f"{steps['6 govern']['index']} over the target "
                 f"{gov['target_index']}; governed {governed} below the "
                 f"ceilings {steps['6 govern']['ceilings']}, the planner's "
                 f"and the scheduler's buckets at those rates; "
                 f"{len(rates) - 1} quiet ticks back to the ceilings; the "
                 f"shards linked back; {dt:.3f} s; K1 "
                 f"{3 * HEAL_TICK_READS}, one per GET (a first tick of "
                 f"{HEAL_TICK_READS} sets the baseline)")

            # 7 the autopilot, plan mode: a hot EC volume (c:3 4-13, b:2
            # 0-3) and a cold one-needle plain volume (a:1)
            pv, dv = HEAL_VIDS["promote"], HEAL_VIDS["demote"]
            pbase = place("c:3", pv, base, range(4, 14))
            place("b:2", pv, base, range(4))
            dsrc = srcs[-1][: -len(".dat")]
            for ext in (".dat", ".idx"):
                os.link(dsrc + ext, os.path.join(adir, f"{dv}{ext}"))
            admin("a:1", "/admin/volume/mount", {"volume": dv})
            until(lambda: whole(pv) and ledger(dv).get("state") ==
                  "healthy", "the autopilot's volumes never showed")
            hot = sorted(expect, key=lambda n: expect[n][2] - expect[n][1])[
                :HEAL_HOT_READS]
            k0 = dict(launches)
            t0 = time.perf_counter()
            read("c:3", pv, hot)
            dt_reads = time.perf_counter() - t0
            hv = get_json(master.url, "/cluster/heat?refresh=1")
            rec = next(r for r in hv["volumes"]["top"]
                       if r["key"] == str(pv))
            out = get_json(master.url, "/cluster/autopilot", {"tick": True})
            plans = out["plans"]
            step_counts("7 plan", k0, 0)
            shape = [(p["policy"], p["vid"], p.get("node"),
                      p.get("other_shard_nodes"), p["state"])
                     for p in plans]
            if shape != [("tiering_promote", pv, url["c:3"],
                          {url["b:2"]: [0, 1, 2, 3]}, "planned"),
                         ("tiering_demote", dv, None, None, "planned")] or \
                    out["status"]["actuator_calls"] != 0:
                raise AssertionError(f"autopilot tick: {plans}, "
                                     f"{out['status']}")
            promote, demote = plans
            k0 = dict(launches)
            t0 = time.perf_counter()
            out = get_json(master.url, "/cluster/autopilot",
                           {"approve": promote["id"], "wait": True})
            dt_promote = time.perf_counter() - t0
            step_counts("7 promote", k0, rebuild_k1)
            done = {p["id"]: p for p in out["status"]["plans"]}
            if done[promote["id"]]["state"] != "done" or \
                    sha256(pbase + ".dat") != dat_hash or \
                    [p for p in os.listdir(dirs["b:2"])
                     if p.startswith(f"{pv}.ec") and p[-2:].isdigit()] or \
                    out["status"]["actuator_calls"] != 2:
                raise AssertionError(f"promote: {done[promote['id']]}, "
                                     f"{out['status']['actuator_calls']} "
                                     f"actuator calls")
            k0 = dict(launches)
            out = get_json(master.url, "/cluster/autopilot",
                           {"approve": demote["id"], "wait": True})
            done = {p["id"]: p for p in out["status"]["plans"]}
            if done[demote["id"]].get("outcome") != "enqueued" or \
                    out["status"]["actuator_calls"] != 3:
                raise AssertionError(f"demote: {done[demote['id']]}")
            units = predict_units(os.path.getsize(dsrc + ".dat"),
                                  layout.LARGE_BLOCK_SIZE,
                                  layout.SMALL_BLOCK_SIZE)
            demote_k2 = -(-units // fleet_convert.UNIT_BATCH)
            rep = get_json(master.url, "/maintenance/convert",
                           {"tick": True})
            step_counts("7 demote", k0, 0, demote_k2)
            if [(a["volumes"], a.get("sealed")) for a in rep["actions"]] \
                    != [([dv], [dv])] or \
                    os.path.exists(os.path.join(adir, f"{dv}.dat")):
                raise AssertionError(f"the demote's conversion: {rep}")
            until(lambda: master_split(client, master.url, dv) ==
                  {url["a:1"]: list(range(14))} and
                  ledger(pv).get("kind") == "normal",
                  "the tiering never reached the master")
            view = get_json(master.url, "/cluster/autopilot")
            mine = [p for p in view["plans"]
                    if p["id"] in (promote["id"], demote["id"])]
            if [p["state"] for p in mine] != ["done", "done"] or \
                    any(len(p["trace_id"]) != 32 for p in mine):
                raise AssertionError(f"the ledger of plans: {mine}")
            # one round of the background loop: nothing left to do
            k0 = dict(launches)
            mrun(asyncio.wait(mrun(master.maintenance_round())))
            step_counts("7 round", k0, 0)
            lp = get_json(master.url, "/cluster/loops")
            bad = {n: r for n, r in lp["loops"].items() if r["errors"]}
            st = status()
            geo = get_json(master.url, "/cluster/geo")
            if not {"repair", "convert", "autopilot"} <= set(lp["loops"]) \
                    or bad or st["states"]["healthy"] != \
                    len(st["volumes"]) or geo["directions"]:
                raise AssertionError(f"/cluster/loops {sorted(lp['loops'])}"
                                     f", errors {bad}; states "
                                     f"{st['states']}; /cluster/geo {geo}")
            steps["7 autopilot"] = {
                "reads_s": dt_reads, "rps": rec["rps"],
                "promote_s": dt_promote, "demote_k2": demote_k2,
                "plans": [{k: p[k] for k in ("id", "policy", "vid",
                                              "state", "trace_id")}
                          for p in mine]}
            hlog(f"7 autopilot (plan mode): {HEAL_HOT_READS} GETs of {pv} "
                 f"on c:3 in {dt_reads:.3f} s (heat {rec['rps']} reads/s); "
                 f"one tick planned a promote of {pv} on c:3 and a demote "
                 f"of {dv}, actuator calls 0 before approval; the promote "
                 f"approved: /admin/volume/unconvert in {dt_promote:.3f} s "
                 f"(K1 {rebuild_k1} == phase 6's), .dat sha256 == phase "
                 f"3's, b:2's remnants retired; the demote approved and "
                 f"enqueued sealed, the next convert tick K2 {demote_k2} "
                 f"for {units} unit(s); both plans done with trace ids; "
                 f"one background round: loops {sorted(lp['loops'])}, no "
                 f"error; {len(st['volumes'])} volumes healthy; "
                 f"/cluster/geo with no sync direction; K1 0")
    finally:
        for vs in servers.values():
            vrun(vs.stop())
        if master is not None:
            mrun(master.stop())
        stop_loops(loops)
        client.close()
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "steps": steps, "counts": counts,
           "s": time.perf_counter() - t_phase}
    hlog(f"launches per step {counts}; phase wall {out['s']:.1f} s")
    return out


# phase 23's cluster: the port's shell and client driving three card
# servers in three racks behind the port's master.
SHELL_NODES = (("A", "dc1", "r1"), ("B", "dc1", "r2"), ("C", "dc1", "r3"))
SHELL_VID = 231  # the phase-3 volume's link, encoded by the shell
SHELL_COLLECTION = "p23"
SHELL_NEEDLES = 512  # step 1's uploads, log-uniform sizes
SHELL_MIN_SIZE = 1 << 10
SHELL_MAX_SIZE = 256 << 10
SHELL_THREADS = 16
SHELL_V_READS = 64  # step 4's needles of V, on its lost data shards
SHELL_W_LOST = (1,)  # step 4's lost data shard of W
SHELL_READ_ONLY = ("volume.list", "cluster.status", "cluster.ps",
                   "ec.codecs -json", "maintenance.status -json",
                   "cluster.autopilot -json", "chaos.status -json")


class ThreeRacks:
    """Phases 23-29's cluster, up from the first one's start to the last
    one's end: the port's `MasterServer` on a loop thread of its
    own (repair loop, aggregator loop and canary off, no vacuum scan)
    and a `VolumeServer` on the card for each of SHELL_NODES, one rack
    each, on another loop thread, beating every 0.5 s, scrubbers and
    hedging off; the shell's `CommandEnv` and an HTTP client drive them.
    On the way out it stops them and holds that no client's
    /cluster/stream thread outlived the master."""

    def __init__(self, vdir: str, device=None):
        self.work = os.path.join(vdir, "racks")
        self.names = [n for n, _, _ in SHELL_NODES]
        self.device = device
        self.loops: list = []
        self.servers: dict = {}
        self.master = None
        self.http = None
        self.env = scoped_env(
            WEEDTPU_REPAIR_INTERVAL="0", WEEDTPU_AGG_INTERVAL="0",
            WEEDTPU_CANARY_INTERVAL="0", WEEDTPU_SCRUB_MBPS="0",
            WEEDTPU_HEDGE_PCT="0")

    def __enter__(self):
        from seaweedfs_tpu_torch.server import volume_server as vsmod
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.shell import commands as shell
        from seaweedfs_tpu_torch.utils import http
        self.env.__enter__()
        try:
            self.mrun = loop_thread(self.loops)
            self.vrun = loop_thread(self.loops)
            self.http = http.PooledHTTP(timeout=600.0, max_idle_per_host=8)
            self.master = MasterServer("127.0.0.1", free_port())
            self.master.vacuum_enabled = False
            self.mrun(self.master.start())
            for name, dc, rack in SHELL_NODES:
                d = os.path.join(self.work, name)
                os.makedirs(d)
                vs = vsmod.VolumeServer(
                    [d], self.master.url, "127.0.0.1", free_port(),
                    data_center=dc, rack=rack, heartbeat_interval=0.5,
                    device=self.device)
                self.vrun(vs.start())
                self.servers[name] = vs
                if vs.scrubber is not None:
                    raise AssertionError(f"server {name} started a "
                                         f"scrubber")
            self.url = {n: self.servers[n].url for n in self.names}
            self.node_of = {u: n for n, u in self.url.items()}
            self.cmd_env = shell.CommandEnv(self.master.url)
            until(lambda: len(self.topo()["nodes"]) == len(self.names),
                  "the servers never registered")
        except BaseException:
            self._stop()
            raise
        return self

    def __exit__(self, *exc) -> None:
        self._stop()
        stream = [th for th in threading.enumerate()
                  if th.name == "weed-vidmap-stream"]
        for th in stream:
            th.join(5)
        if exc[0] is None and any(th.is_alive() for th in stream):
            raise AssertionError("a client's stream thread outlived its "
                                 "master")

    def _stop(self) -> None:
        try:
            for vs in self.servers.values():
                self.vrun(vs.stop())
            if self.master is not None:
                self.mrun(self.master.stop())
        finally:
            stop_loops(self.loops)
            if self.http is not None:
                self.http.close()
            shutil.rmtree(self.work, ignore_errors=True)
            self.env.__exit__(None, None, None)

    def admin(self, name: str, path: str, body: dict) -> dict:
        """POST `body` to server `name`'s `path`; its JSON answer."""
        st, _, raw = self.http.request(
            f"http://{self.servers[name].url}{path}", method="POST",
            body=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        if st != 200:
            raise AssertionError(f"{name}{path}: HTTP {st} {raw[:300]!r}")
        return json.loads(raw) if raw else {}

    def run(self, line: str) -> str:
        """One line through the port's shell, which raises on a failed
        command; returns what it printed."""
        import io
        from seaweedfs_tpu_torch.shell import commands as shell
        buf = io.StringIO()
        rc = shell.run_command(self.cmd_env, line, buf)
        if rc:
            raise AssertionError(f"shell {line!r} exited {rc}: "
                                 f"{buf.getvalue()[-500:]}")
        return buf.getvalue()

    def split(self, vid: int) -> dict:
        return master_split(self.http, self.master.url, vid)

    def topo(self) -> dict:
        return self.cmd_env.topology()

    def holder_of(self, vid: int) -> str:
        """The node holding the normal volume `vid`."""
        return next(n for n in self.names
                    if self.servers[n].store.get_volume(vid) is not None)

    def base_of(self, name: str, vid: int, collection: str = "") -> str:
        return self.servers[name].store.locations[0].base_path(
            vid, collection)


def phase_shell(racks: ThreeRacks, server_src: str, expect: dict,
                blob: bytes, hashes: list[str], aux_hashes: dict,
                encode_k1: int, rebuild_k1: int, seed: int,
                launches: dict) -> dict:
    """Phase 23: the port's own client and shell (ROADMAP 1.19a) driving
    `racks`, three port `VolumeServer`s on the card in three racks
    behind the port's `MasterServer`.  Steps: (1) the
    port's `WeedClient` (on the /cluster/stream feed) uploads 512
    needles of log-uniform 1-256 KiB into collection p23 from 16 threads
    and reads each back, K1 0; (2) a link of the phase-3 volume mounted
    as V on A, `lock` and `ec.encode -volumeId V`: K1 == phase 4's, the
    placement `balanced_ec_distribution`'s, every shard's sha256 phase
    4's; (3) `ec.encode -collection p23 -fullPercent 0 -quietFor 0s`
    after a beat reports every p23 volume's size: the printed list is
    every p23 volume, K1 == the layout's units of their .dat; (4)
    shards 0/3/10/12 of V and 1 of one p23 volume W deleted, 64 of V's
    needles on its lost data shards and every needle of W read through
    the client, K1 one per needle on a lost data shard; (5) `ec.rebuild`:
    K1 == phase 6's for V plus W's rebuild chunks, V's rebuilt shards
    sha256 == phase 4's; (6) the read-only commands, every EC volume
    healthy in `maintenance.status`, K1 0; (7) `ec.decode -volumeId W`
    and `unlock`: W's .dat sha256 == step 3's record, its needles read
    back, K1 0; (8) `python -m seaweedfs_tpu_torch shell -c
    volume.list` as a child process prints what the shell prints in
    process, K1 0.  K2 0 throughout."""
    import numpy as np
    from seaweedfs_tpu_torch.client import WeedClient
    from seaweedfs_tpu_torch.shell import commands as shell
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    from seaweedfs_tpu_torch.utils import resilience

    card = card_name_power()

    def plog(msg: str) -> None:
        log(f"[shell] {msg} [{card}]")

    names, servers, url = racks.names, racks.servers, racks.url
    node_of, cmd_env, master = racks.node_of, racks.cmd_env, racks.master
    admin, run, split, topo = racks.admin, racks.run, racks.split, racks.topo
    holder_of, base_of = racks.holder_of, racks.base_of
    steps: dict = {}
    counts: dict = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 23)

    def step_counts(name: str, k0: dict, k1: int) -> None:
        got = {k: launches[k] - k0[k] for k in launches}
        counts[name] = got
        want = {"gf_apply": k1, "gf_apply_batch": 0}
        if got != want:
            raise AssertionError(f"phase 23 {name}: launched {got}, "
                                 f"predicted {want}")

    client = WeedClient(master.url, stream_updates=True)
    try:
        # 1 the client writes into p23 from 16 threads, then reads
        k0 = dict(launches)
        sizes = np.exp(rng.uniform(np.log(SHELL_MIN_SIZE),
                                   np.log(SHELL_MAX_SIZE),
                                   SHELL_NEEDLES)).astype(int).tolist()
        payload = rng.bytes(sum(sizes))
        ends = np.cumsum(sizes).tolist()
        spans = list(zip([0] + ends[:-1], ends))
        fids: list = [None] * SHELL_NEEDLES

        def put(i: int) -> None:
            lo, hi = spans[i]
            fids[i] = client.upload(payload[lo:hi],
                                    collection=SHELL_COLLECTION)

        def get(i: int) -> None:
            lo, hi = spans[i]
            if client.download(fids[i]) != payload[lo:hi]:
                raise AssertionError(f"read of {fids[i]} differs")
        dt_put = fan(put, list(range(SHELL_NEEDLES)), SHELL_THREADS)
        dt_get = fan(get, list(range(SHELL_NEEDLES)), SHELL_THREADS)
        step_counts("1 client", k0, 0)
        by_vid: dict = {}
        for i, fid in enumerate(fids):
            f = t.FileId.parse(fid)
            by_vid.setdefault(f.volume_id, {})[f.key] = (f.cookie, i)
        written = sorted(by_vid)
        steps["1 client"] = {"needles": SHELL_NEEDLES,
                             "bytes": sum(sizes), "volumes": written,
                             "writes_per_s": SHELL_NEEDLES / dt_put,
                             "reads_per_s": SHELL_NEEDLES / dt_get,
                             "stream_live": client._stream_live}
        plog(f"1 client: {SHELL_NEEDLES} needles ({sum(sizes)} B, "
             f"log-uniform {SHELL_MIN_SIZE}-{SHELL_MAX_SIZE} B) into "
             f"{SHELL_COLLECTION} volumes {written} at "
             f"{SHELL_NEEDLES / dt_put:.1f} writes/s and back, equal, "
             f"at {SHELL_NEEDLES / dt_get:.1f} reads/s from "
             f"{SHELL_THREADS} threads; stream live "
             f"{client._stream_live}; K1 0")

        # 2 the full-size encode through the shell: a link of the
        # phase-3 volume mounted as V on A
        v = SHELL_VID
        base_v = base_of("A", v)
        for ext in (".dat", ".idx"):
            os.link(server_src + ext, base_v + ext)
        admin("A", "/admin/volume/mount", {"volume": v})
        until(lambda: cmd_env.volume_locations(v) == [url["A"]],
              "the master never saw V")
        k0 = dict(launches)
        run("lock")
        t0 = time.perf_counter()
        out2 = run(f"ec.encode -volumeId {v}")
        dt_enc = time.perf_counter() - t0
        step_counts("2 encode", k0, encode_k1)
        racks = {url[n]: f"{dc}/{rack}" for n, dc, rack in SHELL_NODES}
        want = {u: s for u, s in shell.balanced_ec_distribution(
            sorted(url.values()), racks).items() if s}
        got = until(lambda: (lambda s: s if s == want else None)(
            split(v)), f"V's placement never became {want}: "
            f"{split(v)}")
        for u, shards in got.items():
            b = base_of(node_of[u], v)
            for i, h in zip(shards, sha256_many(
                    [b + layout.to_ext(i) for i in shards])):
                if h != hashes[i]:
                    raise AssertionError(f"V's shard {i} on "
                                         f"{node_of[u]} differs from "
                                         f"phase 4's")
            if sha256(b + ".ecx") != aux_hashes[".ecx"]:
                raise AssertionError(f"V's .ecx on {node_of[u]} "
                                     f"differs from phase 4's")
        if sha256(base_v + ".vif") != aux_hashes[".vif"] or \
                os.path.exists(base_v + ".dat"):
            raise AssertionError("V's .vif differs from phase 4's, or "
                                 "its .dat is still on A")
        moved = sum(len(s) for u, s in got.items() if u != url["A"])
        shard_size = os.path.getsize(base_v + layout.to_ext(
            got[url["A"]][0]))
        steps["2 encode"] = {"s": dt_enc, "placement": {
            node_of[u]: s for u, s in got.items()},
            "moved_bytes": moved * shard_size}
        plog(f"2 encode: `ec.encode -volumeId {v}` of the "
             f"{os.path.getsize(server_src + '.dat')} B volume in "
             f"{dt_enc:.3f} s: placement "
             f"{ {node_of[u]: s for u, s in got.items()} } == "
             f"balanced_ec_distribution's, {moved} shards "
             f"({moved * shard_size} B) copied; every shard and .ecx "
             f"sha256 == phase 4's; K1 {encode_k1} == phase 4's")

        # 3 the auto-selection, after a beat reports every p23
        # volume's size
        vols = {vid: servers[holder_of(vid)].store.get_volume(vid)
                for vid in written}
        for vol in vols.values():
            vol.flush()
        dat_size = {vid: vol.data_size() for vid, vol in vols.items()}

        def p23_view() -> dict:
            return {vi["id"]: vi["size"]
                    for nd in topo()["nodes"].values()
                    for vi in nd["volume_infos"]
                    if vi["collection"] == SHELL_COLLECTION}
        p23 = until(lambda: (lambda seen: seen if all(
            seen.get(vid) == n for vid, n in dat_size.items())
            else None)(p23_view()),
            f"no beat reported the p23 sizes {dat_size}")
        dat_hash = {vid: sha256(base_of(holder_of(vid), vid,
                                        SHELL_COLLECTION) + ".dat")
                    for vid in written}
        k0 = dict(launches)
        t0 = time.perf_counter()
        out3 = run(f"ec.encode -collection {SHELL_COLLECTION} "
                   f"-fullPercent 0 -quietFor 0s")
        dt_auto = time.perf_counter() - t0
        listed = json.loads(out3.splitlines()[0].split(": ", 1)[1])
        if listed != sorted(p23) or not set(written) <= set(listed):
            raise AssertionError(f"ec.encode selected {listed}; the "
                                 f"p23 volumes are {sorted(p23)}, "
                                 f"{written} with needles")
        units = {vid: predict_units(p23[vid], layout.LARGE_BLOCK_SIZE,
                                    layout.SMALL_BLOCK_SIZE)
                 for vid in listed}
        step_counts("3 auto", k0, sum(units.values()))
        until(lambda: all(sum(map(len, split(vid).values())) == 14
                          for vid in listed),
              "the p23 shard sets never reached the master")
        steps["3 auto"] = {"s": dt_auto, "volumes": listed,
                           "dat_bytes": p23, "units": units}
        plog(f"3 auto: `ec.encode -collection {SHELL_COLLECTION} "
             f"-fullPercent 0 -quietFor 0s` selected {listed} (every "
             f"p23 volume; .dat {[p23[vid] for vid in listed]} B) and "
             f"encoded them in {dt_auto:.3f} s; K1 "
             f"{sum(units.values())} == the layout's units")

        # 4 degraded reads through the client
        w = max(written, key=lambda vid: (len(by_vid[vid]), vid))
        v_split, w_split = split(v), split(w)
        for u, shards in v_split.items():
            lost_here = [s for s in SERVER_LOSSES if s in shards]
            if lost_here:
                admin(node_of[u], "/admin/ec/delete_shards",
                      {"volume": v, "shards": lost_here})
        for u, shards in w_split.items():
            lost_here = [s for s in SHELL_W_LOST if s in shards]
            if lost_here:
                admin(node_of[u], "/admin/ec/delete_shards",
                      {"volume": w, "shards": lost_here})
        until(lambda: not any(
            set(SERVER_LOSSES) & set(s) for s in split(v).values()) and
            not any(set(SHELL_W_LOST) & set(s)
                    for s in split(w).values()),
            "the master still shows the deleted shards")
        ev_v = next(servers[n].store.get_ec_volume(v) for n in names
                    if servers[n].store.get_ec_volume(v) is not None)
        ev_w = next(servers[n].store.get_ec_volume(w) for n in names
                    if servers[n].store.get_ec_volume(w) is not None)
        touching_v = touching_needles(ev_v, expect, SERVER_LOSSES)
        drawn = sorted(np.random.default_rng(seed + 231).choice(
            touching_v, size=min(SHELL_V_READS, len(touching_v)),
            replace=False).tolist())
        expect_w = {key: None for key in by_vid[w]}
        touching_w = touching_needles(ev_w, expect_w, SHELL_W_LOST)
        resilience.reset_latency_trackers()
        resilience.reset_breakers()

        def get_v(nid: int) -> None:
            cookie, lo, hi = expect[nid]
            if client.download(str(t.FileId(v, nid, cookie))) != \
                    blob[lo:hi]:
                raise AssertionError(f"degraded read of V/{nid} "
                                     f"differs")

        def get_w(key: int) -> None:
            cookie, i = by_vid[w][key]
            lo, hi = spans[i]
            if client.download(str(t.FileId(w, key, cookie))) != \
                    payload[lo:hi]:
                raise AssertionError(f"degraded read of W/{key} "
                                     f"differs")
        k0 = dict(launches)
        dt_v = fan(get_v, drawn, SHELL_THREADS)
        dt_w = fan(get_w, sorted(by_vid[w]), SHELL_THREADS)
        step_counts("4 degraded", k0, len(drawn) + len(touching_w))
        steps["4 degraded"] = {
            "w": w, "v_reads": len(drawn), "v_s": dt_v,
            "w_reads": len(by_vid[w]), "w_touching": len(touching_w),
            "w_s": dt_w}
        plog(f"4 degraded: V lost {list(SERVER_LOSSES)}, W = {w} lost "
             f"{list(SHELL_W_LOST)}; {len(drawn)} of V's "
             f"{len(touching_v)} needles on lost data shards in "
             f"{dt_v:.3f} s and all {len(by_vid[w])} of W's "
             f"({len(touching_w)} on shard 1) in {dt_w:.3f} s through "
             f"the client, equal; K1 {len(drawn) + len(touching_w)} "
             f"== one per needle on a lost data shard")

        # 5 ec.rebuild: V's phase-5 loss and W's shard
        w_node, w_shards = next(iter(split(w).items()))
        w_base = base_of(node_of[w_node], w, SHELL_COLLECTION)
        w_chunks = -(-os.path.getsize(
            w_base + layout.to_ext(w_shards[0]))
            // ec_files.DEFAULT_BATCH)
        k0 = dict(launches)
        t0 = time.perf_counter()
        out5 = run("ec.rebuild")
        dt_reb = time.perf_counter() - t0
        step_counts("5 rebuild", k0, rebuild_k1 + w_chunks)
        rebuilt = {int(m.group(1)): (json.loads(m.group(2)),
                                      m.group(3))
                   for m in re.finditer(
                       r"^volume (\d+): rebuilt (\[[^]]*\]) on (\S+)$",
                       out5, re.M)}
        if sorted(rebuilt) != sorted({v, w}) or \
                rebuilt[v][0] != list(SERVER_LOSSES) or \
                rebuilt[w][0] != list(SHELL_W_LOST):
            raise AssertionError(f"ec.rebuild printed {out5!r}")
        rb = base_of(node_of[rebuilt[v][1]], v)
        for i, h in zip(SERVER_LOSSES, sha256_many(
                [rb + layout.to_ext(i) for i in SERVER_LOSSES])):
            if h != hashes[i]:
                raise AssertionError(f"V's rebuilt shard {i} differs "
                                     f"from phase 4's")
        until(lambda: all(sum(map(len, split(vid).values())) == 14
                          for vid in (v, w)),
              "the rebuilt shards never reached the master")
        steps["5 rebuild"] = {"s": dt_reb, "w_chunks": w_chunks,
                              "rebuilders": {str(k): node_of[r]
                                             for k, (_, r) in
                                             rebuilt.items()}}
        plog(f"5 rebuild: `ec.rebuild` rebuilt V's "
             f"{list(SERVER_LOSSES)} on {node_of[rebuilt[v][1]]} "
             f"(sha256 == phase 4's) and W's {list(SHELL_W_LOST)} on "
             f"{node_of[rebuilt[w][1]]} in {dt_reb:.3f} s; K1 "
             f"{rebuild_k1 + w_chunks} == phase 6's {rebuild_k1} + "
             f"W's {w_chunks} chunk(s)")

        # 6 the read-only commands
        k0 = dict(launches)
        t0 = time.perf_counter()
        printed = {line: run(line) for line in SHELL_READ_ONLY}
        dt_ro = time.perf_counter() - t0
        step_counts("6 read-only", k0, 0)
        st = json.loads(printed["maintenance.status -json"])
        ec_vols = {vid: rec for vid, rec in st["volumes"].items()
                   if rec.get("kind") == "ec"}
        if sorted(map(int, ec_vols)) != sorted(written + [v]) or \
                any(rec["state"] != "healthy"
                    for rec in ec_vols.values()):
            raise AssertionError(f"maintenance.status: "
                                 f"{ {k: r.get('state') for k, r in st['volumes'].items()} }")
        codecs_seen = json.loads(printed["ec.codecs -json"])
        steps["6 read-only"] = {"s": dt_ro, "ec_volumes": len(ec_vols),
                                "mix": codecs_seen["mix"]}
        plog(f"6 read-only: {', '.join(SHELL_READ_ONLY)} exited 0 in "
             f"{dt_ro:.3f} s; maintenance.status: {len(ec_vols)} EC "
             f"volumes, every one healthy; ec.codecs mix "
             f"{codecs_seen['mix']}; K1 0")

        # 7 ec.decode of W, then unlock
        k0 = dict(launches)
        t0 = time.perf_counter()
        out7 = run(f"ec.decode -volumeId {w}")
        dt_dec = time.perf_counter() - t0
        run("unlock")
        collector = node_of[out7.split(" on ")[-1].strip()]
        if sha256(base_of(collector, w, SHELL_COLLECTION) + ".dat") != \
                dat_hash[w]:
            raise AssertionError("W's decoded .dat differs from step "
                                 "3's record")
        until(lambda: cmd_env.volume_locations(w) == [url[collector]]
              and not split(w), "the decoded W never reached the "
              "master")
        dt_wr = fan(get_w, sorted(by_vid[w]), SHELL_THREADS)
        step_counts("7 decode", k0, 0)
        steps["7 decode"] = {"s": dt_dec, "collector": collector,
                             "reads_s": dt_wr}
        plog(f"7 decode: `ec.decode -volumeId {w}` on {collector} in "
             f"{dt_dec:.3f} s, .dat sha256 == step 3's record; its "
             f"{len(by_vid[w])} needles read back in {dt_wr:.3f} s; "
             f"unlocked; K1 0")

        # 8 the CLI's shell as a child process
        k0 = dict(launches)
        want_list = run("volume.list")
        here = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "shell",
             "-master", master.url, "-c", "volume.list"],
            cwd=here, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=here))
        dt_cli = time.perf_counter() - t0
        if child.returncode != 0 or child.stdout != want_list:
            raise AssertionError(f"the CLI shell exited "
                                 f"{child.returncode}: "
                                 f"{child.stdout[-500:]!r} "
                                 f"{child.stderr[-1500:]}")
        step_counts("8 cli", k0, 0)
        steps["8 cli"] = {"s": dt_cli}
        plog(f"8 cli: `python -m seaweedfs_tpu_torch shell -c "
             f"volume.list` exited 0 in {dt_cli:.3f} s and printed "
             f"what the shell prints in process "
             f"({len(want_list.splitlines())} lines); K1 0")
    finally:
        client.close()
    out = {"card": card, "steps": steps, "counts": counts,
           "s": time.perf_counter() - t_phase}
    plog(f"launches per step {counts}; phase wall {out['s']:.1f} s")
    return out


# phase 24's filer (ROADMAP 1.20a): the port's Filer over its LogStore,
# its chunks on phase 23's layout of three card servers in three racks.
FILER_COLLECTION = "p24"
FILER_BYTES = 128 * MIB  # the tree's files, from --seed (cut from 256, PERF §4)
FILER_MIN_SIZE = 1 << 10
FILER_MAX_SIZE = 32 * MIB
FILER_CHUNK = 4 * MIB  # the reference filer's -maxMB default
FILER_APPENDS = 48  # the appended file: one chunk per append
FILER_APPEND_SIZE = 512 << 10
FILER_MANIFEST_BATCH = 16  # cut from MANIFEST_BATCH's 10000 (PERF §4)
FILER_LOST = (0, 3)  # step 3's lost data shards of every p24 EC volume
FILER_CACHE_MEM = 32 * MIB  # the filer server's chunk_cache_mem default
FILER_CACHE_DISK = 1 << 30
FILER_ORACLE = 8  # step 4's sealed chunks opened by `cryptography`
FILER_THREADS = 16


def phase_filer(racks: ThreeRacks, vdir: str, seed: int,
                launches: dict) -> dict:
    """Phase 24: the port's filer without its server (ROADMAP 1.20a) over
    `racks`, phase 23's three port `VolumeServer`s on the card in three
    racks behind the port's `MasterServer`, kept up for it.  The
    `Filer` keeps its entries in a `LogStore` in the phase's directory;
    its `on_delete_chunks` feeds a `DeletionQueue` on the port's
    `WeedClient`, which resolves manifests; reads go through a
    `ChunkCache` of the filer server's 32 MiB memory tier and a disk
    tier.  Steps: (1) 128 MiB of files from --seed (1 KiB-32 MiB,
    log-uniform) under /p24/plain and /p24/enc, cut into 4 MiB chunks
    and uploaded by the client into collection p24 from 16 threads,
    every chunk under /p24/enc sealed by the port's cipher with its key
    in the chunk; a file of 48 appended chunks manifestized at a batch
    of 16, a middle range of a plain file overwritten, a plain file
    hard-linked under /p24/enc, a subtree of /p24/enc renamed; K1 0;
    (2) `ec.encode -collection p24` through the port's shell, K1 == the
    layout's units of the p24 .dat files; (3) data shards 0 and 3 of
    every p24 EC volume deleted, K1 0; (4) every file read in full
    through `ChunkGroup.read_views`, `WeedClient.download` and
    `decrypt`, sha256 == its draw, K1 one per chunk read whose needle
    touches a lost data shard, a sample of sealed chunks opened by
    `cryptography`'s AESGCM; (5) every file again, every chunk read a
    cache hit, K1 0; (6) `delete_entry("/p24/plain", recursive=True)`:
    once the queue drains every freed fid (the manifests' inner fids
    too) answers 404 on every holder, and every /p24/enc file read
    without the cache is still equal, K1 one per manifest and /p24/enc
    chunk on a lost data shard; (7) the LogStore reopened: the same
    `subtree_digest("/p24")`, K1 0.  K2 0 throughout."""
    import hashlib

    import numpy as np
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    from seaweedfs_tpu_torch.client import WeedClient
    from seaweedfs_tpu_torch.filer import filechunk_manifest as fcm
    from seaweedfs_tpu_torch.filer.entry import Attr, Entry, FileChunk
    from seaweedfs_tpu_torch.filer.filechunk_section import ChunkGroup
    from seaweedfs_tpu_torch.filer.filer import Filer
    from seaweedfs_tpu_torch.filer.filer_deletion import DeletionQueue
    from seaweedfs_tpu_torch.filer.stores_extra import LogStore
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout
    from seaweedfs_tpu_torch.utils import cipher, resilience
    from seaweedfs_tpu_torch.utils.chunk_cache import ChunkCache

    card = card_name_power()

    def flog(msg: str) -> None:
        log(f"[filer] {msg} [{card}]")

    work = os.path.join(vdir, "filer")
    os.makedirs(work)
    store_dir = os.path.join(work, "logstore")
    names, servers = racks.names, racks.servers
    node_of, master, http_client = racks.node_of, racks.master, racks.http
    admin, run, split, topo = racks.admin, racks.run, racks.split, racks.topo
    holder_of = racks.holder_of
    client = queue = store = None
    steps: dict = {}
    counts: dict = {}
    predicted: dict = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 24)

    def step_counts(name: str, k0: dict, k1: int, t0: float) -> None:
        got = {k: launches[k] - k0[k] for k in launches}
        counts[name] = got
        predicted[name] = k1
        steps.setdefault(name, {})["wall_s"] = time.perf_counter() - t0
        want = {"gf_apply": k1, "gf_apply_batch": 0}
        if got != want:
            raise AssertionError(f"phase 24 {name}: launched {got}, "
                                 f"predicted {want}")

    def empty_lrus() -> None:
        """No server's reconstruction LRU answers a read this step
        predicts a launch for."""
        for vs in servers.values():
            for loc in vs.store.locations:
                for ev in list(loc.ec_volumes.values()):
                    with ev._recon_lock:
                        ev._recon_cache.clear()
                        ev._recon_cache_bytes = 0

    try:
        # 0 set-up: the client, the filer over its LogStore, the queue,
        # the cache
        client = WeedClient(master.url)
        queue = DeletionQueue(
            client, interval=0.05,
            resolve_manifest=lambda cs: fcm.resolve_chunk_manifest(
                client.download, cs, include_manifests=True))
        queue.start()
        store = LogStore(store_dir)
        filer = Filer(store, on_delete_chunks=queue.enqueue_chunks)
        cache = ChunkCache(mem_limit=FILER_CACHE_MEM,
                           disk_dir=os.path.join(work, "cache"),
                           disk_limit=FILER_CACHE_DISK)

        # 1 the tree: sizes and bytes from the seed, a file every
        # other one under /p24/enc (sealed), the rest under
        # /p24/plain, in four directories each
        t0 = time.perf_counter()
        k0 = dict(launches)
        budget = FILER_BYTES - FILER_APPENDS * FILER_APPEND_SIZE
        sizes: list = []
        while sum(sizes) < budget:
            sizes.append(min(int(np.exp(rng.uniform(
                np.log(FILER_MIN_SIZE), np.log(FILER_MAX_SIZE)))),
                budget - sum(sizes)))
        if sizes[-1] < FILER_MIN_SIZE:  # the remainder joins the last
            sizes[-2] += sizes.pop()
        payload = rng.bytes(FILER_BYTES)
        mv = memoryview(payload)
        content: dict = {}  # path -> the file's bytes
        plan: list = []  # (path, enc) of the drawn files
        at = 0
        for i, size in enumerate(sizes):
            kind = "enc" if i % 2 else "plain"
            path = f"/p24/{kind}/d{i // 2 % 4}/f{i:03d}"
            content[path] = mv[at:at + size]
            plan.append((path, kind == "enc"))
            at += size
        log_path = "/p24/plain/log/appended"
        content[log_path] = mv[at:at + FILER_APPENDS * FILER_APPEND_SIZE]
        pieces = [(path, off, enc) for path, enc in plan
                  for off in range(0, len(content[path]), FILER_CHUNK)]
        pieces += [(log_path, off, False) for off in range(
            0, FILER_APPENDS * FILER_APPEND_SIZE, FILER_APPEND_SIZE)]
        made: dict = {}  # (path, offset) -> FileChunk
        sealed_of: dict = {}  # fid -> (path, offset): the sealed ones

        def upload(piece) -> None:
            path, off, enc = piece
            step = FILER_APPEND_SIZE if path == log_path \
                else FILER_CHUNK
            data = bytes(content[path][off:off + step])
            key = b""
            stored = data
            if enc:
                key, stored = cipher.encrypt(data)
            fid = client.upload(stored, collection=FILER_COLLECTION)
            made[(path, off)] = FileChunk(
                fid=fid, offset=off, size=len(data),
                mtime=time.time_ns(), etag=hashlib.md5(data).hexdigest(),
                cipher_key=key)
            if enc:
                sealed_of[fid] = (path, off)
        dt_up = fan(upload, pieces, FILER_THREADS)

        def save_manifest(data: bytes):
            fid = client.upload(data, collection=FILER_COLLECTION)
            return FileChunk(fid=fid, offset=0, size=len(data),
                             etag=hashlib.md5(data).hexdigest())

        def entry(path: str, chunks: list) -> Entry:
            return Entry(full_path=path, attr=Attr(
                mode=0o644, mime="application/octet-stream",
                file_size=len(content[path]),
                md5=hashlib.md5(content[path]).hexdigest()),
                chunks=chunks)
        for path, _ in plan:
            filer.create_entry(entry(path, sorted(
                (c for (p, _), c in made.items() if p == path),
                key=lambda c: c.offset)))
        appended = sorted((c for (p, _), c in made.items()
                           if p == log_path), key=lambda c: c.offset)
        refs = fcm.maybe_manifestize(save_manifest, appended,
                                     batch=FILER_MANIFEST_BATCH)
        manifests = [c for c in refs if c.is_chunk_manifest]
        if len(manifests) != FILER_APPENDS // FILER_MANIFEST_BATCH or \
                len(refs) != len(manifests):
            raise AssertionError(f"the appended file's refs: {refs}")
        filer.create_entry(entry(log_path, refs))
        # a middle range of the largest plain file overwritten (its
        # old chunks stay, shadowed where the new one lies)
        plains = sorted((p for p, enc in plan if not enc),
                        key=lambda p: (len(content[p]), p))
        over = plains[-1]
        size = len(content[over])
        lo, hi = size // 3, size // 3 + min(3 * MIB, size // 3)
        fresh = rng.bytes(hi - lo)
        content[over] = bytes(content[over][:lo]) + fresh + \
            bytes(content[over][hi:])
        ent = filer.find_entry(over)
        fid = client.upload(fresh, collection=FILER_COLLECTION)
        ent.chunks.append(FileChunk(fid=fid, offset=lo, size=hi - lo,
                                    mtime=time.time_ns(),
                                    etag=hashlib.md5(fresh).hexdigest()))
        ent.attr.md5 = hashlib.md5(content[over]).hexdigest()
        filer.update_entry(ent)
        # a second name under /p24/enc for the next-largest plain file
        linked = plains[-2]
        link = "/p24/enc/links/" + linked.rsplit("/", 1)[1]
        filer.link_entry(linked, link)
        content[link] = content[linked]
        # a subtree of /p24/enc renamed
        moved = {p: "/p24/enc/moved/" + p.rsplit("/", 1)[1]
                 for p in content if p.startswith("/p24/enc/d1/")}
        filer.rename_entry("/p24/enc/d1", "/p24/enc/moved")
        for old, new in moved.items():
            content[new] = content.pop(old)
        sealed_of = {fid: (moved.get(p, p), off)
                     for fid, (p, off) in sealed_of.items()}
        dt_write = time.perf_counter() - t0
        step_counts("1 write", k0, 0, t0)
        written = sum(len(c) for p, c in content.items() if p != link)
        n_chunks = len(made) + len(manifests) + 1
        steps["1 write"].update({
            "files": len(content), "bytes": written, "chunks": n_chunks,
            "upload_s": dt_up, "mbps": written / dt_write / 1e6})
        flog(f"1 write: {len(content)} files ({len(plan)} drawn, "
             f"{FILER_MIN_SIZE}-{FILER_MAX_SIZE} B log-uniform, and "
             f"{log_path} of {FILER_APPENDS} appended chunks, "
             f"{len(manifests)} manifests at a batch of "
             f"{FILER_MANIFEST_BATCH}), {written} B in {n_chunks} "
             f"chunks ({len(sealed_of)} sealed) uploaded by the client "
             f"from {FILER_THREADS} threads at "
             f"{written / dt_up / 1e6:.1f} MB/s, the tree at "
             f"{written / dt_write / 1e6:.1f} MB/s with its entries; "
             f"{over} overwritten at [{lo}, {hi}), {linked} linked as "
             f"{link}, /p24/enc/d1 renamed /p24/enc/moved; K1 0")

        # 2 ec.encode -collection p24, once a beat reports the sizes
        vids = sorted({int(c.fid.split(",")[0]) for c in
                       list(made.values()) + manifests + [
                           ent.chunks[-1]]})
        vols = {vid: servers[holder_of(vid)].store.get_volume(vid)
                for vid in vids}
        for vol in vols.values():
            vol.flush()
        dat_size = {vid: vol.data_size() for vid, vol in vols.items()}

        def p24_view() -> dict:
            return {vi["id"]: vi["size"]
                    for nd in topo()["nodes"].values()
                    for vi in nd["volume_infos"]
                    if vi["collection"] == FILER_COLLECTION}
        p24 = until(lambda: (lambda seen: seen if all(
            seen.get(vid) == n for vid, n in dat_size.items())
            else None)(p24_view()),
            f"no beat reported the p24 sizes {dat_size}")
        units = {vid: predict_units(p24[vid], layout.LARGE_BLOCK_SIZE,
                                    layout.SMALL_BLOCK_SIZE)
                 for vid in p24}
        k0 = dict(launches)
        t0 = time.perf_counter()
        run("lock")
        out2 = run(f"ec.encode -collection {FILER_COLLECTION} "
                   f"-fullPercent 0 -quietFor 0s")
        run("unlock")
        dt_enc = time.perf_counter() - t0
        listed = json.loads(out2.splitlines()[0].split(": ", 1)[1])
        if listed != sorted(p24):
            raise AssertionError(f"ec.encode selected {listed}; the "
                                 f"p24 volumes are {sorted(p24)}")
        step_counts("2 encode", k0, sum(units.values()), t0)
        until(lambda: all(sum(map(len, split(vid).values())) == 14
                          for vid in listed),
              "the p24 shard sets never reached the master")
        steps["2 encode"].update({"s": dt_enc, "volumes": listed,
                                  "dat_bytes": p24, "units": units})
        flog(f"2 encode: `ec.encode -collection {FILER_COLLECTION}` "
             f"of volumes {listed} (.dat {[p24[v] for v in listed]} B) "
             f"in {dt_enc:.3f} s; K1 {sum(units.values())} == the "
             f"layout's units")

        # 3 data shards 0 and 3 of every p24 EC volume deleted
        k0 = dict(launches)
        t0 = time.perf_counter()
        for vid in listed:
            for u, shards in split(vid).items():
                gone = [s for s in FILER_LOST if s in shards]
                if gone:
                    admin(node_of[u], "/admin/ec/delete_shards",
                          {"volume": vid, "shards": gone})
        until(lambda: not any(set(FILER_LOST) & set(s)
                              for vid in listed
                              for s in split(vid).values()),
              "the master still shows the deleted shards")
        step_counts("3 loss", k0, 0, t0)
        flog(f"3 loss: data shards {list(FILER_LOST)} of every p24 EC "
             f"volume deleted where they lived; K1 0")

        # which chunk needles touch a lost data shard, by the layout
        evs = {vid: next(servers[n].store.get_ec_volume(vid)
                         for n in names
                         if servers[n].store.get_ec_volume(vid)
                         is not None) for vid in listed}

        def touches(fid: str) -> bool:
            f = t.FileId.parse(fid)
            ev = evs[f.volume_id]
            return bool(touching_needles(ev, {f.key: None}, FILER_LOST))

        # 4 every file read in full through the views, the client
        # and the cipher, the cache filling
        flights: dict = {}
        flights_lock = threading.Lock()
        fetched: list = []
        blobs_read = [0]

        def fetch(fid: str, cached: bool = True) -> bytes:
            """One chunk blob, one download per fid at a time: from
            the cache, or the client (into the cache)."""
            with flights_lock:
                lk = flights.setdefault(fid, threading.Lock())
            with lk:
                blobs_read[0] += 1
                blob = cache.get(fid) if cached else None
                if blob is None:
                    blob = client.download(fid)
                    fetched.append(fid)
                    if cached:
                        cache.put(fid, blob)
                return blob

        def read_file(path: str, cached: bool = True) -> bytes:
            e = filer.find_entry(path)
            chunks = fcm.resolve_chunk_manifest(
                lambda f: fetch(f, cached), e.chunks)
            out = bytearray(e.size())
            for v in ChunkGroup(chunks).read_views(0, e.size()):
                blob = fetch(v.fid, cached)
                if v.cipher_key:
                    blob = cipher.decrypt(v.cipher_key, blob)
                out[v.logic_offset:v.logic_offset + v.size] = \
                    blob[v.offset_in_chunk:v.offset_in_chunk + v.size]
            return bytes(out)

        def walk(d: str) -> list:
            out = []
            for e in filer.iter_entries(d):
                out += walk(e.full_path) if e.is_directory \
                    else [e.full_path]
            return out
        tree = walk("/p24")
        if sorted(tree) != sorted(content):
            raise AssertionError(
                f"the tree lists {len(tree)} files, {len(content)} "
                f"were written: "
                f"{sorted(set(tree) ^ set(content))[:8]}")
        want_sha = {p: hashlib.sha256(c).hexdigest()
                    for p, c in content.items()}

        def needed(paths) -> set:
            """The fids reading `paths` fetches: the manifests, and
            every chunk a view of the resolved list names."""
            out = set()
            for p in paths:
                e = filer.find_entry(p)
                out |= {c.fid for c in e.chunks if c.is_chunk_manifest}
                chunks = fcm.resolve_chunk_manifest(
                    lambda f: blobs[f], e.chunks) \
                    if any(c.is_chunk_manifest for c in e.chunks) \
                    else e.chunks
                out |= {v.fid for v in ChunkGroup(chunks).read_views(
                    0, e.size())}
            return out

        def check(path: str, cached: bool = True) -> None:
            got = read_file(path, cached)
            if hashlib.sha256(got).hexdigest() != want_sha[path]:
                raise AssertionError(f"{path} differs from its draw")
        blobs = {m.fid: fcm.manifest_payload(
            appended[i * FILER_MANIFEST_BATCH:
                     (i + 1) * FILER_MANIFEST_BATCH])
            for i, m in enumerate(manifests)}
        want_fids = needed(tree)
        touching = {f for f in want_fids if touches(f)}
        empty_lrus()
        resilience.reset_latency_trackers()
        resilience.reset_breakers()
        k0 = dict(launches)
        t0 = time.perf_counter()
        dt_read = fan(check, tree, FILER_THREADS)
        if sorted(fetched) != sorted(want_fids):
            raise AssertionError(f"step 4 fetched {len(fetched)} "
                                 f"blobs, {len(set(fetched))} "
                                 f"distinct; {len(want_fids)} needed")
        step_counts("4 degraded", k0, len(touching), t0)
        oracle = sorted(set(fetched) & set(sealed_of))[:FILER_ORACLE]
        by_fid = {c.fid: c for c in made.values()}
        for fid in oracle:
            path, off = sealed_of[fid]
            blob = cache.get(fid)
            plain = AESGCM(by_fid[fid].cipher_key).decrypt(
                blob[:12], blob[12:], None)
            if plain != bytes(content[path][off:off + len(plain)]) or \
                    len(plain) != by_fid[fid].size:
                raise AssertionError(f"cryptography opens {fid} to "
                                     f"other bytes")
        steps["4 degraded"].update({
            "files": len(tree), "chunk_reads": blobs_read[0],
            "downloads": len(fetched), "touching": len(touching),
            "s": dt_read, "mbps": written / dt_read / 1e6,
            "oracle": len(oracle)})
        flog(f"4 degraded: {len(tree)} files read in full through "
             f"ChunkGroup.read_views, the client and decrypt at "
             f"{FILER_THREADS} threads, each sha256 == its draw: "
             f"{written} B in {dt_read:.3f} s, "
             f"{written / dt_read / 1e6:.1f} MB/s; {blobs_read[0]} chunk "
             f"reads, {len(fetched)} downloads ({len(manifests)} "
             f"manifests), {len(touching)} on a lost data shard; "
             f"{len(oracle)} sealed chunks opened by cryptography's "
             f"AESGCM equal; K1 {len(touching)} == one per download "
             f"touching shards {list(FILER_LOST)}")

        # 5 every file again: each chunk read a cache hit
        k0 = dict(launches)
        reads0, hits0, n0 = blobs_read[0], cache.hits, len(fetched)
        t0 = time.perf_counter()
        for path in tree:
            check(path)
        dt_cached = time.perf_counter() - t0
        reads = blobs_read[0] - reads0
        if len(fetched) != n0 or cache.hits - hits0 != reads:
            raise AssertionError(f"step 5: {len(fetched) - n0} "
                                 f"downloads, {cache.hits - hits0} "
                                 f"cache hits of {reads} chunk reads")
        step_counts("5 cached", k0, 0, t0)
        steps["5 cached"].update({
            "chunk_reads": reads, "hits": cache.hits - hits0,
            "s": dt_cached, "mbps": written / dt_cached / 1e6,
            "cache": cache.stats()})
        flog(f"5 cached: every file again, one thread, each sha256 == "
             f"its draw: {written} B in {dt_cached:.3f} s, "
             f"{written / dt_cached / 1e6:.1f} MB/s; {reads} chunk "
             f"reads, {cache.hits - hits0} cache hits, no download; "
             f"cache {cache.stats()}; K1 0")

        # 6 /p24/plain deleted: the queue frees its chunks, the
        # linked file's excepted
        enc_paths = sorted(p for p in tree if p.startswith("/p24/enc/"))
        keep = needed(enc_paths)
        freed = set()
        for p in tree:
            if p.startswith("/p24/plain/"):
                e = filer.find_entry(p)
                freed |= {c.fid for c in e.chunks} | \
                    {c.fid for c in fcm.resolve_chunk_manifest(
                        lambda f: blobs[f], e.chunks,
                        include_manifests=True)}
        freed -= keep
        enc_touching = {f for f in keep if touches(f)}
        man_touching = {m.fid for m in manifests if touches(m.fid)}
        empty_lrus()
        k0 = dict(launches)
        t0 = time.perf_counter()
        deleted0 = queue.deleted_count
        filer.delete_entry("/p24/plain", recursive=True)
        until(lambda: queue.pending_count() == 0 and
              queue.deleted_count + queue.error_count - deleted0 >=
              len(freed), "the deletion queue never drained",
              timeout=120)
        dt_drain = time.perf_counter() - t0
        if queue.error_count or \
                queue.deleted_count - deleted0 != len(freed):
            raise AssertionError(f"the queue deleted "
                                 f"{queue.deleted_count - deleted0} of "
                                 f"{len(freed)} fids, "
                                 f"{queue.error_count} errors")
        holders = {vid: sorted(split(vid)) for vid in listed}
        if any(len(h) != len(names) for h in holders.values()):
            raise AssertionError(f"the p24 volumes' holders {holders}")

        def gone(fid: str) -> None:
            for u in holders[int(fid.split(",")[0])]:
                st, _, _ = http_client.request(f"http://{u}/{fid}")
                if st != 404:
                    raise AssertionError(f"freed {fid} answers {st} "
                                         f"on {node_of[u]}")
        fan(gone, sorted(freed), FILER_THREADS)
        fetched.clear()
        dt_enc_read = fan(lambda p: check(p, cached=False), enc_paths,
                          FILER_THREADS)
        if sorted(fetched) != sorted(keep):
            raise AssertionError(f"step 6 fetched {len(fetched)} blobs "
                                 f"of /p24/enc; {len(keep)} needed")
        step_counts("6 delete", k0,
                    len(man_touching) + len(enc_touching), t0)
        digest = filer.subtree_digest("/p24")
        steps["6 delete"].update({
            "freed": len(freed), "drain_s": dt_drain,
            "enc_files": len(enc_paths), "enc_read_s": dt_enc_read,
            "manifests_touching": len(man_touching),
            "enc_touching": len(enc_touching), "digest": digest})
        flog(f"6 delete: delete_entry('/p24/plain', recursive=True); "
             f"the queue freed {len(freed)} fids ({len(manifests)} "
             f"manifests and their inner fids) in {dt_drain:.3f} s, "
             f"each 404 on every holder; {linked}'s chunks kept for "
             f"{link}; {len(enc_paths)} /p24/enc files read without "
             f"the cache at {FILER_THREADS} threads, each sha256 == its "
             f"draw, in {dt_enc_read:.3f} s; K1 "
             f"{len(man_touching) + len(enc_touching)} == "
             f"{len(man_touching)} manifests + {len(enc_touching)} "
             f"/p24/enc chunks on a lost data shard")

        # 7 the LogStore reopened
        k0 = dict(launches)
        t0 = time.perf_counter()
        store.shutdown()
        store = LogStore(store_dir)
        again = Filer(store).subtree_digest("/p24")
        if again != digest:
            raise AssertionError(f"subtree_digest after the reopen "
                                 f"{again}, before {digest}")
        step_counts("7 reopen", k0, 0, t0)
        flog(f"7 reopen: the LogStore replayed in "
             f"{time.perf_counter() - t0:.3f} s; subtree_digest('/p24')"
             f" == before ({digest[1]} lines); K1 0")
    finally:
        if queue is not None:
            queue.stop(drain=False)
        if store is not None:
            store.shutdown()
        if client is not None:
            client.close()
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "steps": steps, "counts": counts,
           "predicted": predicted, "s": time.perf_counter() - t_phase}
    flog(f"launches per step {counts} (K1 predicted {predicted}); phase "
         f"wall {out['s']:.1f} s")
    return out


# phase 25's filer server (ROADMAP 1.20b): two port FilerServers over one
# SQLite store, reading their chunks from phase 23's card servers.
FS_COLLECTION = "p25"
FS_BYTES = 128 * MIB  # the tree's files, from --seed (cut from 256, PERF §4)
FS_MIN_SIZE = 1 << 10
FS_MAX_SIZE = 32 * MIB
FS_CACHE_MEM = 512 * MIB  # each filer's: no chunk evicted in the phase
FS_PATCH = 1 * MIB  # step 1's ranged write into the largest plain file
FS_LOST = (0, 3)  # step 3's lost data shards of every p25 EC volume
FS_COLD = 8  # step 7's files read through the restarted A
FS_THREADS = 16


def phase_filer_server(racks: ThreeRacks, vdir: str, seed: int,
                       launches: dict) -> dict:
    """Phase 25: the port's filer server (ROADMAP 1.20b) over `racks`,
    phase 23's three port `VolumeServer`s on the card in three racks
    behind the port's `MasterServer`, kept up for it.  Two port
    `FilerServer`s, A and B (B sealing its chunks with the port's
    cipher), each on a loop thread of its own with a 512 MiB chunk cache
    and the default 4 MiB chunks, share one SQLite store in the phase's
    directory; the hot tier is on and both rings hold both filers before
    step 1.  A has the lower port, so the shell's `find_filer` picks it.
    Steps: (1) /p25 made through A, then 128 MiB of files from --seed
    (1 KiB-32 MiB, log-uniform) PUT from 16 threads into collection p25:
    /p25/plain through A, every fourth of them text/plain over 16
    letters (gzipped), /p25/enc through B (sealed); a 1 MiB PATCH into
    the largest binary plain file, the next one truncated to half and
    /p25/plain/d3 moved to /p25/plain/moved through A, A's deletion
    queue drained of the chunks they dropped; K1 0; (2) `ec.encode
    -collection p25` through the port's shell, K1 == the layout's units
    of the p25 .dat files; (3) data shards 0 and 3 of every p25 EC
    volume deleted, K1 0; (4) every file read in full from 16 threads,
    alternating A and B, sha256 == its draw: summed `direct` == the
    distinct chunks read (the hot tier sends each to the volume tier
    once), `route_in` and `route_out` > 0, `route_fail` 0, K1 == those
    fetches whose needle touches a lost data shard; (5) one Range GET
    per file through the other filer and a HEAD, each equal to the
    draw's slice and size: `direct` and K1 0, and the master's
    /cluster/perf `hot_tier` block the sum of A's and B's events with
    its `hit_ratio` from them; (6) through the port's shell `fs.ls -l
    /p25/plain`, `fs.du /p25` (the draw's bytes), `fs.verify` of every
    /p25/enc file (0 missing; its HEADs decode: K1 == the /p25/enc
    chunks on a lost data shard), `fs.meta.save` of /p25 and `fs.rm -r
    /p25/plain`: once A's deletion queue drains, every freed fid
    answers 404 on every holder; (7) A's /__meta__/subscribe from the
    phase's start replays every create, update, move and delete A made,
    in order; /__meta__/digest of /p25 equal on A and B; A stopped and
    started again on the same directory and port: the same digest, and
    8 /p25/enc files read through it with a cold cache equal to their
    draws, K1 == their chunks homed on A that touch a lost data shard
    (those homed on B come from B's cache).  K2 0 throughout."""
    import hashlib

    import numpy as np
    from seaweedfs_tpu_torch.filer.filechunk_section import ChunkGroup
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout
    from seaweedfs_tpu_torch.utils import http, resilience

    card = card_name_power()

    def plog(msg: str) -> None:
        log(f"[filer-server] {msg} [{card}]")

    work = os.path.join(vdir, "filer_server")
    os.makedirs(work)
    data_dir = os.path.join(work, "shared")
    names, servers = racks.names, racks.servers
    node_of, master = racks.node_of, racks.master
    admin, run, split, topo = racks.admin, racks.run, racks.split, racks.topo
    holder_of = racks.holder_of
    loops: list = []
    filers: dict = {}
    runs: dict = {}
    pool = None
    steps: dict = {}
    counts: dict = {}
    predicted: dict = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 25)

    def step_counts(name: str, k0: dict, k1: int, t0: float) -> None:
        got = {k: launches[k] - k0[k] for k in launches}
        counts[name] = got
        predicted[name] = k1
        steps.setdefault(name, {})["wall_s"] = time.perf_counter() - t0
        want = {"gf_apply": k1, "gf_apply_batch": 0}
        if got != want:
            raise AssertionError(f"phase 25 {name}: launched {got}, "
                                 f"predicted {want}")

    def empty_lrus() -> None:
        """No server's reconstruction LRU answers a read this step
        predicts a launch for."""
        for vs in servers.values():
            for loc in vs.store.locations:
                for ev in list(loc.ec_volumes.values()):
                    with ev._recon_lock:
                        ev._recon_cache.clear()
                        ev._recon_cache_bytes = 0

    def events() -> dict:
        return {n: dict(f.hot_stats) for n, f in filers.items()}

    def delta(before: dict) -> dict:
        now = events()
        return {k: sum(now[n][k] - before[n][k] for n in now)
                for k in now["A"]}

    def call(name: str, path: str, method: str = "GET", body=None,
             headers=None) -> tuple:
        return pool.request(f"http://{filers[name].url}{path}", method,
                            body, headers)

    def members() -> list:
        return racks.cmd_env.master_get("/cluster/status").get(
            "Members", {}).get("filer", [])

    def start(name: str, port: int) -> None:
        if name not in runs:
            runs[name] = loop_thread(loops)
        f = FilerServer(master.url, "127.0.0.1", port, data_dir=data_dir,
                        chunk_cache_mem=FS_CACHE_MEM,
                        encrypt_data=name == "B")
        runs[name](f.start())
        filers[name] = f

    def sync_rings() -> None:
        want = sorted(f.url for f in filers.values())
        until(lambda: members() == want,
              f"the master never listed the filers {want}")
        for n, f in filers.items():
            runs[n](f._refresh_hot_ring())
            if sorted(f.hot_ring.members) != want:
                raise AssertionError(f"{n}'s ring {f.hot_ring.members}")

    try:
        # 0 set-up: A on the lower port, B sealing its chunks
        ports = set()
        while len(ports) < 2:
            ports.add(free_port())
        port_a, port_b = sorted(ports)
        start("A", port_a)
        start("B", port_b)
        sync_rings()
        pool = http.PooledHTTP(timeout=600.0,
                               max_idle_per_host=FS_THREADS)
        A = filers["A"]
        t_ns = time.time_ns()

        # 1 the tree: /p25 through A; sizes and bytes from the seed, a
        # file every other one under /p25/enc through B, the rest under
        # /p25/plain through A (every fourth of those text), in four
        # directories each
        t0 = time.perf_counter()
        k0 = dict(launches)
        st, _, raw = call("A", "/p25/", "POST", b"")
        if st != 201:
            raise AssertionError(f"mkdir /p25: HTTP {st} {raw[:200]!r}")
        sizes: list = []
        while sum(sizes) < FS_BYTES:
            sizes.append(min(int(np.exp(rng.uniform(
                np.log(FS_MIN_SIZE), np.log(FS_MAX_SIZE)))),
                FS_BYTES - sum(sizes)))
        if sizes[-1] < FS_MIN_SIZE:  # the remainder joins the last
            sizes[-2] += sizes.pop()
        payload = rng.bytes(FS_BYTES)
        content: dict = {}  # path -> the file's bytes
        plan: list = []  # (path, filer, content type)
        at = 0
        for i, size in enumerate(sizes):
            piece = payload[at:at + size]
            at += size
            if i % 2:
                path = f"/p25/enc/d{i // 2 % 4}/f{i:03d}"
                plan.append((path, "B", "application/octet-stream"))
            elif i // 2 % 4 == 0:
                path = f"/p25/plain/d{i // 2 % 4}/f{i:03d}.txt"
                piece = ((np.frombuffer(piece, np.uint8) & 15) + 97) \
                    .astype(np.uint8).tobytes()
                plan.append((path, "A", "text/plain"))
            else:
                path = f"/p25/plain/d{i // 2 % 4}/f{i:03d}"
                plan.append((path, "A", "application/octet-stream"))
            content[path] = piece

        def put(item) -> None:
            path, name, ctype = item
            st, _, raw = call(name, f"{path}?collection={FS_COLLECTION}",
                              "PUT", content[path],
                              {"Content-Type": ctype})
            if st != 201 or json.loads(raw)["size"] != len(content[path]):
                raise AssertionError(f"PUT {path} through {name}: HTTP "
                                     f"{st} {raw[:200]!r}")
        dt_up = fan(put, plan, FS_THREADS)
        texts = [p for p, _, c in plan if c == "text/plain"]
        text_chunks = [c for p in texts
                       for c in A.filer.find_entry(p).chunks]
        gz = sum(1 for c in text_chunks if c.is_compressed)
        # the filer gzips a text chunk over 128 B that shrinks by 10 %
        if not texts or gz != sum(1 for c in text_chunks if c.size > 128):
            raise AssertionError(f"{gz} gzipped chunks of "
                                 f"{len(text_chunks)} in {len(texts)} "
                                 f"text files")
        plains = sorted((p for p, n, c in plan
                         if n == "A" and c != "text/plain"),
                        key=lambda p: (len(content[p]), p))
        dropped: set = set()
        # a ranged write into the largest binary plain file
        pat = plains[-1]
        before = {c.fid for c in A.filer.find_entry(pat).chunks}
        off = len(content[pat]) // 3
        fresh = rng.bytes(min(FS_PATCH, len(content[pat]) - off))
        st, _, raw = call("A", f"{pat}?offset={off}&collection="
                          f"{FS_COLLECTION}", "PUT", fresh)
        if st != 201 or json.loads(raw)["size"] != len(fresh):
            raise AssertionError(f"PATCH {pat}: HTTP {st} {raw[:200]!r}")
        content[pat] = content[pat][:off] + fresh + \
            content[pat][off + len(fresh):]
        dropped |= before - {c.fid for c in A.filer.find_entry(pat).chunks}
        # the next one truncated to half
        cut = plains[-2]
        before = {c.fid for c in A.filer.find_entry(cut).chunks}
        half = len(content[cut]) // 2
        st, _, raw = call("A", f"{cut}?truncate={half}", "POST", b"")
        if st != 200:
            raise AssertionError(f"truncate {cut}: HTTP {st} {raw!r}")
        content[cut] = content[cut][:half]
        dropped |= before - {c.fid for c in A.filer.find_entry(cut).chunks}
        # a directory of /p25/plain moved
        st, _, raw = call("A", "/p25/plain/moved?mv.from=/p25/plain/d3",
                          "POST", b"")
        if st != 200:
            raise AssertionError(f"move /p25/plain/d3: HTTP {st} {raw!r}")
        moved = {p: "/p25/plain/moved/" + p.rsplit("/", 1)[1]
                 for p in content if p.startswith("/p25/plain/d3/")}
        for old, new in moved.items():
            content[new] = content.pop(old)
        until(lambda: A.deletion.pending_count() == 0 and
              A.deletion.deleted_count + A.deletion.error_count >=
              len(dropped), "A's deletion queue never freed the "
              "dropped chunks", timeout=60)
        if A.deletion.error_count or \
                A.deletion.deleted_count != len(dropped):
            raise AssertionError(f"A's queue deleted "
                                 f"{A.deletion.deleted_count} of "
                                 f"{len(dropped)} dropped chunks, "
                                 f"{A.deletion.error_count} errors")
        dt_write = time.perf_counter() - t0
        step_counts("1 write", k0, 0, t0)
        written = sum(len(c) for c in content.values())
        entries = {p: A.filer.find_entry(p) for p in content}
        n_chunks = len({c.fid for e in entries.values() for c in e.chunks})
        steps["1 write"].update({
            "files": len(content), "bytes": written, "chunks": n_chunks,
            "gzipped": gz, "dropped": len(dropped), "put_s": dt_up,
            "mbps": written / dt_write / 1e6})
        plog(f"1 write: {len(content)} files ({FS_MIN_SIZE}-"
             f"{FS_MAX_SIZE} B log-uniform), {written} B in {n_chunks} "
             f"chunks PUT from {FS_THREADS} threads at "
             f"{written / dt_up / 1e6:.1f} MB/s: /p25/plain through A "
             f"({len(texts)} text files, {gz} chunks gzipped), /p25/enc "
             f"through B (sealed); {pat} patched at [{off}, "
             f"{off + len(fresh)}), {cut} truncated to {half} B, "
             f"/p25/plain/d3 moved to /p25/plain/moved, {len(dropped)} "
             f"dropped chunks freed by A's queue; "
             f"{written / dt_write / 1e6:.1f} MB/s for the step; K1 0")

        # 2 ec.encode -collection p25, once a beat reports the sizes
        def p25_view() -> dict:
            return {vi["id"]: vi["size"]
                    for nd in topo()["nodes"].values()
                    for vi in nd["volume_infos"]
                    if vi["collection"] == FS_COLLECTION}
        vols = {vid: servers[holder_of(vid)].store.get_volume(vid)
                for vid in p25_view()}
        for vol in vols.values():
            vol.flush()
        dat_size = {vid: vol.data_size() for vid, vol in vols.items()}
        p25 = until(lambda: (lambda seen: seen if seen == dat_size
                             else None)(p25_view()),
                    f"no beat reported the p25 sizes {dat_size}")
        units = {vid: predict_units(p25[vid], layout.LARGE_BLOCK_SIZE,
                                    layout.SMALL_BLOCK_SIZE)
                 for vid in p25}
        k0 = dict(launches)
        t0 = time.perf_counter()
        run("lock")
        out2 = run(f"ec.encode -collection {FS_COLLECTION} "
                   f"-fullPercent 0 -quietFor 0s")
        run("unlock")
        dt_enc = time.perf_counter() - t0
        listed = json.loads(out2.splitlines()[0].split(": ", 1)[1])
        if listed != sorted(p25):
            raise AssertionError(f"ec.encode selected {listed}; the "
                                 f"p25 volumes are {sorted(p25)}")
        step_counts("2 encode", k0, sum(units.values()), t0)
        until(lambda: all(sum(map(len, split(vid).values())) == 14
                          for vid in listed),
              "the p25 shard sets never reached the master")
        dat_bytes = sum(p25.values())
        steps["2 encode"].update({"s": dt_enc, "volumes": listed,
                                  "dat_bytes": p25, "units": units,
                                  "mbps": dat_bytes / dt_enc / 1e6})
        plog(f"2 encode: `ec.encode -collection {FS_COLLECTION}` of "
             f"volumes {listed} (.dat {[p25[v] for v in listed]} B) in "
             f"{dt_enc:.3f} s, {dat_bytes / dt_enc / 1e6:.1f} MB/s; K1 "
             f"{sum(units.values())} == the layout's units")

        # 3 data shards 0 and 3 of every p25 EC volume deleted
        k0 = dict(launches)
        t0 = time.perf_counter()
        for vid in listed:
            for u, shards in split(vid).items():
                gone = [s for s in FS_LOST if s in shards]
                if gone:
                    admin(node_of[u], "/admin/ec/delete_shards",
                          {"volume": vid, "shards": gone})
        until(lambda: not any(set(FS_LOST) & set(s) for vid in listed
                              for s in split(vid).values()),
              "the master still shows the deleted shards")
        step_counts("3 loss", k0, 0, t0)
        plog(f"3 loss: data shards {list(FS_LOST)} of every p25 EC "
             f"volume deleted where they lived; K1 0")

        # which chunk needles touch a lost data shard, by the layout
        evs = {vid: next(servers[n].store.get_ec_volume(vid)
                         for n in names
                         if servers[n].store.get_ec_volume(vid)
                         is not None) for vid in listed}

        def touches(fid: str) -> bool:
            f = t.FileId.parse(fid)
            return bool(touching_needles(evs[f.volume_id], {f.key: None},
                                         FS_LOST))

        # 4 every file read in full, alternating A and B
        tree = sorted(content)
        listed_tree = []
        stack = ["/p25"]
        while stack:
            for e in A.filer.iter_entries(stack.pop()):
                (stack if e.is_directory else listed_tree).append(
                    e.full_path)
        if sorted(listed_tree) != tree:
            raise AssertionError(
                f"the store lists {len(listed_tree)} files, "
                f"{len(tree)} were written: "
                f"{sorted(set(listed_tree) ^ set(tree))[:8]}")
        want_sha = {p: hashlib.sha256(c).hexdigest()
                    for p, c in content.items()}
        views = {p: {v.fid for v in ChunkGroup(e.chunks).read_views(
            0, e.size())} for p, e in entries.items()}
        needed = set().union(*views.values())
        touching = {f for f in needed if touches(f)}
        empty_lrus()
        resilience.reset_latency_trackers()
        resilience.reset_breakers()
        h0 = events()
        k0 = dict(launches)
        t0 = time.perf_counter()

        def read(item) -> None:
            i, path = item
            name = "AB"[i % 2]
            st, _, body = call(name, path)
            if st != 200 or hashlib.sha256(body).hexdigest() != \
                    want_sha[path]:
                raise AssertionError(f"GET {path} through {name}: HTTP "
                                     f"{st}, {len(body)} B differ from "
                                     f"the draw")
        dt_read = fan(read, list(enumerate(tree)), FS_THREADS)
        d4 = delta(h0)
        if d4["direct"] != len(needed) or not d4["route_in"] or \
                not d4["route_out"] or d4["route_fail"]:
            raise AssertionError(f"step 4's hot tier {d4}: "
                                 f"{len(needed)} distinct chunks read")
        step_counts("4 degraded", k0, len(touching), t0)
        steps["4 degraded"].update({
            "files": len(tree), "chunks": len(needed),
            "touching": len(touching), "hot": d4, "s": dt_read,
            "mbps": written / dt_read / 1e6})
        plog(f"4 degraded: {len(tree)} files read in full through A "
             f"and B in turn from {FS_THREADS} threads, each sha256 == "
             f"its draw: {written} B in {dt_read:.3f} s, "
             f"{written / dt_read / 1e6:.1f} MB/s; hot tier {d4}: "
             f"direct {d4['direct']} == the {len(needed)} distinct "
             f"chunks; K1 {len(touching)} == the fetches touching shards "
             f"{list(FS_LOST)}")

        # 5 one Range GET per file through the other filer, and a HEAD
        spans = {}
        for p in tree:
            n = len(content[p])
            lo = int(rng.integers(0, n))
            spans[p] = (lo, int(rng.integers(lo, n)))
        h0 = events()
        k0 = dict(launches)
        t0 = time.perf_counter()

        def ranged(item) -> None:
            i, path = item
            name = "BA"[i % 2]
            lo, hi = spans[path]
            n = len(content[path])
            st, hdrs, body = call(name, path,
                                  headers={"Range": f"bytes={lo}-{hi}"})
            if st != 206 or body != content[path][lo:hi + 1] or \
                    hdrs.get("content-range") != f"bytes {lo}-{hi}/{n}":
                raise AssertionError(f"Range {lo}-{hi} of {path} through "
                                     f"{name}: HTTP {st} "
                                     f"{hdrs.get('content-range')}")
            st, hdrs, _ = call(name, path, "HEAD")
            md5 = entries[path].attr.md5
            if st != 200 or hdrs.get("content-length") != str(n) or \
                    (md5 and hdrs.get("etag") != f'"{md5}"'):
                raise AssertionError(f"HEAD {path} through {name}: HTTP "
                                     f"{st} {hdrs}")
        dt_ranged = fan(ranged, list(enumerate(tree)), FS_THREADS)
        d5 = delta(h0)
        if d5["direct"]:
            raise AssertionError(f"step 5 fetched from the volume tier: "
                                 f"{d5}")
        step_counts("5 ranged", k0, 0, t0)
        st, _, raw = racks.http.request(
            f"http://{master.url}/cluster/perf")
        block = json.loads(raw)["hot_tier"] if st == 200 else {}
        now = events()
        summed = {k: now["A"][k] + now["B"][k] for k in now["A"]}
        hits = summed["hit_local"] + summed["route_out"]
        if block.get("events") != summed or block.get("hit_ratio") != \
                round(hits / (hits + summed["direct"]), 4):
            raise AssertionError(f"/cluster/perf's hot_tier {block}; "
                                 f"A + B {summed}")
        ranged_bytes = sum(hi - lo + 1 for lo, hi in spans.values())
        steps["5 ranged"].update({
            "bytes": ranged_bytes, "hot": d5, "s": dt_ranged,
            "mbps": ranged_bytes / dt_ranged / 1e6,
            "hit_ratio": block["hit_ratio"]})
        plog(f"5 ranged: a Range GET and a HEAD of each file through the "
             f"other filer, each equal to its draw: {ranged_bytes} B in "
             f"{dt_ranged:.3f} s, {ranged_bytes / dt_ranged / 1e6:.1f} "
             f"MB/s; hot tier {d5}; /cluster/perf hot_tier events == A "
             f"+ B {summed}, hit_ratio {block['hit_ratio']}; K1 0")

        # 6 the shell: listing, usage, verify, a metadata dump, and the
        # deletion of /p25/plain through A
        enc = sorted(p for p in tree if p.startswith("/p25/enc/"))
        enc_touching = {c.fid for p in enc for c in entries[p].chunks
                        if c.fid in touching}
        freed = {c.fid for p in tree if p.startswith("/p25/plain/")
                 for c in entries[p].chunks}
        holders = {vid: sorted(split(vid)) for vid in listed}
        if any(len(h) != len(names) for h in holders.values()):
            raise AssertionError(f"the p25 volumes' holders {holders}")
        empty_lrus()
        k0 = dict(launches)
        t0 = time.perf_counter()
        if racks.cmd_env.find_filer() != A.url:
            raise AssertionError(f"the shell's filer is "
                                 f"{racks.cmd_env.find_filer()}, not A")
        out = run("fs.ls -l /p25/plain")
        if sorted(line.split()[-1] for line in out.splitlines()) != \
                ["d0/", "d1/", "d2/", "moved/"]:
            raise AssertionError(f"fs.ls -l /p25/plain: {out!r}")
        out = run("fs.du /p25")
        if out != f"{written} bytes in {len(tree)} file(s) under /p25\n":
            raise AssertionError(f"fs.du /p25: {out!r}, {written} B in "
                                 f"{len(tree)} files written")
        verified = 0
        for p in enc:
            out = run(f"fs.verify {p}")
            n = len(entries[p].chunks)
            if out != f"fs.verify: {n} chunk(s) ok, 0 missing\n":
                raise AssertionError(f"fs.verify {p}: {out!r}")
            verified += n
        dump = os.path.join(work, "p25.jsonl")
        out = run(f"fs.meta.save -o {dump} /p25")
        n_dirs = len({p.rsplit("/", 1)[0] for p in tree} - {"/p25"}) + 2
        if out != f"fs.meta.save: {len(tree) + n_dirs} entr(ies) -> " \
                  f"{dump}\n":
            raise AssertionError(f"fs.meta.save: {out!r}")
        deleted0 = A.deletion.deleted_count
        t_rm = time.perf_counter()
        run("fs.rm -r /p25/plain")
        until(lambda: A.deletion.pending_count() == 0 and
              A.deletion.deleted_count + A.deletion.error_count -
              deleted0 >= len(freed), "A's deletion queue never drained",
              timeout=120)
        dt_drain = time.perf_counter() - t_rm
        if A.deletion.error_count or \
                A.deletion.deleted_count - deleted0 != len(freed):
            raise AssertionError(f"A's queue deleted "
                                 f"{A.deletion.deleted_count - deleted0} "
                                 f"of {len(freed)} fids, "
                                 f"{A.deletion.error_count} errors")

        def gone(fid: str) -> None:
            for u in holders[int(fid.split(",")[0])]:
                st, _, _ = racks.http.request(f"http://{u}/{fid}")
                if st != 404:
                    raise AssertionError(f"freed {fid} answers {st} on "
                                         f"{node_of[u]}")
        fan(gone, sorted(freed), FS_THREADS)
        step_counts("6 shell", k0, len(enc_touching), t0)
        steps["6 shell"].update({
            "verified_chunks": verified, "enc_touching": len(enc_touching),
            "freed": len(freed), "drain_s": dt_drain})
        plog(f"6 shell: fs.ls -l /p25/plain, fs.du /p25 == {written} B "
             f"in {len(tree)} files, fs.verify of {len(enc)} /p25/enc "
             f"files ({verified} chunks ok, 0 missing), fs.meta.save of "
             f"{len(tree) + n_dirs} entries, fs.rm -r /p25/plain: A's "
             f"queue freed {len(freed)} fids in {dt_drain:.3f} s, each "
             f"404 on every holder; K1 {len(enc_touching)} == the "
             f"/p25/enc chunks on a lost data shard that fs.verify's "
             f"HEADs decoded")

        # 7 A's feed, the digests, A restarted
        k0 = dict(launches)
        t0 = time.perf_counter()
        st, _, raw = call("A", f"/__meta__/subscribe?since={t_ns}"
                          f"&live=false")
        feed = [json.loads(line) for line in raw.splitlines() if line]
        expect = _filer_server_events(plan, pat, cut, moved, tree)
        got = [((e["old_entry"] or {}).get("full_path"),
                (e["new_entry"] or {}).get("full_path")) for e in feed]
        if sorted(got, key=repr) != sorted(expect, key=repr):
            raise AssertionError(
                f"A's feed holds {len(got)} events, {len(expect)} "
                f"expected: {sorted(set(got) ^ set(expect), key=repr)[:6]}")
        live: set = set()
        for (old, new), ev in zip(got, feed):
            if old is not None and old not in live:
                raise AssertionError(f"the feed {ev['ts_ns']} names "
                                     f"{old} before its creation")
            live.discard(old)
            if new is not None:
                if old is None and new in live:
                    raise AssertionError(f"the feed creates {new} twice")
                live.add(new)
        if [e["ts_ns"] for e in feed] != sorted(
                {e["ts_ns"] for e in feed}) or feed[0]["ts_ns"] <= t_ns:
            raise AssertionError("A's feed is out of order")

        def digest(name: str) -> tuple:
            st, _, raw = call(name, "/__meta__/digest?prefix=/p25")
            d = json.loads(raw)
            return d["digest"], d["entries"]
        dig = digest("A")
        if digest("B") != dig:
            raise AssertionError(f"the digests differ: A {dig}, B "
                                 f"{digest('B')}")
        runs["A"](filers.pop("A").stop())
        start("A", port_a)
        A = filers["A"]
        sync_rings()
        if digest("A") != dig:
            raise AssertionError(f"A's digest after its restart "
                                 f"{digest('A')}, before {dig}")
        cold = sorted(rng.choice(enc, size=min(FS_COLD, len(enc)),
                                 replace=False).tolist())
        cold_fids = set().union(*(views[p] for p in cold))
        homed_a = {f for f in cold_fids if A.hot_ring.home(f) == A.url}
        cold_touching = homed_a & touching
        empty_lrus()
        h0 = events()
        t_cold = time.perf_counter()
        for p in cold:
            st, _, body = call("A", p)
            if st != 200 or hashlib.sha256(body).hexdigest() != \
                    want_sha[p]:
                raise AssertionError(f"GET {p} through the restarted A: "
                                     f"HTTP {st}, differs from its draw")
        dt_cold = time.perf_counter() - t_cold
        cold_bytes = sum(len(content[p]) for p in cold)
        d7 = delta(h0)
        if d7["direct"] != len(homed_a) or \
                filers["B"].hot_stats["direct"] != h0["B"]["direct"]:
            raise AssertionError(f"step 7's hot tier {d7}: "
                                 f"{len(homed_a)} of {len(cold_fids)} "
                                 f"chunks homed on A")
        step_counts("7 restart", k0, len(cold_touching), t0)
        steps["7 restart"].update({
            "events": len(feed), "digest": dig, "cold_files": len(cold),
            "cold_chunks": len(cold_fids), "homed_a": len(homed_a),
            "hot": d7, "cold_mbps": cold_bytes / dt_cold / 1e6})
        plog(f"7 restart: A's feed since the phase's start replays its "
             f"{len(feed)} creates, updates, moves and deletes in order; "
             f"/__meta__/digest of /p25 ({dig[1]} entries) equal on A "
             f"and B, and on A restarted on the same directory; "
             f"{len(cold)} /p25/enc files read through it cold, each "
             f"sha256 == its draw, {cold_bytes} B at "
             f"{cold_bytes / dt_cold / 1e6:.1f} MB/s, {len(homed_a)} of "
             f"their "
             f"{len(cold_fids)} chunks fetched from the volume tier "
             f"(homed on A), the rest from B's cache; K1 "
             f"{len(cold_touching)} == those on a lost data shard")
    finally:
        for name, f in filers.items():
            runs[name](f.stop())
        stop_loops(loops)
        if pool is not None:
            pool.close()
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "steps": steps, "counts": counts,
           "predicted": predicted, "s": time.perf_counter() - t_phase}
    plog(f"launches per step {counts} (K1 predicted {predicted}); phase "
         f"wall {out['s']:.1f} s")
    return out


def _filer_server_events(plan: list, patched: str, cut: str, moved: dict,
                         tree: list) -> list:
    """The (old path, new path) of every meta event phase 25 has A make,
    by its script: /p25, the directories and files of /p25/plain, the
    patch and the truncate, the move of /p25/plain/d3 (each child, then
    the directory), and `fs.rm -r /p25/plain` (every entry under it,
    then itself)."""
    ev: list = [(None, "/p25")]
    plain = [p for p, name, _ in plan if name == "A"]
    dirs = sorted({p.rsplit("/", 1)[0] for p in plain})
    ev += [(None, "/p25/plain")] + [(None, d) for d in dirs]
    ev += [(None, p) for p in plain]
    ev += [(patched, patched), (cut, cut)]
    ev += [(old, new) for old, new in moved.items()]
    ev.append(("/p25/plain/d3", "/p25/plain/moved"))
    gone = [p for p in tree if p.startswith("/p25/plain/")]
    gone_dirs = sorted({p.rsplit("/", 1)[0] for p in gone})
    ev += [(p, None) for p in gone] + [(d, None) for d in gone_dirs]
    ev.append(("/p25/plain", None))
    return ev


# phase 26's S3 gateway (ROADMAP 1.21a): one port FilerServer F and one
# port S3ApiServer G over it on phase 23's cluster
S3_BUCKET = "p26"  # the bucket, and the collection its chunks land in
S3_BYTES = 128 * MIB  # the objects, from --seed (cut from 256, PERF §4)
S3_MULTIPART = 24 * MIB  # each of the two multipart objects, about
S3_PART = 5 * MIB
S3_CACHE_MEM = 512 * MIB  # F's: no chunk evicted in the phase
S3_LOST = (0, 3)  # step 3's lost data shards of every p26 EC volume
S3_THREADS = 16
S3_PAGE = 7  # step 5's ListObjectsV2 max-keys
S3_DENIED = "d1/"  # step 5's prefix the bucket policy denies R
# W writes and administers, R reads and lists
S3_IDENTITIES = (("W", "P26WRITER", "p26-writer-secret",
                  "Admin,Read,Write,List,Tagging"),
                 ("R", "P26READER", "p26-reader-secret", "Read,List"))


def phase_s3(racks: ThreeRacks, vdir: str, seed: int,
             launches: dict) -> dict:
    """Phase 26: the port's S3 gateway (ROADMAP 1.21a) over `racks`,
    phase 23's three port `VolumeServer`s on the card in three racks
    behind the port's `MasterServer`, kept up for it.  One port
    `FilerServer` F on a loop thread of its own, a fresh SQLite store in
    the phase's directory and a 512 MiB chunk cache, `/buckets/p26/`
    mapped to collection p26 through the port shell's `fs.configure`;
    one port `S3ApiServer` G over F on another loop thread, registered
    with the master, its IAM two identities (W: Admin, Read, Write,
    List, Tagging; R: Read, List), also stored in F's identity.json by
    the shell's `s3.configure`.  Steps: (1) bucket p26 created through
    G by W, then 128 MiB of objects from --seed (1 KiB-32 MiB,
    log-uniform) PUT from 16 threads: three quarters by a signed PUT
    with the payload's SHA-256, a quarter by aws-chunked streaming
    (`sign_v4_chunked`), and two of about 24 MiB by multipart in 5 MiB
    parts, each answered with its MD5 ETag (the multipart ones the MD5
    of the parts' MD5s with -5); K1 0; (2) `ec.encode -collection p26`
    through the port's shell, K1 == the layout's units of the p26 .dat
    files; (3) data shards 0 and 3 of every p26 EC volume deleted, K1 0;
    (4) every object read in full through G from 16 threads, sha256 ==
    its draw, ETag the filer's MD5 (for a multipart object the MD5 of
    its parts' MD5s): F's `direct` == the distinct chunks (each fetched
    from the volume tier once), K1 == those fetches whose needle touches
    a lost data shard; F's summed GET seconds (its request histogram)
    beside the client's; (5) ListObjectsV2 at max-keys 7 with
    continuation lists every key once, in order, with its size; a Range
    GET of each object through a URL presigned by R equals the draw's
    slice and a HEAD its size; a PUT signed by R answers 403
    AccessDenied; a bucket policy denying R s3:GetObject on d1/ makes
    d1/ 403 for R and the rest 200; K1 0 (F's cache); (6) the process's
    weedtpu_tenant_requests_total for W's and R's keys == the phase's
    own count of their successful requests, and weedtpu_tenant_bytes_total
    received == the byte ledger's client data-class total over steps 1
    and 4 (sent within 1 %: the master's answers to F's lookups book
    under the client role too); the
    port's shell lists p26 (`s3.bucket.list`) and W and R
    (`s3.configure -list`); (7) a DeleteObjects of a quarter of the keys,
    a multipart object among them: once F's deletion queue drains, every
    freed fid answers 404 on every holder, and the other multipart
    object still reads equal to its draw, K1 0 (F's cache).  K2 0
    throughout."""
    import hashlib
    import hmac
    import threading as _threading
    import urllib.parse

    import numpy as np
    from seaweedfs_tpu_torch.filer.filechunk_section import ChunkGroup
    from seaweedfs_tpu_torch.s3 import auth
    from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.stats import metrics
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout
    from seaweedfs_tpu_torch.utils import http, resilience

    card = card_name_power()

    def plog(msg: str) -> None:
        log(f"[s3] {msg} [{card}]")

    work = os.path.join(vdir, "s3")
    os.makedirs(work)
    names, servers = racks.names, racks.servers
    node_of, master = racks.node_of, racks.master
    admin, run, split, topo = racks.admin, racks.run, racks.split, racks.topo
    holder_of = racks.holder_of
    loops: list = []
    frun = grun = F = G = pool = None
    steps: dict = {}
    counts: dict = {}
    predicted: dict = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 26)
    creds = {who: auth.Credential(ak, sk)
             for who, ak, sk, _ in S3_IDENTITIES}
    ok_by_key: dict = {c.access_key: 0 for c in creds.values()}
    ok_lock = _threading.Lock()

    def step_counts(name: str, k0: dict, k1: int, t0: float) -> None:
        got = {k: launches[k] - k0[k] for k in launches}
        counts[name] = got
        predicted[name] = k1
        steps.setdefault(name, {})["wall_s"] = time.perf_counter() - t0
        want = {"gf_apply": k1, "gf_apply_batch": 0}
        if got != want:
            raise AssertionError(f"phase 26 {name}: launched {got}, "
                                 f"predicted {want}")

    def empty_lrus() -> None:
        """No server's reconstruction LRU answers a read this step
        predicts a launch for."""
        for vs in servers.values():
            for loc in vs.store.locations:
                for ev in list(loc.ec_volumes.values()):
                    with ev._recon_lock:
                        ev._recon_cache.clear()
                        ev._recon_cache_bytes = 0

    def s3(who: str | None, method: str, key: str = "", query=None,
           body: bytes = b"", headers=None, chunked: bool = False,
           url: str | None = None) -> tuple:
        """One request to G, signed by `who` (None: unsigned; `url`: a
        presigned path and query); a success books one request on the
        signer's key, as the gateway's tenant counter should."""
        path = f"/{S3_BUCKET}" + (f"/{key}" if key else "")
        h = dict(headers or {})
        if url is None:
            query = query or {}
            if who is not None and chunked:
                sh, body = auth.sign_v4_chunked(
                    creds[who], method, G.url, path, query, body)
                h.update(sh)
            elif who is not None:
                h.update(auth.sign_v4(creds[who], method, G.url, path,
                                      query, payload=body))
            qs = urllib.parse.urlencode(query, quote_via=urllib.parse.quote)
            url = urllib.parse.quote(path) + (f"?{qs}" if qs else "")
        # the signed Host is the one http.client sends (G.url): a second
        # copy is a malformed request
        h.pop("Host", None)
        st, hdrs, raw = pool.request(f"http://{G.url}{url}", method,
                                     body if body or method in
                                     ("PUT", "POST") else None, h)
        if st < 400 and who is not None:
            with ok_lock:
                ok_by_key[creds[who].access_key] += 1
        return st, hdrs, raw

    def presign(who: str, key: str, expires: int = 900) -> str:
        """A GET URL presigned by `who` (SigV4 query auth, host signed)."""
        iam = auth.IdentityAccessManagement
        when = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        scope = f"{when[:8]}/us-east-1/s3/aws4_request"
        path = f"/{S3_BUCKET}/{key}"
        q = {"X-Amz-Algorithm": "AWS4-HMAC-SHA256",
             "X-Amz-Credential": f"{creds[who].access_key}/{scope}",
             "X-Amz-Date": when, "X-Amz-Expires": str(expires),
             "X-Amz-SignedHeaders": "host"}
        creq = "\n".join(["GET", iam._canonical_uri(path),
                          iam._canonical_query(q), f"host:{G.url}\n",
                          "host", "UNSIGNED-PAYLOAD"])
        sts = "\n".join(["AWS4-HMAC-SHA256", when, scope,
                         hashlib.sha256(creq.encode()).hexdigest()])
        q["X-Amz-Signature"] = hmac.new(
            iam._sig_key(creds[who].secret_key, when[:8], "us-east-1",
                         "s3"), sts.encode(), hashlib.sha256).hexdigest()
        return urllib.parse.quote(path) + "?" + urllib.parse.urlencode(
            q, quote_via=urllib.parse.quote)

    def ledger() -> dict:
        """The process's tenant counters and byte ledger, as G books
        them, once two reads 50 ms apart agree (the middleware books a
        request after its reply is on the wire)."""
        while True:
            a = _ledger()
            time.sleep(0.05)
            if _ledger() == a:
                return a

    def _ledger() -> dict:
        out = {"req": {}, "tenant": {"recv": 0.0, "sent": 0.0},
               "flow": {"recv": 0.0, "sent": 0.0}}
        for labels, child in metrics.TENANT_REQUESTS._pairs():
            ld = dict(labels)
            out["req"][ld["tenant"]] = out["req"].get(ld["tenant"], 0) + \
                child.value
        for labels, child in metrics.TENANT_BYTES._pairs():
            out["tenant"][dict(labels)["direction"]] += child.value
        for labels, child in metrics.NET_BYTES._pairs():
            ld = dict(labels)
            if ld.get("class") == "data" and \
                    ld.get("peer_role") == "client":
                out["flow"][ld["direction"]] += child.value
        return out

    try:
        # 0 set-up.  Phase 25's two filers stopped moments ago and the
        # master lists a member for 30 s after its last beat, so the
        # shell's find_filer could pick one: they leave the table first
        async def forget_filers() -> None:
            master.cluster_members.pop("filer", None)
        racks.mrun(forget_filers())
        frun, grun = loop_thread(loops), loop_thread(loops)
        F = FilerServer(master.url, "127.0.0.1", free_port(),
                        data_dir=os.path.join(work, "filer"),
                        chunk_cache_mem=S3_CACHE_MEM)
        frun(F.start())
        until(lambda: racks.cmd_env.master_get("/cluster/status").get(
            "Members", {}).get("filer") == [F.url],
            "the master never listed F alone")
        run("lock")
        run(f"fs.configure -locationPrefix /buckets/{S3_BUCKET}/ "
            f"-collection {S3_BUCKET} -apply")
        for who, ak, sk, actions in S3_IDENTITIES:
            run(f"s3.configure -user {who} -access_key {ak} -secret_key "
                f"{sk} -actions {actions}")
        run("unlock")
        iam = auth.IdentityAccessManagement([
            auth.Identity(who, [creds[who]], actions.split(","))
            for who, _, _, actions in S3_IDENTITIES])
        G = S3ApiServer(F.url, "127.0.0.1", free_port(), iam=iam,
                        master_url=master.url)
        grun(G.start())
        until(lambda: G.url in master.cluster_members.get("s3", {}),
              "G never registered with the master")
        until(lambda: sorted(i.name for i in G.iam.identities) ==
              ["R", "W"] and G.iam._ever_configured,
              "G never loaded F's identity.json")
        pool = http.PooledHTTP(timeout=600.0, max_idle_per_host=S3_THREADS)
        led0 = ledger()
        ok0 = dict(ok_by_key)

        # 1 the bucket and its objects
        t0 = time.perf_counter()
        k0 = dict(launches)
        st, _, raw = s3("W", "PUT")
        if st != 200:
            raise AssertionError(f"PUT /{S3_BUCKET}: HTTP {st} "
                                 f"{raw[:200]!r}")
        mp_sizes = [S3_MULTIPART - int(rng.integers(0, MIB))
                    for _ in range(2)]
        budget = S3_BYTES - sum(mp_sizes)
        sizes: list = []
        while sum(sizes) < budget:
            sizes.append(min(int(np.exp(rng.uniform(
                np.log(FS_MIN_SIZE), np.log(FS_MAX_SIZE)))),
                budget - sum(sizes)))
        if sizes[-1] < FS_MIN_SIZE:  # the remainder joins the last
            sizes[-2] += sizes.pop()
        payload = rng.bytes(S3_BYTES)
        content: dict = {}  # key -> the object's bytes
        plan: list = []  # (key, "put" | "chunked" | "multipart")
        at = 0
        for i, size in enumerate(sizes):
            key = f"d{i % 4}/o{i:03d}.bin"
            content[key] = payload[at:at + size]
            at += size
            plan.append((key, "chunked" if i % 4 == 3 else "put"))
        multipart = [f"mp/big{j}.bin" for j in range(2)]
        for key, size in zip(multipart, mp_sizes):
            content[key] = payload[at:at + size]
            at += size
            plan.append((key, "multipart"))
        md5 = {k: hashlib.md5(c).hexdigest() for k, c in content.items()}
        for key in multipart:
            c = content[key]
            md5[key] = hashlib.md5(b"".join(
                hashlib.md5(c[o:o + S3_PART]).digest()
                for o in range(0, len(c), S3_PART))).hexdigest()
        n_parts = -(-S3_MULTIPART // S3_PART)

        def put(item) -> None:
            key, how = item
            data = content[key]
            if how != "multipart":
                st, hdrs, raw = s3("W", "PUT", key, body=data,
                                   chunked=how == "chunked")
                if st != 200 or hdrs.get("etag") != f'"{md5[key]}"':
                    raise AssertionError(f"{how} PUT {key}: HTTP {st} "
                                         f"{hdrs.get('etag')} "
                                         f"{raw[:200]!r}")
                return
            st, _, raw = s3("W", "POST", key, {"uploads": ""})
            uid = re.search(rb"<UploadId>([^<]+)</UploadId>", raw)
            if st != 200 or uid is None:
                raise AssertionError(f"initiate {key}: HTTP {st} "
                                     f"{raw[:200]!r}")
            uid = uid.group(1).decode()
            parts = []
            for n, o in enumerate(range(0, len(data), S3_PART), 1):
                st, hdrs, raw = s3("W", "PUT", key, {
                    "partNumber": str(n), "uploadId": uid},
                    body=data[o:o + S3_PART])
                if st != 200:
                    raise AssertionError(f"part {n} of {key}: HTTP {st} "
                                         f"{raw[:200]!r}")
                parts.append(f"<Part><PartNumber>{n}</PartNumber><ETag>"
                             f"{hdrs['etag']}</ETag></Part>")
            st, _, raw = s3("W", "POST", key, {"uploadId": uid},
                            body=("<CompleteMultipartUpload>" +
                                  "".join(parts) +
                                  "</CompleteMultipartUpload>").encode())
            want = f'<ETag>"{md5[key]}-{len(parts)}"</ETag>'
            if st != 200 or want.encode() not in raw or \
                    len(parts) != n_parts:
                raise AssertionError(f"complete {key}: HTTP {st} "
                                     f"{raw[:300]!r}, {len(parts)} parts")
        dt_up = fan(put, plan, S3_THREADS)
        step_counts("1 write", k0, 0, t0)
        led1 = ledger()
        written = sum(len(c) for c in content.values())
        entries = {k: F.filer.find_entry(f"/buckets/{S3_BUCKET}/{k}")
                   for k in content}
        n_chunks = len({c.fid for e in entries.values() for c in e.chunks})
        ways = {w: sum(1 for _, h in plan if h == w)
                for w in ("put", "chunked", "multipart")}
        steps["1 write"].update({
            "objects": len(content), "bytes": written, "chunks": n_chunks,
            "ways": ways, "put_s": dt_up,
            "mbps": written / steps["1 write"]["wall_s"] / 1e6})
        plog(f"1 write: bucket {S3_BUCKET} created by W, {len(content)} "
             f"objects ({FS_MIN_SIZE}-{FS_MAX_SIZE} B log-uniform), "
             f"{written} B in {n_chunks} chunks PUT through G from "
             f"{S3_THREADS} threads at {written / dt_up / 1e6:.1f} MB/s: "
             f"{ways['put']} signed PUTs with the payload's SHA-256, "
             f"{ways['chunked']} aws-chunked, {ways['multipart']} "
             f"multipart of {mp_sizes} B in {n_parts} parts of "
             f"{S3_PART} B; every ETag the object's MD5 (-{n_parts} on "
             f"the MD5 of the parts' MD5s); K1 0")

        # 2 ec.encode -collection p26, once a beat reports the sizes
        def p26_view() -> dict:
            return {vi["id"]: vi["size"]
                    for nd in topo()["nodes"].values()
                    for vi in nd["volume_infos"]
                    if vi["collection"] == S3_BUCKET}
        vols = {vid: servers[holder_of(vid)].store.get_volume(vid)
                for vid in p26_view()}
        for vol in vols.values():
            vol.flush()
        dat_size = {vid: vol.data_size() for vid, vol in vols.items()}
        p26 = until(lambda: (lambda seen: seen if seen == dat_size
                             else None)(p26_view()),
                    f"no beat reported the p26 sizes {dat_size}")
        units = {vid: predict_units(p26[vid], layout.LARGE_BLOCK_SIZE,
                                    layout.SMALL_BLOCK_SIZE)
                 for vid in p26}
        k0 = dict(launches)
        t0 = time.perf_counter()
        run("lock")
        out2 = run(f"ec.encode -collection {S3_BUCKET} "
                   f"-fullPercent 0 -quietFor 0s")
        run("unlock")
        dt_enc = time.perf_counter() - t0
        listed = json.loads(out2.splitlines()[0].split(": ", 1)[1])
        if listed != sorted(p26):
            raise AssertionError(f"ec.encode selected {listed}; the "
                                 f"p26 volumes are {sorted(p26)}")
        step_counts("2 encode", k0, sum(units.values()), t0)
        until(lambda: all(sum(map(len, split(vid).values())) == 14
                          for vid in listed),
              "the p26 shard sets never reached the master")
        dat_bytes = sum(p26.values())
        steps["2 encode"].update({"s": dt_enc, "volumes": listed,
                                  "dat_bytes": p26, "units": units,
                                  "mbps": dat_bytes / dt_enc / 1e6})
        plog(f"2 encode: `ec.encode -collection {S3_BUCKET}` of volumes "
             f"{listed} (.dat {[p26[v] for v in listed]} B) in "
             f"{dt_enc:.3f} s, {dat_bytes / dt_enc / 1e6:.1f} MB/s; K1 "
             f"{sum(units.values())} == the layout's units")

        # 3 data shards 0 and 3 of every p26 EC volume deleted
        k0 = dict(launches)
        t0 = time.perf_counter()
        for vid in listed:
            for u, shards in split(vid).items():
                gone = [s for s in S3_LOST if s in shards]
                if gone:
                    admin(node_of[u], "/admin/ec/delete_shards",
                          {"volume": vid, "shards": gone})
        until(lambda: not any(set(S3_LOST) & set(s) for vid in listed
                              for s in split(vid).values()),
              "the master still shows the deleted shards")
        step_counts("3 loss", k0, 0, t0)
        plog(f"3 loss: data shards {list(S3_LOST)} of every p26 EC "
             f"volume deleted where they lived; K1 0")

        evs = {vid: next(servers[n].store.get_ec_volume(vid)
                         for n in names
                         if servers[n].store.get_ec_volume(vid)
                         is not None) for vid in listed}

        def touches(fid: str) -> bool:
            f = t.FileId.parse(fid)
            return bool(touching_needles(evs[f.volume_id], {f.key: None},
                                         S3_LOST))

        # 4 every object read in full through G
        keys = sorted(content)
        want_sha = {k: hashlib.sha256(c).hexdigest()
                    for k, c in content.items()}
        views = {k: {v.fid for v in ChunkGroup(e.chunks).read_views(
            0, e.size())} for k, e in entries.items()}
        needed = set().union(*views.values())
        touching = {f for f in needed if touches(f)}
        empty_lrus()
        resilience.reset_latency_trackers()
        resilience.reset_breakers()
        direct0 = F.hot_stats["direct"]
        fget = metrics.FILER_REQUEST_HISTOGRAM.labels("get")
        fget0 = (fget.total, fget.count)
        client_s = [0.0]
        led3 = ledger()
        k0 = dict(launches)
        t0 = time.perf_counter()

        def read(key) -> None:
            t_req = time.perf_counter()
            st, hdrs, body = s3("W", "GET", key)
            dt = time.perf_counter() - t_req
            with ok_lock:
                client_s[0] += dt
            if st != 200 or hashlib.sha256(body).hexdigest() != \
                    want_sha[key] or hdrs.get("etag") != f'"{md5[key]}"':
                raise AssertionError(f"GET {key}: HTTP {st}, {len(body)} "
                                     f"B, ETag {hdrs.get('etag')}: not "
                                     f"the draw")
        dt_read = fan(read, keys, S3_THREADS)
        direct = F.hot_stats["direct"] - direct0
        if direct != len(needed):
            raise AssertionError(f"F fetched {direct} chunks from the "
                                 f"volume tier; {len(needed)} distinct "
                                 f"chunks were read")
        step_counts("4 degraded", k0, len(touching), t0)
        # F's GETs: one per object, and any of G's bucket-policy
        # refreshes that fell in the step
        f_s, f_n = fget.total - fget0[0], fget.count - fget0[1]
        if f_n < len(keys):
            raise AssertionError(f"F timed {f_n} GETs, {len(keys)} made")
        steps["4 degraded"].update({
            "objects": len(keys), "chunks": len(needed),
            "touching": len(touching), "s": dt_read,
            "mbps": written / dt_read / 1e6, "filer_get_s": f_s,
            "filer_gets": f_n, "client_get_s": client_s[0]})
        plog(f"4 degraded: {len(keys)} objects read in full through G "
             f"from {S3_THREADS} threads, each sha256 == its draw and its "
             f"ETag its MD5: {written} B in {dt_read:.3f} s, "
             f"{written / dt_read / 1e6:.1f} MB/s; F's direct {direct} == "
             f"the {len(needed)} distinct chunks; seconds summed over "
             f"the GETs: F's {f_s:.3f} over {f_n} (its request "
             f"histogram), the "
             f"client's {client_s[0]:.3f} ({f_s / client_s[0]:.3f} of it "
             f"in F); K1 {len(touching)} == the fetches touching shards "
             f"{list(S3_LOST)}")
        led4 = ledger()

        # 5 listing, ranges and auth
        k0 = dict(launches)
        t0 = time.perf_counter()
        listing, token, pages = [], "", 0
        while True:
            q = {"list-type": "2", "max-keys": str(S3_PAGE)}
            if token:
                q["continuation-token"] = token
            st, _, raw = s3("W", "GET", query=q)
            if st != 200:
                raise AssertionError(f"ListObjectsV2 page {pages}: HTTP "
                                     f"{st} {raw[:200]!r}")
            pages += 1
            page = re.findall(rb"<Key>([^<]*)</Key>.*?<Size>(\d+)</Size>",
                              raw)
            if len(page) > S3_PAGE:
                raise AssertionError(f"page {pages}: {len(page)} keys")
            listing += [(k.decode(), int(n)) for k, n in page]
            m = re.search(rb"<NextContinuationToken>([^<]*)<", raw)
            if b"<IsTruncated>true" not in raw:
                break
            token = urllib.parse.unquote(m.group(1).decode())
        if listing != [(k, len(content[k])) for k in keys] or \
                pages != -(-len(keys) // S3_PAGE):
            raise AssertionError(f"ListObjectsV2 at max-keys {S3_PAGE}: "
                                 f"{len(listing)} keys in {pages} pages, "
                                 f"{len(keys)} written")
        spans = {}
        for k in keys:
            n = len(content[k])
            lo = int(rng.integers(0, n))
            spans[k] = (lo, int(rng.integers(lo, n)))
        direct0 = F.hot_stats["direct"]
        t_rng = time.perf_counter()

        def ranged(key) -> None:
            lo, hi = spans[key]
            n = len(content[key])
            st, hdrs, body = s3("R", "GET", url=presign("R", key),
                                headers={"Range": f"bytes={lo}-{hi}"})
            if st != 206 or body != content[key][lo:hi + 1] or \
                    hdrs.get("content-range") != f"bytes {lo}-{hi}/{n}":
                raise AssertionError(f"presigned Range {lo}-{hi} of {key}"
                                     f": HTTP {st} "
                                     f"{hdrs.get('content-range')}")
            st, hdrs, _ = s3("W", "HEAD", key)
            if st != 200 or hdrs.get("content-length") != str(n):
                raise AssertionError(f"HEAD {key}: HTTP {st} {hdrs}")
        dt_ranged = fan(ranged, keys, S3_THREADS)
        if F.hot_stats["direct"] != direct0:
            raise AssertionError("step 5 fetched from the volume tier")
        st, _, raw = s3("R", "PUT", "r-was-here.bin", body=b"denied")
        if st != 403 or b"<Code>AccessDenied</Code>" not in raw:
            raise AssertionError(f"R's PUT: HTTP {st} {raw[:200]!r}")
        policy = json.dumps({"Version": "2012-10-17", "Statement": [{
            "Effect": "Deny", "Principal": {"AWS": "arn:aws:iam:::user/R"},
            "Action": "s3:GetObject",
            "Resource": f"arn:aws:s3:::{S3_BUCKET}/{S3_DENIED}*"}]})
        st, _, raw = s3("W", "PUT", query={"policy": ""},
                        body=policy.encode())
        if st != 204:
            raise AssertionError(f"PUT policy: HTTP {st} {raw[:200]!r}")
        denied = [k for k in keys if k.startswith(S3_DENIED)]
        allowed = [k for k in keys if not k.startswith(S3_DENIED)]
        for k in denied[:4]:
            st, _, raw = s3("R", "GET", url=presign("R", k))
            if st != 403 or b"<Code>AccessDenied</Code>" not in raw:
                raise AssertionError(f"R's GET of {k} under the policy: "
                                     f"HTTP {st} {raw[:200]!r}")
        for k in allowed[:4]:
            st, _, body = s3("R", "GET", url=presign("R", k))
            if st != 200 or body != content[k]:
                raise AssertionError(f"R's GET of {k}: HTTP {st}")
        step_counts("5 list", k0, 0, t0)
        ranged_bytes = sum(hi - lo + 1 for lo, hi in spans.values())
        steps["5 list"].update({
            "pages": pages, "ranged_bytes": ranged_bytes,
            "ranged_s": dt_ranged,
            "mbps": ranged_bytes / dt_ranged / 1e6})
        plog(f"5 list: ListObjectsV2 at max-keys {S3_PAGE} lists the "
             f"{len(keys)} keys once, in order, with their sizes, in "
             f"{pages} pages; a Range GET presigned by R and a HEAD of "
             f"each object, equal to its draw: {ranged_bytes} B in "
             f"{dt_ranged:.3f} s, {ranged_bytes / dt_ranged / 1e6:.1f} "
             f"MB/s, no volume-tier fetch; R's PUT 403 AccessDenied; a "
             f"policy denying R s3:GetObject on {S3_DENIED}: 4 of its "
             f"{len(denied)} objects 403 for R, 4 others 200; K1 0")

        # 6 the tenant counters and the shell
        k0 = dict(launches)
        t0 = time.perf_counter()
        led = ledger()
        for who, c in creds.items():
            got = led["req"].get(c.access_key, 0) - \
                led0["req"].get(c.access_key, 0)
            want = ok_by_key[c.access_key] - ok0[c.access_key]
            if got != want:
                raise AssertionError(f"{who}'s tenant requests {got}; the "
                                     f"phase made {want} successful ones")
        # over steps 1 and 4, whose client data-class traffic is G's
        # clients' (steps 2-3 poll the master through another client).
        # Received bytes conserve exactly; the sent ones also hold the
        # master's answers to F's EC location lookups, which book under
        # the client role too, so they agree within 1 %
        cons = {d: tuple(led1[k][d] - led0[k][d] + led4[k][d] -
                         led3[k][d] for k in ("tenant", "flow"))
                for d in ("recv", "sent")}
        ten, flow = cons["recv"]
        if not ten or ten != flow:
            raise AssertionError(f"steps 1 and 4: tenant recv bytes "
                                 f"{ten}; the ledger's client data recv "
                                 f"{flow}")
        ten, flow = cons["sent"]
        if not ten or not ten <= flow <= 1.01 * ten:
            raise AssertionError(f"steps 1 and 4: tenant sent bytes "
                                 f"{ten}; the ledger's client data sent "
                                 f"{flow}")
        out = run("s3.bucket.list")
        if S3_BUCKET not in out.split():
            raise AssertionError(f"s3.bucket.list: {out!r}")
        run("lock")
        out = run("s3.configure -list")
        run("unlock")
        if sorted(line.split(":")[0] for line in out.splitlines()) != \
                ["R", "W"]:
            raise AssertionError(f"s3.configure -list: {out!r}")
        step_counts("6 tenants", k0, 0, t0)
        steps["6 tenants"].update({
            "requests": {who: ok_by_key[c.access_key] - ok0[c.access_key]
                         for who, c in creds.items()},
            "bytes": cons})
        plog(f"6 tenants: weedtpu_tenant_requests_total W "
             f"{steps['6 tenants']['requests']['W']}, R "
             f"{steps['6 tenants']['requests']['R']} == the phase's "
             f"successful requests; weedtpu_tenant_bytes_total over "
             f"steps 1 and 4 recv {cons['recv'][0]:.0f} B == the "
             f"ledger's client data recv {cons['recv'][1]:.0f} B, sent "
             f"{cons['sent'][0]:.0f} B against its "
             f"{cons['sent'][1]:.0f} B; "
             f"s3.bucket.list and s3.configure -list; K1 0")

        # 7 a quarter of the keys deleted in one DeleteObjects
        doomed = sorted(rng.choice([k for k in keys
                                    if k not in multipart],
                                   size=len(keys) // 4 - 1,
                                   replace=False).tolist()) + [multipart[0]]
        freed = {c.fid for k in doomed for c in entries[k].chunks}
        holders = {vid: sorted(split(vid)) for vid in listed}
        k0 = dict(launches)
        t0 = time.perf_counter()
        deleted0 = F.deletion.deleted_count
        body = ("<Delete>" + "".join(f"<Object><Key>{k}</Key></Object>"
                                     for k in doomed) + "</Delete>")
        st, _, raw = s3("W", "POST", query={"delete": ""},
                        body=body.encode())
        if st != 200 or raw.count(b"<Deleted>") != len(doomed) or \
                b"<Error>" in raw:
            raise AssertionError(f"DeleteObjects: HTTP {st} {raw[:300]!r}")
        until(lambda: F.deletion.pending_count() == 0 and
              F.deletion.deleted_count + F.deletion.error_count -
              deleted0 >= len(freed), "F's deletion queue never drained",
              timeout=120)
        dt_drain = time.perf_counter() - t0
        if F.deletion.error_count or \
                F.deletion.deleted_count - deleted0 != len(freed):
            raise AssertionError(f"F's queue deleted "
                                 f"{F.deletion.deleted_count - deleted0} "
                                 f"of {len(freed)} fids, "
                                 f"{F.deletion.error_count} errors")

        def gone(fid: str) -> None:
            for u in holders[int(fid.split(",")[0])]:
                st, _, _ = racks.http.request(f"http://{u}/{fid}")
                if st != 404:
                    raise AssertionError(f"freed {fid} answers {st} on "
                                         f"{node_of[u]}")
        fan(gone, sorted(freed), S3_THREADS)
        st, hdrs, body = s3("W", "GET", multipart[1])
        if st != 200 or hashlib.sha256(body).hexdigest() != \
                want_sha[multipart[1]]:
            raise AssertionError(f"{multipart[1]} after the deletion: "
                                 f"HTTP {st}, not its draw")
        st, _, raw = s3("W", "GET", query={"list-type": "2"})
        if st != 200 or raw.count(b"<Key>") != len(keys) - len(doomed):
            raise AssertionError(f"the listing after the deletion: HTTP "
                                 f"{st}, {raw.count(b'<Key>')} keys")
        step_counts("7 delete", k0, 0, t0)
        steps["7 delete"].update({"objects": len(doomed),
                                  "freed": len(freed), "drain_s": dt_drain})
        plog(f"7 delete: DeleteObjects of {len(doomed)} keys ({multipart[0]}"
             f" among them); F's queue freed {len(freed)} fids in "
             f"{dt_drain:.3f} s, each 404 on every holder; "
             f"{multipart[1]} still reads equal to its draw; K1 0")
    finally:
        if G is not None:
            grun(G.stop())
        if F is not None:
            frun(F.stop())
        stop_loops(loops)
        if pool is not None:
            pool.close()
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "steps": steps, "counts": counts,
           "predicted": predicted, "s": time.perf_counter() - t_phase}
    plog(f"launches per step {counts} (K1 predicted {predicted}); phase "
         f"wall {out['s']:.1f} s")
    return out


# phase 27's WebDAV gateway and mount (ROADMAP 1.21b) and the CLI's
# offline tools (1.19c): one port FilerServer F, one port WebDavServer D
# and one port WFS M (the mount's VFS core, driven without a kernel
# mount) on phase 23's cluster
DAV_COLLECTION = "p27"  # F's collection: every chunk of the phase
DAV_BYTES = 128 * MIB  # the gateway's files, from --seed
DAV_DIRS = 4  # /p27/dav/d0..d3, and d0/deep
DAV_CACHE_MEM = 512 * MIB  # F's: no chunk evicted in the phase
DAV_LOST = (0, 3)  # step 3's lost data shards of every p27 EC volume
DAV_THREADS = 16
MNT_WRITE = 256 << 10  # the mount's application write size
MNT_READ = 4 * MIB  # the mount's reads at offsets in step 4
MNT_THREADS = 8
# the CLI's offline tools, in one child on the card's host: backup of a
# volume from its server, the backup's .idx rebuilt by fix, export and
# compact of the copy; it reports whether it loaded torch or jax
OFFLINE_CHILD = r"""
import json, os, shutil, sys
from seaweedfs_tpu_torch.__main__ import main
url, vid, col, bk = sys.argv[1:5]
base = os.path.join(bk, f"{col}_{vid}")
def run(*argv):
    rc = main(list(argv))
    if rc:
        raise SystemExit(f"{argv[0]} exited {rc}")
run("backup", "-server", url, "-volumeId", vid, "-collection", col,
    "-dir", bk)
shutil.copyfile(base + ".dat", base + ".dat.backup")
os.remove(base + ".idx")
run("fix", "-dir", bk, "-volumeId", vid, "-collection", col)
shutil.copyfile(base + ".idx", base + ".idx.fixed")
run("export", "-dir", bk, "-volumeId", vid, "-collection", col, "-o",
    base + ".tar")
run("compact", "-dir", bk, "-volumeId", vid, "-collection", col)
print(json.dumps({m: m in sys.modules for m in ("torch", "jax")}))
"""


def phase_webdav(racks: ThreeRacks, vdir: str, seed: int,
                 launches: dict) -> dict:
    """Phase 27: the port's WebDAV gateway and mount (ROADMAP 1.21b) and
    the CLI's offline tools (1.19c) over `racks`, phase 23's three port
    `VolumeServer`s on the card in three racks behind the port's
    `MasterServer`, kept up for it.  One port `FilerServer` F on a loop
    thread of its own (a fresh SQLite store, every chunk into collection
    p27, a 512 MiB chunk cache), one port `WebDavServer` D over F on
    another, and one port `WFS` M over F, its meta subscription on and
    its admin socket started; M is driven through its VFS calls, with no
    kernel mount.  Steps: (1) a MKCOL tree and 128 MiB of files from
    --seed (1 KiB-32 MiB, log-uniform) PUT through D from 16 threads;
    36.5 MiB through M: a file written sequentially in 256 KiB
    writes, a sparse one, appends, an overwrite in place, a truncate, a
    symlink, a hard link and an xattr; K1 0; (2) `ec.encode -collection
    p27` through the port's shell, K1 == the layout's units of the p27
    .dat files; (3) data shards 0 and 3 of every p27 EC volume deleted,
    K1 0; (4) every file read in full through D from 16 threads, sha256
    == its draw (F's `direct` == the distinct chunks, K1 == those
    fetches whose needle touches a lost data shard), then a Range GET of
    each through D and reads of each through M at offsets, every byte
    equal; the symlink, hard link and xattr through M; (5) PROPFIND at
    Depth 1 of each directory == F's listing of it; a MOVE of a subtree
    and a COPY of another through D, M's meta cache seeing the new
    names through its subscription (a cached lookup of each name made
    before), K1 0; (6) `mount.configure -dir <M's mountpoint>` through
    the port's shell: a quota under M's usage makes a write fail with
    errno 122 (EDQUOT), clearing it lets the write through, K1 0; (7) a
    DELETE through D of a subtree, a copy and a file: once F's deletion queue
    drains, every freed fid answers 404 on every holder, K1 0; (8) on
    the card's host, a child running the CLI: `backup` of a p27 volume
    from its card server (.dat byte-equal), `fix` of the backup's
    removed .idx (== the server's live needle map), `export` (each tar
    member == its needle) and `compact` of the copy (each needle read
    back), no torch loaded, K1 0.  K2 0 throughout."""
    import tarfile
    import urllib.parse
    import xml.etree.ElementTree as ET

    import numpy as np
    from seaweedfs_tpu_torch.filer.filechunk_section import ChunkGroup
    from seaweedfs_tpu_torch.mount import weedfs
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.server.webdav_server import WebDavServer
    from seaweedfs_tpu_torch.storage import idx as idxf
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout
    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE
    from seaweedfs_tpu_torch.storage.volume import Volume
    from seaweedfs_tpu_torch.utils import http, resilience

    card = card_name_power()

    def plog(msg: str) -> None:
        log(f"[webdav] {msg} [{card}]")

    work = os.path.join(vdir, "webdav")
    os.makedirs(work)
    names, servers = racks.names, racks.servers
    node_of, master = racks.node_of, racks.master
    admin, run, split, topo = racks.admin, racks.run, racks.split, racks.topo
    holder_of = racks.holder_of
    loops: list = []
    frun = drun = F = D = M = pool = None
    steps: dict = {}
    counts: dict = {}
    predicted: dict = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 27)
    dav_root, mnt_root = f"/{DAV_COLLECTION}/dav", f"/{DAV_COLLECTION}/m"

    def step_counts(name: str, k0: dict, k1: int, t0: float) -> None:
        got = {k: launches[k] - k0[k] for k in launches}
        counts[name] = got
        predicted[name] = k1
        steps.setdefault(name, {})["wall_s"] = time.perf_counter() - t0
        want = {"gf_apply": k1, "gf_apply_batch": 0}
        if got != want:
            raise AssertionError(f"phase 27 {name}: launched {got}, "
                                 f"predicted {want}")

    def empty_lrus() -> None:
        """No server's reconstruction LRU answers a read this step
        predicts a launch for."""
        for vs in servers.values():
            for loc in vs.store.locations:
                for ev in list(loc.ec_volumes.values()):
                    with ev._recon_lock:
                        ev._recon_cache.clear()
                        ev._recon_cache_bytes = 0

    def dav(method: str, path: str, body=None, headers=None) -> tuple:
        return pool.request(f"http://{D.url}{urllib.parse.quote(path)}",
                            method, body, headers or {})

    def must(method: str, path: str, want: int, body=None,
             headers=None) -> tuple:
        st, hdrs, raw = dav(method, path, body, headers)
        if st != want:
            raise AssertionError(f"{method} {path} through D: HTTP {st} "
                                 f"{raw[:200]!r}, wanted {want}")
        return st, hdrs, raw

    def propfind(path: str) -> dict:
        """name -> (is a collection, getcontentlength) of `path`'s
        members, by D's multistatus at Depth 1."""
        _, _, raw = must("PROPFIND", path, 207, headers={"Depth": "1"})
        out = {}
        for resp in ET.fromstring(raw).iter("{DAV:}response"):
            href = urllib.parse.unquote(resp.find("{DAV:}href").text)
            name = href.rstrip("/").rsplit("/", 1)[-1]
            if href.rstrip("/") == path.rstrip("/"):
                continue
            n = resp.find(".//{DAV:}getcontentlength")
            out[name] = (resp.find(".//{DAV:}collection") is not None,
                         None if n is None else int(n.text))
        return out

    try:
        # 0 set-up.  Phase 26's filer stopped moments ago and the master
        # lists a member for 30 s after its last beat: it leaves the
        # table first, so F's hot ring holds F alone
        async def forget_filers() -> None:
            master.cluster_members.pop("filer", None)
        racks.mrun(forget_filers())
        frun, drun = loop_thread(loops), loop_thread(loops)
        F = FilerServer(master.url, "127.0.0.1", free_port(),
                        data_dir=os.path.join(work, "filer"),
                        collection=DAV_COLLECTION,
                        chunk_cache_mem=DAV_CACHE_MEM)
        frun(F.start())
        until(lambda: racks.cmd_env.master_get("/cluster/status").get(
            "Members", {}).get("filer") == [F.url],
            "the master never listed F alone")
        D = WebDavServer(F.url, "127.0.0.1", free_port())
        drun(D.start())
        mnt = os.path.join(work, "mnt")
        os.makedirs(mnt)
        M = weedfs.WFS(F.url, subscribe=True)
        weedfs.start_admin_socket(M, mnt)
        until(lambda: F._subscribers, "M's meta feed never subscribed")
        pool = http.PooledHTTP(timeout=600.0, max_idle_per_host=DAV_THREADS)

        # 1 the gateway's tree and files, then the mount's
        t0 = time.perf_counter()
        k0 = dict(launches)
        dirs = [f"{dav_root}/d{i}" for i in range(DAV_DIRS)]
        for d in [f"/{DAV_COLLECTION}", dav_root, *dirs,
                  f"{dav_root}/d0/deep"]:
            must("MKCOL", d, 201)
        sizes: list = []
        while sum(sizes) < DAV_BYTES:
            sizes.append(min(int(np.exp(rng.uniform(
                np.log(FS_MIN_SIZE), np.log(FS_MAX_SIZE)))),
                DAV_BYTES - sum(sizes)))
        if sizes[-1] < FS_MIN_SIZE:  # the remainder joins the last
            sizes[-2] += sizes.pop()
        payload = rng.bytes(DAV_BYTES)
        content: dict = {}  # path -> the file's bytes
        at = 0
        for i, size in enumerate(sizes):
            d = f"{dav_root}/d0/deep" if i % 8 == 0 else dirs[i % DAV_DIRS]
            content[f"{d}/f{i:03d}.bin"] = payload[at:at + size]
            at += size
        dav_paths = sorted(content)

        def put(path: str) -> None:
            must("PUT", path, 201, content[path],
                 {"Content-Type": "application/octet-stream"})
        dt_dav = fan(put, dav_paths, DAV_THREADS)

        t_m = time.perf_counter()
        model: dict = {}  # the mount's files as M was asked to leave them

        def m_write(path: str, writes, create: bool) -> None:
            fh = M.create(path) if create else M.open(path)
            buf = model.setdefault(path, bytearray())
            for off, data in writes:
                if M.write(fh, data, off) != len(data):
                    raise AssertionError(f"M's write at {off} of {path}")
                if off > len(buf):
                    buf.extend(bytes(off - len(buf)))
                buf[off:off + len(data)] = data
            M.release(fh)
        M.mkdir(mnt_root)
        seq = rng.bytes(12 * MIB)
        m_write(f"{mnt_root}/seq.bin",
                [(o, seq[o:o + MNT_WRITE])
                 for o in range(0, len(seq), MNT_WRITE)], True)
        m_write(f"{mnt_root}/sparse.bin",
                [(0, rng.bytes(MIB)), (9 * MIB, rng.bytes(MIB))], True)
        m_write(f"{mnt_root}/append.bin", [], True)
        for _ in range(4):
            end = len(model[f"{mnt_root}/append.bin"])
            m_write(f"{mnt_root}/append.bin",
                    [(end, rng.bytes(3 * MIB // 2))], False)
        m_write(f"{mnt_root}/over.bin", [(0, rng.bytes(6 * MIB))], True)
        m_write(f"{mnt_root}/over.bin", [(3 * MIB, rng.bytes(MIB // 2))],
                False)
        m_write(f"{mnt_root}/trunc.bin", [(0, rng.bytes(4 * MIB))], True)
        M.truncate(f"{mnt_root}/trunc.bin", 5 * MIB // 2)
        del model[f"{mnt_root}/trunc.bin"][5 * MIB // 2:]
        M.symlink("seq.bin", f"{mnt_root}/link")
        M.link(f"{mnt_root}/over.bin", f"{mnt_root}/hard.bin")
        model[f"{mnt_root}/hard.bin"] = model[f"{mnt_root}/over.bin"]
        seq_sha = hashlib.sha256(seq).hexdigest()
        M.setxattr(f"{mnt_root}/seq.bin", "user.sha256", seq_sha.encode())
        dt_m = time.perf_counter() - t_m
        content.update({p: bytes(b) for p, b in model.items()})
        m_bytes = sum(len(b) for p, b in model.items()
                      if not p.endswith("hard.bin"))
        step_counts("1 write", k0, 0, t0)
        sha = {p: hashlib.sha256(c).hexdigest() for p, c in content.items()}
        entries = {p: F.filer.find_entry(p) for p in content}
        n_chunks = len({c.fid for e in entries.values() for c in e.chunks})
        written = sum(sizes)
        steps["1 write"].update({
            "dav_files": len(dav_paths), "dav_bytes": written,
            "dav_s": dt_dav, "dav_mbps": written / dt_dav / 1e6,
            "mount_files": len(model), "mount_bytes": m_bytes,
            "mount_s": dt_m, "mount_mbps": m_bytes / dt_m / 1e6,
            "chunks": n_chunks})
        plog(f"1 write: {DAV_DIRS + 3} collections and {len(dav_paths)} "
             f"files ({FS_MIN_SIZE}-{FS_MAX_SIZE} B log-uniform), "
             f"{written} B PUT through D from {DAV_THREADS} threads at "
             f"{written / dt_dav / 1e6:.1f} MB/s; through M {m_bytes} B in "
             f"{dt_m:.3f} s ({m_bytes / dt_m / 1e6:.1f} MB/s): 12 MiB in "
             f"{MNT_WRITE} B writes, a sparse file, 4 appends, an "
             f"overwrite in place, a truncate, a symlink, a hard link and "
             f"an xattr; {n_chunks} chunks; K1 0")

        # 2 ec.encode -collection p27, once a beat reports the sizes
        def p27_view() -> dict:
            return {vi["id"]: vi["size"]
                    for nd in topo()["nodes"].values()
                    for vi in nd["volume_infos"]
                    if vi["collection"] == DAV_COLLECTION}
        vols = {vid: servers[holder_of(vid)].store.get_volume(vid)
                for vid in p27_view()}
        for vol in vols.values():
            vol.flush()
        dat_size = {vid: vol.data_size() for vid, vol in vols.items()}
        p27 = until(lambda: (lambda seen: seen if seen == dat_size
                             else None)(p27_view()),
                    f"no beat reported the p27 sizes {dat_size}")
        units = {vid: predict_units(p27[vid], layout.LARGE_BLOCK_SIZE,
                                    layout.SMALL_BLOCK_SIZE)
                 for vid in p27}
        k0 = dict(launches)
        t0 = time.perf_counter()
        run("lock")
        out2 = run(f"ec.encode -collection {DAV_COLLECTION} "
                   f"-fullPercent 0 -quietFor 0s")
        run("unlock")
        dt_enc = time.perf_counter() - t0
        listed = json.loads(out2.splitlines()[0].split(": ", 1)[1])
        if listed != sorted(p27):
            raise AssertionError(f"ec.encode selected {listed}; the "
                                 f"p27 volumes are {sorted(p27)}")
        step_counts("2 encode", k0, sum(units.values()), t0)
        until(lambda: all(sum(map(len, split(vid).values())) == 14
                          for vid in listed),
              "the p27 shard sets never reached the master")
        dat_bytes = sum(p27.values())
        steps["2 encode"].update({"s": dt_enc, "volumes": listed,
                                  "dat_bytes": p27, "units": units,
                                  "mbps": dat_bytes / dt_enc / 1e6})
        plog(f"2 encode: `ec.encode -collection {DAV_COLLECTION}` of "
             f"volumes {listed} (.dat {[p27[v] for v in listed]} B) in "
             f"{dt_enc:.3f} s, {dat_bytes / dt_enc / 1e6:.1f} MB/s; K1 "
             f"{sum(units.values())} == the layout's units")

        # 3 data shards 0 and 3 of every p27 EC volume deleted
        k0 = dict(launches)
        t0 = time.perf_counter()
        for vid in listed:
            for u, shards in split(vid).items():
                gone = [s for s in DAV_LOST if s in shards]
                if gone:
                    admin(node_of[u], "/admin/ec/delete_shards",
                          {"volume": vid, "shards": gone})
        until(lambda: not any(set(DAV_LOST) & set(s) for vid in listed
                              for s in split(vid).values()),
              "the master still shows the deleted shards")
        step_counts("3 loss", k0, 0, t0)
        plog(f"3 loss: data shards {list(DAV_LOST)} of every p27 EC "
             f"volume deleted where they lived; K1 0")

        evs = {vid: next(servers[n].store.get_ec_volume(vid)
                         for n in names
                         if servers[n].store.get_ec_volume(vid)
                         is not None) for vid in listed}

        def touches(fid: str) -> bool:
            f = t.FileId.parse(fid)
            return bool(touching_needles(evs[f.volume_id], {f.key: None},
                                         DAV_LOST))

        # 4 every file read back through D, whole and ranged, and through
        # M at offsets
        files = sorted(content)
        views = {p: {v.fid for v in ChunkGroup(e.chunks).read_views(
            0, e.size())} for p, e in entries.items()}
        needed = set().union(*views.values())
        touching = {f for f in needed if touches(f)}
        total = sum(len(content[p]) for p in files)
        empty_lrus()
        resilience.reset_latency_trackers()
        resilience.reset_breakers()
        direct0 = F.hot_stats["direct"]
        k0 = dict(launches)
        t0 = time.perf_counter()

        def whole(path: str) -> None:
            st, _, body = dav("GET", path)
            if st != 200 or hashlib.sha256(body).hexdigest() != sha[path]:
                raise AssertionError(f"GET {path} through D: HTTP {st}, "
                                     f"{len(body)} B, not its draw")
        dt_whole = fan(whole, files, DAV_THREADS)
        direct = F.hot_stats["direct"] - direct0
        if direct != len(needed):
            raise AssertionError(f"F fetched {direct} chunks from the "
                                 f"volume tier; {len(needed)} distinct "
                                 f"chunks were read")
        spans = {}
        for p in files:
            n = len(content[p])
            lo = int(rng.integers(0, n))
            spans[p] = (lo, int(rng.integers(lo, n)))

        def ranged(path: str) -> None:
            lo, hi = spans[path]
            st, hdrs, body = dav("GET", path,
                                 headers={"Range": f"bytes={lo}-{hi}"})
            if st != 206 or body != content[path][lo:hi + 1]:
                raise AssertionError(f"Range {lo}-{hi} of {path} through "
                                     f"D: HTTP {st}")
        dt_ranged = fan(ranged, files, DAV_THREADS)
        offsets = {p: list(range(0, len(content[p]), MNT_READ)) +
                   [int(rng.integers(0, len(content[p])))] for p in files}

        def m_read(path: str) -> None:
            data = content[path]
            fh = M.open(path)
            try:
                for off in offsets[path]:
                    got = M.read(fh, MNT_READ, off)
                    if got != data[off:off + MNT_READ]:
                        raise AssertionError(f"M's read of {path} at "
                                             f"{off}: not its draw")
            finally:
                M.release(fh)
        dt_mread = fan(m_read, files, MNT_THREADS)
        if M.readlink(f"{mnt_root}/link") != "seq.bin" or \
                M.getxattr(f"{mnt_root}/seq.bin", "user.sha256") != \
                seq_sha.encode() or \
                M.getattr(f"{mnt_root}/hard.bin")["st_nlink"] != 2:
            raise AssertionError("M's symlink, xattr or hard link")
        if F.hot_stats["direct"] - direct0 != len(needed):
            raise AssertionError("the ranged and mount reads fetched from "
                                 "the volume tier")
        step_counts("4 read", k0, len(touching), t0)
        ranged_bytes = sum(hi - lo + 1 for lo, hi in spans.values())
        steps["4 read"].update({
            "files": len(files), "bytes": total, "chunks": len(needed),
            "touching": len(touching), "whole_s": dt_whole,
            "whole_mbps": total / dt_whole / 1e6,
            "ranged_bytes": ranged_bytes, "ranged_s": dt_ranged,
            "mount_s": dt_mread, "mount_mbps": total / dt_mread / 1e6})
        plog(f"4 read: {len(files)} files read in full through D from "
             f"{DAV_THREADS} threads, each sha256 == its draw: {total} B "
             f"in {dt_whole:.3f} s, {total / dt_whole / 1e6:.1f} MB/s "
             f"degraded; F's direct {direct} == the {len(needed)} distinct "
             f"chunks; a Range GET of each through D, {ranged_bytes} B in "
             f"{dt_ranged:.3f} s; each through M in {MNT_READ} B reads at "
             f"offsets from {MNT_THREADS} threads, {total} B in "
             f"{dt_mread:.3f} s ({total / dt_mread / 1e6:.1f} MB/s), "
             f"every byte equal; M's symlink, hard link (nlink 2) and "
             f"xattr; K1 {len(touching)} == the fetches touching shards "
             f"{list(DAV_LOST)}")

        # 5 listings, then a MOVE and a COPY of subtrees through D
        k0 = dict(launches)
        t0 = time.perf_counter()
        listed_dirs = [dav_root, *dirs, f"{dav_root}/d0/deep", mnt_root]
        for d in listed_dirs:
            got = propfind(d)
            want = {}
            for e in F.filer.list_entries(d, limit=100000):
                want[e.name] = (e.is_directory, None if e.is_directory
                                else F.filer.find_entry(e.full_path).size())
            if got != want:
                raise AssertionError(f"PROPFIND {d}: {got}; F lists "
                                     f"{want}")
        moved_from, moved_to = dirs[1], f"{dav_root}/moved"
        copied_from, copied_to = dirs[2], f"{dav_root}/copy"
        old = sorted(p for p in dav_paths if p.startswith(moved_from + "/"))
        new = [moved_to + p[len(moved_from):] for p in old]
        for p in old:
            M.getattr(p)  # cached in M's meta cache
        for p in new:
            try:
                M.getattr(p)  # a cached miss
                raise AssertionError(f"{p} exists before the MOVE")
            except weedfs.FsError:
                pass
        must("MOVE", moved_from, 201, b"",
             {"Destination": f"http://{D.url}{moved_to}"})
        t_seen = time.perf_counter()

        def sees_the_move() -> bool:
            for p in new:
                try:
                    M.getattr(p)
                except weedfs.FsError:
                    return False
            for p in old:
                try:
                    M.getattr(p)
                    return False
                except weedfs.FsError:
                    pass
            return True
        until(sees_the_move, "M's meta cache never saw the MOVE through "
              "its subscription")
        dt_seen = time.perf_counter() - t_seen
        for p, q in zip(old, new):
            content[q] = content.pop(p)
            sha[q] = sha.pop(p)
            entries[q] = entries.pop(p)
        fh = M.open(new[0])
        if M.read(fh, len(content[new[0]]), 0) != content[new[0]]:
            raise AssertionError(f"{new[0]} through M after the MOVE")
        M.release(fh)
        must("COPY", copied_from, 201, b"",
             {"Destination": f"http://{D.url}{copied_to}"})
        copies = sorted(p for p in content if p.startswith(copied_from + "/"))
        for p in copies:
            q = copied_to + p[len(copied_from):]
            st, _, body = dav("GET", q)
            if st != 200 or body != content[p]:
                raise AssertionError(f"COPY's {q}: HTTP {st}")
        step_counts("5 list", k0, 0, t0)
        steps["5 list"].update({"dirs": len(listed_dirs), "moved": len(old),
                                "seen_s": dt_seen, "copied": len(copies)})
        plog(f"5 list: PROPFIND at Depth 1 of {len(listed_dirs)} "
             f"collections == F's listings (names, kinds, sizes); MOVE of "
             f"{moved_from} ({len(old)} files) to {moved_to}, M's meta "
             f"cache saw every new name and lost every old one {dt_seen:.3f}"
             f" s after, through its subscription; COPY of {copied_from} "
             f"({len(copies)} files) to {copied_to}, each copy equal; K1 0")

        # 6 the mount's quota through the shell's mount.configure
        k0 = dict(launches)
        t0 = time.perf_counter()
        out6 = [run(f"mount.configure -dir {mnt}")]
        used = M._used_bytes()
        quota_mb = used // MIB - 1
        out6.append(run(f"mount.configure -dir {mnt} -quotaMB {quota_mb}"))
        if M.quota_bytes != quota_mb * MIB:
            raise AssertionError(f"M's quota {M.quota_bytes} after "
                                 f"-quotaMB {quota_mb}")
        qpath = f"{mnt_root}/quota.bin"
        qdata = rng.bytes(MIB)
        fh = M.create(qpath)
        try:
            M.write(fh, qdata, 0)
            raise AssertionError("a write over the quota went through")
        except weedfs.FsError as e:
            if e.errno != 122:
                raise
        out6.append(run(f"mount.configure -dir {mnt} -quotaMB 0"))
        M.write(fh, qdata, 0)
        M.release(fh)
        fh = M.open(qpath)
        if M.read(fh, MIB, 0) != qdata:
            raise AssertionError(f"{qpath} after the quota was cleared")
        M.release(fh)
        if "quota=unlimited" not in out6[0] or \
                f"quota={quota_mb}MB" not in out6[1] or \
                "quota=unlimited" not in out6[2]:
            raise AssertionError(f"mount.configure printed {out6}")
        step_counts("6 quota", k0, 0, t0)
        steps["6 quota"].update({"used": used, "quota_mb": quota_mb})
        plog(f"6 quota: `mount.configure -dir <mnt>` through the port's "
             f"shell: unlimited; -quotaMB {quota_mb} under M's {used} B "
             f"in use: a {MIB} B write failed with errno 122 (EDQUOT); "
             f"-quotaMB 0: the write went through and reads back; K1 0")

        # 7 DELETE through D: a subtree on the EC volumes, a copy on a
        # plain volume and a file the mount truncated
        copy_gone = copied_to + copies[0][len(copied_from):]
        doomed = [f"{dav_root}/d0", copy_gone, f"{mnt_root}/trunc.bin"]
        gone_paths = [p for p in content
                      if any(p == d or p.startswith(d + "/")
                             for d in doomed)]
        freed = {c.fid for p in gone_paths for c in entries[p].chunks} | \
            {c.fid for c in F.filer.find_entry(copy_gone).chunks}
        ec_holders = {vid: sorted(split(vid)) for vid in listed}
        k0 = dict(launches)
        t0 = time.perf_counter()
        deleted0 = F.deletion.deleted_count
        for d in doomed:
            must("DELETE", d, 204)
        until(lambda: F.deletion.pending_count() == 0 and
              F.deletion.deleted_count + F.deletion.error_count -
              deleted0 >= len(freed), "F's deletion queue never drained",
              timeout=120)
        dt_drain = time.perf_counter() - t0
        if F.deletion.error_count or \
                F.deletion.deleted_count - deleted0 != len(freed):
            raise AssertionError(f"F's queue deleted "
                                 f"{F.deletion.deleted_count - deleted0} "
                                 f"of {len(freed)} fids, "
                                 f"{F.deletion.error_count} errors")

        def gone(fid: str) -> None:
            vid = int(fid.split(",")[0])
            holders = ec_holders.get(vid) or \
                [servers[holder_of(vid)].url]
            for u in holders:
                st, _, _ = racks.http.request(f"http://{u}/{fid}")
                if st != 404:
                    raise AssertionError(f"freed {fid} answers {st} on "
                                         f"{node_of[u]}")
        fan(gone, sorted(freed), DAV_THREADS)
        for d in doomed:
            must("PROPFIND", d, 404, headers={"Depth": "0"})
        step_counts("7 delete", k0, 0, t0)
        steps["7 delete"].update({"paths": len(gone_paths) + 1,
                                  "freed": len(freed), "drain_s": dt_drain})
        plog(f"7 delete: DELETE of {doomed} through D "
             f"({len(gone_paths) + 1} files); F's queue freed "
             f"{len(freed)} fids in {dt_drain:.3f} s, each 404 on every "
             f"holder (EC shards and plain volumes); K1 0")

        # 8 the CLI's offline tools on the card's host
        plain = {vid: size for vid, size in p27_view().items()
                 if vid not in listed and size > SUPER_BLOCK_SIZE}
        if not plain:
            raise AssertionError("no plain p27 volume holds data after "
                                 "the encode")
        vid_b = max(plain, key=lambda v: (plain[v], -v))
        holder = servers[holder_of(vid_b)]
        vol = holder.store.get_volume(vid_b)
        vol.flush()
        bk = os.path.join(work, "backup")
        base = os.path.join(bk, f"{DAV_COLLECTION}_{vid_b}")
        k0 = dict(launches)
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", OFFLINE_CHILD, holder.url, str(vid_b),
             DAV_COLLECTION, bk], capture_output=True, text=True,
            timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
        dt_cli = time.perf_counter() - t0
        if child.returncode:
            raise AssertionError(f"the offline CLI child exited "
                                 f"{child.returncode}: "
                                 f"{child.stderr[-1500:]}")
        loaded = json.loads(child.stdout.strip().splitlines()[-1])
        if any(loaded.values()):
            raise AssertionError(f"the offline CLI loaded {loaded}")
        src = os.path.join(vol.dir, f"{DAV_COLLECTION}_{vid_b}")
        if sha256(base + ".dat.backup") != sha256(src + ".dat"):
            raise AssertionError(f"backup of volume {vid_b}: its .dat "
                                 f"differs from the server's")
        live = sorted((nid, off, size) for nid, (off, size)
                      in vol.nm.items() if t.size_is_valid(size))
        with open(base + ".idx.fixed", "rb") as f:
            raw = f.read()
        fixed = sorted(idxf.unpack_entry(raw[i:i + 16])
                       for i in range(0, len(raw), 16))
        if fixed != live:
            raise AssertionError(f"fix of volume {vid_b}: {len(fixed)} "
                                 f"entries; the server's map holds "
                                 f"{len(live)}")
        with tarfile.open(base + ".tar") as tar:
            members = {m.name: tar.extractfile(m).read()
                       for m in tar.getmembers()}
        needles = {nid: vol.read_needle(nid) for nid, _, _ in live}
        want_tar = {f"{vid_b}/{nid:x}_"
                    f"{n.name.decode(errors='replace') or f'{nid:x}'}":
                    n.data for nid, n in needles.items() if n.data}
        if members != want_tar:
            raise AssertionError(f"export of volume {vid_b}: "
                                 f"{len(members)} members against "
                                 f"{len(want_tar)} needles")
        compacted = Volume(bk, DAV_COLLECTION, vid_b)
        try:
            for nid, n in needles.items():
                if compacted.read_needle(nid).data != n.data:
                    raise AssertionError(f"needle {nid} after compact")
            compacted_size = compacted.data_size()
        finally:
            compacted.close()
        step_counts("8 offline", k0, 0, t0)
        steps["8 offline"].update({
            "volume": vid_b, "dat_bytes": os.path.getsize(src + ".dat"),
            "needles": len(live), "compacted_bytes": compacted_size,
            "cli_s": dt_cli})
        plog(f"8 offline: a child on the card's host ran the CLI's backup "
             f"of p27 volume {vid_b} from {node_of[holder.url]} "
             f"({os.path.getsize(src + '.dat')} B, .dat byte-equal), fix of "
             f"its removed .idx ({len(live)} entries == the server's map), "
             f"export ({len(members)} tar members == the needles) and "
             f"compact ({compacted_size} B, every needle read back) in "
             f"{dt_cli:.3f} s, loading neither torch nor jax; K1 0")
    finally:
        t_stop = time.perf_counter()
        if M is not None:
            M.close()
        if D is not None:
            drun(D.stop())
        if F is not None:
            frun(F.stop())
        stop_loops(loops)
        if pool is not None:
            pool.close()
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "steps": steps, "counts": counts,
           "predicted": predicted, "stop_s": time.perf_counter() - t_stop,
           "s": time.perf_counter() - t_phase}
    plog(f"launches per step {counts} (K1 predicted {predicted}); M, D "
         f"and F stopped in {out['stop_s']:.3f} s; phase wall "
         f"{out['s']:.1f} s")
    return out


# phase 28's replication, notification and remote storage (ROADMAP
# 1.22a): two port FilerServers A (region a) and B (region b) kept in
# step by the port's FilerSync, a port S3ApiServer G over B, the
# replicate daemon into a local directory and a bucket of G, the volume
# tier and remote mounts over G, on phase 23's cluster
REPL_BYTES = 128 * MIB  # A's files, from --seed
REPL_DIRS = 4  # /p28/d0..d3
REPL_CACHE_MEM = 512 * MIB  # A's and B's: no chunk evicted in the phase
REPL_LOST = (0, 3)  # step 3's lost data shards of every p28a EC volume
REPL_THREADS = 16
REPL_BACK = 4  # step 5's files PUT on B, 2 MiB each
REPL_KEYS = ("W28", "AKIAPHASE28", "phase28secretKEY/+=")  # G's identity
# the CLI's filer client tools, in one child on the card's host: filer.cat,
# filer.copy, filer.meta.tail, then filer.meta.backup and filer.backup,
# each of those two ended by a SIGINT once its work is done, as an
# operator's ^C would; it reports whether it loaded torch or jax
REPL_CHILD = r"""
import contextlib, io, json, os, signal, sys, threading, time
from seaweedfs_tpu_torch.__main__ import main
a, work = sys.argv[1:3]
want = json.load(open(os.path.join(work, "cli_want.json")))
secs = {}

def run(name, argv, done=None):
    stop = threading.Event()
    buf = io.StringIO()
    def watch():
        while not stop.wait(0.02):
            if done(buf.getvalue()):
                os.kill(os.getpid(), signal.SIGINT)
                return
    if done is not None:
        threading.Thread(target=watch, daemon=True).start()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    stop.set()
    secs[name] = time.perf_counter() - t0
    if rc:
        raise SystemExit(f"{name} exited {rc}")
    return buf.getvalue()

def mirrored(_):
    for p, size in want["backup"].items():
        q = os.path.join(work, "bk", p.lstrip("/"))
        if not os.path.exists(q) or os.path.getsize(q) != size:
            return False
    return True

run("cat", ["filer.cat", "-filer", a, "-o", os.path.join(work, "cat.out"),
            want["cat"]])
run("copy", ["filer.copy", "-filer", a, os.path.join(work, "cli_src"),
             "/cli28/"])
tail = run("tail", ["filer.meta.tail", "-filer", a, "-pathPrefix", "/p28",
                    "-timeAgo", "3600", "-untilTimeAgo", "0.001"])
with open(os.path.join(work, "tail.out"), "w") as f:
    f.write(tail)
run("meta_backup", ["filer.meta.backup", "-filer", a, "-filerPath", "/p28",
                    "-store", "sqlite:" + os.path.join(work, "meta.db")],
    lambda out: "tailing" in out)
run("backup", ["filer.backup", "-filer", a, "-dir",
               os.path.join(work, "bk"), "-filerPath", "/p28",
               "-offsetFile", os.path.join(work, "bk.json")], mirrored)
print(json.dumps({"s": secs, "loaded": {m: m in sys.modules
                                        for m in ("torch", "jax")}}))
"""


def phase_replication(racks: ThreeRacks, vdir: str, seed: int,
                      launches: dict) -> dict:
    """Phase 28: the port's replication, notification and remote storage
    (ROADMAP 1.22a) over `racks`, phase 23's three port `VolumeServer`s on
    the card in three racks behind the port's `MasterServer`, kept up for
    it.  Two port `FilerServer`s, each on a loop thread of its own with a
    fresh SQLite store and a 512 MiB chunk cache, the hot tier off (two
    regions): A (region a, collection p28a, a `LogQueue` notification in
    the phase's directory, the lower port, so the shell's `find_filer`
    picks it) and B (region b, collection p28b, /buckets/ mapped to
    collection p28g); one port `S3ApiServer` G over B with an identity
    file, so the port's `S3Remote` signs every request.  Steps: (1) 128
    MiB of files from --seed (1 KiB-32 MiB, log-uniform, 4 MiB chunks)
    POSTed to A under /p28 from 16 threads, K1 0; (2) `ec.encode
    -collection p28a` through the port's shell, K1 == the layout's units
    of the p28a .dat files; (3) data shards 0 and 3 of every p28a EC
    volume deleted, K1 0; (4) a port `FilerSync(A, B, prefix="/p28")`
    with regions a and b until B's `/__meta__/digest` of /p28 equals
    A's: every file read from B sha256 == its draw, the a->b pump applied
    A's step-1 events, the b->a pump applied nothing and skipped every
    echo, A's `direct` == the distinct chunks, K1 == those fetches whose
    needle touches a lost data shard; (5) files PUT on B under
    /p28/back reach A, nothing echoes back, the digests equal again, K1
    0; (6) the master's /cluster/geo lists a->b and b->a, neither
    stalled, `weedtpu_replication_applied_total` == the pumps' counts,
    `cluster.geo` through the port's shell prints both, the sync's
    `DivergenceAuditor` reports the prefix clean, the sync stopped, K1
    0; (7) two port `ReplicateDaemon`s over a `LogFileSource` of A's
    log, A's chunk cache emptied first: a `LocalSink` directory and a
    `CloudSink` over `S3Remote` into G's bucket p28mirror, every file ==
    its draw and every object's ETag its draw's MD5 (step 9 reads them
    all back), A's `direct` == the distinct chunks, K1 == those fetches
    whose needle touches a lost data shard; (8) `volume.tier.upload` of
    B's p28b volume to G's bucket p28tier through the port's shell, its
    needles read from its card server through G from 16 threads ==
    their draws, `volume.tier.download` back, the .dat's sha256
    unchanged, K1 0; (9) `remote.mount` of p28mirror on A under
    /remote28, every placeholder read through G == its draw, then
    `remote.cache` (every entry whole on A's volumes, 8 read back),
    `remote.uncache` (8 read through G again), `remote.meta.sync` and
    `remote.unmount` through the port's shell, K1 0; (10) a child
    running the CLI against A, loading neither torch nor jax:
    `filer.cat`, `filer.copy` of a local directory, `filer.meta.tail`
    (== A's feed of /p28), `filer.meta.backup` into SQLite (== A's
    entries and chunk lists) and `filer.backup` into a directory (every
    file == its draw), K1 == the fetches of chunks not in A's cache
    that touch a lost shard (0: step 7 cached them all).  K2 0
    throughout."""
    import urllib.parse

    import numpy as np
    from seaweedfs_tpu_torch.filer.abstract_sql import SqliteStore
    from seaweedfs_tpu_torch.filer.filechunk_section import ChunkGroup
    from seaweedfs_tpu_torch.notification import LogQueue
    from seaweedfs_tpu_torch.remote_storage import S3Remote
    from seaweedfs_tpu_torch.replication.filer_sync import FilerSync
    from seaweedfs_tpu_torch.replication.replicate_daemon import (
        LogFileSource, ReplicateDaemon, read_file_via_filer)
    from seaweedfs_tpu_torch.replication.sink import LocalSink, make_sink
    from seaweedfs_tpu_torch.s3 import auth
    from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.stats import metrics, netflow
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout
    from seaweedfs_tpu_torch.utils import http, resilience
    from seaweedfs_tpu_torch.utils.chunk_cache import ChunkCache

    card = card_name_power()

    def plog(msg: str) -> None:
        log(f"[replication] {msg} [{card}]")

    work = os.path.join(vdir, "replication")
    os.makedirs(work)
    names, servers = racks.names, racks.servers
    node_of, master = racks.node_of, racks.master
    admin, run, split, topo = racks.admin, racks.run, racks.split, racks.topo
    holder_of = racks.holder_of
    loops: list = []
    arun = brun = grun = A = B = G = pool = queue = sync = None
    daemons: list = []
    steps: dict = {}
    counts: dict = {}
    predicted: dict = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 28)
    who, ak, sk = REPL_KEYS
    root = "/p28"

    def step_counts(name: str, k0: dict, k1: int, t0: float) -> None:
        got = {k: launches[k] - k0[k] for k in launches}
        counts[name] = got
        predicted[name] = k1
        steps.setdefault(name, {})["wall_s"] = time.perf_counter() - t0
        want = {"gf_apply": k1, "gf_apply_batch": 0}
        if got != want:
            raise AssertionError(f"phase 28 {name}: launched {got}, "
                                 f"predicted {want}")

    def empty_lrus() -> None:
        """No server's reconstruction LRU answers a read this step
        predicts a launch for."""
        for vs in servers.values():
            for loc in vs.store.locations:
                for ev in list(loc.ec_volumes.values()):
                    with ev._recon_lock:
                        ev._recon_cache.clear()
                        ev._recon_cache_bytes = 0

    def req(url: str, method: str = "GET", body=None, headers=None,
            want=(200,)) -> bytes:
        st, _, raw = pool.request(url, method, body, headers or {})
        if st not in want:
            raise AssertionError(f"{method} {url}: HTTP {st} {raw[:200]!r}")
        return raw

    def path_url(filer, path: str) -> str:
        return f"http://{filer.url}{urllib.parse.quote(path)}"

    def digest(filer) -> str:
        return json.loads(req(f"http://{filer.url}/__meta__/digest?"
                              + urllib.parse.urlencode({"prefix": root})
                              ))["digest"]

    def replay(filer, prefix: str = root) -> list:
        raw = req(f"http://{filer.url}/__meta__/subscribe?"
                  + urllib.parse.urlencode({"since": "0", "prefix": prefix,
                                            "live": "false"}))
        return [ln for ln in raw.split(b"\n") if ln.strip()]

    try:
        # 0 set-up.  Phase 27's filer stopped moments ago and the master
        # lists a member for 30 s after its last beat: it leaves the
        # table first, so A and B are the filers find_filer sees
        async def forget_filers() -> None:
            master.cluster_members.pop("filer", None)
        racks.mrun(forget_filers())
        arun, brun, grun = (loop_thread(loops), loop_thread(loops),
                            loop_thread(loops))
        ports = sorted(free_port() for _ in range(2))
        queue = LogQueue(os.path.join(work, "a_events.jsonl"))
        with scoped_env(WEEDTPU_HOT_TIER="0"):
            A = FilerServer(master.url, "127.0.0.1", ports[0],
                            data_dir=os.path.join(work, "a"),
                            collection="p28a", chunk_cache_mem=REPL_CACHE_MEM,
                            notification=queue, region="a")
            B = FilerServer(master.url, "127.0.0.1", ports[1],
                            data_dir=os.path.join(work, "b"),
                            collection="p28b", chunk_cache_mem=REPL_CACHE_MEM,
                            region="b")
        arun(A.start())
        brun(B.start())
        until(lambda: racks.cmd_env.master_get("/cluster/status").get(
            "Members", {}).get("filer") == [A.url, B.url],
            "the master never listed A and B alone")
        pool = http.PooledHTTP(timeout=600.0, max_idle_per_host=REPL_THREADS)
        req(f"http://{B.url}/__admin__/filer_conf", "POST", json.dumps(
            {"locations": [{"location_prefix": "/buckets/",
                            "collection": "p28g"}]}).encode(),
            {"Content-Type": "application/json"})
        ident = os.path.join(work, "s3.json")
        with open(ident, "w") as f:
            json.dump({"identities": [{
                "name": who, "credentials": [{"accessKey": ak,
                                              "secretKey": sk}],
                "actions": ["Admin", "Read", "Write", "List"]}]}, f)
        G = S3ApiServer(B.url, "127.0.0.1", free_port(),
                        iam=auth.IdentityAccessManagement.from_file(ident))
        grun(G.start())

        def bucket(name: str) -> "S3Remote":
            return S3Remote(G.url, name, access_key=ak, secret_key=sk)
        plog(f"0 set-up: A {A.url} (region a, p28a, LogQueue), B {B.url} "
             f"(region b, p28b, /buckets/ -> p28g) and G {G.url} over B in "
             f"{time.perf_counter() - t_phase:.3f} s")

        # 1 A's files
        t0 = time.perf_counter()
        k0 = dict(launches)
        sizes: list = []
        while sum(sizes) < REPL_BYTES:
            sizes.append(min(int(np.exp(rng.uniform(
                np.log(FS_MIN_SIZE), np.log(FS_MAX_SIZE)))),
                REPL_BYTES - sum(sizes)))
        if sizes[-1] < FS_MIN_SIZE:  # the remainder joins the last
            sizes[-2] += sizes.pop()
        payload = rng.bytes(REPL_BYTES)
        content: dict = {}  # path -> the file's bytes
        at = 0
        for i, size in enumerate(sizes):
            content[f"{root}/d{i % REPL_DIRS}/f{i:03d}.bin"] = \
                payload[at:at + size]
            at += size
        a_paths = sorted(content)

        def post(path: str) -> None:
            req(path_url(A, path), "POST", content[path],
                {"Content-Type": "application/octet-stream"},
                want=(200, 201))
        dt_write = fan(post, a_paths, REPL_THREADS)
        step_counts("1 write", k0, 0, t0)
        sha = {p: hashlib.sha256(c).hexdigest() for p, c in content.items()}
        entries = {p: A.filer.find_entry(p) for p in a_paths}
        n_chunks = len({c.fid for e in entries.values() for c in e.chunks})
        steps["1 write"].update({"files": len(a_paths),
                                 "bytes": REPL_BYTES, "s": dt_write,
                                 "mbps": REPL_BYTES / dt_write / 1e6,
                                 "chunks": n_chunks})
        plog(f"1 write: {len(a_paths)} files ({FS_MIN_SIZE}-{FS_MAX_SIZE} "
             f"B log-uniform), {REPL_BYTES} B POSTed to A under {root} "
             f"from {REPL_THREADS} threads at "
             f"{REPL_BYTES / dt_write / 1e6:.1f} MB/s; {n_chunks} chunks; "
             f"K1 0")

        # 2 ec.encode -collection p28a, once a beat reports the sizes
        def view(col: str) -> dict:
            return {vi["id"]: vi["size"]
                    for nd in topo()["nodes"].values()
                    for vi in nd["volume_infos"]
                    if vi["collection"] == col}
        vols = {vid: servers[holder_of(vid)].store.get_volume(vid)
                for vid in view("p28a")}
        for vol in vols.values():
            vol.flush()
        dat_size = {vid: vol.data_size() for vid, vol in vols.items()}
        p28a = until(lambda: (lambda seen: seen if seen == dat_size
                              else None)(view("p28a")),
                     f"no beat reported the p28a sizes {dat_size}")
        units = {vid: predict_units(p28a[vid], layout.LARGE_BLOCK_SIZE,
                                    layout.SMALL_BLOCK_SIZE)
                 for vid in p28a}
        k0 = dict(launches)
        t0 = time.perf_counter()
        run("lock")
        out2 = run("ec.encode -collection p28a -fullPercent 0 "
                   "-quietFor 0s")
        run("unlock")
        dt_enc = time.perf_counter() - t0
        listed = json.loads(out2.splitlines()[0].split(": ", 1)[1])
        if listed != sorted(p28a):
            raise AssertionError(f"ec.encode selected {listed}; the p28a "
                                 f"volumes are {sorted(p28a)}")
        step_counts("2 encode", k0, sum(units.values()), t0)
        until(lambda: all(sum(map(len, split(vid).values())) == 14
                          for vid in listed),
              "the p28a shard sets never reached the master")
        steps["2 encode"].update({"s": dt_enc, "volumes": listed,
                                  "dat_bytes": p28a, "units": units})
        plog(f"2 encode: `ec.encode -collection p28a` of volumes {listed} "
             f"(.dat {[p28a[v] for v in listed]} B) in {dt_enc:.3f} s; K1 "
             f"{sum(units.values())} == the layout's units")

        # 3 data shards 0 and 3 of every p28a EC volume deleted
        k0 = dict(launches)
        t0 = time.perf_counter()
        for vid in listed:
            for u, shards in split(vid).items():
                gone = [s for s in REPL_LOST if s in shards]
                if gone:
                    admin(node_of[u], "/admin/ec/delete_shards",
                          {"volume": vid, "shards": gone})
        until(lambda: not any(set(REPL_LOST) & set(s) for vid in listed
                              for s in split(vid).values()),
              "the master still shows the deleted shards")
        step_counts("3 loss", k0, 0, t0)
        plog(f"3 loss: data shards {list(REPL_LOST)} of every p28a EC "
             f"volume deleted where they lived; K1 0")

        evs = {vid: next(servers[n].store.get_ec_volume(vid)
                         for n in names
                         if servers[n].store.get_ec_volume(vid)
                         is not None) for vid in listed}

        def touches(fid: str) -> bool:
            f = t.FileId.parse(fid)
            ev = evs.get(f.volume_id)
            return ev is not None and bool(
                touching_needles(ev, {f.key: None}, REPL_LOST))

        def views_of(entry) -> set:
            return {v.fid for v in ChunkGroup(entry.chunks).read_views(
                0, entry.size())}

        def uncached_touching(paths) -> int:
            """Launches a read of `paths` through A costs: one per chunk
            not in A's cache whose needle touches a lost shard."""
            cached = set(A.chunk_cache.mem._d)
            fids = set().union(*(views_of(A.filer.find_entry(p))
                                 for p in paths))
            return sum(1 for f in fids if f not in cached and touches(f))

        # 4 A -> B through the port's sync pump
        a_events = replay(A)
        needed = set().union(*(views_of(e) for e in entries.values()))
        k1 = uncached_touching(a_paths)
        empty_lrus()
        resilience.reset_latency_trackers()
        resilience.reset_breakers()
        direct0 = A.hot_stats["direct"]
        wan0 = netflow.wan_total("sent")
        # the process's counters, which the geo view folds, before the
        # pumps start
        counted0 = {d: metrics.REPLICATION_APPLIED.labels(d).value
                    for d in ("a->b", "b->a")}
        k0 = dict(launches)
        t0 = time.perf_counter()
        with scoped_env(WEEDTPU_GEO_AUDIT_INTERVAL="0"):
            sync = FilerSync(A.url, B.url, prefix=root,
                             offset_path=os.path.join(work, "sync.json"),
                             region_a="a", region_b="b")
            sync.start()
        a_digest = digest(A)
        until(lambda: digest(B) == a_digest,
              "B's digest of /p28 never reached A's", timeout=300)
        dt_sync = time.perf_counter() - t0
        until(lambda: sync.b2a.skipped >= sync.a2b.applied,
              "the b->a pump never saw the echoes", timeout=60)
        direct = A.hot_stats["direct"] - direct0

        def from_b(path: str) -> None:
            body = req(path_url(B, path))
            if hashlib.sha256(body).hexdigest() != sha[path]:
                raise AssertionError(f"{path} on B: not its draw")
        fan(from_b, a_paths, REPL_THREADS)
        a2b, b2a = sync.a2b, sync.b2a
        if a2b.applied != len(a_events) or a2b.errors or b2a.errors or \
                b2a.applied or b2a.skipped != a2b.applied or \
                a2b.skipped:
            raise AssertionError(f"the pumps: a->b {a2b.status()}, b->a "
                                 f"{b2a.status()}; A logged "
                                 f"{len(a_events)} events under {root}")
        if direct != len(needed):
            raise AssertionError(f"A fetched {direct} chunks from the "
                                 f"volume tier; {len(needed)} distinct "
                                 f"chunks were read")
        step_counts("4 sync a->b", k0, k1, t0)
        wan = netflow.wan_total("sent") - wan0
        steps["4 sync a->b"].update({
            "s": dt_sync, "mbps": REPL_BYTES / dt_sync / 1e6,
            "events": len(a_events), "applied": a2b.applied,
            "echoes_skipped": b2a.skipped, "direct": direct,
            "chunks": len(needed), "wan_sent": wan})
        plog(f"4 sync a->b: FilerSync(A, B, prefix={root}) reached B's "
             f"digest == A's in {dt_sync:.3f} s "
             f"({REPL_BYTES / dt_sync / 1e6:.1f} MB/s): a->b applied "
             f"{a2b.applied} == A's {len(a_events)} events, b->a applied 0 "
             f"and skipped {b2a.skipped} echoes; every file on B sha256 == "
             f"its draw; A's direct {direct} == the {len(needed)} distinct "
             f"chunks; WAN sent {wan:.0f} B; K1 {k1} == the fetches "
             f"touching shards {list(REPL_LOST)}")

        # 5 B -> A: files PUT on B come back, nothing echoes
        k0 = dict(launches)
        t0 = time.perf_counter()
        applied0, skipped0 = a2b.applied, a2b.skipped
        back = {f"{root}/back/b{i}.bin": rng.bytes(2 * MIB)
                for i in range(REPL_BACK)}
        for p, data in back.items():
            req(path_url(B, p), "PUT", data,
                {"Content-Type": "application/octet-stream"},
                want=(200, 201))
        content.update(back)
        sha.update({p: hashlib.sha256(d).hexdigest() for p, d in back.items()})
        until(lambda: all(pool.request(path_url(A, p))[2] == d
                          for p, d in back.items()),
              "B's files never reached A", timeout=60)
        until(lambda: digest(A) == digest(B),
              "the digests never met again", timeout=60)
        until(lambda: a2b.skipped - skipped0 >= b2a.applied,
              "the a->b pump never saw the echoes", timeout=60)
        if a2b.applied != applied0 or a2b.errors or b2a.errors:
            raise AssertionError(f"echo: a->b {a2b.status()}, b->a "
                                 f"{b2a.status()}")
        dt_back = time.perf_counter() - t0
        step_counts("5 sync b->a", k0, 0, t0)
        steps["5 sync b->a"].update({"files": len(back), "s": dt_back,
                                     "applied": b2a.applied,
                                     "echoes_skipped":
                                         a2b.skipped - skipped0})
        plog(f"5 sync b->a: {len(back)} files PUT on B under {root}/back "
             f"reached A in {dt_back:.3f} s, b->a applied {b2a.applied}, "
             f"a->b skipped {a2b.skipped - skipped0} echoes and applied "
             f"nothing more; digests equal; K1 0")

        # 6 the observatory: /cluster/geo, cluster.geo, the auditor
        k0 = dict(launches)
        t0 = time.perf_counter()
        geo = json.loads(req(f"http://{master.url}/cluster/geo?refresh=1"))
        dirs = geo["directions"]
        if sorted(dirs) != ["a->b", "b->a"] or \
                any(d.get("stalled") for d in dirs.values()) or \
                any(dirs[d.direction].get("applied", 0) -
                    counted0[d.direction] != d.applied
                    for d in (a2b, b2a)):
            raise AssertionError(f"/cluster/geo: {geo}, the pumps applied "
                                 f"{a2b.applied} and {b2a.applied} since "
                                 f"{counted0}")
        for d in (a2b, b2a):
            got = metrics.REPLICATION_APPLIED.labels(d.direction).value - \
                counted0[d.direction]
            if got != d.applied:
                raise AssertionError(f"weedtpu_replication_applied_total"
                                     f"{{{d.direction}}} {got}, the pump "
                                     f"applied {d.applied}")
        printed = run("cluster.geo")
        if not all(re.search(rf"^\s+{re.escape(d)}\s+lag=", printed, re.M)
                   for d in ("a->b", "b->a")) or "STALLED" in printed:
            raise AssertionError(f"cluster.geo printed {printed!r}")
        audit = sync.auditor.run_once()
        if audit["outcome"] != "clean" or \
                metrics.GEO_DIVERGENCE.labels(root).value != 0:
            raise AssertionError(f"the auditor: {audit}")
        t_stop = time.perf_counter()
        sync.stop()
        dt_stop = time.perf_counter() - t_stop
        if any(th.is_alive() for th in sync._threads):
            raise AssertionError("a pump outlived FilerSync.stop")
        sync_status = sync.status()
        sync = None
        step_counts("6 observe", k0, 0, t0)
        steps["6 observe"].update({"geo": dirs, "stop_s": dt_stop,
                                   "audit": audit["outcome"],
                                   "wan": geo["wan"]})
        plog(f"6 observe: /cluster/geo a->b applied {a2b.applied} lag "
             f"{dirs['a->b'].get('lag_s', 0):.3f} s, b->a applied "
             f"{b2a.applied}, neither stalled; the applied counters == "
             f"the pumps'; cluster.geo printed both; "
             f"the auditor: {root} {audit['outcome']}; FilerSync stopped "
             f"in {dt_stop:.3f} s, every pump thread ended; K1 0")

        # 7 the replicate daemon over A's notification log, into a local
        # directory and into G's bucket p28mirror.  A's cache is emptied
        # first, so the daemons' source reads fetch from the volume tier
        # and decode every chunk on a lost shard
        mirror = os.path.join(work, "mirror")
        bucket("p28mirror").create_bucket()
        log_path = queue.path
        log_size = os.path.getsize(log_path)
        all_paths = sorted(content)
        A.chunk_cache = ChunkCache(mem_limit=REPL_CACHE_MEM)
        direct0 = A.hot_stats["direct"]
        k1 = uncached_touching(all_paths)
        empty_lrus()
        k0 = dict(launches)
        t0 = time.perf_counter()
        sinks = {"local": LocalSink(mirror),
                 "s3": make_sink("s3", endpoint=G.url, bucket="p28mirror",
                                 access_key=ak, secret_key=sk)}
        done_s: dict = {}
        for name, sink in sinks.items():
            d = ReplicateDaemon(
                LogFileSource(log_path, poll_interval=0.05), sink,
                read_file_via_filer(A.url), prefix=root,
                offset_path=os.path.join(work, f"rep_{name}.json"),
                offset_key=f"p28:{name}")
            daemons.append(d)
            d.run_in_thread()
        for name, d in zip(sinks, daemons):
            until(lambda: d.offsets.get(d.key) >= log_size,
                  f"the {name} daemon never reached the log's end",
                  timeout=300)
            done_s[name] = time.perf_counter() - t0
        for d in daemons:
            d.stop()
        applied = [d.applied for d in daemons]
        daemons.clear()
        fetched = set().union(*(views_of(A.filer.find_entry(p))
                                for p in all_paths))
        direct = A.hot_stats["direct"] - direct0
        if direct != len(fetched):
            raise AssertionError(f"A fetched {direct} chunks from the "
                                 f"volume tier for the daemons; the files "
                                 f"have {len(fetched)}")
        for p in all_paths:
            with open(os.path.join(mirror, p.lstrip("/")), "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() != sha[p]:
                    raise AssertionError(f"{p} in the mirror")
        mirror_b = bucket("p28mirror")

        def object_of(p: str) -> None:
            # the gateway's ETag: the MD5 of the bytes the sink PUT
            with mirror_b._request("HEAD", p.lstrip("/")) as r:
                etag = r.headers.get("ETag", "").strip('"')
            if etag != hashlib.md5(content[p]).hexdigest():
                raise AssertionError(f"{p} in p28mirror: ETag {etag}")
        fan(object_of, all_paths, REPL_THREADS)
        step_counts("7 replicate", k0, k1, t0)
        total = sum(len(content[p]) for p in all_paths)
        steps["7 replicate"].update({
            "files": len(all_paths), "bytes": total, "applied": applied,
            "direct": direct,
            "s": done_s, "mbps": {k: total / v / 1e6
                                  for k, v in done_s.items()}})
        plog(f"7 replicate: two ReplicateDaemons over A's log "
             f"({log_size} B): {total} B of {len(all_paths)} files into "
             f"the local directory in {done_s['local']:.3f} s "
             f"({total / done_s['local'] / 1e6:.1f} MB/s) and into G's "
             f"p28mirror in {done_s['s3']:.3f} s "
             f"({total / done_s['s3'] / 1e6:.1f} MB/s), applied "
             f"{applied}; every file sha256 == its draw, every object's "
             f"ETag its draw's MD5; A's direct {direct} == the distinct "
             f"chunks; K1 {k1} (chunks on a lost shard, A's cache emptied "
             f"first)")

        # 8 B's p28b volume to G's bucket p28tier and back
        k0 = dict(launches)
        t0 = time.perf_counter()
        p28b = view("p28b")
        vid_t = max(p28b, key=lambda v: (p28b[v], -v))
        holder = servers[holder_of(vid_t)]
        vol = holder.store.get_volume(vid_t)
        vol.flush()
        dat = racks.base_of(node_of[holder.url], vid_t, "p28b") + ".dat"
        dat_sha = sha256(dat)
        dat_len = os.path.getsize(dat)
        bucket("p28tier").create_bucket()
        spec = (f"s3:endpoint={G.url},bucket=p28tier,access_key={ak},"
                f"secret_key={sk}")
        run("lock")
        out8 = [run(f"volume.tier.upload -volumeId {vid_t} -dest {spec}")]
        if os.path.exists(dat) or "tier s3" not in out8[0]:
            raise AssertionError(f"volume {vid_t} after the upload: "
                                 f"{out8[0]!r}")
        needles = [(p, c) for p in all_paths
                   for c in B.filer.find_entry(p).chunks
                   if t.FileId.parse(c.fid).volume_id == vid_t]
        if not needles:
            raise AssertionError(f"no B chunk lives on volume {vid_t}")
        t_read = time.perf_counter()

        def tiered(item) -> None:
            p, c = item
            body = req(f"http://{holder.url}/{c.fid}")
            if body != content[p][c.offset:c.offset + c.size]:
                raise AssertionError(f"{c.fid} through the tier")
        # sixteen readers: a read of the tiered volume waits on G, whose
        # filer reads the same servers; the servers read a tier on a
        # pool of their own, so G's reads find the loop's pool free
        # (ROADMAP fault 3.15)
        fan(tiered, needles, REPL_THREADS)
        dt_tread = time.perf_counter() - t_read
        out8.append(run(f"volume.tier.download -volumeId {vid_t} "
                        f"-deleteRemote true"))
        run("unlock")
        if sha256(dat) != dat_sha or "back on local disk" not in out8[1]:
            raise AssertionError(f"volume {vid_t} after the download: "
                                 f"{out8[1]!r}")
        dt_tier = time.perf_counter() - t0
        step_counts("8 tier", k0, 0, t0)
        steps["8 tier"].update({"volume": vid_t, "dat_bytes": dat_len,
                                "needles": len(needles),
                                "read_s": dt_tread, "s": dt_tier})
        plog(f"8 tier: `volume.tier.upload` of p28b volume {vid_t} "
             f"({dat_len} B) on node {node_of[holder.url]} to G's p28tier, "
             f"{len(needles)} needles read through G in {dt_tread:.3f} s, "
             f"each == its draw; `volume.tier.download` back, .dat sha256 "
             f"unchanged; {dt_tier:.3f} s in all; K1 0")

        # 9 p28mirror mounted on A under /remote28
        k0 = dict(launches)
        t0 = time.perf_counter()
        rspec = (f"s3:endpoint={G.url},bucket=p28mirror,access_key={ak},"
                 f"secret_key={sk}")
        mnt = "/remote28"
        out9 = [run(f"remote.mount -remote {rspec} -dir {mnt}")]
        mounted = {f"{mnt}{p}": p for p in all_paths}

        def through(item) -> None:
            q, p = item
            body = req(path_url(A, q))
            if hashlib.sha256(body).hexdigest() != sha[p]:
                raise AssertionError(f"{q} through A: not its draw")
        items = sorted(mounted.items())
        dt_rt = fan(through, items, REPL_THREADS)
        out9.append(run(f"remote.cache -remote {rspec} -dir {mnt}"))
        for q, p in items:  # cached: chunks on A's volumes, whole files
            e = A.filer.find_entry(q)
            if not e.chunks or e.size() != len(content[p]):
                raise AssertionError(f"{q} after remote.cache: "
                                     f"{len(e.chunks)} chunks, {e.size()} B")
        fan(through, items[:8], REPL_THREADS)
        out9.append(run(f"remote.uncache -dir {mnt}"))
        fan(through, items[:8], REPL_THREADS)
        out9.append(run(f"remote.meta.sync -remote {rspec} -dir {mnt}"))
        out9.append(run(f"remote.unmount -dir {mnt}"))
        n = len(all_paths)
        want9 = [f"remote.mount: {n} object(s) from s3 -> {mnt}",
                 f"remote.cache: {n} object(s) cached under {mnt}",
                 f"remote.uncache: {n} file(s) reverted to placeholders",
                 f"remote.meta.sync: 0 updated, 0 deleted, {n} unchanged",
                 f"remote.unmount: {mnt} detached"]
        if not all(w in o for w, o in zip(want9, out9)):
            raise AssertionError(f"the remote commands printed {out9}")
        dt_remote = time.perf_counter() - t0
        step_counts("9 remote", k0, 0, t0)
        steps["9 remote"].update({"objects": n, "read_through_s": dt_rt,
                                  "s": dt_remote})
        plog(f"9 remote: `remote.mount` of p28mirror on A under {mnt}: "
             f"{n} placeholders read through G in {dt_rt:.3f} s, each == "
             f"its draw; `remote.cache` (every entry whole on A's "
             f"volumes, 8 read back), `remote.uncache` (8 read through "
             f"again), `remote.meta.sync` (0 updated, 0 "
             f"deleted) and `remote.unmount`; {dt_remote:.3f} s in all; "
             f"K1 0")

        # 10 the CLI's filer client tools in a child against A
        src = os.path.join(work, "cli_src")
        cli_files = {f"s{i}.bin": rng.bytes(64 << 10) for i in range(4)}
        os.makedirs(src)
        for name, data in cli_files.items():
            with open(os.path.join(src, name), "wb") as f:
                f.write(data)
        cat_path = max(a_paths, key=lambda p: len(content[p]))
        with open(os.path.join(work, "cli_want.json"), "w") as f:
            json.dump({"cat": cat_path,
                       "backup": {p: len(content[p]) for p in all_paths}},
                      f)
        k1 = uncached_touching(all_paths)
        empty_lrus()
        k0 = dict(launches)
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", REPL_CHILD, A.url, work],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        dt_cli = time.perf_counter() - t0
        if child.returncode:
            raise AssertionError(f"the CLI child exited {child.returncode}"
                                 f": {child.stderr[-1500:]}")
        res = json.loads(child.stdout.strip().splitlines()[-1])
        if any(res["loaded"].values()):
            raise AssertionError(f"the CLI child loaded {res['loaded']}")
        with open(os.path.join(work, "cat.out"), "rb") as f:
            if f.read() != content[cat_path]:
                raise AssertionError("filer.cat: not the draw")
        for name, data in cli_files.items():
            if req(path_url(A, f"/cli28/cli_src/{name}")) != data:
                raise AssertionError(f"filer.copy's {name} on A")
        with open(os.path.join(work, "tail.out"), "rb") as f:
            tailed = [ln for ln in f.read().split(b"\n") if ln.strip()]
        if tailed != replay(A):
            raise AssertionError(f"filer.meta.tail printed {len(tailed)} "
                                 f"events; A's feed of {root} has "
                                 f"{len(replay(A))}")
        store = SqliteStore(os.path.join(work, "meta.db"))
        try:
            for p in all_paths:
                got = [c.fid for c in store.find_entry(p).chunks]
                if got != [c.fid for c in A.filer.find_entry(p).chunks]:
                    raise AssertionError(f"filer.meta.backup's {p}")
        finally:
            store.shutdown()
        for p in all_paths:
            with open(os.path.join(work, "bk", p.lstrip("/")), "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() != sha[p]:
                    raise AssertionError(f"filer.backup's {p}")
        step_counts("10 cli", k0, k1, t0)
        steps["10 cli"].update({"s": dt_cli, "child_s": res["s"],
                                "tailed": len(tailed)})
        plog(f"10 cli: a child ran filer.cat ({len(content[cat_path])} B "
             f"== the draw), filer.copy ({len(cli_files)} files on A), "
             f"filer.meta.tail ({len(tailed)} events == A's feed), "
             f"filer.meta.backup (every entry's chunks == A's) and "
             f"filer.backup (every file == its draw) in {dt_cli:.3f} s "
             f"({', '.join(f'{k} {v:.3f}' for k, v in res['s'].items())}"
             f"), loading neither torch nor jax; K1 {k1}")
    finally:
        t_stop = time.perf_counter()
        for d in daemons:
            d.stop()
        if sync is not None:
            sync.stop()
        if G is not None:
            grun(G.stop())
        if B is not None:
            brun(B.stop())
        if A is not None:
            arun(A.stop())
        stop_loops(loops)
        if queue is not None:
            queue.close()
        if pool is not None:
            pool.close()
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "steps": steps, "counts": counts,
           "predicted": predicted, "sync": sync_status,
           "stop_s": time.perf_counter() - t_stop,
           "s": time.perf_counter() - t_phase}
    plog(f"launches per step {counts} (K1 predicted {predicted}); G, B "
         f"and A stopped in {out['stop_s']:.3f} s; phase wall "
         f"{out['s']:.1f} s")
    return out


MQ_COLLECTION = "p29"  # F's collection: every segment, conf and offset
MQ_TOPIC = "chip.p29"
MQ_PARTITIONS = 8
MQ_BYTES = 64 * MIB  # step 2's message values, from --seed
MQ_MIN_SIZE = 256
MQ_MAX_SIZE = 256 << 10
MQ_THREADS = 16
MQ_CACHE_MEM = 512 * MIB  # F's: no chunk evicted in the phase
MQ_LOST = (0, 3)  # step 5's lost data shards of every p29 EC volume
MQ_MORE = 256  # step 7's messages, after the failover
MQ_GROUP = "g1"
MQ_CLI = 64  # step 9's messages through the CLI's broker
MQ_RING = 4096  # the reference's PARTITION_COUNT_RING

# the CLI's `mq.broker` in a child: `main` on a thread, what it loaded
# printed when the phase says so on stdin
MQ_CHILD = r"""
import json, os, sys, threading, traceback
from seaweedfs_tpu_torch.__main__ import main
def serve():
    try:
        main(sys.argv[1:])
    except BaseException:
        traceback.print_exc()
        os._exit(3)
threading.Thread(target=serve, daemon=True).start()
sys.stdin.readline()
print(json.dumps({m: m in sys.modules for m in ("torch", "jax")} | {
    "seaweedfs_tpu": any(m.split(".")[0] == "seaweedfs_tpu"
                         for m in sys.modules)}), flush=True)
os._exit(0)
"""


def mq_draws(rng, n_bytes: int = 0, n: int = 0) -> list:
    """(key, value) pairs from `rng`, `n_bytes` of values or `n` of them:
    log-uniform sizes of MQ_MIN_SIZE-MQ_MAX_SIZE, printable values (the
    broker's NDJSON decodes a value as UTF-8), a drawn 16-hex-digit key
    each."""
    import numpy as np
    sizes: list = []
    while (n_bytes and sum(sizes) < n_bytes) or (n and len(sizes) < n):
        sizes.append(int(np.exp(rng.uniform(np.log(MQ_MIN_SIZE),
                                             np.log(MQ_MAX_SIZE)))))
    if n_bytes:
        sizes[-1] -= sum(sizes) - n_bytes
        if sizes[-1] < MQ_MIN_SIZE:
            sizes[-2] += sizes.pop()
    payload = rng.integers(33, 127, sum(sizes), dtype=np.uint8).tobytes()
    out, at = [], 0
    for size in sizes:
        out.append((b"%016x" % int(rng.integers(0, 1 << 62)),
                    payload[at:at + size]))
        at += size
    return out


def mq_publishers(seed: int) -> int:
    """Child of phase 29's step 2, a process of its own as a queue's
    producers are, started at the phase's set-up: it draws the MQ_BYTES
    of messages `mq_draws` gives for `seed` and says `ready`; on a line
    of brokers (comma-separated) on its stdin, MQ_THREADS threads publish
    them through one `MQClient` of those brokers, each thread every
    MQ_THREADS-th message; it answers one JSON line, [index, partition,
    offset] per acknowledged message and the seconds."""
    import numpy as np
    from seaweedfs_tpu_torch.mq.client import MQClient

    msgs = mq_draws(np.random.default_rng(seed + 29), n_bytes=MQ_BYTES)
    print("ready", flush=True)
    client = MQClient(sys.stdin.readline().strip().split(","))
    acked: list = []

    def publish(i: int) -> None:
        key, value = msgs[i]
        acked.append((i, *client.publish(MQ_TOPIC, value, key=key)))
    dt = fan(publish, list(range(len(msgs))), MQ_THREADS)
    print(json.dumps({"acked": acked, "s": dt}), flush=True)
    return 0


def mq_partition(key: bytes, n: int) -> int:
    """The partition of `key` among `n` by the reference's rule,
    written out here: `ring_slot` is crc32 % 4096
    (seaweedfs_tpu/mq/topic.py:44-45), and `split_ring` gives partition
    i the slots [i * step, (i + 1) * step), the last one up to 4096."""
    step = MQ_RING // n
    return min((zlib.crc32(key) % MQ_RING) // step, n - 1)


def phase_mq(racks: ThreeRacks, vdir: str, seed: int,
             launches: dict) -> dict:
    """Phase 29: the port's message queue (ROADMAP 1.22b) over `racks`,
    phase 23's three port `VolumeServer`s on the card behind the port's
    `MasterServer`, kept up for it.  One port `FilerServer` F on a loop
    thread of its own (a fresh SQLite store, collection p29, a 512 MiB
    chunk cache) and two port `BrokerServer`s P and Q, each on a loop
    thread of its own, keeping their logs in F (`peer_refresh=0.5`).
    Steps: (1) `mq.topic.configure -topic chip.p29 -partitionCount 8`
    through the port's shell once both brokers see a ring of two, K1 0;
    (2) 64 MiB of messages from --seed (256 B-256 KiB, log-uniform,
    printable bytes, a drawn key each) published through `MQClient`
    from 16 threads of a child process (`--mq-publish`, started at the
    set-up to draw them meanwhile), each on the partition the
    reference's `ring_slot` gives its key, the offsets dense, K1 0; (3) a
    `GroupConsumer` group g1 of two members polls everything and
    commits: each message once, in offset order within its partition,
    equal to its draw, `/offsets/get` == the commits, K1 0; (4) `POST
    /flush` to both brokers, then `ec.encode -collection p29` through
    the port's shell, K1 == the layout's units; (5) data shards 0 and 3
    of every p29 EC volume deleted and F's chunk cache emptied, K1 0;
    (6) P and Q stopped (each at once) and two fresh brokers started
    over F, whose recovery reads every segment back through F: every
    partition's next offset as before, a replay from 0 == the draws,
    g1's offsets kept, a publish takes the next offset, F's `direct` ==
    the distinct chunks under /topics, K1 one per such fetch whose
    needle touches a lost data shard; (7) one broker stopped, and once
    the survivor's ring has settled on itself 256 more messages
    published, `mq.balance`, `mq.topic.list` and `mq.topic.desc` through
    the port's shell show it owning every partition, nothing lost, K1 0;
    (8) the master's epoch of every partition rose across the ring
    change, and a `/replicate` below the epoch the survivor has seen
    gets 403 `fenced` while one at it gets 200, K1 0; (9) a child
    running the CLI's `mq.broker` behind a master of its own (started
    at step 4, so it boots meanwhile), loading neither torch nor jax:
    `MQClient` configures a topic, publishes and fetches through it,
    every byte equal, K1 0.  K2 0 throughout."""
    import urllib.parse

    import numpy as np
    from seaweedfs_tpu_torch.filer.filechunk_section import ChunkGroup
    from seaweedfs_tpu_torch.mq.broker import BrokerServer
    from seaweedfs_tpu_torch.mq.client import MQClient
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout
    from seaweedfs_tpu_torch.utils import http
    from seaweedfs_tpu_torch.utils.chunk_cache import ChunkCache

    card = card_name_power()

    def plog(msg: str) -> None:
        log(f"[mq] {msg} [{card}]")

    work = os.path.join(vdir, "mq")
    os.makedirs(work)
    names, servers = racks.names, racks.servers
    node_of, master = racks.node_of, racks.master
    admin, run, split, topo = racks.admin, racks.run, racks.split, racks.topo
    holder_of = racks.holder_of
    loops: list = []
    F = M = pool = child = publishers = None
    brokers: dict = {}  # url -> (broker, its loop's runner)
    steps: dict = {}
    counts: dict = {}
    predicted: dict = {}
    stops: dict = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 29)

    def step_counts(name: str, k0: dict, k1: int, t0: float) -> None:
        got = {k: launches[k] - k0[k] for k in launches}
        counts[name] = got
        predicted[name] = k1
        steps.setdefault(name, {})["wall_s"] = time.perf_counter() - t0
        want = {"gf_apply": k1, "gf_apply_batch": 0}
        if got != want:
            raise AssertionError(f"phase 29 {name}: launched {got}, "
                                 f"predicted {want}")

    def empty_lrus() -> None:
        for vs in servers.values():
            for loc in vs.store.locations:
                for ev in list(loc.ec_volumes.values()):
                    with ev._recon_lock:
                        ev._recon_cache.clear()
                        ev._recon_cache_bytes = 0

    def req(url: str, method: str = "GET", body=None, want=(200,)):
        st, _, raw = pool.request(url, method, body, {
            "Content-Type": "application/json"} if body else {})
        if st not in want:
            raise AssertionError(f"{method} {url}: HTTP {st} {raw[:200]!r}")
        return st, raw

    def start_broker() -> "BrokerServer":
        brun = loop_thread(loops)
        b = BrokerServer(master.url, "127.0.0.1", free_port(),
                         peer_refresh=0.5, filer_url=F.url)
        t0 = time.perf_counter()
        brun(b.start())
        brokers[b.url] = (b, brun, time.perf_counter() - t0)
        return b

    def stop_broker(b) -> float:
        t0 = time.perf_counter()
        brokers.pop(b.url)[1](b.stop())
        stops[b.url] = time.perf_counter() - t0
        if stops[b.url] > 2.0:
            raise AssertionError(f"broker {b.url} took {stops[b.url]:.3f}"
                                 f" s to stop")
        return stops[b.url]

    def live() -> list:
        return [b for b, _, _ in brokers.values()]

    def settled() -> bool:
        ring = sorted(brokers)
        listed = racks.cmd_env.master_get("/cluster/status").get(
            "Members", {}).get("broker", [])
        return sorted(listed) == ring and all(
            b.peer_brokers == ring for b in live())

    async def forget_brokers() -> None:
        master.cluster_members.pop("broker", None)

    def replay(client, want_next: list) -> dict:
        """Every partition of MQ_TOPIC from offset 0: -> {(pi, offset):
        value bytes}, each partition dense and in order up to
        want_next[pi]."""
        got: dict = {}
        for pi in range(MQ_PARTITIONS):
            off = 0
            while off < want_next[pi]:
                msgs, nxt = client.fetch(MQ_TOPIC, pi, off, limit=16384)
                if not msgs:
                    raise AssertionError(f"partition {pi} ends at {off}, "
                                         f"not {want_next[pi]}")
                if [m["offset"] for m in msgs] != list(
                        range(off, off + len(msgs))):
                    raise AssertionError(f"partition {pi} from {off}: "
                                         f"not dense and in order")
                got.update({(pi, m["offset"]): m["value"].encode()
                            for m in msgs})
                off = nxt
        return got

    try:
        # 0 set-up.  Phase 28's filers stopped moments ago and the master
        # lists a member for 30 s after its last beat: they leave the
        # table first, so F is the filer the brokers and the shell see
        async def forget_filers() -> None:
            master.cluster_members.pop("filer", None)
        racks.mrun(forget_filers())
        racks.mrun(forget_brokers())
        # step 2's publishers, a process of their own, draw meanwhile
        here = os.path.dirname(os.path.abspath(__file__))
        pub_err = os.path.join(work, "publishers.log")
        with open(pub_err, "wb") as err:
            publishers = subprocess.Popen(
                [sys.executable, os.path.join(here, "chip_smoke.py"),
                 "--seed", str(seed), "--mq-publish"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
                text=True, cwd=here)
        pool = http.PooledHTTP(timeout=600.0, max_idle_per_host=MQ_THREADS)
        frun = loop_thread(loops)
        F = FilerServer(master.url, "127.0.0.1", free_port(),
                        data_dir=os.path.join(work, "filer"),
                        collection=MQ_COLLECTION,
                        chunk_cache_mem=MQ_CACHE_MEM)
        frun(F.start())
        P, Q = start_broker(), start_broker()
        until(settled, "P and Q never shared a ring of two", timeout=30)
        plog(f"0 set-up: F {F.url} (p29), brokers P {P.url} and Q "
             f"{Q.url} in one ring in "
             f"{time.perf_counter() - t_phase:.3f} s")

        # 1 the topic, through the port's shell
        k0 = dict(launches)
        t0 = time.perf_counter()
        out1 = run(f"mq.topic.configure -topic {MQ_TOPIC} -partitionCount "
                   f"{MQ_PARTITIONS}")
        if out1 != f"topic {MQ_TOPIC} partitions={MQ_PARTITIONS}\n":
            raise AssertionError(f"mq.topic.configure printed {out1!r}")
        for b in live():
            if len(b._get_topic(MQ_TOPIC) or []) != MQ_PARTITIONS:
                raise AssertionError(f"{b.url} has not the topic")
        step_counts("1 configure", k0, 0, t0)
        plog(f"1 configure: {out1.strip()} on both brokers; K1 0")

        # 2 publish
        msgs = mq_draws(rng, n_bytes=MQ_BYTES)  # the child draws the same
        client = MQClient([P.url, Q.url])
        acked: dict = {}  # (pi, offset) -> index into msgs
        lock = threading.Lock()

        def publish(i: int) -> None:
            key, value = msgs[i]
            acknowledged(i, *client.publish(MQ_TOPIC, value, key=key))

        def acknowledged(i: int, pi: int, off: int) -> None:
            if pi != mq_partition(msgs[i][0], MQ_PARTITIONS):
                raise AssertionError(f"key {msgs[i][0]!r} on partition "
                                     f"{pi}")
            with lock:
                if (pi, off) in acked:
                    raise AssertionError(f"({pi}, {off}) acknowledged "
                                         f"twice")
                acked[(pi, off)] = i
        k0 = dict(launches)
        t0 = time.perf_counter()
        if publishers.stdout.readline().strip() != "ready":
            raise AssertionError(f"the publishers exited "
                                 f"{publishers.wait(10)}")
        out2, _ = publishers.communicate(f"{P.url},{Q.url}\n",
                                         timeout=300)
        if publishers.returncode:
            with open(pub_err) as f:
                raise AssertionError(f"the publishers exited "
                                     f"{publishers.returncode}: "
                                     f"{f.read()[-1500:]}")
        publishers = None
        res = json.loads(out2.strip().splitlines()[-1])
        if sorted(i for i, _, _ in res["acked"]) != list(range(len(msgs))):
            raise AssertionError("the publishers' acks are not the draws")
        for i, pi, off in res["acked"]:
            acknowledged(i, pi, off)
        dt_pub = res["s"]
        per_part = [sum(1 for pi, _ in acked if pi == k)
                    for k in range(MQ_PARTITIONS)]
        want = [(pi, o) for pi in range(MQ_PARTITIONS)
                for o in range(per_part[pi])]
        if sorted(acked) != want:
            raise AssertionError(f"the acknowledged offsets are not "
                                 f"dense: {sorted(set(acked) - set(want))[:8]}"
                                 f" beyond, {sorted(set(want) - set(acked))[:8]}"
                                 f" missing")
        for b in live():  # the owner's log and its follower's replica
            got = [p.next_offset for p in b._get_topic(MQ_TOPIC)]
            if got != per_part:
                raise AssertionError(f"{b.url} holds {got}, the acks "
                                     f"{per_part}")
        step_counts("2 publish", k0, 0, t0)
        steps["2 publish"].update({
            "messages": len(msgs), "bytes": MQ_BYTES, "s": dt_pub,
            "msgs_per_s": len(msgs) / dt_pub,
            "mbps": MQ_BYTES / dt_pub / 1e6, "per_partition": per_part})
        plog(f"2 publish: {len(msgs)} messages ({MQ_MIN_SIZE}-{MQ_MAX_SIZE}"
             f" B log-uniform, {MQ_BYTES} B) through MQClient from "
             f"{MQ_THREADS} threads of a child in {dt_pub:.3f} s "
             f"({len(msgs) / dt_pub:.0f} msg/s, "
             f"{MQ_BYTES / dt_pub / 1e6:.1f} MB/s, the follower's "
             f"replication in it); per partition {per_part}, each key "
             f"where the reference's ring_slot puts it, both brokers "
             f"holding every message; K1 0")

        # 3 a group of two consumes everything and commits
        k0 = dict(launches)
        t0 = time.perf_counter()
        members = [client.consumer(MQ_TOPIC, group=MQ_GROUP, member=m)
                   for m in ("c1", "c2")]
        for m in members:
            m.join()
        members[0].join()  # learns of c2
        if sorted(members[0].partitions + members[1].partitions) != \
                list(range(MQ_PARTITIONS)):
            raise AssertionError(f"g1's split: {members[0].partitions} "
                                 f"{members[1].partitions}")
        seen: dict = {}
        for m in members:
            last = {pi: -1 for pi in m.partitions}
            while True:
                batch = m.poll(max_messages=1024)
                if not batch:
                    break
                for r in batch:
                    pi, off = r["partition"], r["offset"]
                    if off != last[pi] + 1 or (pi, off) in seen:
                        raise AssertionError(f"{m.member} got ({pi}, "
                                             f"{off}) after {last[pi]}")
                    last[pi] = off
                    seen[(pi, off)] = r["value"].encode()
            m.commit()
        dt_sub = time.perf_counter() - t0
        if seen.keys() != acked.keys() or any(
                seen[k] != msgs[i][1] for k, i in acked.items()):
            raise AssertionError("g1 did not read each message once, "
                                 "equal to its draw")
        committed = {pi: per_part[pi] for pi in range(MQ_PARTITIONS)}

        def offsets_of(url: str) -> dict:
            return {pi: json.loads(req(
                f"http://{url}/offsets/get?" + urllib.parse.urlencode(
                    {"group": MQ_GROUP, "topic": MQ_TOPIC,
                     "partition": str(pi)}))[1])["offset"]
                for pi in range(MQ_PARTITIONS)}
        for b in live():
            if offsets_of(b.url) != committed:
                raise AssertionError(f"{b.url}'s g1 offsets "
                                     f"{offsets_of(b.url)}")
        step_counts("3 consume", k0, 0, t0)
        steps["3 consume"].update({"s": dt_sub,
                                   "msgs_per_s": len(msgs) / dt_sub,
                                   "mbps": MQ_BYTES / dt_sub / 1e6})
        plog(f"3 consume: group {MQ_GROUP} (c1 {members[0].partitions}, "
             f"c2 {members[1].partitions}) polled {len(seen)} messages "
             f"once each, in offset order, == their draws, in "
             f"{dt_sub:.3f} s ({len(msgs) / dt_sub:.0f} msg/s, "
             f"{MQ_BYTES / dt_sub / 1e6:.1f} MB/s) and committed; "
             f"/offsets/get on both brokers == the commits; K1 0")

        # 4 /flush, then ec.encode -collection p29 once a beat reports
        # the sizes
        def view(col: str) -> dict:
            return {vi["id"]: vi["size"]
                    for nd in topo()["nodes"].values()
                    for vi in nd["volume_infos"]
                    if vi["collection"] == col}
        k0 = dict(launches)
        t0 = time.perf_counter()
        # step 9's child boots meanwhile, behind a master of its own
        mrun = loop_thread(loops)
        M = MasterServer("127.0.0.1", free_port())
        mrun(M.start())
        port = free_port()
        url = f"127.0.0.1:{port}"
        err_path = os.path.join(work, "cli_broker.log")
        t_spawn = time.perf_counter()
        with open(err_path, "wb") as err:
            child = subprocess.Popen(
                [sys.executable, "-c", MQ_CHILD, "mq.broker", "-master",
                 M.url, "-port", str(port)], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=err, cwd=here,
                env=dict(os.environ, PYTHONPATH=here))
        for b in live():
            req(f"http://{b.url}/flush", "POST", b"{}")

        def deletions_done() -> bool:
            """F's deletion queue (the chunks of the overwritten offset
            files and confs: their tombstones grow the .dat) empty, and
            its last batch through: no count moved for 0.3 s."""
            q = F.deletion
            n = (q.pending_count(), q.deleted_count, q.error_count)
            time.sleep(0.3)
            return n[0] == 0 and n == (q.pending_count(), q.deleted_count,
                                       q.error_count)
        until(deletions_done, "F's deletion queue never went idle")
        vols = {vid: servers[holder_of(vid)].store.get_volume(vid)
                for vid in view(MQ_COLLECTION)}

        def beat_sizes():
            for vol in vols.values():
                vol.flush()
            sizes = {vid: vol.data_size() for vid, vol in vols.items()}
            return sizes if view(MQ_COLLECTION) == sizes else None
        p29 = until(beat_sizes, "no beat reported the p29 sizes")
        units = {vid: predict_units(p29[vid], layout.LARGE_BLOCK_SIZE,
                                    layout.SMALL_BLOCK_SIZE)
                 for vid in p29}
        t_enc = time.perf_counter()
        run("lock")
        out4 = run(f"ec.encode -collection {MQ_COLLECTION} -fullPercent 0 "
                   f"-quietFor 0s")
        run("unlock")
        dt_enc = time.perf_counter() - t_enc
        listed = json.loads(out4.splitlines()[0].split(": ", 1)[1])
        if listed != sorted(p29):
            raise AssertionError(f"ec.encode selected {listed}; the p29 "
                                 f"volumes are {sorted(p29)}")
        step_counts("4 encode", k0, sum(units.values()), t0)
        until(lambda: all(sum(map(len, split(vid).values())) == 14
                          for vid in listed),
              "the p29 shard sets never reached the master")
        steps["4 encode"].update({"s": dt_enc, "volumes": listed,
                                  "dat_bytes": p29, "units": units})
        plog(f"4 encode: both brokers flushed; `ec.encode -collection "
             f"p29` of volumes {listed} (.dat {[p29[v] for v in listed]} "
             f"B) in {dt_enc:.3f} s; K1 {sum(units.values())} == the "
             f"layout's units")

        # 5 data shards 0 and 3 lost; F's chunk cache emptied
        k0 = dict(launches)
        t0 = time.perf_counter()
        for vid in listed:
            for u, shards in split(vid).items():
                gone = [s for s in MQ_LOST if s in shards]
                if gone:
                    admin(node_of[u], "/admin/ec/delete_shards",
                          {"volume": vid, "shards": gone})
        until(lambda: not any(set(MQ_LOST) & set(s) for vid in listed
                              for s in split(vid).values()),
              "the master still shows the deleted shards")
        F.chunk_cache = ChunkCache(mem_limit=MQ_CACHE_MEM)
        step_counts("5 loss", k0, 0, t0)
        plog(f"5 loss: data shards {list(MQ_LOST)} of every p29 EC volume "
             f"deleted where they lived, F's chunk cache emptied; K1 0")

        # 6 every broker restarted: recovery reads the segments back
        # through F, whose chunks lie on the lost shards
        evs = {vid: next(servers[n].store.get_ec_volume(vid)
                         for n in names
                         if servers[n].store.get_ec_volume(vid)
                         is not None) for vid in listed}

        def touches(fid: str) -> bool:
            f = t.FileId.parse(fid)
            ev = evs.get(f.volume_id)
            return ev is not None and bool(
                touching_needles(ev, {f.key: None}, MQ_LOST))

        def files_under(d: str) -> list:
            out = []
            for e in F.filer.iter_entries(d):
                out += files_under(e.full_path) if e.is_directory else [e]
            return out
        topic_files = files_under("/topics")
        fids = {v.fid for e in topic_files
                for v in ChunkGroup(e.chunks).read_views(0, e.size())}
        segs = [e for e in topic_files if e.full_path.endswith(".seg")]
        k1 = sum(1 for f in fids if touches(f))
        before = list(per_part)
        for b in live():
            stop_broker(b)
        racks.mrun(forget_brokers())
        empty_lrus()
        direct0 = F.hot_stats["direct"]
        k0 = dict(launches)
        t0 = time.perf_counter()
        P2 = start_broker()
        Q2 = start_broker()
        recover_s = [brokers[b.url][2] for b in (P2, Q2)]
        for b in (P2, Q2):
            got = [p.next_offset for p in b._get_topic(MQ_TOPIC)]
            if got != before:
                raise AssertionError(f"{b.url} recovered next offsets "
                                     f"{got}, not {before}")
        until(settled, "P2 and Q2 never shared a ring of two", timeout=30)
        client = MQClient([P2.url, Q2.url])
        client.refresh()
        back = replay(client, before)
        if back.keys() != acked.keys() or any(
                back[k] != msgs[i][1] for k, i in acked.items()):
            raise AssertionError("the replay after the restart is not the "
                                 "draws")
        for b in live():
            if offsets_of(b.url) != committed:
                raise AssertionError(f"{b.url}'s g1 offsets after the "
                                     f"restart: {offsets_of(b.url)}")
        one = (b"after-restart", b"0123456789abcdef")
        pi1, off1 = client.publish(MQ_TOPIC, one[0], key=one[1])
        if off1 != before[pi1]:
            raise AssertionError(f"the publish after the restart took "
                                 f"({pi1}, {off1}), not offset "
                                 f"{before[pi1]}")
        acked[(pi1, off1)] = len(msgs)
        msgs.append((one[1], one[0]))
        per_part[pi1] += 1
        direct = F.hot_stats["direct"] - direct0
        if direct != len(fids):
            raise AssertionError(f"F fetched {direct} chunks from the "
                                 f"volume tier; the files under /topics "
                                 f"have {len(fids)}")
        step_counts("6 restart", k0, k1, t0)
        seg_bytes = sum(e.size() for e in segs)
        steps["6 restart"].update({
            "segments": len(segs), "segment_bytes": seg_bytes,
            "files": len(topic_files), "chunks": len(fids),
            "direct": direct, "recover_s": recover_s,
            "recover_mbps": seg_bytes / recover_s[0] / 1e6,
            "stop_s": dict(stops)})
        plog(f"6 restart: P and Q stopped in "
             f"{', '.join(f'{s:.3f}' for s in stops.values())} s; P2 "
             f"recovered {len(segs)} segments ({seg_bytes} B) through F "
             f"in {recover_s[0]:.3f} s ({seg_bytes / recover_s[0] / 1e6:.1f}"
             f" MB/s), Q2 from F's cache in {recover_s[1]:.3f} s; next "
             f"offsets {before} kept, the replay from 0 == the draws, "
             f"g1's offsets kept, a publish took ({pi1}, {off1}); F's "
             f"direct {direct} == the distinct chunks under /topics; K1 "
             f"{k1} (those on a lost shard)")

        # 7 failover: Q2 stopped, more published, the shell's view
        epochs0 = {pi: master._mq_epochs.get(f"{MQ_TOPIC}/{pi}", 0)
                   for pi in range(MQ_PARTITIONS)}
        k0 = dict(launches)
        t0 = time.perf_counter()
        stop_broker(Q2)
        racks.mrun(forget_brokers())
        until(settled, "P2's ring never settled on itself", timeout=30)
        dt_settle = time.perf_counter() - t0
        client.refresh()  # the client's ring is P2's now
        more = mq_draws(rng, n=MQ_MORE)
        base = len(msgs)
        msgs.extend(more)
        dt_more = fan(publish, list(range(base, len(msgs))), MQ_THREADS)
        per_part = [sum(1 for pi, _ in acked if pi == k)
                    for k in range(MQ_PARTITIONS)]
        ring = [P2.url]
        out7 = {line: run(line) for line in (
            "mq.balance", "mq.topic.list", f"mq.topic.desc -topic "
            f"{MQ_TOPIC}")}
        want7 = {
            "mq.balance": f"broker ring: {ring}\n{MQ_TOPIC}: "
                          f"{MQ_PARTITIONS} partition(s)\n" + "".join(
                              f"  p{pi}: owner {P2.url} follower - "
                              f"next_offset {per_part[pi]}\n"
                              for pi in range(MQ_PARTITIONS)),
            "mq.topic.list": f"{MQ_TOPIC:32s} partitions={MQ_PARTITIONS} "
                             f"next_offsets={per_part}\n",
            f"mq.topic.desc -topic {MQ_TOPIC}": "".join(
                f"partition {pi}: owner={P2.url} next_offset="
                f"{per_part[pi]}\n" for pi in range(MQ_PARTITIONS))}
        if out7 != want7:
            raise AssertionError(f"the shell printed {out7}")
        # P2's log itself (step 6 read everything through the client)
        held = {(pi, m.offset): m.value
                for pi, part in enumerate(P2._get_topic(MQ_TOPIC))
                for m in part.snapshot()[1]}
        if held.keys() != acked.keys() or any(
                held[k] != msgs[i][1] for k, i in acked.items()):
            raise AssertionError("messages lost in the failover")
        step_counts("7 failover", k0, 0, t0)
        steps["7 failover"].update({"messages": MQ_MORE, "s": dt_more,
                                    "settle_s": dt_settle})
        plog(f"7 failover: Q2 stopped in {stops[Q2.url]:.3f} s, the ring "
             f"settled on P2 in {dt_settle:.3f} s, {MQ_MORE} more messages "
             f"published through the client in {dt_more:.3f} s; "
             f"mq.balance, mq.topic.list and "
             f"mq.topic.desc show P2 owning all {MQ_PARTITIONS} "
             f"partitions, next offsets {per_part}; every acknowledged "
             f"message in P2's log == its draw; K1 0")

        # 8 fencing
        k0 = dict(launches)
        t0 = time.perf_counter()
        epochs1 = {pi: master._mq_epochs.get(f"{MQ_TOPIC}/{pi}", 0)
                   for pi in range(MQ_PARTITIONS)}
        if not all(epochs1[pi] > epochs0[pi]
                   for pi in range(MQ_PARTITIONS)):
            raise AssertionError(f"the epochs did not all rise across the "
                                 f"ring change: {epochs0} -> {epochs1}")
        part = P2._get_topic(MQ_TOPIC)[0]
        held = part.next_offset - 1  # already held: nothing appended

        def replicate(epoch: int, want: int) -> bytes:
            body = json.dumps({
                "topic": MQ_TOPIC, "partition": 0,
                "partition_count": MQ_PARTITIONS, "offset": held,
                "ts_ns": 1, "epoch": epoch, "key": "",
                "value": "c3RhbGU="}).encode()
            return req(f"http://{P2.url}/replicate", "POST", body,
                       want=(want,))[1]
        replicate(epochs1[0], 200)
        fenced = replicate(epochs0[0], 403)
        if b"fenced" not in fenced:
            raise AssertionError(f"/replicate below the epoch: {fenced!r}")
        replicate(epochs1[0], 200)
        if part.next_offset != held + 1:
            raise AssertionError("a /replicate of a held offset appended")
        step_counts("8 fencing", k0, 0, t0)
        plog(f"8 fencing: the master's epoch of every partition rose "
             f"across the ring change; on P2 a /replicate at the new epoch"
             f" 200, at the old one 403 ({fenced.decode()[:60]}), at the "
             f"new one again 200; K1 0")

        # 9 the CLI's mq.broker, started in a child at step 4 behind a
        # master of its own (M), so it is alone in its ring
        k0 = dict(launches)
        t0 = time.perf_counter()

        def child_up() -> bool:
            if child.poll() is not None:
                with open(err_path) as f:
                    raise AssertionError(f"the CLI's broker exited "
                                         f"{child.returncode}: "
                                         f"{f.read()[-1500:]}")
            try:
                st, raw = req(f"http://{url}/status", want=(200, 404))
            except OSError:
                return False
            return st == 200 and json.loads(raw)["brokers"] == [url]
        until(child_up, "the CLI's broker never came up", timeout=60)
        dt_up = time.perf_counter() - t_spawn
        cli = MQClient([url])
        cli.configure("chip.p29cli", partition_count=2)
        sent = {}
        for key, value in mq_draws(rng, n=MQ_CLI):
            sent[cli.publish("chip.p29cli", value, key=key)] = value
        got = {}
        for pi in range(2):
            off = 0
            while True:
                batch, off = cli.fetch("chip.p29cli", pi, off)
                if not batch:
                    break
                got.update({(pi, r["offset"]): r["value"].encode()
                            for r in batch})
        if got != sent:
            raise AssertionError("the CLI's broker gave back other bytes")
        out, _ = child.communicate(b"report\n", timeout=60)
        loaded = json.loads(out.decode().strip().splitlines()[-1])
        child = None
        if any(loaded.values()):
            raise AssertionError(f"the CLI's broker loaded {loaded}")
        step_counts("9 cli", k0, 0, t0)
        steps["9 cli"].update({"up_s": dt_up, "messages": MQ_CLI})
        plog(f"9 cli: `mq.broker` in a child behind M up {dt_up:.3f} s "
             f"after its start; "
             f"MQClient configured chip.p29cli, published {MQ_CLI} "
             f"messages and fetched every byte back; the child loaded "
             f"{loaded}; K1 0")
    finally:
        t_stop = time.perf_counter()
        for proc in (child, publishers):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(10)
        for b, brun, _ in list(brokers.values()):
            brun(b.stop())
        brokers.clear()
        if F is not None:
            frun(F.stop())
        if M is not None:
            mrun(M.stop())
        stop_loops(loops)
        if pool is not None:
            pool.close()
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "steps": steps, "counts": counts,
           "predicted": predicted, "stop_s": time.perf_counter() - t_stop,
           "s": time.perf_counter() - t_phase}
    plog(f"launches per step {counts} (K1 predicted {predicted}); phase "
         f"wall {out['s']:.1f} s")
    return out


# phase 30: the chaos harness's cells, then the fleet simulator, on the card
CHAOS_CELLS = (("degraded_read", "shard_loss"), ("degraded_read", "bit_rot"),
               ("degraded_read", "convert_mid_failure"),
               ("filer_stream", "rack_loss"))
CHAOS_RACKS = ["a", "b", "c"]
CHAOS_FLEET_TICKS = 5  # the fleet's aggregator ticks, their median printed

# the CLI's `python -m seaweedfs_tpu_torch.maintenance.fleetsim <master>`
# through runpy, ended by a SIGINT as an operator's ^C would; it reports
# its exit code and what it loaded
FLEETSIM_CHILD = r"""
import json, runpy, sys
sys.argv = ["fleetsim", sys.argv[1]]
rc = None
try:
    runpy.run_module("seaweedfs_tpu_torch.maintenance.fleetsim",
                     run_name="__main__")
except SystemExit as e:
    rc = e.code
print(json.dumps({"rc": rc, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in
    ("torch", "jax", "seaweedfs_tpu"))}), flush=True)
"""


def chaos_layout(c) -> dict:
    """{vid: {shard id: (server index, file)}} of every EC volume on the
    cluster's live nodes."""
    from seaweedfs_tpu_torch.storage.ec import layout
    out: dict = {}
    for i, vs in enumerate(c.volume_servers):
        if vs is None:
            continue
        for loc in vs.store.locations:
            for vid, ev in list(loc.ec_volumes.items()):
                for sid in ev.shard_ids():
                    out.setdefault(vid, {})[sid] = \
                        (i, ev.base + layout.to_ext(sid))
    return out


def chaos_reduced_launches(local, helpers: list, lost: list,
                           k: int = 10) -> int:
    """K1 launches of one reduced rebuild of shards that fit one segment
    and one batch chunk, by the planner's rule as the reference documents
    it: each lost shard in turn is one window of the rebuilder's local
    survivors and, when they are fewer than k, the first k - |local|
    remote survivors ordered by (locality, node, shard); one apply of the
    local part and one partial per helper node in the window; the rebuilt
    shard joins the local survivors for the next."""
    local = set(local)
    total = 0
    for sid in sorted(lost):
        remote = sorted((h["locality"], h["node"], s) for h in helpers
                        for s in h["shards"] if s != sid)
        t = k - len(local)
        window = remote[:t] if t > 0 else []
        total += (1 if local else 0) + len({n for _, n, _ in window})
        local.add(sid)
    return total


def chaos_predict(c, fault: str, pre: dict, dats: dict) -> dict:
    """K1 and K2 of one cell from its own layout (`pre`: {vid: {shard
    id: (node index, bytes)}} before the fault; `dats`: {vid: .dat
    bytes} of node 0's plain volumes then), each as [lo, hi]: the
    EC volumes' units (from the encode-time .dat size in their .vif), the
    scrub windows the passes verify, the degraded reads made while a
    shard is lost (none: every verify runs after the heal), the reduced
    rebuilds' applies (the planner's decisions, their rebuilders' final
    shards less the lost ones); K2 ceil(units / UNIT_BATCH) per
    conversion batch, once when the kill lands before the batch or after
    it commits, twice when it lands in between."""
    from seaweedfs_tpu_torch.maintenance import scrub
    from seaweedfs_tpu_torch.ops import fleet_convert
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    large, small = layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE
    out = {"units": 0, "windows": [0, 0], "degraded": 0, "repair": 0,
           "k2": [0, 0]}
    if fault == "convert_mid_failure":
        units = sum(predict_units(size, large, small)
                    for size in dats.values())
        batch = -(-units // fleet_convert.UNIT_BATCH)
        out["k2"] = [batch, 2 * batch]
    now = chaos_layout(c)
    for vid, files in pre.items():
        path = next(iter(now[vid].values()))[1]
        vif = ec_files.read_vif(path[:-len(layout.to_ext(0))])
        out["units"] += predict_units(vif["dat_file_size"], large, small)
        size = next(iter(files.values()))[1]
        if size > min(REPAIR_ALIGN, REPAIR_BATCH):
            raise AssertionError(f"[chaos] volume {vid}'s shards are "
                                 f"{size} B: the model covers one "
                                 f"segment and one chunk")
    decisions = list(c.leader().maintenance.decisions)
    url_of = {vs.url: vs for vs in c.volume_servers if vs is not None}
    for d in decisions:
        if d["mode"] != "reduced" or d.get("replans"):
            raise AssertionError(f"[chaos] a repair the model does not "
                                 f"cover: {d}")
        ev = url_of[d["rebuilder"]].store.get_ec_volume(d["vid"])
        out["repair"] += chaos_reduced_launches(
            set(ev.shard_ids()) - set(d["lost"]), d["helpers"], d["lost"])
    if fault == "bit_rot":
        # pass 1: node 0 verifies the flipped window; the others read its
        # quarantined range of the flipped shard and skip it, unless that
        # is a parity shard.  Pass 2: the rebuilder verifies; the others
        # hold the shard's old home in their 10 s location cache and skip,
        # unless the rebuilder is node 0 or their cache expired
        home = {d["vid"]: d["rebuilder"] for d in decisions}
        for vid, files in pre.items():
            windows = -(-next(iter(files.values()))[1]
                        // scrub.DEFAULT_WINDOW)
            holders = len({i for i, _ in files.values()})
            flipped = min(s for s, (i, _) in files.items() if i == 0)
            first = 1 + (holders - 1) * (flipped >= 10)
            lo = holders if home.get(vid) == c.volume_servers[0].url else 1
            out["windows"][0] += windows * (first + lo)
            out["windows"][1] += windows * (first + holders)
    base = out["units"] + out["degraded"] + out["repair"]
    out["k1"] = [base + out["windows"][0], base + out["windows"][1]]
    return out


def chaos_cell(c, workload: str, fault: str, launches: dict,
               work: str) -> dict:
    """One cell through `run_scenario` on `c`: the shard files' sha256
    taken before the fault (and, for the conversion, the .dat of each of
    node 0's plain volumes), K1 and K2 of the cell against
    `chaos_predict`, and after it every healed shard set equal to its
    pre-fault sha256 (a converted set: to write_ec_files' plain version
    of its .dat, on the CPU)."""
    from seaweedfs_tpu_torch.maintenance import chaos
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    pre: dict = {}
    dats: dict = {}

    def before_fault(c) -> None:
        for vid, files in chaos_layout(c).items():
            pre[vid] = {sid: (i, os.path.getsize(path), sha256(path))
                        for sid, (i, path) in files.items()}
        if fault == "convert_mid_failure":
            for loc in c.volume_servers[0].store.locations:
                for vid, v in list(loc.volumes.items()):
                    dats[vid] = os.path.getsize(v._base + ".dat")

    k0 = dict(launches)
    rep = chaos.run_scenario(c, workload, fault, before_fault=before_fault)
    got = {k: launches[k] - k0[k] for k in launches}
    pred = chaos_predict(c, fault, {v: {s: f[:2] for s, f in fs.items()}
                                    for v, fs in pre.items()}, dats)
    now = chaos_layout(c)
    for vid, files in pre.items():
        if sorted(now.get(vid, {})) != list(range(layout.TOTAL_SHARDS)):
            raise AssertionError(f"[chaos] {fault}: volume {vid} healed to "
                                 f"shards {sorted(now.get(vid, {}))}")
        for sid, (_, _, want) in files.items():
            if sha256(now[vid][sid][1]) != want:
                raise AssertionError(f"[chaos] {fault}: volume {vid} shard "
                                     f"{sid} differs from before the fault")
    for vid in dats:
        base = os.path.join(work, f"plain{vid}")
        v = c.volume_servers[0].store.get_volume(vid)
        shutil.copy(v._base + ".dat", base + ".dat")
        ec_files.write_ec_files(base, device="cpu")
        shards = now.get(vid, {})
        if sorted(shards) != list(range(layout.TOTAL_SHARDS)) or any(
                sha256(shards[s][1]) != sha256(base + layout.to_ext(s))
                for s in shards):
            raise AssertionError(f"[chaos] {fault}: volume {vid}'s "
                                 f"converted shards differ from the plain "
                                 f"encode of its .dat")
    k1_ok = pred["k1"][0] <= got["gf_apply"] <= pred["k1"][1]
    k2_ok = pred["k2"][0] <= got["gf_apply_batch"] <= pred["k2"][1]
    if not (k1_ok and k2_ok) or \
            (fault == "convert_mid_failure") != bool(got["gf_apply_batch"]):
        raise AssertionError(f"[chaos] {workload} x {fault} launched {got}"
                             f", the layout predicts {pred}")
    return {"report": rep, "launches": got, "predicted": pred,
            "volumes": sorted(pre) or sorted(dats)}


def phase_chaos(vdir: str, launches: dict, device=None) -> dict:
    """Phase 30: the port's chaos harness and fleet simulator (ROADMAP
    1.23) on the card.  Four cells of `CHAOS_CELLS`, each through
    `run_scenario` on a fresh port `ChaosCluster` on a loop thread of its
    own (the port's master, three `VolumeServer`s on the card in racks a,
    b and c, one `FilerServer`; the workloads' sizes and seeds are the
    reference harness's): degraded_read x shard_loss, x bit_rot (the
    flip found by the on-request remote scrub of the nodes' background
    scrubbers, at 1e6 MB/s and a 3600 s interval, and healed), x
    convert_mid_failure (the scheduler's K2 batch on node 0, killed
    mid-flight) and filer_stream x rack_loss (a reduced repair on the
    rack-labelled cluster).  Per cell: K1 and K2 against
    `chaos_predict`'s layout, every healed shard set equal to its
    pre-fault sha256, `volume.fsck -json` ok (inside `run_scenario`).
    Then `FleetSim` at its defaults (500 vnodes in 10 racks, 8 volumes
    each) against the last cell's master: 500 beats, the aggregator's
    items and backlog, a rack failed and recovered, 50 nodes left, the
    median of its CHAOS_FLEET_TICKS ticks; K1 and K2 0.  Meanwhile a child
    runs the CLI's `python -m seaweedfs_tpu_torch.maintenance.fleetsim`
    against a master of its own from the phase's start: its 500 vnodes
    register, a SIGINT ends it with 0, and it loaded neither torch, jax
    nor the reference package.  Every master runs with its repair loop,
    aggregator loop and canary off, hedging off."""
    import pathlib
    import signal
    from seaweedfs_tpu_torch.maintenance import chaos, fleetsim
    from seaweedfs_tpu_torch.server.master import MasterServer

    card = card_name_power()
    work = os.path.join(vdir, "chaos")
    os.makedirs(work)
    t_phase = time.perf_counter()
    cells: dict = {}
    loops: list = []
    child = cluster = M = None
    env = scoped_env(
        WEEDTPU_REPAIR_INTERVAL="0", WEEDTPU_AGG_INTERVAL="0",
        WEEDTPU_CANARY_INTERVAL="0", WEEDTPU_HEDGE_PCT="0",
        WEEDTPU_SCRUB_MBPS="1000000", WEEDTPU_SCRUB_INTERVAL="3600")
    env.__enter__()
    try:
        # the CLI's fleet, behind a master of its own (M), registering
        # while the cells run
        mrun = loop_thread(loops)
        M = MasterServer("127.0.0.1", free_port())
        mrun(M.start())
        t_child = time.time()
        child = subprocess.Popen(
            [sys.executable, "-c", FLEETSIM_CHILD, M.url],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)

        for i, (workload, fault) in enumerate(CHAOS_CELLS):
            t0 = time.perf_counter()
            cdir = os.path.join(work, f"cell{i}")
            os.makedirs(cdir)
            cluster = chaos.ChaosCluster(
                pathlib.Path(cdir), n_volume_servers=3, with_filer=True,
                racks=CHAOS_RACKS, device=device).start()
            cluster.wait_heartbeats()
            rec = chaos_cell(cluster, workload, fault, launches, cdir)
            rec["s"] = time.perf_counter() - t0
            cells[f"{workload} x {fault}"] = rec
            pred = rec["predicted"]
            log(f"[chaos] {workload} x {fault}: {rec['report']}; volumes "
                f"{rec['volumes']}; launches {rec['launches']}, predicted "
                f"K1 {pred['k1']} (units {pred['units']} + windows "
                f"{pred['windows']} + degraded {pred['degraded']} + "
                f"repair {pred['repair']}), K2 {pred['k2']}; every shard "
                f"set sha256-equal to before the fault, fsck ok; {card}")
            if i < len(CHAOS_CELLS) - 1:
                cluster.stop()
                cluster = None

        # the CLI's fleet registered meanwhile: stop it
        def registered() -> int:
            with M.topo._lock:
                return sum(1 for n in M.topo.nodes.values()
                           if n.last_seen >= t_child)
        until(lambda: registered() >= fleetsim.NODES or
              child.poll() is not None, "the CLI's fleet never registered",
              timeout=60)
        n_cli = registered()
        child.send_signal(signal.SIGINT)
        out, err = child.communicate(timeout=60)
        rep = json.loads(out.decode().strip().splitlines()[-1])
        if n_cli != fleetsim.NODES or child.returncode != 0 or \
                rep != {"rc": 0, "loaded": []}:
            raise AssertionError(f"[chaos cli] {n_cli} vnodes registered, "
                                 f"exit {child.returncode}, {rep}: "
                                 f"{err.decode()[-1500:]}")
        child = None
        log(f"[chaos cli] `python -m seaweedfs_tpu_torch.maintenance."
            f"fleetsim` registered {n_cli} vnodes behind a master of its "
            f"own, ended by SIGINT with 0, loaded {rep['loaded']}")

        # the fleet simulator at its defaults against the last cell's
        # master
        k0 = dict(launches)
        master = cluster.leader()
        sim = fleetsim.FleetSim(master.url).start()
        try:
            t0 = time.perf_counter()
            beats = sim.beat_all()
            t_beat = time.perf_counter() - t0

            def tick() -> dict:
                st, raw, _ = chaos._req(
                    f"http://{master.url}/cluster/loops?refresh=1")
                if st != 200:
                    raise AssertionError(f"[chaos fleet] /cluster/loops: "
                                         f"HTTP {st}")
                return json.loads(raw)["loops"]["aggregator"]
            # CHAOS_FLEET_TICKS ticks: the fleet registered, a rack down,
            # recovered, then the rest steady
            agg = tick()
            walls = [agg["wall_last"]]
            failed = sim.fail_rack("rack0")
            down = tick()
            walls.append(down["wall_last"])
            sim.recover_rack("rack0")
            up = tick()
            walls.append(up["wall_last"])
            backlog_failed, backlog_recovered = down["backlog"], \
                up["backlog"]
            while len(walls) < CHAOS_FLEET_TICKS:
                walls.append(tick()["wall_last"])
            gone = sim.stop_nodes(50)
            left = len(sim)
        finally:
            sim.stop()
        fleet = {"beats": beats, "beat_s": t_beat,
                 "items_total": agg["items_total"],
                 "backlog": agg["backlog"], "failed": len(failed),
                 "backlog_failed": backlog_failed,
                 "backlog_recovered": backlog_recovered,
                 "left": left, "tick_s": walls,
                 "tick_median_s": statistics.median(walls),
                 "launches": {k: launches[k] - k0[k] for k in launches}}
        if beats != fleetsim.NODES or \
                agg["items_total"] < fleetsim.NODES + 1 or \
                agg["backlog"] or len(failed) != 50 or \
                backlog_failed < 50 or backlog_recovered or \
                len(gone) != 50 or left != 450 or \
                any(fleet["launches"].values()):
            raise AssertionError(f"[chaos fleet] {fleet}")
        log(f"[chaos fleet] FleetSim(500 vnodes, 10 racks, 8 volumes "
            f"each): beat_all {beats} in {t_beat:.3f} s; aggregator "
            f"items_total {agg['items_total']}, backlog {agg['backlog']}; "
            f"fail_rack(rack0) {len(failed)} nodes, backlog "
            f"{backlog_failed}, recovered {backlog_recovered}; "
            f"stop_nodes(50) leaves {left}; median of the "
            f"{CHAOS_FLEET_TICKS} ticks (registered, rack down, recovered, "
            f"steady) {fleet['tick_median_s']:.3f} s "
            f"({', '.join(f'{w:.3f}' for w in walls)}); launches "
            f"{fleet['launches']}; {card}")
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait(10)
        if cluster is not None:
            cluster.stop()
        if M is not None:
            mrun(M.stop())
        stop_loops(loops)
        env.__exit__(None, None, None)
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "cells": cells, "fleet": fleet,
           "s": time.perf_counter() - t_phase}
    log(f"[chaos] phase wall {out['s']:.1f} s; {card}")
    return out


def chaos_worker(vdir: str) -> int:
    """Phase 30 in a process of its own (`--chaos-worker`): the card's
    context made, then, at a line on stdin (the parent's phase 27
    starting), `phase_chaos` under `vdir`, and one JSON line: the phase's
    record, its launches and its staged copies."""
    import torch
    from seaweedfs_tpu_torch.ops import gf_cuda
    torch.zeros(1, device="cuda")
    if not sys.stdin.readline():
        return 1  # the parent ended before its start signal
    gf_cuda.reset_launches()
    rec = phase_chaos(vdir, gf_cuda.LAUNCHES)
    print(json.dumps({"chaos": rec, "launches": dict(gf_cuda.LAUNCHES),
                      "staged": dict(gf_cuda.STAGED)}), flush=True)
    return 0


# phase 31: the launch tile's sweep, its pin and the tile-drift sentinel
TILE_SWEEP_ITERS = 3  # timed launches per tile: micro_sweep's default,
#                       which the sentinel's sweeps take
TILE_SENTINEL_TICKS = 2  # the sentinel's sweeps before it is stopped
TILE_FOREIGN = "tpu:TPU v5 lite:1"  # a pin's fingerprint from another chip


def phase_tile(vdir: str, server_src: str, dat_hash: str,
               hashes: list[str], enc_launches: int, launches: dict,
               device=None) -> dict:
    """Phase 31: the launch tile (ops/gf_cuda.py) and its sentinel on the
    card, with WEEDTPU_TILE_PIN in the work directory.  (1) micro_sweep at
    [10, 1 MiB]: one line per candidate, K1 candidates x (1 + iters);
    each candidate's product of the sweep's input byte-equal to the plain
    version's and to the default tile's (K1 one each).  (2) The winner
    pinned; resolved_tile gives it; a pin with another chip's
    fingerprint gives the default; WEEDTPU_EC_TILE wins over the pin.
    (3) The phase-3 volume (links of its copy) encoded at the pinned tile:
    the 14 shards sha256-equal to phase 4's, K1 phase 4's count.  (4) A
    port master and a card VolumeServer started with
    WEEDTPU_TILE_SENTINEL_INTERVAL=1: after TILE_SENTINEL_TICKS sweeps
    the sentinel is stopped, and its verdict (held against its own sweep
    table) is on /debug/pipeline, the master's /cluster/perf, /metrics
    (weedtpu_tile_drift) and the shell's cluster.perf; K1 one sweep per
    tick.  (5) The sentinel cleared.  K2 0 throughout."""
    import io

    import numpy as np
    import torch
    from seaweedfs_tpu_torch.models import rs
    from seaweedfs_tpu_torch.ops import gf_cuda
    from seaweedfs_tpu_torch.server import volume_server as vsmod
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
    from seaweedfs_tpu_torch.stats import pipeline
    from seaweedfs_tpu_torch.stats.aggregate import parse_exposition
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    from seaweedfs_tpu_torch.utils import http

    card = card_name_power()

    def tlog(msg: str) -> None:
        log(f"[tile] {msg} [{card}]")

    work = os.path.join(vdir, "tile")
    dirs = {n: os.path.join(work, n) for n in ("enc", "vs")}
    for d in dirs.values():
        os.makedirs(d)
    pin_path = os.path.join(work, "pin.json")
    tiles = sorted(gf_cuda.SWEEP_TILES)
    steps: dict = {}
    counts: dict = {}
    t_phase = time.perf_counter()

    def step_counts(name: str, k0: dict, k1: int) -> None:
        got = {k: launches[k] - k0[k] for k in launches}
        counts[name] = got
        want = {"gf_apply": k1, "gf_apply_batch": 0}
        if got != want:
            raise AssertionError(f"phase 31 {name}: launched {got}, "
                                 f"predicted {want}")

    loops: list = []
    client = http.PooledHTTP(timeout=120.0, max_idle_per_host=4)
    master = vs = sentinel = None
    saved_ec_tile = os.environ.pop("WEEDTPU_EC_TILE", None)
    try:
        with scoped_env(WEEDTPU_TILE_PIN=pin_path):
            # 1 the sweep, then every candidate's bytes
            k0 = dict(launches)
            t0 = time.perf_counter()
            sweep = gf_cuda.micro_sweep(iters=TILE_SWEEP_ITERS,
                                        device=device)
            dt = time.perf_counter() - t0
            if sorted(sweep) != tiles or not all(
                    v > 0 for v in sweep.values()):
                raise AssertionError(f"micro_sweep gave {sweep}, wanted a "
                                     f"rate for each of {tiles}")
            step_counts("1 sweep", k0, len(tiles) * (1 + TILE_SWEEP_ITERS))
            for t in tiles:
                tlog(f"1 sweep [10,1MiB] tile {t}: {sweep[t]:.3f} GB/s")
            k0 = dict(launches)
            C = rs.get_code(10, 4).parity_matrix
            dev = gf_cuda.resolve_device(device)
            x = gf_cuda.device_empty((10, gf_cuda.SWEEP_N), dev)
            x.copy_(torch.from_numpy(np.random.default_rng(0).integers(
                0, 256, (10, gf_cuda.SWEEP_N), dtype=np.uint8)))
            plain = gf_cuda.gf_apply_plain(
                gf_cuda.CudaGFMatrix(C).bitmat.to(dev), x)
            outs = {t: gf_cuda.CudaGFMatrix(C, tile=t)(x) for t in tiles}
            for t in tiles:
                if not torch.equal(outs[t], plain) or not torch.equal(
                        outs[t], outs[gf_cuda.DEFAULT_TILE]):
                    raise AssertionError(f"tile {t}: the product differs "
                                         f"from the plain version's or the "
                                         f"default tile's")
            del outs, plain, x
            step_counts("1 bytes", k0, len(tiles))
            best = max(sweep, key=sweep.get)
            steps["1 sweep"] = {"gbps": {str(t): sweep[t] for t in tiles},
                                "best": best, "s": dt}
            tlog(f"1 sweep: {len(tiles)} candidates in {dt:.3f} s, K1 "
                 f"{counts['1 sweep']['gf_apply']} (x {1 + TILE_SWEEP_ITERS}"
                 f" each); best {best} ({sweep[best]:.3f} GB/s, default "
                 f"{gf_cuda.DEFAULT_TILE}: "
                 f"{sweep[gf_cuda.DEFAULT_TILE]:.3f}); each tile's product "
                 f"== plain == the default tile's, K1 {len(tiles)}")

            # 2 the pin, a foreign pin, the override
            written = gf_cuda.save_tile_pin(best, sweep[best], sweep,
                                            device=device)
            home = os.path.join(os.path.expanduser("~"),
                                ".weedtpu_tile_pin.json")
            if written != pin_path or os.path.realpath(written) == \
                    os.path.realpath(home):
                raise AssertionError(f"the pin went to {written}")
            pin = gf_cuda.load_tile_pin()
            fingerprint = gf_cuda.chip_fingerprint(device)
            if pin["fingerprint"] != fingerprint or \
                    gf_cuda.resolved_tile(device=device) != best or \
                    gf_cuda.get_codec(10, 4, device=device).tile != best:
                raise AssertionError(f"the pin {pin} does not apply")
            foreign_path = os.path.join(work, "foreign.json")
            with open(foreign_path, "w") as f:
                json.dump(dict(pin, fingerprint=TILE_FOREIGN,
                               tile=max(tiles)), f)
            with scoped_env(WEEDTPU_TILE_PIN=foreign_path):
                if gf_cuda.resolved_tile(device=device) != \
                        gf_cuda.DEFAULT_TILE:
                    raise AssertionError("a foreign pin applied")
            other = next(t for t in reversed(tiles) if t != best)
            with scoped_env(WEEDTPU_EC_TILE=str(other)):
                if gf_cuda.resolved_tile(device=device) != other:
                    raise AssertionError("WEEDTPU_EC_TILE lost to the pin")
            tlog(f"2 pin: {best} written to the work directory with "
                 f"{fingerprint!r}, resolved_tile {best}; a pin of "
                 f"{max(tiles)} with {TILE_FOREIGN!r} resolves "
                 f"{gf_cuda.DEFAULT_TILE}; WEEDTPU_EC_TILE={other} wins "
                 f"over the pin")

            # 3 the phase-3 volume encoded at the pinned tile
            if sha256(server_src + ".dat") != dat_hash:
                raise AssertionError("the phase-3 copy changed")
            ebase = os.path.join(dirs["enc"], os.path.basename(server_src))
            for ext in (".dat", ".idx"):
                os.link(server_src + ext, ebase + ext)
            if ec_files._get_codec(device).tile != best:
                raise AssertionError("the encode's codec is not at the "
                                     "pinned tile")
            k0 = dict(launches)
            t0 = time.perf_counter()
            ec_files.write_ec_files(ebase, device=device)
            dt = time.perf_counter() - t0
            got = sha256_many([ebase + layout.to_ext(i) for i in range(14)])
            if got != hashes:
                bad = [i for i in range(14) if got[i] != hashes[i]]
                raise AssertionError(f"shards {bad} at tile {best} differ "
                                     f"from phase 4's")
            step_counts("3 encode", k0, enc_launches)
            steps["3 encode"] = {"tile": best, "s": dt}
            tlog(f"3 encode: the phase-3 volume at tile {best} in {dt:.2f} "
                 f"s, 14 shards sha256 == phase 4's, K1 {enc_launches}")

            # 4 the sentinel behind a port master and a card server
            mrun, vrun = loop_thread(loops), loop_thread(loops)
            with scoped_env(WEEDTPU_REPAIR_INTERVAL="0",
                            WEEDTPU_CANARY_INTERVAL="0",
                            WEEDTPU_AGG_INTERVAL="0",
                            WEEDTPU_SCRUB_MBPS="0",
                            WEEDTPU_TILE_SENTINEL_INTERVAL="1"):
                master = MasterServer("127.0.0.1", free_port())
                master.vacuum_enabled = False
                mrun(master.start())
                k0 = dict(launches)
                vs = vsmod.VolumeServer([dirs["vs"]], master.url,
                                        "127.0.0.1", free_port(),
                                        heartbeat_interval=0.5,
                                        device=device)
                vrun(vs.start())
            sentinel = pipeline._sentinel
            if sentinel is None or sentinel.interval != 1.0 or \
                    sentinel.device != vs.device:
                raise AssertionError("the server started no sentinel on "
                                     "its device")
            ticks: list = []
            tick = sentinel.run_once

            def counted() -> dict:
                st = tick()
                ticks.append(st["state"])
                return st
            sentinel.run_once = counted  # before its first tick, 1 s on
            until(lambda: len(ticks) >= TILE_SENTINEL_TICKS,
                  "the sentinel did not tick", timeout=15)
            sentinel.stop()
            step_counts("4 sentinel", k0, len(ticks) * len(tiles) *
                        (1 + TILE_SWEEP_ITERS))
            verdict = sentinel.status()
            if verdict["state"] not in ("ok", "stale") or \
                    "sweep_failed" in ticks:
                raise AssertionError(f"the sentinel's ticks {ticks}, last "
                                     f"{verdict}")
            table = {int(t): v for t, v in verdict["sweep"].items()}
            pinned, top = table[verdict["pinned_tile"]], max(table.values())
            drift = max(0.0, top / pinned - 1.0)
            if sorted(table) != tiles or verdict["pinned_tile"] != best or \
                    abs(verdict["drift"] - drift) > 1e-3 or \
                    (verdict["state"] == "stale") != (drift > 0.1):
                raise AssertionError(f"the verdict {verdict} disagrees with "
                                     f"its sweep table")
            st, _, raw = client.request(f"http://{vs.url}/debug/pipeline")
            if st != 200 or json.loads(raw).get("tile") != verdict:
                raise AssertionError(f"/debug/pipeline: {st} {raw[:300]!r}")
            until(lambda: master.topo.nodes, "the server never beat")
            st, _, raw = client.request(f"http://{master.url}/cluster/perf")
            tiles_seen = json.loads(raw).get("tiles", {}) if st == 200 \
                else {}
            # one process, one tracker: the master's own snapshot, first
            # in the merge, carries the process-wide sentinel's verdict
            if list(tiles_seen.values()) != [verdict]:
                raise AssertionError(f"/cluster/perf tiles {tiles_seen}")
            node = next(iter(tiles_seen))
            st, _, raw = client.request(f"http://{vs.url}/metrics")
            gauge = [v for _, _, v in parse_exposition(raw.decode()).get(
                "weedtpu_tile_drift", {}).get("samples", [])]
            if st != 200 or gauge != [verdict["drift"]]:
                raise AssertionError(f"weedtpu_tile_drift {gauge}, the "
                                     f"verdict's {verdict['drift']}")
            out = io.StringIO()
            run_command(CommandEnv(master.url), "cluster.perf", out)
            line = next((ln for ln in out.getvalue().splitlines()
                         if ln.strip().startswith(
                             f"tile {node}: {verdict['state']}")),
                        None)
            if line is None:
                raise AssertionError(f"cluster.perf: {out.getvalue()!r}")
            steps["4 sentinel"] = {"ticks": ticks, "verdict": verdict}
            tlog(f"4 sentinel: {len(ticks)} ticks {ticks} on {vs.device} at "
                 f"1 s, stopped; {verdict['state']}: pinned {best} "
                 f"{verdict['pinned_gbps']} GB/s, best "
                 f"{verdict['best_tile']} {verdict['best_gbps']} GB/s, "
                 f"drift {verdict['drift']} (its own table's "
                 f"{drift:.4f}); on /debug/pipeline, /cluster/perf, "
                 f"/metrics and `{line.strip()}`; K1 "
                 f"{counts['4 sentinel']['gf_apply']} "
                 f"({len(tiles) * (1 + TILE_SWEEP_ITERS)} a sweep)")
    finally:
        if sentinel is not None:
            sentinel.stop()
        pipeline.set_sentinel(None)
        if vs is not None:
            vrun(vs.stop())
        if master is not None:
            mrun(master.stop())
        stop_loops(loops)
        client.close()
        if saved_ec_tile is not None:
            os.environ["WEEDTPU_EC_TILE"] = saved_ec_tile
        shutil.rmtree(work, ignore_errors=True)
    # 5 cleared
    if pipeline.sentinel_status() is not None or any(
            t.name == "weedtpu-tile-sentinel" for t in threading.enumerate()):
        raise AssertionError("a tile sentinel outlived the phase")
    out = {"card": card, "steps": steps, "counts": counts,
           "s": time.perf_counter() - t_phase}
    k1 = {k: v["gf_apply"] for k, v in counts.items()}
    tlog(f"5 cleared: no sentinel left; K1 per step {k1}, K2 0; phase wall "
         f"{out['s']:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--volume-mib", type=int, default=1024,
                    help="volume .dat size (default 1 GiB)")
    ap.add_argument("--fleet-worker", action="store_true",
                    help=argparse.SUPPRESS)  # phase 12's child
    ap.add_argument("--small-clients", nargs=2, metavar=("URL", "VID"),
                    help=argparse.SUPPRESS)  # phase 16's child
    ap.add_argument("--codecs-worker", nargs=2, metavar=("DIR", "DAT"),
                    help=argparse.SUPPRESS)  # phase 10's child
    ap.add_argument("--mq-publish", action="store_true",
                    help=argparse.SUPPRESS)  # phase 29's child
    ap.add_argument("--chaos-worker", metavar="DIR",
                    help=argparse.SUPPRESS)  # phase 30's child
    ap.add_argument("--trace-dir", default=None,
                    help="keep phase 13's torch.profiler trace (Chrome "
                         "JSON) in this directory")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    if args.small_clients:
        # the clients need no card: the server they load holds it
        return small_clients(args.small_clients[0],
                             int(args.small_clients[1]), args.seed)
    if args.mq_publish:
        return mq_publishers(args.seed)
    from seaweedfs_tpu_torch import _build
    # 1 build, started before torch's import, which it overlaps
    child = args.fleet_worker or args.codecs_worker or args.chaos_worker
    compiles = {} if child else _build.start()
    import torch
    if not torch.cuda.is_available():
        _build.stop(compiles)
        print("chip_smoke: no CUDA device; the port runs on the card",
              file=sys.stderr)
        return 1
    if args.fleet_worker:
        return fleet_worker()
    if args.chaos_worker:
        return chaos_worker(args.chaos_worker)
    if args.codecs_worker:
        return codecs_worker(*args.codecs_worker, args.seed,
                             args.volume_mib * MIB)
    from seaweedfs_tpu_torch.ops import gf_cuda
    from seaweedfs_tpu_torch.stats.profile import KERNELS
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume, layout

    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    vdir = os.path.join(here, "build", "chip_smoke")
    shutil.rmtree(vdir, ignore_errors=True)
    os.makedirs(vdir)
    # the launch tile's pin lives in the work directory: no pin applies
    # before phase 31 writes one, in this process or its children, and
    # none is read from or written to the home directory
    os.environ["WEEDTPU_TILE_PIN"] = os.path.join(vdir, "tile_pin.json")
    phases: dict = {}
    written: dict = {}

    def write_volume() -> None:
        t0 = time.perf_counter()
        try:
            written["volume"] = build_volume(vdir, args.seed,
                                             args.volume_mib * MIB)
        except BaseException as e:  # raised on the main thread
            written["error"] = e
        written["s"] = time.perf_counter() - t0
    chaos_proc = None
    try:
        # 1 build: the compiles started above.  3 write, host work alone,
        # runs on a thread meanwhile (the needle checksum's library
        # first), joined before phase 2, whose timings want a quiet host
        t0 = time.perf_counter()
        try:
            took = _build.finish({k: compiles.pop(k) for k in ("crc32c",)
                                  if k in compiles})
        except BaseException:
            _build.stop(compiles)
            raise
        writer = threading.Thread(target=write_volume)
        writer.start()
        try:
            took.update(_build.finish(compiles))
        finally:
            t1 = time.perf_counter()
            writer.join()
        log(f"[build] {t1 - t0:.1f} s waited after torch's import ("
            f"{', '.join(f'{k} {v:.1f} s' for k, v in took.items())} "
            f"from the start), then {time.perf_counter() - t1:.1f} s for "
            f"phase 3's volume, written meanwhile")
        for name, tag in (("gf_matmul", ""), ("gf_matmul_tiled", "tiled ")):
            for line in ptxas_report(_build.LOG.get(name, "")):
                log(f"[build] ptxas {tag}{line}")
        if "error" in written:
            raise written["error"]

        # 2 kernel
        rows, kernels, k1_io = phase_kernel(args.seed)

        gf_cuda.reset_launches()
        launches = gf_cuda.LAUNCHES
        # 3 write: the volume the thread above wrote
        dat_path, expect, blob = written["volume"]
        dt = written["s"]
        dat_size = os.path.getsize(dat_path)
        phases["write"] = {"needles": len(expect), "dat_bytes": dat_size,
                           "s": dt}
        log(f"[write] {len(expect)} needles, {dat_size} B in {dt:.2f} s, "
            f"beside the build")
        base = dat_path[: -len(".dat")]
        shard = [base + layout.to_ext(i) for i in range(14)]

        # 4 encode; each run starts with no shard set, as phase 11's do
        for cache in ("cold", "warm"):
            for p in shard:
                if os.path.exists(p):
                    os.remove(p)
            resident = drop_cache([dat_path]) if cache == "cold" \
                else resident_share([dat_path])
            KERNELS.reset()
            st: dict = {}
            before = launches["gf_apply"]
            t0 = time.perf_counter()
            ec_files.write_ec_files(base, stats=st)
            ec_files.write_sorted_ecx(base + ".idx")
            dt = time.perf_counter() - t0
            enc_launches = launches["gf_apply"] - before
            if enc_launches <= 0:
                raise AssertionError("encode did not launch the kernel")
            n_rows = len(stripe_rows(dat_size, layout.LARGE_BLOCK_SIZE,
                                     layout.SMALL_BLOCK_SIZE))
            checked = check_stripes(base, dat_path, layout.LARGE_BLOCK_SIZE,
                                    layout.SMALL_BLOCK_SIZE,
                                    sample_rows(n_rows, 8, args.seed + 1))
            c = KERNELS.snapshot()["encode_parity[device]"]
            phases[f"encode_{cache}"] = {
                "s": dt, "gbps": dat_size / dt / 1e9,
                "launches": enc_launches, "dat_resident": resident,
                "rows_checked": checked, "counters": c,
                "stages_s": {k: v for k, v in st.items()
                             if k.endswith("_s")}}
            log(f"[encode {cache}] .dat {resident:.1%} cached: "
                f"{dat_size / dt / 1e9:.3f} GB/s ({dt:.2f} s), "
                f"{enc_launches} launches, {checked} of {n_rows} stripe "
                f"rows == .dat and plain; read {st.get('read_s', 0):.3f} s "
                f"/ device wait {c['device_s']:.3f} s / d2h "
                f"{c['d2h_s']:.3f} s")
        hashes = sha256_many(shard)
        aux_hashes = {ext: sha256(base + ext) for ext in (".ecx", ".vif")}

        # 5 degraded read
        lost = [0, 3, 10, 12]
        kept = [p for i, p in enumerate(shard) if i not in lost]
        for i in lost:
            os.remove(shard[i])
        ev = ec_volume.EcVolume(base)
        touching = []
        for nid in expect:
            off, size = ev.find_needle(nid)
            ivs = layout.locate_data(ev.large_block, ev.small_block,
                                     ev.dat_size, off,
                                     t.actual_size(size, ev.version))
            if any(iv.to_shard_id_and_offset()[0] in lost for iv in ivs):
                touching.append(nid)
        others = [nid for nid in expect if nid not in set(touching)]
        import numpy as np
        rng = np.random.default_rng(args.seed + 2)
        extra = rng.choice(others, size=min(len(others),
                                            max(0, 200 - len(touching))),
                           replace=False).tolist() if others else []
        reads = touching + extra
        for cache in ("cold", "warm"):
            resident = drop_cache(kept) if cache == "cold" \
                else resident_share(kept)
            before = launches["gf_apply"]
            t0 = time.perf_counter()
            for nid in reads:
                n = ev.read_needle(nid)  # parses with the CRC checked
                cookie, lo, hi = expect[nid]
                if n.cookie != cookie or n.data != blob[lo:hi]:
                    raise AssertionError(
                        f"degraded read of needle {nid} differs")
            dt = time.perf_counter() - t0
            read_launches = launches["gf_apply"] - before
            if read_launches <= 0:
                raise AssertionError("degraded reads did not launch the "
                                     "kernel")
            phases[f"degraded_read_{cache}"] = {
                "reads": len(reads), "touching_lost": len(touching), "s": dt,
                "reads_per_s": len(reads) / dt, "launches": read_launches,
                "shards_resident": resident}
            log(f"[degraded {cache}] shards {resident:.1%} cached: "
                f"{len(reads)} needles ({len(touching)} touching lost data "
                f"shards) equal, {len(reads) / dt:.1f} reads/s, "
                f"{read_launches} launches")
        ev.close()

        # 6 rebuild
        shard_size = os.path.getsize(shard[1])
        for cache in ("cold", "warm"):
            if cache == "warm":
                for i in lost:
                    os.remove(shard[i])
            resident = drop_cache(kept) if cache == "cold" \
                else resident_share(kept)
            before = launches["gf_apply"]
            t0 = time.perf_counter()
            rebuilt = ec_files.rebuild_ec_files(base)
            dt = time.perf_counter() - t0
            if sorted(rebuilt) != lost:
                raise AssertionError(f"rebuilt {rebuilt}, wanted {lost}")
            for i, h in zip(lost, sha256_many([shard[i] for i in lost])):
                if h != hashes[i]:
                    raise AssertionError(f"rebuilt shard {i} differs")
            reb_launches = launches["gf_apply"] - before
            if reb_launches <= 0:
                raise AssertionError("rebuild did not launch the kernel")
            phases[f"rebuild_{cache}"] = {
                "s": dt, "shard_bytes": shard_size,
                "read_gbps": 10 * shard_size / dt / 1e9,
                "rebuilt_gbps": len(lost) * shard_size / dt / 1e9,
                "launches": reb_launches, "shards_resident": resident}
            log(f"[rebuild {cache}] survivors {resident:.1%} cached: 4 "
                f"shards of {shard_size} B sha256-equal in {dt:.2f} s: "
                f"{10 * shard_size / dt / 1e9:.3f} GB/s survivors read, "
                f"{reb_launches} launches")

        # 7 fleet
        phases["fleet"], srcs = phase_fleet(vdir, dat_path, hashes,
                                            args.seed, launches)

        # 8 scrub
        phases["scrub"] = phase_scrub(base, launches)

        # 9 repair
        phases["repair"] = phase_repair(vdir, base, hashes, launches)

        rs_launches = dict(launches)
        staged = dict(gf_cuda.STAGED)
        if any(staged.values()):
            raise AssertionError(f"a path made the kernel wrapper stage "
                                 f"copies of its input: {staged}")
        if not rs_launches["gf_apply_batch"]:
            raise AssertionError("no path launched K2 (gf_apply_batch)")
        log(f"[path] phases 3-9: launches {rs_launches}, staged copies "
            f"{staged}")

        path_launches = dict(rs_launches)

        # 11 native, on the card's host; launches none of the kernels
        phases["native"] = phase_native(
            vdir, dat_path, hashes, expect, blob, reads, k1_io,
            {"encode_gbps": phases["encode_warm"]["gbps"],
             "rebuild_gbps": phases["rebuild_warm"]["read_gbps"]},
            args.seed, launches)

        # 12 writer engine, counted on its own (its children too)
        gf_cuda.reset_launches()
        phases["writer"] = phase_writer(vdir, dat_path, hashes, srcs,
                                        launches)
        path_launches = {k: path_launches[k] + phases["writer"]["launches"][k]
                         for k in path_launches}

        # phases 10 and 16 read the phase-3 volume as phase 4 encoded
        # it: a copy, taken before phase 14 appends through links of it
        server_src = os.path.join(vdir, "server_src", os.path.basename(base))
        os.makedirs(os.path.dirname(server_src))
        for ext in (".dat", ".idx"):
            shutil.copyfile(base + ext, server_src + ext)
        dat_hash = sha256(server_src + ".dat")

        # 10 codecs, in a child process (its own launch counts), which
        # starts up now and, once phase 13 is done, runs beside the
        # records and phases 14 and 15: they share no file and no count
        codecs_proc = start_worker(vdir, "codecs_worker", [
            "--codecs-worker", vdir, server_src + ".dat", "--seed",
            str(args.seed), "--volume-mib", str(args.volume_mib)])
        try:
            # 13 telemetry, counted on its own
            gf_cuda.reset_launches()
            phases["telemetry"] = phase_telemetry(
                vdir, dat_path, hashes, reads, expect, blob, srcs, rows,
                launches,
                args.trace_dir and os.path.abspath(args.trace_dir))
            tel_launches = dict(launches)
            staged = dict(gf_cuda.STAGED)
            if any(staged.values()):
                raise AssertionError(f"the telemetry phase made the kernel "
                                     f"wrapper stage copies of its input: "
                                     f"{staged}")
            if not all(tel_launches.values()):
                raise AssertionError(f"the telemetry phase launched "
                                     f"{tel_launches}: K1 and K2 both "
                                     f"expected")
            phases["telemetry"]["launches"] = tel_launches
            log(f"[path] phase 13: launches {tel_launches}, staged copies "
                f"{staged}")
            path_launches = {k: path_launches[k] + tel_launches[k]
                             for k in path_launches}

            go_worker(codecs_proc)
            # records, outside the counted window
            phases["fleet_record"] = fleet_record(vdir, srcs)
            phases["rebuild_record"] = rebuild_record(vdir, base, hashes)

            # 14 store, counted on its own; its appends and deletes go
            # through hard links of the phase-3 volume
            gf_cuda.reset_launches()
            phases["store"] = phase_store(vdir, dat_path, expect, blob,
                                          args.seed, launches)
            store_launches = dict(launches)
            staged = dict(gf_cuda.STAGED)
            if any(staged.values()):
                raise AssertionError(f"the store phase made the kernel "
                                     f"wrapper stage copies of its input: "
                                     f"{staged}")
            log(f"[path] phase 14: launches {store_launches}, staged "
                f"copies {staged}")
            path_launches = {k: path_launches[k] + store_launches[k]
                             for k in path_launches}

            # 15 remote reads, counted on its own; after phase 14, on
            # nodes linking phase 4's shard set
            gf_cuda.reset_launches()
            phases["remote"] = phase_remote(vdir, base, expect, blob,
                                            args.seed, launches)
            remote_launches = dict(launches)
            staged = dict(gf_cuda.STAGED)
            if any(staged.values()):
                raise AssertionError(f"the remote phase made the kernel "
                                     f"wrapper stage copies of its input: "
                                     f"{staged}")
            log(f"[path] phase 15: launches {remote_launches}, staged "
                f"copies {staged}")
            path_launches = {k: path_launches[k] + remote_launches[k]
                             for k in path_launches}

            phases["codecs"], codec_launches, staged, waited = \
                join_worker(codecs_proc, "codecs", 10)
        finally:
            stop_worker(codecs_proc)
        if any(staged.values()):
            raise AssertionError(f"the codecs phase made the kernel wrapper "
                                 f"stage copies of its input: {staged}")
        phases["codecs"]["child_wait_s"] = waited
        log(f"[path] phase 10: launches {codec_launches}, staged copies "
            f"{staged}; its child ran beside the records and phases 14 "
            f"and 15, {time.perf_counter() - codecs_proc.t_go:.1f} s from "
            f"the start signal, {waited:.1f} s of them waited at the join")
        path_launches = {k: path_launches[k] + codec_launches[k]
                         for k in path_launches}

        # 16 volume server, counted on its own
        gf_cuda.reset_launches()
        phases["server"] = phase_server(
            vdir, server_src, expect, blob, hashes, aux_hashes, dat_hash,
            phases["encode_warm"]["launches"],
            phases["rebuild_warm"]["launches"], args.seed, launches)
        server_launches = dict(launches)
        staged = dict(gf_cuda.STAGED)
        if any(staged.values()):
            raise AssertionError(f"the server phase made the kernel wrapper "
                                 f"stage copies of its input: {staged}")
        log(f"[path] phase 16: launches {server_launches}, staged copies "
            f"{staged}")
        path_launches = {k: path_launches[k] + server_launches[k]
                         for k in path_launches}

        # 17 maintenance through the server, counted on its own
        gf_cuda.reset_launches()
        phases["maintenance"] = phase_maintenance(
            vdir, base, server_src, expect, blob, hashes, aux_hashes,
            phases, srcs, args.seed, launches)
        maint_launches = dict(launches)
        staged = dict(gf_cuda.STAGED)
        if any(staged.values()):
            raise AssertionError(f"the maintenance phase made the kernel "
                                 f"wrapper stage copies of its input: "
                                 f"{staged}")
        if not all(maint_launches.values()):
            raise AssertionError(f"the maintenance phase launched "
                                 f"{maint_launches}: K1 and K2 both "
                                 f"expected")
        log(f"[path] phase 17: launches {maint_launches}, staged copies "
            f"{staged}")
        path_launches = {k: path_launches[k] + maint_launches[k]
                         for k in path_launches}

        # 18 volume admin through the server, counted on its own
        gf_cuda.reset_launches()
        phases["admin"] = phase_admin(
            vdir, base, server_src, expect, blob, dat_hash, phases, srcs,
            args.seed, launches)
        admin_launches = dict(launches)
        staged = dict(gf_cuda.STAGED)
        if any(staged.values()):
            raise AssertionError(f"the admin phase made the kernel wrapper "
                                 f"stage copies of its input: {staged}")
        if not all(admin_launches.values()):
            raise AssertionError(f"the admin phase launched "
                                 f"{admin_launches}: K1 and K2 both "
                                 f"expected")
        log(f"[path] phase 18: launches {admin_launches}, staged copies "
            f"{staged}")
        path_launches = {k: path_launches[k] + admin_launches[k]
                         for k in path_launches}

        # 19 the mesh, counted on its own
        gf_cuda.reset_launches()
        phases["mesh"] = phase_mesh(vdir, server_src, hashes, aux_hashes,
                                    phases, srcs, launches)
        mesh_launches = dict(launches)
        staged = dict(gf_cuda.STAGED)
        if any(staged.values()):
            raise AssertionError(f"the mesh phase made the kernel wrapper "
                                 f"stage copies of its input: {staged}")
        if not all(mesh_launches.values()):
            raise AssertionError(f"the mesh phase launched "
                                 f"{mesh_launches}: K1 and K2 both "
                                 f"expected")
        log(f"[path] phase 19: launches {mesh_launches}, staged copies "
            f"{staged}")
        path_launches = {k: path_launches[k] + mesh_launches[k]
                         for k in path_launches}

        # 20 the master with raft and a failover, counted on its own
        gf_cuda.reset_launches()
        phases["master"] = phase_master(vdir, base, expect, blob, args.seed,
                                        launches)
        master_launches = dict(launches)
        staged = dict(gf_cuda.STAGED)
        if any(staged.values()):
            raise AssertionError(f"the master phase made the kernel wrapper "
                                 f"stage copies of its input: {staged}")
        log(f"[path] phase 20: launches {master_launches}, staged copies "
            f"{staged}")
        path_launches = {k: path_launches[k] + master_launches[k]
                         for k in path_launches}

        # 21 the master's planes over two card servers, counted on its own
        gf_cuda.reset_launches()
        phases["planes"] = phase_planes(vdir, base, expect, blob, args.seed,
                                        launches)
        planes_launches = dict(launches)
        staged = dict(gf_cuda.STAGED)
        if any(staged.values()):
            raise AssertionError(f"the planes phase made the kernel wrapper "
                                 f"stage copies of its input: {staged}")
        log(f"[path] phase 21: launches {planes_launches}, staged copies "
            f"{staged}")
        path_launches = {k: path_launches[k] + planes_launches[k]
                         for k in path_launches}

        # 22 the master's maintenance plane healing, converting and
        # tiering on four card servers, counted on its own
        gf_cuda.reset_launches()
        phases["heal"] = phase_heal(
            vdir, base, server_src, expect, blob, hashes, aux_hashes,
            dat_hash, phases, srcs, args.seed, launches)
        heal_launches = dict(launches)
        staged = dict(gf_cuda.STAGED)
        if any(staged.values()):
            raise AssertionError(f"the heal phase made the kernel wrapper "
                                 f"stage copies of its input: {staged}")
        if not all(heal_launches.values()):
            raise AssertionError(f"the heal phase launched {heal_launches}"
                                 f": K1 and K2 both expected")
        log(f"[path] phase 22: launches {heal_launches}, staged copies "
            f"{staged}")
        path_launches = {k: path_launches[k] + heal_launches[k]
                         for k in path_launches}

        # 30 the chaos harness in a child: started here, after the
        # phases that time the master's planes, to import and make its
        # card context meanwhile; told to go at phase 27
        chaos_proc = start_worker(vdir, "chaos_worker",
                                  ["--chaos-worker", vdir])

        # 23 the port's shell and client over three card servers in
        # three racks, then 24 the port's filer, 25 its filer server, 26
        # its S3 gateway, 27 its WebDAV gateway, mount and offline tools,
        # 28 its replication and 29 its message queue on the same
        # cluster, each counted on its own
        with ThreeRacks(vdir) as racks:
            gf_cuda.reset_launches()
            phases["shell"] = phase_shell(
                racks, server_src, expect, blob, hashes, aux_hashes,
                phases["encode_warm"]["launches"],
                phases["rebuild_warm"]["launches"], args.seed, launches)
            shell_launches = dict(launches)
            staged = dict(gf_cuda.STAGED)
            if any(staged.values()):
                raise AssertionError(f"the shell phase made the kernel "
                                     f"wrapper stage copies of its input: "
                                     f"{staged}")
            if not shell_launches["gf_apply"] or \
                    shell_launches["gf_apply_batch"]:
                raise AssertionError(f"the shell phase launched "
                                     f"{shell_launches}: K1 and no K2 "
                                     f"expected")
            log(f"[path] phase 23: launches {shell_launches}, staged "
                f"copies {staged}")
            path_launches = {k: path_launches[k] + shell_launches[k]
                             for k in path_launches}

            gf_cuda.reset_launches()
            phases["filer"] = phase_filer(racks, vdir, args.seed, launches)
            filer_launches = dict(launches)
            staged = dict(gf_cuda.STAGED)
            if any(staged.values()):
                raise AssertionError(f"the filer phase made the kernel "
                                     f"wrapper stage copies of its input: "
                                     f"{staged}")
            if not filer_launches["gf_apply"] or \
                    filer_launches["gf_apply_batch"]:
                raise AssertionError(f"the filer phase launched "
                                     f"{filer_launches}: K1 and no K2 "
                                     f"expected")
            log(f"[path] phase 24: launches {filer_launches}, staged "
                f"copies {staged}")
            path_launches = {k: path_launches[k] + filer_launches[k]
                             for k in path_launches}

            gf_cuda.reset_launches()
            phases["filer_server"] = phase_filer_server(
                racks, vdir, args.seed, launches)
            fs_launches = dict(launches)
            staged = dict(gf_cuda.STAGED)
            if any(staged.values()):
                raise AssertionError(f"the filer server phase made the "
                                     f"kernel wrapper stage copies of its "
                                     f"input: {staged}")
            if not fs_launches["gf_apply"] or \
                    fs_launches["gf_apply_batch"]:
                raise AssertionError(f"the filer server phase launched "
                                     f"{fs_launches}: K1 and no K2 "
                                     f"expected")
            log(f"[path] phase 25: launches {fs_launches}, staged "
                f"copies {staged}")
            path_launches = {k: path_launches[k] + fs_launches[k]
                             for k in path_launches}

            gf_cuda.reset_launches()
            phases["s3"] = phase_s3(racks, vdir, args.seed, launches)
            s3_launches = dict(launches)
            staged = dict(gf_cuda.STAGED)
            if any(staged.values()):
                raise AssertionError(f"the s3 phase made the kernel "
                                     f"wrapper stage copies of its input: "
                                     f"{staged}")
            if not s3_launches["gf_apply"] or \
                    s3_launches["gf_apply_batch"]:
                raise AssertionError(f"the s3 phase launched "
                                     f"{s3_launches}: K1 and no K2 "
                                     f"expected")
            log(f"[path] phase 26: launches {s3_launches}, staged "
                f"copies {staged}")
            path_launches = {k: path_launches[k] + s3_launches[k]
                             for k in path_launches}

            gf_cuda.reset_launches()
            go_worker(chaos_proc)
            phases["webdav"] = phase_webdav(racks, vdir, args.seed, launches)
            dav_launches = dict(launches)
            staged = dict(gf_cuda.STAGED)
            if any(staged.values()):
                raise AssertionError(f"the webdav phase made the kernel "
                                     f"wrapper stage copies of its input: "
                                     f"{staged}")
            if not dav_launches["gf_apply"] or \
                    dav_launches["gf_apply_batch"]:
                raise AssertionError(f"the webdav phase launched "
                                     f"{dav_launches}: K1 and no K2 "
                                     f"expected")
            log(f"[path] phase 27: launches {dav_launches}, staged "
                f"copies {staged}")
            path_launches = {k: path_launches[k] + dav_launches[k]
                             for k in path_launches}

            gf_cuda.reset_launches()
            phases["replication"] = phase_replication(racks, vdir, args.seed,
                                                      launches)
            repl_launches = dict(launches)
            staged = dict(gf_cuda.STAGED)
            if any(staged.values()):
                raise AssertionError(f"the replication phase made the "
                                     f"kernel wrapper stage copies of its "
                                     f"input: {staged}")
            if not repl_launches["gf_apply"] or \
                    repl_launches["gf_apply_batch"]:
                raise AssertionError(f"the replication phase launched "
                                     f"{repl_launches}: K1 and no K2 "
                                     f"expected")
            log(f"[path] phase 28: launches {repl_launches}, staged "
                f"copies {staged}")
            path_launches = {k: path_launches[k] + repl_launches[k]
                             for k in path_launches}

            gf_cuda.reset_launches()
            phases["mq"] = phase_mq(racks, vdir, args.seed, launches)
            mq_launches = dict(launches)
            staged = dict(gf_cuda.STAGED)
            if any(staged.values()):
                raise AssertionError(f"the mq phase made the kernel "
                                     f"wrapper stage copies of its input: "
                                     f"{staged}")
            if not mq_launches["gf_apply"] or \
                    mq_launches["gf_apply_batch"]:
                raise AssertionError(f"the mq phase launched "
                                     f"{mq_launches}: K1 and no K2 "
                                     f"expected")
            log(f"[path] phase 29: launches {mq_launches}, staged "
                f"copies {staged}")
            path_launches = {k: path_launches[k] + mq_launches[k]
                             for k in path_launches}

        # 30 the chaos harness's cells and the fleet simulator, on
        # clusters of their own, in the child beside phases 27-29
        phases["chaos"], chaos_launches, staged, waited = \
            join_worker(chaos_proc, "chaos", 30)
        phases["chaos"]["child_wait_s"] = waited
        if any(staged.values()):
            raise AssertionError(f"the chaos phase made the kernel "
                                 f"wrapper stage copies of its input: "
                                 f"{staged}")
        if not all(chaos_launches.values()):
            raise AssertionError(f"the chaos phase launched "
                                 f"{chaos_launches}: K1 and K2 both "
                                 f"expected")
        log(f"[path] phase 30: launches {chaos_launches}, staged copies "
            f"{staged}; its child ran beside phases 27-29, "
            f"{time.perf_counter() - chaos_proc.t_go:.1f} s from the "
            f"start signal, {waited:.1f} s of them waited at the join")
        path_launches = {k: path_launches[k] + chaos_launches[k]
                         for k in path_launches}

        # 31 the launch tile: its sweep, its pin and the sentinel, after
        # every other phase (the sentinel's ticks launch K1 at times no
        # other phase predicts), counted on its own
        gf_cuda.reset_launches()
        phases["tile"] = phase_tile(vdir, server_src, dat_hash, hashes,
                                    phases["encode_warm"]["launches"],
                                    launches)
        tile_launches = dict(launches)
        staged = dict(gf_cuda.STAGED)
        if any(staged.values()):
            raise AssertionError(f"the tile phase made the kernel wrapper "
                                 f"stage copies of its input: {staged}")
        if not tile_launches["gf_apply"] or tile_launches["gf_apply_batch"]:
            raise AssertionError(f"the tile phase launched {tile_launches}: "
                                 f"K1 and no K2 expected")
        log(f"[path] phase 31: launches {tile_launches}, staged copies "
            f"{staged}")
        path_launches = {k: path_launches[k] + tile_launches[k]
                         for k in path_launches}
    finally:
        if chaos_proc is not None:
            stop_worker(chaos_proc)
        shutil.rmtree(vdir, ignore_errors=True)

    # 32 report
    for entry in kernels:
        entry["launches"] = path_launches[entry["name"]]
    log(json.dumps({"phases": phases, "kernel_cases": rows}))
    log(f"[total] {time.perf_counter() - t_start:.1f} s wall")
    print(json.dumps({"kernels": kernels}))
    print(card_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
