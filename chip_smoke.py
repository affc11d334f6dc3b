#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: build the kernels, hold
each against its plain PyTorch version, then drive the EC data plane end
to end and check every byte.

    python3 chip_smoke.py [--seed N] [--volume-mib MIB]

Phases (any failure ends the run with a non-zero exit and no result line):

  1 build      nvcc/g++ build of seaweedfs_tpu_torch/csrc, all at once
  2 kernel     the GF(2^8) kernel against gf_apply_plain, byte for byte:
               timed at the main path's shapes (encode, rebuild, degraded
               reads, the unit batch) with CUDA events beside its byte
               bound and the plain version's time;
               untimed at m = 1..16, k = 1/17/32, ragged n, strided and
               unaligned views, and the codec on a contiguous [10, 700]
  3 write      a volume of needles (sizes uniform in 4 KB..1 MB, data from
               --seed) through Volume.append_needle
  4 encode     write_ec_files + write_sorted_ecx; parity of sampled stripe
               units recomputed with the plain version and compared with
               the shard files
  5 degraded   .ec00/.ec03/.ec10/.ec12 deleted; every needle touching a
               lost data shard (and more, >= 200) read through
               EcVolume.read_needle, CRC checked, bytes compared
  6 rebuild    rebuild_ec_files; rebuilt shards' sha256 == the originals'
  7 report     {"kernels": [...]} line, the card's name and power limit,
               and the result line

Phases 4-6 each run twice: first "cold", with the files they read synced
and dropped from the page cache (posix_fadvise DONTNEED; mincore reports
the share still resident), then "warm", right after, with those files
cached.  Launch counts are zeroed just before phase 3 and read just after
phase 6, so the reported launches are the main path's own (both passes);
the run fails if that path made the kernel wrapper stage a copy of any
input (`gf_cuda.STAGED`), since it hands the kernel rows it reads in
place.  Needs one CUDA card;
exits non-zero without one, and outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
MIB = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


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
    from seaweedfs_tpu_torch.ops import gf_cuda

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
        ("batch [8,10,1MiB]", parity, (8, 10, MIB), True, True),
        ("decode [1,10]@[10,4KiB]", decode([0]), (10, 4096), False, True),
        ("decode [1,10]@[10,512KiB]", decode([0]), (10, MIB // 2), False,
         True),
        ("decode [2,10]@[10,512KiB]", decode([0, 3]), (10, MIB // 2), False,
         True),
        # one block, 16 bytes: the launch and memory-latency floor
        ("floor [1,1]@[1,16]", rand(1, 1), (1, 16), False, True),
    ]
    cases += [(f"parity n={n}", parity, (10, n), False, False)
              for n in (1, 15, 17, 255, 4097)]
    cases += [(f"random [{m},10] n=4097", rand(m, 10), (10, 4097), False,
               False) for m in range(1, 17)]
    cases += [(f"random [4,{k}] n={n}", rand(4, k), (k, n), False, False)
              for k in (1, 17, 32) for n in (1, 15, 17, 4097)]
    return cases


def phase_kernel(seed: int) -> tuple[list[dict], list[dict]]:
    """Kernel vs plain at the main path's shapes and the correctness cases;
    returns (rows, json)."""
    import torch
    from seaweedfs_tpu_torch.ops import gf_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(128 * MIB, dtype=torch.uint8, device="cuda")
    rows = []

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
        err = check(name, kern(), plain())
        units = shape[0] if batched else 1
        nbytes = units * (mat.k + mat.m) * n
        row = {"case": name, "max_abs_err": err, "bytes": nbytes,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        if timed:
            row["ms"] = gpu_ms(kern, flush)
            row["plain_ms"] = gpu_ms(plain, flush, runs=20, warmup=1)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            log(f"[kernel] {name}: equal, {row['ms']:.5f} ms "
                f"({row['share_of_bound']:.1%} of the {row['bound_ms']:.5f} "
                f"ms byte bound), plain {row['plain_ms']:.4f} ms")
        rows.append(row)
        del x
    log(f"[kernel] {sum('ms' not in r for r in rows)} correctness cases "
        "equal (m 1..16, k 1/17/32, ragged n)")
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
              "batch [8,10,1MiB]"),
    ]
    return rows, kernels


def views_and_codec(seed: int) -> list[dict]:
    """Inputs the kernel cannot all read in place, against the plain
    version: a [:, :n] view of a wider buffer, a view off the 16-byte grid,
    and the codec's encode / reconstruct on a contiguous [10, 700]."""
    import torch
    from seaweedfs_tpu_torch.models import rs
    from seaweedfs_tpu_torch.ops import gf_cuda

    code = rs.get_code(10, 4)
    mat = gf_cuda.CudaGFMatrix(code.parity_matrix)
    bit = mat.bitmat.cuda()
    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    wide = torch.randint(0, 256, (10, 8192), dtype=torch.uint8,
                         device="cuda", generator=g)
    rows = []
    for name, x in (("strided [:, :3000] of [10,8192]", wide[:, :3000]),
                    ("unaligned [:, 1:3001] of [10,8192]", wide[:, 1:3001])):
        got, want = mat(x), gf_cuda.gf_apply_plain(bit, x)
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
    log("[kernel] strided view, unaligned view and the codec at contiguous "
        "[10,700]: equal to plain")
    return rows


def ptxas_report(log_text: str) -> list[str]:
    """ptxas registers, spills and shared memory of the instantiations
    RS(10,4) runs: k = 10 with m = 1, 2, 4."""
    out = []
    entries = log_text.split("Compiling entry function")
    for label, needle in (("M=1,K=10", "gf_apply_kernelILi1ELi10E"),
                          ("M=2,K=10", "gf_apply_kernelILi2ELi10E"),
                          ("M=4,K=10", "gf_apply_kernelILi4ELi10E")):
        for e in entries:
            if needle in e.split("\n", 1)[0]:
                facts = [ln.split(":", 1)[-1].strip() for ln in e.splitlines()
                         if "spill" in ln or "Used" in ln]
                out.append(f"{label}: {'; '.join(facts)}")
    return out


def build_volume(vdir: str, seed: int, target: int):
    """Phase 3: needles of uniform 4 KB..1 MB until the .dat reaches
    `target` bytes.  Returns (dat_path, {id: (cookie, lo, hi)}, blob)."""
    import numpy as np
    from seaweedfs_tpu_torch.storage import needle as ndl
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.volume import Volume

    rng = np.random.default_rng(seed)
    sizes = []
    total = 8  # super block
    while total < target:
        s = int(rng.integers(4096, MIB + 1))
        sizes.append(s)
        total += t.actual_size(s + 5)  # DataSize(4) + data + flags(1)
    blob = rng.bytes(sum(sizes))
    cookies = rng.integers(0, 1 << 32, len(sizes)).tolist()
    v = Volume(vdir, "", 1)
    expect = {}
    lo = 0
    for i, s in enumerate(sizes):
        nid = i + 1
        v.append_needle(ndl.Needle(cookie=cookies[i], id=nid,
                                   data=blob[lo:lo + s],
                                   append_at_ns=1_700_000_000_000_000_000 + i))
        expect[nid] = (cookies[i], lo, lo + s)
        lo += s
    v.flush()
    v.close()
    return v.dat_path, expect, blob


def check_parity(base: str, dat_path: str, dat_size: int, seed: int) -> int:
    """Phase 4 check: recompute the parity of sampled stripe units with the
    plain version on the card and compare with the parity shard files."""
    import numpy as np
    import torch
    from seaweedfs_tpu_torch.models import rs
    from seaweedfs_tpu_torch.ops import gf, gf_cuda
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout

    units = list(ec_files._iter_units(dat_size, layout.LARGE_BLOCK_SIZE,
                                      layout.SMALL_BLOCK_SIZE,
                                      ec_files.DEFAULT_BATCH))
    rng = np.random.default_rng(seed + 1)
    pick = sorted(set(rng.choice(len(units), size=min(8, len(units)),
                                 replace=False).tolist()) | {len(units) - 1})
    bit = torch.from_numpy(gf.gf_matrix_to_bitmatrix(
        rs.get_code(10, 4).parity_matrix)).float().cuda()
    with open(dat_path, "rb") as f:
        dat = f.read()
    for u in pick:
        row_start, block, col, step, shard_off = units[u]
        data = np.zeros((10, step), dtype=np.uint8)
        for j in range(10):
            off = row_start + j * block + col
            n = max(0, min(step, dat_size - off))
            data[j, :n] = np.frombuffer(dat, np.uint8, n, off) if n else 0
        want = gf_cuda.gf_apply_plain(bit, torch.from_numpy(data).cuda()).cpu()
        for i in range(4):
            with open(base + layout.to_ext(10 + i), "rb") as f:
                f.seek(shard_off)
                got = np.frombuffer(f.read(step), np.uint8)
            if not np.array_equal(got, want[i].numpy()):
                raise AssertionError(f"parity shard {10 + i} differs at "
                                     f"unit {u} (offset {shard_off})")
    return len(pick)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--volume-mib", type=int, default=1024,
                    help="volume .dat size (default 1 GiB)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from seaweedfs_tpu_torch import _build
    from seaweedfs_tpu_torch.ops import dispatch
    from seaweedfs_tpu_torch.ops import gf_cuda
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume, layout

    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 1 build
    t0 = time.perf_counter()
    took = _build.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")
    for line in ptxas_report(_build.LOG.get("gf_matmul", "")):
        log(f"[build] ptxas {line}")

    # 2 kernel
    rows, kernels = phase_kernel(args.seed)

    vdir = os.path.join(here, "build", "chip_smoke")
    shutil.rmtree(vdir, ignore_errors=True)
    os.makedirs(vdir)
    phases: dict = {}
    try:
        gf_cuda.reset_launches()
        launches = gf_cuda.LAUNCHES
        # 3 write
        t0 = time.perf_counter()
        dat_path, expect, blob = build_volume(
            vdir, args.seed, args.volume_mib * MIB)
        dt = time.perf_counter() - t0
        dat_size = os.path.getsize(dat_path)
        phases["write"] = {"needles": len(expect), "dat_bytes": dat_size,
                           "s": dt}
        log(f"[write] {len(expect)} needles, {dat_size} B in {dt:.2f} s")
        base = dat_path[: -len(".dat")]
        shard = [base + layout.to_ext(i) for i in range(14)]

        # 4 encode
        for cache in ("cold", "warm"):
            resident = drop_cache([dat_path]) if cache == "cold" \
                else resident_share([dat_path])
            dispatch.COUNTERS.reset()
            st: dict = {}
            before = launches["gf_apply"]
            t0 = time.perf_counter()
            ec_files.write_ec_files(base, stats=st)
            ec_files.write_sorted_ecx(base + ".idx")
            dt = time.perf_counter() - t0
            enc_launches = launches["gf_apply"] - before
            if enc_launches <= 0:
                raise AssertionError("encode did not launch the kernel")
            checked = check_parity(base, dat_path, dat_size, args.seed)
            c = dispatch.COUNTERS.snapshot()
            phases[f"encode_{cache}"] = {
                "s": dt, "gbps": dat_size / dt / 1e9,
                "launches": enc_launches, "dat_resident": resident,
                "units_checked": checked, "counters": c,
                "stages_s": {k: v for k, v in st.items()
                             if k.endswith("_s")}}
            log(f"[encode {cache}] .dat {resident:.1%} cached: "
                f"{dat_size / dt / 1e9:.3f} GB/s ({dt:.2f} s), "
                f"{enc_launches} launches, parity of {checked} units == "
                f"plain; read {st.get('read_s', 0):.3f} s / h2d "
                f"{c['h2d_s']:.3f} s / device {c['device_s']:.3f} s / d2h "
                f"{c['d2h_s']:.3f} s")

        # 5 degraded read
        lost = [0, 3, 10, 12]
        kept = [p for i, p in enumerate(shard) if i not in lost]
        orig = {i: sha256(shard[i]) for i in lost}
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
            for i in lost:
                if sha256(shard[i]) != orig[i]:
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
        main_launches = dict(launches)
        staged = dict(gf_cuda.STAGED)
        if any(staged.values()):
            raise AssertionError(f"the main path made the kernel wrapper "
                                 f"stage copies of its input: {staged}")
        log(f"[path] launches {main_launches}, staged copies {staged}")
    finally:
        shutil.rmtree(vdir, ignore_errors=True)

    # 7 report
    for entry in kernels:
        entry["launches"] = main_launches[entry["name"]]
    log(json.dumps({"phases": phases, "kernel_cases": rows}))
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
