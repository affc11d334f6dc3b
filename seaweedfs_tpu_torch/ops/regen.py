"""Reduced-read shard repair: partial-sum decode plans over helper groups.

Counterpart of `seaweedfs_tpu/ops/regen.py`.  A naive single-shard
rebuild copies k full survivor shards to the repairing node.  The code
is linear, so

    lost_row = sum_GF( M[0, i] * survivor_i )        (GF(2^8) sum == XOR)

distributes over any partition of the survivors: each helper NODE applies
its slice of the decode matrix to the shards it holds (one GF(2^8) matrix
apply, `dispatch.apply_matrix`, kernel K1 on the card) and ships a single
[f, range] partial, and the repairing node XORs the partials.  Network
cost per remote node drops from (shards_held x range) to (f x range), and
the output is byte-identical to the naive decode, because exact repair of
a shard yields the same bytes from ANY decodable survivor set.

With d > k helper shards available, the byte range is striped into
segments with a rotating k-of-d survivor window, so each remote helper
reads only sub-shard ranges (~k/d of its shards) while per-node
aggregation keeps the shipped bytes at one range.  Local shards (locality
class 0) are free and always participate.

Per family:
- RS: the windows above (`plan_repair`).
- LRC: `plan_repair` steers a single loss into the lost shard's local
  group when the code's `repair_support` finds one (r survivors, not k),
  and takes the decode matrix's columns from the code's `decode_select`
  basis, dropping window shards outside it.  The windows take no account
  of LRC not being MDS: a window the code cannot decode raises the
  code's ValueError, as the reference does (ROADMAP fault 3.5).
- MSR: `plan_msr_repair`, the regenerating-code plan in sub-row
  coordinates: each of d helpers ships one combined sub-row per held
  shard, and the repairing node expands every payload through a `post`
  matrix into the alpha sub-rows of the lost shard.

Multi-shard loss is repaired as a sequence of single-shard plans
(`storage/ec/ec_files.rebuild_ec_reduced`: each rebuilt shard joins the
local survivors for the next pass).  A ValueError from a planner sends
the caller to the naive copy+rebuild path.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass, field

import numpy as np

from seaweedfs_tpu_torch.ops import dispatch
from seaweedfs_tpu_torch.topology.topology import locality_name

# segment alignment for sub-shard striping: segments smaller than this
# cost more per-fetch orchestration than the read spread saves
DEFAULT_SEG_ALIGN = 4 * 1024 * 1024


class HelperDied(IOError):
    """A helper stopped answering mid-repair; the plan must be rebuilt
    with a substitute survivor set excluding it."""

    def __init__(self, node: str, shards: tuple[int, ...] = ()):
        super().__init__(f"helper {node or '<local>'} died"
                         + (f" (shards {list(shards)})" if shards else ""))
        self.node = node
        self.shards = tuple(shards)


@dataclass(frozen=True)
class HelperGroup:
    """Survivor shards co-located on one node.  node == "" is the
    repairing node itself (locality 0): its reads are local preads, never
    network."""
    node: str
    shards: tuple[int, ...]
    locality: int = 3

    def replace_shards(self, shards) -> "HelperGroup":
        return HelperGroup(self.node, tuple(sorted(shards)), self.locality)


@dataclass(frozen=True)
class Part:
    """One group's contribution to one segment: coeff [f, len(shards)]
    over the group's shard rows, in `shards` order.  `post`, when set, is
    a matrix the repairing node applies to the group's [f, n] partial
    before the XOR: an MSR helper's payload expands through its columns
    of R into all alpha output sub-rows."""
    group: HelperGroup
    shards: tuple[int, ...]
    coeff: np.ndarray
    post: np.ndarray | None = None


@dataclass(frozen=True)
class Segment:
    offset: int
    size: int
    parts: tuple[Part, ...]


@dataclass
class RepairPlan:
    lost: int
    k: int
    d: int
    length: int
    segments: list[Segment] = field(default_factory=list)
    # output rows per offset: 1 for RS and LRC plans, alpha for MSR
    # plans, whose offsets and lengths are in SUB-ROW coordinates (file
    # bytes / alpha)
    out_rows: int = 1

    def predicted_bytes(self) -> dict:
        """Exact repair bandwidth this plan will move, per node and per
        locality class, plus what each remote node reads.  The accounting
        contract: executing the plan fetches EXACTLY per_node[n] payload
        bytes from each remote node n."""
        per_node: dict[str, int] = {}
        by_loc: dict[str, int] = {}
        reads: dict[str, int] = {}
        local = 0
        for seg in self.segments:
            for part in seg.parts:
                n = part.coeff.shape[0] * seg.size
                if part.group.locality == 0:
                    local += n
                    continue
                per_node[part.group.node] = \
                    per_node.get(part.group.node, 0) + n
                name = locality_name(part.group.locality)
                by_loc[name] = by_loc.get(name, 0) + n
                reads[part.group.node] = reads.get(part.group.node, 0) + \
                    len(part.shards) * seg.size
        return {"per_node": per_node, "by_locality": by_loc,
                "remote": sum(per_node.values()), "local": local,
                "helper_reads": reads}

    def naive_remote_bytes(self, n_local: int) -> int:
        """Bytes the copy-survivors-then-rebuild baseline would move for
        this loss: (k - local survivors) full shard ranges.  Sub-row plans
        scale back up by out_rows: the baseline copies whole shard files."""
        return max(0, self.k - n_local) * self.length * self.out_rows


def _order_survivors(groups: list[HelperGroup], exclude: set[int]
                     ) -> list[tuple[HelperGroup, int]]:
    """(group, shard) pairs ordered local-first then by ascending
    locality class, node, shard: the planner's survivor preference."""
    out: list[tuple[HelperGroup, int]] = []
    for g in sorted(groups, key=lambda g: (g.locality, g.node)):
        for sid in sorted(set(g.shards)):
            if sid not in exclude:
                out.append((g, sid))
    return out


def plan_repair(code, lost: int, groups: list[HelperGroup], length: int,
                d: int | None = None,
                align: int = DEFAULT_SEG_ALIGN) -> RepairPlan:
    """Build the reduced-read plan for ONE lost shard over [0, length).

    `d` caps how many helper shards participate (None = all survivors;
    clamped to [k, available]).  With d > k the range stripes into
    rotating k-of-d windows; local shards are in every window.

    Codes exposing `repair_support(lost, available)` (LRC) steer the plan
    into the lost shard's local group when it suffices: the window becomes
    the support set (r survivors, no cross-group fan-in).  Each window's
    decode matrix has its columns in the code's `decode_select` basis
    where the code has one; window shards outside the basis drop out."""
    k = code.k
    entries = _order_survivors(groups, {lost})
    support_hook = getattr(code, "repair_support", None)
    k_eff = k
    if support_hook is not None:
        support = support_hook(lost, sorted({s for _, s in entries}))
        if support is not None:
            sup = set(support)
            entries = [(g, s) for g, s in entries if s in sup]
            k_eff = len(support)
    if len(entries) < k_eff:
        raise ValueError(
            f"need >= {k_eff} survivors to repair shard {lost}, "
            f"have {len(entries)}")
    d_eff = len(entries) if d is None \
        else max(k_eff, min(int(d), len(entries)))
    helpers = entries[:d_eff]
    local = [(g, s) for g, s in helpers if g.locality == 0]
    remote = [(g, s) for g, s in helpers if g.locality != 0]
    t = k_eff - len(local)
    plan = RepairPlan(lost=lost, k=k, d=d_eff, length=length)
    if length <= 0:
        return plan
    if t <= 0:
        windows = [local[:k_eff]]
    elif t >= len(remote):
        windows = [local + remote]
    else:
        # rotating exclusion over the remote tail: window s uses remote
        # helpers [s, s+t) mod |remote|, so each remote helper reads
        # ~t/|remote| of the range instead of all of it
        windows = [local + [remote[(s + j) % len(remote)]
                            for j in range(t)]
                   for s in range(len(remote))]
    # cut [0, length) into len(windows) align-floored segments; collapse
    # to fewer windows when the range is too small to stripe
    nseg = max(1, min(len(windows), -(-length // align)))
    base = (length // nseg) // align * align if nseg > 1 else length
    if nseg > 1 and base == 0:
        nseg, base = 1, length
    sel = getattr(code, "decode_select", None)
    for s in range(nseg):
        off = s * base
        size = base if s < nseg - 1 else length - off
        win = windows[s]
        sids = sorted(sid for _, sid in win)
        basis = list(sel(sids, [lost])) if sel is not None else sids
        M = code.decode_matrix(sids, [lost])  # [1, |basis|]
        col = {sid: i for i, sid in enumerate(basis)}
        parts: list[Part] = []
        for g in sorted({id(gr): gr for gr, _ in win}.values(),
                        key=lambda g: (g.locality, g.node)):
            mine = tuple(sorted(sid for gr, sid in win
                                if gr is g and sid in col))
            if not mine:
                continue
            coeff = np.ascontiguousarray(
                M[:, [col[sid] for sid in mine]], dtype=np.uint8)
            parts.append(Part(group=g, shards=mine, coeff=coeff))
        plan.segments.append(Segment(offset=off, size=size,
                                     parts=tuple(parts)))
    return plan


def plan_msr_repair(code, lost: int, groups: list[HelperGroup],
                    length: int, d: int | None = None,
                    align: int = DEFAULT_SEG_ALIGN) -> RepairPlan:
    """Build the regenerating-code repair plan for ONE lost MSR shard file
    over its full [0, length) byte range.  `code` is the file codec or its
    inner `PMMSRCode`; `align` is unused (one segment), and is taken so
    that `repair_shard` calls every planner alike.

    Plan coordinates are SUB-ROWS (file bytes / alpha): shard ids in Parts
    are virtual ids `file_sid * alpha + j`, offsets and sizes are sub-row
    offsets, and the executor's read_local / fetch_partial / sink own the
    byte-interleave translation (virtual rows [o, o+s) are the contiguous
    file range [o*alpha, (o+s)*alpha)).

    Each of the d helper shards contributes ONE combined sub-row (coeff =
    phi_f per held shard, block-diagonal for a node holding several), and
    the repairing node expands each node's payload through its R columns
    (`post`): d/alpha shard-equivalents over the network, against k for
    the naive copy.  Raises ValueError when fewer than d helper shards
    survive or `length` is not an alpha multiple."""
    inner = getattr(code, "code", code)
    a = inner.alpha
    need = inner.d if d is None else max(inner.d, int(d))
    if length % a != 0:
        raise ValueError(f"msr length {length} not a multiple of "
                         f"alpha={a}")
    sub_len = length // a
    entries = _order_survivors(groups, {lost})
    if len(entries) < need:
        raise ValueError(
            f"msr repair of shard {lost} needs {need} helpers, "
            f"have {len(entries)}")
    helpers = entries[:need]
    helper_sids = [sid for _, sid in helpers]
    phi = inner.repair_coeff(lost)                 # [1, alpha]
    R = inner.repair_matrix(lost, helper_sids)     # [alpha, d]
    col = {sid: i for i, sid in enumerate(helper_sids)}
    plan = RepairPlan(lost=lost, k=inner.k_nodes, d=need, length=sub_len,
                      out_rows=a)
    if sub_len <= 0:
        return plan
    parts: list[Part] = []
    for g in sorted({id(gr): gr for gr, _ in helpers}.values(),
                    key=lambda g: (g.locality, g.node)):
        mine = tuple(sorted(sid for gr, sid in helpers if gr is g))
        c = len(mine)
        coeff = np.zeros((c, c * a), dtype=np.uint8)
        vids: list[int] = []
        for i, sid in enumerate(mine):
            coeff[i, i * a:(i + 1) * a] = phi[0]
            vids.extend(sid * a + j for j in range(a))
        post = np.ascontiguousarray(R[:, [col[sid] for sid in mine]],
                                    dtype=np.uint8)
        parts.append(Part(group=g, shards=tuple(vids), coeff=coeff,
                          post=post))
    plan.segments.append(Segment(offset=0, size=sub_len,
                                 parts=tuple(parts)))
    return plan


def _xor_into(acc: np.ndarray | None, part: np.ndarray) -> np.ndarray:
    if acc is None:
        return np.array(part, copy=True)
    np.bitwise_xor(acc, part, out=acc)
    return acc


def _tick(stats: dict, key: str, t0: float) -> float:
    """Add the seconds since `t0` to stats[key]; returns now."""
    t = time.perf_counter()
    stats[key] = stats.get(key, 0.0) + (t - t0)
    return t


def execute_plan(codec, plan: RepairPlan, read_local, fetch_partial,
                 sink, batch_size: int, stats: dict,
                 pool: ThreadPoolExecutor | None, cancel=None) -> None:
    """Run one plan: per batch chunk, submit each remote group's fetch to
    `pool`, compute the local partial through `dispatch.apply_matrix`, XOR
    the remote partials in as they complete (each through its part's
    `post` first, where it has one), and hand the rebuilt range to
    `sink(offset, ndarray)`: one [n] row for a scalar-row plan, all
    [out_rows, n] sub-rows for a sub-row plan.  `pool` may be None only
    for a plan with no remote part.

    `read_local(sid, off, n) -> bytes|None`; a short/failed local read
    raises HelperDied("", (sid,)) so the caller replans without it.
    `fetch_partial(group, shards, coeff, off, n) -> bytes` raises
    HelperDied on transport failure.  Raises propagate mid-range: the
    caller owns tmp-file discipline, so a dead helper can never leave a
    partial shard visible.  `stats` gets the payload bytes received per
    node (`helper_bytes`) and per locality class (`by_locality`), and the
    caller thread's seconds by stage: local preads and stack (`read_s`),
    the local apply and every post apply (`apply_s`), waiting on remote
    partials (`wait_s`), XOR (`xor_s`) and the sink (`write_s`).
    `cancel()`, polled before each chunk, aborts with EncodeCancelled."""
    for seg in plan.segments:
        end = seg.offset + seg.size
        for off in range(seg.offset, end, batch_size):
            if cancel is not None and cancel():
                # ec_files imports this module: its exception is looked
                # up when it is raised
                from seaweedfs_tpu_torch.storage.ec.ec_files import \
                    EncodeCancelled
                raise EncodeCancelled("reduced rebuild cancelled")
            n = min(batch_size, end - off)
            futs = {}
            for part in seg.parts:
                if part.group.locality != 0:
                    futs[pool.submit(fetch_partial, part.group,
                                     part.shards, part.coeff,
                                     off, n)] = part
            acc: np.ndarray | None = None
            t = time.perf_counter()
            for part in seg.parts:
                if part.group.locality != 0:
                    continue
                rows = []
                for sid in part.shards:
                    data = read_local(sid, off, n)
                    if data is None or len(data) != n:
                        raise HelperDied("", (sid,))
                    rows.append(np.frombuffer(data, dtype=np.uint8))
                stack = np.stack(rows)
                t = _tick(stats, "read_s", t)
                local = dispatch.apply_matrix(codec, part.coeff, stack)
                if part.post is not None:
                    local = dispatch.apply_matrix(codec, part.post, local)
                t = _tick(stats, "apply_s", t)
                acc = _xor_into(acc, local)
                t = _tick(stats, "xor_s", t)
            for fut in as_completed(futs):
                t = _tick(stats, "wait_s", t)
                part = futs[fut]
                exc = fut.exception()
                if exc is not None:
                    if isinstance(exc, HelperDied):
                        raise exc
                    raise HelperDied(part.group.node, part.shards) \
                        from exc
                payload = fut.result()
                want = part.coeff.shape[0] * n
                if payload is None or len(payload) != want:
                    raise HelperDied(part.group.node, part.shards)
                hb = stats.setdefault("helper_bytes", {})
                hb[part.group.node] = hb.get(part.group.node, 0) + want
                bl = stats.setdefault("by_locality", {})
                name = locality_name(part.group.locality)
                bl[name] = bl.get(name, 0) + want
                arr = np.frombuffer(payload, dtype=np.uint8).reshape(
                    part.coeff.shape[0], n)
                if part.post is not None:
                    arr = dispatch.apply_matrix(codec, part.post, arr)
                    t = _tick(stats, "apply_s", t)
                acc = _xor_into(acc, arr)
                t = _tick(stats, "xor_s", t)
            assert acc is not None, "plan segment with no parts"
            if plan.out_rows == 1:
                sink(off, acc[0])
            else:
                sink(off, acc.reshape(plan.out_rows, n))
            _tick(stats, "write_s", t)


def repair_shard(code, codec, lost: int, groups: list[HelperGroup],
                 length: int, read_local, fetch_partial, sink, *,
                 d: int | None = None, batch_size: int = 16 * 1024 * 1024,
                 align: int = DEFAULT_SEG_ALIGN, cancel=None,
                 stats: dict, planner=plan_repair) -> RepairPlan:
    """Repair one lost shard with automatic re-planning: when a helper
    dies mid-transfer (HelperDied), its node (or, for the repairing node's own
    reads, its shards) leaves the survivor pool and the WHOLE shard
    recomputes under a fresh plan; `sink` writes are offset-addressed and
    idempotent, so a restart simply overwrites.  `planner` is
    `plan_repair` (RS, LRC) or `plan_msr_repair` (MSR, whose virtual
    shard ids map back to files as `sid // out_rows`).  `stats` gets
    execute_plan's ledgers and stage seconds, and also counts `replans`
    and lists `dead_helpers` (in file shard ids).  `cancel` goes to
    execute_plan: EncodeCancelled is not a helper's death and is not
    replanned.  Raises the planner's
    ValueError when too few survivors remain.  Returns the plan that
    completed."""
    dead_nodes: set[str] = set()
    dead_shards: set[int] = set()
    pool: ThreadPoolExecutor | None = None
    try:
        while True:
            live = []
            for g in groups:
                if g.locality != 0 and g.node in dead_nodes:
                    continue
                keep = tuple(s for s in g.shards if s not in dead_shards)
                if keep:
                    live.append(g.replace_shards(keep))
            plan = planner(code, lost, live, length, d=d, align=align)
            remote = {g.node for g in live if g.locality != 0}
            if pool is None and remote:
                # one pool for every attempt: a replan must not pay
                # pool teardown/spawn on top of the lost transfer
                pool = ThreadPoolExecutor(
                    max_workers=min(8, len(remote)),
                    thread_name_prefix="ec-partial")
            try:
                execute_plan(codec, plan, read_local, fetch_partial,
                             sink, batch_size, stats, pool, cancel=cancel)
                return plan
            except HelperDied as e:
                shards = sorted({s // plan.out_rows for s in e.shards})
                stats["replans"] = stats.get("replans", 0) + 1
                stats.setdefault("dead_helpers", []).append(
                    {"node": e.node, "shards": shards})
                if e.node:
                    dead_nodes.add(e.node)
                else:
                    dead_shards.update(shards)
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
