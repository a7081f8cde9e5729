"""``doctor()``: the performance advisor.

PyTorch counterpart of ``tensorframes_tpu/doctor.py``, with its rules,
codes, severities, thresholds and messages.  The observability layer
accumulates the evidence (counters, the always-on latency histograms,
request ledgers, span annotations); :func:`doctor` reads it and returns
structured diagnoses of the anti-patterns, each naming the knob that
fixes it, and :func:`render` formats them for humans.

Rules (each fires at most one diagnostic): ``retrace_storm``,
``bucket_miss_churn``, ``cache_thrash``, ``low_pool_occupancy``,
``shed_burn``, ``retry_burn``, ``slow_tail``, ``coalesce_miss``,
``unfair_tenant``, ``shuffle_skew``, ``stale_artifacts``, ``cse_miss``,
``indep_probe_churn``, ``kv_fragmentation``, ``decode_slot_starvation``,
``replica_flap`` and ``fleet_imbalance``; the JAX module's docstring
describes each.

Every input is injectable (``counters=``, ``latency=``, ``ledger=``,
``spans=``, ``tenants=``, ``shuffles=``, ``plans=``, ``artifacts=``,
``fleet=``, ``decode=``), so tests and offline analysis run the same rules
over recorded snapshots; with no arguments the live process is read (the
``plans`` section from the planner's ``recent_plan_stats``, ``shuffles``
from ``relational.recent_shuffle_stats``, ``artifacts`` from the janitor's
``summary``, ``decode`` from the live ``bridge.coalescer.DecodeScheduler``).
The section whose module the port does not have yet (the bridge's fleet:
ROADMAP.md Queue 1 item 12b) reads empty inputs, and :func:`render` names
it in one line.  Only the absence of such a module
is tolerated: any other failure to read a section raises.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Mapping, Optional, Sequence

from . import observability

__all__ = ["doctor", "render"]

# thresholds: deliberately conservative — a diagnostic that fires on a
# healthy process erodes trust faster than a missed one
MIN_EVENTS = 8  # evidence floor before any rule may fire
RETRACE_RATIO = 0.5  # traces per invocation past warmup
OCCUPANCY_FLOOR = 0.5  # mean pooled occupancy below this is "idle"
SHED_RATE = 0.10
TAIL_RATIO = 32.0  # p99 / p50
COALESCE_MISS_RATE = 0.5  # solo dispatches / coalescer-eligible requests
UNFAIR_ROW_RATIO = 4.0  # top tenant rows vs the runner-up
SHUFFLE_SKEW_RATIO = 4.0  # largest shuffle partition vs the median


def _diag(
    code: str,
    severity: str,
    summary: str,
    evidence: Mapping[str, Any],
    knob: str,
    advice: str,
) -> Dict[str, Any]:
    return {
        "code": code,
        "severity": severity,
        "summary": summary,
        "evidence": dict(evidence),
        "knob": knob,
        "advice": advice,
    }


def _rule_retrace_storm(c, latency) -> Optional[Dict[str, Any]]:
    by_verb = c.get("by_verb") or {}
    worst = None
    for verb, vc in by_verb.items():
        traces = vc.get("program_traces", 0)
        calls = (latency.get(f"verb:{verb}") or {}).get("count", 0)
        if calls < MIN_EVENTS or traces < MIN_EVENTS:
            continue
        ratio = traces / calls
        if ratio >= RETRACE_RATIO and (
            worst is None or ratio > worst[1]
        ):
            worst = (verb, ratio, traces, calls)
    if worst is None:
        return None
    verb, ratio, traces, calls = worst
    return _diag(
        "retrace_storm",
        "warn",
        f"{verb} re-traced its program {traces} times over {calls} "
        f"calls ({ratio:.2f} traces/call) — steady state should be ~0",
        {"verb": verb, "traces": traces, "calls": calls,
         "traces_per_call": round(ratio, 3)},
        "TFS_BLOCK_BUCKETS",
        "uneven block sizes mint one executable per distinct shape; "
        "enable shape-canonical bucketing (TFS_BLOCK_BUCKETS) so O(log "
        "max-dim) buckets serve every size, and prime with warmup() + "
        "TFS_COMPILE_CACHE so fresh processes skip XLA entirely",
    )


def _rule_bucket_miss_churn(c) -> Optional[Dict[str, Any]]:
    compiles = c.get("backend_compiles", 0)
    hits = c.get("persistent_cache_hits", 0)
    misses = c.get("persistent_cache_misses", 0)
    if compiles < MIN_EVENTS:
        return None
    if hits + misses == 0:
        return _diag(
            "bucket_miss_churn",
            "info",
            f"{compiles} XLA backend compiles with NO persistent "
            f"compilation cache configured — every process pays them "
            f"from scratch",
            {"backend_compiles": compiles, "persistent_cache_hits": 0,
             "persistent_cache_misses": 0},
            "TFS_COMPILE_CACHE",
            "set TFS_COMPILE_CACHE to a shared directory so compiled "
            "executables persist across processes (warmup() then turns "
            "cold starts into disk fetches)",
        )
    if misses > max(hits, MIN_EVENTS - 1):
        return _diag(
            "bucket_miss_churn",
            "warn",
            f"persistent compile cache misses ({misses}) exceed hits "
            f"({hits}) over {compiles} compiles — the cache is not "
            f"absorbing the compile load",
            {"backend_compiles": compiles, "persistent_cache_hits": hits,
             "persistent_cache_misses": misses},
            "TFS_COMPILE_CACHE",
            "the executed shapes are not converging: check that "
            "TFS_BLOCK_BUCKETS is on so block sizes canonicalize, and "
            "that the TFS_COMPILE_CACHE directory is shared and "
            "writable across processes",
        )
    return None


def _rule_cache_thrash(c) -> Optional[Dict[str, Any]]:
    ev = c.get("cache_evictions", 0)
    hits = c.get("cache_shard_hits", 0)
    if ev < max(4, MIN_EVENTS // 2):
        return None
    if ev < hits / 4:
        return None  # evicting a little while serving a lot is healthy
    return _diag(
        "cache_thrash",
        "warn",
        f"the HBM frame cache evicted {ev} shard(s) against {hits} "
        f"shard hit(s) — the working set is cycling through the budget "
        f"instead of residing in it",
        {"cache_evictions": ev, "cache_shard_hits": hits},
        "TFS_HBM_BUDGET",
        "raise TFS_HBM_BUDGET so the live frames' shards fit, or "
        "cache() fewer columns/frames (each eviction re-pays the H2D "
        "it was supposed to save; with TFS_SPILL_DIR set, disk I/O too)",
    )


def _rule_low_pool_occupancy(c, ledger, spans) -> Optional[Dict[str, Any]]:
    if c.get("pool_blocks", 0) < MIN_EVENTS:
        return None
    # prefer span evidence (measured occupancy); fall back to the
    # ledger's blocks-per-device imbalance
    occs: List[float] = []
    devices = 0
    for rec in spans or ():
        dp = rec.get("device_pool")
        if not dp or not dp.get("occupancy"):
            continue
        occ = dp["occupancy"]
        if len(occ) >= 2:
            occs = occ
            devices = dp.get("devices", len(occ))
    if occs:
        mean = sum(occs) / len(occs)
        if mean >= OCCUPANCY_FLOOR:
            return None
        return _diag(
            "low_pool_occupancy",
            "warn",
            f"pooled dispatch left devices idle: mean occupancy "
            f"{mean:.2f} across {devices} device(s) "
            f"(per-device {occs})",
            {"occupancy": occs, "mean_occupancy": round(mean, 3),
             "devices": devices},
            "TFS_PREFETCH_BLOCKS",
            "the pool is starving: raise TFS_PREFETCH_BLOCKS so staging "
            "lanes run further ahead of compute, or repartition the "
            "frame into more blocks so every device has work in flight",
        )
    bpd = (ledger or {}).get("blocks_per_device") or {}
    if len(bpd) >= 2:
        counts = sorted(int(v) for v in bpd.values())
        if counts[-1] >= 4 * max(1, counts[0]) and sum(counts) >= MIN_EVENTS:
            return _diag(
                "low_pool_occupancy",
                "info",
                f"block placement is skewed: blocks per device {bpd} — "
                f"the busiest device carries {counts[-1]}x the quietest's "
                f"{counts[0]}",
                {"blocks_per_device": dict(bpd)},
                "TFS_PREFETCH_BLOCKS",
                "skewed block sizes serialize on one device; repartition "
                "into more, evener blocks (the least-loaded scheduler "
                "balances rows, but cannot split a giant block)",
            )
    return None


def _rule_shed_burn(c) -> Optional[Dict[str, Any]]:
    shed = c.get("bridge_shed", 0)
    executed = c.get("bridge_verbs_executed", 0)
    offered = shed + executed
    if shed < MIN_EVENTS or offered == 0:
        return None
    rate = shed / offered
    if rate < SHED_RATE:
        return None
    return _diag(
        "shed_burn",
        "critical" if rate >= 0.5 else "warn",
        f"admission control shed {shed} of {offered} offered requests "
        f"({rate:.0%}) — clients are burning retries against a full "
        f"server",
        {"bridge_shed": shed, "bridge_verbs_executed": executed,
         "shed_rate": round(rate, 3)},
        "TFS_BRIDGE_MAX_INFLIGHT",
        "raise TFS_BRIDGE_MAX_INFLIGHT / TFS_BRIDGE_QUEUE_DEPTH if the "
        "host has headroom (watch occupancy first), or add servers and "
        "route on the health RPC — sheds are the backpressure working, "
        "but a sustained rate means the fleet is undersized",
    )


def _rule_retry_burn(c) -> Optional[Dict[str, Any]]:
    retries = c.get("block_retries", 0)
    if retries < MIN_EVENTS:
        return None
    quarantined = c.get("devices_quarantined", 0)
    return _diag(
        "retry_burn",
        "warn",
        f"{retries} block retries absorbed"
        + (f", {quarantined} device quarantine(s)" if quarantined else "")
        + " — results are intact but every retry pays re-staging plus "
          "backoff",
        {"block_retries": retries, "devices_quarantined": quarantined,
         "faults_injected": c.get("faults_injected", 0)},
        "TFS_QUARANTINE_AFTER",
        "check the health RPC's quarantined_devices history for a sick "
        "chip; lower TFS_QUARANTINE_AFTER to drain it sooner, and "
        "consider TFS_BLOCK_BACKOFF_S if retry latency dominates p99",
    )


def _rule_slow_tail(latency) -> Optional[Dict[str, Any]]:
    worst = None
    for key, s in latency.items():
        if s.get("count", 0) < MIN_EVENTS * 2:
            continue
        p50, p99 = s.get("p50_s", 0.0), s.get("p99_s", 0.0)
        if p50 <= 0:
            continue
        ratio = p99 / p50
        if ratio >= TAIL_RATIO and (worst is None or ratio > worst[1]):
            worst = (key, ratio, p50, p99, s["count"])
    if worst is None:
        return None
    key, ratio, p50, p99, count = worst
    return _diag(
        "slow_tail",
        "info",
        f"{key} p99 ({p99:.4f}s) is {ratio:.0f}x its p50 ({p50:.6f}s) "
        f"over {count} observations — a minority of requests pay a "
        f"disproportionate price",
        {"series": key, "p50_s": p50, "p99_s": p99,
         "tail_ratio": round(ratio, 1), "count": count},
        "TFS_SLOW_REQUEST_MS",
        "set TFS_SLOW_REQUEST_MS to log the slow requests' ledgers "
        "(correlation id + counters delta), then read the attribution "
        "RPC for the victims — tails here usually trace to a retrace "
        "storm, retry burn, or admission queueing diagnosed above",
    )


def _rule_coalesce_miss(c) -> Optional[Dict[str, Any]]:
    solo = c.get("coalesce_solo_requests", 0)
    batched = c.get("coalesced_requests", 0)
    hot = c.get("warm_program_hits", 0)
    if solo < MIN_EVENTS:
        return None
    offered = solo + batched
    rate = solo / offered
    if rate < COALESCE_MISS_RATE:
        return None
    return _diag(
        "coalesce_miss",
        "warn" if rate >= 0.9 else "info",
        f"{solo} of {offered} coalescer-eligible requests ({rate:.0%}) "
        f"dispatched ALONE on hot programs ({hot} warm-pool hits) — "
        f"the gather window keeps expiring before company arrives",
        {"coalesce_solo_requests": solo, "coalesced_requests": batched,
         "warm_program_hits": hot, "solo_rate": round(rate, 3)},
        "TFS_BRIDGE_COALESCE_US",
        "raise TFS_BRIDGE_COALESCE_US so concurrent small requests on "
        "the same program merge into one bucket-canonical dispatch "
        "(each batch amortizes staging + dispatch across its members); "
        "a window near the inter-arrival gap captures most of the win "
        "for at most one window of added latency",
    )


def _rule_unfair_tenant(c, tenants) -> Optional[Dict[str, Any]]:
    if not tenants or len(tenants) < 2:
        return None
    rows = {
        t: int(v.get("rows", 0))
        for t, v in tenants.items()
        if v.get("requests", 0) > 0
    }
    if len(rows) < 2 or sum(rows.values()) == 0:
        return None
    ranked = sorted(rows.items(), key=lambda kv: -kv[1])
    (top, top_rows), (_, second_rows) = ranked[0], ranked[1]
    total_req = sum(int(v.get("requests", 0)) for v in tenants.values())
    if total_req < MIN_EVENTS:
        return None
    if top_rows < UNFAIR_ROW_RATIO * max(1, second_rows):
        return None
    # starvation needs CONTENTION evidence: someone was shed or queued
    # while the hog ran — imbalance alone on an idle server is fine
    shed = c.get("bridge_shed", 0)
    fair = c.get("fair_share_sheds", 0)
    if shed + fair == 0:
        return None
    if fair > 0:
        # the budget knob is already enforcing; report as info so the
        # operator sees WHO is being throttled, not as a missing knob
        sev, advice = "info", (
            "TFS_BRIDGE_FAIR_ROWS is enforcing: the over-budget tenant "
            "is being shed with retry_after_ms hints; raise its budget "
            "(or add capacity) if the throttling is unintended"
        )
    else:
        sev, advice = "warn", (
            "set TFS_BRIDGE_FAIR_ROWS (per-tenant rows per "
            "TFS_BRIDGE_FAIR_WINDOW_S window) so the SLO scheduler "
            "sheds the hog with a backoff hint BEFORE the admission "
            "queue fills and p99 blows for everyone else"
        )
    return _diag(
        "unfair_tenant",
        sev,
        f"tenant {top!r} consumed {top_rows} rows — "
        f"{top_rows / max(1, second_rows):.0f}x the next tenant's "
        f"{second_rows} — while {shed + fair} request(s) were shed",
        {"rows_by_tenant": rows, "top_tenant": top,
         "bridge_shed": shed, "fair_share_sheds": fair},
        "TFS_BRIDGE_FAIR_ROWS",
        advice,
    )


def _rule_shuffle_skew(shuffles) -> Optional[Dict[str, Any]]:
    """One shuffle partition carrying >= 4x the median partition's rows:
    the key's hash distribution is lumpy (usually a hot key), so the
    sort-merge join / downstream consumer serializes on that partition
    and its memory bound blows past total/partitions."""
    worst = None
    for s in shuffles or ():
        rows = [int(r) for r in s.get("partition_rows") or ()]
        if len(rows) < 2 or sum(rows) < MIN_EVENTS:
            continue
        ranked = sorted(rows)
        med = max(1, ranked[len(ranked) // 2])
        top = ranked[-1]
        if top >= SHUFFLE_SKEW_RATIO * med and (
            worst is None or top / med > worst[1]
        ):
            worst = (s.get("key"), top / med, top, med, rows)
    if worst is None:
        return None
    key, ratio, top, med, rows = worst
    return _diag(
        "shuffle_skew",
        "warn",
        f"shuffle on key {key!r} is skewed: the largest partition holds "
        f"{top} rows, {ratio:.0f}x the median partition's {med} "
        f"(per-partition {rows})",
        {"key": key, "partition_rows": rows, "max_rows": top,
         "median_rows": med, "skew_ratio": round(ratio, 2)},
        "TFS_SHUFFLE_PARTITIONS",
        f"a hot value in key {key!r} hashes every duplicate into one "
        f"partition; raising TFS_SHUFFLE_PARTITIONS shrinks every OTHER "
        f"partition's memory bound but not the hot one's — prefer a "
        f"higher-cardinality key (or salt the hot key upstream), and "
        f"budget the sort-merge join for the largest partition's rows",
    )


def _rule_cse_miss(c, plans) -> Optional[Dict[str, Any]]:
    """One subplan signature re-executed >= MIN_EVENTS times with zero
    registry hits: the cross-plan sharing the planner offers is being
    left on the table (result dropped between requests, CSE off, or
    per-request Program rebuilds defeating object identity)."""
    worst = None
    for s in plans or ():
        ex, hits = int(s.get("executions", 0)), int(s.get("hits", 0))
        if ex < MIN_EVENTS or hits > 0:
            continue
        if worst is None or ex > worst[0]:
            worst = (ex, int(s.get("stages", 0)))
    if worst is None:
        return None
    ex, stages = worst
    total_hits = c.get("plan_cse_hits", 0)
    return _diag(
        "cse_miss",
        "info",
        f"one {stages}-stage subplan executed {ex} times across recent "
        f"requests with 0 cross-plan shares (process-wide "
        f"plan_cse_hits={total_hits}) — identical work is being re-paid "
        f"per request",
        {"executions": ex, "stages": stages,
         "plan_cse_hits": total_hits},
        "TFS_PLAN_CSE",
        "keep TFS_PLAN_CSE on and hold the shared subplan's result "
        "alive (.lazy() retention or cache(sharded=True)) so repeats "
        "reuse it; on the bridge, enable the warm program pool "
        "(TFS_BRIDGE_WARM) so identical requests share one Program "
        "object — the registry keys on object identity plus live "
        "params",
    )


STALE_ARTIFACT_MIN_BYTES = 1 << 20  # ignore sub-MB crumbs


def _rule_stale_artifacts(artifacts) -> Optional[Dict[str, Any]]:
    """Dead processes left spill/spool/journal files behind (round 20,
    the orphan janitor's scan): the bytes are reclaimable — nothing
    live references them — and interrupted durable jobs are waiting to
    be resumed.  Fires on >= 1 MB reclaimable OR any interrupted job."""
    if not artifacts:
        return None
    nbytes = int(artifacts.get("reclaimable_bytes", 0))
    interrupted = list(artifacts.get("interrupted_jobs") or ())
    if nbytes < STALE_ARTIFACT_MIN_BYTES and not interrupted:
        return None
    dirs = [
        d
        for d in (artifacts.get("spill_dir"), artifacts.get("journal_dir"))
        if d
    ]
    parts = []
    if nbytes:
        parts.append(
            f"{artifacts.get('reclaimable_count', 0)} dead-process "
            f"artifact(s), {nbytes} bytes reclaimable, under "
            f"{' and '.join(dirs)}"
        )
    if interrupted:
        parts.append(
            f"{len(interrupted)} interrupted durable job(s) awaiting "
            f"resume: {interrupted}"
        )
    return _diag(
        "stale_artifacts",
        "warn" if nbytes >= STALE_ARTIFACT_MIN_BYTES else "info",
        "; ".join(parts),
        dict(artifacts),
        "TFS_JOURNAL_DIR",
        "run tensorframes_tpu.recovery.janitor.reclaim() to delete the "
        "dead-process spill/journal leftovers (a restarted "
        "BridgeServer does this automatically at startup); resume "
        "interrupted jobs by re-issuing their request with the same "
        "job_id — the journal continues from the last completed "
        "window",
    )


def _rule_indep_probe_churn(c) -> Optional[Dict[str, Any]]:
    falls = c.get("analysis_probe_fallbacks", 0)
    hits = c.get("analysis_static_hits", 0)
    if falls < MIN_EVENTS or falls <= hits:
        return None
    return _diag(
        "indep_probe_churn",
        "info",
        f"{falls} row-independence question(s) fell back to the "
        f"per-size compile probe against {hits} static-classifier "
        f"answer(s) — each fallback re-traces the program per new size "
        f"set (>= 2 traces) where a classified program pays zero",
        {"analysis_probe_fallbacks": falls, "analysis_static_hits": hits},
        "TFS_ANALYZE",
        "the dominant programs are outside the static classifier's "
        "envelope (unclassified primitive, size-branching python "
        "control flow, non-monotone literals) — file the program's "
        "jaxpr so the lattice learns the primitive; run with "
        "TFS_ANALYZE_XCHECK=1 to capture classifier-vs-probe evidence, "
        "and keep TFS_ANALYZE on (the probe fallback stays sound)",
    )


KV_CHURN_PAGES = 8.0  # pages cycled per retired stream before "churn"


def _rule_kv_fragmentation(c, decode) -> Optional[Dict[str, Any]]:
    """The paged decode scheduler (round 22) is cycling many small KV
    pages per stream while the pool sits mostly idle: the page size is
    minting allocation/free traffic and page-table entries without the
    pool being under capacity pressure.  Larger pages cut the churn;
    the capacity cost (internal fragmentation of the last page per
    stream) is what the low occupancy says the pool can afford."""
    if not decode:
        return None
    freed = c.get("kv_pages_freed", 0)
    retired = int(decode.get("retired") or 0)
    if freed < MIN_EVENTS or retired < 1:
        return None
    pages_per_seq = freed / retired
    cap = int(decode.get("pages_capacity") or 0)
    occ = (decode.get("pages_used") or 0) / cap if cap else 0.0
    if pages_per_seq < KV_CHURN_PAGES or occ >= OCCUPANCY_FLOOR:
        return None
    return _diag(
        "kv_fragmentation",
        "info",
        f"paged decode cycled {freed} KV pages over {retired} retired "
        f"stream(s) ({pages_per_seq:.1f} pages/stream at "
        f"{decode.get('page_tokens')} tokens/page) while the pool sits "
        f"at {occ:.0%} occupancy — page bookkeeping, not capacity, is "
        f"the overhead",
        {"kv_pages_freed": freed, "retired": retired,
         "pages_per_stream": round(pages_per_seq, 2),
         "page_tokens": decode.get("page_tokens"),
         "pages_used": decode.get("pages_used"),
         "pages_capacity": cap},
        "TFS_DECODE_PAGE_TOKENS",
        "raise TFS_DECODE_PAGE_TOKENS so each stream spans fewer pages "
        "(fewer allocate/free cycles and smaller page tables); the "
        "trade is internal fragmentation of each stream's last page, "
        "which the idle pool absorbs — revisit if occupancy later "
        "climbs past the floor",
    )


def _rule_decode_slot_starvation(c, decode) -> Optional[Dict[str, Any]]:
    """Decode admissions were refused while slots sat idle (round 22):
    the configured bounds — the page pool sized off
    ``TFS_DECODE_MAX_SLOTS``, or the backlog cap at twice it — turned
    work away that idle compute could have taken."""
    if not decode:
        return None
    idle_refusals = int(decode.get("refused_while_idle") or 0)
    if idle_refusals < MIN_EVENTS:
        return None
    return _diag(
        "decode_slot_starvation",
        "warn",
        f"{idle_refusals} decode admission refusal(s) were issued "
        f"while at least one of {decode.get('max_slots')} slots sat "
        f"idle (pages: {decode.get('refused_pages')}, backlog: "
        f"{decode.get('refused_slots')}) — the bounds, not compute, "
        f"are the limit",
        {"refused_while_idle": idle_refusals,
         "refused_pages": decode.get("refused_pages"),
         "refused_slots": decode.get("refused_slots"),
         "max_slots": decode.get("max_slots"),
         "pages_capacity": decode.get("pages_capacity")},
        "TFS_DECODE_MAX_SLOTS",
        "raise TFS_DECODE_MAX_SLOTS (the default page pool scales with "
        "it, so both the backlog cap and page capacity grow), or pass "
        "a larger pool_pages explicitly if only the pool is tight — "
        "admission stays refusal-based either way, so decode still "
        "cannot OOM mid-step",
    )


FLEET_IMBALANCE_RATIO = 4.0  # busiest replica's sessions vs fleet mean


def _rule_replica_flap(fleet) -> Optional[Dict[str, Any]]:
    """A fleet replica is flapping (round 21): down transitions and/or
    silent restarts (epoch changes) inside the router's flap window at
    or past the quarantine threshold, or an active quarantine.  Each
    flap dumps that replica's sessions onto its peers and re-pays warm
    state; a flapper that keeps rejoining is worse than one that stays
    down."""
    if not fleet:
        return None
    reps = fleet.get("replicas") or {}
    threshold = max(1, int(fleet.get("quarantine_after") or 1))
    worst = None
    for name, r in reps.items():
        flaps = int(r.get("flaps_recent") or 0)
        if r.get("quarantined") or flaps >= threshold:
            if worst is None or flaps > worst[1]:
                worst = (name, flaps, r)
    if worst is None:
        return None
    name, flaps, r = worst
    state = "quarantined" if r.get("quarantined") else "flapping"
    return _diag(
        "replica_flap",
        "warn",
        f"fleet replica {name} is {state}: {flaps} flap(s) in the last "
        f"{fleet.get('flap_window_s')}s (threshold "
        f"{threshold}) — its sessions keep spilling onto peers",
        {"replica": name, **{k: r.get(k) for k in (
            "flaps_recent", "quarantined", "healthy", "draining",
            "epoch", "uptime_s")}},
        "TFS_FLEET_QUARANTINE_AFTER",
        "find why the replica keeps dying/restarting (its log, OOM "
        "kills, TFS_FAULT_INJECT leftovers); quarantine holds it out "
        "for TFS_FLEET_QUARANTINE_S so the fleet stabilizes — lower "
        "TFS_FLEET_QUARANTINE_AFTER to quarantine sooner, and prefer "
        "a drained rolling restart (BridgeFleet.rolling_restart) over "
        "letting it crash-loop",
    )


def _rule_fleet_imbalance(fleet) -> Optional[Dict[str, Any]]:
    """One replica carries far more sessions than the fleet mean (round
    21).  Rendezvous hashing balances KEYS, not load — a hot key (one
    client funneling everything through one session token) or a
    shrunken eligible set (peers draining/quarantined) concentrates
    work on one replica, which then sheds while its peers idle."""
    if not fleet:
        return None
    reps = fleet.get("replicas") or {}
    if len(reps) < 2:
        return None
    sessions = {n: int(r.get("sessions") or 0) for n, r in reps.items()}
    total = sum(sessions.values())
    if total < MIN_EVENTS:
        return None
    mean = total / len(sessions)
    top_name, top = max(sessions.items(), key=lambda kv: kv[1])
    if top < FLEET_IMBALANCE_RATIO * max(mean, 1.0):
        return None
    ineligible = [
        n for n, r in reps.items()
        if r.get("draining") or r.get("quarantined") or not r.get("healthy")
    ]
    return _diag(
        "fleet_imbalance",
        "warn",
        f"fleet replica {top_name} holds {top} of {total} sessions "
        f"(mean {mean:.1f} across {len(sessions)} replicas) — the "
        f"fleet is keyed onto one replica",
        {"sessions": sessions, "mean": round(mean, 2),
         "ineligible": ineligible},
        "TFS_FLEET_SIZE",
        "spread clients across distinct routing keys (one FleetClient "
        "key per logical session, not one shared key); return drained/"
        "quarantined peers to eligibility so rendezvous has somewhere "
        "to spread (check the ineligible list), or raise TFS_FLEET_SIZE "
        "if every replica is genuinely saturated",
    )


# argument -> (module, function, the rules that read it) of each live
# section, read lazily as the JAX package reads them; a module not in the
# port yet (the fleet's, item 12b) reads as empty
_SECTIONS = {
    "shuffles": ("relational", "recent_shuffle_stats", ("shuffle_skew",)),
    "plans": ("ops.planner", "recent_plan_stats", ("cse_miss",)),
    "artifacts": ("recovery.janitor", "summary", ("stale_artifacts",)),
    "fleet": ("bridge.fleet", "doctor_snapshot", ("replica_flap", "fleet_imbalance")),
    "decode": ("bridge.coalescer", "decode_doctor_snapshot",
               ("kv_fragmentation", "decode_slot_starvation")),
}


def _section_module(module: str):
    """The port's ``module``, or None when it (or a package above it) does
    not exist in the port yet; any other import failure raises."""
    name = f"{__package__}.{module}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name is not None and (name == e.name or name.startswith(e.name + ".")):
            return None
        raise


def not_ported() -> List[str]:
    """The sections whose modules the port does not have yet."""
    return [arg for arg, (module, _fn, _rules) in _SECTIONS.items()
            if _section_module(module) is None]


def _read_section(arg: str, empty):
    module, fn, _rules = _SECTIONS[arg]
    mod = _section_module(module)
    return empty if mod is None else (getattr(mod, fn)() or empty)


def doctor(
    counters: Optional[Mapping[str, Any]] = None,
    latency: Optional[Mapping[str, Mapping[str, Any]]] = None,
    ledger: Optional[Mapping[str, Any]] = None,
    spans: Optional[Sequence[Mapping[str, Any]]] = None,
    tenants: Optional[Mapping[str, Mapping[str, Any]]] = None,
    shuffles: Optional[Sequence[Mapping[str, Any]]] = None,
    plans: Optional[Sequence[Mapping[str, Any]]] = None,
    artifacts: Optional[Mapping[str, Any]] = None,
    fleet: Optional[Mapping[str, Any]] = None,
    decode: Optional[Mapping[str, Any]] = None,
) -> List[Dict[str, Any]]:
    """Diagnose the process's (or the given snapshots') performance
    state.  Returns structured diagnostics, worst first, each naming the
    anti-pattern, the evidence and the knob to turn; an empty list is the
    healthy answer.

    ``counters``/``latency`` default to :func:`observability.counters` /
    :func:`observability.latency_snapshot`; ``ledger`` takes a
    :meth:`RequestLedger.snapshot` to scope the pool-skew rule to one
    request; ``spans`` takes :func:`observability.last_spans` records for
    measured pool occupancy; ``tenants`` takes
    :func:`observability.request_metrics` for the fairness rule.  The
    other sections read their modules when the port has them."""
    c = dict(counters if counters is not None else observability.counters())
    lat = dict(latency if latency is not None else observability.latency_snapshot())
    if spans is None:
        spans = observability.last_spans(64)
    if tenants is None:
        tenants = observability.request_metrics()
    if shuffles is None:
        shuffles = _read_section("shuffles", [])
    if plans is None:
        plans = _read_section("plans", [])
    if artifacts is None:
        artifacts = _read_section("artifacts", {})
    if fleet is None:
        fleet = _read_section("fleet", {})
    if decode is None:
        decode = _read_section("decode", {})
    out: List[Dict[str, Any]] = []
    for rule in (
        lambda: _rule_shed_burn(c),
        lambda: _rule_retrace_storm(c, lat),
        lambda: _rule_bucket_miss_churn(c),
        lambda: _rule_cache_thrash(c),
        lambda: _rule_low_pool_occupancy(c, ledger, spans),
        lambda: _rule_retry_burn(c),
        lambda: _rule_unfair_tenant(c, tenants),
        lambda: _rule_coalesce_miss(c),
        lambda: _rule_shuffle_skew(shuffles),
        lambda: _rule_cse_miss(c, plans),
        lambda: _rule_stale_artifacts(artifacts),
        lambda: _rule_replica_flap(fleet),
        lambda: _rule_fleet_imbalance(fleet),
        lambda: _rule_indep_probe_churn(c),
        lambda: _rule_kv_fragmentation(c, decode),
        lambda: _rule_decode_slot_starvation(c, decode),
        lambda: _rule_slow_tail(lat),
    ):
        d = rule()
        if d is not None:
            out.append(d)
    sev_rank = {"critical": 0, "warn": 1, "info": 2}
    out.sort(key=lambda d: sev_rank.get(d["severity"], 3))
    return out


def render(diagnostics: Sequence[Mapping[str, Any]]) -> str:
    """Human rendering of :func:`doctor`'s output, ending with one line
    naming the sections the port cannot read yet."""
    if not diagnostics:
        lines = ["doctor: no anti-patterns detected"]
    else:
        lines = [f"doctor: {len(diagnostics)} diagnostic(s)"]
        for d in diagnostics:
            lines.append(f" [{d['severity']}] {d['code']}: {d['summary']}")
            lines.append(f"   knob: {d['knob']}")
            lines.append(f"   advice: {d['advice']}")
    missing = not_ported()
    if missing:
        rules = [r for arg in missing for r in _SECTIONS[arg][2]]
        lines.append(f"doctor: not ported yet, read as empty: {', '.join(missing)} "
                     f"(rules {', '.join(rules)})")
    return "\n".join(lines)
