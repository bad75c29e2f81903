"""The unified cross-engine metrics schema: ``cache-sim/metrics/v1.2``.

The port's copy of the JAX package's ``obs/schema.py`` (its metrics
half): every ``--metrics`` path of the port's CLI routes through here.
The adapters (:func:`from_async`, :func:`from_sync`, :func:`from_native`)
normalize each engine's native counter dict into one report, and
:func:`validate` checks it without any external dependency. The code is
the JAX module's, so a report of the port equals the JAX package's for
the same counters.

Report layout (every field always present; ``None`` marks a counter
the producing engine does not measure — *not* zero):

==================== ====================================================
key                  meaning
==================== ====================================================
schema               literal ``"cache-sim/metrics/v1.2"``
engine               producing engine (``async``/``sync``/``deep``/
                     ``native``)
steps                engine time steps executed
step_unit            what a step is: ``"cycles"`` (async/native) or
                     ``"rounds"`` (sync/deep transactions)
instrs_retired, read_hits, write_hits, read_misses, write_misses,
upgrades, invalidations, evictions
                     the eight core counters, flat at top level (ints)
messages             {processed_total, by_type, dropped_overflow,
                     dropped_injected} — message-level engines only
queue_depth_peak     max mailbox occupancy seen on any node
latency_cycles       {bucket_lo, counts}: miss-latency histogram,
                     bucket b counts waits with issue→retire latency in
                     [bucket_lo[b], next lo); last bucket open-ended
extra                engine-specific counters that have no cross-engine
                     meaning (e.g. sync conflicts/promotions)
txn_latency          *optional* (v1.1): transaction-span latency summary
                     of the causal tracer: {spans, open, by_type: {type:
                     {count, p50, p95, p99}}, segments_total}
mb_dropped           (v1.2) mailbox-overflow silent-drop counter;
                     ``None`` = not measured
==================== ====================================================

v1 and v1.1 documents validate unchanged (v1.1 adds the optional
``txn_latency`` block, v1.2 the required ``mb_dropped``).

The serving half (JAX ``obs/schema.py:306-689``) is copied too: the
job-lifecycle span docs of serve and soak (``cache-sim/serve-trace/v1``,
:func:`validate_serve_trace`), the daemon's ``stats`` snapshot
(``cache-sim/daemon-stats/v1``, :func:`validate_daemon_stats`, whose
optional profile block goes through ``obs.cohprof``) and the merged
fleet view of ``top`` (``cache-sim/fleet/v1``, :func:`validate_fleet`).
"""

from __future__ import annotations

from typing import Optional

from ue22cs343bb1_openmp_assignment_tpu_torch.types import MSG_NAMES

SCHEMA_ID = "cache-sim/metrics/v1.2"

#: previous schema ids; validate() accepts docs under any of them
SCHEMA_V1 = "cache-sim/metrics/v1"
SCHEMA_V1_1 = "cache-sim/metrics/v1.1"

#: the eight cross-engine core counters, flat at top level of the report
CORE_COUNTERS = ("instrs_retired", "read_hits", "write_hits",
                 "read_misses", "write_misses", "upgrades",
                 "invalidations", "evictions")

_TOP_KEYS = (("schema", "engine", "steps", "step_unit") + CORE_COUNTERS
             + ("messages", "queue_depth_peak", "latency_cycles", "extra"))

#: v1.1 optional keys: allowed but never required
_OPT_KEYS = ("txn_latency",)

#: required fields of each txn_latency by_type entry
_TXN_TYPE_KEYS = ("count", "p50", "p95", "p99")

_MSG_KEYS = ("processed_total", "by_type", "dropped_overflow",
             "dropped_injected")


# lint: host
def _report(engine: str, steps: int, step_unit: str, counters: dict,
            messages: Optional[dict] = None,
            queue_depth_peak: Optional[int] = None,
            latency_cycles: Optional[dict] = None,
            extra: Optional[dict] = None,
            mb_dropped: Optional[int] = None) -> dict:
    doc = {"schema": SCHEMA_ID, "engine": engine, "steps": int(steps),
           "step_unit": step_unit}
    for k in CORE_COUNTERS:
        doc[k] = int(counters[k])
    doc["messages"] = (dict.fromkeys(_MSG_KEYS) if messages is None
                      else {k: messages.get(k) for k in _MSG_KEYS})
    doc["queue_depth_peak"] = queue_depth_peak
    doc["latency_cycles"] = latency_cycles
    doc["extra"] = extra or {}
    doc["mb_dropped"] = mb_dropped
    return doc


# lint: host
def latency_histogram(counts) -> Optional[dict]:
    """Render a LAT_BUCKETS-long count vector as the report's
    ``latency_cycles`` object (power-of-two bucket_lo edges); None when
    no wait ever completed (all-zero histogram from a run with no
    misses is still emitted — None means the engine didn't measure)."""
    counts = [int(c) for c in counts]
    return {"bucket_lo": [1 << b for b in range(len(counts))],
            "counts": counts}


# lint: host
def from_async(m: dict, engine: str = "async") -> dict:
    """CoherenceSystem.metrics (the async Metrics pytree as a dict) →
    unified report."""
    by_type = {name: int(c)
               for name, c in zip(MSG_NAMES, m["msgs_processed"])}
    return _report(
        engine, m["cycles"], "cycles", m,
        messages={"processed_total": sum(by_type.values()),
                  "by_type": by_type,
                  "dropped_overflow": int(m["msgs_dropped"]),
                  "dropped_injected": int(m["msgs_injected_dropped"])},
        queue_depth_peak=int(m["mb_depth_peak"]),
        latency_cycles=latency_histogram(m["lat_hist"]),
        mb_dropped=int(m["msgs_dropped"]))


# lint: host
def from_sync(m: dict, engine: str = "sync") -> dict:
    """TransactionalSystem.metrics (SyncMetrics as a dict) → unified
    report. The transactional engine has no message plane or wait
    latency — those stay None; its engine-specific counters (claim
    conflicts, S→E promotions) go to ``extra``."""
    return _report(
        engine, m["rounds"], "rounds", m,
        extra={"conflicts": int(m["conflicts"]),
               "promotions": int(m["promotions"])})


# lint: host
def from_native(m: dict, engine: str = "native") -> dict:
    """NativeEngine.metrics() (the C++ counter vector) → unified
    report. The oracle counts dequeues and drops but not per-type or
    latency."""
    return _report(
        engine, m["cycles"], "cycles", m,
        messages={"processed_total": None, "by_type": None,
                  "dropped_overflow": int(m["msgs_dropped"]),
                  "dropped_injected": None},
        mb_dropped=int(m["msgs_dropped"]))


# lint: host
def coverage_signature(doc: dict, dir_occupancy: Optional[dict] = None):
    """Project a v1 report (plus optional directory-state occupancy
    counts) onto a small hashable coverage point for analysis/fuzz.py.

    The signature deliberately quantizes: which message types appeared
    at all, which latency buckets are occupied, which core counters are
    nonzero, and the exact directory-state occupancy of the final
    state. Two runs with the same signature exercised the same protocol
    surface; the fuzzer keeps one corpus entry per signature. Not part
    of the report schema — :func:`validate` does not know about it."""
    bt = (doc.get("messages") or {}).get("by_type") or {}
    lat = doc.get("latency_cycles") or {"counts": ()}
    return (doc.get("engine"),
            tuple(int(bool(doc.get(k))) for k in CORE_COUNTERS),
            tuple(sorted(k for k, v in bt.items() if v)),
            tuple(i for i, c in enumerate(lat["counts"]) if c),
            tuple(sorted((dir_occupancy or {}).items())))


# lint: host
def _validate_txn_latency(tl, errs) -> None:
    """Structural check of the optional v1.1 txn_latency block."""
    if not isinstance(tl, dict):
        errs.append("txn_latency must be a dict")
        return
    for k in ("spans", "open"):
        v = tl.get(k)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            errs.append(f"txn_latency.{k} must be a non-negative int, "
                        f"got {v!r}")
    bt = tl.get("by_type")
    if not isinstance(bt, dict):
        errs.append("txn_latency.by_type must be a dict")
    else:
        for t, ent in bt.items():
            if (not isinstance(ent, dict)
                    or any(k not in ent for k in _TXN_TYPE_KEYS)):
                errs.append(f"txn_latency.by_type[{t!r}] must carry "
                            f"{_TXN_TYPE_KEYS}")
    st = tl.get("segments_total")
    if not isinstance(st, dict) or not all(
            isinstance(v, int) and v >= 0 for v in st.values()):
        errs.append("txn_latency.segments_total must be a dict of "
                    "non-negative ints")


# lint: host
def validate(doc: dict) -> dict:
    """Check a report against the schema (v1.2, or v1/v1.1 unchanged
    for backward compatibility); returns the doc, raises ValueError
    listing every violation. Dependency-free on purpose — the
    container has no jsonschema."""
    errs = []
    if not isinstance(doc, dict):
        raise ValueError(f"report must be a dict, got {type(doc).__name__}")
    is_v1 = doc.get("schema") == SCHEMA_V1
    is_v11 = doc.get("schema") == SCHEMA_V1_1
    required = _TOP_KEYS if (is_v1 or is_v11) else (
        _TOP_KEYS + ("mb_dropped",))
    allowed = (_TOP_KEYS if is_v1
               else _TOP_KEYS + _OPT_KEYS if is_v11
               else _TOP_KEYS + _OPT_KEYS + ("mb_dropped",))
    for k in required:
        if k not in doc:
            errs.append(f"missing key: {k}")
    for k in doc:
        if k not in allowed:
            errs.append(f"unknown key: {k}")
    if doc.get("schema") not in (SCHEMA_ID, SCHEMA_V1, SCHEMA_V1_1):
        errs.append(f"schema must be {SCHEMA_ID!r} (or the "
                    f"backward-compatible {SCHEMA_V1!r}/{SCHEMA_V1_1!r}), "
                    f"got {doc.get('schema')!r}")
    if "txn_latency" in doc and not is_v1:
        _validate_txn_latency(doc["txn_latency"], errs)
    if "mb_dropped" in doc:
        v = doc["mb_dropped"]
        if v is not None and (not isinstance(v, int)
                              or isinstance(v, bool) or v < 0):
            errs.append(f"mb_dropped must be None or a non-negative "
                        f"int, got {v!r}")
    if not isinstance(doc.get("engine"), str):
        errs.append("engine must be a string")
    if doc.get("step_unit") not in ("cycles", "rounds"):
        errs.append(f"step_unit must be cycles|rounds, "
                    f"got {doc.get('step_unit')!r}")
    for k in ("steps",) + CORE_COUNTERS:
        v = doc.get(k)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            errs.append(f"{k} must be a non-negative int, got {v!r}")
    msgs = doc.get("messages")
    if not isinstance(msgs, dict):
        errs.append("messages must be a dict")
    else:
        for k in _MSG_KEYS:
            if k not in msgs:
                errs.append(f"messages missing key: {k}")
        for k in ("processed_total", "dropped_overflow",
                  "dropped_injected"):
            v = msgs.get(k)
            if v is not None and (not isinstance(v, int) or v < 0):
                errs.append(f"messages.{k} must be None or "
                            f"non-negative int, got {v!r}")
        bt = msgs.get("by_type")
        if bt is not None:
            if not isinstance(bt, dict) or not all(
                    isinstance(v, int) and v >= 0 for v in bt.values()):
                errs.append("messages.by_type must be None or a dict of "
                            "non-negative ints")
            elif (msgs.get("processed_total") is not None
                  and sum(bt.values()) != msgs["processed_total"]):
                errs.append("messages.by_type does not sum to "
                            "processed_total")
    q = doc.get("queue_depth_peak")
    if q is not None and (not isinstance(q, int) or q < 0):
        errs.append(f"queue_depth_peak must be None or non-negative "
                    f"int, got {q!r}")
    lat = doc.get("latency_cycles")
    if lat is not None:
        if (not isinstance(lat, dict)
                or set(lat) != {"bucket_lo", "counts"}):
            errs.append("latency_cycles must be None or "
                        "{bucket_lo, counts}")
        elif (len(lat["bucket_lo"]) != len(lat["counts"])
              or lat["bucket_lo"] != sorted(set(lat["bucket_lo"]))
              or any(not isinstance(c, int) or c < 0
                     for c in lat["counts"])):
            errs.append("latency_cycles bucket_lo must be strictly "
                        "increasing and counts non-negative ints of "
                        "the same length")
    if not isinstance(doc.get("extra"), dict):
        errs.append("extra must be a dict")
    if errs:
        raise ValueError("invalid metrics report:\n  " + "\n  ".join(errs))
    return doc


# -- serving trace: job-lifecycle spans ------------------------------------

SERVE_TRACE_SCHEMA_ID = "cache-sim/serve-trace/v1"

#: every span field, all always present (Dapper-style lifecycle:
#: submit -> queued -> admitted(wave, slot) -> running -> quiescent ->
#: extracted, assembled host-side by serve.SpanBook under the injected
#: clock). The three segment durations MUST sum exactly to e2e_s —
#: they are computed from the timestamps in one place (SpanBook), so
#: the decomposition holds by construction, and validate_serve_trace
#: re-checks it.
SPAN_KEYS = ("job", "wave", "slot", "quiesced",
             "t_submit", "t_queued", "t_admitted", "t_running",
             "t_quiescent", "t_extracted",
             "queue_wait_s", "run_s", "extract_s", "e2e_s")

#: optional span fields: the daemon's tenancy annotations
#: (daemon/core.py stamps them via SpanBook.annotate) — ``lane`` is
#: the priority lane the job was admitted from, ``bucket`` the shape
#: bucket label it ran in. serve/soak spans omit both; anything else
#: unknown is still rejected.
_SPAN_OPT_KEYS = ("lane", "bucket")

#: the lifecycle timestamps in causal order (monotone per span)
_SPAN_TS_ORDER = ("t_submit", "t_queued", "t_admitted", "t_running",
                  "t_quiescent", "t_extracted")

_TRACE_TOP_KEYS = ("schema", "clock", "jobs", "latency", "spans")


# lint: host
def _validate_span(i: int, s, errs) -> None:
    if not isinstance(s, dict):
        errs.append(f"span {i}: not a dict")
        return
    for k in SPAN_KEYS:
        if k not in s:
            errs.append(f"span {i}: missing key {k}")
            return
    for k in set(s) - set(SPAN_KEYS) - set(_SPAN_OPT_KEYS):
        errs.append(f"span {i}: unknown key {k}")
    for k in _SPAN_OPT_KEYS:
        if k in s and (not isinstance(s[k], str) or not s[k]):
            errs.append(f"span {i}: {k} must be a non-empty string, "
                        f"got {s[k]!r}")
    if not isinstance(s["job"], str) or not s["job"]:
        errs.append(f"span {i}: job must be a non-empty string")
    for k in ("wave", "slot"):
        v = s[k]
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            errs.append(f"span {i}: {k} must be a non-negative int, "
                        f"got {v!r}")
    if not isinstance(s["quiesced"], bool):
        errs.append(f"span {i}: quiesced must be bool")
    ts = []
    for k in _SPAN_TS_ORDER:
        v = s[k]
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            errs.append(f"span {i}: {k} must be a number, got {v!r}")
            return
        ts.append(float(v))
    if any(b < a for a, b in zip(ts, ts[1:])):
        errs.append(f"span {i} ({s['job']}): lifecycle timestamps not "
                    f"monotone: {list(zip(_SPAN_TS_ORDER, ts))}")
    for k in ("queue_wait_s", "run_s", "extract_s", "e2e_s"):
        v = s[k]
        if (not isinstance(v, (int, float)) or isinstance(v, bool)
                or v < 0):
            errs.append(f"span {i}: {k} must be a non-negative number, "
                        f"got {v!r}")
            return
    if s["e2e_s"] != s["queue_wait_s"] + s["run_s"] + s["extract_s"]:
        errs.append(f"span {i} ({s['job']}): e2e_s != queue_wait_s + "
                    f"run_s + extract_s (the decomposition must hold "
                    f"exactly, by construction)")


# lint: host
def validate_serve_trace(doc: dict) -> dict:
    """Structural check of a ``cache-sim/serve-trace/v1`` doc
    (serve.serve_trace_doc / the soak harness): schema id, clock kind,
    per-span lifecycle monotonicity, and the exact span decomposition
    invariant. Same contract as :func:`validate`."""
    errs = []
    if not isinstance(doc, dict):
        raise ValueError(f"trace must be a dict, got {type(doc).__name__}")
    if doc.get("schema") != SERVE_TRACE_SCHEMA_ID:
        errs.append(f"schema must be {SERVE_TRACE_SCHEMA_ID!r}, "
                    f"got {doc.get('schema')!r}")
    for k in _TRACE_TOP_KEYS:
        if k not in doc:
            errs.append(f"missing key: {k}")
    for k in doc:
        if k not in _TRACE_TOP_KEYS:
            errs.append(f"unknown key: {k}")
    if doc.get("clock") not in ("monotonic", "virtual"):
        errs.append(f"clock must be monotonic|virtual, "
                    f"got {doc.get('clock')!r}")
    spans = doc.get("spans")
    if not isinstance(spans, list):
        errs.append("spans must be a list")
        spans = []
    if doc.get("jobs") != len(spans):
        errs.append(f"jobs ({doc.get('jobs')!r}) != len(spans) "
                    f"({len(spans)})")
    for i, s in enumerate(spans):
        _validate_span(i, s, errs)
    lat = doc.get("latency")
    if lat is not None:
        if not isinstance(lat, dict):
            errs.append("latency must be None or a dict")
        else:
            ps = [lat.get(k) for k in ("p50_ms", "p95_ms", "p99_ms")]
            if any(not isinstance(p, (int, float))
                   or isinstance(p, bool) or p < 0 for p in ps):
                errs.append("latency p50_ms/p95_ms/p99_ms must be "
                            "non-negative numbers")
            elif not ps[0] <= ps[1] <= ps[2]:
                errs.append(f"latency percentiles not monotone: {ps}")
    if errs:
        raise ValueError("invalid serve trace:\n  " + "\n  ".join(errs))
    return doc


# -- serving daemon: stats snapshot ----------------------------------------

DAEMON_STATS_SCHEMA_ID = "cache-sim/daemon-stats/v1"

#: required top-level keys of a daemon ``stats`` response
#: (daemon/core.DaemonCore.stats) — one point-in-time snapshot of the
#: admission queues, shape buckets, and padding accounting
_DAEMON_TOP_KEYS = ("schema", "clock", "uptime_s", "draining", "jobs",
                    "lanes", "buckets", "chunks", "busy_s",
                    "drain_rate_jobs_per_s", "mb_dropped",
                    "mid_wave_swaps", "bucket_growths",
                    "queue_depth_peak", "retain_results",
                    "results_evicted", "recording", "padding_waste",
                    "single_shape_padding_waste")

#: the live-capture counters a recording daemon reports (``recording``
#: is None when ``--record`` is off): the artifact path plus exact
#: lifetime row counts — ``submits`` accepted submissions streamed,
#: ``results`` digest rows written (obs.recording)
_DAEMON_RECORDING_KEYS = ("path", "submits", "results")

_DAEMON_JOB_KEYS = ("submitted", "rejected", "done", "quiesced")

_DAEMON_LANE_KEYS = ("weight", "depth", "queued", "submitted",
                     "admitted", "rejected", "done", "latency")

_DAEMON_BUCKET_KEYS = ("bucket", "protocol", "nodes", "trace_len",
                       "slots", "busy", "admitted", "chunks")


# lint: host
def validate_daemon_stats(doc: dict) -> dict:
    """Structural check of a ``cache-sim/daemon-stats/v1`` snapshot
    (the daemon ``stats`` socket op). Same contract as :func:`validate`:
    raises ValueError listing every violation, returns the doc."""
    errs = []
    if not isinstance(doc, dict):
        raise ValueError(f"stats must be a dict, got {type(doc).__name__}")
    if doc.get("schema") != DAEMON_STATS_SCHEMA_ID:
        errs.append(f"schema must be {DAEMON_STATS_SCHEMA_ID!r}, "
                    f"got {doc.get('schema')!r}")
    for k in _DAEMON_TOP_KEYS:
        if k not in doc:
            errs.append(f"missing key: {k}")
    if doc.get("clock") not in ("monotonic", "virtual"):
        errs.append(f"clock must be monotonic|virtual, "
                    f"got {doc.get('clock')!r}")
    jobs = doc.get("jobs")
    if not isinstance(jobs, dict):
        errs.append("jobs must be a dict")
    else:
        for k in _DAEMON_JOB_KEYS:
            v = jobs.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"jobs.{k} must be a non-negative int, "
                            f"got {v!r}")
    lanes = doc.get("lanes")
    if not isinstance(lanes, dict) or not lanes:
        errs.append("lanes must be a non-empty dict")
    else:
        for name, lane in lanes.items():
            if not isinstance(lane, dict):
                errs.append(f"lane {name}: not a dict")
                continue
            for k in _DAEMON_LANE_KEYS:
                if k not in lane:
                    errs.append(f"lane {name}: missing key {k}")
    buckets = doc.get("buckets")
    if not isinstance(buckets, list):
        errs.append("buckets must be a list")
    else:
        for i, b in enumerate(buckets):
            if not isinstance(b, dict):
                errs.append(f"bucket {i}: not a dict")
                continue
            for k in _DAEMON_BUCKET_KEYS:
                if k not in b:
                    errs.append(f"bucket {i}: missing key {k}")
    for k in ("padding_waste", "single_shape_padding_waste"):
        v = doc.get(k)
        if v is not None and (not isinstance(v, (int, float))
                              or isinstance(v, bool)
                              or not 0.0 <= float(v) <= 1.0):
            errs.append(f"{k} must be None or in [0, 1], got {v!r}")
    rec = doc.get("recording")
    if rec is not None:
        if not isinstance(rec, dict):
            errs.append("recording must be None or a dict "
                        f"{{{', '.join(_DAEMON_RECORDING_KEYS)}}}")
        else:
            for k in _DAEMON_RECORDING_KEYS:
                if k not in rec:
                    errs.append(f"recording: missing key {k}")
            for k in ("submits", "results"):
                v = rec.get(k)
                if (not isinstance(v, int) or isinstance(v, bool)
                        or v < 0):
                    errs.append(f"recording.{k} must be a "
                                f"non-negative int, got {v!r}")
    # -- live-ops-plane additions, validated WHEN PRESENT: a pre-ops
    # v1 doc (no stats_seq/hist/events) keeps validating unchanged,
    # the backcompat matrix in tests/test_ops_plane.py pins both ways
    v = doc.get("uptime_s")
    if v is not None and (not isinstance(v, (int, float))
                          or isinstance(v, bool) or v < 0):
        errs.append(f"uptime_s must be a non-negative number, got {v!r}")
    for k in ("stats_seq", "slo_alerts"):
        if k in doc:
            v = doc[k]
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"{k} must be a non-negative int, "
                            f"got {v!r}")
    if isinstance(lanes, dict):
        for name, lane in lanes.items():
            hist = lane.get("hist") if isinstance(lane, dict) else None
            if hist is None:
                continue
            h_errs = _hist_errs(hist, f"lane {name}: hist")
            errs.extend(h_errs)
    ev = doc.get("events")
    if ev is not None:
        if not isinstance(ev, dict):
            errs.append("events must be None or a dict "
                        "{path, ring, seq, dropped}")
        else:
            for k in ("ring", "seq", "dropped"):
                v = ev.get(k)
                if (not isinstance(v, int) or isinstance(v, bool)
                        or v < 0):
                    errs.append(f"events.{k} must be a non-negative "
                                f"int, got {v!r}")
    prof = doc.get("profile")
    if prof is not None:
        # validate-when-present: a coherence-profile doc (obs.cohprof)
        # attached by a daemon running with profiling on
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import cohprof
        try:
            cohprof.validate(prof)
        except ValueError as e:
            errs.append(f"profile: {e}")
    if errs:
        raise ValueError("invalid daemon stats:\n  " + "\n  ".join(errs))
    return doc


# lint: host
def _hist_errs(hist, where: str) -> list:
    """Structural errors of one mergeable-histogram doc
    (obs.timeseries.LogHistogram.to_doc): counts must be one longer
    than edges (the overflow bucket) and their total must equal
    ``count`` — the invariant the exact fleet merge relies on."""
    if not isinstance(hist, dict):
        return [f"{where}: must be None or a dict"]
    errs = []
    edges = hist.get("edges_ms")
    counts = hist.get("counts")
    if (not isinstance(edges, list) or not edges
            or any(not isinstance(e, (int, float)) or isinstance(e, bool)
                   for e in edges)
            or any(b <= a for a, b in zip(edges, edges[1:]))):
        errs.append(f"{where}: edges_ms must be a strictly increasing "
                    f"number list")
    if (not isinstance(counts, list)
            or any(not isinstance(c, int) or isinstance(c, bool) or c < 0
                   for c in counts)):
        errs.append(f"{where}: counts must be a list of non-negative "
                    f"ints")
    elif isinstance(edges, list) and len(counts) != len(edges) + 1:
        errs.append(f"{where}: counts must have len(edges_ms) + 1 "
                    f"entries (the overflow bucket), got {len(counts)} "
                    f"for {len(edges)} edges")
    n = hist.get("count")
    if not isinstance(n, int) or isinstance(n, bool) or n < 0:
        errs.append(f"{where}: count must be a non-negative int")
    elif isinstance(counts, list) and all(
            isinstance(c, int) and not isinstance(c, bool) and c >= 0
            for c in counts) and sum(counts) != n:
        errs.append(f"{where}: count ({n}) != sum(counts) "
                    f"({sum(counts)})")
    s = hist.get("sum_ms")
    if (not isinstance(s, (int, float)) or isinstance(s, bool)
            or s < 0):
        errs.append(f"{where}: sum_ms must be a non-negative number")
    return errs


# -- fleet view: N replicas' stats merged -----------------------------------

FLEET_SCHEMA_ID = "cache-sim/fleet/v1"

#: required top-level keys of a fleet doc (obs.fleet.merge_stats):
#: lifetime counters are EXACT sums over the replicas, gauges are the
#: fleet-meaningful reduction (max uptime, peak depth, any draining)
_FLEET_TOP_KEYS = ("schema", "replicas", "jobs", "lanes", "buckets",
                   "chunks", "busy_s", "drain_rate_jobs_per_s",
                   "mb_dropped", "mid_wave_swaps", "bucket_growths",
                   "results_evicted", "slo_alerts", "uptime_s",
                   "queue_depth_peak", "draining", "per_replica")


# lint: host
def validate_fleet(doc: dict) -> dict:
    """Structural check of a ``cache-sim/fleet/v1`` merged stats doc
    (the ``cache-sim top`` aggregator). Same contract as
    :func:`validate_daemon_stats`."""
    errs = []
    if not isinstance(doc, dict):
        raise ValueError(f"fleet doc must be a dict, "
                         f"got {type(doc).__name__}")
    if doc.get("schema") != FLEET_SCHEMA_ID:
        errs.append(f"schema must be {FLEET_SCHEMA_ID!r}, "
                    f"got {doc.get('schema')!r}")
    for k in _FLEET_TOP_KEYS:
        if k not in doc:
            errs.append(f"missing key: {k}")
    n = doc.get("replicas")
    if not isinstance(n, int) or isinstance(n, bool) or n < 1:
        errs.append(f"replicas must be a positive int, got {n!r}")
    jobs = doc.get("jobs")
    if not isinstance(jobs, dict):
        errs.append("jobs must be a dict")
    else:
        for k in _DAEMON_JOB_KEYS:
            v = jobs.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errs.append(f"jobs.{k} must be a non-negative int, "
                            f"got {v!r}")
    lanes = doc.get("lanes")
    if not isinstance(lanes, dict):
        errs.append("lanes must be a dict")
    else:
        for name, lane in lanes.items():
            if not isinstance(lane, dict):
                errs.append(f"lane {name}: not a dict")
                continue
            for k in ("queued", "submitted", "admitted", "rejected",
                      "done"):
                v = lane.get(k)
                if (not isinstance(v, int) or isinstance(v, bool)
                        or v < 0):
                    errs.append(f"lane {name}: {k} must be a "
                                f"non-negative int, got {v!r}")
            if lane.get("hist") is not None:
                errs.extend(_hist_errs(lane["hist"],
                                       f"lane {name}: hist"))
    per = doc.get("per_replica")
    if not isinstance(per, list) or (isinstance(n, int)
                                     and not isinstance(n, bool)
                                     and len(per or []) != n):
        errs.append("per_replica must be a list with one row per "
                    "replica")
    else:
        for i, row in enumerate(per):
            if not isinstance(row, dict) or "replica" not in row:
                errs.append(f"per_replica[{i}]: must be a dict with "
                            f"a 'replica' label")
    if errs:
        raise ValueError("invalid fleet doc:\n  " + "\n  ".join(errs))
    return doc
