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

Not copied yet: the serving-trace, daemon-stats and fleet validators
(``validate_serve_trace``, ``validate_daemon_stats``, ``validate_fleet``)
of the JAX module. They belong with the serving and observability
planes (ROADMAP.md, Queue 1 items 4 and 5).
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
