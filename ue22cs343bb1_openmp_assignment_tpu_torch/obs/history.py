"""Bench history: the append-only record behind ``cache-sim bench-diff``.

Before this module the repo's performance memory lived in loose
``BENCH_r*.json`` round captures that nothing parsed, and PERF.md
argued each round's delta by hand. This module gives every benchmark
capture one schema'd home — a JSONL file of ``cache-sim/bench/v1``
entries carrying the FULL rep-time vector (the noise information the
headline median throws away), a config fingerprint (so apples are only
compared to apples), and the git sha — and adapters from both capture
sources:

- ``bench.py --record PATH`` appends the run it just measured;
- :func:`ingest_capture` lifts an archived round capture
  (``BENCH_r*.json``: ``{"n", "cmd", "rc", "tail", "parsed"}``) or a
  raw two-line ``bench.py`` output file into the same schema.

The statistical comparator over these entries lives in
:mod:`obs.regress`; this module is storage + validation only.
Host-side by construction; dependency-free like obs.schema.

The port's copy of the JAX package's ``obs/history.py``, unchanged
apart from the name it gives the archived captures (round captures).
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import List, Optional

SCHEMA_ID = "cache-sim/bench/v1.4"

#: older schema ids; validate_entry accepts docs under any of these,
#: with only the optional keys their version introduced
SCHEMA_V1 = "cache-sim/bench/v1"
SCHEMA_V11 = "cache-sim/bench/v1.1"
SCHEMA_V12 = "cache-sim/bench/v1.2"
SCHEMA_V13 = "cache-sim/bench/v1.3"

#: entry keys, all always present (None marks "not captured")
_TOP_KEYS = ("schema", "label", "source", "captured_at", "git_sha",
             "metric", "unit", "value", "vs_baseline", "config",
             "rep_times_s", "elapsed_s", "steps", "retired",
             "quiescent", "phases")

#: v1.1 added the comparability keys (bench-diff refuses to compare
#: rep times across devices); v1.2 added the deterministic cost
#: vector (obs.roofline.cost_vector — the --bytes gate's input);
#: v1.3 added the serving block ({slots, jobs, waves, padding_waste}
#: from bench.py --serve — the jobs/sec rows next to the instrs/sec
#: headline); v1.4 added the latency block (p50/p95/p99 job latency
#: + raw samples_ms from the open-loop soak harness, bench.py --soak —
#: what bench-diff --latency adjudicates).
#: Optional: absent and None both mean "not captured".
_OPT_KEYS_V11 = ("device_kind", "hlo_fingerprint")
_OPT_KEYS_V12 = _OPT_KEYS_V11 + ("cost",)
_OPT_KEYS_V13 = _OPT_KEYS_V12 + ("serve",)
_OPT_KEYS_V14 = _OPT_KEYS_V13 + ("latency",)

#: required fields of a serve block (ints except padding_waste);
#: optional extras "devices" (batch-mesh width of the wave) and
#: "mb_dropped" (summed mailbox overflow drops, quirk 6) ride the
#: same block — absent in pre-multi-device captures, no schema bump
_SERVE_KEYS = ("slots", "jobs", "waves", "padding_waste")
_SERVE_OPT_KEYS = ("devices", "mb_dropped")
#: optional serve transport: "inproc" (serve/soak in-process
#: waves) or "daemon" (the soak stream went over the daemon's
#: socket front door); absent in pre-daemon captures
_SERVE_TRANSPORTS = ("inproc", "daemon")

#: required fields of a latency block: the nearest-rank percentiles
#: (ms), the arrival rate the stream was released at (jobs/s — part of
#: comparability: latencies at different offered loads never compare),
#: and the admission-queue depth peak. Optional extras carry the raw
#: per-job sample vector (what regress.compare_latency's Mann-Whitney
#: test runs on) and the soak context.
_LATENCY_KEYS = ("p50_ms", "p95_ms", "p99_ms", "arrival_rate",
                 "queue_depth_peak")
_LATENCY_OPT_KEYS = ("max_ms", "jobs", "samples_ms", "duration_s",
                     "saturated", "drain_rate_jobs_per_s")


# lint: host
def git_sha(repo_dir: Optional[str] = None) -> Optional[str]:
    """Current commit sha, or None outside a work tree / without git."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=repo_dir,
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


# lint: host
def entry(label: str, source: str, result: dict, extra: dict,
          config: Optional[dict] = None, sha: Optional[str] = None,
          captured_at: Optional[str] = None,
          device_kind: Optional[str] = None,
          hlo_fingerprint: Optional[str] = None,
          cost: Optional[dict] = None,
          serve: Optional[dict] = None,
          latency: Optional[dict] = None) -> dict:
    """Build a v1.4 entry from bench.py's two JSON lines.

    ``result`` is the stdout line ({metric, value, unit, vs_baseline});
    ``extra`` is the stderr line (engine, rep_times_s, quiescent, ...).
    ``config`` is the benchmark fingerprint — whatever knobs determined
    the measured computation; the metric string itself is always part
    of the comparability check, so a partial fingerprint degrades
    gracefully for archived captures. ``device_kind`` /
    ``hlo_fingerprint`` make cross-device comparisons detectable;
    ``cost`` is the deterministic roofline cost vector
    (obs.roofline.cost_vector) behind ``bench-diff --bytes``;
    ``serve`` is the batched-serving block ({slots, jobs, waves,
    padding_waste}) attached to jobs/sec rows by ``bench.py --serve``;
    ``latency`` is the open-loop job-latency block ({p50_ms, p95_ms,
    p99_ms, arrival_rate, queue_depth_peak} + the raw samples_ms
    vector) attached by ``bench.py --soak`` — the input of
    ``bench-diff --latency``.
    """
    doc = {
        "schema": SCHEMA_ID,
        "label": str(label),
        "source": str(source),
        "captured_at": captured_at,
        "git_sha": sha,
        "metric": result["metric"],
        "unit": result["unit"],
        "value": float(result["value"]),
        "vs_baseline": float(result.get("vs_baseline", 0.0)),
        "config": dict(config) if config else {"engine": extra.get("engine")},
        "rep_times_s": [float(t) for t in extra.get("rep_times_s", [])],
        "elapsed_s": (float(extra["elapsed_s"])
                      if extra.get("elapsed_s") is not None else None),
        "steps": (int(extra["steps"])
                  if extra.get("steps") is not None else None),
        "retired": (int(extra["retired"])
                    if extra.get("retired") is not None else None),
        "quiescent": (bool(extra["quiescent"])
                      if extra.get("quiescent") is not None else None),
        "phases": extra.get("phases"),
        "device_kind": device_kind,
        "hlo_fingerprint": hlo_fingerprint,
        "cost": cost,
        "serve": serve,
        "latency": latency,
    }
    return validate_entry(doc)


# lint: host
def validate_entry(doc: dict) -> dict:
    """Check an entry against the schema (v1.4, or v1/v1.1/v1.2/v1.3
    unchanged for backward compatibility — an old doc may only carry
    the optional keys its version introduced); returns the doc, raises
    ValueError listing every violation (same contract as
    obs.schema.validate)."""
    errs = []
    if not isinstance(doc, dict):
        raise ValueError(f"entry must be a dict, got {type(doc).__name__}")
    sid = doc.get("schema")
    allowed = _TOP_KEYS + (
        _OPT_KEYS_V14 if sid == SCHEMA_ID
        else _OPT_KEYS_V13 if sid == SCHEMA_V13
        else _OPT_KEYS_V12 if sid == SCHEMA_V12
        else _OPT_KEYS_V11 if sid == SCHEMA_V11 else ())
    for k in _TOP_KEYS:
        if k not in doc:
            errs.append(f"missing key: {k}")
    for k in doc:
        if k not in allowed:
            errs.append(f"unknown key: {k}")
    if sid not in (SCHEMA_ID, SCHEMA_V13, SCHEMA_V12, SCHEMA_V11,
                   SCHEMA_V1):
        errs.append(f"schema must be {SCHEMA_ID!r} (or the "
                    f"backward-compatible {SCHEMA_V13!r}/{SCHEMA_V12!r}"
                    f"/{SCHEMA_V11!r}/{SCHEMA_V1!r}), got {sid!r}")
    for k in _OPT_KEYS_V11:
        v = doc.get(k)
        if v is not None and (not isinstance(v, str) or not v):
            errs.append(f"{k} must be None or a non-empty string")
    cost = doc.get("cost")
    if cost is not None:
        if not isinstance(cost, dict) or not isinstance(
                cost.get("kernels"), dict):
            errs.append("cost must be None or a dict with a 'kernels' "
                        "dict (obs.roofline.cost_vector)")
        else:
            bpi = cost.get("bytes_per_instr")
            if bpi is not None and (
                    not isinstance(bpi, (int, float))
                    or isinstance(bpi, bool) or bpi < 0):
                errs.append("cost.bytes_per_instr must be None or a "
                            f"non-negative number, got {bpi!r}")
    srv = doc.get("serve")
    if srv is not None:
        if not isinstance(srv, dict):
            errs.append("serve must be None or a dict "
                        f"{{{', '.join(_SERVE_KEYS)}}}")
        else:
            for k in ("slots", "jobs", "waves"):
                x = srv.get(k)
                if not isinstance(x, int) or isinstance(x, bool) or x < 0:
                    errs.append(f"serve.{k} must be a non-negative int, "
                                f"got {x!r}")
            pw = srv.get("padding_waste")
            if (not isinstance(pw, (int, float)) or isinstance(pw, bool)
                    or not 0.0 <= pw <= 1.0):
                errs.append("serve.padding_waste must be a number in "
                            f"[0, 1], got {pw!r}")
            for k in _SERVE_OPT_KEYS:
                x = srv.get(k)
                if x is not None and (not isinstance(x, int)
                                      or isinstance(x, bool) or x < 0):
                    errs.append(f"serve.{k} must be None or a "
                                f"non-negative int, got {x!r}")
            tr = srv.get("transport")
            if tr is not None and tr not in _SERVE_TRANSPORTS:
                errs.append("serve.transport must be one of "
                            f"{_SERVE_TRANSPORTS}, got {tr!r}")
    lat = doc.get("latency")
    if lat is not None:
        if not isinstance(lat, dict):
            errs.append("latency must be None or a dict "
                        f"{{{', '.join(_LATENCY_KEYS)}}}")
        else:
            for k in lat:
                if k not in _LATENCY_KEYS + _LATENCY_OPT_KEYS:
                    errs.append(f"latency has unknown key: {k}")
            for k in ("p50_ms", "p95_ms", "p99_ms", "arrival_rate"):
                x = lat.get(k)
                if (not isinstance(x, (int, float))
                        or isinstance(x, bool) or x < 0):
                    errs.append(f"latency.{k} must be a non-negative "
                                f"number, got {x!r}")
            qd = lat.get("queue_depth_peak")
            if (not isinstance(qd, int) or isinstance(qd, bool)
                    or qd < 0):
                errs.append("latency.queue_depth_peak must be a "
                            f"non-negative int, got {qd!r}")
            ps = [lat.get(k) for k in ("p50_ms", "p95_ms", "p99_ms")]
            if (all(isinstance(p, (int, float))
                    and not isinstance(p, bool) for p in ps)
                    and not ps[0] <= ps[1] <= ps[2]):
                errs.append("latency percentiles must be ordered "
                            f"p50 <= p95 <= p99, got {ps}")
            sm = lat.get("samples_ms")
            if sm is not None and (
                    not isinstance(sm, list)
                    or any(not isinstance(x, (int, float))
                           or isinstance(x, bool) or x < 0
                           for x in sm)):
                errs.append("latency.samples_ms must be None or a "
                            "list of non-negative numbers")
    for k in ("label", "source", "metric", "unit"):
        if not isinstance(doc.get(k), str) or not doc.get(k):
            errs.append(f"{k} must be a non-empty string")
    v = doc.get("value")
    if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
        errs.append(f"value must be a non-negative number, got {v!r}")
    reps = doc.get("rep_times_s")
    if (not isinstance(reps, list)
            or any(not isinstance(t, (int, float)) or t <= 0
                   for t in reps)):
        errs.append("rep_times_s must be a list of positive numbers")
    if not isinstance(doc.get("config"), dict):
        errs.append("config must be a dict")
    q = doc.get("quiescent")
    if q is not None and not isinstance(q, bool):
        errs.append("quiescent must be None or bool")
    for k in ("steps", "retired"):
        x = doc.get(k)
        if x is not None and (not isinstance(x, int) or x < 0):
            errs.append(f"{k} must be None or a non-negative int")
    if errs:
        raise ValueError("invalid bench-history entry:\n  "
                         + "\n  ".join(errs))
    return doc


# lint: host
def append(path: str, doc: dict) -> None:
    """Append one validated entry to a JSONL history file."""
    validate_entry(doc)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(doc, sort_keys=True) + "\n")


# lint: host
def load(path: str) -> List[dict]:
    """Load and validate every entry of a JSONL history file (blank
    lines skipped); errors name the offending line."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                out.append(validate_entry(json.loads(line)))
            except ValueError as e:
                raise ValueError(f"{path}:{i}: {e}") from None
    return out


# lint: host
def _json_lines(text: str) -> List[dict]:
    docs = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                docs.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return docs


# lint: host
def ingest_capture(path: str, label: Optional[str] = None) -> dict:
    """Lift an archived capture into a v1 entry.

    Accepts either a round capture (``BENCH_r*.json``: one JSON
    object whose ``tail`` holds bench.py's two output lines and whose
    ``parsed`` duplicates the stderr extra) or a raw file of bench.py
    output lines. The default label is the filename stem (``BENCH_r03``
    -> ``r03``).
    """
    with open(path) as f:
        text = f.read()
    stem = os.path.splitext(os.path.basename(path))[0]
    if label is None:
        label = stem[6:] if stem.startswith("BENCH_") else stem
    result, extra = None, None
    try:
        cap = json.loads(text)
    except json.JSONDecodeError:
        cap = None
    docs = (_json_lines(cap.get("tail", ""))
            if isinstance(cap, dict) and "tail" in cap
            else _json_lines(text))
    if isinstance(cap, dict):
        extra = cap.get("parsed")
    for d in docs:
        if "metric" in d and "value" in d:
            result = d
        elif "rep_times_s" in d:
            extra = d
    if result is None or extra is None:
        raise ValueError(
            f"{path}: no bench result/extra JSON lines found "
            "(expected a BENCH_r*.json round capture or raw bench.py "
            "output)")
    cmd = cap.get("cmd") if isinstance(cap, dict) else None
    cfg = {"engine": extra.get("engine")}
    if cmd:
        cfg["cmd"] = cmd
    return entry(label, os.path.basename(path), result, extra,
                 config=cfg)


# lint: host
def ingest_multichip(path: str, label: Optional[str] = None) -> dict:
    """Lift a MULTICHIP_r*.json dryrun capture into a history entry.

    Multichip captures are *parity* records, not timings: each round's
    dryrun runs the sharded engines against their unsharded twins and
    reports bit-identity plus the largest machine validated. The entry
    therefore carries no rep vector (``rep_times_s=[]`` — bench-diff
    calls it incomparable, by design); its value is the max sharded
    node count proven bit-identical, which is the dashboard's scaling
    curve. The default label prefixes ``mc-`` so bench and multichip
    rows in one history file stay distinguishable.
    """
    import re
    with open(path) as f:
        cap = json.load(f)
    if not isinstance(cap, dict) or "n_devices" not in cap:
        raise ValueError(f"{path}: not a MULTICHIP capture "
                         "(no n_devices key)")
    stem = os.path.splitext(os.path.basename(path))[0]
    if label is None:
        label = ("mc-" + stem[10:] if stem.startswith("MULTICHIP_")
                 else "mc-" + stem)
    tail = cap.get("tail", "") or ""
    # the validated machine sizes appear as "<N>-node" or "<N> nodes"
    # in the dryrun report lines; the largest one is the rung proven
    nodes = [int(m) for m in re.findall(r"(\d+)[- ]nodes?\b", tail)]
    if not nodes:
        raise ValueError(f"{path}: no '<N> nodes' marker in tail — "
                         "cannot place it on the scaling curve")
    doc = {
        "schema": SCHEMA_ID,
        "label": str(label),
        "source": os.path.basename(path),
        "captured_at": None,
        "git_sha": None,
        "metric": "multichip sharded parity: max nodes bit-identical "
                  "to unsharded",
        "unit": "nodes",
        "value": float(max(nodes)),
        "vs_baseline": 0.0,
        "config": {"kind": "multichip",
                   "n_devices": int(cap.get("n_devices", 0)),
                   "ok": bool(cap.get("ok", False)),
                   "skipped": bool(cap.get("skipped", False))},
        "rep_times_s": [],
        "elapsed_s": None,
        "steps": None,
        "retired": None,
        "quiescent": None,
        "phases": None,
        "device_kind": None,
        "hlo_fingerprint": None,
        "cost": None,
        "serve": None,
        "latency": None,
    }
    return validate_entry(doc)


# lint: host
def last_two(path: str) -> tuple:
    """(previous, last) entries of a history file; ValueError when it
    holds fewer than two."""
    hist = load(path)
    if len(hist) < 2:
        raise ValueError(
            f"{path}: need at least 2 entries to diff, have {len(hist)}")
    return hist[-2], hist[-1]
