"""Prometheus text exposition of the daemon-stats snapshot.

``render`` turns one validated ``cache-sim/daemon-stats/v1`` doc (or
the ``cache-sim/fleet/v1`` merge, which shares the counter names)
into Prometheus text format 0.0.4: ``# HELP``/``# TYPE`` headers,
``cache_sim_``-prefixed counters and gauges, lane/bucket-labeled
series, and per-lane latency histograms with cumulative ``le``
buckets derived from the fixed-log-bucket histogram docs
(obs.timeseries.LogHistogram — fixed edges, so every replica exposes
the same ``le`` label set and a Prometheus ``sum by (le)`` over the
fleet is exact).

Pure dict → str, byte-deterministic for a byte-identical input doc
(sorted lanes/buckets, JSON float formatting): the promexpo golden in
tests/test_ops_plane.py pins the rendering.

Host-side and dependency-free: the future fleet router serves this
over HTTP without ever importing torch or the engines.

The port's copy of the JAX package's ``obs/promexpo.py``, unchanged apart from its import paths.
"""
# lint: host

from __future__ import annotations

import json
from typing import List, Optional

PREFIX = "cache_sim"

#: (stats key, metric suffix, type, help) for the scalar top-level
#: series; counters get the conventional ``_total`` suffix
_SCALARS = (
    ("uptime_s", "uptime_seconds", "gauge",
     "Seconds since the daemon core started (its injected clock)."),
    ("stats_seq", "stats_seq", "counter",
     "Monotonic stats-snapshot sequence number."),
    ("chunks", "chunks_total", "counter",
     "Wave chunks executed across all buckets."),
    ("busy_s", "busy_seconds_total", "counter",
     "Seconds spent running wave chunks."),
    ("mb_dropped", "mb_dropped_total", "counter",
     "Mailbox messages silently dropped inside simulated machines."),
    ("mid_wave_swaps", "mid_wave_swaps_total", "counter",
     "Jobs admitted into a wave other slots were mid-flight in."),
    ("bucket_growths", "bucket_growths_total", "counter",
     "Idle shape buckets grown to cover a new job shape."),
    ("results_evicted", "results_evicted_total", "counter",
     "Terminal job payloads evicted by result retention."),
    ("slo_alerts", "slo_alerts_total", "counter",
     "Burn-rate SLO alerts injected into the event stream."),
    ("queue_depth_peak", "queue_depth_peak", "gauge",
     "Peak total admission-queue depth observed."),
    ("draining", "draining", "gauge",
     "1 when the daemon has stopped admitting (drain), else 0."),
)

_JOB_COUNTERS = (
    ("submitted", "Jobs accepted into a lane queue."),
    ("rejected", "Jobs rejected by backpressure or drain."),
    ("done", "Jobs run to extraction."),
    ("quiesced", "Done jobs that reached quiescence."),
)

_LANE_SERIES = (
    ("queued", "gauge", "Jobs waiting in the lane queue."),
    ("submitted", "counter", "Jobs accepted into this lane."),
    ("admitted", "counter", "Jobs admitted from this lane into slots."),
    ("rejected", "counter", "Jobs rejected from this lane."),
    ("done", "counter", "Jobs from this lane run to extraction."),
)

_BUCKET_SERIES = (
    ("busy", "gauge", "Slots currently occupied in this bucket."),
    ("admitted", "counter", "Jobs ever admitted into this bucket."),
    ("chunks", "counter", "Wave chunks this bucket has run."),
)


# lint: host
def _num(v) -> str:
    """Prometheus sample value: ints bare, floats via JSON (repr-
    faithful, so a byte-identical doc renders byte-identically)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return json.dumps(float(v))


# lint: host
def _labels(**kv) -> str:
    if not kv:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(kv.items()))
    return "{" + inner + "}"


# lint: host
def _head(out: List[str], name: str, mtype: str, help_: str) -> None:
    out.append(f"# HELP {name} {help_}")
    out.append(f"# TYPE {name} {mtype}")


# lint: host
def _hist_lines(out: List[str], name: str, hist: dict,
                **labels) -> None:
    """One LogHistogram doc → cumulative ``le`` bucket lines plus
    ``_sum``/``_count`` (the Prometheus histogram convention; the
    stored counts are per-bucket, so cumulate here)."""
    cum = 0
    for edge, c in zip(hist["edges_ms"], hist["counts"]):
        cum += int(c)
        out.append(f"{name}_bucket"
                   f"{_labels(le=_num(float(edge)), **labels)} {cum}")
    cum += int(hist["counts"][-1])
    out.append(f'{name}_bucket{_labels(le="+Inf", **labels)} {cum}')
    out.append(f"{name}_sum{_labels(**labels)} "
               f"{_num(float(hist['sum_ms']))}")
    out.append(f"{name}_count{_labels(**labels)} "
               f"{_num(int(hist['count']))}")


# lint: host
def render(stats: dict) -> str:
    """One daemon-stats (or fleet) doc → Prometheus text exposition.
    Keys the doc does not carry are skipped, never invented, so the
    same renderer serves v1 docs from before ``stats_seq`` existed."""
    out: List[str] = []

    jobs = stats.get("jobs") or {}
    for key, help_ in _JOB_COUNTERS:
        if key not in jobs:
            continue
        name = f"{PREFIX}_jobs_{key}_total"
        _head(out, name, "counter", help_)
        out.append(f"{name} {_num(jobs[key])}")

    for key, suffix, mtype, help_ in _SCALARS:
        if key not in stats or stats[key] is None:
            continue
        name = f"{PREFIX}_{suffix}"
        _head(out, name, mtype, help_)
        out.append(f"{name} {_num(stats[key])}")

    for key, help_ in (("padding_waste",
                        "Fraction of the slot instruction budget "
                        "spent on padding."),
                       ("single_shape_padding_waste",
                        "Counterfactual padding waste of a single "
                        "max-shape slot class.")):
        v = stats.get(key)
        if v is None:
            continue
        name = f"{PREFIX}_{key}"
        _head(out, name, "gauge", help_)
        out.append(f"{name} {_num(float(v))}")

    lanes = stats.get("lanes") or {}
    for key, mtype, help_ in _LANE_SERIES:
        rows = [(lane, ln[key]) for lane, ln in sorted(lanes.items())
                if key in ln]
        if not rows:
            continue
        suffix = "_total" if mtype == "counter" else ""
        name = f"{PREFIX}_lane_{key}{suffix}"
        _head(out, name, mtype, help_)
        for lane, v in rows:
            out.append(f"{name}{_labels(lane=lane)} {_num(v)}")

    hists = [(lane, ln.get("hist"))
             for lane, ln in sorted(lanes.items()) if ln.get("hist")]
    if hists:
        name = f"{PREFIX}_job_latency_ms"
        _head(out, name, "histogram",
              "End-to-end job latency per lane (fixed log buckets, "
              "exactly summable across replicas).")
        for lane, hist in hists:
            _hist_lines(out, name, hist, lane=lane)

    buckets = stats.get("buckets") or []
    for key, mtype, help_ in _BUCKET_SERIES:
        rows = [(b, b[key]) for b in buckets if key in b]
        if not rows:
            continue
        suffix = "_total" if mtype == "counter" else ""
        name = f"{PREFIX}_bucket_{key}{suffix}"
        _head(out, name, mtype, help_)
        for b, v in rows:
            labels = {"bucket": b.get("bucket", "?")}
            if b.get("replica") is not None:
                labels["replica"] = b["replica"]
            out.append(f"{name}{_labels(**labels)} {_num(v)}")

    return "\n".join(out) + "\n"


# lint: host
def write(path, stats: dict) -> Optional[str]:
    """Render to a file (the node-exporter textfile-collector shape);
    returns the text."""
    text = render(stats)
    with open(str(path), "w") as f:
        f.write(text)
    return text
