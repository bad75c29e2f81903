"""Host rendering of the on-device telemetry time-series.

ops.step.run_cycles_telemetry stacks one fixed-shape sample per cycle
on device (counter deltas, per-type dequeues, queue-depth watermarks,
directory occupancy, latency-histogram deltas) — this module turns the
fetched [T, ...] arrays into named JSON-ready series and compact
summaries for ``cache-sim stats --timeseries``.

The serving layer adds a second, host-sampled series family: the soak
harness (soak.py) samples admission-queue depth and slot occupancy at
every scheduler turn; :func:`serve_series` /
:func:`summarize_serve_series` shape those samples the same JSON-ready
way, and :func:`percentile` / :func:`latency_summary` turn a job
latency vector into the p50/p95/p99 block that rides bench history
(obs.history schema v1.4) and the serve-trace doc.

The port's copy of the JAX package's ``obs/timeseries.py``, unchanged apart
from its import paths.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ue22cs343bb1_openmp_assignment_tpu_torch.ops.step import TELEMETRY_COUNTERS
from ue22cs343bb1_openmp_assignment_tpu_torch.types import MSG_NAMES

DIR_STATES = ("EM", "S", "U")


# lint: host
def _np(telem: Dict) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in telem.items()}


# lint: host
def to_series(telem: Dict) -> dict:
    """Fetched telemetry dict → {"cycles": T, "series": {name: [T]
    ints}} with every named channel unpacked (counter deltas by
    counter name, dequeues by message type, occupancy by directory
    state)."""
    t = _np(telem)
    series: Dict[str, list] = {}
    for i, name in enumerate(TELEMETRY_COUNTERS):
        series[name] = t["counters"][:, i].tolist()
    for i, name in enumerate(MSG_NAMES):
        series[f"msgs_{name}"] = t["msgs_processed"][:, i].tolist()
    for i, name in enumerate(DIR_STATES):
        series[f"dir_{name}"] = t["dir_occupancy"][:, i].tolist()
    for key in ("queue_depth_max", "queue_depth_total", "waiting_nodes",
                "msgs_dropped", "msgs_injected_dropped"):
        series[key] = t[key].tolist()
    return {"cycles": int(t["counters"].shape[0]), "series": series}


# lint: host
def summarize(telem: Dict) -> dict:
    """Compact per-channel rollup: totals for deltas, peaks for
    watermarks/gauges — the cheap alternative when the full series
    would be unwieldy."""
    t = _np(telem)
    counters = {name: int(t["counters"][:, i].sum())
                for i, name in enumerate(TELEMETRY_COUNTERS)}
    return {
        "cycles": int(t["counters"].shape[0]),
        "counter_totals": counters,
        "msgs_by_type": {name: int(t["msgs_processed"][:, i].sum())
                         for i, name in enumerate(MSG_NAMES)},
        "queue_depth_peak": int(t["queue_depth_max"].max(initial=0)),
        "queue_depth_total_peak": int(
            t["queue_depth_total"].max(initial=0)),
        "waiting_nodes_peak": int(t["waiting_nodes"].max(initial=0)),
        "dir_occupancy_last": {
            name: int(t["dir_occupancy"][-1, i])
            for i, name in enumerate(DIR_STATES)
        } if t["dir_occupancy"].shape[0] else None,
        "lat_hist_total": t["lat_hist"].sum(axis=0).astype(int).tolist(),
    }


# -- serving-side (host-sampled) series ------------------------------------


# lint: host
def serve_series(samples: Sequence[Tuple[float, int, int]]) -> dict:
    """Soak scheduler samples [(t_s, queue_depth, slots_busy), ...] →
    ``{"samples": n, "series": {"t_s", "queue_depth", "slots_busy"}}``
    — the same named-series shape as :func:`to_series`, but sampled on
    the host at scheduler turns (admission boundaries), not per cycle
    on device."""
    return {
        "samples": len(samples),
        "series": {
            "t_s": [float(t) for t, _, _ in samples],
            "queue_depth": [int(q) for _, q, _ in samples],
            "slots_busy": [int(b) for _, _, b in samples],
        },
    }


# lint: host
def summarize_serve_series(samples: Sequence[Tuple[float, int, int]]) -> dict:
    """Peaks + endpoint of a serve_series sample list (the queue-depth
    numbers the backpressure verdict and the history latency block
    read)."""
    depths = [int(q) for _, q, _ in samples]
    busy = [int(b) for _, _, b in samples]
    return {
        "samples": len(samples),
        "queue_depth_peak": max(depths, default=0),
        "queue_depth_final": depths[-1] if depths else 0,
        "slots_busy_peak": max(busy, default=0),
    }


# lint: host
def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty sample.

    Nearest-rank on purpose: every reported percentile is a latency
    that actually happened to a job, never an interpolated value —
    which also keeps virtual-clock soak docs byte-identical (no
    float interpolation to wobble)."""
    # len(), not truthiness: a numpy sample array would make `not xs`
    # raise the ambiguous-truth error instead of the clear one below
    if len(xs) == 0:
        raise ValueError("percentile of an empty sample: no jobs "
                         "completed, so there is no latency to rank")
    if not 0 <= q <= 100:
        raise ValueError(f"q must be in [0, 100], got {q}")
    s = sorted(xs)
    rank = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[rank - 1])


# lint: host
def latency_summary(lat_s: Sequence[float],
                    arrival_rate: Optional[float] = None,
                    queue_depth_peak: Optional[int] = None) -> Optional[dict]:
    """Job end-to-end latencies (seconds) → the p50/p95/p99 latency
    block (milliseconds) that rides the serve-trace doc and — with
    ``arrival_rate`` / ``queue_depth_peak`` — bench history v1.4.
    None for an empty sample (a soak that released no jobs)."""
    if not len(lat_s):
        return None
    ms: List[float] = [float(x) * 1e3 for x in lat_s]
    doc = {
        "p50_ms": percentile(ms, 50),
        "p95_ms": percentile(ms, 95),
        "p99_ms": percentile(ms, 99),
        "max_ms": max(ms),
        "jobs": len(ms),
    }
    if arrival_rate is not None:
        doc["arrival_rate"] = float(arrival_rate)
    if queue_depth_peak is not None:
        doc["queue_depth_peak"] = int(queue_depth_peak)
    return doc


# -- mergeable latency histogram (the fleet-exact aggregate) ---------------

#: fixed log-spaced latency bucket upper edges in milliseconds —
#: 1 µs .. ~2.2 min doubling, identical for EVERY histogram instance.
#: Fixed on purpose: two replicas' histograms share edges by
#: construction, so a fleet merge is an exact elementwise count sum
#: (never a lossy re-bucketing), and the Prometheus ``le`` label set
#: is stable across the fleet. Each edge is a power of two times an
#: exact binary float, so the doc round-trips JSON byte-identically.
HIST_EDGES_MS = tuple(0.001 * (1 << i) for i in range(28))


class LogHistogram:
    """Streaming latency histogram over :data:`HIST_EDGES_MS`.

    ``counts[i]`` holds samples with ``value <= HIST_EDGES_MS[i]``
    (and above the previous edge); the final extra slot is the
    open-ended overflow bucket. ``count``/``sum_ms`` ride along so
    Prometheus exposition gets ``_count``/``_sum`` for free.
    """

    # lint: host
    def __init__(self):
        self.counts: List[int] = [0] * (len(HIST_EDGES_MS) + 1)
        self.count = 0
        self.sum_ms = 0.0

    # lint: host
    def observe(self, ms: float) -> None:
        ms = float(ms)
        self.count += 1
        self.sum_ms += ms
        for i, edge in enumerate(HIST_EDGES_MS):
            if ms <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    # lint: host
    def to_doc(self) -> dict:
        return {"edges_ms": list(HIST_EDGES_MS),
                "counts": list(self.counts),
                "count": self.count, "sum_ms": self.sum_ms}


# lint: host
def merge_hist_docs(docs: Sequence[dict]) -> Optional[dict]:
    """Exact cross-replica merge of :class:`LogHistogram` docs:
    identical fixed edges → the merged histogram is the elementwise
    count sum (the fleet aggregator's per-lane latency view). Raises
    on mismatched edges; None when no doc survives filtering."""
    docs = [d for d in docs if d]
    if not docs:
        return None
    edges = docs[0]["edges_ms"]
    counts = [0] * len(docs[0]["counts"])
    count = 0
    sum_ms = 0.0
    for d in docs:
        if d["edges_ms"] != edges or len(d["counts"]) != len(counts):
            raise ValueError("histogram docs have mismatched bucket "
                             "edges — refusing a lossy merge")
        for i, c in enumerate(d["counts"]):
            counts[i] += int(c)
        count += int(d["count"])
        sum_ms += float(d["sum_ms"])
    return {"edges_ms": list(edges), "counts": counts,
            "count": count, "sum_ms": sum_ms}


# lint: host
def lane_latency_summaries(spans: Sequence[dict]) -> Dict[str, dict]:
    """Job-lifecycle spans → one :func:`latency_summary` block per
    priority lane (the daemon's per-tenant latency metrics). Spans
    without a ``lane`` annotation (serve/soak single-tenant runs)
    group under ``"default"``; lanes sort lexicographically so the
    dict is deterministic under a VirtualClock."""
    by_lane: Dict[str, List[float]] = {}
    for s in spans:
        by_lane.setdefault(s.get("lane") or "default", []).append(
            float(s["e2e_s"]))
    return {lane: latency_summary(lat)
            for lane, lat in sorted(by_lane.items())}
