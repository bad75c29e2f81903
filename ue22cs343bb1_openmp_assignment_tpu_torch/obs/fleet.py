"""Fleet view: N replicas' stats merged into one validated doc.

ROADMAP item 2's fleet is "N daemon replicas behind a thin router,
per-replica stats aggregated into one fleet view" — this module is
that aggregation, landed before the router exists: ``merge_stats``
folds N ``cache-sim/daemon-stats/v1`` snapshots into one
``cache-sim/fleet/v1`` doc, and ``main`` is the ``cache-sim top ADDR
[ADDR ...]`` CLI that polls live daemons for it.

The merge is EXACT, not approximate: lifetime counters (jobs, lane
totals, chunks, busy_s, evictions, alerts) are integer/float sums;
per-lane latency histograms share the fixed edge set
(obs.timeseries.HIST_EDGES_MS), so the fleet histogram is an
elementwise count sum — never a lossy re-bucketing. Gauges reduce the
only way that is fleet-meaningful: ``uptime_s`` is the oldest
replica, ``queue_depth_peak`` the worst replica, ``draining`` true if
ANY replica is draining. Buckets keep their per-replica identity (two
replicas' "mesi:8x64" classes are different compiled programs) and
are tagged with the replica label instead of summed.

Everything here is host-side and torch-free (socket + json + dicts):
the future router imports this module, so it is a torch-free
target like daemon/server.py. The histogram merge is therefore a
small inline re-statement of obs.timeseries.merge_hist_docs —
timeseries transitively imports the accelerator runtime and must not
be imported from here.

The port's copy of the JAX package's ``obs/fleet.py``, unchanged apart from its import paths and its program name.
"""
# lint: host

from __future__ import annotations

import json
import sys
import time
from typing import List, Optional, Sequence

from ue22cs343bb1_openmp_assignment_tpu_torch.obs import schema

#: counters summed exactly across replicas at the doc top level
_SUM_KEYS = ("chunks", "busy_s", "mb_dropped", "mid_wave_swaps",
             "bucket_growths", "results_evicted", "slo_alerts")

_LANE_SUM_KEYS = ("queued", "submitted", "admitted", "rejected",
                  "done")


# lint: host
def _merge_hists(docs: Sequence[Optional[dict]]) -> Optional[dict]:
    """Exact elementwise merge of LogHistogram docs (the inline
    torch-free twin of obs.timeseries.merge_hist_docs — same contract,
    same refusal on mismatched edges)."""
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
def merge_stats(stats_docs: Sequence[dict],
                labels: Optional[Sequence[str]] = None) -> dict:
    """N per-replica stats docs → one validated fleet doc.

    ``labels`` names each replica (defaults to ``r0..rN-1``; the CLI
    passes the address). Counters are exact sums; the per-replica
    provenance rides in ``per_replica`` so nothing is lost in the
    fold."""
    if not stats_docs:
        raise ValueError("fleet merge needs at least one stats doc")
    if labels is None:
        labels = [f"r{i}" for i in range(len(stats_docs))]
    if len(labels) != len(stats_docs):
        raise ValueError(f"{len(labels)} labels for "
                         f"{len(stats_docs)} stats docs")
    for i, s in enumerate(stats_docs):
        schema.validate_daemon_stats(s)

    jobs = {k: sum(int(s["jobs"][k]) for s in stats_docs)
            for k in ("submitted", "rejected", "done", "quiesced")}

    lane_names = sorted({name for s in stats_docs
                         for name in s["lanes"]})
    lanes = {}
    for name in lane_names:
        rows = [s["lanes"][name] for s in stats_docs
                if name in s["lanes"]]
        lane = {k: sum(int(r[k]) for r in rows)
                for k in _LANE_SUM_KEYS}
        lane["replicas"] = len(rows)
        lane["hist"] = _merge_hists([r.get("hist") for r in rows])
        lanes[name] = lane

    buckets = []
    for label, s in zip(labels, stats_docs):
        for b in s["buckets"]:
            buckets.append({**b, "replica": label})

    sums = {k: sum(s.get(k) or 0 for s in stats_docs)
            for k in _SUM_KEYS}
    busy_s = float(sums["busy_s"])
    doc = {
        "schema": schema.FLEET_SCHEMA_ID,
        "replicas": len(stats_docs),
        "jobs": jobs,
        "lanes": lanes,
        "buckets": buckets,
        "chunks": int(sums["chunks"]),
        "busy_s": busy_s,
        "drain_rate_jobs_per_s": (jobs["done"] / busy_s
                                  if busy_s > 0 else 0.0),
        "mb_dropped": int(sums["mb_dropped"]),
        "mid_wave_swaps": int(sums["mid_wave_swaps"]),
        "bucket_growths": int(sums["bucket_growths"]),
        "results_evicted": int(sums["results_evicted"]),
        "slo_alerts": int(sums["slo_alerts"]),
        "uptime_s": max(float(s["uptime_s"]) for s in stats_docs),
        "queue_depth_peak": max(int(s["queue_depth_peak"])
                                for s in stats_docs),
        "draining": any(s["draining"] for s in stats_docs),
        "per_replica": [
            {
                "replica": label,
                "clock": s["clock"],
                "stats_seq": s.get("stats_seq"),
                "uptime_s": s["uptime_s"],
                "jobs": dict(s["jobs"]),
                "queued": sum(int(ln["queued"])
                              for ln in s["lanes"].values()),
                "chunks": s["chunks"],
                "draining": s["draining"],
                "slo_alerts": s.get("slo_alerts", 0),
            }
            for label, s in zip(labels, stats_docs)
        ],
    }
    return schema.validate_fleet(doc)


# lint: host
def render_top(doc: dict) -> str:
    """The fleet doc as the ``top``-style text block (one line per
    replica, one totals line)."""
    out = []
    out.append(f"fleet: {doc['replicas']} replica(s)  "
               f"up={doc['uptime_s']:.3f}s  "
               f"draining={'yes' if doc['draining'] else 'no'}")
    hdr = (f"{'REPLICA':<28} {'SEQ':>5} {'UP(S)':>9} {'QUEUED':>6} "
           f"{'DONE':>6} {'REJ':>5} {'CHUNKS':>7} {'ALERTS':>6}")
    out.append(hdr)
    for r in doc["per_replica"]:
        seq = r.get("stats_seq")
        out.append(f"{r['replica']:<28} "
                   f"{'-' if seq is None else seq:>5} "
                   f"{r['uptime_s']:>9.3f} {r['queued']:>6} "
                   f"{r['jobs']['done']:>6} "
                   f"{r['jobs']['rejected']:>5} {r['chunks']:>7} "
                   f"{r['slo_alerts']:>6}")
    jobs = doc["jobs"]
    out.append(f"{'TOTAL':<28} {'':>5} {doc['uptime_s']:>9.3f} "
               f"{sum(ln['queued'] for ln in doc['lanes'].values()):>6} "
               f"{jobs['done']:>6} {jobs['rejected']:>5} "
               f"{doc['chunks']:>7} {doc['slo_alerts']:>6}")
    for name in sorted(doc["lanes"]):
        ln = doc["lanes"][name]
        hist = ln.get("hist")
        lat = ""
        if hist and hist["count"]:
            lat = (f"  mean={hist['sum_ms'] / hist['count']:.3f}ms "
                   f"over {hist['count']} job(s)")
        out.append(f"  lane {name:<12} queued={ln['queued']:<4} "
                   f"done={ln['done']:<5} rejected={ln['rejected']:<4}"
                   f"{lat}")
    return "\n".join(out)


# lint: host
def _poll(addrs: List[str], wait_up: Optional[float]) -> dict:
    """One fleet snapshot over live sockets (stats op per replica)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.client import (
        DaemonClient)
    docs = []
    for addr in addrs:
        with DaemonClient(addr) as client:
            if wait_up is not None:
                client.wait_up(wait_up)
            docs.append(client.stats())
    return merge_stats(docs, labels=addrs)


# lint: host
def main(argv=None) -> int:
    """``cache-sim top`` entry point: the fleet-view aggregator."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="cache-sim-torch top",
        description="aggregate N running daemons' stats into one "
                    "validated cache-sim/fleet/v1 view (exact "
                    "counter sums, worst-replica gauges)")
    ap.add_argument("addrs", nargs="+", metavar="ADDR",
                    help="replica addresses: unix socket paths or "
                         "tcp:HOST:PORT")
    ap.add_argument("--once", action="store_true",
                    help="one deterministic snapshot, then exit "
                         "(tests/goldens; default follows forever)")
    ap.add_argument("--interval", type=float, default=2.0, metavar="S",
                    help="refresh cadence in follow mode (default 2)")
    ap.add_argument("--wait-up", type=float, default=None, metavar="S",
                    help="retry-connect for up to S seconds first")
    ap.add_argument("--json", action="store_true",
                    help="print the fleet doc as JSON instead of the "
                         "top-style table")
    ap.add_argument("--prom", action="store_true",
                    help="print Prometheus text exposition of the "
                         "fleet doc (obs.promexpo) instead of the "
                         "table")
    args = ap.parse_args(argv)

    while True:
        doc = _poll(args.addrs, args.wait_up)
        if args.json:
            print(json.dumps(doc, indent=2, sort_keys=True))
        elif args.prom:
            from ue22cs343bb1_openmp_assignment_tpu_torch.obs import promexpo
            sys.stdout.write(promexpo.render(doc))
        else:
            print(render_top(doc))
        if args.once:
            return 0
        sys.stdout.flush()
        time.sleep(args.interval)
        if not (args.json or args.prom):
            print()


if __name__ == "__main__":
    raise SystemExit(main())
