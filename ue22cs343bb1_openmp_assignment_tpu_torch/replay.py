"""``cache-sim replay``: the universal front door over every captured
artifact the framework emits.

One command, four artifact kinds, auto-detected (:func:`detect`):

* **recording** — a ``cache-sim/recording/v1`` JSONL (file, or a
  directory holding ``recording.jsonl``): re-driven as an open-loop
  soak schedule with the ORIGINAL arrival times and lanes preserved
  (coordinated-omission-free — releases were scheduled when recorded
  and stay scheduled on replay), through either the in-proc scheduler
  on a VirtualClock (deterministic; the default) or a live daemon
  (``--daemon ADDR``). Per-job dump digests are checked against the
  recorded digest column, and a v1.4 latency block is emitted for BOTH
  sides so ``bench-diff --latency`` adjudicates recorded-vs-replayed.
* **soak incident** — a ``cache-sim/soak-incident/v1`` directory: its
  embedded breach-window ``recording.jsonl`` slice is replayed as
  above (an incident dir IS a replayable artifact).
* **flight incident** — a ``cache-sim/incident/v1`` directory: the
  repro case re-runs through the differential oracle
  (obs.flight.replay_incident).
* **repro fixture** — a ``cache-sim/repro/v1`` dir / ``repro.json``:
  re-run through the full oracle chain (analysis.fixtures.replay),
  exit 0 iff the recorded verdict reproduces.

``--slo`` puts a latency bound on a recording replay: a breach exits
4 (soak.EXIT_SLO_BREACH) and dumps an incident dir that embeds the
breach-window recording slice — and ``--shrink`` then ddmins the JOB
LIST (jobs are the atoms, not instructions) down to a minimal subset
that still breaches, written back as a replayable incident fixture.

The port of the JAX package's ``replay.py``. Every in-process run goes
on the card unless given ``device="cpu"`` (``--cpu``): the daemon core's
waves of a recording replay (each job's trace drawn through the threefry
kernel there), the differential oracle of a fixture or a flight
incident, and the shrink's replays. JAX's exit codes are kept as they
are: a fixture replays under the clean handlers, and a flight
incident's replay counts as reproduced whatever its fresh verdict.
"""
# lint: host

from __future__ import annotations

import json
import os
import pathlib
import sys
from typing import List, Optional

from ue22cs343bb1_openmp_assignment_tpu_torch import soak as soak_mod
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import recording

#: artifact kinds :func:`detect` can name
KINDS = ("recording", "soak-incident", "flight-incident", "fixture")

#: shared metric string stamped on both sides of a recorded-vs-
#: replayed comparison — bench-diff refuses to compare across metrics
REPLAY_METRIC = "replay_job_latency"


# lint: host
def detect(path) -> str:
    """Classify a captured artifact; returns one of :data:`KINDS` or
    raises ValueError naming everything that was tried."""
    path = str(path)
    tried: List[str] = []
    if os.path.isdir(path):
        inc = os.path.join(path, "incident.json")
        if os.path.exists(inc):
            with open(inc) as f:
                schema = json.load(f).get("schema")
            if schema == soak_mod.INCIDENT_SCHEMA_ID:
                return "soak-incident"
            from ue22cs343bb1_openmp_assignment_tpu_torch.obs import flight
            if schema == flight.SCHEMA_ID:
                return "flight-incident"
            tried.append(f"incident.json with unknown schema "
                         f"{schema!r}")
        if os.path.exists(os.path.join(path, "repro.json")):
            return "fixture"
        if os.path.exists(os.path.join(path, recording.FILENAME)):
            return "recording"
        tried.append("directory without incident.json / repro.json / "
                     + recording.FILENAME)
    elif os.path.exists(path):
        if os.path.basename(path) == "repro.json":
            return "fixture"
        try:
            with open(path) as f:
                first = json.loads(f.readline())
            schema = first.get("schema") if isinstance(first, dict) \
                else None
        except (ValueError, UnicodeDecodeError):
            schema = None
            tried.append("file whose first line is not JSON")
        if schema == recording.SCHEMA_ID:
            return "recording"
        from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import \
            fixtures
        if schema == fixtures.SCHEMA:
            return "fixture"
        if schema is not None:
            tried.append(f"file with unknown schema {schema!r}")
    else:
        tried.append("path does not exist")
    raise ValueError(
        f"{path}: not a replayable artifact ({'; '.join(tried)}) — "
        f"expected a {recording.SCHEMA_ID} JSONL, a soak/flight "
        "incident directory, or a repro fixture")


# lint: host
def replay_recording(rec: dict, daemon: Optional[str] = None,
                     slots: Optional[int] = None,
                     chunk: Optional[int] = None,
                     max_cycles: Optional[int] = None,
                     queue_capacity: Optional[int] = None,
                     wave_s: float = 1e-3, out_dir=None,
                     timeout_s: float = 300.0,
                     quiet: bool = True, burn=None,
                     device=None) -> dict:
    """Re-drive a loaded recording; returns a ``cache-sim/soak/v1``-
    shaped doc (``transport: "replay"``) extended with the digest
    audit (``digests_matched`` / ``digest_mismatches``) and the
    RECORDED latency block alongside the replayed one.

    In-proc (default): the core is rebuilt from the recording's config
    fingerprint (CLI overrides win) on a fresh VirtualClock, so a
    virtual-clock capture replays bit-faithfully — identical spans,
    identical dumps, identical latency block. ``--daemon`` instead
    drives a LIVE daemon over its socket via soak.soak_daemon with the
    original per-job lanes pinned; latency is then client-observed.
    The in-process waves run on ``device`` (None: the card).
    """
    rate = recording.derived_arrival_rate(rec)
    sched = recording.arrivals(rec)
    recorded = recording.results_by_job(rec)
    if daemon:
        doc = soak_mod.soak_daemon(
            [(t, spec) for t, spec, _ in sched], daemon,
            arrival_rate=rate, timeout_s=timeout_s, quiet=quiet,
            lanes=[lane for _, _, lane in sched], burn=burn)
        doc["transport"] = "replay-daemon"
        # dumps do not cross the socket; audit what the daemon reports
        doc["digests_matched"] = None
        doc["digest_mismatches"] = []
    else:
        doc = _replay_in_proc(rec, sched, rate, recorded,
                              slots=slots, chunk=chunk,
                              max_cycles=max_cycles,
                              queue_capacity=queue_capacity,
                              wave_s=wave_s, out_dir=out_dir,
                              burn=burn, device=device)
    doc["recorded_latency"] = recording.latency_block(
        rec, arrival_rate=rate)
    doc["recorded_jobs"] = len(sched)
    doc["recording_path"] = rec.get("path")
    return doc


# lint: host
def _replay_in_proc(rec: dict, sched, rate: float, recorded: dict,
                    slots=None, chunk=None, max_cycles=None,
                    queue_capacity=None, wave_s: float = 1e-3,
                    out_dir=None, burn=None, device=None) -> dict:
    from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.core import (
        DaemonCore, drive)
    from ue22cs343bb1_openmp_assignment_tpu_torch.daemon import protocol
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import timeseries
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import (
        VirtualClock)
    cfg = dict(rec.get("config") or {})
    core = DaemonCore(
        slots=int(slots if slots is not None
                  else cfg.get("slots", 4)),
        max_buckets=int(cfg.get("max_buckets", 4)),
        chunk=int(chunk if chunk is not None
                  else cfg.get("chunk", 16)),
        max_cycles=int(max_cycles if max_cycles is not None
                       else cfg.get("max_cycles", 100_000)),
        queue_capacity=int(queue_capacity if queue_capacity is not None
                           else cfg.get("queue_capacity", 64)),
        lane_depth=int(cfg.get("lane_depth",
                               protocol.DEFAULT_LANE_DEPTH)),
        lane_weights=cfg.get("lane_weights"),
        clock=VirtualClock(wave_s=wave_s), burn=burn,
        out_dir=out_dir, keep_dumps=True,
        # replay must never evict: the digest audit and the span-based
        # latency block need every job's result
        retain_results=max(len(sched) + 1,
                           protocol.DEFAULT_RETAIN_RESULTS),
        device=device)
    responses = drive(core, sched)
    rejected = [{"job": r["job"], "lane": r.get("lane"),
                 "reason": r.get("reason", r.get("error"))}
                for r in responses if r.get("status") != "queued"]
    mismatches = []
    matched = 0
    for name, doc in sorted(core.results.items()):
        rrow = recorded.get(name)
        if rrow is None:
            continue
        if doc["digest"] == rrow["digest"]:
            matched += 1
        else:
            mismatches.append({"job": name,
                               "recorded": rrow["digest"],
                               "replayed": doc["digest"]})
    spans = core.book.spans()
    closed = [s for s in spans if s.get("e2e_s") is not None]
    lat_s = [s["e2e_s"] for s in closed]
    series_summary = timeseries.summarize_serve_series(core.samples)
    latency = timeseries.latency_summary(
        lat_s, arrival_rate=rate,
        queue_depth_peak=core.queue_depth_peak)
    if latency is not None:
        latency["samples_ms"] = [round(s * 1e3, 6)
                                 for s in sorted(lat_s)]
    stats = core.stats()
    drain = stats["drain_rate_jobs_per_s"]
    return {
        "schema": soak_mod.SCHEMA_ID,
        "transport": "replay",
        "slots": core.slots,
        "arrival_rate": rate,
        "jobs_total": len(sched),
        "jobs_quiesced": sum(1 for d in core.results.values()
                             if d["quiesced"]),
        "rejected": rejected,
        "wave_count": stats["chunks"],
        "wall_s": stats["uptime_s"],
        "busy_s": stats["busy_s"],
        "drain_rate_jobs_per_s": drain,
        "padding_waste": stats["padding_waste"] or 0.0,
        "mb_dropped": stats["mb_dropped"],
        "latency": latency,
        "lane_latency": timeseries.lane_latency_summaries(spans),
        "samples_ms": [round(s * 1e3, 6) for s in sorted(lat_s)],
        "series": timeseries.serve_series(core.samples),
        "series_summary": series_summary,
        "verdict": soak_mod.backpressure_verdict(rate, drain,
                                                 series_summary),
        "digests_matched": matched,
        "digest_mismatches": mismatches,
        "jobs": {name: {"quiesced": d["quiesced"], "lane": d["lane"],
                        "bucket": d["bucket"], "cycles": d["cycles"],
                        "digest": d["digest"]}
                 for name, d in sorted(core.results.items())},
        "waves": [],
        "trace": core.trace_doc(),
        "burnrate": None if burn is None else burn.summary(),
    }


# lint: host
def latency_entries(rec: dict, doc: dict):
    """The (recorded, replayed) pair of v1.4 bench-history entries the
    latency adjudication runs on. Both sides share the metric string
    and the DERIVED arrival rate (same schedule → same offered load by
    construction), so ``bench-diff --latency`` compares them instead
    of declaring different operating points."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import history
    rate = recording.derived_arrival_rate(rec)
    rec_block = recording.latency_block(rec, arrival_rate=rate)
    rep_block = doc.get("latency")
    if rec_block is None or rep_block is None:
        raise ValueError("latency adjudication needs finished jobs on "
                         "both sides (recording and replay)")
    rep_block = dict(rep_block)
    rep_block["arrival_rate"] = rate
    out = []
    for label, block in (("recorded", rec_block),
                         ("replayed", rep_block)):
        times = [max(ms / 1e3, 1e-9)
                 for ms in block.get("samples_ms") or []]
        out.append(history.entry(
            label=label, source="replay",
            result={"metric": REPLAY_METRIC,
                    "value": float(block["p95_ms"]), "unit": "ms"},
            extra={"engine": "daemon", "rep_times_s": times},
            config=dict(rec.get("config") or {}),
            latency=block))
    return out[0], out[1]


# lint: host
def write_latency_entries(out_dir, rec: dict, doc: dict):
    """Write ``recorded.entry.json`` / ``replayed.entry.json`` (one
    v1.4 entry per file, bench-diff operands) into ``out_dir``;
    returns the two paths."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import history
    os.makedirs(str(out_dir), exist_ok=True)
    a, b = latency_entries(rec, doc)
    paths = []
    for name, entry in (("recorded.entry.json", a),
                        ("replayed.entry.json", b)):
        p = os.path.join(str(out_dir), name)
        if os.path.exists(p):
            os.unlink(p)
        history.append(p, entry)
        paths.append(p)
    return paths[0], paths[1]


# lint: host
def main(argv=None) -> int:
    """``cache-sim replay`` entry point."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="cache-sim-torch replay",
        description="replay any captured artifact: a traffic "
                    "recording (original arrival times preserved), an "
                    "SLO-breach incident dir (its breach-window "
                    "slice), a flight-recorder incident, or a repro "
                    "fixture — the artifact kind is auto-detected")
    ap.add_argument("artifact",
                    help="recording .jsonl / record dir, incident "
                         "dir, fixture dir, or repro.json")
    ap.add_argument("--daemon", default=None, metavar="ADDR",
                    help="replay a recording through a RUNNING "
                         "daemon at this address instead of the "
                         "in-proc scheduler (latency is then "
                         "client-observed over the socket)")
    ap.add_argument("--slots", type=int, default=None,
                    help="override the recorded slots-per-bucket")
    ap.add_argument("--chunk", type=int, default=None,
                    help="override the recorded admission chunk")
    ap.add_argument("--max-cycles", type=int, default=None)
    ap.add_argument("--queue-capacity", type=int, default=None)
    ap.add_argument("--wave-s", type=float, default=1e-3,
                    help="virtual seconds per wave for the in-proc "
                         "replay clock (default 1e-3)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="--daemon run bound in seconds (default 300)")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write the replay doc plus the recorded/"
                         "replayed v1.4 latency entries here (the "
                         "bench-diff --latency operands)")
    ap.add_argument("--json", action="store_true",
                    help="print the full replay doc as JSON")
    ap.add_argument("--slo", default=None,
                    help='latency SLO on the REPLAYED run, e.g. '
                         '"p95=5" (ms); a breach exits '
                         f"{soak_mod.EXIT_SLO_BREACH} and dumps an "
                         "incident dir embedding the breach-window "
                         "recording slice")
    ap.add_argument("--incident-dir", default="replay_incident",
                    help="where an SLO breach dumps its incident "
                         "(default ./replay_incident)")
    ap.add_argument("--burn-slo", default=None, metavar="SPEC",
                    help="multi-window burn-rate SLO on the replayed "
                         'run, e.g. "5ms,objective=0.99,fast=60,'
                         'slow=300,factor=2" (obs.burnrate); an '
                         f"alert exits {soak_mod.EXIT_SLO_BREACH}")
    ap.add_argument("--shrink", action="store_true",
                    help="on an SLO breach, ddmin the recording's JOB "
                         "LIST to a minimal subset that still "
                         "breaches; writes a replayable incident "
                         "fixture to --shrink-out")
    ap.add_argument("--shrink-out", default="replay_shrunk",
                    metavar="DIR",
                    help="where --shrink writes the minimal "
                         "recording + incident doc (default "
                         "./replay_shrunk)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the in-process replay on the CPU (the "
                         "plain PyTorch path) instead of the card")
    args = ap.parse_args(argv)
    slo = soak_mod.parse_slo(args.slo) if args.slo else None
    burn = None
    if args.burn_slo:
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import burnrate
        burn = burnrate.monitor_from_spec(args.burn_slo)
    if args.shrink and not slo:
        ap.error("--shrink needs --slo: the shrink predicate is "
                 "'this subset still breaches the SLO on replay'")

    try:
        kind = detect(args.artifact)
    except ValueError as e:
        print(f"replay: {e}")
        return 2
    print(f"replay: {args.artifact} -> {kind}")

    dev = None
    if not args.daemon or args.shrink \
            or kind in ("fixture", "flight-incident"):
        from ue22cs343bb1_openmp_assignment_tpu_torch import device
        try:
            dev = device.resolve("cpu" if args.cpu else None)
        except RuntimeError:
            print("error: no CUDA device is available; pass --cpu to run "
                  "the plain PyTorch path on the CPU", file=sys.stderr)
            return 1
    if kind == "fixture":
        return _replay_fixture(args.artifact, args.json, dev)
    if kind == "flight-incident":
        return _replay_flight(args.artifact, args.json, dev)

    # recording, possibly embedded in a soak-incident dir
    rec = recording.load(args.artifact)
    doc = replay_recording(
        rec, daemon=args.daemon, slots=args.slots, chunk=args.chunk,
        max_cycles=args.max_cycles, queue_capacity=args.queue_capacity,
        wave_s=args.wave_s, timeout_s=args.timeout, burn=burn,
        device=dev)
    report = None
    if doc["latency"] is not None \
            and doc["recorded_latency"] is not None:
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import regress
        a, b = latency_entries(rec, doc)
        report = regress.compare_latency(a, b)
        doc["latency_verdict"] = report
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "replay.json").write_text(
            json.dumps(doc, indent=2, sort_keys=True) + "\n")
        write_latency_entries(out, rec, doc)
        print(f"replay: doc + latency entries written to {out}")
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        _print_summary(doc, report)

    if slo:
        breaches = soak_mod.check_slo(doc["latency"], slo)
        if breaches:
            soak_mod.dump_incident(args.incident_dir, doc, breaches,
                                   rec=rec)
            for br in breaches:
                print(f"replay: SLO BREACH {br['metric']} "
                      f"{br['observed_ms']:.2f}ms > limit "
                      f"{br['limit_ms']:.2f}ms", file=sys.stderr)
            print(f"replay: incident (with breach-window recording "
                  f"slice) dumped to {args.incident_dir}",
                  file=sys.stderr)
            if args.shrink:
                _shrink_to_fixture(rec, slo, args, dev)
            return soak_mod.EXIT_SLO_BREACH
        if args.shrink:
            print("replay: --shrink skipped (no SLO breach to "
                  "preserve)")
    if burn is not None and burn.breached():
        for a in burn.alerts:
            print(f"replay: BURN-RATE ALERT at t={a['t_s']:.3f}s: "
                  f"fast {a['fast_burn']:.1f}x / slow "
                  f"{a['slow_burn']:.1f}x the {a['objective']:.3%} "
                  f"error budget (> {a['threshold_ms']}ms, factor "
                  f"{a['factor']})", file=sys.stderr)
        soak_mod.dump_incident(
            args.incident_dir, doc,
            [{"metric": "burn-rate", **a} for a in burn.alerts],
            rec=rec)
        print(f"replay: incident dumped to {args.incident_dir}",
              file=sys.stderr)
        return soak_mod.EXIT_SLO_BREACH
    if doc["digest_mismatches"]:
        print(f"replay: {len(doc['digest_mismatches'])} job(s) with "
              "DIVERGENT dumps vs the recording")
        return 1
    return 0 if doc["jobs_quiesced"] == doc["jobs_total"] else 1


# lint: host
def _print_summary(doc: dict, report: Optional[dict]) -> None:
    lat = doc["latency"]
    lat_str = ("no jobs completed" if lat is None else
               f"p50={lat['p50_ms']:.2f}ms p95={lat['p95_ms']:.2f}ms "
               f"p99={lat['p99_ms']:.2f}ms")
    print(f"replay[{doc['transport']}]: {doc['jobs_quiesced']}/"
          f"{doc['jobs_total']} jobs quiesced, {lat_str}")
    if doc.get("digests_matched") is not None:
        print(f"replay: dump digests {doc['digests_matched']}/"
              f"{doc['recorded_jobs']} byte-identical to the "
              f"recording, {len(doc['digest_mismatches'])} "
              "mismatched")
    if report is not None:
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import regress
        print(regress.format_latency_report(report))


# lint: host
def _json_safe(res: dict) -> str:
    safe = {k: v for k, v in res.items()
            if isinstance(v, (str, int, float, bool, list, dict,
                              type(None)))}
    return json.dumps(safe, indent=2, sort_keys=True, default=str)


# lint: host
def _replay_fixture(path: str, as_json: bool, device=None) -> int:
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import fixtures
    res = fixtures.replay(path, device=device)
    if as_json:
        print(_json_safe(res))
    print(f"replay: fixture verdict {res['verdict']!r} "
          f"(expected {res['expected_verdict']!r}) -> "
          f"{'REPRODUCED' if res['reproduced'] else 'NOT reproduced'}")
    return 0 if res["reproduced"] else 1


# lint: host
def _replay_flight(path: str, as_json: bool, device=None) -> int:
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import flight
    inc = flight.load_incident(path)
    try:
        res = flight.replay_incident(path, device=device)
    except FileNotFoundError:
        print(f"replay: incident {path} has no repro.json (reason "
              f"{inc['reason']!r}) — its Perfetto trace is the "
              "artifact; nothing to re-execute")
        return 2
    if as_json:
        print(_json_safe(res))
    verdict = res.get("verdict")
    # JAX's test, kept: run_case's verdicts are "ok" or a finding,
    # never "pass", so this always holds
    reproduced = verdict != "pass"
    print(f"replay: flight incident (reason {inc['reason']!r}) fresh "
          f"verdict {verdict!r} -> "
          f"{'REPRODUCED' if reproduced else 'NOT reproduced'}")
    return 0 if reproduced else 1


# lint: host
def _shrink_to_fixture(rec: dict, slo, args, device) -> None:
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import shrink
    try:
        shrunk, n_tests = shrink.shrink_recording(
            rec, lambda sub: _breaches(sub, slo, args, device))
    except ValueError as e:
        # possible when the breach was observed through --daemon but
        # the in-proc predicate replay stays under the bound
        print(f"replay: shrink aborted: {e}")
        return
    jobs = sorted({row["job"] for row in shrunk["rows"]
                   if row["event"] == "submit"})
    print(f"replay: shrink converged to {len(jobs)} job(s) in "
          f"{n_tests} replays: {', '.join(jobs)}")
    doc = _replay_for_slo(shrunk, args, device)
    breaches = soak_mod.check_slo(doc["latency"], slo)
    soak_mod.dump_incident(args.shrink_out, doc, breaches, rec=shrunk)
    print(f"replay: minimal incident fixture written to "
          f"{args.shrink_out} (replay it with `cache-sim replay "
          f"{args.shrink_out}`)")


# lint: host
def _replay_for_slo(sub_rec: dict, args, device) -> dict:
    return replay_recording(
        sub_rec, slots=args.slots, chunk=args.chunk,
        max_cycles=args.max_cycles,
        queue_capacity=args.queue_capacity, wave_s=args.wave_s,
        device=device)


# lint: host
def _breaches(sub_rec: dict, slo, args, device) -> bool:
    if not any(row["event"] == "submit" for row in sub_rec["rows"]):
        return False
    doc = _replay_for_slo(sub_rec, args, device)
    return bool(soak_mod.check_slo(doc["latency"], slo))


if __name__ == "__main__":
    raise SystemExit(main())
