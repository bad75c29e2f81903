"""Open-loop soak harness: latency under load, measured honestly.

The port of the JAX package's ``soak.py``: the waves run through the
port's ``ops.step.run_wave_to_quiescence`` (one vmapped ``cycle`` over
the job axis) on ``device`` (None means the card); every document is
the JAX package's, byte for byte under a VirtualClock.

``serve.serve`` is closed-loop — the whole job stream is present at
entry, so it measures *throughput* (jobs/sec) but cannot say anything
about latency under a live arrival process. This module is the
open-loop complement (ROADMAP serving-observability): a deterministic,
seeded Poisson stream of mixed-traffic jobs (:func:`soak_stream`) is
*released* at its scheduled arrival times regardless of how the
machine is doing — arrivals never wait for completions, which is what
makes the measurement free of coordinated omission (PERF.md): a job's
``queue_wait_s`` starts at its **scheduled** arrival, so a stalled
server shows up as queue growth and fat latency tails instead of
silently slowing the load generator down.

The scheduler is a turn loop over the same wave machinery as serve:

1. release every arrival whose scheduled time has passed into the
   admission queue (span ``submit`` stamped at the scheduled time);
2. admit queued jobs into free batch slots (``state.set_state`` — the
   wave jit stays warm, same one-compile contract as serve);
3. sample ``(t, queue_depth, slots_busy)`` — the host-side time series
   behind the backpressure verdict (obs.timeseries.serve_series);
4. run one batched wave to quiescence, stamp spans, extract and free
   every finished slot. When no slot is occupied the clock instead
   jumps/sleeps to the next scheduled arrival.

All timing reads the injected clock (obs.clock): under a
:class:`~ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock.VirtualClock`
every timestamp is a pure function of the schedule, so two soaks with
the same seed emit byte-identical ``cache-sim/serve-trace/v1`` docs —
the determinism gate in tests/test_soak.py.

The summary doc carries the p50/p95/p99 job-latency block
(nearest-rank, obs.timeseries.latency_summary), the queue/occupancy
series, padding-waste and ``mb_dropped`` totals, and a backpressure
verdict (arrival rate vs measured drain rate). ``--slo p95=<ms>``
turns the run into a gate: a breach exits :data:`EXIT_SLO_BREACH` (4,
the obs.regress regression code) after dumping a flight-recorder-style
incident directory (:func:`dump_incident`) with the slowest jobs'
spans, the queue time series, and the Perfetto rendering of the whole
soak.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import (MonotonicClock,
                                                          VirtualClock)
from ue22cs343bb1_openmp_assignment_tpu_torch.serve import (
    DEFAULT_MIX, JobSpec, SpanBook, build_job_arrays, build_job_state,
    empty_state, host_state, job_config, protocol_phase, serve_trace_doc,
    slot_config, weighted_padding_waste, _dev, _host_quiescent)

SCHEMA_ID = "cache-sim/soak/v1"
INCIDENT_SCHEMA_ID = "cache-sim/soak-incident/v1"

#: process exit code on an SLO breach — deliberately the same code
#: obs.regress uses for a bench regression, so CI treats both alike
EXIT_SLO_BREACH = 4

#: latency percentiles an ``--slo`` spec may bound
SLO_METRICS = ("p50", "p95", "p99")

#: slowest jobs carried (with full spans) into an incident doc
INCIDENT_SLOWEST = 5


# lint: host
def soak_stream(arrival_rate: float, duration_s: float, nodes: int = 4,
                trace_len: int = 8, protocol: str = "mesi",
                mix: Tuple[str, ...] = DEFAULT_MIX,
                seed: int = 0) -> List[Tuple[float, JobSpec]]:
    """Deterministic open-loop arrival schedule: a seeded Poisson
    process (exponential inter-arrival gaps at ``arrival_rate`` jobs/s)
    over ``duration_s`` seconds of mixed-traffic jobs — the same
    workload mix and seed convention as serve.mixed_jobs, plus an
    arrival offset per job. Same (rate, duration, seed) → the same
    schedule, byte for byte."""
    if arrival_rate <= 0:
        raise ValueError(f"arrival_rate must be > 0, got {arrival_rate}")
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    rng = np.random.default_rng(seed)
    arrivals: List[Tuple[float, JobSpec]] = []
    t = 0.0
    i = 0
    while True:
        t += float(rng.exponential(1.0 / arrival_rate))
        if t >= duration_s:
            break
        arrivals.append((t, JobSpec(
            name=f"job{i:03d}", workload=mix[i % len(mix)], nodes=nodes,
            trace_len=trace_len, seed=i, protocol=protocol)))
        i += 1
    return arrivals


# lint: host
def bursty_stream(arrival_rate: float, duration_s: float,
                  nodes: int = 4, trace_len: int = 8,
                  protocol: str = "mesi",
                  mix: Tuple[str, ...] = DEFAULT_MIX, seed: int = 0,
                  on_s: float = 0.25, off_s: float = 0.25,
                  peak_factor: float = 4.0
                  ) -> List[Tuple[float, JobSpec]]:
    """On/off (interrupted) Poisson arrivals: exponentially
    distributed ON windows (mean ``on_s``) emit a Poisson stream at
    ``arrival_rate * peak_factor`` jobs/s, alternating with silent
    OFF windows (mean ``off_s``) — the heavy-tailed burst pattern a
    uniform Poisson stream cannot produce (queues build during
    bursts even when the machine keeps up with the AVERAGE rate).
    Seeded-deterministic like :func:`soak_stream`: same (rate,
    duration, seed, on/off/peak) → the same schedule, byte for byte.
    """
    if arrival_rate <= 0:
        raise ValueError(f"arrival_rate must be > 0, got {arrival_rate}")
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    if on_s <= 0 or off_s <= 0:
        raise ValueError(f"on_s/off_s must be > 0, got {on_s}/{off_s}")
    if peak_factor <= 0:
        raise ValueError(f"peak_factor must be > 0, got {peak_factor}")
    rng = np.random.default_rng(seed)
    peak = arrival_rate * peak_factor
    arrivals: List[Tuple[float, JobSpec]] = []
    t = 0.0
    i = 0
    on = True
    window_end = float(rng.exponential(on_s))
    while t < duration_s:
        if not on:
            # silent window: jump to its end, open the next burst
            t = window_end
            on = True
            window_end = t + float(rng.exponential(on_s))
            continue
        gap = float(rng.exponential(1.0 / peak))
        if t + gap >= window_end:
            # burst over before the next arrival (memoryless, so the
            # residual gap is simply redrawn in the next ON window)
            t = window_end
            on = False
            window_end = t + float(rng.exponential(off_s))
            continue
        t += gap
        if t >= duration_s:
            break
        arrivals.append((t, JobSpec(
            name=f"job{i:03d}", workload=mix[i % len(mix)], nodes=nodes,
            trace_len=trace_len, seed=i, protocol=protocol)))
        i += 1
    return arrivals


# lint: host
def recorded_stream(source) -> List[Tuple[float, JobSpec, str]]:
    """Schedule-from-recording: a ``cache-sim/recording/v1`` artifact
    (path, directory, or loaded doc) → the open-loop schedule
    ``[(t_s, JobSpec, lane)]`` with the ORIGINAL arrival times and
    lanes preserved — yesterday's live traffic as today's soak
    schedule (replay it with ``cache-sim replay``)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import recording
    rec = source if isinstance(source, dict) else recording.load(source)
    return recording.arrivals(rec)


# lint: host
def soak(arrivals, slots: int = 4, slot_nodes: Optional[int] = None,
         slot_trace_len: Optional[int] = None, chunk: int = 32,
         max_cycles: int = 100_000, queue_capacity: int = 64,
         arrival_rate: Optional[float] = None, clock=None,
         quiet: bool = True, burn=None, device=None) -> dict:
    """Run an open-loop arrival schedule ``[(t_offset_s, JobSpec)]``
    through the batched wave machinery; returns the
    ``cache-sim/soak/v1`` summary doc (latency block, queue/occupancy
    series, backpressure verdict, embedded serve-trace doc).

    One protocol per soak: a mixed-protocol stream would interleave
    two wave sequences and the drain-rate verdict would compare apples
    to oranges. The waves run on ``device`` (None: the card).

    ``burn`` (an obs.burnrate.BurnRateMonitor) turns the run into a
    CONTINUOUS SLO check: every extracted job feeds one latency
    sample, and ``doc["burnrate"]`` carries the streaming verdict —
    the --slo end-of-run gate's complement.
    """
    import sys

    from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import timeseries
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step

    arrivals = sorted(arrivals, key=lambda a: a[0])
    specs = [s for _, s in arrivals]
    if not specs:
        raise ValueError("soak needs at least one arrival")
    protocols = sorted({s.protocol for s in specs})
    if len(protocols) > 1:
        raise ValueError(f"soak streams are single-protocol, "
                         f"got {protocols}")
    protocol = protocols[0]
    phase = protocol_phase(protocol)
    scfg = slot_config(specs, slot_nodes, slot_trace_len,
                       queue_capacity, protocol)
    N, T = scfg.num_nodes, scfg.max_instrs
    dev = _dev(device)

    clock = clock if clock is not None else MonotonicClock()
    t_start = clock.now()
    book = SpanBook(clock)
    pending = [(t_start + dt, s) for dt, s in arrivals]
    queue: List[JobSpec] = []

    empty = empty_state(scfg, dev)
    occupant: List[Optional[JobSpec]] = [None] * slots
    real_by_slot = [0] * slots
    bstate = st.stack_states([empty] * slots)

    samples: List[Tuple[float, int, int]] = []
    waves: List[dict] = []
    job_docs: Dict[str, dict] = {}
    mb_dropped_total = 0

    while pending or queue or any(o is not None for o in occupant):
        now = clock.now()
        # open-loop release: spans stamp the SCHEDULED arrival time,
        # not the release-check time — queue_wait accrues from the
        # moment the load generator meant the job to exist
        while pending and pending[0][0] <= now:
            t_arr, spec = pending.pop(0)
            book.submit(spec.name, t_arr)
            queue.append(spec)
        for i in range(slots):
            if occupant[i] is None and queue:
                spec = queue.pop(0)
                occupant[i] = spec
                real_by_slot[i] = int(np.sum(build_job_arrays(
                    job_config(spec, queue_capacity), spec, dev)[3]))
                bstate = st.set_state(bstate, i, build_job_state(
                    scfg, job_config(spec, queue_capacity), spec, dev))
                book.admitted(spec.name, wave=len(waves) + 1, slot=i)
        busy = sum(1 for o in occupant if o is not None)
        samples.append((now - t_start, len(queue), busy))
        if busy == 0:
            # idle: nothing to run, jump/sleep to the next arrival
            if pending:
                clock.sleep(pending[0][0] - now)
            continue

        real = sum(real_by_slot)
        t0 = clock.now()
        for o in occupant:
            if o is not None:
                book.running(o.name, t0)
        bstate = step.run_wave_to_quiescence(
            scfg, bstate, chunk, max_cycles, phase)
        host = host_state(bstate)
        quiet_mask = _host_quiescent(host)
        clock.on_wave()
        t_wave_end = clock.now()
        budget = slots * N * T
        occ = np.array([o is not None for o in occupant])
        wave_dropped = int(np.sum(
            host.metrics.msgs_dropped.numpy()[occ]))
        waves.append({
            "protocol": protocol,
            "jobs": [o.name for o in occupant if o is not None],
            "wall_s": t_wave_end - t0,
            "slot_instr_budget": budget,
            "real_instrs": real,
            "padding_waste": 1.0 - real / budget,
            "mb_dropped": wave_dropped,
        })
        mb_dropped_total += wave_dropped
        if wave_dropped and not quiet:
            print(f"soak: WARNING wave {len(waves)} dropped "
                  f"{wave_dropped} mailbox messages", file=sys.stderr)

        for i, spec in enumerate(occupant):
            if spec is None:
                continue
            ok = bool(quiet_mask[i])
            book.quiescent(spec.name, ok, t_wave_end)
            job_docs[spec.name] = {
                "quiesced": ok,
                "wave": len(waves),
                "slot": i,
                "cycles": int(host.cycle[i]),
            }
            book.extracted(spec.name)
            if burn is not None:
                # spans() is in extraction order: the one extracted()
                # just closed is last — its e2e is the burn sample
                burn.feed(t_wave_end - t_start,
                          book.spans()[-1]["e2e_s"])
            # the finished (quiescent = fixpoint) state stays in place
            # until the slot is refilled — same contract as serve
            occupant[i] = None
            real_by_slot[i] = 0

    wall = clock.now() - t_start
    spans = book.spans()
    series_summary = timeseries.summarize_serve_series(samples)
    latency = timeseries.latency_summary(
        [s["e2e_s"] for s in spans], arrival_rate=arrival_rate,
        queue_depth_peak=series_summary["queue_depth_peak"])
    # drain rate over BUSY time (waves actually running), not wall:
    # wall includes idle gaps waiting for the next arrival, which
    # would make an under-loaded machine look slow — busy-time drain
    # is the service capacity the arrival rate is compared against
    busy_s = sum(w["wall_s"] for w in waves)
    drain = len(spans) / busy_s if busy_s > 0 else 0.0
    doc = {
        "schema": SCHEMA_ID,
        "slots": slots,
        "arrival_rate": arrival_rate,
        "jobs_total": len(spans),
        "jobs_quiesced": sum(1 for d in job_docs.values()
                             if d["quiesced"]),
        "wave_count": len(waves),
        "wall_s": wall,
        "busy_s": busy_s,
        "drain_rate_jobs_per_s": drain,
        "padding_waste": weighted_padding_waste(waves),
        "mb_dropped": mb_dropped_total,
        "latency": latency,
        "series": timeseries.serve_series(samples),
        "series_summary": series_summary,
        "verdict": backpressure_verdict(arrival_rate, drain,
                                        series_summary),
        "burnrate": None if burn is None else burn.summary(),
        "jobs": job_docs,
        "waves": waves,
        "trace": serve_trace_doc(spans, clock.kind),
    }
    return doc


# lint: host
def soak_daemon(arrivals, addr: str,
                arrival_rate: Optional[float] = None,
                lane_mix: Tuple[str, ...] = ("interactive", "batch"),
                poll_s: float = 0.002, timeout_s: float = 300.0,
                prefix: str = "", quiet: bool = True,
                lanes: Optional[List[str]] = None, burn=None) -> dict:
    """Drive the same open-loop arrival schedule through a RUNNING
    daemon's socket instead of in-process waves.

    The release loop is the client: each job is submitted at its
    SCHEDULED arrival time on the client clock — releases never wait
    for completions, so the stream stays coordinated-omission-free —
    and jobs alternate through ``lane_mix`` (mixed interactive+batch
    tenancy). The headline latency block is CLIENT-OBSERVED: scheduled
    release → result available over the socket, the number a user of
    the service experiences (queueing, scheduling, and transport
    included). The embedded ``trace`` doc is the daemon's own span
    book (server-side time base, exact queue_wait+run+extract == e2e
    decomposition) — the two latency views are reported side by side,
    not mixed, because they live on different clocks.

    Backpressure rejections surface in ``doc["rejected"]`` and the
    verdict; they are never silent and never touch ``mb_dropped``.

    ``prefix`` is prepended to every job name: a daemon rejects
    duplicate names, so successive soaks against the SAME daemon must
    use distinct prefixes (the CLI derives one from ``--seed``).

    ``lanes`` pins each arrival's lane explicitly (aligned with the
    input ``arrivals`` order) — the replay path uses it to preserve a
    recording's ORIGINAL lane per job; by default jobs alternate
    through ``lane_mix``.
    """
    import dataclasses
    import time as _time

    from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.client import (
        DaemonClient)
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import timeseries

    items = list(arrivals)
    if lanes is None:
        lanes = [lane_mix[i % len(lane_mix)] for i in range(len(items))]
    if len(lanes) != len(items):
        raise ValueError(f"lanes must align with arrivals: "
                         f"{len(lanes)} vs {len(items)}")
    items = sorted(
        ((t, dataclasses.replace(spec, name=prefix + spec.name), lane)
         for (t, spec), lane in zip(items, lanes)),
        key=lambda a: (a[0], a[1].name))
    if not items:
        raise ValueError("soak needs at least one arrival")
    lanes = [lane for _, _, lane in items]

    clock = MonotonicClock()
    with DaemonClient(addr) as client:
        client.wait_up(timeout_s=min(30.0, timeout_s))
        t_start = clock.now()
        deadline = t_start + timeout_s
        pending = [(t_start + dt, spec, lane)
                   for dt, spec, lane in items]
        outstanding: Dict[str, Tuple[float, str]] = {}
        done: Dict[str, dict] = {}
        e2e: Dict[str, Tuple[float, str]] = {}
        rejected: List[dict] = []
        samples: List[Tuple[float, int, int]] = []
        busy_now = 0
        turn = 0
        poll_names: List[str] = []
        while pending or outstanding:
            now = clock.now()
            if now > deadline:
                raise RuntimeError(
                    f"daemon soak timed out after {timeout_s}s with "
                    f"{len(outstanding)} job(s) outstanding")
            while pending and pending[0][0] <= now:
                t_sched, spec, lane = pending.pop(0)
                r = client.submit(spec, lane=lane)
                if r.get("status") == "queued":
                    outstanding[spec.name] = (t_sched, lane)
                else:
                    rejected.append({"job": spec.name, "lane": lane,
                                     "reason": r.get("reason",
                                                     r.get("error"))})
            # poll a bounded rotation of outstanding jobs per turn so
            # release timing stays open-loop even with a deep backlog
            if not poll_names:
                poll_names = sorted(outstanding)
            for name in poll_names[:8]:
                if name not in outstanding:
                    continue
                r = client.result(name)
                if r.get("status") == "done":
                    t_sched, lane = outstanding.pop(name)
                    t_done = clock.now()
                    e2e[name] = (t_done - t_sched, lane)
                    if burn is not None:
                        # client-observed sample on the client clock —
                        # the continuous twin of the headline latency
                        burn.feed(t_done - t_start, t_done - t_sched)
                    done[name] = {
                        "quiesced": bool(r["quiesced"]),
                        "lane": r["lane"], "bucket": r["bucket"],
                        "cycles": int(r["cycles"]),
                    }
            poll_names = poll_names[8:]
            if turn % 20 == 0:
                busy_now = sum(b["busy"]
                               for b in client.stats()["buckets"])
            samples.append((now - t_start, len(outstanding), busy_now))
            turn += 1
            if pending and not outstanding:
                clock.sleep(max(0.0, pending[0][0] - clock.now()))
            elif outstanding:
                _time.sleep(poll_s)
        wall = clock.now() - t_start
        stats = client.stats()
        trace = client.trace()

    series_summary = timeseries.summarize_serve_series(samples)
    lat_s = [v[0] for v in e2e.values()]
    latency = timeseries.latency_summary(
        lat_s, arrival_rate=arrival_rate,
        queue_depth_peak=series_summary["queue_depth_peak"])
    lane_latency = {
        lane: timeseries.latency_summary(
            [s for s, ln in e2e.values() if ln == lane])
        for lane in sorted(set(lanes))}
    drain = stats["drain_rate_jobs_per_s"]
    return {
        "schema": SCHEMA_ID,
        "transport": "daemon",
        "addr": addr,
        "slots": sum(b["slots"] for b in stats["buckets"]),
        "arrival_rate": arrival_rate,
        "jobs_total": len(done) + len(rejected),
        "jobs_quiesced": sum(1 for d in done.values() if d["quiesced"]),
        "rejected": rejected,
        "wave_count": stats["chunks"],
        "wall_s": wall,
        "busy_s": stats["busy_s"],
        "drain_rate_jobs_per_s": drain,
        "padding_waste": stats["padding_waste"] or 0.0,
        "mb_dropped": stats["mb_dropped"],
        "latency": latency,
        "lane_latency": lane_latency,
        "samples_ms": [round(s * 1e3, 6) for s in sorted(lat_s)],
        "series": timeseries.serve_series(samples),
        "series_summary": series_summary,
        "verdict": backpressure_verdict(arrival_rate, drain,
                                        series_summary),
        "burnrate": None if burn is None else burn.summary(),
        "daemon_stats": stats,
        "jobs": done,
        "waves": [],
        "trace": trace,
    }


# lint: host
def backpressure_verdict(arrival_rate: Optional[float], drain: float,
                         series_summary: dict) -> dict:
    """Saturation call: the machine is saturated when jobs arrive
    faster than the measured drain rate — the queue then grows for as
    long as the arrival window lasts (its peak depth is reported
    alongside so the operator sees how far behind it got)."""
    saturated = bool(arrival_rate is not None and drain > 0
                     and arrival_rate > drain)
    return {
        "saturated": saturated,
        "arrival_rate": arrival_rate,
        "drain_rate_jobs_per_s": drain,
        "queue_depth_peak": series_summary["queue_depth_peak"],
    }


# lint: host
def parse_slo(spec: str) -> Dict[str, float]:
    """``"p95=5,p99=20"`` → ``{"p95_ms": 5.0, "p99_ms": 20.0}``;
    bounds are milliseconds on the percentiles in SLO_METRICS."""
    out: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad SLO term {part!r} (want p95=<ms>)")
        k, v = part.split("=", 1)
        k = k.strip()
        if k not in SLO_METRICS:
            raise ValueError(f"unknown SLO metric {k!r} "
                             f"(one of {SLO_METRICS})")
        try:
            ms = float(v)
        except ValueError:
            raise ValueError(f"bad SLO bound {v!r} for {k}")
        if ms <= 0:
            raise ValueError(f"SLO bound for {k} must be > 0, got {ms}")
        out[k + "_ms"] = ms
    if not out:
        raise ValueError(f"empty SLO spec {spec!r}")
    return out


# lint: host
def check_slo(latency: Optional[dict],
              slo: Dict[str, float]) -> List[dict]:
    """Breach list (empty = all bounds hold). A soak that completed no
    jobs has no latency block and cannot breach."""
    if latency is None:
        return []
    return [{"metric": k, "limit_ms": limit,
             "observed_ms": latency[k]}
            for k, limit in sorted(slo.items()) if latency[k] > limit]


# lint: host
def dump_incident(out_dir, doc: dict, breaches: List[dict],
                  rec: Optional[dict] = None) -> dict:
    """Write a self-contained SLO-breach incident directory (the
    flight-recorder convention, obs.flight): ``incident.json`` — the
    breaches, the latency block, the backpressure verdict, the
    ``INCIDENT_SLOWEST`` slowest jobs' full spans, and the queue-depth
    time series — plus ``trace.perfetto.json``, the Perfetto rendering
    of every job's lifecycle with flow arrows. When the soak was
    driven from a traffic recording (``rec``, an obs.recording doc),
    the BREACH-WINDOW slice — every job submitted between the first
    submit and last extract of the slowest jobs — is embedded as
    ``recording.jsonl``, making the incident dir itself replayable
    (``cache-sim replay <dir>``). Returns the incident doc."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (perfetto,
                                                       recording)
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    spans = doc["trace"]["spans"]
    trace = perfetto.validate_trace(perfetto.build_serve_trace(spans))
    perfetto.write_trace(
        os.path.join(out_dir, "trace.perfetto.json"), trace)
    slowest = sorted(spans, key=lambda s: (-s["e2e_s"], s["job"]))
    files = ["incident.json", "trace.perfetto.json"]
    if rec is not None:
        window = slowest[:INCIDENT_SLOWEST]
        t_lo = min(s["t_submit"] for s in window)
        t_hi = max(s["t_extracted"] for s in window)
        recording.write(os.path.join(out_dir, recording.FILENAME),
                        recording.slice_window(rec, t_lo, t_hi))
        files.append(recording.FILENAME)
    inc = {
        "schema": INCIDENT_SCHEMA_ID,
        "reason": "slo-breach",
        "breaches": breaches,
        "arrival_rate": doc["arrival_rate"],
        "jobs_total": doc["jobs_total"],
        "latency": doc["latency"],
        "verdict": doc["verdict"],
        "slowest_jobs": slowest[:INCIDENT_SLOWEST],
        "series": doc["series"],
        "series_summary": doc["series_summary"],
        "files": sorted(files),
    }
    with open(os.path.join(out_dir, "incident.json"), "w") as f:
        json.dump(inc, f, indent=1, sort_keys=True)
        f.write("\n")
    return inc


# lint: host
def load_incident(incident_dir) -> dict:
    """Read and schema-check a soak incident doc."""
    path = os.path.join(str(incident_dir), "incident.json")
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != INCIDENT_SCHEMA_ID:
        raise ValueError(f"{path}: schema must be "
                         f"{INCIDENT_SCHEMA_ID!r}, got "
                         f"{doc.get('schema')!r}")
    for k in ("reason", "breaches", "latency", "slowest_jobs",
              "series", "files"):
        if k not in doc:
            raise ValueError(f"{path}: missing key {k!r}")
    return doc


# lint: host
def main(argv=None) -> int:
    """``cache-sim soak`` entry point."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="cache-sim-torch soak",
        description="open-loop soak: release a seeded mixed-traffic "
                    "job stream at a fixed arrival rate and measure "
                    "p50/p95/p99 job latency, queue depth, and "
                    "saturation")
    ap.add_argument("--arrival-rate", type=float, default=20.0,
                    help="jobs per second released (default 20)")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="arrival window in seconds (default 2); the "
                         "run drains fully after the window closes")
    ap.add_argument("--slots", type=int, default=4,
                    help="batch slots per wave (default 4)")
    ap.add_argument("--nodes", type=int, default=4,
                    help="nodes per job (default 4)")
    ap.add_argument("--trace-len", type=int, default=8,
                    help="instructions per node per job (default 8)")
    ap.add_argument("--protocol", default="mesi",
                    help="coherence protocol for the stream "
                         "(default mesi)")
    ap.add_argument("--seed", type=int, default=0,
                    help="arrival-schedule + workload seed (default 0)")
    ap.add_argument("--bursty", action="store_true",
                    help="use the on/off (interrupted) Poisson "
                         "schedule instead of uniform Poisson: "
                         "exponential ON windows at --arrival-rate x "
                         "--burst-peak alternate with silent OFF "
                         "windows — heavy-tailed load that builds "
                         "queues even at a sustainable AVERAGE rate")
    ap.add_argument("--burst-on", type=float, default=0.25,
                    metavar="S",
                    help="mean ON-window length in seconds under "
                         "--bursty (default 0.25)")
    ap.add_argument("--burst-off", type=float, default=0.25,
                    metavar="S",
                    help="mean OFF-window length in seconds under "
                         "--bursty (default 0.25)")
    ap.add_argument("--burst-peak", type=float, default=4.0,
                    metavar="X",
                    help="in-burst rate multiplier over --arrival-rate "
                         "under --bursty (default 4.0)")
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--max-cycles", type=int, default=100_000)
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--daemon", default=None, metavar="ADDR",
                    help="drive the stream through a RUNNING "
                         "`cache-sim daemon` at this address (unix "
                         "path or tcp:HOST:PORT) instead of "
                         "in-process waves; latency is then "
                         "client-observed over the socket")
    ap.add_argument("--lane-mix", default="interactive,batch",
                    help="comma list of lanes jobs alternate through "
                         "under --daemon (default interactive,batch)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="--daemon run bound in seconds (default 300)")
    ap.add_argument("--virtual-clock", action="store_true",
                    help="run on the deterministic VirtualClock "
                         "(byte-identical trace docs; tests/CI)")
    ap.add_argument("--wave-s", type=float, default=1e-3,
                    help="virtual seconds charged per wave under "
                         "--virtual-clock (default 1e-3)")
    ap.add_argument("--slo", default=None,
                    help='latency SLO, e.g. "p95=5,p99=20" (ms); a '
                         f'breach exits {EXIT_SLO_BREACH} and dumps '
                         'an incident dir')
    ap.add_argument("--burn-slo", default=None, metavar="SPEC",
                    help="CONTINUOUS burn-rate SLO (obs.burnrate), "
                         'e.g. "5ms,objective=0.99,fast=60,slow=300,'
                         'factor=4": every finished job is one '
                         "streaming sample; an alert (both windows "
                         "burning the error budget at factor x) "
                         f"exits {EXIT_SLO_BREACH} — the streaming "
                         "complement of the end-of-run --slo gate")
    ap.add_argument("--incident-dir", default="soak_incident",
                    help="where an SLO breach dumps its incident "
                         "(default ./soak_incident)")
    ap.add_argument("--out", default=None,
                    help="write the full soak doc as JSON here")
    ap.add_argument("--json", action="store_true",
                    help="print the full soak doc as JSON")
    ap.add_argument("--cpu", action="store_true",
                    help="run the waves on the CPU (the plain PyTorch "
                         "path) instead of the card")
    args = ap.parse_args(argv)
    slo = parse_slo(args.slo) if args.slo else None
    burn = None
    if args.burn_slo:
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import burnrate
        burn = burnrate.monitor_from_spec(args.burn_slo)
    if args.daemon and args.virtual_clock:
        ap.error("--daemon measures real client-observed latency over "
                 "the socket; it cannot run on --virtual-clock "
                 "(the daemon owns its own clock)")

    if args.bursty:
        arrivals = bursty_stream(
            args.arrival_rate, args.duration, nodes=args.nodes,
            trace_len=args.trace_len, protocol=args.protocol,
            seed=args.seed, on_s=args.burst_on, off_s=args.burst_off,
            peak_factor=args.burst_peak)
    else:
        arrivals = soak_stream(
            args.arrival_rate, args.duration, nodes=args.nodes,
            trace_len=args.trace_len, protocol=args.protocol,
            seed=args.seed)
    if args.daemon:
        lane_mix = tuple(p.strip() for p in args.lane_mix.split(",")
                         if p.strip())
        doc = soak_daemon(arrivals, args.daemon,
                          arrival_rate=args.arrival_rate,
                          lane_mix=lane_mix, timeout_s=args.timeout,
                          prefix=f"s{args.seed}.", quiet=False,
                          burn=burn)
    else:
        clock = (VirtualClock(wave_s=args.wave_s)
                 if args.virtual_clock else MonotonicClock())
        doc = soak(arrivals, slots=args.slots, chunk=args.chunk,
                   max_cycles=args.max_cycles,
                   queue_capacity=args.queue_capacity,
                   arrival_rate=args.arrival_rate, clock=clock,
                   quiet=False, burn=burn,
                   device="cpu" if args.cpu else None)
    if args.out:
        pathlib.Path(args.out).write_text(
            json.dumps(doc, indent=2) + "\n")
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        lat = doc["latency"]
        v = doc["verdict"]
        lat_str = ("no jobs completed" if lat is None else
                   f"p50={lat['p50_ms']:.2f}ms p95={lat['p95_ms']:.2f}ms "
                   f"p99={lat['p99_ms']:.2f}ms")
        via = (f" via daemon {doc['addr']}"
               if doc.get("transport") == "daemon" else "")
        print(f"soak{via}: {doc['jobs_quiesced']}/{doc['jobs_total']} "
              f"jobs quiesced in {doc['wave_count']} waves, {lat_str}, "
              f"queue_peak={v['queue_depth_peak']}, "
              f"drain={v['drain_rate_jobs_per_s']:.2f} jobs/s, "
              f"{'SATURATED' if v['saturated'] else 'keeping up'}")
        for lane, ls in (doc.get("lane_latency") or {}).items():
            if ls:
                print(f"soak:   lane {lane}: p95={ls['p95_ms']:.2f}ms "
                      f"({ls['jobs']} jobs)")
        if doc.get("rejected"):
            print(f"soak:   {len(doc['rejected'])} job(s) REJECTED "
                  f"by backpressure (explicit, not dropped)")
    if slo:
        breaches = check_slo(doc["latency"], slo)
        if breaches:
            import sys
            dump_incident(args.incident_dir, doc, breaches)
            for b in breaches:
                print(f"soak: SLO BREACH {b['metric']} "
                      f"{b['observed_ms']:.2f}ms > limit "
                      f"{b['limit_ms']:.2f}ms", file=sys.stderr)
            print(f"soak: incident dumped to {args.incident_dir}",
                  file=sys.stderr)
            return EXIT_SLO_BREACH
    if burn is not None and burn.breached():
        import sys
        for a in burn.alerts:
            print(f"soak: BURN-RATE ALERT at t={a['t_s']:.3f}s: "
                  f"fast {a['fast_burn']:.1f}x / slow "
                  f"{a['slow_burn']:.1f}x the {a['objective']:.3%} "
                  f"error budget (> {a['threshold_ms']}ms, factor "
                  f"{a['factor']})", file=sys.stderr)
        dump_incident(args.incident_dir, doc,
                      [{"metric": "burn-rate", **a}
                       for a in burn.alerts])
        print(f"soak: incident dumped to {args.incident_dir}",
              file=sys.stderr)
        return EXIT_SLO_BREACH
    return 0 if doc["jobs_quiesced"] == doc["jobs_total"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
