"""Failure flight recorder: the last K cycles of telemetry, always on
hand when something goes wrong.

An invariant trip, a hang-watchdog firing, or a fuzzer finding used to
leave behind one exit code and whatever the operator could reconstruct
by hand. The flight recorder turns each of those into a self-contained
**incident directory**:

- ``incident.json`` — ``cache-sim/incident/v1``: the reason, the
  validated ``cache-sim/metrics/v1`` doc of the final state, and the
  ring buffer of the last K cycles of telemetry (per-cycle counter
  deltas, queue watermarks, directory occupancy — the same on-device
  series behind ``cache-sim stats --timeseries``), plus a
  ``txn_summary`` from the causal tracer (obs.txntrace): the slowest
  five transactions of the incident's tail with their latency
  decomposition and every transaction still in flight when the
  recorder stopped, and a ``profile`` block — the validated
  ``cache-sim/profile/v1`` coherence profile (obs.cohprof) of the
  replayed run: which lines were contended, how they were missing,
  and what sharing pattern they exhibit;
- ``trace.perfetto.json`` — a validated Perfetto event trace of the
  run replayed from the initial state (the engine is deterministic, so
  the replay IS the incident);
- ``core_<n>.txt`` + ``repro.json`` — when the incident came from a
  fuzz case, the exact ``cache-sim/repro/v1`` fixture format
  analysis/shrink.py emits, so :func:`replay_incident` (and the
  reference simulator itself) can re-run it. ``cache-sim replay
  <dir>`` is the front door: it detects a flight incident among the
  other captured artifact kinds and calls :func:`replay_incident`.

The ring is captured by looping ``ops.step.run_cycles_telemetry`` in
small chunks host-side and keeping only the last K samples — memory is
O(K), not O(run length), which is what makes "always on" affordable.
``message_phase`` threads through so mutant (fuzzer) runs record the
mutant engine, not the clean one.

Host-side orchestration only; the per-cycle capture itself stays in
ops/step.py.

The port's copy of the JAX package's ``obs/flight.py``, with the
captured tensors read to the host through ``convert.host`` (``.cpu()``);
:func:`record_case` and :func:`replay_incident` run on ``device`` (None:
the card). Imports of analysis/* are lazy to keep obs free of an import
cycle (analysis already imports obs).
"""
# lint: host

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional

import numpy as np

from ue22cs343bb1_openmp_assignment_tpu_torch.convert import host

SCHEMA_ID = "cache-sim/incident/v1"

#: default ring depth (cycles of telemetry kept)
DEFAULT_RING = 64

#: cycles replayed into the incident's Perfetto trace (matches
#: analysis/shrink.py's TRACE_CYCLES budget)
TRACE_CYCLES = 256



class FlightRecorder:
    """Run the async engine with a bounded telemetry ring.

    ``FlightRecorder(cfg, state0)`` snapshots the initial state (for
    deterministic replay), then :meth:`run` advances in ``chunk``-cycle
    telemetry scans, retaining the last ``k`` per-cycle samples.
    """

    # lint: host
    def __init__(self, cfg, state0, k: int = DEFAULT_RING,
                 chunk: int = 16,
                 message_phase: Optional[Callable] = None) -> None:
        if k < 1 or chunk < 1:
            raise ValueError(f"k and chunk must be >=1, got {k}, {chunk}")
        self.cfg = cfg
        self.state0 = state0
        self.state = state0
        self.k = int(k)
        self.chunk = int(chunk)
        self.message_phase = message_phase
        self.cycles_run = 0
        self._ring: List[dict] = []   # chunk samples, newest last

    # lint: host
    def run(self, max_cycles: int, stop_on_quiescence: bool = True):
        """Advance up to ``max_cycles`` cycles (chunk granularity, so
        up to chunk-1 overshoot — same contract as run_chunked_to_
        quiescence); returns the final state."""
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
        done = 0
        while done < max_cycles:
            if stop_on_quiescence and bool(self.state.quiescent()):
                break
            n = min(self.chunk, max_cycles - done)
            # chunk size is a static argnum: stick to self.chunk when
            # possible so the scan compiles once, not per remainder
            n = self.chunk if max_cycles - done >= self.chunk else n
            self.state, telem = step.run_cycles_telemetry(
                self.cfg, self.state, n, self.message_phase)
            self._ring.append(
                {kk: host(v) for kk, v in telem.items()})
            done += n
            excess = sum(s["counters"].shape[0]
                         for s in self._ring) - self.k
            while excess > 0 and self._ring:
                head = self._ring[0]
                hlen = head["counters"].shape[0]
                if hlen <= excess:
                    self._ring.pop(0)
                    excess -= hlen
                else:
                    self._ring[0] = {kk: v[hlen - excess:]
                                     for kk, v in head.items()}
                    excess = 0
        self.cycles_run += done
        return self.state

    # lint: host
    def ring(self) -> dict:
        """The retained telemetry window as one stacked dict of
        [T, ...] arrays (T <= k), oldest sample first."""
        if not self._ring:
            return {}
        keys = self._ring[0].keys()
        return {kk: np.concatenate([s[kk] for s in self._ring], axis=0)
                for kk in keys}

    # lint: host
    def _metrics_doc(self) -> dict:
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import schema
        mt = self.state.metrics
        md = {f: host(getattr(mt, f))
              for f in type(mt).__dataclass_fields__}
        return schema.validate(schema.from_async(md))

    # lint: host
    def dump_incident(self, out_dir: str, reason: str,
                      detail: str = "",
                      case: Optional[dict] = None) -> dict:
        """Write the self-contained incident directory; returns the
        incident doc. ``case`` is a fuzz-case dict
        (fuzz.FuzzCase.to_dict()) — when given, the repro fixture
        (core_<n>.txt + repro.json) is emitted alongside."""
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (perfetto,
                                                            timeseries)
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
        from ue22cs343bb1_openmp_assignment_tpu_torch.utils import eventlog
        os.makedirs(out_dir, exist_ok=True)

        # deterministic replay of the incident's first TRACE_CYCLES
        # cycles from the pristine initial state -> Perfetto trace
        n_trace = max(1, min(self.cycles_run or TRACE_CYCLES,
                             TRACE_CYCLES))
        _, events = step.run_cycles_traced(self.cfg, self.state0,
                                           n_trace, self.message_phase)
        trace_doc = perfetto.build_trace(
            eventlog.to_records(events), self.cfg.num_nodes)
        perfetto.validate_trace(trace_doc)
        perfetto.write_trace(
            os.path.join(out_dir, "trace.perfetto.json"), trace_doc)

        files = ["incident.json", "trace.perfetto.json"]
        if case is not None:
            files += self._emit_case_repro(out_dir, reason, detail,
                                           case)

        ring = self.ring()
        series = timeseries.to_series(ring) if ring else None
        # causal transaction spans of the incident's tail: the slowest
        # closed transactions with their latency decomposition plus
        # everything still in flight when the recorder stopped — the
        # hang suspects, by name
        txn_summary = None
        profile = None
        if self.cycles_run:
            from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (cohprof,
                                                                txntrace)
            txn_summary = txntrace.incident_summary(
                self.cfg, self.state0, self.cycles_run,
                self.message_phase)
            # same deterministic-replay discipline: the coherence
            # profile of the exact run that tripped the incident —
            # which lines were contended and how they were missing
            profile = cohprof.capture_async(
                self.cfg, self.state0, self.cycles_run,
                self.message_phase)
        doc = {
            "schema": SCHEMA_ID,
            "reason": str(reason),
            "detail": str(detail),
            "cycles_run": int(self.cycles_run),
            "final_cycle": int(self.state.cycle),
            "quiescent": bool(self.state.quiescent()),
            "ring_depth": self.k,
            "ring": series,
            "ring_summary": (timeseries.summarize(ring)
                             if ring else None),
            "metrics": self._metrics_doc(),
            "txn_summary": txn_summary,
            "profile": profile,
            "trace_cycles": n_trace,
            "has_repro": case is not None,
            "files": sorted(files),
        }
        with open(os.path.join(out_dir, "incident.json"), "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        return doc

    # lint: host
    def _emit_case_repro(self, out_dir: str, reason: str, detail: str,
                         case: dict) -> list:
        # exact analysis/fixtures format (core_<n>.txt in the reference
        # trace syntax + cache-sim/repro/v1 metadata), so an incident
        # replays through the same path as a shrunk finding
        from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
            fixtures, fuzz)
        fc = fuzz.case_from_dict(case)
        fixtures.write_fixture(out_dir, fc, reason.split(":", 1)[-1],
                               detail,
                               extra_files=["trace.perfetto.json"])
        return [f"core_{n}.txt" for n in range(fc.num_nodes)] \
            + ["repro.json"]


# lint: host
def record_case(case, message_phase: Optional[Callable] = None,
                k: int = DEFAULT_RING, device=None) -> FlightRecorder:
    """A FlightRecorder primed from a fuzz case's initial state on
    ``device`` (None: the card): same construction as fuzz.run_case,
    same mutant engine."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import fuzz
    return FlightRecorder(case.config(), fuzz.case_state(case, device),
                          k=k, message_phase=message_phase)


# lint: host
def load_incident(incident_dir: str) -> dict:
    """Read and schema-check an incident doc."""
    path = os.path.join(incident_dir, "incident.json")
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA_ID:
        raise ValueError(f"{path}: schema must be {SCHEMA_ID!r}, "
                         f"got {doc.get('schema')!r}")
    for k in ("reason", "cycles_run", "metrics", "files"):
        if k not in doc:
            raise ValueError(f"{path}: missing key {k!r}")
    if doc.get("profile") is not None:
        # validate-when-present: pre-profiler incidents stay loadable
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import cohprof
        cohprof.validate(doc["profile"])
    return doc


# lint: host
def replay_incident(incident_dir: str,
                    message_phase: Optional[Callable] = None,
                    device=None) -> dict:
    """Re-run an incident's repro case through the differential
    oracle (analysis/fuzz.run_case) on ``device`` (None: the card);
    returns the fresh verdict doc. Raises FileNotFoundError for
    incidents without a repro (hang / invariant incidents from CLI runs
    carry a Perfetto trace but no fuzz case)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import fuzz
    path = os.path.join(incident_dir, "repro.json")
    with open(path) as f:
        meta = json.load(f)
    case = fuzz.case_from_dict(meta["case"])
    return fuzz.run_case(case, message_phase, device)
