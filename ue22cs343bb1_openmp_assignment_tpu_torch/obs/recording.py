"""Traffic recordings: the ``cache-sim/recording/v1`` JSONL artifact.

A recording is the capture side of ROADMAP item 4: every submission a
daemon (or an in-proc :func:`daemon.core.drive` session) ACCEPTS is
streamed as one JSONL row — the full JobSpec, the lane, the SCHEDULED
arrival time on the injectable clock, and the admission queue depth at
accept — followed later by one result row carrying the job's dump
digest, cycle count, and bucket. The artifact is therefore a complete,
replayable description of a served traffic window: feeding
:func:`arrivals` back through ``daemon.core.drive`` (or a live daemon)
re-drives the exact open-loop schedule with original arrival times
preserved, and :func:`latency_block` reconstructs the RECORDED
latency distribution from the rows alone, so ``bench-diff --latency``
can adjudicate recorded-vs-replayed.

Format: line 1 is the header (``schema``, ``clock``, the scheduler
``config`` fingerprint); every further line is an event row::

    {"event": "submit", "job", "lane", "t_s", "depth", "spec": {...}}
    {"event": "result", "job", "t_s", "quiesced", "digest",
     "cycles", "bucket"}

All rows are written with sorted keys and timestamps read off the ONE
injected clock (relative to the core's ``t_start``), so a session on a
VirtualClock produces byte-identical recordings across runs — the
determinism gate in tests/test_recording.py. Result digests are
computed from the per-node golden dumps BEFORE ``retain_results``
eviction (daemon/core._extract), so the digest column is complete
even for jobs whose result docs the daemon has already dropped.

Host-side and dependency-free like the rest of obs (the only repo
import is JobSpec, for :func:`arrivals`).

The port's copy of the JAX package's ``obs/recording.py``, unchanged apart from its import paths.
"""
# lint: host

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

SCHEMA_ID = "cache-sim/recording/v1"

#: canonical file name inside a record directory / incident dir
FILENAME = "recording.jsonl"

_HEADER_KEYS = ("schema", "clock", "config")
_SUBMIT_KEYS = ("event", "job", "lane", "t_s", "depth", "spec")
_RESULT_KEYS = ("event", "job", "t_s", "quiesced", "digest", "cycles",
                "bucket")


# lint: host
def digest(dumps: List[str]) -> str:
    """Stable short digest of a job's per-node golden dumps — the
    byte-parity fingerprint a replay is checked against."""
    h = hashlib.sha256()
    for text in dumps:
        h.update(text.encode("utf-8"))
        h.update(b"\x00")
    return h.hexdigest()[:16]


# lint: host
def _line(row: dict) -> str:
    return json.dumps(row, sort_keys=True) + "\n"


# lint: host
def _target(path) -> str:
    """Writer-side path resolution: anything that is not explicitly a
    ``.jsonl`` file is a record DIRECTORY (the ``daemon --record DIR``
    convention) and gets :data:`FILENAME` inside it; parents are
    created either way."""
    path = str(path)
    if not path.endswith(".jsonl"):
        os.makedirs(path, exist_ok=True)
        return os.path.join(path, FILENAME)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    return path


class RecordingWriter:
    """Streaming writer: one accepted submission / one finished job →
    one flushed JSONL row, so a killed daemon still leaves a valid,
    replayable prefix on disk."""

    # lint: host
    def __init__(self, path, clock_kind: str,
                 config: Optional[dict] = None):
        self.path = _target(path)
        self.submits = 0
        self.results = 0
        self._f = open(self.path, "w")
        self._f.write(_line({"schema": SCHEMA_ID,
                             "clock": str(clock_kind),
                             "config": dict(config or {})}))
        self._f.flush()

    # lint: host
    def submit(self, spec, lane: str, t_s: float, depth: int) -> None:
        """One ACCEPTED submission (rejected jobs are backpressure,
        not traffic served — they are not recorded)."""
        import dataclasses
        self._f.write(_line({
            "event": "submit", "job": spec.name, "lane": str(lane),
            "t_s": float(t_s), "depth": int(depth),
            "spec": dataclasses.asdict(spec)}))
        self._f.flush()
        self.submits += 1

    # lint: host
    def result(self, job: str, t_s: float, quiesced: bool,
               dump_digest: str, cycles: int, bucket: str) -> None:
        self._f.write(_line({
            "event": "result", "job": str(job), "t_s": float(t_s),
            "quiesced": bool(quiesced), "digest": str(dump_digest),
            "cycles": int(cycles), "bucket": str(bucket)}))
        self._f.flush()
        self.results += 1

    # lint: host
    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


# lint: host
def validate(header: dict, rows: List[dict],
             where: str = "recording") -> None:
    """Structural check; raises ValueError listing every violation
    (the obs.schema contract)."""
    errs = []
    if header.get("schema") != SCHEMA_ID:
        errs.append(f"schema must be {SCHEMA_ID!r}, "
                    f"got {header.get('schema')!r}")
    if header.get("clock") not in ("monotonic", "virtual"):
        errs.append(f"clock must be monotonic|virtual, "
                    f"got {header.get('clock')!r}")
    for k in _HEADER_KEYS:
        if k not in header:
            errs.append(f"header missing key: {k}")
    if not isinstance(header.get("config"), dict):
        errs.append("header config must be a dict")
    seen: Dict[str, bool] = {}
    last_t = None
    for i, row in enumerate(rows, 2):
        ev = row.get("event")
        if ev == "submit":
            for k in _SUBMIT_KEYS:
                if k not in row:
                    errs.append(f"line {i}: submit missing key {k!r}")
            job = row.get("job")
            if job in seen:
                errs.append(f"line {i}: duplicate submit for "
                            f"job {job!r}")
            seen[job] = False
            t = row.get("t_s")
            if not isinstance(t, (int, float)) or t < 0:
                errs.append(f"line {i}: t_s must be a non-negative "
                            f"number, got {t!r}")
            elif last_t is not None and t < last_t:
                errs.append(f"line {i}: submit times must be "
                            f"non-decreasing ({t} after {last_t})")
            else:
                last_t = t
            if not isinstance(row.get("spec"), dict):
                errs.append(f"line {i}: spec must be a dict")
        elif ev == "result":
            for k in _RESULT_KEYS:
                if k not in row:
                    errs.append(f"line {i}: result missing key {k!r}")
            job = row.get("job")
            if job not in seen:
                errs.append(f"line {i}: result for job {job!r} "
                            "with no prior submit")
            elif seen[job]:
                errs.append(f"line {i}: duplicate result for "
                            f"job {job!r}")
            else:
                seen[job] = True
        else:
            errs.append(f"line {i}: event must be submit|result, "
                        f"got {ev!r}")
    if errs:
        raise ValueError(f"invalid {where}:\n  " + "\n  ".join(errs))


# lint: host
def resolve(path) -> str:
    """A recording file, or a directory containing :data:`FILENAME`,
    → the file path."""
    path = str(path)
    if os.path.isdir(path):
        path = os.path.join(path, FILENAME)
    return path


# lint: host
def load(path) -> dict:
    """Read + validate a recording; returns ``{"schema", "clock",
    "config", "rows", "path"}`` (rows exclude the header)."""
    path = resolve(path)
    header = None
    rows: List[dict] = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            doc = json.loads(line)
            if header is None:
                header = doc
            else:
                rows.append(doc)
    if header is None:
        raise ValueError(f"{path}: empty recording (no header line)")
    validate(header, rows, where=path)
    return {"schema": header["schema"], "clock": header["clock"],
            "config": header["config"], "rows": rows, "path": path}


# lint: host
def write(path, rec: dict) -> str:
    """Write a (possibly sliced/shrunk) recording back out; returns
    the file path. Validates before writing."""
    path = _target(path)
    header = {"schema": rec.get("schema", SCHEMA_ID),
              "clock": rec["clock"], "config": rec.get("config", {})}
    validate(header, rec["rows"], where=path)
    with open(path, "w") as f:
        f.write(_line(header))
        for row in rec["rows"]:
            f.write(_line(row))
    return path


# lint: host
def arrivals(rec: dict):
    """The recording as the open-loop schedule ``[(t_s, JobSpec,
    lane)]`` that ``daemon.core.drive`` / ``soak.soak_daemon``
    re-drive — original arrival times preserved, coordinated-omission-
    free by construction (releases never waited on completions when
    recorded, and they never will on replay)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.serve import JobSpec
    out = []
    for row in rec["rows"]:
        if row["event"] == "submit":
            out.append((float(row["t_s"]),
                        JobSpec.from_dict(row["spec"]), row["lane"]))
    return sorted(out, key=lambda a: (a[0], a[1].name))


# lint: host
def results_by_job(rec: dict) -> Dict[str, dict]:
    return {row["job"]: row for row in rec["rows"]
            if row["event"] == "result"}


# lint: host
def subset(rec: dict, names) -> dict:
    """The sub-recording over a set of job names (ddmin's reduction
    operator: jobs, not instructions, are the atoms)."""
    names = set(names)
    return {**rec, "rows": [row for row in rec["rows"]
                            if row["job"] in names]}


# lint: host
def slice_window(rec: dict, t_lo: float, t_hi: float) -> dict:
    """The sub-recording of jobs SUBMITTED inside ``[t_lo, t_hi]``
    (their result rows ride along) — the breach-window slice an SLO
    incident dir embeds."""
    keep = {row["job"] for row in rec["rows"]
            if row["event"] == "submit"
            and t_lo <= float(row["t_s"]) <= t_hi}
    return subset(rec, keep)


# lint: host
def derived_arrival_rate(rec: dict) -> float:
    """The offered load the recording actually carried (jobs/s over
    the submit window, rounded for byte-stable reuse). Both sides of
    a recorded-vs-replayed ``bench-diff --latency`` must stamp THIS
    value: the comparator treats differing arrival rates as different
    operating points (incomparable), and the replay serves the same
    schedule by construction."""
    ts = [float(row["t_s"]) for row in rec["rows"]
          if row["event"] == "submit"]
    if not ts:
        raise ValueError("recording has no submit rows")
    span = max(ts) - min(ts)
    return round(len(ts) / span, 6) if span > 0 else float(len(ts))


# lint: host
def latency_block(rec: dict,
                  arrival_rate: Optional[float] = None
                  ) -> Optional[dict]:
    """The RECORDED latency block (obs.history v1.4 shape):
    per-job e2e = result ``t_s`` − submit ``t_s`` on the one recorded
    clock, nearest-rank percentiles, and the recorded admission queue
    depth peak. None when no job finished inside the recording."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import timeseries
    t_sub: Dict[str, float] = {}
    depth_peak = 0
    lat_s: List[Tuple[str, float]] = []
    for row in rec["rows"]:
        if row["event"] == "submit":
            t_sub[row["job"]] = float(row["t_s"])
            depth_peak = max(depth_peak, int(row["depth"]))
        elif row["job"] in t_sub:
            lat_s.append((row["job"],
                          float(row["t_s"]) - t_sub[row["job"]]))
    block = timeseries.latency_summary(
        [s for _, s in lat_s], arrival_rate=arrival_rate,
        queue_depth_peak=depth_peak)
    if block is not None:
        block["samples_ms"] = [round(s * 1e3, 6)
                               for s in sorted(x for _, x in lat_s)]
    return block
