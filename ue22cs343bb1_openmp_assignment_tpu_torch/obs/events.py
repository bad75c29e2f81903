"""Live ops events: the ``cache-sim/events/v1`` structured stream.

The recording (obs.recording) is the REPLAY artifact — only accepted
submissions and finished jobs, enough to re-drive the traffic. This
module is the OPERATIONS artifact: every scheduler decision a person
watching a live daemon wants to see, as one validated, ring-bounded
event stream the ``watch`` socket verb pushes to clients:

========================= =============================================
kind                      emitted when (daemon/core.py)
========================= =============================================
``submit-accepted``       a job lands in a lane queue (lane, depth)
``lane-reject``           explicit backpressure: full lane or draining
``admitted``              a job takes a slot (lane, bucket, wave, slot)
``quiesced``              a job extracts (ok, cycles, bucket, e2e_ms)
``result-evicted``        retention dropped a terminal job's payload
``bucket-growth``         an idle bucket grew to cover a new shape
``slo-alert``             the burn-rate monitor fired (obs.burnrate)
========================= =============================================

Every event row is ``{"seq", "t_s", "kind", "job", ...kind fields}``:
``seq`` is a per-emitter monotonic counter, ``t_s`` the injected
clock's offset from the core's start. Under a VirtualClock the whole
stream is a pure function of the submission schedule — two identical
sessions serialize byte-identically (sorted keys, one clock), the
determinism gate in tests/test_ops_plane.py.

The in-memory ring keeps the newest ``ring`` rows (``dropped`` counts
what scrolled off — a watch client that falls behind sees the gap in
``seq``); ``--events-dir`` additionally streams every row to
``events.jsonl`` with a recording-style header line, flushed per row.

Host-side and dependency-free like the rest of obs (socket servers
import this module, so it must never import torch or the engines).

The port's copy of the JAX package's ``obs/events.py``, unchanged apart from its import paths.
"""
# lint: host

from __future__ import annotations

import json
import os
from typing import List, Optional

SCHEMA_ID = "cache-sim/events/v1"

#: canonical file name inside an ``--events-dir`` directory
FILENAME = "events.jsonl"

#: every event kind the core emits, in rough lifecycle order
KINDS = ("submit-accepted", "lane-reject", "admitted", "quiesced",
         "result-evicted", "bucket-growth", "slo-alert")

#: default in-memory ring bound (rows)
DEFAULT_RING = 4096

_HEADER_KEYS = ("schema", "clock", "ring", "config")
_ROW_KEYS = ("seq", "t_s", "kind", "job")


# lint: host
def _line(row: dict) -> str:
    return json.dumps(row, sort_keys=True) + "\n"


# lint: host
def _target(path) -> str:
    """``--events-dir`` convention, mirroring obs.recording: anything
    not explicitly ``.jsonl`` is a directory that gets
    :data:`FILENAME` inside it."""
    path = str(path)
    if not path.endswith(".jsonl"):
        os.makedirs(path, exist_ok=True)
        return os.path.join(path, FILENAME)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    return path


class EventEmitter:
    """Ring-bounded structured event sink the core emits into.

    ``emit`` is synchronous and allocation-cheap: one dict appended to
    the ring (oldest rows dropped beyond ``ring``, counted in
    ``dropped``) and, when a path was given, one flushed JSONL line —
    a killed daemon still leaves a valid event-stream prefix on disk.
    """

    # lint: host
    def __init__(self, clock_kind: str, ring: int = DEFAULT_RING,
                 path=None, config: Optional[dict] = None):
        if ring < 1:
            raise ValueError(f"ring must be >= 1, got {ring}")
        self.clock_kind = str(clock_kind)
        self.ring = int(ring)
        self.seq = 0               # next seq to assign == rows emitted
        self.dropped = 0           # rows scrolled off the ring
        self.rows: List[dict] = []
        self.path: Optional[str] = None
        self._f = None
        if path is not None:
            self.path = _target(path)
            self._f = open(self.path, "w")
            self._f.write(_line({"schema": SCHEMA_ID,
                                 "clock": self.clock_kind,
                                 "ring": self.ring,
                                 "config": dict(config or {})}))
            self._f.flush()

    # lint: host
    def emit(self, kind: str, t_s: float, job: Optional[str] = None,
             **fields) -> dict:
        if kind not in KINDS:
            raise ValueError(f"unknown event kind {kind!r} "
                             f"(one of {KINDS})")
        row = {"seq": self.seq, "t_s": float(t_s), "kind": kind,
               "job": job, **fields}
        self.seq += 1
        self.rows.append(row)
        if len(self.rows) > self.ring:
            del self.rows[:len(self.rows) - self.ring]
            self.dropped = self.seq - len(self.rows)
        if self._f is not None:
            self._f.write(_line(row))
            self._f.flush()
        return row

    # lint: host
    def since(self, seq: int) -> List[dict]:
        """Every retained row with ``seq >= seq`` — the watch verb's
        cursor read (a client that fell behind the ring sees a seq
        gap, never a stall)."""
        return [r for r in self.rows if r["seq"] >= seq]

    # lint: host
    def dumps(self) -> str:
        """The retained ring serialized as the canonical byte stream
        (sorted keys, one row per line) — what the determinism gate
        compares across runs."""
        return "".join(_line(r) for r in self.rows)

    # lint: host
    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.close()


# lint: host
def validate(header: Optional[dict], rows: List[dict],
             where: str = "events") -> None:
    """Structural check (the obs.schema contract: raise ValueError
    listing every violation). ``header`` is None for a bare in-memory
    ring; rows must carry the base keys, a known kind, strictly
    increasing ``seq``, and non-decreasing ``t_s``."""
    errs = []
    if header is not None:
        if header.get("schema") != SCHEMA_ID:
            errs.append(f"schema must be {SCHEMA_ID!r}, "
                        f"got {header.get('schema')!r}")
        if header.get("clock") not in ("monotonic", "virtual"):
            errs.append(f"clock must be monotonic|virtual, "
                        f"got {header.get('clock')!r}")
        for k in _HEADER_KEYS:
            if k not in header:
                errs.append(f"header missing key: {k}")
    last_seq = None
    last_t = None
    for i, row in enumerate(rows):
        for k in _ROW_KEYS:
            if k not in row:
                errs.append(f"row {i}: missing key {k!r}")
        kind = row.get("kind")
        if kind not in KINDS:
            errs.append(f"row {i}: kind must be one of {KINDS}, "
                        f"got {kind!r}")
        seq = row.get("seq")
        if not isinstance(seq, int) or isinstance(seq, bool) or seq < 0:
            errs.append(f"row {i}: seq must be a non-negative int, "
                        f"got {seq!r}")
        elif last_seq is not None and seq <= last_seq:
            errs.append(f"row {i}: seq must be strictly increasing "
                        f"({seq} after {last_seq})")
        else:
            last_seq = seq
        t = row.get("t_s")
        if not isinstance(t, (int, float)) or isinstance(t, bool) \
                or t < 0:
            errs.append(f"row {i}: t_s must be a non-negative number, "
                        f"got {t!r}")
        elif last_t is not None and t < last_t:
            errs.append(f"row {i}: t_s must be non-decreasing "
                        f"({t} after {last_t})")
        else:
            last_t = t
        job = row.get("job")
        if job is not None and (not isinstance(job, str) or not job):
            errs.append(f"row {i}: job must be None or a non-empty "
                        f"string, got {job!r}")
    if errs:
        raise ValueError(f"invalid {where}:\n  " + "\n  ".join(errs))


# lint: host
def load(path) -> dict:
    """Read + validate an ``--events-dir`` artifact; returns
    ``{"schema", "clock", "ring", "config", "rows", "path"}``."""
    path = str(path)
    if os.path.isdir(path):
        path = os.path.join(path, FILENAME)
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
        raise ValueError(f"{path}: empty event stream (no header line)")
    validate(header, rows, where=path)
    return {"schema": header["schema"], "clock": header["clock"],
            "ring": header["ring"], "config": header["config"],
            "rows": rows, "path": path}
