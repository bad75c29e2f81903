"""Chrome/Perfetto trace-event JSON export of engine event records.

Renders the structured records from utils.eventlog (async engine:
instruction fetches + message dequeues; sync/deep engine: retirement
events) as a trace-event document loadable in ui.perfetto.dev or
chrome://tracing:

- one *process* per node (pid = node id, named ``node <n>``),
- two *threads* per node: tid 0 = ``instr`` track, tid 1 = ``msg``
  track,
- each event a complete ("X") slice at ts = cycle (microsecond units —
  1 simulated cycle renders as 1 us), dur = 1, with the decoded fields
  in ``args``.

The exporter is pure host-side rendering of already-fetched arrays;
the capture itself is the single-dispatch ``lax.scan`` event stack
(ops.step.run_cycles_traced / ops.sync_engine.run_rounds_traced).

The port's copy of the JAX package's ``obs/perfetto.py``, unchanged apart
from its import paths.
"""

from __future__ import annotations

import json
from typing import Dict, List

from ue22cs343bb1_openmp_assignment_tpu_torch.types import Op

TID_INSTR = 0
TID_MSG = 1

_PHASES = ("X", "B", "E", "I", "M", "C", "s", "t", "f")

#: flow-event phases (ph "s" start / "t" step / "f" finish) — emitted
#: by span_flow_events to link one transaction's request/reply slices
#: across node tracks; each binds to the X slice sharing its
#: (pid, tid, ts)
_FLOW_PHASES = ("s", "t", "f")


# lint: host
def _meta(pid: int, tid: int, kind: str, name: str) -> dict:
    ev = {"ph": "M", "pid": pid, "name": kind, "args": {"name": name}}
    if kind == "thread_name":
        ev["tid"] = tid
    return ev


# lint: host
def track_metadata(num_nodes: int) -> List[dict]:
    """Process/thread-name metadata events for per-node tracks."""
    out = []
    for n in range(num_nodes):
        out.append(_meta(n, 0, "process_name", f"node {n}"))
        out.append(_meta(n, TID_INSTR, "thread_name", "instr"))
        out.append(_meta(n, TID_MSG, "thread_name", "msg"))
    return out


# lint: host
def record_to_event(rec: dict) -> dict:
    """One eventlog record ({"kind": "instr"|"msg", ...}) → one "X"
    slice."""
    if rec["kind"] == "instr":
        mnem = "WR" if rec["op"] == int(Op.WRITE) else "RD"
        return {"name": f"{mnem} 0x{rec['addr']:02X}", "ph": "X",
                "cat": "instr", "pid": rec["node"], "tid": TID_INSTR,
                "ts": rec["cycle"], "dur": 1,
                "args": {"op": rec["op"], "addr": rec["addr"],
                         "value": rec["value"]}}
    return {"name": rec["type_name"], "ph": "X", "cat": "msg",
            "pid": rec["node"], "tid": TID_MSG, "ts": rec["cycle"],
            "dur": 1,
            "args": {"sender": rec["sender"], "type": rec["type"],
                     "addr": rec["addr"]}}


# lint: host
def span_flow_events(spans: List[dict]) -> List[dict]:
    """Transaction spans (obs.txntrace) → Perfetto flow events linking
    each span's request/reply slices across node tracks.

    Per attributed closed span: a flow *start* ("s") on the issuing
    instruction slice at the requester, a *step* ("t") on each
    intermediate hop's dequeue slice, and a *finish* ("f", binding
    enclosing, so it attaches to the final reply's dequeue slice back
    at the requester). Flow ids are the span's position in the input
    list — stable because span order is reconstruction order.
    """
    out = []
    for fid, s in enumerate(spans):
        if not s.get("attributed") or not s.get("chain"):
            continue
        name = (f"txn n{s['requester']} 0x{s['addr']:02X} "
                f"#{s['seq']}")
        common = {"name": name, "cat": "txn", "id": fid}
        out.append({"ph": "s", "pid": s["requester"],
                    "tid": TID_INSTR, "ts": s["t_issue"], **common})
        for hop in s["chain"][:-1]:
            out.append({"ph": "t", "pid": hop["dst"], "tid": TID_MSG,
                        "ts": hop["deq"], **common})
        last = s["chain"][-1]
        out.append({"ph": "f", "bp": "e", "pid": last["dst"],
                    "tid": TID_MSG, "ts": last["deq"], **common})
    return out


#: serving-trace track layout (build_serve_trace): pid 0 is the
#: admission queue; slot s renders as process PID_SLOT0 + s
PID_QUEUE = 0
PID_SLOT0 = 1

#: seconds -> trace-event microseconds
_US = 1e6


# lint: host
def serve_span_events(spans: List[dict]) -> List[dict]:
    """Job-lifecycle spans (serve.SpanBook / obs.schema serve-trace) →
    Perfetto slices plus flow arrows following each job across tracks.

    Per span: a ``queued`` slice on the admission-queue track
    (pid PID_QUEUE) from submit to admission, a ``run`` slice on the
    job's slot track (pid PID_SLOT0 + slot, tid 0) from admission to
    quiescence, and an ``extract`` slice (tid 1) from quiescence to
    extraction — then a flow arrow ("s" on the queue slice, "t" on the
    run slice, "f" binding-enclosing on the extract slice) stitching
    the three into one visual chain per job. Flow ids are the span's
    position in the input list, same convention as span_flow_events.
    """
    out = []
    for fid, s in enumerate(spans):
        pid = PID_SLOT0 + s["slot"]
        t_sub = s["t_submit"] * _US
        t_adm = s["t_admitted"] * _US
        t_qui = s["t_quiescent"] * _US
        t_ext = s["t_extracted"] * _US
        args = {"wave": s["wave"], "slot": s["slot"],
                "quiesced": s["quiesced"]}
        # daemon spans carry the priority lane and shape-bucket label
        # (obs.schema optional span keys) — surface them in the slice
        # args so a Perfetto query can split latency by lane
        for k in ("lane", "bucket"):
            if s.get(k) is not None:
                args[k] = s[k]
        out.append({"name": f"queued {s['job']}", "ph": "X",
                    "cat": "serve", "pid": PID_QUEUE, "tid": 0,
                    "ts": t_sub, "dur": max(t_adm - t_sub, 1.0),
                    "args": args})
        out.append({"name": f"run {s['job']}", "ph": "X",
                    "cat": "serve", "pid": pid, "tid": TID_INSTR,
                    "ts": t_adm, "dur": max(t_qui - t_adm, 1.0),
                    "args": args})
        out.append({"name": f"extract {s['job']}", "ph": "X",
                    "cat": "serve", "pid": pid, "tid": TID_MSG,
                    "ts": t_qui, "dur": max(t_ext - t_qui, 1.0),
                    "args": args})
        common = {"name": f"job {s['job']}", "cat": "serve", "id": fid}
        out.append({"ph": "s", "pid": PID_QUEUE, "tid": 0,
                    "ts": t_sub, **common})
        out.append({"ph": "t", "pid": pid, "tid": TID_INSTR,
                    "ts": t_adm, **common})
        out.append({"ph": "f", "bp": "e", "pid": pid, "tid": TID_MSG,
                    "ts": t_qui, **common})
    return out


# lint: host
def build_serve_trace(spans: List[dict]) -> dict:
    """Spans → a complete, validated serving trace-event document:
    one ``queue`` process plus one process per batch slot used, each
    slot with ``run``/``extract`` threads, job slices linked by flow
    arrows (serve_span_events). Time unit: 1 us = 1 clock second/1e6
    (the injected serving clock, see obs.clock)."""
    events = [_meta(PID_QUEUE, 0, "process_name", "queue"),
              _meta(PID_QUEUE, 0, "thread_name", "jobs")]
    for slot in sorted({s["slot"] for s in spans}):
        pid = PID_SLOT0 + slot
        events.append(_meta(pid, 0, "process_name", f"slot {slot}"))
        events.append(_meta(pid, TID_INSTR, "thread_name", "run"))
        events.append(_meta(pid, TID_MSG, "thread_name", "extract"))
    events.extend(serve_span_events(spans))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"source": "cache-sim serve",
                          "time_unit": "clock_us"}}


# lint: host
def build_trace(records: List[dict], num_nodes: int,
                flows: List[dict] = None) -> dict:
    """Records (utils.eventlog.to_records / sync_to_records) → a
    complete trace-event JSON document. ``flows`` (span_flow_events)
    are appended after the slices they bind to."""
    events = track_metadata(num_nodes)
    events.extend(record_to_event(r) for r in records)
    if flows:
        events.extend(flows)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"source": "cache-sim", "time_unit": "cycle"}}


# lint: host
def write_trace(path: str, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
        f.write("\n")


# lint: host
def validate_trace(doc: dict) -> dict:
    """Structural check of a trace-event document (the subset this
    exporter emits plus what Perfetto requires); raises ValueError
    listing every violation, returns the doc."""
    errs = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace must be a dict with a traceEvents list")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not a dict")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            errs.append(f"event {i}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("pid"), int):
            errs.append(f"event {i}: missing/bad pid")
        if not isinstance(ev.get("name"), str):
            errs.append(f"event {i}: missing/bad name")
        if ph == "X":
            if not isinstance(ev.get("ts"), (int, float)):
                errs.append(f"event {i}: X event missing ts")
            if not isinstance(ev.get("dur"), (int, float)):
                errs.append(f"event {i}: X event missing dur")
            if not isinstance(ev.get("tid"), int):
                errs.append(f"event {i}: X event missing tid")
        if ph in _FLOW_PHASES:
            if not isinstance(ev.get("ts"), (int, float)):
                errs.append(f"event {i}: flow event missing ts")
            if not isinstance(ev.get("tid"), int):
                errs.append(f"event {i}: flow event missing tid")
            if not isinstance(ev.get("id"), (int, str)):
                errs.append(f"event {i}: flow event missing id")
            if not isinstance(ev.get("cat"), str):
                errs.append(f"event {i}: flow event missing cat")
        if ph == "M" and "args" not in ev:
            errs.append(f"event {i}: M event missing args")
    if errs:
        raise ValueError("invalid trace-event JSON:\n  "
                         + "\n  ".join(errs[:20]))
    return doc


# lint: host
def tracks(doc: dict) -> Dict[int, set]:
    """{pid: {thread names}} — convenience for tests asserting the
    per-node instr/msg track structure."""
    names: Dict[tuple, str] = {}
    used: Dict[int, set] = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X":
            key = (ev["pid"], ev["tid"])
            used.setdefault(ev["pid"], set()).add(
                names.get(key, str(ev["tid"])))
    return used
