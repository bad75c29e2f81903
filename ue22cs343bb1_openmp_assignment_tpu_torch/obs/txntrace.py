"""Causal transaction tracer: message-ledger capture → Dapper-style spans.

A coherence *transaction* is the protocol's unit of work: a miss or
upgrade issues (the node blocks), a REQUEST travels to the home
directory, the home forwards/invalidates, owners flush, a reply fills
the line and clears the wait. The telemetry series says how many of those
happened per cycle; this module says **where each one spent its
cycles**.

The capture is the message ledger (ops.step cycle ``with_ledger``):
per cycle, the per-node dequeue record, every enqueue candidate with
its post-arbitration accept mask, the frontend issue latch, and the
wait-clear mask — stacked by the same single-dispatch ``lax.scan`` as
the telemetry series and pulled host-side in chunks (:func:`capture`).

Reconstruction exploits two exact properties of the engine:

* **FIFO rings** — per receiver, dequeue order equals enqueue order,
  so the k-th dequeue at node *d* IS the k-th accepted enqueue into
  *d*'s ring: enqueue→dequeue matching needs no message ids on device.
* **causal parents** — a message emitted by node *n* at cycle *t* was
  caused by the message *n* dequeued at *t* (handlers emit in their
  dequeue cycle), else by the instruction *n* fetched at *t*. Walking
  parents from the unblocking reply yields each transaction's exact
  hop chain back to its issue.

Each closed span (keyed ``(requester, addr, issue-order)``) decomposes
into four segments that sum to its end-to-end latency *by
construction* (each hop contributes 1 transit cycle plus its ring
wait, and consecutive hops share a cycle — the handler emits in its
dequeue cycle):

* ``queue_wait``  — the request's wait in the home's ring,
* ``dir_service`` — waits on intermediate hops (forwards, flushes),
* ``in_flight``   — one cycle per hop transit,
* ``ack_wait``    — the final reply's wait in the requester's ring.

Host-side analysis only; the device capture lives in ops/step.py.

The port's copy of the JAX package's ``obs/txntrace.py``: the same code,
with the captured tensors and state fields read to the host through
``convert.host`` (``.cpu()``), since the port's captures may live on the card.
"""
# lint: host

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ue22cs343bb1_openmp_assignment_tpu_torch.convert import host
from ue22cs343bb1_openmp_assignment_tpu_torch.types import MSG_NAMES, Msg, Op

SCHEMA_ID = "cache-sim/txnspans/v1"

#: span segment names, in report order; per span they sum exactly to
#: the end-to-end latency (tests/test_txntrace.py pins the invariant)
SEGMENTS = ("queue_wait", "dir_service", "in_flight", "ack_wait")

#: request message type → transaction class
TXN_TYPES = {int(Msg.READ_REQUEST): "read_miss",
             int(Msg.WRITE_REQUEST): "write_miss",
             int(Msg.UPGRADE): "upgrade"}



# lint: host
def capture(cfg, state0, num_cycles: int, chunk: int = 64,
            message_phase: Optional[Callable] = None,
            stop_on_quiescence: bool = True,
            with_obs: bool = False):
    """Run the async engine ``num_cycles`` cycles with the message
    ledger on, in host-side ``chunk``-cycle scans (one fused dispatch
    each — the flight-recorder discipline; chunk stays a single static
    size so the scan compiles once, plus at most one remainder size).

    Returns ``(final_state, ledger, base_cycle)`` with ledger a dict
    of host [T, ...] numpy arrays (LEDGER_FIELDS) and base_cycle the
    absolute cycle of sample 0.
    """
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    base_cycle = int(state0.cycle)
    state = state0
    parts: List[dict] = []
    done = 0
    while done < num_cycles:
        if stop_on_quiescence and bool(state.quiescent()):
            break
        left = num_cycles - done
        n = chunk if left >= chunk else left
        state, led = step.run_cycles_ledger(cfg, state, n,
                                            message_phase, with_obs)
        parts.append({k: host(v) for k, v in led.items()})
        done += n
    if not parts:
        return state, {}, base_cycle
    ledger = {k: np.concatenate([p[k] for p in parts], axis=0)
              for k in parts[0]}
    return state, ledger, base_cycle


# lint: host
def parse_ledger(cfg, ledger: Dict[str, np.ndarray], base_cycle: int = 0,
                 arb_rank=None, init_mb_count=None) -> dict:
    """Ledger arrays → the causal event structure.

    Returns a dict with:

    * ``msgs`` — one record per *accepted* enqueue, in global causal
      order: ``{src, dst, type, addr, enq, deq, parent}`` where deq is
      None while the message still sits in a ring at capture end and
      parent is ``("msg", i)`` / ``("issue", (node, cycle))`` /
      ``("fetch", (node, cycle))`` / ``("unknown", None)``;
    * ``events`` — per node, its time-ordered activity events
      ``(cycle, kind, msg_idx)`` with kind ``"msg"`` or ``"instr"``
      (a node never does both in one cycle: drain-before-fetch);
    * ``issues`` — ``{(node, cycle): {addr, op, value, req_type,
      accepted}}`` for every coherence-wait-opening fetch;
    * ``unblocks`` — time-ordered ``(cycle, node, msg_idx)``;
    * ``num_cycles`` / ``base_cycle``.

    ``init_mb_count`` (per-node ints) marks messages already enqueued
    before the window: their dequeues match to *unknown* messages
    instead of failing — the warm-start mode the flight recorder uses.
    FIFO matching is exact because each ring dequeues in enqueue order
    and same-cycle enqueue order is the arbitration sort
    ``(arb_rank[src], slot)``, replayed here bit-for-bit.
    """
    if not ledger:
        return {"msgs": [], "events": {}, "issues": {}, "unblocks": [],
                "num_cycles": 0, "base_cycle": base_cycle}
    N, S = cfg.num_nodes, cfg.out_slots
    T = ledger["deq_has"].shape[0]
    rank = (np.arange(N, dtype=np.int64) if arb_rank is None
            else np.asarray(arb_rank, dtype=np.int64))
    pending = ([0] * N if init_mb_count is None
               else [int(c) for c in np.asarray(init_mb_count)])

    msgs: List[dict] = []
    rings: List[List[int]] = [[] for _ in range(N)]
    events: Dict[int, list] = {n: [] for n in range(N)}
    issues: Dict[tuple, dict] = {}
    unblocks: List[tuple] = []

    deq_has = ledger["deq_has"]
    fetch, issue = ledger["fetch"], ledger["issue"]
    acc = ledger["enq_accept"]
    for t in range(T):
        cyc = base_cycle + t
        # phase 1: dequeues pop ring state from *earlier* cycles (a
        # message delivered in phase 3 of cycle c is dequeue-eligible
        # at c+1); FIFO: head of the per-ring list
        deq_of: Dict[int, Optional[int]] = {}
        for n in np.nonzero(deq_has[t])[0]:
            n = int(n)
            if pending[n] > 0:
                pending[n] -= 1
                deq_of[n] = None      # pre-window message: unknown
            else:
                if not rings[n]:
                    raise ValueError(
                        f"ledger inconsistent: node {n} dequeues at "
                        f"cycle {cyc} from an empty ring")
                i = rings[n].pop(0)
                m = msgs[i]
                if (m["type"] != int(ledger["deq_type"][t, n])
                        or m["src"] != int(ledger["deq_sender"][t, n])
                        or m["addr"] != int(ledger["deq_addr"][t, n])):
                    raise ValueError(
                        f"ledger inconsistent: FIFO match at node {n} "
                        f"cycle {cyc} disagrees with dequeue record")
                m["deq"] = cyc
                deq_of[n] = i
            events[n].append((cyc, "msg", deq_of[n]))
            if ledger["unblocked"][t, n]:
                unblocks.append((cyc, n, deq_of[n]))
        # phase 2: instruction fetches (only message-idle nodes)
        for n in np.nonzero(fetch[t])[0]:
            n = int(n)
            events[n].append((cyc, "instr", None))
            if issue[t, n]:
                issues[(n, cyc)] = {
                    "addr": int(ledger["addr"][t, n]),
                    "op": int(ledger["op"][t, n]),
                    "value": int(ledger["value"][t, n]),
                    # the request candidate rides slot 0 this cycle;
                    # its planes are valid even if arbitration (or
                    # fault injection) dropped it
                    "req_type": int(ledger["enq_type"][t, n, 0]),
                    "accepted": bool(acc[t, n, 0]),
                }
        # phase 3: accepted enqueues append in arbitration order —
        # the delivery sort key is (arb_rank[sender], slot)
        srcs, slots = np.nonzero(acc[t])
        if srcs.size:
            order = np.argsort(rank[srcs] * S + slots, kind="stable")
            for src, slot in zip(srcs[order], slots[order]):
                src, slot = int(src), int(slot)
                if deq_has[t, src]:
                    parent = ("msg", events[src][-1][2])
                    if parent[1] is None:
                        parent = ("unknown", None)
                elif issue[t, src] and slot == 0:
                    parent = ("issue", (src, cyc))
                elif fetch[t, src]:
                    parent = ("fetch", (src, cyc))
                else:          # unreachable: every emission has a cause
                    parent = ("unknown", None)
                i = len(msgs)
                msgs.append({
                    "src": src,
                    "dst": int(ledger["enq_recv"][t, src, slot]),
                    "type": int(ledger["enq_type"][t, src, slot]),
                    "addr": int(ledger["enq_addr"][t, src, slot]),
                    "enq": cyc, "deq": None, "parent": parent,
                })
                rings[msgs[i]["dst"]].append(i)
    return {"msgs": msgs, "events": events, "issues": issues,
            "unblocks": unblocks, "num_cycles": T,
            "base_cycle": base_cycle}


# lint: host
def _chain(msgs: List[dict], end_idx: Optional[int]):
    """Hop indices root→reply for the causal chain ending at
    ``msgs[end_idx]``, plus the chain's root cause (an
    ``("issue"|"fetch", (node, cycle))`` tuple or None when the chain
    leaves the capture window)."""
    hops: List[int] = []
    i = end_idx
    root = None
    while i is not None:
        hops.append(i)
        kind, ref = msgs[i]["parent"]
        if kind == "msg":
            i = ref
            continue
        root = None if kind == "unknown" else (kind, ref)
        break
    hops.reverse()
    return hops, root


# lint: host
def _decompose(span: dict, msgs: List[dict], hops: List[int],
               root) -> None:
    """Fill span["segments"] (summing exactly to end-to-end) and
    span["attributed"]. A span is *attributed* when its causal chain
    is fully inside the window and roots at its own issue; otherwise
    (warm start, or the racy FLUSH-clears-any-wait reference quirk
    closing a wait from another node's transaction) the whole latency
    is reported as ack_wait, unattributed — the sum invariant holds
    either way."""
    e2e = span["t_end"] - span["t_issue"]
    ok = (root == ("issue", (span["requester"], span["t_issue"]))
          and hops and msgs[hops[0]]["enq"] == span["t_issue"])
    if not ok:
        span["segments"] = {"queue_wait": 0, "dir_service": 0,
                            "in_flight": 0, "ack_wait": e2e}
        span["attributed"] = False
        span["hops"] = len(hops)
        return
    k = len(hops)
    first, last = msgs[hops[0]], msgs[hops[-1]]
    queue_wait = first["deq"] - first["enq"] - 1
    if k == 1:
        seg = {"queue_wait": queue_wait, "dir_service": 0,
               "in_flight": 1, "ack_wait": 0}
    else:
        ack = last["deq"] - last["enq"] - 1
        seg = {"queue_wait": queue_wait, "in_flight": k,
               "ack_wait": ack,
               "dir_service": e2e - queue_wait - k - ack}
    span["segments"] = seg
    span["attributed"] = True
    span["hops"] = k
    span["chain"] = [
        {"src": msgs[i]["src"], "dst": msgs[i]["dst"],
         "type": MSG_NAMES[msgs[i]["type"]],
         "enq": msgs[i]["enq"], "deq": msgs[i]["deq"]}
        for i in hops]


# lint: host
def build_spans(trace: dict, init_open: Optional[List[dict]] = None
                ) -> List[dict]:
    """Transaction spans from a parsed ledger, keyed
    ``(requester, addr, seq)`` with seq the per-requester issue order.

    A node blocks while it waits, so it has at most one open span;
    issues open spans, wait-clears close the node's open span (even
    when the clearing message belongs to another transaction — the
    reference's unconditional-FLUSH quirk — in which case the span is
    closed but *unattributed*). ``init_open`` seeds spans already in
    flight at window start (flight-recorder warm starts):
    ``{node, t_issue, addr, op}`` each.
    """
    msgs = trace["msgs"]
    spans: List[dict] = []
    open_by_node: Dict[int, dict] = {}
    seq_by_node: Dict[int, int] = {}

    for w in (init_open or []):
        n = int(w["node"])
        seq_by_node[n] = seq_by_node.get(n, 0) + 1
        sp = {"requester": n, "addr": int(w["addr"]),
              "seq": -seq_by_node[n],   # before any in-window issue
              "type": ("read_miss" if int(w["op"]) == int(Op.READ)
                       else "write_miss"),
              "t_issue": int(w["t_issue"]), "t_end": None, "e2e": None,
              "segments": None, "attributed": False, "hops": 0,
              "request_dropped": False, "warm_start": True}
        spans.append(sp)
        open_by_node[n] = sp
    seq_by_node = {}

    # merge issues and unblocks into one time-ordered stream; at equal
    # cycles unblocks come first (phase 1 before phase 2 — and a node
    # never does both, see parse_ledger)
    stream = sorted(
        [(c, 0, n, i) for (c, n, i) in trace["unblocks"]]
        + [(c, 1, n, None) for (n, c) in trace["issues"]])
    for cyc, kind, n, msg_idx in stream:
        if kind == 0:                         # unblock: close n's span
            sp = open_by_node.pop(n, None)
            if sp is None:
                raise ValueError(
                    f"ledger inconsistent: node {n} unblocked at cycle "
                    f"{cyc} with no open span")
            sp["t_end"] = cyc
            sp["e2e"] = cyc - sp["t_issue"]
            hops, root = _chain(msgs, msg_idx)
            _decompose(sp, msgs, hops, root)
        else:                                 # issue: open a span
            info = trace["issues"][(n, cyc)]
            if n in open_by_node:
                raise ValueError(
                    f"ledger inconsistent: node {n} issued at cycle "
                    f"{cyc} while already waiting")
            seq_by_node[n] = seq_by_node.get(n, -1) + 1
            sp = {"requester": n, "addr": info["addr"],
                  "seq": seq_by_node[n],
                  "type": TXN_TYPES.get(info["req_type"], "unknown"),
                  "t_issue": cyc, "t_end": None, "e2e": None,
                  "segments": None, "attributed": False, "hops": 0,
                  "request_dropped": not info["accepted"],
                  "warm_start": False}
            spans.append(sp)
            open_by_node[n] = sp
    return spans


# lint: host
def reconstruct(cfg, ledger: Dict[str, np.ndarray], base_cycle: int = 0,
                arb_rank=None, init_mb_count=None,
                init_open: Optional[List[dict]] = None):
    """parse + span build in one call; returns ``(spans, trace)``."""
    trace = parse_ledger(cfg, ledger, base_cycle=base_cycle,
                         arb_rank=arb_rank, init_mb_count=init_mb_count)
    return build_spans(trace, init_open=init_open), trace


# lint: host
def percentile(values: List[int], q: float) -> Optional[int]:
    """Nearest-rank percentile (deterministic, integer-exact)."""
    if not values:
        return None
    s = sorted(values)
    k = max(1, int(-(-q * len(s) // 100)))  # ceil(q/100 * n), >= 1
    return s[k - 1]


# lint: host
def latency_table(spans: List[dict]) -> dict:
    """Per-transaction-type latency decomposition: count, p50/p95/p99
    of end-to-end latency, and per-segment totals + p95 — closed spans
    only."""
    closed = [s for s in spans if s["t_end"] is not None]
    out = {}
    for t in sorted({s["type"] for s in closed}):
        rows = [s for s in closed if s["type"] == t]
        e2e = [s["e2e"] for s in rows]
        ent = {"count": len(rows),
               "p50": percentile(e2e, 50), "p95": percentile(e2e, 95),
               "p99": percentile(e2e, 99), "max": max(e2e),
               "mean": round(sum(e2e) / len(e2e), 2),
               "segments": {}}
        for seg in SEGMENTS:
            vals = [s["segments"][seg] for s in rows]
            ent["segments"][seg] = {"total": sum(vals),
                                    "p95": percentile(vals, 95)}
        out[t] = ent
    return out


# lint: host
def top_slowest(spans: List[dict], n: int = 10) -> List[dict]:
    """The n slowest closed spans, deterministically ordered
    (latency desc, then issue cycle, then requester)."""
    closed = [s for s in spans if s["t_end"] is not None]
    return sorted(closed,
                  key=lambda s: (-s["e2e"], s["t_issue"],
                                 s["requester"]))[:n]


# lint: host
def summarize(spans: List[dict]) -> dict:
    """The compact ``txn_latency`` block attached to
    ``cache-sim/metrics/v1.1`` reports (obs.schema)."""
    closed = [s for s in spans if s["t_end"] is not None]
    by_type = {}
    for t in sorted({s["type"] for s in closed}):
        e2e = [s["e2e"] for s in closed if s["type"] == t]
        by_type[t] = {"count": len(e2e),
                      "p50": percentile(e2e, 50),
                      "p95": percentile(e2e, 95),
                      "p99": percentile(e2e, 99)}
    return {"spans": len(closed),
            "open": len(spans) - len(closed),
            "by_type": by_type,
            "segments_total": {
                seg: sum(s["segments"][seg] for s in closed)
                for seg in SEGMENTS}}


# lint: host
def spans_doc(cfg, spans: List[dict], total_cycles: int,
              top: int = 10) -> dict:
    """The full ``cache-sim/txnspans/v1`` JSON document behind
    ``cache-sim txns --json``."""
    return {"schema": SCHEMA_ID,
            "num_nodes": cfg.num_nodes,
            "total_cycles": int(total_cycles),
            "spans_closed": sum(1 for s in spans
                                if s["t_end"] is not None),
            "spans_open": sum(1 for s in spans if s["t_end"] is None),
            "attributed": sum(1 for s in spans if s["attributed"]),
            "by_type": latency_table(spans),
            "txn_latency": summarize(spans),
            "slowest": top_slowest(spans, top),
            "open": [{k: s[k] for k in ("requester", "addr", "seq",
                                        "type", "t_issue",
                                        "request_dropped")}
                     for s in spans if s["t_end"] is None]}


# lint: host
def ledger_to_records(ledger: Dict[str, np.ndarray],
                      base_cycle: int = 0) -> List[dict]:
    """Ledger → utils.eventlog-shaped records (instr fetches + msg
    dequeues), so ``cache-sim txns --perfetto`` renders slices from
    the same capture the spans came from — no second traced run."""
    if not ledger:
        return []
    out = []
    mt, mn = np.nonzero(ledger["deq_has"])
    for t, n in zip(mt, mn):
        ty = int(ledger["deq_type"][t, n])
        out.append({"kind": "msg", "cycle": base_cycle + int(t),
                    "node": int(n),
                    "sender": int(ledger["deq_sender"][t, n]),
                    "type": ty, "type_name": MSG_NAMES[ty],
                    "addr": int(ledger["deq_addr"][t, n])})
    ft, fn = np.nonzero(ledger["fetch"])
    for t, n in zip(ft, fn):
        out.append({"kind": "instr", "cycle": base_cycle + int(t),
                    "node": int(n), "op": int(ledger["op"][t, n]),
                    "addr": int(ledger["addr"][t, n]),
                    "value": int(ledger["value"][t, n])})
    return sorted(out, key=lambda r: (r["cycle"], r["node"]))


# lint: host
def incident_summary(cfg, state0, cycles_run: int,
                     message_phase: Optional[Callable] = None,
                     window: int = 4096, chunk: int = 64) -> dict:
    """Transaction-span summary for a flight-recorder incident
    (obs.flight): deterministically replay the run and reconstruct the
    spans of its last ``min(cycles_run, window)`` cycles — the slowest
    five closed spans with their decomposition, plus every transaction
    still in flight at the end (the hang suspects).

    Long runs replay the pre-window prefix without the ledger (chunked
    plain telemetry scans, which the recorder already compiled) and
    warm-start the reconstruction from the ring occupancy and per-node
    wait state at the window edge.
    """
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    cycles_run = int(cycles_run)
    t0 = max(0, cycles_run - int(window))
    state = state0
    done = 0
    while done < t0:                       # prefix replay, ledger off
        n = chunk if t0 - done >= chunk else t0 - done
        state, _ = step.run_cycles_telemetry(cfg, state, n,
                                             message_phase)
        done += n
    init_mb_count = host(state.mb_count)
    waiting = host(state.waiting)
    init_open = [{"node": int(n),
                  "t_issue": int(host(state.waiting_since)[n]),
                  "addr": int(host(state.cur_addr)[n]),
                  "op": int(host(state.cur_op)[n])}
                 for n in np.nonzero(waiting)[0]] if t0 else None
    final, ledger, base = capture(cfg, state, cycles_run - t0,
                                  chunk=chunk,
                                  message_phase=message_phase,
                                  stop_on_quiescence=False)
    spans, _ = reconstruct(cfg, ledger, base_cycle=base,
                           arb_rank=host(state.arb_rank),
                           init_mb_count=init_mb_count if t0 else None,
                           init_open=init_open)
    end_cycle = int(final.cycle)
    return {"window_start": base, "window_cycles": cycles_run - t0,
            "warm_start": bool(t0),
            "spans_closed": sum(1 for s in spans
                                if s["t_end"] is not None),
            "spans_open": sum(1 for s in spans if s["t_end"] is None),
            "slowest": [
                {k: s[k] for k in ("requester", "addr", "seq", "type",
                                   "t_issue", "t_end", "e2e",
                                   "segments", "attributed")}
                for s in top_slowest(spans, 5)],
            "in_flight": [
                {"requester": s["requester"], "addr": s["addr"],
                 "seq": s["seq"], "type": s["type"],
                 "t_issue": s["t_issue"],
                 "age": end_cycle - s["t_issue"],
                 "request_dropped": s["request_dropped"]}
                for s in spans if s["t_end"] is None]}
