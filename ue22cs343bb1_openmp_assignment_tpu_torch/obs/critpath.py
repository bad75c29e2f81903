"""Critical-path attribution over the happens-before DAG.

Classic critical-path analysis (Yang & Miller, ICDCS'88) applied to
the coherence engine: the run's events form a happens-before DAG —

* **program-order edges**: consecutive activity events of one node
  (message dequeue or instruction fetch; a node does at most one per
  cycle, drain-before-fetch), minimum spacing 1 cycle;
* **message edges**: the event that *emitted* a message (its causal
  parent's dequeue, or the issuing fetch — obs.txntrace) happens
  before the message's dequeue at the receiver, minimum spacing 1
  cycle (a message delivered in phase 3 of cycle c is dequeue-eligible
  at c+1). Ring-FIFO ordering needs no extra edges: dequeues at a node
  are already program-ordered.

The critical path to quiescence is the chain that *determined* the
run's length: start from the terminal event and repeatedly step to the
tightest predecessor — the one with the largest ``cycle + 1`` bound
(ties: the message edge binds, then the lower node id; fully
deterministic, so repeated runs of the deterministic engine produce
identical reports). Every cycle between path start and end is
attributed to a (node, phase) pair:

* ``service_msg`` / ``service_instr`` — the event's own cycle,
* ``queue_wait`` — slack under a message edge: the binding message sat
  that long in the receiver's ring,
* ``stall`` — slack under a program-order edge: the node sat idle or
  blocked between its own events.

``by_node`` + ``by_phase`` each sum to the path length, and the length
is ≤ total cycles by construction — "what to optimize next", with
receipts. Host-side analysis only (consumes txntrace.parse_ledger).

The port's copy of the JAX package's ``obs/critpath.py``, unchanged apart
from its import paths.
"""
# lint: host

from __future__ import annotations

from typing import Dict, List, Optional

from ue22cs343bb1_openmp_assignment_tpu_torch.types import MSG_NAMES

SCHEMA_ID = "cache-sim/critpath/v1"

#: attribution phases; report["by_phase"] sums over exactly these
PHASES = ("service_instr", "service_msg", "queue_wait", "stall")


# lint: host
def _event_index(trace: dict) -> Dict[tuple, tuple]:
    """{(node, cycle): (kind, msg_idx, pos-in-node-stream)}."""
    idx = {}
    for n, evs in trace["events"].items():
        for pos, (cyc, kind, mi) in enumerate(evs):
            idx[(n, cyc)] = (kind, mi, pos)
    return idx


# lint: host
def critical_path(trace: dict, total_cycles: Optional[int] = None
                  ) -> dict:
    """The critical path of a parsed ledger (txntrace.parse_ledger).

    Returns the ``cache-sim/critpath/v1`` report dict; deterministic
    for a deterministic engine run. ``total_cycles`` (cycles to
    quiescence) is carried into the report so consumers can see the
    path-length ≤ run-length bound hold.
    """
    msgs = trace["msgs"]
    events = trace["events"]
    idx = _event_index(trace)

    report = {"schema": SCHEMA_ID,
              "total_cycles": (int(total_cycles)
                               if total_cycles is not None else None),
              "length": 0, "events_on_path": 0,
              "start": None, "end": None,
              "by_node": {}, "by_phase": dict.fromkeys(PHASES, 0),
              "steps": []}
    all_events = [(cyc, n, kind, mi)
                  for n, evs in events.items()
                  for (cyc, kind, mi) in evs]
    if not all_events:
        return report

    # terminal: the last event of the run (it *is* the quiescence
    # frontier); among same-cycle events the lowest node id, for
    # determinism
    last_cycle = max(e[0] for e in all_events)
    term = min((n for (cyc, n, _k, _m) in all_events
                if cyc == last_cycle))
    node, cyc = term, last_cycle

    steps: List[dict] = []
    by_node: Dict[int, int] = {}
    by_phase = dict.fromkeys(PHASES, 0)
    while True:
        kind, msg_idx, pos = idx[(node, cyc)]
        preds = []
        if pos > 0:
            p_cyc = events[node][pos - 1][0]
            # sort key: bound desc, message edge (0) before program
            # edge (1), then lower pred node id
            preds.append((-(p_cyc + 1), 1, node, p_cyc, None))
        if kind == "msg" and msg_idx is not None:
            m = msgs[msg_idx]
            if (m["src"], m["enq"]) in idx:
                preds.append((-(m["enq"] + 1), 0, m["src"], m["enq"],
                              msg_idx))
        service = "service_msg" if kind == "msg" else "service_instr"
        if not preds:
            # path root: its own cycle is the origin, not attributed
            # (length = terminal cycle - root cycle)
            steps.append({"node": node, "cycle": cyc, "kind": kind,
                          "wait": 0, "edge": "root"})
            break
        preds.sort()
        _bound, edge_kind, p_node, p_cyc, p_msg = preds[0]
        wait = cyc - p_cyc - 1
        by_node[node] = by_node.get(node, 0) + 1 + wait
        by_phase[service] += 1
        by_phase["queue_wait" if edge_kind == 0 else "stall"] += wait
        step = {"node": node, "cycle": cyc, "kind": kind,
                "wait": wait,
                "edge": "msg" if edge_kind == 0 else "program"}
        if edge_kind == 0:
            step["msg"] = {"src": msgs[p_msg]["src"],
                           "type": MSG_NAMES[msgs[p_msg]["type"]],
                           "addr": msgs[p_msg]["addr"]}
        steps.append(step)
        node, cyc = p_node, p_cyc

    steps.reverse()
    root, term_ev = steps[0], steps[-1]
    report.update(
        length=term_ev["cycle"] - root["cycle"],
        events_on_path=len(steps),
        start={"node": root["node"], "cycle": root["cycle"],
               "kind": root["kind"]},
        end={"node": term_ev["node"], "cycle": term_ev["cycle"],
             "kind": term_ev["kind"]},
        by_node={str(n): c for n, c in sorted(by_node.items())},
        by_phase=by_phase, steps=steps)
    return report


# lint: host
def hotspots(report: dict, top: int = 5) -> List[dict]:
    """The path steps that absorbed the most wait, largest first —
    the "optimize this" shortlist."""
    waits = [s for s in report["steps"] if s.get("wait", 0) > 0]
    return sorted(waits, key=lambda s: (-s["wait"], s["cycle"],
                                        s["node"]))[:top]
