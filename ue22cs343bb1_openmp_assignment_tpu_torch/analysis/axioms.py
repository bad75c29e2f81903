"""Axiomatic execution checker: po/rf/co/fr over captured runs.

Herd-style (Alglave, Maranget & Tautschnig, "Herding Cats", TOPLAS
2014 — PAPERS.md): a run of the engine is abstracted into a set of
memory *events* — one per retired instruction — and the candidate
execution relations are reconstructed from the message ledger:

* **po** — program order, the per-node retire sequence (the engine
  blocks each node on every miss/upgrade, so retire order IS fetch
  order);
* **rf** — reads-from, resolved by value: every write in the litmus
  and fuzz value discipline carries a distinct-enough value that a
  read's retire observation (the ``obs_val`` ledger plane) names its
  source write, or the initial memory value;
* **co** — coherence order, the per-address order of write *retires*.
  A write retires when its fill/upgrade grants ownership, and
  ownership of a line is serialized by the home node, so retire order
  is the home's serialization order;
* **fr** — from-reads, derived as usual: ``r -fr-> w'`` when
  ``rf(r) -co-> w'`` (reads of the initial value front the whole co).

Two checks run on every case, a third on *pristine* cases only:

* ``write_serialization`` — per node per address, co must agree with
  po (coWW);
* ``sc_per_location`` — per address, po-loc ∪ rf ∪ co ∪ fr acyclic
  (cache coherence proper);
* ``sc_cycle`` — the same union across ALL addresses must be acyclic:
  the engine's lockstep blocking makes it sequentially consistent
  (analysis/litmus.py enumerates the classic shapes to exactly their
  SC sets), and this global check is the only axiom that can see a
  *stale shared copy* — a reader hitting on a line whose INV fan-out
  a mutant skipped observes per-location-consistent but globally
  impossible values (the ``mp_reload`` shape).

**Ghosts.** The engine's sanctioned blind-WRITEBACK races (the quirk
family — see the litmus module docstring) can forward a still-pending
line's reset value 0 to a second-hand requester, drop a write's fill
entirely (the early-unblock quirk), or pair a stray second-hand fill
with the wrong in-flight address — the fill installs the message's
value under the *waiting* address's tag, so a read can observe a
value only ever written to a conflicting line. All three leave a
syntactic mark in the ledger: a read retiring with ``obs_val`` 0 or
-1, a read observing a value foreign to its own address but present
in the run's global value pool (some write's value, or some other
address's initial value), or a write retiring with ``obs_val`` != its
own value. Such an event *taints* its address — the per-address
checks skip tainted addresses, the global check requires a fully
untainted (pristine) case — so the sanctioned races are never misread
as violations while every check that does run is exact. Taint is
counted in ``skips``; a read observing a value that NOTHING in the
run produced (no write anywhere, no initial value anywhere, not the
reset value) is impossible under any sanctioned behavior and stays a
hard ``rf_unresolved`` violation.

Violations carry a replayable witness: the event cycle (or offending
pair) with edge labels, ready for ``analysis/shrink.py`` to minimize
the owning case and ``analysis/fixtures.py`` to emit as a repro.

The port of the JAX package's ``analysis/axioms.py``: the event
extraction and the checker are the same host arithmetic; only
:func:`check_case` changes, capturing on ``device`` (None: the card)
through the port's ``obs/txntrace.capture``. The ledger planes come to
numpy once, in the narrowed dtypes (int8/int16), and every event field
is a Python ``int`` as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import litmus
from ue22cs343bb1_openmp_assignment_tpu_torch.types import Op

SCHEMA_ID = "cache-sim/axioms/v1"

#: ledger capture chunk for :func:`check_case` (cycles a host read)
CAPTURE_CHUNK = 64


# -- event extraction ------------------------------------------------------


# lint: host
def extract_events(cfg, ledger: Dict[str, np.ndarray],
                   base_cycle: int = 0) -> List[dict]:
    """Ledger planes → the retired-event list, sorted (cycle, node).

    One event per set bit of ``obs_retire``. The retiring
    instruction's identity is the node's *current latch*: the
    ``op``/``addr``/``value`` planes are valid at ``fetch`` cycles
    only (on other cycles they carry the frontend's idle output), so
    the walk replays each node's latch — a hit retires at its own
    fetch cycle, a miss/upgrade at its later unblock cycle, and the
    two are exclusive per node per cycle. ``obs_val`` holds what the
    node's own cache answers for the in-flight address at the retire
    boundary; ``idx`` is the per-node program-order index.
    """
    if not ledger:
        return []
    retire = np.asarray(ledger["obs_retire"])
    fetch = np.asarray(ledger["fetch"])
    op = np.asarray(ledger["op"])
    addr = np.asarray(ledger["addr"])
    value = np.asarray(ledger["value"])
    obs = np.asarray(ledger["obs_val"])
    n_nodes = retire.shape[1]
    events: List[dict] = []
    po_idx = [0] * n_nodes
    latch = [None] * n_nodes
    hot = np.nonzero(retire | fetch)
    for t, n in zip(*hot):
        t, n = int(t), int(n)
        if fetch[t, n]:
            latch[n] = (int(op[t, n]), int(addr[t, n]),
                        int(value[t, n]))
        if retire[t, n]:
            l_op, l_addr, l_val = latch[n]
            if l_op == int(Op.NOP):
                po_idx[n] += 1
                continue
            kind = "R" if l_op == int(Op.READ) else "W"
            events.append({
                "node": n, "idx": po_idx[n], "t": base_cycle + t,
                "kind": kind, "addr": l_addr,
                "val": l_val if kind == "W" else None,
                "obs": int(obs[t, n]),
            })
            po_idx[n] += 1
    events.sort(key=lambda e: (e["t"], e["node"]))
    return events


def _fmt(e: dict) -> str:
    body = (f"R 0x{e['addr']:02X} obs={e['obs']}" if e["kind"] == "R"
            else f"W 0x{e['addr']:02X}={e['val']}")
    return f"n{e['node']}#{e['idx']}@{e['t']} {body}"


# -- relation construction + acyclicity ------------------------------------


def _find_cycle(n_nodes: int, edges: List[tuple]) -> Optional[List[int]]:
    """Iterative DFS over (src, dst, label) edges; returns one cycle as
    a vertex list (first == last) or None."""
    adj: List[List[int]] = [[] for _ in range(n_nodes)]
    for s, d, _ in edges:
        adj[s].append(d)
    color = [0] * n_nodes          # 0 unseen / 1 on stack / 2 done
    parent = [-1] * n_nodes
    for root in range(n_nodes):
        if color[root]:
            continue
        stack = [(root, iter(adj[root]))]
        color[root] = 1
        while stack:
            v, it = stack[-1]
            for w in it:
                if color[w] == 0:
                    color[w] = 1
                    parent[w] = v
                    stack.append((w, iter(adj[w])))
                    break
                if color[w] == 1:           # back edge: w .. v -> w
                    cyc, u = [v], v
                    while u != w:
                        u = parent[u]
                        cyc.append(u)
                    cyc.reverse()
                    return cyc + [cyc[0]]
            else:
                color[v] = 2
                stack.pop()
    return None


def _witness(events: List[dict], cyc: List[int],
             edges: List[tuple]) -> List[str]:
    """Render a vertex cycle with one edge label per hop."""
    lab = {(s, d): l for s, d, l in edges}
    out = []
    for a, b in zip(cyc, cyc[1:]):
        out.append(f"{_fmt(events[a])} -{lab.get((a, b), '?')}-> "
                   f"{_fmt(events[b])}")
    return out


# -- the checker -----------------------------------------------------------


# lint: host
def check_events(cfg, events: List[dict],
                 quirks: Optional[dict] = None) -> dict:
    """Check the coherence/consistency axioms over an event list.

    Pure host-side function of its inputs (tests hand-build event
    lists). Returns ``{schema, violations, skips, pristine, stats}``;
    each violation carries ``check``, ``detail`` and a ``witness``
    list of rendered edges. ``quirks`` (the fuzz run's allow-listed
    step-tier counters) only gates the global SC check.
    """
    skips = {"ghost_read": 0, "ghost_write": 0, "ghost_cross": 0,
             "unattributed": 0, "ambiguous_rf": 0, "tainted_addrs": 0}
    violations: List[dict] = []
    by_addr: Dict[int, List[int]] = {}
    for i, e in enumerate(events):
        by_addr.setdefault(e["addr"], []).append(i)
    vals_of = {a: {events[i]["val"] for i in idxs
                   if events[i]["kind"] == "W"}
               for a, idxs in by_addr.items()}
    pool = set().union(*vals_of.values()) if vals_of else set()
    pool |= {litmus.init_val(cfg, a) for a in by_addr}

    # -- per-event classification: ghosts taint their address ----------
    tainted: set = set()
    for i, e in enumerate(events):
        a = e["addr"]
        if e["kind"] == "R":
            own = vals_of[a] | {litmus.init_val(cfg, a)}
            if e["obs"] == -1:
                skips["unattributed"] += 1
                tainted.add(a)
            elif e["obs"] == 0 and 0 not in own:
                skips["ghost_read"] += 1
                tainted.add(a)
            elif e["obs"] not in own and e["obs"] in pool:
                skips["ghost_cross"] += 1
                tainted.add(a)
        elif e["obs"] != e["val"]:
            skips["ghost_write"] += 1
            tainted.add(a)
    skips["tainted_addrs"] = len(tainted)

    # -- rf resolution + per-address relations -------------------------
    ambiguous = False
    all_edges: List[tuple] = []
    for a, idxs in sorted(by_addr.items()):
        if a in tainted:
            continue
        writes = [i for i in idxs if events[i]["kind"] == "W"]
        reads = [i for i in idxs if events[i]["kind"] == "R"]
        init = litmus.init_val(cfg, a)
        co = sorted(writes, key=lambda i: (events[i]["t"],
                                           events[i]["node"]))
        co_pos = {i: k for k, i in enumerate(co)}

        # write_serialization: co must agree with po per node (coWW)
        last: Dict[int, int] = {}
        for i in co:
            n = events[i]["node"]
            if n in last and events[last[n]]["idx"] > events[i]["idx"]:
                violations.append({
                    "check": "write_serialization", "addr": a,
                    "detail": f"0x{a:02X}: co inverts po on node {n}",
                    "witness": [f"{_fmt(events[last[n]])} "
                                f"-co-before-po-> {_fmt(events[i])}"]})
            last[n] = i

        # rf: resolve each read to init or a unique same-value write
        rf: Dict[int, Optional[int]] = {}
        edges: List[tuple] = []
        for r in reads:
            v = events[r]["obs"]
            srcs = [w for w in writes if events[w]["val"] == v]
            if v == init and srcs:                # init/write collision
                skips["ambiguous_rf"] += 1
                ambiguous = True
                continue
            if not srcs and v == init:
                rf[r] = None                      # reads-from-init
            elif len(srcs) == 1:
                rf[r] = srcs[0]
                edges.append((srcs[0], r, "rf"))
            elif not srcs:
                violations.append({
                    "check": "rf_unresolved", "addr": a,
                    "detail": f"0x{a:02X}: read observed {v}, which no "
                              f"write produced and init ({init}) does "
                              "not explain",
                    "witness": [_fmt(events[r])]})
                continue
            else:                                 # duplicate values
                skips["ambiguous_rf"] += 1
                ambiguous = True
                continue
            # fr: r precedes every write co-after rf(r)
            start = co_pos[rf[r]] + 1 if rf[r] is not None else 0
            for w in co[start:]:
                edges.append((r, w, "fr"))
        for w1, w2 in zip(co, co[1:]):
            edges.append((w1, w2, "co"))
        by_node: Dict[int, List[int]] = {}
        for i in idxs:
            by_node.setdefault(events[i]["node"], []).append(i)
        for lst in by_node.values():
            lst.sort(key=lambda i: events[i]["idx"])
            for i1, i2 in zip(lst, lst[1:]):
                edges.append((i1, i2, "po-loc"))

        cyc = _find_cycle(len(events), edges)
        if cyc is not None:
            violations.append({
                "check": "sc_per_location", "addr": a,
                "detail": f"0x{a:02X}: po-loc ∪ rf ∪ co ∪ fr is cyclic",
                "witness": _witness(events, cyc, edges)})
        all_edges.extend(edges)

    # -- global SC: pristine cases only --------------------------------
    pristine = (not tainted and not ambiguous and not (quirks or {})
                and not violations)
    if pristine and events:
        by_node = {}
        for i, e in enumerate(events):
            by_node.setdefault(e["node"], []).append(i)
        sc_edges = list(all_edges)
        for lst in by_node.values():
            lst.sort(key=lambda i: events[i]["idx"])
            for i1, i2 in zip(lst, lst[1:]):
                sc_edges.append((i1, i2, "po"))
        cyc = _find_cycle(len(events), sc_edges)
        if cyc is not None:
            violations.append({
                "check": "sc_cycle",
                "detail": "po ∪ rf ∪ co ∪ fr is cyclic: no sequentially "
                          "consistent order explains this execution",
                "witness": _witness(events, cyc, sc_edges)})
    return {"schema": SCHEMA_ID, "violations": violations,
            "skips": skips, "pristine": pristine,
            "stats": {"events": len(events),
                      "addrs": len(by_addr),
                      "edges": len(all_edges)}}


# lint: host
def check_case(case, message_phase: Optional[Callable] = None,
               max_cycles: Optional[int] = None,
               quirks: Optional[dict] = None, device=None) -> dict:
    """Capture one fuzz case's ledger and check it.

    Runs the async engine to quiescence under ledger capture
    (obs/txntrace.capture — the same capture the span reconstruction
    uses) on ``device`` (None: the card) and returns the
    :func:`check_events` report plus ``events`` and ``final_state``
    (the litmus outcome-membership check in analysis/fuzz.py consumes
    both).
    """
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import fuzz
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import txntrace
    cfg = case.config()
    st = fuzz.case_state(case, device)
    fin, ledger, base = txntrace.capture(
        cfg, st, max_cycles or fuzz.MAX_CYCLES, chunk=CAPTURE_CHUNK,
        message_phase=message_phase, with_obs=True)
    events = extract_events(cfg, ledger, base)
    rep = check_events(cfg, events, quirks=quirks)
    rep["events"] = events
    rep["final_state"] = fin
    return rep
