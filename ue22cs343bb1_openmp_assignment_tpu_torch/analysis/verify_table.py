"""Table-level static verification: protocol properties without simulation.

The port of the JAX package's ``analysis/verify_table.py``, over the
port's tables. Four pure passes over an
:class:`.protocol_table.ProtocolTable` (no tensors, no state space,
milliseconds each):

* **totality + determinism** — for every message type, enumerate the
  full product of its declared guard-atom domains and require *exactly
  one* matching row per point. Zero rows is a hole (a reachable
  receiver predicate the protocol doesn't define — the dropped-row
  mutant); two is an overlap (nondeterministic dispatch — the
  guard-overlap mutant). A row guarding on an atom outside its
  message's declared domain is rejected first, since it would make the
  enumeration unsound.
* **ownership conservation** — per directory-writing row, exhaustively
  enumerate abstract pre-states (sharer bitvector over a 4-node
  universe with requester/second aliasing x 3 directory states),
  filter by the directory trio of invariants + the row's guard and
  ``assumes``, apply the row's directory effect, and require the trio
  to still hold. This is the inductive step of "the directory never
  lies": EM names exactly one owner, S at least one sharer, U none.
  A second sub-pass rejects double-grants (a row that both installs
  M/E locally and sends an ownership-granting reply).
* **stability** — a row that sends messages but changes *no* state is a
  pure forwarder: if following pure-forwarder emissions ever cycles
  back to the originating message type, the guard that fired re-fires
  on identical state and the messages circulate forever without an
  intervening state change. Require the pure-forwarder emission graph
  to be acyclic (conservative livelock check; the model checker's
  Tarjan pass is the dynamic ground truth).
* **anchors** — every row must cite an ``assignment.c`` anchor from
  :data:`..ops.handlers.TRANSITION_ANCHORS` for its message and only
  documented quirk ids from :data:`..ops.handlers.QUIRKS`, and every
  registered anchor/quirk must be cited by some row — the table and
  the hand-written handlers are forced to name the same reference
  code, so either drifting from the C is a loud failure.

``verify(table)`` returns a report dict shaped like the model checker's
(``ok`` + ``findings`` with kind/detail), consumed by runner ``--table``
and tests/test_torch_analysis.py.
"""

from __future__ import annotations

import itertools

from ue22cs343bb1_openmp_assignment_tpu_torch.analysis.protocol_table import (
    ATOM_DOMAINS, CacheWrite, ClearWait, DirWrite, InvFanout, MemWrite,
    ProtocolTable, Replace, Row, Send, guard_holds)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import handlers
from ue22cs343bb1_openmp_assignment_tpu_torch.types import (CacheState,
                                                            DirState, Msg)

_M, _E = int(CacheState.MODIFIED), int(CacheState.EXCLUSIVE)
_EM, _DS, _U = int(DirState.EM), int(DirState.S), int(DirState.U)

_MSG_NAME = {int(m): m.name for m in Msg if m is not Msg.NONE}


def _atom_domain(table: ProtocolTable, atom: str) -> tuple:
    if atom == "cache_state":
        return table.cache_states
    return ATOM_DOMAINS[atom]


def check_totality_determinism(table: ProtocolTable) -> list:
    """Exactly-one-row over each message's declared guard-atom product."""
    findings = []
    for msg, name in _MSG_NAME.items():
        if msg not in table.domains:
            findings.append(dict(kind="missing_domain", message=name,
                                 detail=f"no guard domain declared for "
                                        f"{name}"))
            continue
        atoms = table.domains[msg]
        rows = table.rows_for(msg)
        if not rows:
            findings.append(dict(kind="totality_hole", message=name,
                                 detail=f"no rows at all for {name}"))
            continue
        for r in rows:
            extra = set(r.guard.atoms()) - set(atoms)
            if extra:
                findings.append(dict(
                    kind="undeclared_atom", message=name, row=r.name,
                    detail=f"row {r.name} guards on {sorted(extra)} outside "
                           f"the declared {name} domain {atoms}"))
        domains = [_atom_domain(table, a) for a in atoms]
        for point in itertools.product(*domains):
            val = dict(zip(atoms, point))
            # set-valued atoms match by membership: present scalars as-is
            matches = [r for r in rows if _guard_at(r, val)]
            where = f"{name}{val}" if val else name
            if not matches:
                findings.append(dict(
                    kind="totality_hole", message=name, point=val,
                    detail=f"no row matches {where}"))
            elif len(matches) > 1:
                findings.append(dict(
                    kind="determinism_overlap", message=name, point=val,
                    rows=[r.name for r in matches],
                    detail=f"rows {[r.name for r in matches]} all match "
                           f"{where}"))
    return findings


def _guard_at(row: Row, val: dict) -> bool:
    """guard_holds restricted to the enumerated atoms (others don't-care)."""
    g = row.guard
    probe = dict(val)
    for a in g.atoms():
        if a not in probe:
            return False        # undeclared atom; reported separately
    return guard_holds(g, probe)


# ---------------------------------------------------------------------------
# ownership conservation
# ---------------------------------------------------------------------------

# abstract 4-node universe: sender is node 0, the message's `second`
# aliases the sender (c=0) or not (c=1), nodes 2 and 3 are bystanders.
_NODES = (0, 1, 2, 3)


def _trio_ok(ds: int, bv: frozenset) -> bool:
    if ds == _EM:
        return len(bv) == 1     # EM names exactly one owner
    if ds == _DS:
        return len(bv) >= 1     # S has at least one sharer
    return len(bv) == 0         # U names none


def _others_class(bv: frozenset, sender: int) -> str:
    n = len(bv - {sender})
    return "0" if n == 0 else ("1" if n == 1 else "2+")


def _dir_guard_ok(g, ds: int, bv: frozenset, sender: int) -> bool:
    if g.dir_state is not None and ds not in g.dir_state:
        return False
    if g.others is not None and _others_class(bv, sender) not in g.others:
        return False
    return True


def _apply_bv(expr: str, bv: frozenset, sender: int, second: int):
    return {
        "bv|sender": bv | {sender},
        "bv|second": bv | {second},
        "sender": frozenset({sender}),
        "second": frozenset({second}),
        "bv-sender": bv - {sender},
        "empty": frozenset(),
    }[expr]


_DS_BY_NAME = {"EM": _EM, "S": _DS, "U": _U}

_GRANT_TYPES = {int(Msg.REPLY_WR), int(Msg.REPLY_ID)}


def check_conservation(table: ProtocolTable) -> list:
    """Inductive preservation of the directory trio, row by row."""
    findings = []
    sender = 0
    for r in table.rows:
        dws = [e for e in r.effects if isinstance(e, DirWrite)]
        for dw in dws:
            for bv_bits in itertools.chain.from_iterable(
                    itertools.combinations(_NODES, k)
                    for k in range(len(_NODES) + 1)):
                bv = frozenset(bv_bits)
                for ds in (_EM, _DS, _U):
                    for second in (0, 1):
                        if not _trio_ok(ds, bv):
                            continue
                        if not _dir_guard_ok(r.guard, ds, bv, sender):
                            continue
                        if not _dir_guard_ok(r.assumes, ds, bv, sender):
                            continue
                        nds = _DS_BY_NAME[dw.state] \
                            if dw.state is not None else ds
                        nbv = _apply_bv(dw.bv, bv, sender, second) \
                            if dw.bv is not None else bv
                        if not _trio_ok(nds, nbv):
                            findings.append(dict(
                                kind="conservation_violation", row=r.name,
                                pre=dict(dir=ds, bv=sorted(bv),
                                         second=second),
                                post=dict(dir=nds, bv=sorted(nbv)),
                                detail=f"row {r.name}: pre dir={ds} "
                                       f"bv={sorted(bv)} second={second} "
                                       f"-> post dir={nds} bv={sorted(nbv)}"
                                       f" breaks the directory trio"))
        # double-grant: installing ownership locally while also granting it
        installs = any(isinstance(e, CacheWrite) and e.state in (_M, _E)
                       for e in r.effects)
        grants = any(isinstance(e, Send) and
                     (e.type in _GRANT_TYPES or e.bitvec == "others")
                     for e in r.effects)
        if installs and grants:
            findings.append(dict(
                kind="double_grant", row=r.name,
                detail=f"row {r.name} installs M/E locally and also sends "
                       f"an ownership grant"))
    return findings


# ---------------------------------------------------------------------------
# stability
# ---------------------------------------------------------------------------

_STATE_EFFECTS = (CacheWrite, DirWrite, MemWrite, ClearWait, Replace,
                  InvFanout)


def check_stability(table: ProtocolTable) -> list:
    """Pure-forwarder emission graph must be acyclic."""
    edges: dict = {}
    for r in table.rows:
        sends = [e for e in r.effects if isinstance(e, Send)]
        changes = any(isinstance(e, _STATE_EFFECTS) for e in r.effects)
        if sends and not changes:
            edges.setdefault(r.msg, set()).update(e.type for e in sends)
    findings = []
    for start in edges:
        stack, seen = [(start, (start,))], set()
        while stack:
            node, path = stack.pop()
            for nxt in edges.get(node, ()):
                if nxt == start:
                    cyc = [_MSG_NAME[m] for m in path + (nxt,)]
                    findings.append(dict(
                        kind="stability_cycle", cycle=cyc,
                        detail="pure-forwarder rows circulate without a "
                               "state change: " + " -> ".join(cyc)))
                elif nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + (nxt,)))
    return findings


# ---------------------------------------------------------------------------
# anchors
# ---------------------------------------------------------------------------

def check_anchors(table: ProtocolTable) -> list:
    findings = []
    cited_anchors: dict = {}
    cited_quirks: set = set()
    for r in table.rows:
        name = _MSG_NAME[r.msg]
        registered = handlers.TRANSITION_ANCHORS.get(name, ())
        if r.anchor not in registered:
            findings.append(dict(
                kind="unknown_anchor", row=r.name,
                detail=f"row {r.name} cites {r.anchor}, not a registered "
                       f"{name} anchor {registered}"))
        cited_anchors.setdefault(name, set()).add(r.anchor)
        for q in r.quirks:
            if q not in handlers.QUIRKS:
                findings.append(dict(
                    kind="unknown_quirk", row=r.name,
                    detail=f"row {r.name} cites undocumented quirk {q}"))
            cited_quirks.add(q)
    for name, anchors in handlers.TRANSITION_ANCHORS.items():
        missing = set(anchors) - cited_anchors.get(name, set())
        if missing:
            findings.append(dict(
                kind="uncited_anchor", message=name,
                detail=f"registered {name} anchors never cited by any row: "
                       f"{sorted(missing)}"))
    missing_q = set(handlers.QUIRKS) - cited_quirks
    if missing_q:
        findings.append(dict(
            kind="uncited_quirk",
            detail=f"documented quirks never cited by any row: "
                   f"{sorted(missing_q)}"))
    return findings


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

PASSES = (
    ("totality_determinism", check_totality_determinism),
    ("conservation", check_conservation),
    ("stability", check_stability),
    ("anchors", check_anchors),
)


def verify(table: ProtocolTable) -> dict:
    """Run all passes; report in the model checker's shape."""
    findings, passes = [], {}
    for pname, fn in PASSES:
        f = fn(table)
        passes[pname] = "fail" if f else "ok"
        findings.extend(f)
    return dict(
        table=table.name, protocol=table.protocol, rows=len(table.rows),
        passes=passes, findings=findings, ok=not findings,
    )
