"""Declarative memory-consistency litmus suite (herd-style).

Each :class:`LitmusTest` is a symbolic multi-node program — per-node
sequences of reads and writes over the two symbolic addresses ``x`` and
``y`` — plus its *expected outcome set*: every (read observations +
final values) tuple the engine's lockstep semantics may legally
produce. The engine blocks each node on every miss/upgrade with at most
one outstanding operation (``assignment.c:624-735``), so its executions
are sequentially consistent and the allowed sets below are the SC sets
of the classic tests (Alglave, Maranget & Tautschnig, "Herding Cats",
TOPLAS 2014 — see PAPERS.md).

The port of the JAX package's ``analysis/litmus.py``. Three consumers
share one compilation path:

* the **model checker** (analysis/model_check.py, ``track_obs=True``)
  enumerates EVERY reachable outcome of a test's scope and the suite
  diffs that set against ``allowed`` — exact equality, both directions:
  an unexpected outcome is a consistency violation, an unobserved one
  means the scope lost interleavings;
* the **fuzzer** (analysis/fuzz.py) seeds the suite's traces into its
  corpus at reference dimensions (:func:`seed_cases`) and checks every
  run of a litmus-tagged case for membership in ``allowed``
  (:func:`check_run_outcome`);
* the **axiomatic checker** (analysis/axioms.py) replays any captured
  run — litmus or fuzzed — against the po/rf/co/fr axioms.

Symbolic conventions: addresses ``x`` = (home 0, block 1) and ``y`` =
(home 1, block 0) — distinct homes, distinct direct-mapped cache slots,
and each writer below writes only the address it homes, so a reader's
fill and the INV that kills it always share a sender (FIFO keeps them
ordered). Values ``x0``/``y0`` denote the reference initial memory
pattern ``(20*home + block) & 0xFF`` (so x0 = 1, y0 = 20); write
values start at 65, clear of every initial value and of the -1
unattributed sentinel. No litmus address has initial value 0: the
engine's sanctioned blind-WRITEBACK races (quirk family, see
ARCHITECTURE.md) can forward a still-pending line's *reset* value 0 to
a second-hand requester, so a read may observe a ghost 0 nobody wrote.
Keeping 0 out of the init/write value space makes ghosts syntactically
recognizable — a literal ``0`` in an ``allowed`` entry below always
marks such a sanctioned ghost outcome, and the axiomatic checker
(analysis/axioms.py) treats an observed 0 as a ghost read rather than
an unresolvable reads-from edge.
"""

from __future__ import annotations

import dataclasses

from ue22cs343bb1_openmp_assignment_tpu_torch import codec
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.types import Op

# symbolic write values (distinct per address, never an init value)
A, B, C, D = 65, 66, 67, 68


@dataclasses.dataclass(frozen=True)
class LitmusTest:
    """One symbolic litmus test.

    ``programs``: per node, a tuple of ``("R", sym)`` / ``("W", sym,
    value)`` instructions, ``sym`` in {"x", "y"}.
    ``allowed``: the complete set of legal outcome tuples — every READ's
    observed value in node-major program order, then the final value of
    each ``final_addrs`` entry. Entries are ints or the symbolic init
    tokens ``"x0"`` / ``"y0"``.
    """

    name: str
    doc: str
    programs: tuple
    allowed: tuple
    final_addrs: tuple = ()

    @property
    def num_nodes(self) -> int:
        return len(self.programs)

    def to_dict(self) -> dict:
        return {"name": self.name, "doc": self.doc,
                "programs": [list(map(list, p)) for p in self.programs],
                "allowed": sorted(map(list, self.allowed)),
                "final_addrs": list(self.final_addrs)}


def _R(sym):
    return ("R", sym)


def _W(sym, val):
    return ("W", sym, val)


#: iriw's sanctioned ghost outcomes (literal 0 = the blind-WRITEBACK
#: race of the module docstring; witnessed by the model checker). The
#: race needs three same-address transactions in flight — a reader
#: granted EXCLUSIVE, the writer's WRITEBACK_* fan-out, and a second
#: reader whose forwarded FLUSH arrives from a node whose own fill is
#: still pending — so only the 4-node test can reach it; every 2-node
#: shape above enumerates to exactly its SC set. Outcome slots are
#: (Rx@n2, Ry@n2, Ry@n3, Rx@n3); the canonical forbidden outcome
#: (A, y0, B, x0) stays unreachable even among the ghosts.
_IRIW_GHOSTS = (
    (0, 0, "y0", "x0"), (0, "y0", "y0", "x0"), (0, B, "y0", "x0"),
    (0, B, B, "x0"), ("x0", 0, "y0", 0), ("x0", 0, "y0", "x0"),
    ("x0", 0, "y0", A), ("x0", "y0", 0, 0), ("x0", "y0", 0, "x0"),
    ("x0", "y0", 0, A), ("x0", "y0", "y0", 0), ("x0", "y0", B, 0),
    ("x0", B, "y0", 0), ("x0", B, B, 0), (A, 0, "y0", "x0"),
    (A, 0, "y0", A), (A, "y0", 0, A))


#: the builtin suite: the classic coherence/SC shapes plus `mp_reload`,
#: a reload variant whose forbidden outcomes need a *stale shared copy*
#: to manifest — the shape that catches a skipped INV fan-out, which no
#: two-read classic test can see (a stale copy yields only old values,
#: which per-location look like "the write simply came last").
BUILTIN = {t.name: t for t in (
    LitmusTest(
        "corr", "coherent read-read: two reads of one location may "
        "never observe the write order backwards",
        ((_W("x", A),), (_R("x"), _R("x"))),
        (("x0", "x0"), ("x0", A), (A, A))),
    LitmusTest(
        "coww", "coherent write-write: program-order writes to one "
        "location serialize in order",
        ((_W("x", A), _W("x", B)),),
        ((B,),), final_addrs=("x",)),
    LitmusTest(
        "corw", "coherent read-write: a read may not observe its own "
        "node's later write's successor",
        ((_R("x"), _W("x", B)), (_W("x", A),)),
        (("x0", A), ("x0", B), (A, B)), final_addrs=("x",)),
    LitmusTest(
        "cowr", "coherent write-read: a read after a local write "
        "observes that write or a co-later one",
        ((_W("x", A), _R("x")), (_W("x", B),)),
        ((A, A), (A, B), (B, B)), final_addrs=("x",)),
    LitmusTest(
        "mp", "message passing: observing the flag write implies "
        "observing the data write",
        ((_W("x", A), _W("y", B)), (_R("y"), _R("x"))),
        (("y0", "x0"), ("y0", A), (B, A))),
    LitmusTest(
        "sb", "store buffering: both readers observing initial values "
        "is forbidden under SC",
        ((_W("x", A), _R("y")), (_W("y", B), _R("x"))),
        (("y0", A), (B, "x0"), (B, A))),
    LitmusTest(
        "lb", "load buffering: both loads observing the other node's "
        "later store is forbidden",
        ((_R("x"), _W("y", B)), (_R("y"), _W("x", A))),
        (("x0", "y0"), ("x0", B), (A, "y0"))),
    LitmusTest(
        "2+2w", "two-plus-two writes: both first writes losing to the "
        "other node's po-earlier write is forbidden",
        ((_W("x", A), _W("y", B)), (_W("y", C), _W("x", D))),
        ((D, C), (A, B), (D, B)), final_addrs=("x", "y")),
    LitmusTest(
        "iriw", "independent reads of independent writes: the two "
        "readers must agree on the write order",
        ((_W("x", A),), (_W("y", B),),
         (_R("x"), _R("y")), (_R("y"), _R("x"))),
        tuple((rx2, ry2, ry3, rx3)
              for rx2 in ("x0", A) for ry2 in ("y0", B)
              for ry3 in ("y0", B) for rx3 in ("x0", A)
              if (rx2, ry2, ry3, rx3) != (A, "y0", B, "x0"))
        + _IRIW_GHOSTS),
    LitmusTest(
        "mp_reload", "message passing with a reload: a reader that saw "
        "the flag may never fall back to the stale data value — the "
        "stale-refill detector (the reload is owner-forwarded, so a "
        "fill that resurrects a dead local copy shows up here)",
        ((_W("x", A), _W("y", B)), (_R("x"), _R("y"), _R("x"))),
        (("x0", "y0", "x0"), ("x0", "y0", A), (A, "y0", A),
         ("x0", B, A), (A, B, A))),
    LitmusTest(
        "mp_upgrade", "mp_reload with a read on the writer's own node "
        "first: both nodes share x, so the data write must take the "
        "UPGRADE -> REPLY_ID -> INV fan-out path — the stale-SHARED-"
        "copy detector (a skipped invalidation leaves the reader "
        "hitting on dead data, which only the cross-address SC check "
        "can see). The writer's own read is po-before its write, so "
        "it always observes x0",
        ((_R("x"), _W("x", A), _W("y", B)),
         (_R("x"), _R("y"), _R("x"))),
        (("x0", "x0", "y0", "x0"), ("x0", "x0", "y0", A),
         ("x0", A, "y0", A), ("x0", "x0", B, A), ("x0", A, B, A))),
)}


# ---------------------------------------------------------------------------
# concretization: symbols -> one cfg's addresses/values
# ---------------------------------------------------------------------------

def litmus_cfg(num_nodes: int, protocol: str = "mesi") -> SystemConfig:
    """The enumeration configuration of a litmus scope: 2 memory blocks
    (so x and y exist), 2 direct-mapped lines (so x and y occupy
    DIFFERENT slots — litmus outcomes must not alias through conflict
    evictions), exact-reference mailbox INV semantics."""
    return SystemConfig(num_nodes=num_nodes, cache_size=2, mem_size=2,
                        queue_capacity=16, max_instrs=4,
                        inv_mode="mailbox", protocol=protocol)


def addr_of(cfg: SystemConfig, sym: str) -> int:
    """x = (home 0, block 1), y = (home 1, block 0) — nonzero-init
    blocks, so an observed 0 is always a ghost (module docstring)."""
    if sym == "x":
        return codec.make_address(cfg, 0, 1)
    if sym == "y":
        return codec.make_address(cfg, 1 % cfg.num_nodes, 0)
    raise ValueError(f"unknown litmus symbol {sym!r}")


def init_val(cfg: SystemConfig, addr: int) -> int:
    """Reference initial memory: block b of home h starts (20h+b)&0xFF
    (state.init_state, assignment.c:806-851)."""
    return (20 * codec.home_node(cfg, addr)
            + codec.block_index(cfg, addr)) & 0xFF


def concretize(test: LitmusTest, cfg: SystemConfig) -> dict:
    """Resolve a test's symbols against one configuration: concrete
    per-node traces in the engine trace format, the concrete allowed
    outcome set, and the concrete final-value addresses."""
    if cfg.num_nodes < test.num_nodes:
        raise ValueError(f"{test.name} needs {test.num_nodes} nodes")
    sym_init = {"x0": init_val(cfg, addr_of(cfg, "x")),
                "y0": init_val(cfg, addr_of(cfg, "y"))}

    def val(v):
        return sym_init[v] if isinstance(v, str) else int(v)

    traces = []
    for prog in test.programs:
        tr = []
        for ins in prog:
            if ins[0] == "R":
                tr.append((int(Op.READ), addr_of(cfg, ins[1]), 0))
            else:
                tr.append((int(Op.WRITE), addr_of(cfg, ins[1]),
                           int(ins[2])))
        traces.append(tuple(tr))
    return {
        "traces": tuple(traces),
        "allowed": frozenset(tuple(val(v) for v in out)
                             for out in test.allowed),
        "final_addrs": tuple(addr_of(cfg, s) for s in test.final_addrs),
        "init": sym_init,
    }


def to_scope(test: LitmusTest, protocol: str = "mesi"):
    """The test as a model-checker Scope (reference memory init, so the
    enumeration starts from exactly the state a real run starts from;
    the symmetry group collapses to the identity, which is fine at
    these scope sizes)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis.model_check import (
        Scope)
    cfg = litmus_cfg(test.num_nodes, protocol)
    conc = concretize(test, cfg)
    return Scope(f"litmus_{test.name}", cfg, conc["traces"])


def message_phase_for(protocol: str):
    """None (the live handlers) for MESI; the compiled table phase for
    the table variants."""
    if protocol == "mesi":
        return None
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis.protocol_table \
        import TABLES, table_message_phase
    return table_message_phase(TABLES[protocol]())


# ---------------------------------------------------------------------------
# enumeration: model-checker outcome set vs the DSL's allowed set
# ---------------------------------------------------------------------------

def enumerate_outcomes(test: LitmusTest, protocol: str = "mesi",
                       message_phase=None,
                       max_states: int = 200_000, device=None,
                       tally=None) -> dict:
    """Exhaustively enumerate the test's reachable outcomes under one
    protocol and diff against the DSL's allowed set (exact equality).

    ``message_phase`` overrides the handler phase (mutation testing);
    by default it follows the protocol. The oracle runs on ``device``
    (None: the card). Raises ScopeTooLarge past ``max_states`` (the
    runner maps that to the budget exit)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis.model_check import (
        ModelChecker)
    if message_phase is None:
        message_phase = message_phase_for(protocol)
    scope = to_scope(test, protocol)
    conc = concretize(test, scope.cfg)
    ck = ModelChecker(scope, message_phase=message_phase,
                      max_states=max_states, track_obs=True,
                      final_addrs=conc["final_addrs"], device=device,
                      tally=tally)
    rep = ck.run()
    observed = frozenset(tuple(o) for o in rep["outcomes"])
    unexpected = sorted(observed - conc["allowed"])
    unobserved = sorted(conc["allowed"] - observed)
    return {
        "test": test.name,
        "protocol": protocol,
        "allowed": sorted(conc["allowed"]),
        "observed": sorted(observed),
        "unexpected": unexpected,
        "unobserved": unobserved,
        "violations": [v["name"] for v in rep["violations"]],
        "stats": rep["stats"],
        "ok": bool(not unexpected and not unobserved
                   and not rep["violations"]),
    }


def run_suite(tests=None, protocols=("mesi",), message_phase=None,
              max_states: int = 200_000, progress=None,
              device=None, tally=None) -> dict:
    """The full (protocol x test) matrix. Returns {protocol: {test:
    enumeration report}}; ScopeTooLarge becomes a budget_exhausted
    entry (runner exit 3) instead of aborting the sweep."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis.model_check import (
        ScopeTooLarge)
    names = list(tests) if tests else list(BUILTIN)
    out = {}
    for proto in protocols:
        out[proto] = {}
        for name in names:
            if name not in BUILTIN:
                raise KeyError(
                    f"unknown litmus test {name!r} "
                    f"(builtin: {', '.join(sorted(BUILTIN))})")
            try:
                rep = enumerate_outcomes(
                    BUILTIN[name], protocol=proto,
                    message_phase=message_phase, max_states=max_states,
                    device=device, tally=tally)
            except ScopeTooLarge as e:
                rep = {"test": name, "protocol": proto, "ok": None,
                       "budget_exhausted": True, "detail": str(e)}
            out[proto][name] = rep
            if progress:
                progress(proto, name, rep)
    return out


# ---------------------------------------------------------------------------
# fuzzer seeding: the suite as corpus cases at reference dimensions
# ---------------------------------------------------------------------------

#: corpus-seeding order: the discriminating shapes first, so a
#: truncated seed budget (fuzz seeds ``n_cases // 2`` litmus cases)
#: still carries the stale-copy detector and the classic MP/SB pair
SEED_ORDER = ("mp_reload", "mp_upgrade", "mp", "sb", "corr", "cowr",
              "corw", "lb", "2+2w", "iriw", "coww")


def to_fuzz_case(test: LitmusTest, case_id: int):
    """The test as a litmus-tagged FuzzCase at reference dimensions
    (same symbolic concretization — the init-value formula is
    dimension-independent, so the allowed set carries over)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import fuzz
    n = test.num_nodes
    cfg = SystemConfig.reference(num_nodes=n)
    conc = concretize(test, cfg)
    local = all(codec.home_node(cfg, ins[1]) == node
                for node, tr in enumerate(conc["traces"])
                for ins in tr)
    return fuzz.FuzzCase(
        case_id=case_id, num_nodes=n, traces=conc["traces"],
        delays=(0,) * n, periods=(1,) * n, rank=tuple(range(n)),
        local=local, litmus=test.name)


def seed_cases(max_n: int) -> tuple:
    """The first ``max_n`` builtin tests in SEED_ORDER as fuzz corpus
    seeds (case ids 0..max_n-1)."""
    return tuple(to_fuzz_case(BUILTIN[name], i)
                 for i, name in enumerate(SEED_ORDER[:max_n]))


def check_run_outcome(test: LitmusTest, cfg: SystemConfig, events,
                      final_state) -> dict | None:
    """Membership check for ONE concrete run of a litmus-tagged case:
    assemble the run's outcome tuple from the axiomatic checker's
    extracted events (reads node-major in program order) plus the
    final values of final_addrs, and test it against ``allowed``.
    Returns a finding dict on a forbidden outcome, else None. Runs
    with an unattributed (obs -1, early-unblock quirk) or ghost
    (obs 0, blind-WRITEBACK race — module docstring) read are
    skipped — the outcome tuple is not well defined there."""
    import numpy as np
    conc = concretize(test, cfg)
    reads = [e["obs"]
             for e in sorted(events, key=lambda e: (e["node"], e["idx"]))
             if e["kind"] == "R"]
    if any(v <= 0 for v in reads):
        return None
    from ue22cs343bb1_openmp_assignment_tpu_torch.convert import (
        sim_numpy_leaves)
    leaves = sim_numpy_leaves(final_state)     # dir_bitvec as uint32
    dir_state = leaves["dir_state"]
    dir_bv = leaves["dir_bitvec"]
    cache_addr = leaves["cache_addr"]
    cache_val = leaves["cache_val"]
    cache_state = leaves["cache_state"]
    memory = leaves["memory"]
    from ue22cs343bb1_openmp_assignment_tpu_torch.types import CacheState, \
        DirState

    def final_value(addr):
        h = codec.home_node(cfg, addr)
        b = codec.block_index(cfg, addr)
        if int(dir_state[h, b]) == int(DirState.EM):
            cidx = codec.cache_index(cfg, addr)
            for nn in range(cfg.num_nodes):
                if ((int(dir_bv[h, b, nn // 32]) >> (nn % 32)) & 1
                        and int(cache_addr[nn, cidx]) == addr
                        and int(cache_state[nn, cidx])
                        != int(CacheState.INVALID)):
                    return int(cache_val[nn, cidx])
        return int(memory[h, b])

    outcome = tuple(reads) + tuple(final_value(a)
                                   for a in conc["final_addrs"])
    if outcome in conc["allowed"]:
        return None
    return {
        "check": "litmus_outcome",
        "test": test.name,
        "outcome": list(outcome),
        "allowed": sorted(map(list, conc["allowed"])),
        "detail": f"litmus {test.name}: forbidden outcome "
                  f"{outcome} (allowed: {sorted(conc['allowed'])})",
    }
