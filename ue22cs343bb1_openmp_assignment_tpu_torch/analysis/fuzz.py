"""Coverage-guided differential fuzzing: random traces, three engines.

The model checker's scopes are exhaustive but tiny; the fuzzer trades
exhaustiveness for reach — seeded random instruction traces at the
reference dimensions, run differentially against independently written
engines. The async engine and the native C++ oracle implement the same
deterministic cycle model, so under identical schedule knobs they must
agree state-for-state on *any* traffic; the transactional sync engine
joins the comparison on node-local (schedule-independent) cases.
Everything is derived from one ``numpy`` Generator, so a seed fully
determines the corpus and every verdict.

Oracles, in check order (first hit is the verdict):

* ``hang`` — async and native disagree on quiescence within the budget
* ``state`` — an architectural array differs between async and native
* ``invariant`` — engine-tier step invariant nonzero on the final state
* ``consistency`` — the axiomatic checker (analysis/axioms.py) finds a
  po/rf/co/fr axiom violation in the run's message ledger, or a
  litmus-tagged seed (analysis/litmus.py) lands outside its allowed
  outcome set. The check needs a second, ledger-instrumented run of
  the case, so it fires on every litmus-tagged case but only a
  deterministic quarter of untagged ones (``case_id % 4 == 0``)
* ``coherence`` — node-local (race-free) case with a nonzero
  coherence-tier count (must be exactly zero without races)
* ``sync`` — node-local case where the transactional engine disagrees

Coverage signal is :func:`obs.schema.coverage_signature` over the async
run's metrics report plus final directory-state occupancy: a case that
lights up a new (message-type set, latency-bucket set, occupancy)
combination joins the corpus and seeds later mutations; the rest are
discarded. Handler mutants inject through the same ``message_phase``
hook the model checker uses (analysis/mutations.py).

The port of the JAX package's ``analysis/fuzz.py``: the generation code
is the same numpy code, so a seed gives the JAX package's corpus case
for case, and the reports are equal byte for byte. The async and sync
runs go on ``device`` (None: the card); the native oracle runs on the
host. Tensors come to the host only at the oracle boundaries:
quiescence, the six compared arrays (in the JAX dtypes, through
``convert.sim_numpy_leaves``: the port keeps ``dir_bitvec`` as int32 bit
patterns), the invariant counts, the metrics doc and the directory
occupancy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np

from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.convert import (
    host, sim_numpy_leaves)
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import schema
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import invariants, step
from ue22cs343bb1_openmp_assignment_tpu_torch.state import init_state
from ue22cs343bb1_openmp_assignment_tpu_torch.types import DirState

SCHEMA_ID = "cache-sim/fuzz/v1"

#: per-case cycle budget; quiescence past this is a ``hang`` verdict.
#: Clean reference-dimension runs of <=32 instrs quiesce well under it.
MAX_CYCLES = 2048

#: architectural arrays compared between engines, async field order
ARRAYS = ("cache_addr", "cache_val", "cache_state", "memory",
          "dir_state", "dir_bitvec")

#: (num_nodes, n_instrs) pool. Two node counts on purpose: the corpus
#: mutates traces far more cheaply than dimensions.
DIMS = ((2, 12), (4, 16))

#: Step-tier names that are *reference behavior* under eviction races,
#: not engine bugs — the async and native states are bit-identical when
#: they fire (the ``state`` oracle runs first and passed). Mechanism:
#: an owner conflict-evicts while a remote WRITE_REQUEST is in flight;
#: the home has already re-pointed the directory at the requester, the
#: late EVICT_MODIFIED blindly resets the entry to U
#: (``assignment.c:596-616``), and the FLUSH_INVACK then re-adds the
#: requester's bit under U.
QUIRK_STEP_ALLOWLIST = frozenset({"unowned_with_sharers"})


@dataclasses.dataclass(frozen=True)
class FuzzCase:
    """One reproducible differential workload (everything a rerun
    needs; serialized verbatim into findings and shrunk repros)."""

    case_id: int
    num_nodes: int
    #: per node, a tuple of (op, addr, value) triples
    traces: tuple
    delays: tuple
    periods: tuple
    rank: tuple
    #: node-local (race-free) traffic — sync + coherence oracles join
    local: bool
    #: builtin litmus test name when this case is a seeded litmus
    #: workload (analysis/litmus.to_fuzz_case) — the consistency
    #: oracle additionally checks the run's outcome tuple against the
    #: test's allowed set. Mutation drops the tag (a mutated trace is
    #: no longer that litmus test).
    litmus: Optional[str] = None

    def config(self) -> SystemConfig:
        return SystemConfig.reference(num_nodes=self.num_nodes)

    def trace_lists(self) -> list:
        return [[tuple(int(x) for x in ins) for ins in tr]
                for tr in self.traces]

    def to_dict(self) -> dict:
        return {"case_id": self.case_id, "num_nodes": self.num_nodes,
                "traces": [[list(i) for i in tr] for tr in self.traces],
                "delays": list(self.delays),
                "periods": list(self.periods),
                "rank": list(self.rank), "local": self.local,
                "litmus": self.litmus}


def case_from_dict(d: dict) -> FuzzCase:
    return FuzzCase(
        case_id=int(d["case_id"]), num_nodes=int(d["num_nodes"]),
        traces=tuple(tuple(tuple(int(x) for x in i) for i in tr)
                     for tr in d["traces"]),
        delays=tuple(int(x) for x in d["delays"]),
        periods=tuple(int(x) for x in d["periods"]),
        rank=tuple(int(x) for x in d["rank"]), local=bool(d["local"]),
        litmus=d.get("litmus"))


def case_state(case: FuzzCase, device=None):
    """The case's initial machine on ``device`` (None: the card): its
    traces, schedule knobs and arbitration ranks."""
    return init_state(case.config(), case.trace_lists(),
                      issue_delay=np.array(case.delays, np.int32),
                      issue_period=np.array(case.periods, np.int32),
                      arb_rank=np.array(case.rank, np.int32),
                      device=device)


# -- generation ------------------------------------------------------------


def _gen_instr(rng, cfg: SystemConfig, node: int, local: bool) -> tuple:
    home = node if local else int(rng.integers(cfg.num_nodes))
    block = int(rng.integers(max(2, cfg.mem_size // 2)))
    a = (home << cfg.block_bits) | block
    if rng.random() < 0.45:
        return (0, a, 0)
    return (1, a, int(rng.integers(256)))


def gen_case(rng, case_id: int, local: bool = False) -> FuzzCase:
    nn, ni = DIMS[int(rng.integers(len(DIMS)))]
    cfg = SystemConfig.reference(num_nodes=nn)
    traces = []
    for n in range(nn):
        tr: list = []
        while len(tr) < ni:
            ins = _gen_instr(rng, cfg, n, local)
            # bias toward read-modify-write pairs: a write-hit on a
            # SHARED line is the only way onto the UPGRADE path, and
            # pure-random traffic reaches it too rarely to kill
            # upgrade-family mutants in a small budget
            if ins[0] == 1 and len(tr) + 2 <= ni and rng.random() < 0.35:
                tr.append((0, ins[1], 0))
            tr.append(ins)
        traces.append(tuple(tr))
    traces = tuple(traces)
    return FuzzCase(
        case_id=case_id, num_nodes=nn, traces=traces,
        delays=tuple(int(x) for x in rng.integers(0, 7, nn)),
        periods=tuple(int(x) for x in rng.integers(1, 4, nn)),
        rank=tuple(int(x) for x in rng.permutation(nn)), local=local)


def mutate_case(rng, case: FuzzCase, case_id: int) -> FuzzCase:
    """Corpus mutation: a few structural edits to an interesting case —
    drop/duplicate/rewrite instructions, perturb the schedule — with
    the node-local property and the per-node instruction cap
    preserved."""
    cfg = case.config()
    traces = [list(tr) for tr in case.traces]
    delays, periods = list(case.delays), list(case.periods)
    for _ in range(1 + int(rng.integers(3))):
        n = int(rng.integers(len(traces)))
        kind = int(rng.integers(4))
        if kind == 0 and traces[n]:                      # drop one
            del traces[n][int(rng.integers(len(traces[n])))]
        elif kind == 1 and 0 < len(traces[n]) < cfg.max_instrs:
            i = int(rng.integers(len(traces[n])))        # duplicate one
            traces[n].insert(i, traces[n][i])
        elif kind == 2 and traces[n]:                    # rewrite one
            i = int(rng.integers(len(traces[n])))
            traces[n][i] = _gen_instr(rng, cfg, n, case.local)
        elif kind == 3:                                  # schedule nudge
            delays[n] = int(rng.integers(0, 7))
            periods[n] = int(rng.integers(1, 4))
    return dataclasses.replace(
        case, case_id=case_id,
        traces=tuple(tuple(tr) for tr in traces),
        delays=tuple(delays), periods=tuple(periods), litmus=None)


# -- differential execution ------------------------------------------------


# lint: host
def _metrics_dict(st) -> dict:
    mt = st.metrics
    return {f: host(getattr(mt, f))
            for f in type(mt).__dataclass_fields__}


# lint: host
def _dir_occupancy(st) -> dict:
    ds = host(st.dir_state)
    return {DirState(int(v)).name: int(c)
            for v, c in zip(*np.unique(ds, return_counts=True))}


# lint: host
def run_case(case: FuzzCase, message_phase: Optional[Callable] = None,
             device=None) -> dict:
    """Run one case differentially; returns {verdict, detail, quirks,
    coverage, cycles}. ``message_phase`` mutates the async engine only —
    the native oracle always runs the clean protocol. The async and
    sync runs go on ``device`` (None: the card)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.native.bindings import \
        NativeEngine

    dev = _device.resolve(device)
    cfg = case.config()
    traces = case.trace_lists()
    delays = np.array(case.delays, np.int32)
    periods = np.array(case.periods, np.int32)
    rank = np.array(case.rank, np.int32)

    ast = case_state(case, dev)
    fin = step.run_to_quiescence(cfg, ast, MAX_CYCLES, message_phase)

    nat = NativeEngine(cfg)
    nat.load_traces(traces)
    nat.set_schedule(delays.tolist(), periods.tolist())
    nat.set_arbitration(rank)
    nat.run(MAX_CYCLES)

    verdict, detail = "ok", ""
    aq = bool(fin.quiescent())
    if aq != nat.quiescent:
        verdict = "hang"
        detail = (f"quiescence disagreement in {MAX_CYCLES} cycles: "
                  f"async={aq} native={nat.quiescent}")
    if verdict == "ok":
        nst = nat.export_state()
        leaves = sim_numpy_leaves(fin)
        for name in ARRAYS:
            if not np.array_equal(leaves[name], np.asarray(nst[name])):
                verdict = "state"
                detail = f"{name} diverged (async vs native)"
                break
    quirks = {}
    if verdict == "ok":
        bad = {k: int(v)
               for k, v in invariants.step_violations(cfg, fin).items()
               if int(v)}
        quirks = {k: v for k, v in bad.items()
                  if k in QUIRK_STEP_ALLOWLIST}
        bad = {k: v for k, v in bad.items()
               if k not in QUIRK_STEP_ALLOWLIST}
        if bad:
            verdict, detail = "invariant", f"step-tier violations: {bad}"
    if verdict == "ok" and (case.litmus is not None
                            or case.case_id % 4 == 0):
        verdict, detail = _consistency_join(case, message_phase, quirks,
                                            dev)
    if verdict == "ok" and case.local:
        bad = {k: int(v)
               for k, v in
               invariants.quiescent_violations(cfg, fin).items()
               if int(v)}
        if bad:
            verdict = "coherence"
            detail = f"coherence violations on race-free traffic: {bad}"
    if verdict == "ok" and case.local and message_phase is None:
        verdict, detail = _sync_join(cfg, traces, fin, dev)

    doc = schema.from_async(_metrics_dict(fin))
    return {"verdict": verdict, "detail": detail, "quirks": quirks,
            "coverage": schema.coverage_signature(doc,
                                                  _dir_occupancy(fin)),
            "cycles": int(fin.cycle)}


# lint: host
def _consistency_join(case: FuzzCase, message_phase, quirks,
                      device) -> tuple:
    """The consistency oracle: recapture the run under the message
    ledger, reconstruct po/rf/co/fr and check the coherence axioms
    (analysis/axioms.py); litmus-tagged cases additionally check the
    run's outcome tuple against the test's allowed set."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import axioms
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import litmus
    rep = axioms.check_case(case, message_phase, quirks=quirks,
                            device=device)
    if rep["violations"]:
        v = rep["violations"][0]
        wit = "; ".join(v.get("witness", []))
        return "consistency", (f"{v['check']}: {v['detail']}"
                               + (f" [{wit}]" if wit else ""))
    if case.litmus is not None and case.litmus in litmus.BUILTIN:
        f = litmus.check_run_outcome(
            litmus.BUILTIN[case.litmus], case.config(),
            rep["events"], rep["final_state"])
        if f is not None:
            return "consistency", f["detail"]
    return "ok", ""


# lint: host
def _sync_join(cfg, traces, fin, device) -> tuple:
    """Node-local traffic is schedule-independent, so the transactional
    engine must land the same final state as the async run."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    s = se.run_sync_to_quiescence(
        cfg, se.from_sim_state(cfg, init_state(cfg, traces, device=device)),
        8, MAX_CYCLES)
    if not bool(s.quiescent()):
        return "sync", f"sync engine not quiescent in {MAX_CYCLES} rounds"
    s_mem, s_ds, s_bv = se.to_sim_arrays(cfg, s)
    leaves = sim_numpy_leaves(fin)
    pairs = [("cache_addr", s.cache_addr), ("cache_val", s.cache_val),
             ("cache_state", s.cache_state), ("memory", s_mem),
             ("dir_state", s_ds), ("dir_bitvec", s_bv)]
    for name, sv in pairs:
        if not np.array_equal(leaves[name], np.asarray(host(sv))):
            return "sync", f"{name} diverged (async vs sync)"
    return "ok", ""


# -- the fuzz loop ---------------------------------------------------------


# lint: host
def fuzz(n_cases: int = 32, seed: int = 0,
         message_phase: Optional[Callable] = None,
         progress: Optional[Callable] = None,
         flight_dir: Optional[str] = None, device=None) -> dict:
    """Run the coverage-guided loop; returns the fuzz report.

    Every fourth fresh case is node-local so the sync and coherence
    oracles stay exercised; once the corpus is non-empty, half the
    cases are mutations of a coverage-novel ancestor. Deterministic:
    (n_cases, seed, message_phase) fixes the report bit-for-bit, on any
    device.

    ``flight_dir`` arms the flight recorder (obs/flight.py): every
    finding re-runs under telemetry capture and dumps a replayable
    ``incident_<case_id>`` directory underneath it.
    """
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import litmus
    dev = _device.resolve(device)
    rng = np.random.default_rng(seed)
    corpus: list = []
    seen: set = set()
    findings: list = []
    verdicts: dict = {}
    quirk_cases = 0
    # the litmus suite seeds the front half of the budget (tagged
    # cases get the outcome-membership check on top of the axioms);
    # the back half stays random/mutated so the corpus keeps its reach
    seeds = litmus.seed_cases(n_cases // 2)
    for i in range(n_cases):
        if i < len(seeds):
            case = seeds[i]
        elif corpus and rng.random() < 0.5:
            case = mutate_case(
                rng, corpus[int(rng.integers(len(corpus)))], i)
        else:
            case = gen_case(rng, i, local=(i % 4 == 3))
        res = run_case(case, message_phase, dev)
        v = res["verdict"]
        verdicts[v] = verdicts.get(v, 0) + 1
        quirk_cases += bool(res["quirks"])
        if v != "ok":
            findings.append({"verdict": v, "detail": res["detail"],
                             "cycles": res["cycles"],
                             "case": case.to_dict()})
            if flight_dir is not None:
                from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (
                    flight as _flight)
                fr = _flight.record_case(case, message_phase, device=dev)
                fr.run(max(res["cycles"], 1), stop_on_quiescence=False)
                fr.dump_incident(
                    os.path.join(flight_dir,
                                 f"incident_{case.case_id}"),
                    f"fuzz:{v}", res["detail"], case=case.to_dict())
        if res["coverage"] not in seen:
            seen.add(res["coverage"])
            corpus.append(case)
        if progress is not None:
            progress(i, case, res)
    return {"schema": SCHEMA_ID, "seed": seed, "cases": n_cases,
            "max_cycles": MAX_CYCLES,
            "verdicts": dict(sorted(verdicts.items())),
            "quirk_cases": quirk_cases,
            "coverage_points": len(seen), "corpus_size": len(corpus),
            "findings": findings, "ok": not findings}
