"""Trace shrinking: ddmin a diverging fuzz case to a minimal repro.

Zeller's delta debugging over the flattened (node, instruction) list of
a :class:`..analysis.fuzz.FuzzCase` — per-node program order is
preserved, everything else (dimensions, schedule knobs, arbitration) is
held fixed so the predicate stays deterministic. The predicate is "the
same verdict kind reproduces" under :func:`fuzz.run_case`, so a shrink
of a ``state`` divergence cannot silently drift into a different bug.

The minimized case is emitted as a ready-to-run fixture directory —
``core_<n>.txt`` files in the exact reference trace format
(``RD 0x<addr>`` / ``WR 0x<addr> <value>``, parseable by
utils.trace.load_test_dir and the reference's own ``fscanf`` loop) plus
``repro.json`` (the full case + verdict) and ``trace.perfetto.json``, a
Perfetto event trace of the diverging run captured through
ops.step.run_cycles_traced and obs/perfetto.py.

The port of the JAX package's ``analysis/shrink.py``: every engine run
(the predicate's ``fuzz.run_case`` and the traced run of
:func:`emit_repro`) goes on ``device`` (None: the card), and the files
it writes are the JAX package's byte for byte.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Tuple

from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import fixtures, fuzz
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import perfetto
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import eventlog

#: cycles captured into the emitted Perfetto trace (enough for any
#: shrunk repro at reference dimensions to reach quiescence or expose
#: its hang)
TRACE_CYCLES = 256


def _flatten(case: fuzz.FuzzCase) -> List[Tuple[int, tuple]]:
    return [(n, ins) for n, tr in enumerate(case.traces) for ins in tr]


def _rebuild(case: fuzz.FuzzCase,
             items: List[Tuple[int, tuple]]) -> fuzz.FuzzCase:
    per_node: list = [[] for _ in range(case.num_nodes)]
    for n, ins in items:
        per_node[n].append(ins)
    return dataclasses.replace(
        case, traces=tuple(tuple(tr) for tr in per_node))


def ddmin(items: list, test: Callable[[list], bool]) -> list:
    """Classic ddmin: assumes test(items) is True; returns a 1-minimal
    sublist (order-preserving) still satisfying test."""
    n = 2
    while len(items) >= 2:
        size = len(items) // n
        chunks = [items[i:i + size] for i in range(0, len(items), size)]
        reduced = False
        for c in chunks:                      # try each subset
            if len(c) < len(items) and test(c):
                items, n, reduced = c, 2, True
                break
        if not reduced:
            for i in range(len(chunks)):      # try each complement
                comp = [x for j, c in enumerate(chunks) if j != i
                        for x in c]
                if len(comp) < len(items) and test(comp):
                    items, n = comp, max(2, n - 1)
                    reduced = True
                    break
        if not reduced:
            if n >= len(items):
                break
            n = min(len(items), 2 * n)
    return items


def shrink_case(case: fuzz.FuzzCase,
                message_phase: Optional[Callable] = None,
                verdict: Optional[str] = None, device=None) -> dict:
    """Minimize ``case`` to the fewest instructions that still produce
    the same verdict kind. Returns {case, verdict, detail, runs,
    instrs_before, instrs_after}; predicate results are memoized so the
    engine runs once per distinct candidate, on ``device`` (None: the
    card)."""
    if verdict is None:
        verdict = fuzz.run_case(case, message_phase, device)["verdict"]
    if verdict == "ok":
        raise ValueError("refusing to shrink a passing case")
    cache: dict = {}
    runs = [0]

    def test(items: list) -> bool:
        key = tuple(items)
        if key not in cache:
            runs[0] += 1
            res = fuzz.run_case(_rebuild(case, list(items)),
                                message_phase, device)
            cache[key] = res["verdict"] == verdict
        return cache[key]

    items = _flatten(case)
    kept = ddmin(items, test)
    small = _rebuild(case, kept)
    res = fuzz.run_case(small, message_phase, device)
    assert res["verdict"] == verdict, "shrink lost the bug"
    return {"case": small, "verdict": verdict, "detail": res["detail"],
            "runs": runs[0], "instrs_before": len(items),
            "instrs_after": len(kept)}


def shrink_recording(rec: dict,
                     predicate: Callable[[dict], bool]
                     ) -> Tuple[dict, int]:
    """ddmin over a traffic recording's JOB LIST: jobs — not
    instructions — are the atoms here, because the failure being
    preserved (an SLO breach, a stats anomaly) is a property of the
    SCHEDULE, not of any one trace. ``predicate`` takes a
    sub-recording (obs.recording doc) and answers "does the failure
    still reproduce on replay?"; it must hold on the full recording.
    Returns ``(minimal sub-recording, replays run)`` — 1-minimal:
    dropping any single remaining job loses the failure. Predicate
    results are memoized per job subset, so each distinct candidate
    replays once."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import recording
    jobs = [row["job"] for row in rec["rows"]
            if row["event"] == "submit"]
    cache: dict = {}
    runs = [0]

    def test(names: list) -> bool:
        key = frozenset(names)
        if key not in cache:
            runs[0] += 1
            cache[key] = bool(predicate(recording.subset(rec, key)))
        return cache[key]

    if not test(jobs):
        raise ValueError("refusing to shrink: the predicate does not "
                         "hold on the full recording")
    kept = ddmin(jobs, test)
    return recording.subset(rec, kept), runs[0]


# -- repro emission --------------------------------------------------------


def emit_repro(shrunk: dict, out_dir: str,
               message_phase: Optional[Callable] = None,
               device=None) -> dict:
    """Write the shrunk case as a fixture directory
    (:func:`..analysis.fixtures.write_fixture`: per-node
    ``core_<n>.txt`` in the reference trace format + ``repro.json``)
    plus a validated ``trace.perfetto.json`` of the diverging run
    (traced on ``device``, None: the card). Returns the repro metadata
    dict."""
    case = shrunk["case"]
    cfg = case.config()
    os.makedirs(out_dir, exist_ok=True)
    st = fuzz.case_state(case, device)
    _, events = step.run_cycles_traced(cfg, st, TRACE_CYCLES,
                                       message_phase)
    doc = perfetto.build_trace(eventlog.to_records(events),
                               cfg.num_nodes)
    perfetto.validate_trace(doc)
    perfetto.write_trace(os.path.join(out_dir, "trace.perfetto.json"),
                         doc)

    return fixtures.write_fixture(
        out_dir, case, shrunk["verdict"], shrunk["detail"],
        extra_files=["trace.perfetto.json"])


def shrink_findings(report: dict, out_root: Optional[str] = None,
                    message_phase: Optional[Callable] = None,
                    limit: int = 3, device=None) -> list:
    """Shrink up to ``limit`` findings of a fuzz report on ``device``
    (None: the card); returns the shrunk summaries (and writes repro
    dirs under ``out_root`` when given)."""
    out = []
    for k, finding in enumerate(report.get("findings", [])[:limit]):
        case = fuzz.case_from_dict(finding["case"])
        shrunk = shrink_case(case, message_phase,
                             verdict=finding["verdict"], device=device)
        if out_root is not None:
            emit_repro(shrunk, os.path.join(
                out_root, f"repro_{case.case_id}"), message_phase,
                device)
        out.append({"case_id": case.case_id,
                    "verdict": shrunk["verdict"],
                    "detail": shrunk["detail"],
                    "instrs_before": shrunk["instrs_before"],
                    "instrs_after": shrunk["instrs_after"],
                    "runs": shrunk["runs"]})
    return out
