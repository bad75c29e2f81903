"""First-class loader for ``cache-sim/repro/v1`` fixture directories.

A repro fixture is the one interchange format every replayable artifact
in this repo shares: per-node ``core_<n>.txt`` trace files in the exact
reference syntax (``RD 0x<addr>`` / ``WR 0x<addr> <value>``, parseable
by utils.trace.load_test_dir and the reference's own ``fscanf`` loop)
plus a ``repro.json`` carrying the full :class:`..analysis.fuzz.FuzzCase`
(dimensions, schedule knobs, arbitration ranks, litmus tag) and the
verdict it was captured with. Writers: :func:`..analysis.shrink.emit_repro`
(shrunk fuzz findings), obs/flight.py incident dirs, and tests that
hand-build cases. Readers: :func:`replay` (the full differential-oracle
chain via ``fuzz.run_case`` — hang, state, invariant, consistency,
coherence, sync), litmus seed replay, and external captures — all
through this one module, the first step of ROADMAP item 4's
record/replay story. The universal front door is ``cache-sim replay``
(:mod:`..replay`): it auto-detects a fixture among every other
captured artifact kind and routes it here.

Everything here is host-side plumbing. The port of the JAX package's
``analysis/fixtures.py``: the files it writes are the JAX package's byte
for byte, and :func:`replay` runs on ``device`` (None: the card).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable, Optional

from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import fuzz

#: the one schema id; bump on any breaking layout change
SCHEMA = "cache-sim/repro/v1"


def trace_lines(tr) -> str:
    """Render one node's (op, addr, value) trace in reference syntax."""
    out = []
    for op, a, v in tr:
        out.append(f"RD 0x{a:02X}" if op == 0 else f"WR 0x{a:02X} {v}")
    # no trailing blank line for an idle node: parse_trace loads any
    # non-RD/WR line (even empty) as an explicit NOP instruction
    return "\n".join(out) + ("\n" if out else "")


def write_fixture(out_dir: str, case: fuzz.FuzzCase, verdict: str,
                  detail: str,
                  extra_files: Iterable[str] = ()) -> dict:
    """Write ``case`` as a fixture directory: ``core_<n>.txt`` per node
    plus ``repro.json``. ``extra_files`` names sidecars the caller has
    written (or will write) into the same dir — e.g. a Perfetto trace —
    so they appear in the manifest. Returns the metadata dict."""
    os.makedirs(out_dir, exist_ok=True)
    cores = []
    for n, tr in enumerate(case.traces):
        name = f"core_{n}.txt"
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(trace_lines(tr))
        cores.append(name)
    meta = {"schema": SCHEMA,
            "verdict": verdict, "detail": detail,
            "instrs": sum(len(tr) for tr in case.traces),
            "num_nodes": case.num_nodes,
            "case": case.to_dict(),
            "files": sorted(set(cores) | set(extra_files)
                            | {"repro.json"})}
    with open(os.path.join(out_dir, "repro.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")
    return meta


def load(path: str) -> dict:
    """Read and schema-check a fixture's metadata. ``path`` is either
    the ``repro.json`` itself or the directory holding it."""
    if os.path.isdir(path):
        path = os.path.join(path, "repro.json")
    with open(path) as f:
        meta = json.load(f)
    if meta.get("schema") != SCHEMA:
        raise ValueError(f"{path}: schema must be {SCHEMA!r}, "
                         f"got {meta.get('schema')!r} — for other "
                         "captured artifacts (recordings, incident "
                         "dirs) use `cache-sim replay`, which "
                         "auto-detects the kind")
    for k in ("verdict", "case"):
        if k not in meta:
            raise ValueError(f"{path}: missing key {k!r}")
    return meta


def load_case(path: str) -> fuzz.FuzzCase:
    """The fixture's case, reconstructed (litmus tag included)."""
    return fuzz.case_from_dict(load(path)["case"])


def replay(path: str, message_phase: Optional[Callable] = None,
           device=None) -> dict:
    """Re-run a fixture through the full differential-oracle chain
    (``fuzz.run_case``: hang, state-vs-native, invariants, consistency,
    coherence, sync join) on ``device`` (None: the card). Returns the
    fresh run result annotated with ``expected_verdict`` (from the
    fixture) and ``reproduced`` (fresh verdict == recorded verdict)."""
    meta = load(path)
    res = fuzz.run_case(fuzz.case_from_dict(meta["case"]), message_phase,
                        device)
    res["expected_verdict"] = meta["verdict"]
    res["reproduced"] = res["verdict"] == meta["verdict"]
    return res
