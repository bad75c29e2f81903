"""`cache-sim-torch analyze`: the static-analysis gate (host-side CLI).

The port of the JAX package's ``analysis/runner.py``: the same parser,
exit codes and report, plus ``--cpu``. Runs the symmetry-reduced model
checker over the builtin small scopes (default), the AST trace lint of
the port's device code (default), the declarative table prong behind
``--table`` (verify_table over the MESI/MOESI/MESIF tables, then
table-vs-handlers conformance), the memory-consistency litmus matrix
behind ``--litmus`` and the coverage-guided differential fuzzer behind
``--fuzz N`` (analysis/fuzz.py; findings ddmin-shrunk by
analysis/shrink.py into ``--repro-dir``, flight incidents into
``--flight-dir``), and the static walkers: ``--jaxpr`` (the aten-level
IR lint and replay guard, analysis/lint_aten.py), ``--kernel`` (the
CUDA kernels' contracts, analysis/kernelcheck.py) and ``--index`` (the
index-pressure audit, analysis/indexcheck.py), with their seeded
mutations. The engines run on the card unless ``--cpu``; with no card
and no ``--cpu`` the verb exits 1 and runs nothing on the CPU. On the
card ``--kernel`` builds the kernel libraries and reads their ptxas
logs and runtime entries; with ``--cpu`` it reads the ptxas capture
committed beside kernelcheck.py. Prints a human report that keeps
reference-sanctioned quirks (`~`) visually distinct from genuine
violations (`!`), optionally writes the full JSON report (the JAX
runner's blocks, plus ``prongs``: each prong's wall seconds and oracle
batches), and exits by the code table in ``--help``. ``python -m
ue22cs343bb1_openmp_assignment_tpu_torch.analysis`` is the same command.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

_EPILOG = """\
exit codes — the one canonical contract for `cache-sim-torch analyze`:
  0  clean pass — every requested check ran to completion and passed
  1  findings — a protocol violation, lint finding, fuzz divergence,
     table-verification failure, table/handler conformance divergence,
     kernel-contract finding (rounding lemma, VMEM budget,
     lowerability, or gate divergence), an index-budget breach, or a
     failed recompilation guard
  2  usage error (argparse's code, left untouched)
  3  budget exhausted, no finding — a scope hit --max-states before
     exhausting its state space, or the index prong's probe run hit
     its cycle budget before quiescence: nothing failed, but nothing
     was proven either; raise --max-states or shrink the scope
findings always win: a run that both finds a violation and exhausts a
budget exits 1, not 3.

related gate (documented here because the two share scripts/check.sh):
`cache-sim-torch bench-diff` exits 0 = no regression (difference is noise),
2 = incomparable (configs/sample sizes don't support a verdict),
4 = statistically significant regression."""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cache-sim-torch analyze",
        description="Statically verify the coherence engine: "
                    "symmetry-reduced protocol model checking, "
                    "AST + aten-level lint, kernel contracts, index "
                    "pressure, differential fuzzing.",
        epilog=_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scopes", "--scope", dest="scopes", default=None,
                   help="comma-separated scope names (default: all "
                        "builtin scopes)")
    p.add_argument("--list-scopes", action="store_true",
                   help="print every scope (builtin + conformance-only) "
                        "with dimensions and programs, then exit")
    p.add_argument("--skip-model-check", action="store_true")
    p.add_argument("--skip-lint", action="store_true")
    p.add_argument("--table", action="store_true",
                   help="run the declarative-protocol-table prong: "
                        "verify_table static passes (totality, "
                        "determinism, conservation, stability, anchors) "
                        "over the MESI/MOESI/MESIF tables, then the "
                        "table-vs-handlers conformance gate on --scopes "
                        "(default 2n2h)")
    p.add_argument("--litmus", action="store_true",
                   help="run the memory-consistency litmus prong: "
                        "exhaustively enumerate each test's reachable "
                        "outcome set (model checker in litmus mode, "
                        "symmetry-reduced) and require EXACT equality "
                        "with the DSL's allowed set — any forbidden "
                        "outcome, or any allowed outcome the engine "
                        "cannot produce, is a finding")
    p.add_argument("--litmus-tests", default=None, metavar="T1,T2",
                   help="comma-separated litmus test names (default: "
                        "the full builtin suite; see analysis/litmus.py)")
    p.add_argument("--litmus-protocols", default="mesi",
                   metavar="P1,P2",
                   help="protocols for the litmus sweep (default mesi; "
                        "also moesi, mesif via the declarative tables)")
    p.add_argument("--mutation", default=None,
                   help="run the gates with this seeded bug: a handler "
                        "mutation from analysis.mutations.MUTATIONS "
                        "(checker/fuzzer/conformance must fail), a "
                        "table mutation from TABLE_MUTATIONS "
                        "(verify-table must fail), or a consistency "
                        "mutation from CONSISTENCY_MUTATIONS (litmus "
                        "enumeration must fail) — the gates' own "
                        "regression test")
    p.add_argument("--max-states", type=int, default=50_000,
                   help="state-count guard per scope (default 50000); "
                        "exceeding it without a finding exits 3")
    p.add_argument("--fuzz", type=int, default=0, metavar="N",
                   help="run N coverage-guided differential fuzz cases "
                        "(async vs native on any traffic, sync joining "
                        "on node-local); diverging traces are ddmin-"
                        "shrunk automatically")
    p.add_argument("--seed", type=int, default=0,
                   help="fuzzer PRNG seed (default 0); the seed fully "
                        "determines corpus and verdicts")
    p.add_argument("--repro-dir", default=None, metavar="DIR",
                   help="write shrunk fuzz repros here (core_<n>.txt "
                        "fixture + repro.json + Perfetto trace)")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="arm the flight recorder: every fuzz finding "
                        "dumps a replayable incident_<case_id> dir "
                        "here (telemetry ring + metrics + Perfetto "
                        "trace + repro fixture; obs/flight.py)")
    p.add_argument("--jaxpr", action="store_true",
                   help="run the IR lint over the aten op streams of "
                        "the hot paths (analysis/lint_aten.py) plus the "
                        "replay guard (one op stream per shape, the "
                        "build caches reused)")
    p.add_argument("--kernel", action="store_true",
                   help="run the kernel-contract prong: re-derive the "
                        "deep round's packed-word bit budgets in exact "
                        "integers and check the key at its extremes, "
                        "each kernel's shared memory against the "
                        "card's, the ptxas registers, spills and the "
                        "cooperative grids' residency, and cross-check "
                        "deep_round_kernel.supported() against the "
                        "derivation")
    p.add_argument("--kernel-nodes", type=int, default=4096,
                   metavar="N",
                   help="node count for the kernel-contract headline "
                        "config (default 4096, the perf-report deep "
                        "headline)")
    p.add_argument("--kernel-static", action="store_true",
                   help="the arithmetic only: exactness + gate passes "
                        "and the layout-formula shared memory (no "
                        "build, no ptxas, no launch)")
    p.add_argument("--index", action="store_true",
                   help="run the index-pressure prong: record every hot "
                        "body, inventory its aten index ops with "
                        "semantic-plane attribution, compute "
                        "per-engine indices per retired instruction, "
                        "flag mergeable scatter pairs (shared index "
                        "vector, disjoint destinations) and enforce "
                        "the per-target index budgets")
    p.add_argument("--index-engine", default=None,
                   choices=["async", "sync", "deep", "wave", "fused"],
                   help="restrict the index audit to one engine "
                        "(default: all five; async carries the "
                        "routed delivery's router)")
    p.add_argument("--index-nodes", type=int, default=None,
                   metavar="N",
                   help="node count for the index audit (default 8, "
                        "the canonical budget-pinned size; budgets "
                        "are only enforced at the default)")
    p.add_argument("--json", dest="json_path", default=None,
                   help="write the full JSON report here")
    p.add_argument("--lint-paths", nargs="*", default=None,
                   help="lint these files/dirs instead of the default "
                        "ops/ parallel/ models/")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="only the verdict line")
    p.add_argument("--cpu", action="store_true",
                   help="run the model checker's oracle and the "
                        "fuzzer's engines on the CPU (default: the "
                        "card; without one, --cpu is required)")
    return p


#: the report blocks the port computes as the JAX runner does, byte for
#: byte under sort_keys (``lint`` reads another package's code)
DIGEST_BLOCKS = ("model_check", "table", "litmus")

#: further blocks computed as the JAX runner does, digested when the
#: report has them (the prong ran)
OPTIONAL_DIGEST_BLOCKS = ("fuzz",)


def block_digests(report: dict) -> dict:
    """{block: sha256 of ``json.dumps(report[block], sort_keys=True)``}
    over DIGEST_BLOCKS, and over OPTIONAL_DIGEST_BLOCKS where the report
    has them: what ``chip_smoke.py``'s ANALYZE_REFERENCE and
    FUZZ_REFERENCE pin (``scripts/analyze_reference.py`` computes them
    from the JAX runner). The report is taken through JSON first, so an
    in-memory report and its ``--json`` file give the same digests."""
    doc = json.loads(json.dumps(report))
    blocks = DIGEST_BLOCKS + tuple(b for b in OPTIONAL_DIGEST_BLOCKS
                                   if doc.get(b) is not None)
    return {b: hashlib.sha256(json.dumps(doc[b], sort_keys=True)
                              .encode()).hexdigest()
            for b in blocks}


def _print(quiet: bool, *a) -> None:
    if not quiet:
        print(*a)


def _resolve_mutation(name):
    if name is None:
        return None, None, None
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import mutations
    if name in mutations.TABLE_MUTATIONS:
        raise SystemExit(
            f"`{name}` is a table mutation — it seeds a bug in the "
            "declarative table, not the handlers, so it only applies to "
            "the --table prong (run with --table --skip-model-check "
            "--skip-lint)")
    if name in mutations.CONSISTENCY_MUTATIONS:
        raise SystemExit(
            f"`{name}` is a consistency mutation — it keeps every "
            "per-state invariant happy and corrupts only observed "
            "values, so the invariant prongs cannot see it; run it "
            "through the litmus prong (--litmus --skip-model-check "
            "--skip-lint)")
    if name in mutations.KERNEL_MUTATIONS:
        raise SystemExit(
            f"`{name}` is a kernel mutation — it perturbs the fused "
            "Pallas round's arithmetic contracts (ladder constants / "
            "support gates), which the protocol prongs never touch; "
            "run it through the kernel-contract prong (--kernel "
            "--skip-model-check --skip-lint)")
    if name in mutations.INDEX_MUTATIONS:
        raise SystemExit(
            f"`{name}` is an index mutation — it re-splits the packed "
            "commit scatters bit-identically, so every dynamic oracle "
            "(model checker, fuzzer, conformance, goldens) stays "
            "green; only the static index inventory can see it — run "
            "it through the index prong (--index --skip-model-check "
            "--skip-lint)")
    if name not in mutations.MUTATIONS:
        raise SystemExit(
            f"unknown mutation `{name}` (handler mutations: "
            f"{', '.join(mutations.MUTATIONS)}; table mutations: "
            f"{', '.join(mutations.TABLE_MUTATIONS)}; consistency "
            f"mutations: {', '.join(mutations.CONSISTENCY_MUTATIONS)}; "
            f"kernel mutations: "
            f"{', '.join(mutations.KERNEL_MUTATIONS)}; index "
            f"mutations: {', '.join(mutations.INDEX_MUTATIONS)})")
    return mutations.MUTATIONS[name]


def run_model_check(scope_names, mutation, max_states, quiet, device=None,
                    tally=None) -> dict:
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import model_check
    scopes = model_check.builtin_scopes()
    names = list(scopes) if scope_names is None else [
        s.strip() for s in scope_names.split(",") if s.strip()]
    unknown = [n for n in names if n not in scopes]
    if unknown:
        raise SystemExit(f"unknown scope(s): {', '.join(unknown)} "
                         f"(have: {', '.join(scopes)})")

    mp, mscope, expected = _resolve_mutation(mutation)
    if mp is not None:
        if scope_names is None:
            names = [mscope]
        _print(quiet, f"== seeded mutation `{mutation}` on scope "
                      f"{mscope} (expected finding: {expected})")

    out = {}
    for name in names:
        try:
            rep = model_check.check_scope(scopes[name], message_phase=mp,
                                          max_states=max_states,
                                          device=device, tally=tally)
        except model_check.ScopeTooLarge as e:
            out[name] = {"ok": None, "budget_exhausted": True,
                         "detail": str(e)}
            _print(quiet, f"== scope {name}: BUDGET EXHAUSTED ({e}) — "
                          "no finding; not a pass")
            continue
        out[name] = rep
        st = rep["stats"]
        verdict = "ok" if rep["ok"] else "FAIL"
        _print(quiet,
               f"== scope {name}: {verdict}  "
               f"[{st['states']} states, {st['transitions']} transitions, "
               f"{st['quiescent_states']} quiescent, "
               f"{st['deadlocked_states']} deadlocked, "
               f"sym x{st['symmetry_group_order']}]")
        for q in rep["quirks"]:
            _print(quiet, f"  ~ {q['name']} ({q['states']} states) — "
                          f"sanctioned: {q['rationale']}")
        for n in rep["coverage"]["sanctioned_noops"]:
            _print(quiet, f"  ~ no-op {n['pair']} ({n['count']}x) — "
                          f"sanctioned: {n['rationale']}")
        for v in rep["violations"]:
            named = v.get("name") and v["name"] != v["check"]
            _print(quiet, f"  ! {v['check']}"
                          f"{'/' + v['name'] if named else ''}"
                          f": {v['detail']}")
            for step in v.get("path", [])[-6:]:
                _print(quiet, f"      > {step}")
            for step in v.get("cycle", []):
                _print(quiet, f"      @ {step}")
            for line in v.get("state_render", []):
                _print(quiet, f"      | {line}")
    return out


def run_litmus(test_names, protocol_names, mutation, max_states,
               quiet, device=None, tally=None) -> dict:
    """The memory-consistency prong: enumerate every (protocol, test)
    cell of the litmus matrix and require the reachable outcome set to
    EXACTLY equal the DSL's allowed set."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (litmus,
                                                             mutations)
    names = (None if test_names is None else
             [s.strip() for s in test_names.split(",") if s.strip()])
    protos = [s.strip() for s in protocol_names.split(",") if s.strip()]
    unknown = [n for n in (names or []) if n not in litmus.BUILTIN]
    if unknown:
        raise SystemExit(f"unknown litmus test(s): {', '.join(unknown)} "
                         f"(have: {', '.join(litmus.BUILTIN)})")

    mp = None
    cmut = mutations.CONSISTENCY_MUTATIONS.get(mutation) \
        if mutation else None
    if mutation is not None:
        if cmut is not None:
            mp = cmut[0]
            if names is None:
                names = [cmut[1]]   # the shape documented to kill it
            _print(quiet, f"== seeded consistency mutation `{mutation}` "
                          f"on litmus {cmut[1]} (a forbidden outcome "
                          "must appear)")
        elif mutation in mutations.MUTATIONS:
            mp = mutations.MUTATIONS[mutation][0]
        # other kinds already rejected upstream

    def progress(proto, name, rep):
        if rep.get("budget_exhausted"):
            _print(quiet, f"== litmus {name} [{proto}]: BUDGET "
                          f"EXHAUSTED ({rep['detail']}) — no finding; "
                          "not a pass")
            return
        st = rep["stats"]
        verdict = "ok" if rep["ok"] else "FAIL"
        _print(quiet,
               f"== litmus {name} [{proto}]: {verdict}  "
               f"[{st['states']} states, {len(rep['observed'])} "
               f"outcomes, allowed {len(rep['allowed'])}]")
        for o in rep["unexpected"]:
            _print(quiet, f"  ! forbidden outcome observed: {tuple(o)}")
        for o in rep["unobserved"]:
            _print(quiet, f"  ! allowed outcome never reached: "
                          f"{tuple(o)}")
        for v in rep["violations"]:
            _print(quiet, f"  ! model-check violation: {v}")

    return litmus.run_suite(tests=names, protocols=protos,
                            message_phase=mp, max_states=max_states,
                            progress=progress, device=device,
                            tally=tally)



def run_lint(paths, quiet) -> dict:
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import lint_trace
    findings = lint_trace.lint_paths(paths)
    # the no-torch boundary pass always runs over its own fixed targets
    # (the daemon wire layer and the ops plane), independent of
    # --lint-paths
    findings.extend(lint_trace.lint_no_torch())
    n_files = len({f.file for f in findings})
    if findings:
        _print(quiet, f"== lint: FAIL ({len(findings)} findings in "
                      f"{n_files} files)")
        for f in findings:
            _print(quiet, f"  ! {f.render()}")
    else:
        _print(quiet, "== lint: ok (0 findings)")
    return {"ok": not findings,
            "findings": [f.as_dict() for f in findings]}



def run_jaxpr(quiet, device=None, tally=None) -> dict:
    """The IR-lint prong: ``lint_aten.lint`` over the hot paths plus
    the replay guard, on ``device``."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import lint_aten
    rep = lint_aten.lint(device=device)
    guard = lint_aten.replay_guard(device=device)
    rep["recompile_guard"] = guard
    rep["ok"] = bool(rep["ok"] and guard["ok"])
    counts = ", ".join(f"{k}={v}" for k, v in rep["targets"].items())
    _print(quiet, f"== jaxpr lint (aten ops): "
                  f"{'ok' if rep['ok'] else 'FAIL'} "
                  f"[{counts}; budget {rep['budget']}]")
    for f in rep["findings"]:
        _print(quiet, f"  ! {f['target']}: {f['rule']} — {f['detail']}")
    same = ", ".join(f"{k}={'same' if v else 'DIFFERS'}"
                     for k, v in guard["same_stream"].items())
    _print(quiet, f"   replay guard: op streams {same}; native reuse="
                  f"{guard['native_build_reused']}; kernel nvcc runs="
                  f"{guard['kernel_nvcc_runs']}")
    return rep


def run_kernel(nodes, static, mutation, quiet, device=None,
               tally=None) -> dict:
    """The kernel-contract prong (analysis/kernelcheck.py): the packed
    words' budgets, shared memory, the ptxas resource contract and the
    gates. A seeded kernel mutation forces the static passes only —
    every kernel mutant is killed by integer arithmetic — and the run
    must then FAIL with the documented finding kind (asserted here, so a
    mutant the verifier misses is itself a finding)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
        kernelcheck, mutations)
    kmut = mutations.KERNEL_MUTATIONS.get(mutation) if mutation else None
    if mutation is not None and kmut is None and \
            mutation not in mutations.MUTATIONS:
        # handler mutations riding along for another prong leave the
        # kernels alone, so the prong just runs clean
        raise SystemExit(
            f"unknown mutation `{mutation}` (kernel mutations: "
            f"{', '.join(mutations.KERNEL_MUTATIONS)})")

    cfg = kernelcheck.headline_config(num_nodes=nodes)
    if kmut is not None:
        _print(quiet, f"== seeded kernel mutation `{mutation}` "
                      f"(expected finding: {kmut[1]})")
        with kmut[0]():
            rep = kernelcheck.check(cfg, trace=False, device=device)
        kinds = [f["kind"] for f in rep["findings"]]
        rep["expected_kind"] = kmut[1]
        rep["mutant_killed"] = (not rep["ok"]) and kmut[1] in kinds
        if not rep["mutant_killed"]:
            # the verifier MISSED a seeded bug: that is the failure
            rep["ok"] = False
            rep["findings"].append({
                "pass": "mutation", "kind": "mutant_survived",
                "detail": f"seeded kernel mutation `{mutation}` was not "
                          f"caught (expected `{kmut[1]}`, got "
                          f"{kinds or 'no findings'})"})
    else:
        rep = kernelcheck.check(cfg, trace=not static, device=device)
    for line in kernelcheck.render_text(rep):
        _print(quiet, line)
    return rep


def run_index(engine, nodes, mutation, max_states, quiet, device=None,
              tally=None) -> dict:
    """The index-pressure prong (analysis/indexcheck.py): the aten index
    inventory, plane attribution, indices/instr probes, merge detection
    and budget enforcement. A seeded index mutation skips the probe
    runs — the mutant is semantics-preserving by construction, so only
    the static pass can kill it — and the run must then FAIL with the
    documented budget breach AND name the split planes as merge
    candidates (asserted here: a mutant the auditor misses is itself a
    finding)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
        indexcheck, mutations)
    imut = mutations.INDEX_MUTATIONS.get(mutation) if mutation else None
    if mutation is not None and imut is None and \
            mutation not in mutations.MUTATIONS:
        raise SystemExit(
            f"unknown mutation `{mutation}` (index mutations: "
            f"{', '.join(mutations.INDEX_MUTATIONS)})")

    engines = None if engine is None else [engine]
    nodes = indexcheck.DEFAULT_NODES if nodes is None else nodes
    if imut is not None:
        engines = engines or ["async"]   # the seam lives in step.cycle
        _print(quiet, f"== seeded index mutation `{mutation}` "
                      f"(expected finding: {imut[1]})")
        with imut[0]():
            rep = indexcheck.check(engines=engines, nodes=nodes,
                                   probe=False, device=device)
        kinds = [f["kind"] for f in rep["findings"]]
        cands = [c for er in rep["engines"].values()
                 for c in er["merge_candidates"]
                 if c["scope"].startswith("step.cycle")]
        rep["expected_kind"] = imut[1]
        rep["mutant_killed"] = bool((not rep["ok"]) and imut[1] in kinds
                                    and cands)
        if not rep["mutant_killed"]:
            # the auditor MISSED a seeded bug: that is the failure
            rep["ok"] = False
            rep["findings"].append({
                "pass": "mutation", "kind": "mutant_survived",
                "detail": f"seeded index mutation `{mutation}` was not "
                          f"caught (expected `{imut[1]}` + merge "
                          f"candidates in step.cycle, got "
                          f"{kinds or 'no findings'} and "
                          f"{len(cands)} candidates)"})
    else:
        rep = indexcheck.check(engines=engines, nodes=nodes, probe=True,
                               probe_budget=min(max_states, 4096),
                               device=device)
    for line in indexcheck.render_text(rep):
        _print(quiet, line)
    return rep


def run_table(scope_names, mutation, max_states, quiet, device=None,
              tally=None) -> dict:
    """The declarative-table prong: static verify passes over all three
    protocol tables, then the table-vs-handlers conformance gate."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (conformance,
                                                             mutations,
                                                             protocol_table,
                                                             verify_table)
    out = {"verify": {}, "conformance": {}}
    tmut = mutations.TABLE_MUTATIONS.get(mutation) if mutation else None
    hmut = mutations.MUTATIONS.get(mutation) if mutation else None
    if mutation and tmut is None and hmut is None:
        raise SystemExit(
            f"unknown mutation `{mutation}` (handler mutations: "
            f"{', '.join(mutations.MUTATIONS)}; table mutations: "
            f"{', '.join(mutations.TABLE_MUTATIONS)})")

    for name, factory in protocol_table.TABLES.items():
        tbl = factory()
        if tmut is not None and name == "mesi":
            tbl = tmut[0](tbl)
            _print(quiet, f"== seeded table mutation `{mutation}` "
                          f"(expected finding: {tmut[1]})")
        rep = verify_table.verify(tbl)
        out["verify"][name] = rep
        passes = " ".join(f"{p}={'ok' if v == 'ok' else 'FAIL'}"
                          for p, v in rep["passes"].items())
        _print(quiet, f"== table {tbl.name}: "
                      f"{'ok' if rep['ok'] else 'FAIL'} "
                      f"[{rep['rows']} rows; {passes}]")
        for f in rep["findings"][:8]:
            _print(quiet, f"  ! {f['kind']}: {f['detail']}")

    if tmut is not None:
        # a mutated table is (intentionally) not the handlers' protocol;
        # conformance against the live phase would only restate the
        # verify findings, so the prong stops at the static passes
        return out

    scopes = conformance.conformance_scopes()
    if scope_names is not None:
        names = [s.strip() for s in scope_names.split(",") if s.strip()]
        unknown = [n for n in names if n not in scopes]
        if unknown:
            raise SystemExit(f"unknown scope(s): {', '.join(unknown)} "
                             f"(have: {', '.join(scopes)})")
    elif hmut is not None:
        names = [hmut[1]]   # the scope documented to expose the mutant
        _print(quiet, f"== seeded handler mutation `{mutation}` on scope "
                      f"{hmut[1]} (conformance vs the MESI table must "
                      "diverge)")
    else:
        names = ["2n2h"]
    mp = hmut[0] if hmut is not None else None
    tbl = protocol_table.mesi_table()
    for name in names:
        try:
            rep = conformance.check_conformance(
                scopes[name], tbl, message_phase=mp, max_states=max_states,
                device=device, tally=tally)
        except conformance.ScopeTooLarge as e:
            out["conformance"][name] = {"ok": None,
                                        "budget_exhausted": True,
                                        "detail": str(e)}
            _print(quiet, f"== conformance {name}: BUDGET EXHAUSTED "
                          f"({e}) — no finding; not a pass")
            continue
        out["conformance"][name] = rep
        st = rep["stats"]
        _print(quiet,
               f"== conformance {name}: {'ok' if rep['ok'] else 'FAIL'} "
               f"[{st['states']} states, {st['msg_events']} msg events, "
               f"rows {st['rows_covered']}/{st['rows_total']}, "
               f"sym x{st['symmetry_group_order']}]")
        for f in rep["findings"][:4]:
            _print(quiet, f"  ! {f['check']}: {f['detail']}")
            for step in f.get("path", [])[-6:]:
                _print(quiet, f"      > {step}")
            for line in f.get("ref_render", []):
                _print(quiet, f"      |ref   {line}")
            for line in f.get("table_render", []):
                _print(quiet, f"      |table {line}")
    return out


def run_fuzz(n_cases, seed, mutation, repro_dir, quiet, flight_dir=None,
             device=None, tally=None) -> dict:
    """The fuzz prong: ``n_cases`` cases of the coverage-guided loop on
    ``device``, the first two findings ddmin-shrunk (repros under
    ``repro_dir``). ``tally`` gets the cases run and their async
    cycles."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import fuzz as fz
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
        shrink as sh)
    mp = _resolve_mutation(mutation)[0]

    def progress(i, case, res):
        if tally is not None:
            tally["cases"] = tally.get("cases", 0) + 1
            tally["cycles"] = tally.get("cycles", 0) + res["cycles"]

    rep = fz.fuzz(n_cases, seed=seed, message_phase=mp, progress=progress,
                  flight_dir=flight_dir, device=device)
    _print(quiet,
           f"== fuzz: {'ok' if rep['ok'] else 'FAIL'} "
           f"[{n_cases} cases, seed {seed}, "
           f"{rep['coverage_points']} coverage points, "
           f"verdicts {rep['verdicts']}, "
           f"{rep['quirk_cases']} quirk-only cases]")
    if rep["findings"]:
        shrunk = sh.shrink_findings(rep, out_root=repro_dir,
                                    message_phase=mp, limit=2,
                                    device=device)
        rep["shrunk"] = shrunk
        for s in shrunk:
            _print(quiet,
                   f"  ! case {s['case_id']}: {s['verdict']} — "
                   f"{s['detail']}; shrunk {s['instrs_before']} -> "
                   f"{s['instrs_after']} instrs ({s['runs']} runs)")
        if repro_dir:
            _print(quiet, f"   repros written under {repro_dir}")
        if flight_dir:
            _print(quiet, f"   flight-recorder incidents under "
                          f"{flight_dir}")
    return rep


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_scopes:
        from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
            conformance, model_check)
        builtin = set(model_check.builtin_scopes())
        for name, scope in conformance.conformance_scopes().items():
            d = scope.describe()
            tag = "" if name in builtin else "  [conformance-only]"
            print(f"{name}: {d['num_nodes']} nodes, cache {d['cache_size']}"
                  f", mem {d['mem_size']} ({d['mem_init']}){tag}")
            for i, prog in enumerate(d["programs"]):
                print(f"    node {i}: "
                      + "; ".join(f"{op} a={a} v={v}" for op, a, v in prog))
        return 0

    device = None
    if (not args.skip_model_check or args.litmus or args.table
            or args.fuzz > 0 or args.jaxpr or args.kernel or args.index):
        from ue22cs343bb1_openmp_assignment_tpu_torch import device as _dev
        try:
            device = _dev.resolve("cpu" if args.cpu else None)
        except RuntimeError:
            print("error: no CUDA device is available; pass --cpu to run "
                  "the plain PyTorch path on the CPU", file=sys.stderr)
            return 1

    report = {"model_check": {}, "lint": None, "jaxpr": None,
              "fuzz": None, "table": None, "litmus": None,
              "kernel": None, "index": None}
    prongs = {}

    def prong(name, fn, *a, **kw):
        """Run one prong, recording its wall seconds, oracle batches and
        whatever else it tallies (the card synchronised before the clock
        stops)."""
        tally = {"batches": 0}
        t0 = time.perf_counter()
        out = fn(*a, device=device, tally=tally, **kw)
        if device is not None and device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)
        prongs[name] = {"seconds": time.perf_counter() - t0,
                        "oracle_batches": tally.pop("batches"), **tally}
        return out

    ok, exhausted = True, False
    if not args.skip_model_check:
        report["model_check"] = prong(
            "model_check", run_model_check, args.scopes, args.mutation,
            args.max_states, args.quiet)
        for r in report["model_check"].values():
            if r.get("budget_exhausted"):
                exhausted = True
            else:
                ok &= r["ok"]
    if args.litmus:
        report["litmus"] = prong(
            "litmus", run_litmus, args.litmus_tests, args.litmus_protocols,
            args.mutation, args.max_states, args.quiet)
        for per_proto in report["litmus"].values():
            for r in per_proto.values():
                if r.get("budget_exhausted"):
                    exhausted = True
                else:
                    ok &= r["ok"]
    if args.table:
        report["table"] = prong("table", run_table, args.scopes,
                                args.mutation, args.max_states, args.quiet)
        for r in report["table"]["verify"].values():
            ok &= r["ok"]
        for r in report["table"]["conformance"].values():
            if r.get("budget_exhausted"):
                exhausted = True
            else:
                ok &= r["ok"]
    if not args.skip_lint:
        t0 = time.perf_counter()
        report["lint"] = run_lint(args.lint_paths, args.quiet)
        prongs["lint"] = {"seconds": time.perf_counter() - t0,
                          "oracle_batches": 0}
        ok &= report["lint"]["ok"]
    if args.jaxpr:
        report["jaxpr"] = prong("jaxpr", run_jaxpr, args.quiet)
        ok &= report["jaxpr"]["ok"]
    if args.kernel:
        report["kernel"] = prong("kernel", run_kernel, args.kernel_nodes,
                                 args.kernel_static, args.mutation,
                                 args.quiet)
        ok &= report["kernel"]["ok"]
    if args.index:
        report["index"] = prong("index", run_index, args.index_engine,
                                args.index_nodes, args.mutation,
                                args.max_states, args.quiet)
        if report["index"].get("budget_exhausted"):
            exhausted = True
        ok &= report["index"]["ok"]
    if args.fuzz > 0:
        report["fuzz"] = prong("fuzz", run_fuzz, args.fuzz, args.seed,
                               args.mutation, args.repro_dir, args.quiet,
                               flight_dir=args.flight_dir)
        ok &= report["fuzz"]["ok"]
    report["ok"] = bool(ok and not exhausted)
    report["prongs"] = prongs
    for name, p in prongs.items():
        print(f"analyze: {name} took {p['seconds']:.2f} s, "
              f"{p['oracle_batches']} oracle batches", file=sys.stderr)

    if args.json_path:
        with open(args.json_path, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
        _print(args.quiet, f"report written to {args.json_path}")

    if not ok:
        print("analyze: FAIL")
        return 1
    if exhausted:
        print("analyze: BUDGET EXHAUSTED (no finding — not a pass)")
        return 3
    print("analyze: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
