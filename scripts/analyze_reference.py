#!/usr/bin/env python3
"""The JAX package's analysis reports and table-protocol serving results
that ``chip_smoke.py`` holds the port's card runs to
(``ANALYZE_REFERENCE``).

    JAX_PLATFORMS=cpu python scripts/analyze_reference.py [--scopes S]
        [--litmus-tests T1,T2] [--jobs 16] [--nodes 16] [--trace-len 16]
        [--slots 16] [--chunk 16] [--hex 12]

Runs the JAX package's ``cache-sim analyze --table --litmus`` on the CPU
with the default model check (``--scopes`` and ``--litmus-tests`` cut
it down, as the tests do; the lint prong is skipped: it reads the other
package's code) and prints one JSON line: the sha256 of each report
block the port reproduces (``model_check``, ``table``, ``litmus``; the
port's ``analysis.runner.block_digests``), and for ``moesi`` and
``mesif`` the first ``--hex`` hex digits of every job's
``serve.job_digest`` of the JAX ``serve`` of ``mixed_jobs(jobs, nodes,
trace_len)`` under that protocol (``slots`` slots, ``chunk`` cycles a
chunk, queue capacity 64), in job order, joined. About 2 min at the
defaults on one CPU core (``iriw`` is most of it).

    JAX_PLATFORMS=cpu python scripts/analyze_reference.py --fuzz
        [--fuzz-cases 16] [--seed 0] [--mutation stale_owner_forward]

prints instead what ``chip_smoke.py`` pins as ``FUZZ_REFERENCE``: the
sha256 of the ``fuzz`` block of the JAX runner's ``--skip-model-check
--skip-lint --fuzz N --seed S`` report (``clean``) and of the same run
under ``--mutation M --repro-dir R --flight-dir F`` (under the
mutation's name), the sha256 of every file under ``R`` and ``F``
(``files``, keyed ``R/...`` and ``F/...``), and the exit code and
verdict line of the JAX ``replay`` of the first shrunk repro and of the
first incident (``replay``). About 2 min at the defaults on one CPU core.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import pathlib
import sys
import tempfile

# run as a file from anywhere: the packages sit at the repo root
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def analyze_digests(scopes=None, litmus_tests=None) -> dict:
    """Block digests of the JAX runner's ``--table --litmus`` report."""
    from ue22cs343bb1_openmp_assignment_tpu.analysis import runner
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis.runner import (
        block_digests)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "report.json"
        argv = ["--table", "--litmus", "--skip-lint", "-q",
                "--json", str(path)]
        if scopes:
            argv += ["--scopes", scopes]
        if litmus_tests:
            argv += ["--litmus-tests", litmus_tests]
        with contextlib.redirect_stdout(sys.stderr):
            rc = runner.main(argv)
        if rc != 0:
            raise SystemExit(f"the JAX analyze run exited {rc}")
        return block_digests(json.loads(path.read_text()))


def serve_digits(protocol: str, jobs: int, nodes: int, trace_len: int,
                 slots: int, chunk: int, hex_digits: int) -> str:
    """The JAX serve run's job digests of the mix under ``protocol``."""
    from ue22cs343bb1_openmp_assignment_tpu import serve
    from ue22cs343bb1_openmp_assignment_tpu_torch.serve import (
        job_digest, read_job_dumps)
    specs = serve.mixed_jobs(jobs, nodes=nodes, trace_len=trace_len,
                             protocol=protocol)
    with tempfile.TemporaryDirectory() as tmp:
        doc = serve.serve(specs, slots=min(slots, jobs), chunk=chunk,
                          queue_capacity=64, out_dir=tmp)
        if doc["jobs_quiesced"] != jobs:
            raise SystemExit(f"{protocol}: {jobs - doc['jobs_quiesced']} "
                             "job(s) did not quiesce")
        return "".join(job_digest(read_job_dumps(pathlib.Path(tmp) / s.name,
                                                 nodes),
                                  doc["jobs"][s.name]["metrics"])[:hex_digits]
                       for s in specs)


def analyze_fuzz(runner_main, out: pathlib.Path, label: str, argv: list,
                 extra=()) -> tuple:
    """``analyze --skip-model-check --skip-lint ARGV --json`` through a
    package's ``runner_main``: (exit code, report)."""
    path = out / f"{label}.json"
    with contextlib.redirect_stdout(sys.stderr):
        rc = runner_main([*extra, "--skip-model-check", "--skip-lint", "-q",
                          *argv, "--json", str(path)])
    return rc, json.loads(path.read_text())


def file_digests(root, prefix: str) -> dict:
    """{prefix/relative path: sha256} of every file under ``root``."""
    root = pathlib.Path(root)
    return {f"{prefix}/{p.relative_to(root)}":
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def replay_lines(replay_main, report: dict, repro_dir, flight_dir,
                 extra=()) -> dict:
    """{kind: [directory, exit code, verdict line]} of ``replay`` through
    a package's ``replay_main`` on the first shrunk repro and the first
    incident of a mutation run's report."""
    first = report["fuzz"]["findings"][0]["case"]["case_id"]
    out = {}
    for kind, d in (
            ("fixture", f"repro_{report['fuzz']['shrunk'][0]['case_id']}"),
            ("incident", f"incident_{first}")):
        path = pathlib.Path(repro_dir if kind == "fixture"
                            else flight_dir) / d
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = replay_main([str(path), *extra])
        out[kind] = [d, rc, buf.getvalue().splitlines()[-1]]
    return out


def fuzz_digests(runner_main, replay_main, cases: int = 16, seed: int = 0,
                 mutation: str = "stale_owner_forward", extra=()) -> dict:
    """FUZZ_REFERENCE from a package's runner and replay verb."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis.runner import (
        block_digests)
    argv = ["--fuzz", str(cases), "--seed", str(seed)]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        rc, clean = analyze_fuzz(runner_main, tmp, "clean", argv, extra)
        if rc != 0:
            raise SystemExit(f"the clean fuzz run exited {rc}")
        r, f = tmp / "R", tmp / "F"
        rc, mut = analyze_fuzz(runner_main, tmp, "mutation", argv + [
            "--mutation", mutation, "--repro-dir", str(r), "--flight-dir",
            str(f)], extra)
        if rc != 1:
            raise SystemExit(f"the {mutation} fuzz run exited {rc}")
        return {"clean": block_digests(clean)["fuzz"],
                mutation: block_digests(mut)["fuzz"],
                "files": {**file_digests(r, "R"), **file_digests(f, "F")},
                "replay": replay_lines(replay_main, mut, r, f, extra)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scopes", default=None)
    ap.add_argument("--litmus-tests", default=None)
    ap.add_argument("--jobs", type=int, default=16)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--trace-len", type=int, default=16)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--hex", type=int, default=12)
    ap.add_argument("--fuzz", action="store_true",
                    help="print FUZZ_REFERENCE instead")
    ap.add_argument("--fuzz-cases", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mutation", default="stale_owner_forward")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.fuzz:
        from ue22cs343bb1_openmp_assignment_tpu import replay
        from ue22cs343bb1_openmp_assignment_tpu.analysis import runner
        print(json.dumps(fuzz_digests(runner.main, replay.main,
                                      args.fuzz_cases, args.seed,
                                      args.mutation), sort_keys=True))
        return 0
    out = analyze_digests(args.scopes, args.litmus_tests)
    out["serve"] = {p: serve_digits(p, args.jobs, args.nodes,
                                    args.trace_len, args.slots, args.chunk,
                                    args.hex)
                    for p in ("moesi", "mesif")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
