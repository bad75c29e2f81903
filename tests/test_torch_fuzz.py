"""The port's differential fuzzer, shrinker, repro fixtures, flight
incidents and the verbs over them against the JAX package's, exactly.

Both packages run on the CPU from the same seed. Reports are compared as
``json.dumps(sort_keys=True)`` and every file a run writes (the repro
fixtures' ``core_<n>.txt``, ``repro.json`` and ``trace.perfetto.json``,
the flight incidents' ``incident.json`` and the rest) byte for byte. The
mutation is ``stale_owner_forward``: short ``state`` findings, so shrinks
of a few runs; the other handler mutations (one of them eight 2048-cycle
hangs) are in the slow tier.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib

import jax
import numpy as np
import pytest
from filelock import FileLock

from ue22cs343bb1_openmp_assignment_tpu import replay as j_replay
from ue22cs343bb1_openmp_assignment_tpu.analysis import (
    fixtures as j_fix, fuzz as j_fz, mutations as j_mut, runner as j_run,
    shrink as j_sh)
from ue22cs343bb1_openmp_assignment_tpu.obs import flight as j_flight
from ue22cs343bb1_openmp_assignment_tpu_torch import cli, replay
from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
    fixtures, fuzz, mutations, runner, shrink)
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import flight, recording
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import trace

import tests.torch_parity  # noqa: F401,E402  (one torch thread a process)

jax.config.update("jax_platforms", "cpu")

MUT = "stale_owner_forward"


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


def _files(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _run(main, argv, *paths) -> tuple:
    """(exit code, stdout with ``paths`` normalised) of an in-process
    verb; a usage error's SystemExit counts as its code."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    text = out.getvalue()
    for i, p in enumerate(paths):
        text = text.replace(str(p), f"{{path{i}}}")
    return rc, text


def _shared(tmp_path_factory, name: str, compute) -> tuple:
    """(compute(dir) through a JSON round trip, dir), computed once a
    session: under pytest-xdist the first worker to ask computes it into
    the session's shared temporary directory while the others wait on a
    file lock, so each JAX run (and its jit compiles) happens once."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / f"torch_fuzz_{name}"
    with FileLock(str(d) + ".lock"):
        done = d / "result.json"
        if not done.exists():
            d.mkdir(exist_ok=True)
            done.write_text(json.dumps(compute(d)))
        return json.loads(done.read_text()), d


# -- generation --------------------------------------------------------------


@pytest.mark.parametrize("local", [False, True], ids=["racy", "local"])
@pytest.mark.parametrize("seed", range(4))
def test_generation_equals_jax(seed, local):
    """gen_case / mutate_case / to_dict / case_from_dict: the same numpy
    draws, so the same cases and the generators left in the same state."""
    rng, j_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for i in range(3):
        case = fuzz.gen_case(rng, i, local=local)
        j_case = j_fz.gen_case(j_rng, i, local=local)
        assert _dumps(case.to_dict()) == _dumps(j_case.to_dict())
        assert fuzz.case_from_dict(case.to_dict()) == case
        assert case.trace_lists() == j_case.trace_lists()
        assert case.config().num_nodes == j_case.config().num_nodes
        for k in range(3):
            case = fuzz.mutate_case(rng, case, 10 * i + k)
            j_case = j_fz.mutate_case(j_rng, j_case, 10 * i + k)
            assert _dumps(case.to_dict()) == _dumps(j_case.to_dict())
            assert case.local == local
    assert rng.integers(1 << 30) == j_rng.integers(1 << 30)


def test_mutation_drops_the_litmus_tag():
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import litmus
    seed = litmus.seed_cases(1)[0]
    assert seed.litmus == litmus.SEED_ORDER[0]
    mutated = fuzz.mutate_case(np.random.default_rng(0), seed, 5)
    assert mutated.litmus is None and mutated.case_id == 5
    assert fuzz.case_from_dict(mutated.to_dict()) == mutated


# -- the fuzzer --------------------------------------------------------------


@pytest.mark.parametrize("n_cases,seed", [(10, 3), (16, 0)],
                         ids=["10-seed3", "16-seed0"])
def test_clean_fuzz_report_equals_jax(n_cases, seed):
    """The clean handlers: every case ``ok`` in both packages, the
    coverage and corpus equal; a second port run gives the same report."""
    got = fuzz.fuzz(n_cases, seed=seed, device="cpu")
    want = j_fz.fuzz(n_cases, seed=seed)
    assert got["ok"] and got["verdicts"] == {"ok": n_cases}
    assert _dumps(got) == _dumps(want)
    if n_cases == 10:
        assert _dumps(fuzz.fuzz(n_cases, seed=seed, device="cpu")) == \
            _dumps(got)


@pytest.fixture(scope="module")
def mutant_reports(tmp_path_factory):
    """fuzz(16, seed=0) under stale_owner_forward in both packages, and
    the first two findings shrunk into repro dirs."""
    def compute(root):
        mp, j_mp = mutations.MUTATIONS[MUT][0], j_mut.MUTATIONS[MUT][0]
        got = fuzz.fuzz(16, seed=0, message_phase=mp, device="cpu")
        want = j_fz.fuzz(16, seed=0, message_phase=j_mp)
        got_sh = shrink.shrink_findings(got, str(root / "port"), mp,
                                        limit=2, device="cpu")
        want_sh = j_sh.shrink_findings(want, str(root / "jax"), j_mp,
                                       limit=2)
        return got, want, got_sh, want_sh
    res, root = _shared(tmp_path_factory, "mutant", compute)
    return (*res, root)


def test_mutant_fuzz_report_equals_jax(mutant_reports):
    got, want, _, _, _ = mutant_reports
    assert not got["ok"] and got["verdicts"] == {"ok": 5, "state": 11}
    assert all(f["verdict"] == "state" for f in got["findings"])
    assert _dumps(got) == _dumps(want)


def test_shrunk_repros_equal_jax(mutant_reports):
    """shrink_findings' summaries, and every file of both repro dirs,
    equal to JAX's; the fixture loads through utils.trace and replays
    its recorded verdict under the mutation."""
    _, _, got_sh, want_sh, root = mutant_reports
    assert got_sh == want_sh
    assert [(s["instrs_before"], s["instrs_after"]) for s in got_sh] == [
        (5, 2), (6, 2)]
    port, jax_files = _files(root / "port"), _files(root / "jax")
    assert sorted(port) == sorted(jax_files) and len(port) == 8
    assert port == jax_files
    for s in got_sh:
        d = root / "port" / f"repro_{s['case_id']}"
        meta = fixtures.load(str(d))
        case = fixtures.load_case(str(d / "repro.json"))
        assert meta["verdict"] == "state" and case.case_id == s["case_id"]
        traces = trace.load_test_dir(str(d), case.num_nodes)
        assert [[tuple(i) for i in tr] for tr in traces] == \
            case.trace_lists()
        res = fixtures.replay(str(d), mutations.MUTATIONS[MUT][0],
                              device="cpu")
        assert res["reproduced"] and res["expected_verdict"] == "state"


def test_shrink_refuses_a_passing_case():
    case = fuzz.gen_case(np.random.default_rng(0), 1)
    with pytest.raises(ValueError, match="passing case"):
        shrink.shrink_case(case, device="cpu")
    assert shrink.ddmin(list(range(8)), lambda xs: 3 in xs) == [3]


# -- the verbs, fixtures and flight incidents --------------------------------


def _analyze(main, tmp, label, argv, extra=()):
    path = tmp / f"{label}.json"
    rc, out = _run(main, [*extra, "--skip-model-check", "--skip-lint",
                          *argv, "--json", str(path)], tmp / label, path)
    return rc, out, json.loads(path.read_text())


def test_analyze_fuzz_equals_jax(tmp_path, capsys):
    """``analyze --fuzz 8 --seed 0`` (clean): exit 0 and the fuzz block of
    the JAX runner's report; the prong's time and cycles on stderr's
    report."""
    argv = ["--fuzz", "8", "--seed", "0"]
    rc, out, doc = _analyze(runner.main, tmp_path, "port", argv, ["--cpu"])
    j_rc, j_out, j_doc = _analyze(j_run.main, tmp_path, "jax", argv)
    assert (rc, out) == (j_rc, j_out)
    assert rc == 0 and doc["ok"] and "== fuzz: ok [8 cases" in out
    assert _dumps(doc["fuzz"]) == _dumps(j_doc["fuzz"])
    assert runner.block_digests(doc)["fuzz"] == \
        runner.block_digests(j_doc)["fuzz"]
    assert set(runner.block_digests(doc)) == set(runner.DIGEST_BLOCKS) | {
        "fuzz"}
    p = doc["prongs"]["fuzz"]
    assert p["cases"] == 8 and p["cycles"] > 0 and p["seconds"] > 0
    assert "analyze: fuzz took" in capsys.readouterr().err


@pytest.fixture(scope="module")
def mutant_verb_runs(tmp_path_factory):
    """``analyze --fuzz 4 --seed 0 --mutation stale_owner_forward
    --repro-dir R --flight-dir F --json`` in both packages."""
    def compute(root):
        runs = {}
        for label, main, extra in (("port", runner.main, ["--cpu"]),
                                   ("jax", j_run.main, [])):
            d = root / label
            argv = ["--fuzz", "4", "--seed", "0", "--mutation", MUT,
                    "--repro-dir", str(d / "R"), "--flight-dir",
                    str(d / "F")]
            runs[label] = _analyze(main, root, label, argv, extra)
        return runs
    runs, root = _shared(tmp_path_factory, "verb", compute)
    return {label: (*r, root / label) for label, r in runs.items()}


def test_analyze_fuzz_mutation_equals_jax(mutant_verb_runs):
    """Exit 1, the stdout (paths normalised) and the fuzz block (findings
    and shrunk summaries) of the JAX runner's."""
    (rc, out, doc, _), (j_rc, j_out, j_doc, _) = (
        mutant_verb_runs["port"], mutant_verb_runs["jax"])
    assert rc == j_rc == 1
    assert out == j_out and "analyze: FAIL" in out
    assert _dumps(doc["fuzz"]) == _dumps(j_doc["fuzz"])
    assert len(doc["fuzz"]["shrunk"]) == 2


def test_flight_incidents_and_repros_equal_jax(mutant_verb_runs):
    """Every file under --flight-dir (incident.json, the Perfetto trace,
    core_*.txt, repro.json) and --repro-dir equal to JAX's."""
    d, j_d = mutant_verb_runs["port"][3], mutant_verb_runs["jax"][3]
    for sub in ("F", "R"):
        got, want = _files(d / sub), _files(j_d / sub)
        assert sorted(got) == sorted(want) and got == want
    incidents = sorted(os.listdir(d / "F"))
    assert incidents == [f"incident_{i}" for i in range(4)]
    for name in incidents:
        doc = flight.load_incident(str(d / "F" / name))
        assert doc["has_repro"] and doc["reason"] == "fuzz:state"
        assert {"repro.json", "trace.perfetto.json", "incident.json",
                "core_0.txt"} <= set(doc["files"])


def test_incident_and_fixture_replays_equal_jax(mutant_verb_runs):
    """flight.replay_incident and fixtures.replay: JAX's verdict doc on
    the same directory, under the clean handlers and the mutation."""
    d = mutant_verb_runs["port"][3]
    inc, rep = d / "F" / "incident_2", d / "R" / "repro_0"
    for mp, j_mp in ((None, None), (mutations.MUTATIONS[MUT][0],
                                    j_mut.MUTATIONS[MUT][0])):
        got = flight.replay_incident(str(inc), mp, device="cpu")
        want = j_flight.replay_incident(str(inc), j_mp)
        assert _dumps(got) == _dumps(want)
        got = fixtures.replay(str(rep), mp, device="cpu")
        want = j_fix.replay(str(rep), j_mp)
        assert _dumps(got) == _dumps(want)
        assert got["reproduced"] == (mp is not None)


@pytest.mark.parametrize("kind", ["fixture", "incident"])
def test_replay_verb_equals_jax(mutant_verb_runs, kind):
    """``replay <dir> --cpu`` of a repro fixture and of a fuzz incident:
    the JAX verb's exit code and stdout (a fixture replays under the
    clean handlers, so a mutant's repro is NOT reproduced, exit 1; an
    incident's fresh verdict always counts as reproduced, exit 0)."""
    d = mutant_verb_runs["port"][3]
    path = d / "R" / "repro_0" if kind == "fixture" else \
        d / "F" / "incident_0"
    got = _run(cli.main, ["replay", str(path), "--cpu"], path)
    want = _run(j_replay.main, [str(path)], path)
    assert got == want
    assert got[0] == (1 if kind == "fixture" else 0)
    assert ("NOT reproduced" in got[1]) == (kind == "fixture")
    got = _run(replay.main, [str(path), "--cpu", "--json"], path)
    assert got == _run(j_replay.main, [str(path), "--json"], path)


def test_replay_shrink_equals_jax(tmp_path):
    """``replay --shrink --slo p95=1 --shrink-out S`` of a 4-job
    VirtualClock recording that breaches: the JAX verb's exit code,
    stdout (the shrunk job list) and a byte-identical fixture directory,
    which replays through the same front door."""
    from tests.test_torch_replay import _record_port
    rec = _record_port(tmp_path / "rec", 4)
    outs = {}
    for label, main, extra in (("port", replay.main, ["--cpu"]),
                               ("jax", j_replay.main, [])):
        s, inc = tmp_path / f"{label}_s", tmp_path / f"{label}_inc"
        outs[label] = _run(main, [str(rec), *extra, "--wave-s", "0.05",
                                  "--slo", "p95=1", "--incident-dir",
                                  str(inc), "--shrink", "--shrink-out",
                                  str(s)], rec, s, inc)
    assert outs["port"] == outs["jax"]
    rc, out = outs["port"]
    assert rc == 4 and "shrink converged to 1 job(s)" in out
    got, want = _files(tmp_path / "port_s"), _files(tmp_path / "jax_s")
    assert got == want and recording.FILENAME in got
    assert replay.detect(tmp_path / "port_s") == "soak-incident"
    assert _run(replay.main, [str(tmp_path / "port_s"), "--cpu",
                              "--wave-s", "0.05"])[0] == 0


def test_fuzz_verbs_need_the_card_unless_cpu(monkeypatch, tmp_path, capsys):
    """No card: the library entry points raise, ``analyze --fuzz`` and
    ``replay`` of a fixture exit 1 with the port's error."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = fuzz.gen_case(np.random.default_rng(0), 0)
    for call in (lambda: fuzz.fuzz(1), lambda: fuzz.run_case(case),
                 lambda: shrink.shrink_case(case, verdict="state"),
                 lambda: flight.record_case(case)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert runner.main(["--skip-model-check", "--skip-lint",
                        "--fuzz", "1"]) == 1
    fixtures.write_fixture(str(tmp_path / "fx"), case, "ok", "")
    assert replay.main([str(tmp_path / "fx")]) == 1
    assert capsys.readouterr().err.count("no CUDA device") == 2


# -- slow: the other handler mutations ---------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(set(mutations.MUTATIONS) - {MUT}))
def test_other_mutant_fuzz_reports_equal_jax(name):
    """fuzz(16, seed=0) under each other handler mutation, and two shrunk
    findings where the verdicts are not hangs."""
    mp, j_mp = mutations.MUTATIONS[name][0], j_mut.MUTATIONS[name][0]
    got = fuzz.fuzz(16, seed=0, message_phase=mp, device="cpu")
    want = j_fz.fuzz(16, seed=0, message_phase=j_mp)
    assert not got["ok"]
    assert _dumps(got) == _dumps(want)
    if all(f["verdict"] != "hang" for f in got["findings"]):
        assert shrink.shrink_findings(got, None, mp, limit=2,
                                      device="cpu") == \
            j_sh.shrink_findings(want, None, j_mp, limit=2)
