"""``scripts/analyze_reference.py`` (the JAX runner's report digests and
table-protocol serving digests that ``chip_smoke.py`` pins as
ANALYZE_REFERENCE, and with ``--fuzz`` the fuzz digests it pins as
FUZZ_REFERENCE) against the port's CPU runs (slices 15 and 16): a
cut-down run here; the whole reference in the slow tier."""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import tempfile

import jax
import pytest

from ue22cs343bb1_openmp_assignment_tpu_torch import replay, serve
from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import runner

# the fuzz verbs' runs of both packages, computed once a session
from tests.test_torch_fuzz import mutant_verb_runs  # noqa: F401

jax.config.update("jax_platforms", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _script():
    spec = importlib.util.spec_from_file_location(
        "analyze_reference", ROOT / "scripts" / "analyze_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_digests(*argv) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "r.json")
        rc = runner.main(["--cpu", "--table", "--litmus", "--skip-lint",
                          "-q", "--json", path, *argv])
        assert rc == 0
        with open(path) as fh:
            return runner.block_digests(json.load(fh))


def _port_serve_digits(protocol: str, jobs: int, nodes: int,
                       trace_len: int, slots: int, chunk: int,
                       hex_digits: int) -> str:
    specs = serve.mixed_jobs(jobs, nodes=nodes, trace_len=trace_len,
                             protocol=protocol)
    with tempfile.TemporaryDirectory() as tmp:
        doc = serve.serve(specs, slots=min(slots, jobs), chunk=chunk,
                          queue_capacity=64, out_dir=tmp, device="cpu")
        return "".join(serve.job_digest(
            serve.read_job_dumps(os.path.join(tmp, s.name), nodes),
            doc["jobs"][s.name]["metrics"])[:hex_digits] for s in specs)


def test_cut_down_reference_equals_the_port():
    want = _script().analyze_digests("2n1a", "mp")
    assert set(want) == set(runner.DIGEST_BLOCKS)
    assert _port_digests("--scopes", "2n1a", "--litmus-tests", "mp") == want


@pytest.mark.parametrize("protocol", ["moesi", "mesif"])
def test_reference_serve_digits_equal_the_port(protocol):
    args = (protocol, 4, 4, 6, 2, 8, 12)
    assert _port_serve_digits(*args) == _script().serve_digits(*args)


def test_chip_smoke_pins_the_script_defaults():
    import chip_smoke as cs
    ref, a = cs.ANALYZE_REFERENCE, cs.ANALYZE
    assert set(ref) == set(runner.DIGEST_BLOCKS) | {"serve"}
    assert all(len(ref[b]) == 64 for b in runner.DIGEST_BLOCKS)
    assert {p: len(v) for p, v in ref["serve"].items()} == {
        "moesi": a["jobs"] * a["hex"], "mesif": a["jobs"] * a["hex"]}
    args = vars(_script().build_parser().parse_args([]))
    assert {k: args[k] for k in ("jobs", "nodes", "trace_len", "slots",
                                 "chunk", "hex")} == {
        k: a[k] for k in ("jobs", "nodes", "trace_len", "slots", "chunk",
                          "hex")}
    assert args["scopes"] is None and args["litmus_tests"] is None


@pytest.mark.slow
def test_port_full_run_equals_chip_smoke_reference():
    import chip_smoke as cs
    ref = cs.ANALYZE_REFERENCE
    got = _port_digests()
    assert got == {b: ref[b] for b in runner.DIGEST_BLOCKS}
    a = cs.ANALYZE
    for p in ("moesi", "mesif"):
        assert _port_serve_digits(p, a["jobs"], a["nodes"], a["trace_len"],
                                  a["slots"], a["chunk"],
                                  a["hex"]) == ref["serve"][p]


@pytest.mark.slow
def test_script_full_run_equals_chip_smoke_reference():
    import chip_smoke as cs
    ref = cs.ANALYZE_REFERENCE
    mod = _script()
    assert mod.analyze_digests() == {b: ref[b]
                                     for b in runner.DIGEST_BLOCKS}
    a = cs.ANALYZE
    for p in ("moesi", "mesif"):
        assert mod.serve_digits(p, a["jobs"], a["nodes"], a["trace_len"],
                                a["slots"], a["chunk"],
                                a["hex"]) == ref["serve"][p]


def test_fuzz_reference_pieces_equal_the_port(mutant_verb_runs):  # noqa: F811
    """The script's digests of a cut-down mutation run (4 cases, with
    --repro-dir and --flight-dir): its file digests and replay lines of
    the JAX run's directories through the JAX verb equal the port's
    through the port's verb."""
    from ue22cs343bb1_openmp_assignment_tpu import replay as j_replay
    mod = _script()
    got = {}
    for label, main, extra in (("port", replay.main, ["--cpu"]),
                               ("jax", j_replay.main, [])):
        _, _, doc, d = mutant_verb_runs[label]
        got[label] = ({**mod.file_digests(d / "R", "R"),
                       **mod.file_digests(d / "F", "F")},
                      mod.replay_lines(main, doc, d / "R", d / "F", extra),
                      runner.block_digests(doc)["fuzz"])
    assert got["port"] == got["jax"]
    files, lines, _ = got["port"]
    assert {k.split("/")[0] for k in files} == {"R", "F"}
    assert sorted(lines) == ["fixture", "incident"]


def test_chip_smoke_pins_the_fuzz_defaults():
    import chip_smoke as cs
    ref, f = cs.FUZZ_REFERENCE, cs.FUZZ
    assert set(ref) == {"clean", f["mutation"], "replay", "files"}
    assert all(len(ref[k]) == 64 for k in ("clean", f["mutation"]))
    assert all(len(v) == 64 for v in ref["files"].values())
    assert {k.split("/")[0] for k in ref["files"]} == {"R", "F"}
    assert {k: v[1] for k, v in ref["replay"].items()} == {
        "fixture": 1, "incident": 0}
    args = vars(_script().build_parser().parse_args([]))
    assert (args["fuzz_cases"], args["seed"], args["mutation"]) == (
        f["cases"], f["seed"], f["mutation"])


@pytest.mark.slow
def test_port_fuzz_run_equals_chip_smoke_reference():
    import chip_smoke as cs
    f = cs.FUZZ
    got = _script().fuzz_digests(runner.main, replay.main, f["cases"],
                                 f["seed"], f["mutation"], ["--cpu"])
    got["replay"] = {k: tuple(v) for k, v in got["replay"].items()}
    assert got == cs.FUZZ_REFERENCE


@pytest.mark.slow
def test_script_fuzz_run_equals_chip_smoke_reference():
    import chip_smoke as cs
    from ue22cs343bb1_openmp_assignment_tpu import replay as j_replay
    from ue22cs343bb1_openmp_assignment_tpu.analysis import (
        runner as j_runner)
    f = cs.FUZZ
    got = _script().fuzz_digests(j_runner.main, j_replay.main, f["cases"],
                                 f["seed"], f["mutation"])
    got["replay"] = {k: tuple(v) for k, v in got["replay"].items()}
    assert got == cs.FUZZ_REFERENCE
