"""The port's CLI against the JAX package's, run side by side on the CPU.

Each case runs JAX ``cli.main`` and the port's ``cli.main`` in process
with ``--cpu``, each in a directory of its own, and compares what the
user sees: the exit codes, stdout (the "Processor n initialized" lines,
a sweep's report), the last stderr line when it is the metrics
document (equal as JSON), and every file the run wrote there byte for
byte (``core_<n>_output.txt`` dumps, ``--trace-log`` logs; checkpoints
are compared by resuming them). Checkpoints cross both ways: one
package saves, then both resume it. The error exits follow JAX
``tests/test_cli_engines.py``; the last case holds the port to its
device rule (no card and no ``--cpu``: a non-zero exit naming the card).
"""

import json
import pathlib
import shutil

import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu import cli as jax_cli
from ue22cs343bb1_openmp_assignment_tpu_torch import cli as port_cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = str(ROOT / "tests" / "fixtures")
MINI = ["mini", "--tests-root", FIXTURES, "--cpu"]
SYNC16 = ["--engine", "sync", "--procedural", "--nodes", "16",
          "--trace-len", "24", "--cpu", "--check", "--metrics", "--dump"]
PACKAGES = {"jax": jax_cli, "port": port_cli}

#: id -> (setup, argv): ``setup`` is None, ("jax" | "port", argv) run
#: once into a shared directory PRE before both sides, or "suite" (a
#: racy-suite copy of mini under PRE with a run_1 of the JAX CLI's own
#: sync dumps); "{pre}" in an argv names that directory
CASES = {
    **{f"mini-{e}": (None, MINI + ["--engine", e, "--metrics"])
       for e in ("async", "sync", "native")},
    **{f"mini-{e}{flag}": (None, MINI + ["--engine", e, flag, "--metrics"])
       for e in ("async", "sync") for flag in ("--check", "--check-strict")},
    "trace-log": (None, MINI + ["--trace-log", "log.txt", "--metrics"]),
    "trace-log-msgs": (None, MINI + ["--trace-log", "log.txt",
                                     "--trace-msgs"]),
    "trace-log-sync": (None, MINI + ["--engine", "sync", "--trace-log",
                                     "log.txt", "--metrics"]),
    "drop-prob": (None, MINI + ["--drop-prob", "0.1", "--fault-seed", "3",
                                "--run-cycles", "40", "--metrics"]),
    **{f"workload-{w}-{e}": (None, ["--workload", w, "--nodes", "16",
                                    "--trace-len", "8", "--cpu", "--engine",
                                    e, "--metrics", "--dump"])
       for w in ("uniform", "false_sharing", "hotspot")
       for e in ("async", "native")},
    # uniform traffic at 64 nodes trips the async engine's own engine
    # tier (unowned_with_sharers) in both packages: exit 3, no document
    "workload-uniform-check": (None, ["--workload", "uniform", "--nodes",
                                      "64", "--trace-len", "16", "--cpu",
                                      "--check", "--metrics"]),
    "procedural-k1": (None, SYNC16 + ["--txn-width", "1"]),
    "procedural-k3": (None, SYNC16 + ["--txn-width", "3"]),
    "procedural-deep": (None, SYNC16 + ["--deep-window", "--deep-slots",
                                        "3"]),
    "resume-async-from-jax": (
        ("jax", MINI + ["--run-cycles", "7", "--save-checkpoint",
                        "{pre}/ck.npz"]),
        ["--resume", "{pre}/ck.npz", "--cpu", "--dump", "--metrics"]),
    "resume-sync-from-port": (
        ("port", MINI + ["--engine", "sync", "--run-cycles", "3",
                         "--save-checkpoint", "{pre}/ck.npz"]),
        ["--resume", "{pre}/ck.npz", "--cpu", "--engine", "sync", "--dump",
         "--metrics"]),
    "resume-async-from-port": (
        ("port", ["--workload", "hotspot", "--nodes", "16", "--trace-len",
                  "8", "--cpu", "--run-cycles", "9", "--save-checkpoint",
                  "{pre}/ck.npz"]),
        ["--resume", "{pre}/ck.npz", "--cpu", "--dump", "--metrics"]),
    "resume-sync-from-jax": (
        ("jax", SYNC16 + ["--run-cycles", "2", "--save-checkpoint",
                          "{pre}/ck.npz"]),
        ["--resume", "{pre}/ck.npz", "--cpu", "--engine", "sync",
         "--txn-width", "3", "--dump", "--metrics"]),
    "sweep-seeds": ("suite", ["mini", "--tests-root", "{pre}", "--cpu",
                              "--engine", "sync", "--sweep-seeds", "4"]),
    # error exits (JAX tests/test_cli_engines.py:41-160)
    **{f"missing-dir-{e}": (None, ["no_such_dir", "--tests-root", FIXTURES,
                                   "--cpu", "--engine", e])
       for e in ("async", "sync", "native")},
    "sync-rejects-delays": (None, ["--workload", "uniform", "--cpu",
                                   "--engine", "sync", "--delays", "1", "2",
                                   "3", "4"]),
    "native-rejects-check": (None, ["--workload", "uniform", "--cpu",
                                    "--engine", "native", "--check"]),
    "procedural-needs-sync": (None, ["--procedural", "--nodes", "8",
                                     "--cpu"]),
    "txn-width-needs-sync": (None, ["--workload", "uniform", "--nodes", "8",
                                    "--cpu", "--txn-width", "3"]),
}

#: the exit each case must give (0 where not listed); mini is racy, so
#: the async engine's strict coherence tier fails there (exit 3); a
#: failed check ends the run before the dumps and the document
EXPECTED_RC = {"mini-async--check-strict": 3, "workload-uniform-check": 3,
               "missing-dir-async": 1, "missing-dir-sync": 1,
               "missing-dir-native": 1, "sync-rejects-delays": 2,
               "native-rejects-check": 2, "procedural-needs-sync": 2,
               "txn-width-needs-sync": 2}


def _run(mod, argv, cwd, monkeypatch, capsys):
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    rc = mod.main(argv)
    out, err = capsys.readouterr()
    files = {p.name: p.read_bytes() for p in sorted(cwd.iterdir())
             if p.is_file() and p.suffix != ".npz"}
    return rc, out, err, files


def _setup(setup, pre, monkeypatch, capsys):
    pre.mkdir()
    if setup == "suite":
        suite = pre / "mini"
        shutil.copytree(ROOT / "tests" / "fixtures" / "mini", suite)
        rc, *_ = _run(jax_cli, MINI + ["--engine", "sync", "--out-dir",
                                       str(suite / "run_1")],
                      pre, monkeypatch, capsys)
    elif setup is not None:
        who, argv = setup
        rc, *_ = _run(PACKAGES[who],
                      [a.replace("{pre}", str(pre)) for a in argv],
                      pre, monkeypatch, capsys)
    else:
        return
    assert rc == 0


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_the_jax_cli(case, tmp_path, monkeypatch, capsys):
    setup, argv = CASES[case]
    pre = tmp_path / "pre"
    _setup(setup, pre, monkeypatch, capsys)
    argv = [a.replace("{pre}", str(pre)) for a in argv]
    got = {}
    for name, mod in PACKAGES.items():
        (tmp_path / name).mkdir()
        got[name] = _run(mod, argv, tmp_path / name, monkeypatch, capsys)
    (rc_j, out_j, err_j, files_j), (rc_p, out_p, err_p, files_p) = (
        got["jax"], got["port"])
    assert rc_p == rc_j == EXPECTED_RC.get(case, 0), (err_j, err_p)
    assert out_p == out_j
    assert sorted(files_p) == sorted(files_j)
    for name in files_j:
        assert files_p[name] == files_j[name], f"{name} differs"
    if "--metrics" in argv and rc_j == 0:
        doc_j = json.loads(err_j.strip().splitlines()[-1])
        doc_p = json.loads(err_p.strip().splitlines()[-1])
        assert doc_p == doc_j
    if rc_j == 0 and ("--dump" in argv or argv[0] == "mini"
                      and "--sweep-seeds" not in argv):
        assert any(n.startswith("core_") for n in files_j)
    if EXPECTED_RC.get(case) == 3:
        assert err_p.splitlines()[-1] == err_j.splitlines()[-1]
        assert "invariant check FAILED" in err_p
    if case.endswith("rejects-check") or case.endswith("rejects-delays"):
        assert "--engine async" in err_p and "--engine async" in err_j
    if case == "sweep-seeds":
        report = json.loads(out_p.strip().splitlines()[-1])
        assert report["matches"]["0"] == "run_1"


def test_cli_needs_the_card_unless_asked_for_cpu(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ("async", "sync", "native"):
        rc, out, err, files = _run(
            port_cli, ["mini", "--tests-root", FIXTURES, "--engine", engine,
                       "--metrics"], tmp_path, monkeypatch, capsys)
        assert rc != 0 and "no CUDA device" in err and "--cpu" in err
        assert not out and not files
