"""The port's observability host modules and verbs against the JAX
package's.

The copies (``obs/phases``, ``timeseries``, ``txntrace``, ``critpath``,
``perfetto``, ``cohprof``, ``flight``) run on the port's captures and
must give the JAX modules' documents on the JAX captures of the same
machine, byte for byte under the JAX package's own ``json.dumps``
arguments. The verbs (``obs/verbs.py`` through ``cli.main``) run side by
side with the JAX CLI's in process with ``--cpu``, each in a directory
of its own: equal exit codes, stdout, stderr and written files, with
``extra.phases`` (wall clock) compared by its keys and counts. The
flight recorder's incident of ``--check --flight-dir`` must be the JAX
CLI's, and either package's ``load_incident`` reads either's incident.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu import cli as jax_cli
from ue22cs343bb1_openmp_assignment_tpu.models.system import (
    CoherenceSystem as JaxSystem)
from ue22cs343bb1_openmp_assignment_tpu.obs import cohprof as jcohprof
from ue22cs343bb1_openmp_assignment_tpu.obs import critpath as jcritpath
from ue22cs343bb1_openmp_assignment_tpu.obs import flight as jflight
from ue22cs343bb1_openmp_assignment_tpu.obs import perfetto as jperfetto
from ue22cs343bb1_openmp_assignment_tpu.obs import phases as jphases
from ue22cs343bb1_openmp_assignment_tpu.obs import timeseries as jts
from ue22cs343bb1_openmp_assignment_tpu.obs import txntrace as jtxn
from ue22cs343bb1_openmp_assignment_tpu.ops import step as jstep
from ue22cs343bb1_openmp_assignment_tpu_torch import cli as port_cli
from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
    CoherenceSystem as PortSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import cohprof as pcohprof
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import critpath as pcritpath
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import flight as pflight
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import perfetto as pperfetto
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import phases as pphases
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import timeseries as pts
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import txntrace as ptxn
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import verbs
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step as pstep

from tests.torch_parity import assert_sim_states_equal, cfg_pair

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = str(ROOT / "tests" / "fixtures")
MINI = ["mini", "--tests-root", FIXTURES, "--cpu"]
U16 = ["--workload", "uniform", "--nodes", "16", "--trace-len", "16",
       "--cpu"]
FS16 = ["--workload", "false_sharing", "--nodes", "16", "--trace-len", "16",
        "--cpu"]
PACKAGES = {"jax": jax_cli, "port": port_cli}


def _dumps(doc) -> str:
    """The JAX CLI's document bytes (obs/cli.py ``_emit``)."""
    return json.dumps(doc, indent=2, sort_keys=True) + "\n"


def _machines(workload: str = "false_sharing", nodes: int = 16,
              length: int = 16):
    jcfg, tcfg = cfg_pair(nodes)
    js = JaxSystem.from_workload(jcfg, workload, trace_len=length, seed=5)
    ps = PortSystem.from_workload(tcfg, workload, trace_len=length, seed=5,
                                  device="cpu")
    assert_sim_states_equal(js.state, ps.state)
    return js, ps


# -- the host modules --------------------------------------------------------

def test_timeseries_of_the_telemetry_matches_jax():
    js, ps = _machines()
    _, jt = jstep.run_cycles_telemetry(js.cfg, js.state, 60)
    _, pt = pstep.run_cycles_telemetry(ps.cfg, ps.state, 60)
    pt = {k: v.numpy() for k, v in pt.items()}
    assert _dumps(pts.summarize(pt)) == _dumps(jts.summarize(jt))
    assert _dumps(pts.to_series(pt)) == _dumps(jts.to_series(jt))
    assert pts.DIR_STATES == jts.DIR_STATES


def test_txntrace_spans_and_critical_path_match_jax():
    js, ps = _machines()
    T = int(js.run(10_000).metrics["cycles"])
    _, jled, jbase = jtxn.capture(js.cfg, js.state, T,
                                  stop_on_quiescence=False)
    _, pled, pbase = ptxn.capture(ps.cfg, ps.state, T, chunk=17,
                                  stop_on_quiescence=False)
    assert jbase == pbase == 0 and sorted(jled) == sorted(pled)
    for k in jled:
        assert jled[k].dtype == pled[k].dtype and np.array_equal(
            jled[k], pled[k]), k
    jspans, jtrace = jtxn.reconstruct(js.cfg, jled, jbase,
                                      arb_rank=np.asarray(js.state.arb_rank))
    pspans, ptrace = ptxn.reconstruct(ps.cfg, pled, pbase,
                                      arb_rank=ps.state.arb_rank.numpy())
    assert pspans == jspans and len(pspans) > 0
    assert _dumps(ptxn.summarize(pspans)) == _dumps(jtxn.summarize(jspans))
    assert _dumps(ptxn.spans_doc(ps.cfg, pspans, T)) == _dumps(
        jtxn.spans_doc(js.cfg, jspans, T))
    prep = pcritpath.critical_path(ptrace, total_cycles=T)
    jrep = jcritpath.critical_path(jtrace, total_cycles=T)
    assert _dumps(prep) == _dumps(jrep)
    assert pcritpath.hotspots(prep) == jcritpath.hotspots(jrep)
    # the flight recorder's warm-started tail summary
    assert _dumps(ptxn.incident_summary(ps.cfg, ps.state, T, window=20,
                                        chunk=8)) == _dumps(
        jtxn.incident_summary(js.cfg, js.state, T, window=20, chunk=8))


def test_perfetto_docs_match_jax():
    js, ps = _machines("uniform")
    _, jev = js.run_cycles_traced(40)
    _, pev = ps.run_cycles_traced(40)
    from ue22cs343bb1_openmp_assignment_tpu.utils import eventlog as jlog
    from ue22cs343bb1_openmp_assignment_tpu_torch.utils import (
        eventlog as plog)
    jdoc = jperfetto.build_trace(jlog.to_records(jev), 16)
    pdoc = pperfetto.build_trace(plog.to_records(pev), 16)
    pperfetto.validate_trace(pdoc)
    assert json.dumps(pdoc) == json.dumps(jdoc)
    _, jled, _ = jtxn.capture(js.cfg, js.state, 40)
    _, pled, _ = ptxn.capture(ps.cfg, ps.state, 40)
    jsp, _ = jtxn.reconstruct(js.cfg, jled)
    psp, _ = ptxn.reconstruct(ps.cfg, pled)
    flows = pperfetto.span_flow_events(psp)
    assert flows == jperfetto.span_flow_events(jsp) and flows
    assert json.dumps(pperfetto.build_trace(
        ptxn.ledger_to_records(pled), 16, flows=flows)) == json.dumps(
        jperfetto.build_trace(jtxn.ledger_to_records(jled), 16,
                              flows=jperfetto.span_flow_events(jsp)))


@pytest.mark.parametrize("engine", ["async", "sync", "deep"])
def test_cohprof_docs_match_jax(engine):
    """The ``cache-sim/profile/v1`` doc of each engine's capture, and its
    text rendering, byte for byte."""
    if engine == "async":
        js, ps = _machines("false_sharing")
        jdoc = jcohprof.capture_async(js.cfg, js.state, 60, k=4)
        pdoc = pcohprof.capture_async(ps.cfg, ps.state, 60, k=4)
        assert pdoc["miss_classes"] is not None
    else:
        from ue22cs343bb1_openmp_assignment_tpu.models.transactional import (
            TransactionalSystem as JT)
        from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional \
            import TransactionalSystem as PT
        deep = engine == "deep"
        kw = dict(drain_depth=13 if deep else 4, txn_width=3)
        if deep:
            kw.update(deep_window=True, deep_slots=3, deep_ownerval_slots=1,
                      deep_horizon_slack=4)
        jcfg, tcfg = cfg_pair(16, **kw)
        jt = JT.from_workload(jcfg, "uniform", trace_len=16, workload_seed=1)
        pt = PT.from_workload(tcfg, "uniform", trace_len=16, workload_seed=1,
                              device="cpu")
        jcap = jcohprof.capture_deep if deep else jcohprof.capture_sync
        pcap = pcohprof.capture_deep if deep else pcohprof.capture_sync
        # 4 rounds at the verbs' own configs (profile-sync and
        # profile-deep below): one JAX compile serves both
        jdoc = jcap(jcfg, jt.state, 4, k=4)
        pdoc = pcap(tcfg, pt.state, 4, k=4)
        assert (pdoc["abort_anatomy"] is not None) == deep
    assert _dumps(pdoc) == _dumps(jdoc)
    assert pcohprof.render_text(pdoc) == jcohprof.render_text(jdoc)
    assert pcohprof.validate(jdoc) == jdoc
    assert pdoc["accesses"]["reads"] + pdoc["accesses"]["writes"] > 0


def test_phase_timer_reports_like_jax():
    reports = []
    for mod in (jphases, pphases):
        t = mod.PhaseTimer()
        for name in ("build", "run", "device_get", "run"):
            t.add(name, 0.25)
        with t.phase("device_get"):
            pass
        t.attach("note", {"k": 1})
        rep = t.report()
        for p in rep["phases"].values():
            p["seconds"] = round(p["seconds"], 2)
        rep["total_seconds"] = round(rep["total_seconds"], 2)
        reports.append(rep)
    assert reports[0] == reports[1]
    assert list(reports[1]["phases"]) == ["build", "run", "device_get"]


# -- the verbs ---------------------------------------------------------------

#: id -> argv (run through both packages' cli.main, "{d}" the run's
#: directory); EXPECTED_RC the exits other than 0
CASES = {
    "stats-mini-all": ["stats"] + MINI + ["--timeseries", "--txns",
                                          "--phases", "--timeseries-out",
                                          "series.json"],
    "stats-async-out": ["stats"] + U16 + ["--out", "report.json"],
    "stats-sync": ["stats"] + U16 + ["--engine", "sync"],
    "stats-native": ["stats"] + FS16 + ["--engine", "native"],
    "stats-sync-timeseries": ["stats"] + U16 + ["--engine", "sync",
                                                "--timeseries"],
    "stats-no-input": ["stats", "--cpu"],
    "trace-async": ["trace"] + U16 + ["--perfetto", "t.json"],
    "trace-mini-no-msgs": ["trace"] + MINI + ["--perfetto", "t.json",
                                              "--no-msgs"],
    "trace-deep": ["trace"] + FS16 + ["--perfetto", "t.json", "--engine",
                                      "deep"],
    "txns-json-perfetto": ["txns"] + U16 + ["--json", "--perfetto",
                                            "tx.json", "--top", "3"],
    "txns-mini": ["txns"] + MINI,
    "txns-run-cycles": ["txns"] + FS16 + ["--run-cycles", "25"],
    "critical-path": ["critical-path"] + FS16,
    "critical-path-json": ["critical-path"] + U16 + ["--json", "--out",
                                                     "cp.json"],
    "profile-async-json": ["profile"] + U16 + ["--json"],
    "profile-async-text": ["profile"] + FS16 + ["--top", "3"],
    "profile-sync": ["profile"] + U16 + ["--engine", "sync",
                                         "--run-cycles", "4"],
    "profile-sync-mini": ["profile"] + MINI + ["--engine", "sync",
                                               "--json"],
    "profile-deep": ["profile"] + U16 + ["--engine", "deep", "--json",
                                         "--run-cycles", "4"],
    "profile-deep-no-exact": pytest.param(
        ["profile"] + FS16 + ["--engine", "deep", "--no-exact-flags",
                              "--run-cycles", "3", "--out", "p.txt"],
        marks=pytest.mark.slow),
    "profile-no-exact-needs-deep": ["profile"] + U16 + ["--no-exact-flags"],
    "profile-deep-too-big": ["profile", "--workload", "uniform", "--nodes",
                             "4096", "--engine", "deep", "--cpu"],
}
EXPECTED_RC = {"stats-sync-timeseries": 2, "stats-no-input": 2,
               "profile-no-exact-needs-deep": 2, "profile-deep-too-big": 2}


def _run(mod, argv, cwd, monkeypatch, capsys):
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    rc = mod.main(argv)
    out, err = capsys.readouterr()
    files = {str(p.relative_to(cwd)): p.read_bytes()
             for p in sorted(cwd.rglob("*")) if p.is_file()}
    return rc, out, err, files


def _without_phases(text: str):
    """(document without extra.phases, phases' names and counts)."""
    doc = json.loads(text)
    ph = doc["extra"].pop("phases")
    return doc, {k: v["count"] for k, v in ph["phases"].items()}


def _cases():
    for case, argv in CASES.items():
        if isinstance(argv, list):
            yield pytest.param(case, argv, id=case)
        else:
            yield pytest.param(case, *argv.values, marks=argv.marks,
                               id=case)


@pytest.mark.parametrize("case, argv", _cases())
def test_verbs_match_the_jax_cli(case, argv, tmp_path, monkeypatch, capsys):
    got = {}
    for name, mod in PACKAGES.items():
        (tmp_path / name).mkdir()
        got[name] = _run(mod, argv, tmp_path / name, monkeypatch, capsys)
    (rc_j, out_j, err_j, files_j), (rc_p, out_p, err_p, files_p) = (
        got["jax"], got["port"])
    assert rc_p == rc_j == EXPECTED_RC.get(case, 0), (err_j, err_p)
    if "--phases" in argv:
        doc_j, ph_j = _without_phases(out_j)
        doc_p, ph_p = _without_phases(out_p)
        assert doc_p == doc_j and ph_p == ph_j
        assert "telemetry_run" in ph_p and "ledger_run" in ph_p
    else:
        assert out_p == out_j
    assert err_p == err_j
    assert sorted(files_p) == sorted(files_j)
    for name in files_j:
        assert files_p[name] == files_j[name], f"{name} differs"
    if rc_j == 0:
        assert out_p or files_p


def test_flight_incident_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    """``--check --flight-dir`` on a run whose engine tier trips
    (``unowned_with_sharers`` after racy uniform traffic, both
    packages): exit 3 and the ``invariant:check`` incident, its
    incident.json and trace.perfetto.json byte-identical; each
    package's ``load_incident`` reads both incidents."""
    argv = ["--workload", "uniform", "--nodes", "64", "--trace-len", "16",
            "--cpu", "--check", "--flight-dir", "fl", "--flight-ring", "24"]
    got = {}
    for name, mod in PACKAGES.items():
        (tmp_path / name).mkdir()
        got[name] = _run(mod, argv, tmp_path / name, monkeypatch, capsys)
    (rc_j, out_j, err_j, files_j), (rc_p, out_p, err_p, files_p) = (
        got["jax"], got["port"])
    assert rc_p == rc_j == 3
    assert (out_p, err_p) == (out_j, err_j)
    inc = "fl/incident_invariant"
    assert sorted(files_p) == sorted(files_j) == [
        f"{inc}/incident.json", f"{inc}/trace.perfetto.json"]
    for name in files_j:
        assert files_p[name] == files_j[name], f"{name} differs"
    docs = [mod.load_incident(str(tmp_path / who / inc))
            for mod in (jflight, pflight) for who in ("jax", "port")]
    assert all(d == docs[0] for d in docs)
    d = docs[0]
    assert d["reason"] == "invariant:check" and not d["has_repro"]
    assert 0 < len(d["ring"]["series"]["instrs_retired"]) <= 24
    assert d["txn_summary"] is not None and d["profile"] is not None


def test_flight_recorder_matches_jax_in_the_library(tmp_path):
    """FlightRecorder alone: the ring of the last k cycles and the dumped
    incident equal the JAX recorder's."""
    js, ps = _machines("uniform")
    jfr = jflight.FlightRecorder(js.cfg, js.state, k=10, chunk=7)
    pfr = pflight.FlightRecorder(ps.cfg, ps.state, k=10, chunk=7)
    jfr.run(100)
    pfr.run(100)
    assert jfr.cycles_run == pfr.cycles_run > 10
    jr, pr = jfr.ring(), pfr.ring()
    assert sorted(jr) == sorted(pr)
    for k in jr:
        assert np.array_equal(jr[k], pr[k]) and jr[k].dtype == pr[k].dtype
    jdoc = jfr.dump_incident(str(tmp_path / "j"), "hang:test", "detail")
    pdoc = pfr.dump_incident(str(tmp_path / "p"), "hang:test", "detail")
    assert _dumps(pdoc) == _dumps(jdoc)
    for f in ("incident.json", "trace.perfetto.json"):
        assert (tmp_path / "p" / f).read_bytes() == (
            tmp_path / "j" / f).read_bytes()


def test_load_incident_refuses_a_wrong_schema(tmp_path):
    (tmp_path / "incident.json").write_text(json.dumps({"schema": "x"}))
    with pytest.raises(ValueError, match="schema"):
        pflight.load_incident(str(tmp_path))


@pytest.mark.parametrize("verb", verbs.VERBS)
def test_verbs_need_the_card_unless_asked_for_cpu(verb, tmp_path,
                                                  monkeypatch, capsys):
    """No card and no --cpu: exit 1 with the CLI's error, no output and
    no file; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extra = (["--perfetto", "t.json"] if verb == "trace" else [])
    rc, out, err, files = _run(
        port_cli, [verb, "mini", "--tests-root", FIXTURES] + extra,
        tmp_path, monkeypatch, capsys)
    assert rc == 1 and "no CUDA device" in err and "--cpu" in err
    assert not out and not files


def test_flight_dir_needs_the_card_unless_asked_for_cpu(tmp_path,
                                                        monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err, files = _run(
        port_cli, ["mini", "--tests-root", FIXTURES, "--check",
                   "--flight-dir", "fl"], tmp_path, monkeypatch, capsys)
    assert rc == 1 and "no CUDA device" in err and not files
