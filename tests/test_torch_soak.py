"""The port's open-loop soak harness against the JAX package's, exactly.

Every document of ``soak.soak`` and of the ``soak`` CLI (its ``--out``
doc, stdout, stderr, exit code and the SLO-breach incident directory)
byte for byte under a VirtualClock. One slot shape for the whole module
(2 nodes x 4 instructions, 2 slots), so the JAX wave compiles once.
"""

import contextlib
import io
import json
import pathlib

import pytest

from ue22cs343bb1_openmp_assignment_tpu import soak as jsoak
from ue22cs343bb1_openmp_assignment_tpu.obs.clock import (
    VirtualClock as JaxClock)
from ue22cs343bb1_openmp_assignment_tpu_torch import soak as tsoak
from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import (
    VirtualClock as PortClock)

SOAK = dict(slots=2, arrival_rate=50.0)
CLI = ["--arrival-rate", "50", "--duration", "0.3", "--nodes", "2",
       "--trace-len", "4", "--slots", "2", "--virtual-clock",
       "--wave-s", "0.01"]


def _pair(stream, **kw):
    """The same stream made by both packages (equal as plain tuples)."""
    a = getattr(jsoak, stream)(**kw)
    b = getattr(tsoak, stream)(**kw)
    assert [(t, s.__dict__) for t, s in a] == [(t, s.__dict__)
                                               for t, s in b]
    return a, b


@pytest.mark.parametrize("wave_s", [0.001, 0.01, 0.2])
def test_soak_doc_byte_identical(wave_s):
    """Under-loaded, near and saturated regimes: the whole soak doc
    (latency, series, verdict, spans) equals the JAX package's."""
    a, b = _pair("soak_stream", arrival_rate=50.0, duration_s=0.3, nodes=2,
                 trace_len=4)
    jd = jsoak.soak(a, clock=JaxClock(wave_s=wave_s), **SOAK)
    td = tsoak.soak(b, clock=PortClock(wave_s=wave_s), device="cpu",
                    **SOAK)
    assert json.dumps(td, sort_keys=True) == json.dumps(jd, sort_keys=True)
    assert td["jobs_quiesced"] == td["jobs_total"] == len(a)


def test_bursty_soak_byte_identical():
    a, b = _pair("bursty_stream", arrival_rate=30.0, duration_s=0.3,
                 nodes=2, trace_len=4, seed=3)
    jd = jsoak.soak(a, clock=JaxClock(wave_s=0.01), **SOAK)
    td = tsoak.soak(b, clock=PortClock(wave_s=0.01), device="cpu", **SOAK)
    assert json.dumps(td, sort_keys=True) == json.dumps(jd, sort_keys=True)


def test_slo_parsing_and_checks_match():
    for spec in ("p95=5,p99=20", "p50=0.5"):
        assert tsoak.parse_slo(spec) == jsoak.parse_slo(spec)
    for bad in ("p95", "p90=1", "p95=x", "p95=-1", ""):
        with pytest.raises(ValueError):
            tsoak.parse_slo(bad)
        with pytest.raises(ValueError):
            jsoak.parse_slo(bad)
    lat = {"p50_ms": 1.0, "p95_ms": 2.0, "p99_ms": 3.0}
    slo = {"p50_ms": 0.5, "p99_ms": 9.0}
    assert tsoak.check_slo(lat, slo) == jsoak.check_slo(lat, slo)
    assert tsoak.check_slo(None, slo) == []


def _files(root) -> dict:
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _run_cli(main, argv):
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        rc = main(argv)
    return rc, o.getvalue(), e.getvalue()


@pytest.mark.parametrize("gate", [
    ["--slo", "p95=100000"],
    ["--slo", "p95=0.001"],
    ["--burn-slo", "0.000001ms,fast=60,slow=300,factor=2"]],
    ids=["slo-pass", "slo-breach", "burn-breach"])
def test_soak_cli_side_by_side(tmp_path, gate):
    """``soak`` in both CLIs: exit code (4 on a breach), stdout, stderr,
    the --out doc and the incident directory, byte for byte."""
    from ue22cs343bb1_openmp_assignment_tpu import cli as jcli
    from ue22cs343bb1_openmp_assignment_tpu_torch import cli as tcli
    res = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--cpu"])):
        d = tmp_path / name
        argv = ["soak"] + CLI + gate + [
            "--out", str(d / "soak.json"), "--incident-dir",
            str(d / "incident")] + extra
        d.mkdir()
        rc, out, err = _run_cli(main, argv)
        res[name] = (rc, out, err.replace(str(d), "{d}"), _files(d))
    assert res["port"] == res["jax"]
    rc, _, err, files = res["port"]
    if gate[1].startswith("p95=1"):
        assert rc == 0 and "incident/incident.json" not in files
    else:
        assert rc == tsoak.EXIT_SLO_BREACH == 4
        assert "incident dumped" in err
        inc = tsoak.load_incident(tmp_path / "port" / "incident")
        assert inc["reason"] == "slo-breach"
        assert sorted(inc["files"]) == ["incident.json",
                                        "trace.perfetto.json"]


def test_incident_round_trip_and_schema_check(tmp_path):
    a, b = _pair("soak_stream", arrival_rate=50.0, duration_s=0.3, nodes=2,
                 trace_len=4)
    td = tsoak.soak(b, clock=PortClock(wave_s=0.01), device="cpu", **SOAK)
    breach = [{"metric": "p95_ms", "observed_ms": 1.0, "limit_ms": 0.5}]
    inc = tsoak.dump_incident(tmp_path / "port", td, breach)
    jinc = jsoak.dump_incident(tmp_path / "jax", td, breach)
    assert inc == jinc
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert tsoak.load_incident(tmp_path / "port") == inc
    (tmp_path / "port" / "incident.json").write_text('{"schema": "x"}')
    with pytest.raises(ValueError, match="schema"):
        tsoak.load_incident(tmp_path / "port")
