"""The port's dashboard (``obs/dashboard.py``, the ``dashboard`` verb)
against the JAX package, exactly.

``obs/dashboard.py`` is a copy: on the archived captures it renders the
golden files byte for byte, and on the same entries (the archives, a
live entry with a cost vector, a serving entry, a recording and a
coherence profile) its model and both renders equal JAX's. The verb
takes JAX's flags and prints and exits as JAX's does. The one place the
models differ: an entry recorded on an NVIDIA H100 classifies against
the port's ``h100`` peak row, where JAX falls back to generic peaks.
"""

import json
import pathlib

import pytest

from ue22cs343bb1_openmp_assignment_tpu.obs import cli as jax_obs_cli
from ue22cs343bb1_openmp_assignment_tpu.obs import dashboard as jax_dashboard
from ue22cs343bb1_openmp_assignment_tpu.obs import history as jax_history
from ue22cs343bb1_openmp_assignment_tpu.obs import recording as jax_recording
from ue22cs343bb1_openmp_assignment_tpu_torch import cli as port_cli
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (
    dashboard, history, recording)

import tests.torch_parity  # noqa: F401  (one torch thread a process)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
ARCHIVES = ([str(ROOT / f"BENCH_r0{i}.json") for i in range(1, 6)]
            + [str(ROOT / f"MULTICHIP_r0{i}.json") for i in range(1, 7)])
H100 = "NVIDIA H100 80GB HBM3"


def _live(mod, label, device_kind="cpu"):
    """A live bench entry with a cost vector (two kernels), built by
    ``mod``'s history."""
    cost = {"per_step_kernel": "sync.round_step", "steps": 96,
            "retired": 4096, "bytes_per_instr": 1234.5,
            "flops_per_instr": 150.25, "cost_available": True,
            "kernels": {"sync.round_step": {
                "flops": 6400.0, "hbm_bytes": 52000.0,
                "output_bytes": 9000.0, "cost_available": True},
                "sync.run_to_quiescence[chunk=8]": {
                "flops": 51200.0, "hbm_bytes": 416000.0,
                "output_bytes": 72000.0, "cost_available": True}}}
    return mod.entry(
        label=label, source="bench",
        result={"metric": "simulated RD/WR instrs/sec @64 cores (deep "
                          "engine, uniform, procedural, 1 chip, cpu)",
                "value": 2.5e6, "unit": "instrs/sec"},
        extra={"engine": "deep", "rep_times_s": [0.5, 0.52, 0.51],
               "steps": 96, "retired": 4096, "quiescent": True},
        config={"engine": "deep", "nodes": 64, "workload": "uniform"},
        device_kind=device_kind, hlo_fingerprint="0123456789abcdef",
        cost=cost)


def _serving(mod):
    return mod.entry(
        label="serve@8", source="bench",
        result={"metric": "serve jobs/sec", "value": 550.0,
                "unit": "jobs/sec"},
        extra={"engine": "async", "rep_times_s": [0.03]},
        device_kind="cpu",
        serve={"slots": 8, "jobs": 16, "waves": 2, "padding_waste": 0.125})


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A small recording (three jobs through the port's daemon core on a
    VirtualClock) and a coherence profile document, on disk."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import soak
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu_torch.daemon import core
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import cohprof
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import (
        VirtualClock)
    tmp = tmp_path_factory.mktemp("dash")
    rec = tmp / "rec"
    c = core.DaemonCore(slots=2, chunk=16, clock=VirtualClock(wave_s=1e-3),
                        device="cpu")
    core.attach_recorder(c, str(rec))
    arr = soak.soak_stream(60.0, 0.05, nodes=2, trace_len=4, seed=2)[:3]
    core.drive(c, [(t, s, ("interactive", "batch")[i % 2])
                   for i, (t, s) in enumerate(arr)])
    c.recorder.close()
    cfg = SystemConfig.scale(num_nodes=4)
    sysm = CoherenceSystem.from_workload(cfg, "uniform", trace_len=4,
                                         seed=0, device="cpu")
    prof = tmp / "prof.json"
    prof.write_text(json.dumps(cohprof.capture_async(sysm.cfg, sysm.state,
                                                     16)))
    litmus = tmp / "litmus.json"
    litmus.write_text(json.dumps({"litmus": {"mesi": {"sb": {
        "ok": True, "observed": [[0, 0], [1, 1]],
        "allowed": [[0, 0], [1, 1], [0, 1]], "unexpected": []}}}}))
    return {"rec": rec, "prof": prof, "litmus": litmus}


def test_dashboard_golden_render(tmp_path, capsys):
    html, md = tmp_path / "d.html", tmp_path / "d.md"
    rc = port_cli.main(["dashboard", *ARCHIVES, "--html", str(html),
                        "--md", str(md)])
    assert rc == 0 and "wrote" in capsys.readouterr().err
    assert html.read_bytes() == (GOLDEN / "dashboard.html").read_bytes()
    assert md.read_bytes() == (GOLDEN / "dashboard.md").read_bytes()


def test_dashboard_model_and_renders_match_jax(artifacts):
    def entries(mod):
        return ([mod.ingest_capture(p) for p in ARCHIVES[:5]]
                + [mod.ingest_multichip(p) for p in ARCHIVES[5:]]
                + [_live(mod, "live"), _serving(mod)])
    port_e, jax_e = entries(history), entries(jax_history)
    assert port_e == jax_e
    prof = json.loads(artifacts["prof"].read_text())
    kw = dict(recordings=[recording.load(str(artifacts["rec"]))],
              profiles=[prof])
    jkw = dict(recordings=[jax_recording.load(str(artifacts["rec"]))],
               profiles=[prof])
    model = dashboard.build_model(port_e, **kw)
    assert model == jax_dashboard.build_model(jax_e, **jkw)
    assert model["roofline"] and model["recordings"] and model["profiles"]
    assert model["serving"]
    assert dashboard.render_html(model) == jax_dashboard.render_html(model)
    assert dashboard.render_markdown(model) == \
        jax_dashboard.render_markdown(model)


def test_dashboard_h100_entry_classifies_against_the_h100_row():
    port = dashboard.build_model([_live(history, "card", H100)])
    jax_m = jax_dashboard.build_model([_live(jax_history, "card", H100)])
    for p, j in zip(port["roofline"], jax_m["roofline"]):
        assert p["ridge"] == pytest.approx(5.0) and j["ridge"] == 200.0
        assert p["device_kind"] == j["device_kind"] == H100
        assert p["ai"] == j["ai"]
    port.pop("roofline"), jax_m.pop("roofline")
    assert port == jax_m
    assert "NVIDIA H100 80GB HBM3 (ridge 5.0 flop/B)" in \
        dashboard.render_html(dashboard.build_model(
            [_live(history, "card", H100)]))


def _both(argv, capsys) -> tuple:
    """(rc, stdout, stderr) of the port's verb and of JAX's."""
    rc = port_cli.main(["dashboard", *argv])
    port = capsys.readouterr()
    rc_jax = jax_obs_cli.main_dashboard(list(argv))
    jax_out = capsys.readouterr()
    return (rc, port.out, port.err), (rc_jax, jax_out.out, jax_out.err)


def test_dashboard_verb_matches_jax(tmp_path, artifacts, capsys):
    hist = tmp_path / "h.jsonl"
    history.append(str(hist), _live(history, "live"))
    history.append(str(hist), _serving(history))
    port, jax_res = _both(
        ["--history", str(hist), ARCHIVES[0], ARCHIVES[5], "--json",
         "--litmus", str(artifacts["litmus"]), "--recording",
         str(artifacts["rec"]), "--profile", str(artifacts["prof"])],
        capsys)
    assert port == jax_res and port[0] == 0
    model = json.loads(port[1])
    assert model["litmus"] and model["recordings"] and model["profiles"]


@pytest.mark.parametrize("case", ["no-input", "no-output", "bad-litmus",
                                  "missing-history"])
def test_dashboard_usage_errors_match_jax(case, tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    argv = {"no-input": [],
            "no-output": [ARCHIVES[0]],
            "bad-litmus": [ARCHIVES[0], "--json", "--litmus", str(bad)],
            "missing-history": ["--history", str(tmp_path / "none.jsonl"),
                                "--json"]}[case]
    port, jax_res = _both(argv, capsys)
    assert port == jax_res and port[0] == 2
