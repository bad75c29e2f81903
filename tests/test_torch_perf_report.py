"""``cache-sim-torch perf-report`` and the bench's instruments on the CPU.

The verb builds its configs as the JAX verb does and pins the same
deterministic integers: ``steps`` and ``retired`` equal the JAX engine's
own run of the same config (async, sync), or the port's plain deep run,
which ``tests/test_torch_deep_engine.py`` holds to JAX. The document
names the kernels JAX's would, is byte-identical across two runs and has
no ``timing`` without ``--timing``; ``--profile`` embeds JAX's coherence
profile of the pinned run. The JAX verb itself is not run: under JAX
0.9.0 it fails before writing a document.
"""

import json

import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu.obs import cli as jax_obs_cli
from ue22cs343bb1_openmp_assignment_tpu_torch import bench
from ue22cs343bb1_openmp_assignment_tpu_torch import cli as port_cli

import tests.torch_parity  # noqa: F401  (one torch thread a process)

SIZE = {"async": ("4", "4"), "sync": ("8", "8"), "deep": ("4", "4")}

#: the kernel names JAX's document carries for each engine
NAMES = {"async": {"step.cycle", "mailbox.dequeue",
                   "step.run_chunked[chunk=4]"},
         "sync": {"sync.round_step", "sync.run_to_quiescence[chunk=4]"},
         "deep": {"sync.round_step", "sync.run_to_quiescence[chunk=4]",
                  "deep.round_fused[io-contract]"}}


def _argv(engine: str, *extra) -> list:
    nodes, trace = SIZE[engine]
    return ["perf-report", "--engine", engine, "--nodes", nodes,
            "--trace-len", trace, "--chunk", "4", "--cpu", "--json", *extra]


def _report(argv, capsys):
    rc = port_cli.main(argv)
    out = capsys.readouterr().out
    assert rc == 0
    return out


def _reference(engine: str) -> tuple:
    """(steps, retired) of the reference run of the verb's config."""
    nodes, trace = int(SIZE[engine][0]), int(SIZE[engine][1])
    if engine == "deep":
        from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
            CoherenceSystem)
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import perf_report
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
            sync_engine as se)
        cfg = perf_report.report_config("deep", nodes)
        sysm = CoherenceSystem.from_workload(cfg, "uniform", trace_len=trace,
                                             seed=0, device="cpu")
        st = se.run_sync_to_quiescence(
            cfg, se.from_sim_state(cfg, sysm.state, seed=0), 4,
            se.claim_max_rounds(cfg) - 1, fold_impl="plain")
        return int(st.metrics.rounds), int(st.metrics.instrs_retired.sum())
    from ue22cs343bb1_openmp_assignment_tpu.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu.models.system import (
        CoherenceSystem)
    if engine == "async":
        from ue22cs343bb1_openmp_assignment_tpu.ops import step
        cfg = SystemConfig.scale(num_nodes=nodes)
        sysm = CoherenceSystem.from_workload(cfg, "uniform", trace_len=trace,
                                             seed=0)
        st = step.run_chunked_to_quiescence(cfg, sysm.state, 4, 100_000)
        return (int(st.metrics.cycles),
                int(np.sum(np.asarray(st.metrics.instrs_retired))))
    from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
    cfg = SystemConfig.scale(num_nodes=nodes, drain_depth=4, txn_width=3)
    sysm = CoherenceSystem.from_workload(cfg, "uniform", trace_len=trace,
                                         seed=0)
    st = jse.run_sync_to_quiescence(
        cfg, jse.from_sim_state(cfg, sysm.state, seed=0), 4,
        min(100_000, jse.claim_max_rounds(cfg) - 1))
    return (int(st.metrics.rounds),
            int(np.sum(np.asarray(st.metrics.instrs_retired))))


@pytest.mark.parametrize("engine", ["async", "sync", "deep"])
def test_perf_report_on_cpu(engine, capsys):
    first = _report(_argv(engine), capsys)
    doc = json.loads(first)
    assert doc["schema"] == "cache-sim/perfreport/v1"
    assert doc["engine"] == engine and doc["device"]["kind"] == "cpu"
    assert doc["per_step_kernel"] == ("step.cycle" if engine == "async"
                                      else "sync.round_step")
    assert {k["name"] for k in doc["kernels"]} == NAMES[engine]
    assert doc["cost_available"] and doc["bound"] == "hbm"
    assert doc["bytes_per_instr"] > 0 and "timing" not in doc
    assert all(k["launches"] == {} for k in doc["kernels"]
               if k.get("basis") == "aten-dispatch")
    assert (doc["steps"], doc["retired"]) == _reference(engine)
    assert ("fused" in doc) == (engine == "deep")
    # JAX's blocks: vmem on the deep engine, index on every engine
    assert ("vmem" in doc) == (engine == "deep")
    if engine == "deep":
        assert [r["kernel"] for r in doc["vmem"]] == ["deep.fold",
                                                      "deep.round_fused"]
        assert all(r["ok"] and r["vmem_bytes"] == 227 * 1024
                   for r in doc["vmem"])
    ix = doc["index"]
    assert ix["engine"] == engine and ix["index_sites"] > 0
    assert ix["indices_per_instr"] == round(
        ix["indices_per_step"] * doc["steps"] / doc["retired"], 3)
    assert _report(_argv(engine), capsys) == first


def test_perf_report_profile_matches_jax_capture(capsys):
    from ue22cs343bb1_openmp_assignment_tpu.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu.obs import cohprof
    doc = json.loads(_report(_argv("async", "--profile"), capsys))
    cfg = SystemConfig.scale(num_nodes=4)
    sysm = CoherenceSystem.from_workload(cfg, "uniform", trace_len=4, seed=0)
    want = cohprof.capture_async(sysm.cfg, sysm.state, doc["steps"])
    assert doc["profile"] == json.loads(json.dumps(want))


def test_perf_report_text_and_timing(capsys):
    out = _report(["perf-report", "--engine", "async", "--nodes", "8",
                   "--trace-len", "4", "--chunk", "4", "--cpu", "--timing",
                   "--reps", "2"], capsys)
    assert out.startswith("perf-report: async engine, 8 nodes (cpu,")
    assert "timing (nondeterministic)" in out and "DISPATCH-BOUND" in out
    assert "transport (wire-shape, 8 shards" in out
    assert "index pressure (step.cycle" in out and "by plane:" in out


def test_perf_report_usage_errors(capsys, monkeypatch):
    want_rc = jax_obs_cli.main_perfreport(["mini"])
    want = capsys.readouterr().err
    assert port_cli.main(["perf-report", "mini", "--cpu"]) == want_rc == 2
    assert capsys.readouterr().err == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_cli.main(["perf-report", "--engine", "async"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_bench_instruments_on_cpu(tmp_path, capsys, monkeypatch):
    """``--kernel-costs`` attaches the runner chunk's dispatch record to
    the phase report (given the config that sizes the card's kernel
    contracts), ``--timer-check`` the self-check, ``--profile-dir`` a
    Chrome trace of the timed runs."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import profiler
    seen = {}
    real = profiler.kernel_cost_report

    def spy(fn, *args, **kw):
        seen.update(kw)
        return real(fn, *args, **kw)
    monkeypatch.setattr(profiler, "kernel_cost_report", spy)
    prof = tmp_path / "prof"
    rc = bench.main(["--engine", "async", "--nodes", "16", "--trace-len",
                     "8", "--chunk", "4", "--reps", "1", "--device", "cpu",
                     "--kernel-costs", "--timer-check", "--profile-dir",
                     str(prof)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    kernels = line["phases"]["kernels"]
    assert kernels["available"] and kernels["basis"] == "aten-dispatch"
    assert kernels["cost"]["bytes accessed"] > 0 and kernels["ops"] > 0
    assert line["phases"]["phases"]["execute_dispatch"]["count"] == 1
    assert line["timer_check"]["barrier_trustworthy"] is True
    assert isinstance(seen["cfg"], SystemConfig)
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
