"""The message-level engine as a whole: the port's CoherenceSystem and
runners against the JAX package's, exactly.

Lockstep, cycle by cycle, on the in-repo fixture tests/fixtures/mini
(reference config, mailbox INV) with byte-identical dumps; the schedule
knobs (arbitration rank, issue delay and period) on the same fixture;
``procedural_uniform`` at 64 nodes in scatter mode run to quiescence
(state, metrics, coherence report); a run whose overflowing rings strand
requesters (the stall watchdog); and fault injection and the random
workloads, which now draw from the threefry twin of jax.random.
"""

import dataclasses
import functools
import pathlib

import jax
import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu.models.system import (
    CoherenceSystem as JaxSystem)
from ue22cs343bb1_openmp_assignment_tpu.ops import failures as jfail
from ue22cs343bb1_openmp_assignment_tpu.ops import invariants as jinv
from ue22cs343bb1_openmp_assignment_tpu.ops import step as jstep
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.models import workloads
from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
    CoherenceSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import invariants
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
from ue22cs343bb1_openmp_assignment_tpu_torch.state import init_state

from tests.torch_parity import assert_sim_states_equal, cfg_pair

MINI = "tests/fixtures/mini"


@functools.lru_cache(maxsize=None)
def _jax_cycle():
    return jax.jit(jstep.cycle, static_argnums=0)


def _lockstep(jcfg, jsys, tsys, limit=400):
    """Step both machines until the JAX one is quiescent, every leaf
    equal after every cycle; returns (jax state, port system)."""
    js, ts = jsys.state, tsys.state
    cyc = _jax_cycle()
    for n in range(limit):
        if bool(js.quiescent()):
            break
        js = cyc(jcfg, js)
        ts = step.cycle(tsys.cfg, ts)
        assert_sim_states_equal(js, ts, f"cycle {n + 1}: ")
    assert bool(js.quiescent()) and bool(ts.quiescent())
    return js, tsys.__class__(tsys.cfg, ts)


def test_mini_fixture_lockstep_and_dumps(tmp_path):
    jcfg, tcfg = cfg_pair(4, reference=True)
    jsys = JaxSystem.from_test_dir(MINI, jcfg)
    js, tsys = _lockstep(jcfg, jsys,
                         CoherenceSystem.from_test_dir(MINI, tcfg,
                                                       device="cpu"))
    jdone = JaxSystem(jcfg, js)
    assert tsys.dumps() == jdone.dumps()
    assert tsys.metrics == jdone.metrics
    assert tsys.instrs_retired == jdone.instrs_retired > 0
    # run() stops exactly at quiescence, like the JAX run()
    again = CoherenceSystem.from_test_dir(MINI, tcfg, device="cpu").run()
    assert again.dumps() == jdone.dumps() and again.metrics == jdone.metrics
    paths = tsys.write_dumps(str(tmp_path))
    assert [pathlib.Path(p).read_text() for p in paths] == jdone.dumps()
    assert tsys.check_invariants(strict_coherence=False) == \
        jinv.coherence_report(jcfg, js)


@pytest.mark.parametrize("knobs", [
    dict(arb_rank=[3, 1, 0, 2]),
    dict(issue_delay=[0, 2, 1, 3], issue_period=[1, 2, 1, 3]),
    dict(arb_rank=[2, 0, 3, 1], issue_delay=[1, 0, 0, 2])],
    ids=["arb_rank", "issue_delay", "both"])
def test_schedule_knobs_lockstep(knobs):
    """Another arbitration order or issue schedule: another legal
    interleaving, the same in both engines cycle by cycle."""
    jcfg, tcfg = cfg_pair(4, reference=True)
    js, tsys = _lockstep(
        jcfg, JaxSystem.from_test_dir(MINI, jcfg, **knobs),
        CoherenceSystem.from_test_dir(MINI, tcfg, device="cpu", **knobs))
    assert tsys.dumps() == JaxSystem(jcfg, js).dumps()


@pytest.mark.parametrize("chunk", [16])
def test_procedural_uniform_to_quiescence(chunk):
    """64 nodes, scatter INV: the chunked runner ends in the same state
    after the same cycles, with the same metrics and coherence report
    (the workload is racy, so the report need not be clean)."""
    jcfg, tcfg = cfg_pair(64, queue_capacity=32)
    jsys = JaxSystem.from_workload(jcfg, "procedural_uniform",
                                   trace_len=24)
    tsys = CoherenceSystem.from_workload(tcfg, "procedural_uniform",
                                         trace_len=24, device="cpu")
    assert_sim_states_equal(jsys.state, tsys.state, "init: ")
    want = jstep.run_chunked_to_quiescence(jsys.cfg, jsys.state, chunk,
                                           5000)
    got = tsys.run(5000, chunk=chunk)
    assert_sim_states_equal(want, got.state)
    assert got.quiescent and got.metrics["cycles"] % chunk == 0
    assert got.instrs_retired == 64 * 24
    assert got.metrics == JaxSystem(jsys.cfg, want).metrics
    assert invariants.coherence_report(got.cfg, got.state) == \
        jinv.coherence_report(jsys.cfg, want)
    assert {k: int(v) for k, v in invariants.step_violations(
        got.cfg, got.state).items()} == \
        {k: int(v) for k, v in jinv.step_violations(jsys.cfg, want).items()}


def test_stalled_run_stall_report():
    """Rings of two slots overflow, replies are dropped and their
    requesters wait for ever: the same stall report as JAX."""
    jcfg, tcfg = cfg_pair(16, queue_capacity=2)
    jsys = JaxSystem.from_workload(jcfg, "procedural_uniform",
                                   trace_len=12)
    tsys = CoherenceSystem.from_workload(tcfg, "procedural_uniform",
                                         trace_len=12, device="cpu")
    want = jstep.run_cycles(jsys.cfg, jsys.state, 120)
    got = tsys.run_cycles(120)
    assert_sim_states_equal(want, got.state)
    report = got.stall_report(threshold=40)
    assert report == jfail.stall_report(jsys.cfg, want, 40)
    assert report["count"] > 0 and got.metrics["msgs_dropped"] > 0
    assert got.stalled(40) == report["nodes"]
    # the dropped messages broke the directory: the engine tier says so,
    # as in JAX, and run_checked refuses such a run
    viol = {k: int(v) for k, v in invariants.step_violations(
        got.cfg, got.state).items()}
    assert viol == {k: int(v) for k, v in jinv.step_violations(
        jsys.cfg, want).items()}
    assert any(viol.values())
    with pytest.raises(AssertionError, match="during run"):
        tsys.run_checked(120)


def test_run_cycles_step_and_run_checked_agree():
    _, tcfg = cfg_pair(4, reference=True)
    a = CoherenceSystem.from_test_dir(MINI, tcfg, device="cpu")
    b = a.run_cycles(5)
    c = a.step().step().step().step().step()
    d = a.run_checked(5)
    assert b.metrics == c.metrics == d.metrics and b.metrics["cycles"] == 5
    assert b.dumps() == c.dumps() == d.dumps()
    assert b.check_invariants(strict_coherence=False) == {}   # in flight


def test_fault_injection_and_random_workloads_wait_for_threefry():
    """The three calls that waited for the threefry twin of jax.random
    now draw from it (``utils.random``): ``init_state`` under drop_prob
    0.25, ``from_workload`` under that config, and the JAX default
    workload ``uniform``. Each builds, with leaves equal to the JAX
    package's, and the fault-injected machine's first cycles drop
    messages from the same stream as JAX's."""
    from ue22cs343bb1_openmp_assignment_tpu.state import (
        init_state as jax_init_state)
    jcfg, tcfg = cfg_pair(16, drop_prob=0.25)
    assert_sim_states_equal(jax_init_state(jcfg),
                            init_state(tcfg, device="cpu"))
    jsys = JaxSystem.from_workload(jcfg, "procedural_uniform")
    tsys = CoherenceSystem.from_workload(tcfg, "procedural_uniform",
                                         device="cpu")
    assert_sim_states_equal(jsys.state, tsys.state)
    js, ts = jsys.state, tsys.state
    for n in range(12):
        js, ts = _jax_cycle()(jcfg, js), step.cycle(tcfg, ts)
        assert_sim_states_equal(js, ts, f"cycle {n + 1}: ")
    assert int(ts.metrics.msgs_injected_dropped) > 0
    jok, ok = cfg_pair(16)
    assert_sim_states_equal(
        JaxSystem.from_workload(jok, "uniform").state,
        CoherenceSystem.from_workload(ok, "uniform", device="cpu").state)
    assert set(workloads.GENERATORS) == {
        "uniform", "producer_consumer", "false_sharing",
        "false_sharing_vars", "false_sharing_vars_padded", "fft", "radix",
        "lu", "hotspot", "zipf_hotspot", "procedural_uniform"}


def test_state_round_trips_through_numpy():
    """convert carries a JAX SimState into the port and back, bit for
    bit (uint32 words, bool flags, the fault key of a seed)."""
    jcfg, tcfg = cfg_pair(4, reference=True)
    js = JaxSystem.from_test_dir(MINI, jcfg, fault_seed=2**31 + 5).state
    js = _jax_cycle()(jcfg, js)
    leaves = convert.sim_numpy_leaves(js)
    port = convert.sim_from_numpy(tcfg, leaves, device="cpu")
    assert port.dir_bitvec.dtype == torch.int32
    back = convert.sim_numpy_leaves(port)
    for k in leaves:
        assert leaves[k].dtype == back[k].dtype and np.array_equal(
            leaves[k], back[k]), k
    assert np.array_equal(
        back["fault_key"],
        np.asarray(jax.random.key_data(jax.random.PRNGKey(2**31 + 5))))
    assert convert.leaves_digest(back) == convert.leaves_digest(leaves)
    back["cycle"] = back["cycle"] + 1
    assert convert.leaves_digest(back) != convert.leaves_digest(leaves)
    with pytest.raises(ValueError, match="shape"):
        convert.sim_from_numpy(dataclasses.replace(tcfg, num_nodes=8),
                               leaves, device="cpu")


def test_workload_arrays_already_on_the_target_device():
    """``from_workload`` hands init_state tensors made on the target
    device; they are taken as they are, never through numpy (a CUDA
    tensor has no numpy view). The meta device stands in for the card."""
    _, tcfg = cfg_pair(16, max_instrs=4)
    sys_ = CoherenceSystem.from_workload(tcfg, "procedural_uniform",
                                         device="meta")
    assert sys_.state.instr_op.device.type == "meta"
    st = init_state(tcfg, device="meta",
                    arb_rank=torch.arange(16, device="meta").flip(0))
    assert st.arb_rank.dtype == torch.int32


@pytest.mark.slow
def test_chip_smoke_async_reference_is_the_jax_run():
    """chip_smoke.py holds the card's async@4096 run to numbers recorded
    from the JAX package by scripts/async_reference.py; recompute them
    (about 30 s of JAX on the CPU)."""
    import importlib.util
    import json
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "scripts/async_reference.py"],
                         cwd=root, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert {k: got[k] for k in smoke.ASYNC_REFERENCE} == \
        smoke.ASYNC_REFERENCE
    cfg = smoke.async_cfg(smoke.ASYNC["num_nodes"], smoke.ASYNC["trace_len"])
    assert (got["nodes"], got["trace_len"], got["chunk"],
            got["queue_capacity"]) == (
        smoke.ASYNC["num_nodes"], smoke.ASYNC["trace_len"],
        smoke.ASYNC["chunk"], cfg.queue_capacity)
