"""The port's traced runs equal the JAX package's, event for event.

The message-level engine: ``CoherenceSystem.run_cycles_traced`` and
``run_traced`` on ``tests/fixtures/mini`` (the reference config) and on
a 16-node ``procedural_uniform`` workload must give JAX's event arrays,
array for array and dtype for dtype, and ``utils.eventlog``'s records,
lines and per-node projections must equal JAX's; the mini projection is
the fixture's ``instruction_order.txt``. ``run_traced`` caps the run at
``max_cycles`` exactly and gives {} when no block runs; a
``message_phase`` override reaches every cycle.

The deep-window round's event record: ``round_step(with_events=True)``
and ``run_rounds_traced`` on deep configs at 16 nodes (two absorption
waves; the read storm), 8 rounds, against JAX's ``run_rounds_traced``,
state and events equal. With ``fused_round`` set the traced round takes
the fold path, as in JAX. Every comparison is exact.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

from ue22cs343bb1_openmp_assignment_tpu.models.system import (
    CoherenceSystem as JaxSystem)
from ue22cs343bb1_openmp_assignment_tpu.ops import step as jstep
from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu.utils import eventlog as jeventlog
from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
    CoherenceSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import handlers
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as tse
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import eventlog

from tests.torch_parity import (BENCH_DEEP, assert_sim_states_equal,
                                assert_states_equal, cfg_pair)

MINI = pathlib.Path(__file__).resolve().parent / "fixtures" / "mini"


def _systems(workload):
    """(JAX system, port system) of one workload, on the CPU."""
    if workload == "mini":
        jcfg, tcfg = cfg_pair(4, reference=True)
        return (JaxSystem.from_test_dir(MINI, jcfg),
                CoherenceSystem.from_test_dir(MINI, tcfg, device="cpu"))
    jcfg, tcfg = cfg_pair(16, queue_capacity=32)
    return (JaxSystem.from_workload(jcfg, "procedural_uniform",
                                    trace_len=12),
            CoherenceSystem.from_workload(tcfg, "procedural_uniform",
                                          trace_len=12, device="cpu"))


def _assert_events_equal(want: dict, got: dict, where: str = "") -> None:
    assert sorted(want) == sorted(got), (where, sorted(want), sorted(got))
    for k in want:
        a, b = np.asarray(want[k]), got[k]
        assert isinstance(b, np.ndarray), (where, k, type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, (
            where, k, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}{k}")


@pytest.mark.parametrize("workload", ["mini", "procedural_uniform"])
def test_run_traced_matches_jax(workload, tmp_path):
    jsys, tsys = _systems(workload)
    jdone, jev = jsys.run_traced(chunk=16)
    tdone, tev = tsys.run_traced(chunk=16)
    assert tdone.quiescent and jdone.quiescent
    assert_sim_states_equal(jdone.state, tdone.state)
    _assert_events_equal(jev, tev, f"{workload}: ")
    assert eventlog.to_records(tev, base_cycle=2) == jeventlog.to_records(
        jev, base_cycle=2)
    for kinds in (("instr",), ("instr", "msg")):
        lines = eventlog.to_lines(tev, kinds)
        assert lines == jeventlog.to_lines(jev, kinds)
        assert eventlog.per_node_projection(lines) == (
            jeventlog.per_node_projection(lines))
    eventlog.write_log(str(tmp_path / "port.txt"), tev, ("instr", "msg"))
    jeventlog.write_log(str(tmp_path / "jax.txt"), jev, ("instr", "msg"))
    assert (tmp_path / "port.txt").read_text() == (
        tmp_path / "jax.txt").read_text()
    assert int(tev["fetch"].sum()) == tdone.instrs_retired > 0
    if workload == "mini":
        fixture = (MINI / "instruction_order.txt").read_text().splitlines()
        assert eventlog.per_node_projection(eventlog.to_lines(tev)) == (
            eventlog.per_node_projection(fixture))


def test_run_cycles_traced_and_the_cycle_cap():
    """A fixed number of cycles, then run_traced capped at max_cycles
    (the last block trimmed) and from a quiescent machine (no block)."""
    jsys, tsys = _systems("procedural_uniform")
    jmid, jev = jsys.run_cycles_traced(10)
    tmid, tev = tsys.run_cycles_traced(10)
    assert_sim_states_equal(jmid.state, tmid.state)
    _assert_events_equal(jev, tev)
    assert tev["fetch"].shape == (10, 16)
    jcap, jev = jmid.run_traced(max_cycles=17, chunk=4)
    tcap, tev = tmid.run_traced(max_cycles=17, chunk=4)
    assert int(tcap.state.cycle) == 17 and not tcap.quiescent
    assert_sim_states_equal(jcap.state, tcap.state)
    _assert_events_equal(jev, tev)
    assert tev["msg"].shape == (7, 16)
    done = tcap.run()
    assert done.run_traced()[1] == {} and jcap.run().run_traced()[1] == {}


def test_message_phase_override_passes_through():
    """``run_cycles_traced(message_phase=...)`` runs the given handler
    phase every cycle: a wrapper that counts its calls gives JAX's
    events and state."""
    jsys, tsys = _systems("mini")
    calls = []

    def counted(cfg, state, mv):
        calls.append(1)
        return handlers.message_phase(cfg, state, mv)

    want_st, want = jstep.run_cycles_traced(jsys.cfg, jsys.state, 12)
    got_st, got = step.run_cycles_traced(tsys.cfg, tsys.state, 12,
                                         message_phase=counted)
    assert len(calls) == 12
    assert_sim_states_equal(want_st, got_st)
    _assert_events_equal({k: np.asarray(v) for k, v in want.items()},
                         {k: v.numpy() for k, v in got.items()})


DEEP_CASES = {
    # name: config overrides of the bench's deep config
    "waves2": dict(deep_waves=2, proc_local_permille=300),
    "storm": dict(deep_read_storm=True, deep_exact_flags=False,
                  proc_local_permille=300),
}


@pytest.mark.parametrize("case", list(DEEP_CASES))
def test_deep_round_events_match_jax(case):
    jcfg, tcfg = cfg_pair(16, **dict(BENCH_DEEP, **DEEP_CASES[case]))
    # the fused round's config: traced rounds take the fold path
    tcfg = dataclasses.replace(tcfg, fused_round=True)
    js0 = jse.procedural_state(jcfg, 4096, seed=3)
    ts0 = tse.procedural_state(tcfg, 4096, seed=3, device="cpu")
    js, jev = jse.run_rounds_traced(jcfg, js0, 8)
    ts, tev = tse.run_rounds_traced(tcfg, ts0, 8)
    assert_states_equal(js, ts, f"{case} run_rounds_traced: ")
    assert sorted(tev) == sorted(jev)
    W = tcfg.drain_depth + tcfg.txn_width
    for f in jev:
        assert tuple(tev[f].shape) == (8, 16, W), (f, tev[f].shape)
        assert np.asarray(jev[f]).dtype == tev[f].numpy().dtype, f
        np.testing.assert_array_equal(np.asarray(jev[f]), tev[f].numpy(),
                                      err_msg=f)
    st = ts0
    for r in range(8):
        st, ev = tse.round_step(tcfg, st, with_events=True)
        for f in jev:
            np.testing.assert_array_equal(np.asarray(jev[f][r]),
                                          ev[f].numpy(),
                                          err_msg=f"round {r + 1} {f}")
    assert_states_equal(js, st, f"{case} round_step: ")
    retired = int(tev["retired"].sum())
    assert retired == int(ts.metrics.instrs_retired) > 0
    assert eventlog.sync_to_records(tev) == jeventlog.sync_to_records(jev)
