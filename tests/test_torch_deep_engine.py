"""The port's deep-window round equals the JAX package's, round by round.

Both engines start from the same built state (procedural, or the stored
``mini`` fixture) and step one round at a time — JAX through
``sync_engine.run_rounds(cfg, st, 1)`` (one jit per config), the port
through ``round_step`` on the CPU, where the fold wrappers take the
plain PyTorch fold. After every round every state leaf and metric must
be equal. The configs cover one and three absorption waves, the read
storm on and off, exact flags on and off, and procedural and stored
traces; the fast tier holds two configs that between them take each
value once, the rest run in the slow tier.
"""

import pathlib

import pytest

from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu.state import init_state
from ue22cs343bb1_openmp_assignment_tpu.utils import trace as jtrace
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as tse

from tests.torch_parity import BENCH_DEEP, assert_states_equal, cfg_pair

MINI = pathlib.Path(__file__).resolve().parent / "fixtures" / "mini"
STORED = dict(deep_window=True, drain_depth=13, txn_width=3, deep_slots=3,
              deep_ownerval_slots=1, deep_horizon_slack=4)

CASES = {
    # name: (workload, config overrides, rounds)
    "procedural-w1": ("procedural", dict(proc_local_permille=500), 10),
    "mini-w3-storm-noexact": ("mini", dict(deep_waves=3,
                                           deep_read_storm=True,
                                           deep_exact_flags=False), 8),
    "procedural-w3": ("procedural", dict(deep_waves=3,
                                         proc_local_permille=300), 8),
    "procedural-storm-noexact": ("procedural", dict(
        deep_read_storm=True, deep_exact_flags=False,
        proc_local_permille=300), 8),
    "mini-w1": ("mini", {}, 8),
}
FAST = ("procedural-w1", "mini-w3-storm-noexact")


def _start(workload, kw):
    if workload == "procedural":
        jcfg, tcfg = cfg_pair(16, **dict(BENCH_DEEP, **kw))
        return (jcfg, tcfg, jse.procedural_state(jcfg, 4096, seed=1),
                tse.procedural_state(tcfg, 4096, seed=1, device="cpu"))
    jcfg, tcfg = cfg_pair(4, reference=True, **dict(STORED, **kw))
    traces = jtrace.load_test_dir(str(MINI), 4, jcfg.max_instrs)
    return (jcfg, tcfg, jse.from_sim_state(jcfg, init_state(jcfg, traces),
                                           seed=1),
            tse.from_traces(tcfg, traces, seed=1, device="cpu"))


@pytest.mark.parametrize("case", [
    c if c in FAST else pytest.param(c, marks=pytest.mark.slow)
    for c in CASES])
def test_rounds_match_jax(case):
    workload, kw, rounds = CASES[case]
    jcfg, tcfg, js, ts = _start(workload, kw)
    assert_states_equal(js, ts, "built state: ")
    for r in range(rounds):
        js = jse.run_rounds(jcfg, js, 1)
        ts = tse.round_step(tcfg, ts)
        assert_states_equal(js, ts, f"after round {r + 1}: ")
    tse.check_exact_directory(tcfg, ts)
    assert int(ts.metrics.instrs_retired) > 0
