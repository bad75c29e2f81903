"""The port's fused round (ops/deep_round_kernel) against the JAX package.

On the CPU ``round_step`` under ``fused_round`` takes
``deep_round_kernel.round_step_deep_fused``, whose wrapper runs
``plain_round`` for CPU tensors (the CUDA kernel is held to it on the
card by chip_smoke.py and tests/test_torch_cuda.py). Here the port's
rounds are held against JAX ``deep_engine.round_step_deep``, which the
JAX package's own tests pin equal to its fused Pallas kernel, from
mid-run states carried across with ``convert.from_numpy``; the slow
tier also holds ``plain_round`` against the Pallas kernel itself in
interpret mode. Every comparison is exact (int32, tolerance 0).
"""

import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu.ops import deep_engine as jde
from ue22cs343bb1_openmp_assignment_tpu.ops import pallas_round as jpr
from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu.state import init_state
from ue22cs343bb1_openmp_assignment_tpu.utils import trace as jtrace
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    deep_fold_kernel as dfk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    deep_round_kernel as drk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as tse

from tests.torch_parity import BENCH_DEEP, assert_states_equal, cfg_pair

MINI = pathlib.Path(__file__).resolve().parent / "fixtures" / "mini"
STORED = dict(deep_window=True, drain_depth=13, txn_width=3, deep_slots=3,
              deep_ownerval_slots=1, deep_horizon_slack=4)
#: tests/test_pallas_round.py's _cfg(): 8 nodes, W=4, 4 slots, 2 g-slots
TINY = dict(procedural="uniform", max_instrs=1, deep_window=True,
            drain_depth=2, txn_width=2, deep_slots=4,
            deep_ownerval_slots=2)

CASES = {
    # name: (workload, nodes, config overrides, warm-up rounds, rounds)
    "bench64": ("procedural", 64, BENCH_DEEP, 4, 3),
    "waves3": ("procedural", 64, dict(BENCH_DEEP, deep_waves=3,
                                      proc_local_permille=300), 4, 3),
    "noexact": ("procedural", 64, dict(BENCH_DEEP, deep_exact_flags=False,
                                       proc_local_permille=500), 4, 3),
    "mini": ("mini", 4, STORED, 2, 4),
    # the protocol variants of tests/test_pallas_round.py: cold start
    "moesi": ("procedural", 8, dict(TINY, proc_local_permille=500,
                                    protocol="moesi"), 4, 2),
    "mesif": ("procedural", 8, dict(TINY, proc_local_permille=500,
                                    protocol="mesif"), 4, 2),
}


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    return jax.jit(functools.partial(jde.round_step_deep, jcfg))


def _jax_start(workload, nodes, kw):
    if workload == "procedural":
        jcfg, tcfg = cfg_pair(nodes, **kw)
        return jcfg, tcfg, jse.procedural_state(jcfg, 4096, seed=1)
    jcfg, tcfg = cfg_pair(4, reference=True, **kw)
    traces = jtrace.load_test_dir(str(MINI), 4, jcfg.max_instrs)
    return jcfg, tcfg, jse.from_sim_state(jcfg, init_state(jcfg, traces),
                                          seed=1)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_round_matches_jax(case, monkeypatch):
    workload, nodes, kw, warm, rounds = CASES[case]
    jcfg, tcfg, js = _jax_start(workload, nodes, kw)
    step = _jax_step(jcfg)
    for _ in range(warm):
        js = step(js)
    fcfg = dataclasses.replace(tcfg, fused_round=True)
    ts = convert.from_numpy(fcfg, convert.numpy_leaves(js), device="cpu")
    calls = []
    plain_round = drk.plain_round
    monkeypatch.setattr(drk, "plain_round",
                        lambda *a: calls.append(1) or plain_round(*a))
    for r in range(rounds):
        js = step(js)
        ts = tse.round_step(fcfg, ts)
        assert_states_equal(js, ts, f"{case}, round {warm + r + 1}: ")
    assert len(calls) == rounds          # the round kernel's path ran
    assert drk.fused_round.launches == 0
    tse.check_exact_directory(fcfg, ts)
    assert int(ts.metrics.instrs_retired) > 0


def test_supported_admits_what_jax_admits():
    """Every config JAX's fused round takes (tests/test_pallas_round.py
    test_supported_gate), the port's takes too; storm and non-deep
    configs are refused by both. JAX also refuses 2^14 or more
    contenders per entry, which its f32 scatter-min ladder cannot
    resolve; the port's atomicMin has no such cap, so those configs
    differ on purpose."""
    def both(cfg_kw, n=8, **scale):
        jcfg, tcfg = cfg_pair(n, **dict(scale, **cfg_kw))
        return jpr.supported(jcfg), drk.supported(tcfg)

    tiny = dict(TINY, proc_local_permille=200)
    assert both(tiny, drain_depth=2, txn_width=2) == (True, True)
    assert both(dict(tiny, deep_read_storm=True)) == (False, False)
    assert both(dict(tiny, deep_window=False)) == (False, False)
    big = dict(deep_window=True, deep_slots=3, drain_depth=2, txn_width=2)
    assert both(big, 8192) == (True, True)
    assert both(dict(big, deep_waves=2), 8192) == (False, True)
    assert both(dict(big, deep_slots=2), 16384) == (False, True)
    assert both(BENCH_DEEP, 4096) == (True, True)
    # the kernel keeps boolean tables in 32-bit masks
    assert not drk.supported(cfg_pair(8, **dict(tiny, deep_slots=33))[1])


def test_io_contract_bytes_match_jax():
    for n, kw in ((4096, BENCH_DEEP), (256, dict(BENCH_DEEP, deep_slots=2)),
                  (8, TINY)):
        jcfg, tcfg = cfg_pair(n, **kw)
        assert drk.io_contract_bytes(tcfg) == jpr.io_contract_bytes(jcfg)
    _, tcfg = cfg_pair(4096, **BENCH_DEEP)
    assert sum(drk.io_contract_bytes(tcfg)) == 5_079_040


def test_round_kernel_defines():
    _, tcfg = cfg_pair(4096, **BENCH_DEEP)
    assert dict(drk.defines(tcfg)) == dict(
        dfk.defines(tcfg), DR_WAVES=1, DR_EXACT=1)
    _, w3 = cfg_pair(256, **dict(BENCH_DEEP, deep_waves=3,
                                 deep_exact_flags=False))
    assert dict(drk.defines(w3))["DR_WAVES"] == 3
    assert dict(drk.defines(w3))["DF_WAVES1"] == 0
    assert dict(drk.defines(w3))["DR_EXACT"] == 0
    _, storm = cfg_pair(64, **dict(BENCH_DEEP, deep_read_storm=True))
    with pytest.raises(ValueError, match="read storm"):
        drk.defines(storm)


def test_wrapper_takes_plain_round_only_on_cpu():
    _, tcfg = cfg_pair(16, **BENCH_DEEP)
    st = tse.run_rounds(tcfg, tse.procedural_state(tcfg, 4096, device="cpu"),
                        2)
    args = drk.round_inputs(tcfg, st)
    got = drk.fused_round(*args)
    want = drk.plain_round(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not CUDA"):
        drk.launch(*args)
    assert drk.fused_round.launches == 0
    with pytest.raises(ValueError, match="impl"):
        drk.round_step_deep_fused(tcfg, st, impl="xla")


def test_round_step_dispatch(monkeypatch):
    """fused_round on a supported config takes the fused round (the
    plain round with fold_impl="plain"); a storm config takes the fold
    path, as in JAX."""
    seen = []
    monkeypatch.setattr(drk, "round_step_deep_fused",
                        lambda cfg, st, impl: seen.append(impl) or st)
    _, tcfg = cfg_pair(16, **dict(BENCH_DEEP, fused_round=True))
    st = tse.procedural_state(tcfg, 64, device="cpu")
    assert tse.round_step(tcfg, st) is st
    assert tse.round_step(tcfg, st, "plain") is st
    assert seen == ["kernel", "plain"]
    storm = dataclasses.replace(tcfg, deep_read_storm=True)
    assert int(tse.round_step(storm, st).round) == 1
    assert seen == ["kernel", "plain"]


@pytest.mark.slow
def test_plain_round_matches_pallas_interpret():
    """plain_round's four outputs against the fused Pallas kernel itself
    (ops/pallas_round in interpret mode on the CPU) at the tiny config
    of tests/test_pallas_round.py, mid-run."""
    jcfg, tcfg = cfg_pair(8, **dict(TINY, proc_local_permille=200))
    st = tse.run_rounds(tcfg, tse.procedural_state(tcfg, 200, seed=1,
                                                   device="cpu"), 30)
    args = drk.round_inputs(tcfg, st)
    want = jpr._call_round(jcfg, *[jnp.asarray(t.numpy())
                                   for t in args[1:]])
    got = drk.plain_round(*args)
    for name, a, b in zip(("dm", "cache", "n_ret", "delta"), want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
