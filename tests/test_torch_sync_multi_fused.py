"""The fused txn_width >= 2 round's plain version equals the JAX round.

``sync_multi_round_kernel.plain_round`` (through ``round_step_fused(
impl="plain")``) and ``sync_engine.round_step`` on the fused route
(``cfg.pallas_burst`` at txn_width >= 2; on the CPU the wrapper runs
``plain_round``) against the JAX package's ``round_step`` with its XLA
round (``pallas_burst`` off there: no Pallas interpreter), round by
round, from states carried across with ``convert.from_numpy``. Every
comparison is exact: int32, tolerance 0, every state leaf and every
metric. The CUDA kernel is held to ``plain_round`` on the card
(tests/test_torch_cuda.py, chip_smoke.py) and, built with g++ against a
CPU stub of the runtime, here (tests/test_torch_cuda_stub.py).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_burst_kernel as sbk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as tse
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_multi_round_kernel as smk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_window_kernel as swk)

from tests.torch_parity import assert_states_equal, cfg_pair

PROC = dict(procedural="uniform", max_instrs=1)

CASES = {
    # name: (nodes, config overrides, warm-up rounds, rounds)
    "n1-k2-c2-h1": (1, dict(txn_width=2, cache_size=2, mem_size=8,
                            drain_depth=1), 2, 4),
    "n12-k3-c4-h4": (12, dict(txn_width=3, drain_depth=4,
                              proc_local_permille=500), 3, 5),
    "n12-k4-c8-h1": (12, dict(txn_width=4, cache_size=8, mem_size=8,
                              drain_depth=1, proc_local_permille=300), 3, 4),
    "n33-k2-c2-h4": (33, dict(txn_width=2, cache_size=2, mem_size=32,
                              drain_depth=4, proc_local_permille=300), 3, 5),
    "n33-k4-c4-h4": (33, dict(txn_width=4, drain_depth=4,
                              proc_local_permille=800), 3, 4),
    "n256-bench": (256, dict(txn_width=3, drain_depth=4,
                             proc_local_permille=800), 8, 4),
    "n256-contended": (256, dict(txn_width=3, drain_depth=4,
                                 proc_local_permille=300), 6, 4),
    # long enough that claim keys of older rounds stay in the claim column
    # beside this round's
    "n256-long": (256, dict(txn_width=2, mem_size=8, drain_depth=1,
                            proc_local_permille=300), 0, 24),
}


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    return jax.jit(functools.partial(jse.round_step, jcfg))


@pytest.mark.parametrize("case", list(CASES))
def test_fused_multi_round_plain_version_matches_jax(case, monkeypatch):
    nodes, kw, warm, rounds = CASES[case]
    jcfg, tcfg = cfg_pair(nodes, **dict(PROC, **kw))
    fcfg = dataclasses.replace(tcfg, pallas_burst=True)
    assert smk.supported(fcfg) and not jcfg.pallas_burst
    calls = []
    plain_round = smk.plain_round
    monkeypatch.setattr(smk, "plain_round",
                        lambda *a: calls.append(1) or plain_round(*a))
    step = _jax_step(jcfg)
    js = jse.procedural_state(jcfg, 200, seed=3)
    for _ in range(warm):
        js = step(js)
    leaves = convert.numpy_leaves(js)
    routed = convert.from_numpy(fcfg, leaves, device="cpu")
    plain = convert.from_numpy(fcfg, leaves, device="cpu")
    launches = smk.fused_round.launches
    for r in range(rounds):
        where = f"{case}, round {warm + r + 1}"
        js = step(js)
        routed = tse.round_step(fcfg, routed)
        plain = smk.round_step_fused(fcfg, plain, "plain")
        assert_states_equal(js, routed, f"{where} (round_step): ")
        assert_states_equal(js, plain, f"{where} (plain_round): ")
    assert len(calls) == 2 * rounds and smk.fused_round.launches == launches
    tse.check_exact_directory(tcfg, plain)
    m = plain.metrics
    assert int(m.instrs_retired) > 0
    if nodes > 1:
        assert int(m.conflicts) > 0 and int(m.evictions) > 0
    if case == "n256-long":
        claim = plain.dm[:, tse.DM_CLAIM].numpy()
        prio_bits = max(1, (nodes - 1).bit_length())
        countdowns = np.unique(claim[claim != tse.INT32_MAX] >> prio_bits)
        assert len(countdowns) > 1, countdowns


def test_fused_multi_round_dispatch_and_contract(monkeypatch):
    """Which configs the fused multi round takes, its compile-time
    constants, its bytes, and that it is the route of round_step at
    txn_width >= 2 under pallas_burst (plain_round on CPU tensors, no
    launch); where it does not take the config, the window kernels'
    route is."""
    _, tcfg = cfg_pair(4096, **dict(PROC, txn_width=3, drain_depth=4,
                                    pallas_burst=True))
    assert smk.supported(tcfg) and sbk.supported(tcfg)
    defs = dict(smk.defines(tcfg))
    assert (defs["SW_C"], defs["SW_K"], defs["SW_W"], defs["SR_PB"]) == (
        4, 3, 7, 12)
    assert defs["SR_CMR"] == tse.claim_max_rounds(tcfg) == (1 << 18) - 1
    assert "SB_H" not in defs
    # dm [65536, 7] in and out, three [4096, 4] cache planes in and out,
    # idx and instr_count in, idx out, round/seed/round + 1, 11 + 11
    # counters
    E = 4096 << 4
    assert smk.io_contract_bytes(tcfg) == (
        4 * (E * 7 + 12 * 4096 + 2 * 4096 + 2 + 11),
        4 * (E * 7 + 12 * 4096 + 4096 + 1 + 11))
    for bad in (dataclasses.replace(tcfg, txn_width=1),
                dataclasses.replace(tcfg, cache_size=64),
                dataclasses.replace(tcfg, procedural=None),
                dataclasses.replace(tcfg, deep_window=True),
                dataclasses.replace(tcfg, txn_width=33),
                dataclasses.replace(tcfg, drain_depth=125)):
        assert not smk.supported(bad)
        with pytest.raises(ValueError, match="txn_width >= 2"):
            smk.defines(bad)
    assert smk.supported(dataclasses.replace(tcfg, txn_width=32))
    small = dataclasses.replace(tcfg, num_nodes=16)
    st = tse.procedural_state(small, 16, device="cpu")
    before = smk.fused_round.launches
    seen = []
    fused = smk.round_step_fused
    monkeypatch.setattr(smk, "round_step_fused",
                        lambda cfg, s, impl: seen.append(impl)
                        or fused(cfg, s, impl))
    a = tse.round_step(small, st)
    b = tse._round_step_multi(dataclasses.replace(small,
                                                  pallas_burst=False), st)
    for name, want in convert.to_numpy(b).items():
        assert np.array_equal(want, convert.to_numpy(a)[name]), name
    assert seen == ["kernel"] and smk.fused_round.launches == before
    # the window kernels' route where the fused round does not take the
    # config (more than 32 lines a node)
    wide = dataclasses.replace(small, cache_size=64)
    assert sbk.supported(wide) and not smk.supported(wide)
    windows = []
    plain_window = swk.plain_window
    monkeypatch.setattr(swk, "plain_window",
                        lambda *x: windows.append(1) or plain_window(*x))
    wst = tse.procedural_state(wide, 16, device="cpu")
    assert int(tse.round_step(wide, wst).round) == 1
    assert windows == [1] and seen == ["kernel"]
    with pytest.raises(ValueError, match="impl"):
        smk.round_step_fused(small, st, "xla")
    with pytest.raises(ValueError, match="not CUDA"):
        smk.launch(small, *smk.round_inputs(small, st)[1:])
