"""The fused txn_width 1 round's plain version equals the JAX round.

``sync_round_kernel.plain_round`` (through ``round_step_fused(impl=
"plain")``) and ``sync_engine.round_step`` on the fused route
(``cfg.pallas_burst`` at txn_width 1; on the CPU the wrapper runs
``plain_round``) against the JAX package's ``round_step`` with its XLA
round (``pallas_burst`` off there: no Pallas interpreter), round by
round, from states carried across with ``convert.from_numpy``. Every
comparison is exact: int32, tolerance 0, every state leaf and every
metric. The CUDA kernel is held to ``plain_round`` on the card
(tests/test_torch_cuda.py, chip_smoke.py).
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
    sync_round_kernel as srk)

from tests.torch_parity import assert_states_equal, cfg_pair

PROC = dict(procedural="uniform", max_instrs=1, txn_width=1)

CASES = {
    # name: (nodes, config overrides, warm-up rounds, rounds)
    "n1-c2-m8-h1": (1, dict(cache_size=2, mem_size=8, drain_depth=1), 2, 4),
    "n12-c4-m16-h4": (12, dict(drain_depth=4, proc_local_permille=500),
                      3, 5),
    "n12-c8-m8-h16": (12, dict(cache_size=8, mem_size=8, drain_depth=16,
                               proc_local_permille=300), 3, 4),
    "n33-c2-m32-h4": (33, dict(cache_size=2, mem_size=32, drain_depth=4,
                               proc_local_permille=300), 3, 5),
    "n33-c8-m16-h1": (33, dict(cache_size=8, drain_depth=1,
                               proc_local_permille=700), 3, 4),
    "n256-bench": (256, dict(drain_depth=16, proc_local_permille=800), 8, 4),
    "n256-contended": (256, dict(drain_depth=4, proc_local_permille=300),
                       6, 4),
    # long enough that claim keys of older rounds stay in the claim column
    # beside this round's
    "n256-long": (256, dict(mem_size=8, drain_depth=1,
                            proc_local_permille=300), 0, 28),
}


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    return jax.jit(functools.partial(jse.round_step, jcfg))


@pytest.mark.parametrize("case", list(CASES))
def test_fused_round_plain_version_matches_jax(case, monkeypatch):
    nodes, kw, warm, rounds = CASES[case]
    jcfg, tcfg = cfg_pair(nodes, **dict(PROC, **kw))
    fcfg = dataclasses.replace(tcfg, pallas_burst=True)
    assert srk.supported(fcfg) and not jcfg.pallas_burst
    calls = []
    plain_round = srk.plain_round
    monkeypatch.setattr(srk, "plain_round",
                        lambda *a: calls.append(1) or plain_round(*a))
    step = _jax_step(jcfg)
    js = jse.procedural_state(jcfg, 200, seed=3)
    for _ in range(warm):
        js = step(js)
    leaves = convert.numpy_leaves(js)
    routed = convert.from_numpy(fcfg, leaves, device="cpu")
    plain = convert.from_numpy(fcfg, leaves, device="cpu")
    launches = srk.fused_round.launches
    for r in range(rounds):
        where = f"{case}, round {warm + r + 1}"
        js = step(js)
        routed = tse.round_step(fcfg, routed)
        plain = srk.round_step_fused(fcfg, plain, "plain")
        assert_states_equal(js, routed, f"{where} (round_step): ")
        assert_states_equal(js, plain, f"{where} (plain_round): ")
    assert len(calls) == 2 * rounds and srk.fused_round.launches == launches
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


def test_fused_round_dispatch_and_contract():
    """Which configs the fused round takes, its compile-time constants,
    its bytes, and that it is the route of round_step at txn_width 1
    under pallas_burst (plain_round on CPU tensors, no launch)."""
    _, tcfg = cfg_pair(4096, **dict(PROC, drain_depth=16,
                                    pallas_burst=True))
    assert srk.supported(tcfg) and sbk.supported(tcfg)
    defs = dict(srk.defines(tcfg))
    assert (defs["SB_H"], defs["SW_C"], defs["SR_PB"]) == (16, 4, 12)
    assert defs["SR_CMR"] == tse.claim_max_rounds(tcfg) == (1 << 18) - 1
    # dm [65536, 7] in and out, three [4096, 4] cache planes in and out,
    # idx and instr_count in, idx out, round/seed/round + 1, 11 + 11
    # counters
    E = 4096 << 4
    assert srk.io_contract_bytes(tcfg) == (
        4 * (E * 7 + 12 * 4096 + 2 * 4096 + 2 + 11),
        4 * (E * 7 + 12 * 4096 + 4096 + 1 + 11))
    for bad in (dataclasses.replace(tcfg, txn_width=2),
                dataclasses.replace(tcfg, cache_size=64),
                dataclasses.replace(tcfg, procedural=None),
                dataclasses.replace(tcfg, deep_window=True)):
        assert not srk.supported(bad)
        with pytest.raises(ValueError, match="txn_width 1"):
            srk.defines(bad)
    small = dataclasses.replace(tcfg, num_nodes=16)
    st = tse.procedural_state(small, 16, device="cpu")
    before = srk.fused_round.launches
    a = tse.round_step(small, st)
    b = tse._round_step_single(dataclasses.replace(small,
                                                   pallas_burst=False), st)
    for name, want in convert.to_numpy(b).items():
        assert np.array_equal(want, convert.to_numpy(a)[name]), name
    assert srk.fused_round.launches == before
    # the counters are views of one [11] buffer, passed to the next round
    # as it is
    buf = a.metrics.buffer()
    assert buf.shape == (11,) and a.metrics.rounds.data_ptr() == buf.data_ptr()
    with pytest.raises(ValueError, match="impl"):
        srk.round_step_fused(small, st, "xla")
    with pytest.raises(ValueError, match="not CUDA"):
        srk.launch(small, *srk.round_inputs(small, st)[1:])
