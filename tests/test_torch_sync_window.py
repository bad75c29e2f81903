"""The sync window engine's kernel modules against the JAX package's
Pallas kernels.

``sync_window_kernel.plain_window`` / ``plain_replay`` against
``pallas_window._call_window`` / ``_call_replay``, and
``sync_burst_kernel.plain_burst`` against ``pallas_burst.burst``, each
Pallas kernel in interpret mode on the CPU, on mid-run inputs at the
sizes the JAX package's own tests use (64 nodes, drain_depth 1,
txn_width 2; 128 nodes for the burst). The CUDA kernels are held to the
same plain versions on the card (chip_smoke.py, tests/test_torch_cuda.py).
Also here: the wrappers' device rule, the build constants and the I/O
contract. Every comparison is exact (int32, tolerance 0).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu.ops import pallas_burst as jpb
from ue22cs343bb1_openmp_assignment_tpu.ops import pallas_window as jpw
from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_burst_kernel as sbk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as tse
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_window_kernel as swk)

from tests.torch_parity import cfg_pair

PROC = dict(procedural="uniform", max_instrs=1)
#: tests/test_pallas_window.py's _cfgs() and tests/test_pallas_burst.py's
#: _proc_cfg()
WINDOW = dict(PROC, drain_depth=1, txn_width=2, proc_local_permille=700)
BURST = dict(PROC, drain_depth=6, proc_local_permille=700)
BENCH_SYNC = dict(PROC, drain_depth=4, txn_width=3)


def _mid_run(nodes, kw, rounds, seed=1):
    """(jax cfg, port cfg, the port's state ``rounds`` rounds in), the
    rounds run by the JAX package's XLA round."""
    jcfg, tcfg = cfg_pair(nodes, **kw)
    js = jse.run_rounds(jcfg, jse.procedural_state(jcfg, 200, seed=seed),
                        rounds)
    return jcfg, tcfg, convert.from_numpy(
        tcfg, convert.numpy_leaves(js), device="cpu")


def _jnp(ts):
    return [jnp.asarray(t.numpy()) for t in ts]


def test_plain_window_and_replay_match_pallas_interpret():
    """At the JAX tests' tiny window (K=2, W=3): the Pallas interpreter
    did not finish the bench's K=3, W=7 kernel in 50 minutes."""
    jcfg, tcfg, st = _mid_run(64, WINDOW, 40)
    call_window = jax.jit(functools.partial(jpw._call_window, jcfg))
    call_replay = jax.jit(functools.partial(jpw._call_replay, jcfg))
    seen = dict(txn=0, released=0, truncated=0, retired=0)
    for r in range(3):
        args = swk.round_inputs(tcfg, st)
        got = swk.plain_window(*args)
        want = call_window(*_jnp(args[1:]))
        for name, a, b in zip(("slots", "steps", "cv_pre"), want, got):
            assert b.dtype == torch.int32 and b.shape == a.shape
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"round {r} {name}")
        slot, hc_w, dep_w, he_w = swk.unpack_window(tcfg, got[0], got[1])
        mid = tse.multi_middle(tcfg, st, tse._index_ops(), slot, hc_w,
                               dep_w, he_w, got[2], 0)
        rargs = args + (mid["first_lose"][None, :].contiguous(),
                        mid["fill_state"].contiguous(),
                        mid["fill_val"].contiguous())
        gotr = swk.plain_replay(*rargs)
        wantr = call_replay(*_jnp(rargs[1:]))
        for name, a, b in zip(("cache", "counts"), wantr, gotr):
            assert b.dtype == torch.int32 and b.shape == a.shape
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"round {r} {name}")
        seen["txn"] += int((slot["ok"] != 0).sum())
        seen["released"] += int((slot["rel_ordn"][slot["ok"] != 0]
                                 < tcfg.txn_width).sum())
        seen["truncated"] += int((mid["first_lose"] < len(he_w)).sum())
        seen["retired"] += int(gotr[1][0].sum())
        st = tse.round_step(tcfg, st)
    # the inputs exercised multi-transaction windows, releases and
    # truncation
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("rounds", [0, 40], ids=["cold", "mid-run"])
def test_plain_burst_matches_pallas_interpret(rounds):
    jcfg, tcfg, st = _mid_run(128, BURST, rounds)
    args = (st.cache_addr, st.cache_val, st.cache_state, st.idx,
            st.instr_count)
    want = jpb.burst(jcfg, *_jnp(args))
    got = sbk.plain_burst(tcfg, *args)
    names = ("d", "rh", "wh", "oa", "val", "live", "cv", "cs")
    for name, a, b in zip(names, want, got):
        assert np.asarray(a).dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
    if rounds:
        assert int(got[0].sum()) > 0 and int(got[2].sum()) > 0
    else:               # a cold cache bursts nothing and stops at slot 0
        assert int(got[0].sum()) == 0 and bool(got[5].all())


def test_wrappers_take_the_plain_versions_only_on_cpu():
    _, tcfg = cfg_pair(16, **BENCH_SYNC)
    st = tse.run_rounds(tcfg, tse.procedural_state(tcfg, 64, device="cpu"),
                        3)
    args = swk.round_inputs(tcfg, st)
    got = swk.window(*args)
    for a, b in zip(got, swk.plain_window(*args)):
        assert torch.equal(a, b)
    K = tcfg.txn_width
    fl = torch.full((1, 16), 2, dtype=torch.int32)
    fills = torch.ones((K, 16), dtype=torch.int32)
    for a, b in zip(swk.replay(*args, fl, fills, fills),
                    swk.plain_replay(*args, fl, fills, fills)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not CUDA"):
        swk._launch("window", *args)
    assert (swk.window.launches, swk.replay.launches) == (0, 0)

    _, single = cfg_pair(16, **dict(PROC, drain_depth=4))
    bargs = (single, st.cache_addr, st.cache_val, st.cache_state, st.idx,
             st.instr_count)
    for a, b in zip(sbk.burst(*bargs), sbk.plain_burst(*bargs)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not CUDA"):
        sbk.launch(single, *args[1:])
    assert sbk.burst.launches == 0
    with pytest.raises(ValueError, match="fold_impl"):
        swk.round_step_multi_kernel(tcfg, st, "xla")


def test_supported_and_defines():
    _, tcfg = cfg_pair(4096, **dict(BENCH_SYNC, proc_seed=3))
    assert sbk.supported(tcfg)
    assert dict(swk.defines(tcfg)) == dict(
        SW_C=4, SW_BLOCK_BITS=4, SW_M=16,
        SW_SEED_TERM=f"{3 * 2654435761 % 2**32}u", SW_LOCAL_PERMILLE=800,
        SW_WRITE_PERMILLE=500, SW_K=3, SW_W=7)
    _, single = cfg_pair(1100, **dict(PROC, drain_depth=16))
    assert sbk.supported(single)            # any N: no tiling
    assert dict(sbk.defines(single))["SB_H"] == 16
    assert "SW_K" not in dict(sbk.defines(single))
    with pytest.raises(ValueError, match="txn_width"):
        swk.defines(single)
    for kw in (dict(drain_depth=4, txn_width=3),             # stored traces
               dict(BENCH_SYNC, deep_window=True)):
        _, bad = cfg_pair(64, **kw)
        assert not sbk.supported(bad)
        with pytest.raises(ValueError, match="procedural"):
            swk.defines(bad)
        with pytest.raises(ValueError, match="procedural"):
            sbk.defines(bad)
    st = tse.procedural_state(bad, 8, device="cpu")
    with pytest.raises(ValueError, match="procedural"):
        swk.round_step_multi_kernel(bad, st)


def test_io_contract_rows():
    """Operand rows at the bench's sync configs (C=4): window 78,
    replay 36 at K=3/W=7; burst 28 at H=16; N int32 each."""
    _, tcfg = cfg_pair(4096, **BENCH_SYNC)
    assert swk.io_rows(tcfg, "window") == (14, [39, 21, 4])
    assert swk.io_rows(tcfg, "replay") == (21, [12, 3])
    assert sum(swk.io_contract_bytes(tcfg, "window")) == 78 * 4096 * 4
    assert sum(swk.io_contract_bytes(tcfg, "replay")) == 36 * 4096 * 4
    _, single = cfg_pair(4096, **dict(PROC, drain_depth=16))
    assert sbk.io_contract_bytes(single) == (14 * 4096 * 4, 14 * 4096 * 4)
    assert len(tse.SLOT_FIELDS) + 1 == swk.N_SLOT == len(
        jpw._SLOT_FIELDS) + 1
    assert tse.SLOT_FIELDS == jpw._SLOT_FIELDS
    assert swk.STEP_FIELDS == jpw._STEP_FIELDS
