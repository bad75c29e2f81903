"""The CUDA kernels (the fold and the fused round) against their plain
versions, on the card.

Marked ``cuda``: each test skips without a card (decided inside the
fixture, never at import). The card machine has no JAX, so run this file
there without the suite's conftest (which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Exact comparisons: everything is int32.
"""

import dataclasses

import pytest
import torch

from chip_smoke import fold_inputs
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    deep_fold_kernel as dfk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    deep_round_kernel as drk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _cfg(num_nodes, **kw):
    cfg = SystemConfig.scale(num_nodes=num_nodes, drain_depth=13,
                             txn_width=3)
    base = dict(deep_window=True, deep_slots=3, deep_ownerval_slots=1,
                deep_horizon_slack=4, procedural="uniform", max_instrs=1,
                proc_local_permille=800)
    return dataclasses.replace(cfg, **dict(base, **kw))


def _equal(a: dict, b: dict, where: str):
    for k, v in a.items():
        if isinstance(v, dict):
            _equal(v, b[k], f"{where}{k}.")
        else:
            assert torch.equal(v, b[k]), f"{where}{k}"


@pytest.mark.parametrize("kw", [
    {}, dict(proc_local_permille=300, deep_waves=3, deep_read_storm=True),
    dict(deep_slots=2)], ids=["bench", "waves3-storm", "q2"])
def test_kernel_equals_plain_mid_run(card, kw):
    cfg = _cfg(1000, **kw)      # not a multiple of the block size
    st = se.run_rounds(cfg, se.procedural_state(cfg, 4096, device=card), 6,
                       fold_impl="plain")
    args = fold_inputs(cfg, st)
    for mode, wrapper in dfk.WRAPPERS.items():
        before = wrapper.launches
        _equal(dfk.PLAIN[mode](*args[mode]), wrapper(*args[mode]),
               f"{mode}.")
        assert wrapper.launches == before + 1


def test_rounds_kernel_equal_plain_and_cpu(card):
    cfg = _cfg(128, proc_local_permille=500)
    k = se.procedural_state(cfg, 4096, seed=3, device=card)
    p = se.procedural_state(cfg, 4096, seed=3, device=card)
    c = se.procedural_state(cfg, 4096, seed=3, device="cpu")
    for _ in range(5):
        k = se.round_step(cfg, k, "kernel")
        p = se.round_step(cfg, p, "plain")
        c = se.round_step(cfg, c)
    want = convert.to_numpy(c)
    for st in (k, p):
        got = convert.to_numpy(st)
        for f in want:
            assert (want[f] == got[f]).all(), f


def test_wrapper_refuses_bad_operands(card):
    cfg = _cfg(256)
    st = se.procedural_state(cfg, 64, device=card)
    args = fold_inputs(cfg, st)["replay"]
    bad = args[6].T.contiguous().T          # right shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        dfk.fold_replay(*args[:6], bad, args[7])
    with pytest.raises(ValueError, match="int32"):
        dfk.fold_replay(*args[:6], args[6].to(torch.int64), args[7])


@pytest.mark.parametrize("kw", [
    {}, dict(proc_local_permille=300, deep_waves=3),
    dict(proc_local_permille=500, deep_exact_flags=False)],
    ids=["waves1", "waves3", "noexact"])
def test_round_kernel_equals_plain_round(card, kw):
    cfg = _cfg(1000, fused_round=True, **kw)   # 8 blocks, not a multiple
    st = se.run_rounds(cfg, se.procedural_state(cfg, 4096, device=card), 6,
                       fold_impl="plain")
    args = drk.round_inputs(cfg, st)
    before = drk.fused_round.launches
    got = drk.fused_round(*args)
    assert drk.fused_round.launches == before + 1
    for a, b in zip(got, drk.plain_round(*args)):
        assert torch.equal(a, b)


def test_round_kernel_rounds_equal_fold_path_and_cpu(card):
    cfg = _cfg(128, proc_local_permille=500, deep_waves=2)
    fused = dataclasses.replace(cfg, fused_round=True)
    f = se.procedural_state(cfg, 4096, seed=3, device=card)
    k, c = f, se.procedural_state(cfg, 4096, seed=3, device="cpu")
    for _ in range(5):
        f = se.round_step(fused, f)
        k = se.round_step(cfg, k)
        c = se.round_step(fused, c)
    want = convert.to_numpy(c)
    for st in (f, k):
        got = convert.to_numpy(st)
        for name in want:
            assert (want[name] == got[name]).all(), name


def test_round_wrapper_refuses_bad_operands(card):
    cfg = _cfg(256, fused_round=True)
    args = drk.round_inputs(cfg, se.procedural_state(cfg, 64, device=card))
    bad = list(args)
    bad[7] = args[7].to(torch.int64)                 # w_val
    with pytest.raises(ValueError, match="int32"):
        drk.fused_round(*bad)
    bad = list(args)
    bad[4] = args[4].T.contiguous().T                # cache_val
    with pytest.raises(ValueError, match="contiguous"):
        drk.fused_round(*bad)
    bad = list(args)
    bad[2] = args[2][:-7]                            # dm
    with pytest.raises(ValueError, match="dm"):
        drk.fused_round(*bad)
