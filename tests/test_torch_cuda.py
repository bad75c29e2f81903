"""The CUDA kernels (the deep fold, the fused round, the sync window
engine's window, replay and burst kernels, its fused txn_width 1 and
txn_width >= 2 rounds with their replica axis, and the routed
transport's ring exchange) against their plain versions, on the card.

Marked ``cuda``: each test skips without a card (decided inside the
fixture, never at import). The card machine has no JAX, so run this file
there without the suite's conftest (which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Exact comparisons: everything is int32.
"""

import dataclasses

import pytest
import torch

from chip_smoke import replay_inputs, fold_inputs
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    deep_fold_kernel as dfk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    deep_round_kernel as drk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_burst_kernel as sbk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_multi_round_kernel as smk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_round_kernel as srk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_window_kernel as swk)
from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
    CoherenceSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import (
    mesh, ring_kernel, sharded_step)

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


#: table shapes that change the fold's layout: lines, own entries (S = 8
#: and 32, the latter over 48 KB of shared memory a block), slots,
#: owner-value slots
SHAPES = [dict(cache_size=2), dict(cache_size=8), dict(mem_size=8),
          dict(mem_size=32), dict(deep_slots=1, proc_local_permille=500),
          dict(deep_ownerval_slots=2, proc_local_permille=500)]
SHAPE_IDS = ["c2", "c8", "s8", "s32", "q1", "g2"]


@pytest.mark.parametrize("kw", [
    {}, dict(proc_local_permille=300, deep_waves=3, deep_read_storm=True),
    dict(deep_slots=2)] + SHAPES, ids=["bench", "waves3-storm", "q2"]
    + SHAPE_IDS)
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
    dict(proc_local_permille=500, deep_exact_flags=False)] + SHAPES
    + [dict(num_nodes=65536, deep_slots=2)],
    ids=["waves1", "waves3", "noexact"] + SHAPE_IDS + ["n65536"])
def test_round_kernel_equals_plain_round(card, kw):
    kw = dict(kw)
    n = kw.pop("num_nodes", 1000)       # 1000: not a multiple of a block
    cfg = _cfg(n, fused_round=True, **kw)
    if n > 1000:
        # more nodes than resident threads: the grid is capped, and the
        # kernel's node loops go round more than once
        lib = drk.LIBRARY.load(cfg)
        assert lib.deep_round_grid(n) == lib.deep_round_grid(2 * n)
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


# -- the sync window engine ---------------------------------------------------

def _sync_cfg(num_nodes, txn_width, drain_depth, **kw):
    cfg = SystemConfig.scale(num_nodes=num_nodes, drain_depth=drain_depth,
                             txn_width=txn_width)
    base = dict(procedural="uniform", max_instrs=1, pallas_burst=True)
    return dataclasses.replace(cfg, **dict(base, **kw))


@pytest.mark.parametrize("K,H,local", [(3, 4, 800), (2, 1, 300), (4, 3, 500)],
                         ids=["bench", "contended", "k4"])
def test_window_and_replay_kernels_equal_plain_mid_run(card, K, H, local):
    cfg = _sync_cfg(1000, K, H, proc_local_permille=local)  # ragged block
    st = se.run_rounds(cfg, se.procedural_state(cfg, 4096, device=card), 6,
                       fold_impl="plain")
    args = swk.round_inputs(cfg, st)
    before = swk.window.launches, swk.replay.launches
    want = swk.plain_window(*args)
    for a, b in zip(swk.window(*args), want):
        assert torch.equal(a, b)
    rargs = replay_inputs(cfg, st, args, want)
    for a, b in zip(swk.replay(*rargs), swk.plain_replay(*rargs)):
        assert torch.equal(a, b)
    assert (swk.window.launches, swk.replay.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("H,local", [(16, 800), (6, 300)],
                         ids=["bench", "contended"])
def test_burst_kernel_equals_plain_mid_run(card, H, local):
    cfg = _sync_cfg(1000, 1, H, proc_local_permille=local)
    st = se.run_rounds(cfg, se.procedural_state(cfg, 4096, device=card), 6,
                       fold_impl="plain")
    args = (cfg, st.cache_addr, st.cache_val, st.cache_state, st.idx,
            st.instr_count)
    before = sbk.burst.launches
    for a, b in zip(sbk.burst(*args), sbk.plain_burst(*args)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert sbk.burst.launches == before + 1


@pytest.mark.parametrize("K,H,route", [(3, 4, "kernel"), (1, 16, "kernel"),
                                       (1, 16, "burst")],
                         ids=["multi", "single", "single-burst"])
def test_sync_rounds_kernels_equal_plain_rounds_and_cpu(card, K, H, route):
    """Rounds to quiescence on the card through the kernels (txn_width
    1: the fused round, or the burst kernel inside the eager round),
    through the plain rounds on the card, and on the CPU: same rounds,
    every leaf equal."""
    cfg = _sync_cfg(128, K, H, proc_local_permille=500)
    plain = dataclasses.replace(cfg, pallas_burst=False)
    if route == "burst":
        def step(st):
            return se._round_step_single(cfg, st, use_kernel=True)
    else:
        def step(st):
            return se.round_step(cfg, st)
    k = se.procedural_state(cfg, 64, seed=3, device=card)
    p, c = k, se.procedural_state(cfg, 64, seed=3, device="cpu")
    before = srk.fused_round.launches, sbk.burst.launches
    rounds = 0
    while not bool(c.quiescent()):
        k, p, c = step(k), se.round_step(plain, p), se.round_step(plain, c)
        rounds += 1
    assert bool(k.quiescent()) and bool(p.quiescent())
    if K == 1:
        assert (srk.fused_round.launches - before[0],
                sbk.burst.launches - before[1]) == (
            (rounds, 0) if route == "kernel" else (0, rounds))
    want = convert.to_numpy(c)
    for st in (k, p):
        got = convert.to_numpy(st)
        for name in want:
            assert (want[name] == got[name]).all(), name


#: the fused round's configs: those of tests/test_torch_sync_fused.py,
#: and 65,536 nodes (more than the grid's threads: the node loops go round
#: more than once)
FUSED = {
    "n1-c2-m8-h1": (1, dict(cache_size=2, mem_size=8, drain_depth=1)),
    "n12-c8-m8-h16": (12, dict(cache_size=8, mem_size=8, drain_depth=16,
                               proc_local_permille=300)),
    "n33-c2-m32-h4": (33, dict(cache_size=2, mem_size=32, drain_depth=4,
                               proc_local_permille=300)),
    "n1000-bench": (1000, dict(drain_depth=16, proc_local_permille=800)),
    "n256-contended": (256, dict(drain_depth=4, proc_local_permille=300)),
    "n4096-bench": (4096, dict(drain_depth=16, proc_local_permille=800)),
    "n65536": (65536, dict(drain_depth=16, proc_local_permille=800)),
}


@pytest.mark.parametrize("case", list(FUSED))
def test_fused_sync_round_equals_plain_round(card, case):
    n, kw = FUSED[case]
    kw = dict(kw)
    cfg = _sync_cfg(n, 1, kw.pop("drain_depth"), **kw)
    assert srk.supported(cfg)
    lib = srk.LIBRARY.load(cfg)
    if n > 4096:
        assert lib.sync_round_grid(1, n) == lib.sync_round_grid(1, 2 * n)
    # the kernel's block partials are static; it takes no dynamic smem
    assert lib.sync_round_smem_bytes() == 0
    assert lib.sync_round_static_smem_bytes() > 0
    st = se.run_rounds(cfg, se.procedural_state(cfg, 4096, device=card), 6,
                       fold_impl="plain")
    for _ in range(3):
        args = srk.round_inputs(cfg, st)
        before = srk.fused_round.launches
        got = srk.fused_round(*args)
        assert srk.fused_round.launches == before + 1
        for a, b in zip(got, srk.plain_round(*args)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        st = srk.round_step_fused(cfg, st)


def test_sync_wrappers_refuse_bad_operands(card):
    cfg = _sync_cfg(256, 3, 4)
    args = swk.round_inputs(cfg, se.procedural_state(cfg, 64, device=card))
    bad = list(args)
    bad[2] = args[2].to(torch.int64)                 # cache_val
    with pytest.raises(ValueError, match="int32"):
        swk.window(*bad)
    bad = list(args)
    bad[4] = args[4][:, :-1].contiguous()            # idx
    with pytest.raises(ValueError, match="idx"):
        swk.window(*bad)
    fl = torch.zeros((1, 256), dtype=torch.int32, device=card)
    fills = torch.zeros((3, 256), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        swk.replay(*args, fl, fills.T.contiguous().T, fills)
    with pytest.raises(ValueError, match="not CUDA"):
        sbk.launch(cfg, *[t.cpu() for t in args[1:]])
    single = _sync_cfg(256, 1, 16)
    args = srk.round_inputs(single, se.procedural_state(single, 64,
                                                        device=card))
    bad = list(args)
    bad[3] = args[3].to(torch.int64)                 # cache_state
    with pytest.raises(ValueError, match="int32"):
        srk.fused_round(*bad)
    bad = list(args)
    bad[1] = args[1].T.contiguous().T                # cache_addr
    with pytest.raises(ValueError, match="contiguous"):
        srk.fused_round(*bad)
    bad = list(args)
    bad[4] = args[4][:-7]                            # dm
    with pytest.raises(ValueError, match="dm"):
        srk.fused_round(*bad)
    bad = list(args)
    bad[9] = args[9][:10]                            # metrics
    with pytest.raises(ValueError, match="metrics"):
        srk.fused_round(*bad)
    bad = list(args)
    bad[2] = torch.empty(256 * 4 + 1, dtype=torch.int32,
                         device=card)[1:].view(256, 4)   # cache_val
    with pytest.raises(ValueError, match="16-byte"):
        srk.fused_round(*bad)


#: the fused txn_width >= 2 round's configs: K 2/3/4, drain_depth 1/4,
#: locality 0.3/0.8, and 65,536 nodes (more than the grid's threads: the
#: node loops go round more than once)
MULTI = {
    "k2-h1-l300": (1000, 2, 1, dict(proc_local_permille=300)),
    "k2-h4-l800": (1000, 2, 4, {}),
    "k3-h4-l800": (4096, 3, 4, {}),
    "k3-h4-l300": (256, 3, 4, dict(proc_local_permille=300)),
    "k3-h1-c2": (33, 3, 1, dict(cache_size=2, mem_size=32,
                                proc_local_permille=300)),
    "k4-h1-l300": (1000, 4, 1, dict(proc_local_permille=300)),
    "k4-h4-c8": (1000, 4, 4, dict(cache_size=8, mem_size=8,
                                  proc_local_permille=500)),
    "n65536": (65536, 3, 4, {}),
}


@pytest.mark.parametrize("case", list(MULTI))
def test_fused_multi_round_equals_plain_round(card, case):
    n, K, H, kw = MULTI[case]
    cfg = _sync_cfg(n, K, H, **kw)
    assert smk.supported(cfg)
    lib = smk.LIBRARY.load(cfg)
    if n > 4096:
        assert lib.sync_multi_round_grid(1, n) == (
            lib.sync_multi_round_grid(1, 2 * n))
    # the kernel's block partials are static; it takes no dynamic smem
    assert lib.sync_multi_round_smem_bytes() == 0
    assert lib.sync_multi_round_static_smem_bytes() > 0
    st = se.run_rounds(cfg, se.procedural_state(cfg, 4096, device=card), 6,
                       fold_impl="plain")
    for _ in range(3):
        args = smk.round_inputs(cfg, st)
        before = smk.fused_round.launches
        got = smk.fused_round(*args)
        assert smk.fused_round.launches == before + 1
        for a, b in zip(got, smk.plain_round(*args)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        st = smk.round_step_fused(cfg, st)


def test_fused_multi_round_rounds_equal_window_route_and_cpu(card):
    """Rounds to quiescence on the card through the fused round (the
    route of round_step), through the window kernels and on the CPU's
    plain rounds: same rounds, every leaf equal; one fused launch a
    round and no window or replay launch on the fused route."""
    cfg = _sync_cfg(128, 3, 4, proc_local_permille=500)
    plain = dataclasses.replace(cfg, pallas_burst=False)
    f = se.procedural_state(cfg, 64, seed=3, device=card)
    w, c = f, se.procedural_state(cfg, 64, seed=3, device="cpu")
    rounds, fused = 0, 0
    while not bool(c.quiescent()):
        before = (smk.fused_round.launches, swk.window.launches,
                  swk.replay.launches)
        f = se.round_step(cfg, f)
        assert (smk.fused_round.launches, swk.window.launches,
                swk.replay.launches) == (before[0] + 1,) + before[1:]
        w = swk.round_step_multi_kernel(cfg, w)
        c = se.round_step(plain, c)
        rounds += 1
    assert bool(f.quiescent()) and bool(w.quiescent()) and rounds > 0
    want = convert.to_numpy(c)
    for st in (f, w):
        got = convert.to_numpy(st)
        for name in want:
            assert (want[name] == got[name]).all(), name


def test_fused_multi_round_wrapper_refuses_bad_operands(card):
    cfg = _sync_cfg(256, 3, 4)
    args = smk.round_inputs(cfg, se.procedural_state(cfg, 64, device=card))
    with pytest.raises(ValueError, match="not CUDA"):
        smk.launch(cfg, *[t.cpu() for t in args[1:]])
    bad = list(args)
    bad[3] = args[3].to(torch.int64)                 # cache_state
    with pytest.raises(ValueError, match="int32"):
        smk.fused_round(*bad)
    bad = list(args)
    bad[1] = args[1].T.contiguous().T                # cache_addr
    with pytest.raises(ValueError, match="contiguous"):
        smk.fused_round(*bad)
    bad = list(args)
    bad[4] = args[4][:-7]                            # dm
    with pytest.raises(ValueError, match="dm"):
        smk.fused_round(*bad)
    bad = list(args)
    bad[5] = args[5][:-1]                            # idx
    with pytest.raises(ValueError, match="idx"):
        smk.fused_round(*bad)
    bad = list(args)
    bad[9] = args[9][:10]                            # metrics
    with pytest.raises(ValueError, match="metrics"):
        smk.fused_round(*bad)
    bad = list(args)
    bad[2] = torch.empty(256 * 4 + 1, dtype=torch.int32,
                         device=card)[1:].view(256, 4)   # cache_val
    with pytest.raises(ValueError, match="16-byte"):
        smk.fused_round(*bad)


#: the fused rounds' replica axis: (txn_width, drain_depth, overrides)
REPLICA = {
    "k1-h16": (1, 16, {}),
    "k1-h4-l300": (1, 4, dict(proc_local_permille=300)),
    "k3-h4": (3, 4, {}),
    "k3-h4-l300": (3, 4, dict(proc_local_permille=300)),
}


@pytest.mark.parametrize("reps", [1, 8])
@pytest.mark.parametrize("case", list(REPLICA))
def test_fused_rounds_replica_axis_equals_plain_round(card, case, reps):
    """An ensemble of R machines (seeds and rounds all different) through
    one launch a round, held to the plain round of each replica."""
    K, H, kw = REPLICA[case]
    cfg = _sync_cfg(256, K, H, **kw)
    mod = srk if K == 1 else smk
    ens = se.make_ensemble([
        se.run_rounds(cfg, se.procedural_state(cfg, 4096, seed=s,
                                               device=card), 4 + s,
                      fold_impl="plain") for s in range(reps)])
    for _ in range(3):
        args = mod.round_inputs(cfg, ens)
        before = mod.fused_round.launches
        got = mod.fused_round(*args)
        assert mod.fused_round.launches == before + 1
        for a, b in zip(got, mod.plain_round(*args)):
            assert a.shape == b.shape and torch.equal(a, b)
        ens = mod.round_step_fused(cfg, ens)
    assert bool((ens.metrics.conflicts > 0).all())


@pytest.mark.parametrize("K,H", [(1, 16), (3, 4)])
def test_ensemble_to_quiescence_equals_solo_runs(card, K, H):
    """run_ensemble_to_quiescence at R = 8 on the card: one launch a
    round, each replica equal to its solo run of as many rounds."""
    cfg = _sync_cfg(512, K, H, proc_local_permille=500)
    mod = srk if K == 1 else smk
    solos = [se.procedural_state(cfg, 64, seed=s, device=card)
             for s in range(8)]
    before = mod.fused_round.launches
    ens = se.run_ensemble_to_quiescence(cfg, se.make_ensemble(solos), 8)
    rounds = int(ens.round[0])
    assert mod.fused_round.launches - before == rounds > 0
    assert bool(ens.quiescent())
    for r, st in enumerate(solos):
        want = convert.to_numpy(se.run_rounds(cfg, st, rounds))
        got = convert.to_numpy(se.ensemble_replica(ens, r))
        for name in want:
            assert (want[name] == got[name]).all(), (r, name)


# -- the message-level engine: the ring exchange and routed delivery ---------

@pytest.mark.parametrize("D,cap,W", [(2, 3072, 9), (4, 1536, 9),
                                     (8, 768, 9), (4, 7, 7), (3, 5, 3),
                                     (8, 1, 1)],
                         ids=["d2", "d4", "d8", "ragged", "ragged3",
                              "one-word"])
def test_ring_kernel_equals_plain(card, D, cap, W):
    """Every word equal, with 16-byte lanes (cap * W a multiple of 4) and
    ragged ones (scalar copies)."""
    g = torch.Generator().manual_seed(D * 1000 + cap)
    ob = torch.randint(-2**31, 2**31 - 1, (D, D, cap, W), generator=g,
                       dtype=torch.int32).to(card)
    before = ring_kernel.exchange.launches
    got = ring_kernel.exchange(ob)
    assert ring_kernel.exchange.launches == before + 1
    assert torch.equal(got, ring_kernel.plain_exchange(ob))
    assert torch.equal(got.cpu(), ring_kernel.exchange(ob.cpu()))


def test_ring_wrapper_refuses_bad_operands(card):
    ob = torch.zeros((4, 4, 8, 9), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="int32"):
        ring_kernel.exchange(ob.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        ring_kernel.exchange(ob.transpose(2, 3))
    with pytest.raises(ValueError, match="shards"):
        ring_kernel.exchange(torch.zeros((9, 9, 2, 9), dtype=torch.int32,
                                         device=card))


def test_routed_async_run_equals_plain_delivery(card):
    """128 cycles at 1024 nodes: routed through the ring kernel and
    through all_to_all at D = 4, both equal to plain delivery on the card
    and on the CPU; the ring launched once a cycle."""
    cfg = SystemConfig.scale(num_nodes=1024, max_instrs=64)
    sys0 = CoherenceSystem.from_workload(cfg, "procedural_uniform",
                                         device=card)
    cpu = CoherenceSystem.from_workload(cfg, "procedural_uniform",
                                        device="cpu")
    want = convert.sim_numpy_leaves(step.run_cycles(cfg, cpu.state, 128))
    plain = convert.sim_numpy_leaves(step.run_cycles(cfg, sys0.state, 128))
    layout = mesh.make_layout(1024, 4, device=card)
    for transport in ("rdma", "all_to_all"):
        run = sharded_step.make_transport_runner(cfg, layout, 128, transport)
        before = ring_kernel.exchange.launches
        got = convert.sim_numpy_leaves(run(sys0.state))
        launched = ring_kernel.exchange.launches - before
        assert launched == (128 if transport == "rdma" else 0)
        for name in want:
            assert (want[name] == got[name]).all(), (transport, name)
            assert (want[name] == plain[name]).all(), name


def test_ring_exchange_across_cards(card):
    """One shard per card, peer access on, one launch per sender."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    D = min(n, ring_kernel.MAX_SHARDS)
    g = torch.Generator().manual_seed(5)
    obs = [torch.randint(-2**31, 2**31 - 1, (D, 37, 9), generator=g,
                         dtype=torch.int32).to(f"cuda:{s}")
           for s in range(D)]
    before = ring_kernel.exchange.launches
    got = ring_kernel.exchange_across(obs)
    assert ring_kernel.exchange.launches == before + D
    for d, (a, b) in enumerate(zip(got,
                                   ring_kernel.plain_exchange_across(obs))):
        torch.cuda.synchronize(d)
        assert a.device == b.device and torch.equal(a, b), d
