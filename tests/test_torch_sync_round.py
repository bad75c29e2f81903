"""The port's sync window rounds equal the JAX package's, round by round.

``round_step`` without ``cfg.deep_window``: ``_round_step_single``
(txn_width 1) and ``_round_step_multi`` (txn_width > 1) against their
JAX namesakes, from mid-run states carried across with
``convert.from_numpy``. Each case runs the port twice from the same
state: the plain round with the event record (held to JAX's events as
well), and, on procedural workloads, the kernel route
(``cfg.pallas_burst``: the fused round at either txn_width), whose
wrappers run the kernels' plain versions on the CPU (the
CUDA kernels are held to those on the card by chip_smoke.py and
tests/test_torch_cuda.py). Stored traces are made once
with numpy from a seed and fed to both sides. The sync rounds do not
read ``cfg.protocol``, so there are no variant cases. Every comparison
is exact (int32, tolerance 0).
"""

import dataclasses
import functools
import pathlib

import jax
import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu.state import init_state
from ue22cs343bb1_openmp_assignment_tpu.utils import eventlog as jeventlog
from ue22cs343bb1_openmp_assignment_tpu.utils import trace as jtrace
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    deep_round_kernel as drk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_burst_kernel as sbk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as tse
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_multi_round_kernel as smk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_round_kernel as srk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_window_kernel as swk)
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import eventlog

from tests.torch_parity import assert_states_equal, cfg_pair

MINI = pathlib.Path(__file__).resolve().parent / "fixtures" / "mini"
PROC = dict(procedural="uniform", max_instrs=1)

CASES = {
    # name: (nodes, config overrides, warm-up rounds, rounds)
    "multi": (64, dict(PROC, drain_depth=4, txn_width=3,
                       proc_local_permille=700), 10, 12),
    "multi-contended": (64, dict(PROC, drain_depth=1, txn_width=2,
                                 proc_local_permille=300), 10, 12),
    "multi-stored": (32, dict(drain_depth=4, txn_width=3, max_instrs=48),
                     4, 12),
    "single": (128, dict(PROC, drain_depth=6, proc_local_permille=700),
               20, 12),
    "single-contended": (64, dict(PROC, drain_depth=16,
                                  proc_local_permille=300), 6, 12),
    "single-stored": (32, dict(drain_depth=4, max_instrs=48), 4, 12),
}


def stored_traces(cfg, seed: int):
    """(op, addr, val, count) numpy arrays [N, max_instrs]: reads and
    writes at locality 0.6, a few NOPs, ragged lengths."""
    rng = np.random.default_rng(seed)
    N, T = cfg.num_nodes, cfg.max_instrs
    home = np.where(rng.random((N, T)) < 0.6, np.arange(N)[:, None],
                    rng.integers(0, N, (N, T)))
    addr = (home << cfg.block_bits) | rng.integers(0, cfg.mem_size, (N, T))
    op = rng.choice([0, 0, 0, 1, 1, 1, 2], size=(N, T))
    return (op.astype(np.int32), addr.astype(np.int32),
            rng.integers(0, 256, (N, T)).astype(np.int32),
            rng.integers(T // 2, T + 1, (N,)).astype(np.int32))


def _jax_start(nodes, kw, seed=1):
    jcfg, tcfg = cfg_pair(nodes, **kw)
    if jcfg.procedural:
        return jcfg, tcfg, jse.procedural_state(jcfg, 200, seed=seed)
    sim = init_state(jcfg, instr_arrays=stored_traces(jcfg, 7))
    return jcfg, tcfg, jse.from_sim_state(jcfg, sim, seed=seed)


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    return jax.jit(functools.partial(jse.round_step, jcfg,
                                     with_events=True))


@pytest.mark.parametrize("case", list(CASES))
def test_rounds_and_events_match_jax(case):
    nodes, kw, warm, rounds = CASES[case]
    jcfg, tcfg, js = _jax_start(nodes, kw)
    step = _jax_step(jcfg)
    for _ in range(warm):
        js, _ = step(js)
    leaves = convert.numpy_leaves(js)
    plain = convert.from_numpy(tcfg, leaves, device="cpu")
    routed = None
    if tcfg.procedural:
        kcfg = dataclasses.replace(tcfg, pallas_burst=True)
        routed = convert.from_numpy(kcfg, leaves, device="cpu")
    for r in range(rounds):
        where = f"{case}, round {warm + r + 1}"
        js, jev = step(js)
        plain, tev = tse.round_step(tcfg, plain, with_events=True)
        assert_states_equal(js, plain, f"{where}: ")
        assert sorted(tev) == sorted(jev)
        for f in jev:
            want, got = np.asarray(jev[f]), tev[f].numpy()
            assert want.dtype == got.dtype, (where, f)
            np.testing.assert_array_equal(want, got, err_msg=f"{where} {f}")
        if routed is not None:
            routed = tse.round_step(kcfg, routed)
            assert_states_equal(js, routed, f"{where} (kernel route): ")
    tse.check_exact_directory(tcfg, plain)
    m = plain.metrics
    assert int(m.instrs_retired) > 0 and int(m.conflicts) > 0
    assert int(m.evictions) > 0


def test_untileable_node_count_takes_the_kernel_route(monkeypatch):
    """1100 nodes fit no 1024 tile, so JAX keeps its XLA round under
    pallas_burst; the port's kernels take any N, so its window-kernel
    route (``round_step_multi_kernel``, called here directly: the fused
    round is round_step's route) goes through the window wrappers (on
    the CPU their plain versions, by the wrapper's CPU branch or by
    fold_impl="plain"). Same states."""
    jcfg, tcfg = cfg_pair(1100, **dict(PROC, drain_depth=1, txn_width=2,
                                       proc_local_permille=700,
                                       pallas_burst=True))
    assert sbk.supported(tcfg)
    js = jse.procedural_state(jcfg, 64, seed=2)
    ts = tse.procedural_state(tcfg, 64, seed=2, device="cpu")
    by_wrapper, by_impl = [], []
    plain_window = swk.plain_window
    monkeypatch.setattr(
        swk, "plain_window",
        lambda *a: by_wrapper.append(1) or plain_window(*a))
    monkeypatch.setitem(
        swk.PLAIN, "window",
        lambda *a: by_impl.append(1) or plain_window(*a))
    for r in range(4):
        js = jse.run_rounds(jcfg, js, 1)
        ts = swk.round_step_multi_kernel(tcfg, ts,
                                         "plain" if r % 2 else "kernel")
        assert_states_equal(js, ts, f"round {r + 1}: ")
    assert (len(by_wrapper), len(by_impl)) == (2, 2)
    assert swk.window.launches == 0


def test_round_step_dispatch(monkeypatch):
    """pallas_burst routes procedural rounds without events through the
    kernel modules (the fused rounds; at txn_width 1 the burst kernel
    where the fused round does not take the config); stored traces and
    event tracing keep the plain rounds, and a deep round with events
    the fold path, as in JAX."""
    seen = []
    monkeypatch.setattr(smk, "round_step_fused",
                        lambda cfg, st, impl: seen.append(("multi", impl))
                        or st)
    monkeypatch.setattr(srk, "round_step_fused",
                        lambda cfg, st, impl: seen.append(("fused", impl))
                        or st)
    burst = sbk.plain_burst
    monkeypatch.setattr(sbk, "burst",
                        lambda *a: seen.append(("burst",)) or burst(*a))
    _, multi = cfg_pair(16, **dict(PROC, drain_depth=2, txn_width=2,
                                   pallas_burst=True))
    st = tse.procedural_state(multi, 16, device="cpu")
    assert tse.round_step(multi, st) is st
    assert tse.round_step(multi, st, "plain") is st
    assert seen == [("multi", "kernel"), ("multi", "plain")]
    out, ev = tse.round_step(multi, st, with_events=True)
    assert int(out.round) == 1 and ev["retired"].shape == (16, 4)
    off = dataclasses.replace(multi, pallas_burst=False)
    assert int(tse.round_step(off, st).round) == 1
    assert len(seen) == 2
    single = dataclasses.replace(multi, txn_width=1)
    assert tse.round_step(single, st) is st
    assert tse.round_step(single, st, "plain") is st
    assert seen[2:] == [("fused", "kernel"), ("fused", "plain")]
    wide = dataclasses.replace(single, cache_size=64)
    assert sbk.supported(wide) and not srk.supported(wide)
    wst = tse.procedural_state(wide, 16, device="cpu")
    assert int(tse.round_step(wide, wst).round) == 1
    assert seen[4:] == [("burst",)]
    assert int(tse.round_step(wide, wst, "plain").round) == 1
    assert len(seen) == 5
    _, stored = cfg_pair(4, reference=True, txn_width=2, pallas_burst=True)
    traces = jtrace.load_test_dir(str(MINI), 4, stored.max_instrs)
    sst = tse.from_traces(stored, traces, device="cpu")
    assert int(tse.round_step(stored, sst).round) == 1
    assert len(seen) == 5
    with pytest.raises(ValueError, match="fold_impl"):
        tse.round_step(multi, st, "xla")
    # the deep round's event record comes from the fold path, never the
    # fused round (tests/test_torch_traced.py holds it to JAX's)
    _, deep = cfg_pair(16, **dict(PROC, deep_window=True, fused_round=True))
    monkeypatch.setattr(drk, "round_step_deep_fused",
                        lambda *a: pytest.fail("the fused deep round ran"))
    out, ev = tse.round_step(deep, tse.procedural_state(deep, 8,
                                                        device="cpu"),
                             with_events=True)
    W = deep.drain_depth + deep.txn_width
    assert int(out.round) == 1 and ev["retired"].shape == (16, W)


@pytest.mark.parametrize("txn_width", [1, 2])
def test_run_rounds_traced_and_event_log_match_jax(txn_width, tmp_path):
    """The retirement record of the mini fixture: tensors, records and
    the rendered instruction_order lines equal JAX's."""
    jcfg, tcfg = cfg_pair(4, reference=True, txn_width=txn_width)
    traces = jtrace.load_test_dir(str(MINI), 4, jcfg.max_instrs)
    js = jse.from_sim_state(jcfg, init_state(jcfg, traces), seed=1)
    ts = tse.from_traces(tcfg, traces, seed=1, device="cpu")
    assert_states_equal(js, ts, "built state: ")
    js, jev = jse.run_rounds_traced(jcfg, js, 10)
    ts, tev = tse.run_rounds_traced(tcfg, ts, 10)
    assert_states_equal(js, ts)
    for f in ("retired", "op", "addr", "value"):
        assert tev[f].shape == (10, 4, tcfg.drain_depth + txn_width)
        np.testing.assert_array_equal(np.asarray(jev[f]), tev[f].numpy())
    want = jeventlog.sync_to_records(jev, base_round=3)
    got = eventlog.sync_to_records(tev, base_round=3)
    assert got == want and len(got) == int(ts.metrics.instrs_retired) > 0
    assert [eventlog.format_record(r) for r in got] == [
        jeventlog.format_record(r) for r in want]
    jeventlog.write_sync_log(str(tmp_path / "jax.txt"), jev)
    eventlog.write_sync_log(str(tmp_path / "port.txt"), tev)
    assert (tmp_path / "port.txt").read_text() == (
        tmp_path / "jax.txt").read_text() != ""


def test_continue_with_traces_round_trip():
    """Two stored phases chained through continue_with_traces: the
    boundary state and the final state equal JAX's; a machine with
    instructions left is refused."""
    jcfg, tcfg = cfg_pair(16, drain_depth=2, txn_width=2, max_instrs=12)
    first, second = stored_traces(jcfg, 3), stored_traces(jcfg, 4)
    js = jse.from_sim_state(jcfg, init_state(jcfg, instr_arrays=first))
    ts = tse.from_traces(tcfg, instr_arrays=first, device="cpu")
    with pytest.raises(ValueError, match="fully retired"):
        tse.continue_with_traces(tcfg, tse.round_step(tcfg, ts),
                                 instr_arrays=second)
    js = jse.run_sync_to_quiescence(jcfg, js, 4, 400)
    ts = tse.run_sync_to_quiescence(tcfg, ts, 4, 400)
    assert_states_equal(js, ts, "phase 1: ")
    js = jse.continue_with_traces(jcfg, js, instr_arrays=second)
    ts = tse.continue_with_traces(tcfg, ts, instr_arrays=second)
    assert_states_equal(js, ts, "boundary: ")
    assert int(ts.round) == 0 and int(ts.metrics.rounds) > 0
    js = jse.run_sync_to_quiescence(jcfg, js, 4, 400)
    ts = tse.run_sync_to_quiescence(tcfg, ts, 4, 400)
    assert_states_equal(js, ts, "phase 2: ")
    assert bool(ts.quiescent())
    tse.check_exact_directory(tcfg, ts)


def test_round_key_matches_jax():
    jcfg, tcfg = cfg_pair(1000, **PROC)
    js = jse.procedural_state(jcfg, 4, seed=5).replace(
        round=jax.numpy.asarray(37, jax.numpy.int32))
    ts = tse.procedural_state(tcfg, 4, seed=5, device="cpu").replace(
        round=torch.tensor(37, dtype=torch.int32))
    want = jse._round_key(jcfg, js, jax.numpy.arange(1000, dtype="int32"))
    got = tse._round_key(tcfg, ts, torch.arange(1000, dtype=torch.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert len(set(got.tolist())) == 1000       # unique per node
