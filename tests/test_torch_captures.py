"""The observability captures of the port against the JAX package's.

``mailbox.deliver(with_accept=True)``, the four captures of the
message-level ``cycle`` through their runners (``run_cycles_telemetry``
with and without the ledger, ``run_cycles_ledger`` with and without the
retire observation, ``run_cycles_profile``), ``run_sync_profile`` and
the deep engine's ``return_stats`` / ``run_deep_profile``. Both sides
run on the CPU from the same seeded inputs; every sample and plane must
be equal, values and dtypes (the ledger's narrowed node ids and
addresses included: 128 nodes cross the int8 -> int16 edge).
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu.models.system import (
    CoherenceSystem as JaxSystem)
from ue22cs343bb1_openmp_assignment_tpu.ops import deep_engine as jde
from ue22cs343bb1_openmp_assignment_tpu.ops import mailbox as jmail
from ue22cs343bb1_openmp_assignment_tpu.ops import step as jstep
from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
    CoherenceSystem as PortSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import deep_engine as tde
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import mailbox as tmail
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step as tstep
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as tse

from tests.torch_parity import (BENCH_DEEP, assert_sim_states_equal,
                                assert_states_equal, assert_trees_equal,
                                cfg_pair, jax_sim_state, jax_state)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MINI = str(ROOT / "tests" / "fixtures" / "mini")

#: id -> (nodes, workload or None for tests/fixtures/mini, trace length,
#: cycles captured)
CONFIGS = {
    "mini": (4, None, None, 40),
    "uniform16": (16, "uniform", 32, 48),
    "false_sharing16": (16, "false_sharing", 32, 48),
    "uniform128": (128, "uniform", 8, 24),
}


def _systems(name: str):
    """(JAX cfg, JAX state, port cfg, port state) of a CONFIGS entry,
    the same machine on both sides."""
    nodes, workload, length, _ = CONFIGS[name]
    if workload is None:
        jcfg, tcfg = cfg_pair(nodes, reference=True)
        js = JaxSystem.from_test_dir(MINI, jcfg)
        ts = PortSystem.from_test_dir(MINI, tcfg, device="cpu")
    else:
        jcfg, tcfg = cfg_pair(nodes)
        js = JaxSystem.from_workload(jcfg, workload, trace_len=length,
                                     seed=3)
        ts = PortSystem.from_workload(tcfg, workload, trace_len=length,
                                      seed=3, device="cpu")
    assert_sim_states_equal(js.state, ts.state)
    return js.cfg, js.state, ts.cfg, ts.state


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_exact(want, got, where: str = "") -> None:
    """Nested dicts of arrays equal in keys, shapes, dtypes and values."""
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), (where, sorted(want),
                                             sorted(got))
        for k in want:
            assert_exact(want[k], got[k], f"{where}{k}.")
        return
    a, b = _np(want), _np(got)
    assert a.dtype == b.dtype, f"{where}: dtype {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{where}: shape {a.shape} vs {b.shape}"
    assert np.array_equal(a, b), f"{where}: values differ"


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("with_ledger", [False, True],
                         ids=["telemetry", "telemetry+ledger"])
def test_run_cycles_telemetry_matches_jax(name, with_ledger):
    jcfg, jst, tcfg, tst = _systems(name)
    T = CONFIGS[name][3]
    want = jstep.run_cycles_telemetry(jcfg, jst, T, None, with_ledger)
    got = tstep.run_cycles_telemetry(tcfg, tst, T,
                                     with_ledger=with_ledger)
    assert len(got) == len(want) == 2 + with_ledger
    assert_sim_states_equal(want[0], got[0])
    assert_exact(want[1], got[1], "telem.")
    assert got[1]["counters"].shape == (T, 8)
    if with_ledger:
        assert_exact(want[2], got[2], "ledger.")
        assert sorted(got[2]) == sorted(tstep.LEDGER_FIELDS)
    # the summed counter deltas are the run's metrics
    m = got[0].metrics
    tot = got[1]["counters"].sum(0)
    for i, f in enumerate(tstep.TELEMETRY_COUNTERS):
        assert int(tot[i]) == int(getattr(m, f)), f


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("with_obs", [False, True],
                         ids=["ledger", "ledger+obs"])
def test_run_cycles_ledger_matches_jax(name, with_obs):
    jcfg, jst, tcfg, tst = _systems(name)
    T = CONFIGS[name][3]
    want = jstep.run_cycles_ledger(jcfg, jst, T, None, with_obs)
    got = tstep.run_cycles_ledger(tcfg, tst, T, with_obs=with_obs)
    assert_sim_states_equal(want[0], got[0])
    assert_exact(want[1], got[1], "ledger.")
    node_dt = torch.int8 if CONFIGS[name][0] <= 127 else torch.int16
    assert got[1]["enq_recv"].dtype == node_dt
    assert got[1]["deq_addr"].dtype == torch.int16
    assert got[1]["enq_accept"].any()
    if with_obs:
        assert got[1]["obs_val"].dtype == torch.int16
        assert got[1]["obs_retire"].any()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_cycles_profile_matches_jax(name):
    jcfg, jst, tcfg, tst = _systems(name)
    T = CONFIGS[name][3]
    want = jstep.run_cycles_profile(jcfg, jst, T)
    got = tstep.run_cycles_profile(tcfg, tst, T)
    assert_sim_states_equal(want[0], got[0])
    assert_exact(want[1], got[1], "prof.")
    prof, m = got[1], got[0].metrics
    assert int(prof["rd"].sum()) == int(m.read_hits + m.read_misses)
    assert int(prof["wr"].sum()) == int(m.write_hits + m.write_misses)
    assert int(prof["miss_node"].sum()) > 0


@pytest.mark.parametrize("runner", ["telemetry", "telemetry+ledger",
                                    "ledger", "ledger+obs", "profile"])
def test_zero_cycle_captures_match_jax(runner):
    """A run of 0 cycles: empty [0, ...] samples of the same dtypes, and
    a zeroed profile."""
    jcfg, jst, tcfg, tst = _systems("uniform16")
    if runner.startswith("telemetry"):
        led = runner.endswith("ledger")
        want = jstep.run_cycles_telemetry(jcfg, jst, 0, None, led)
        got = tstep.run_cycles_telemetry(tcfg, tst, 0, with_ledger=led)
    elif runner.startswith("ledger"):
        obs = runner.endswith("obs")
        want = jstep.run_cycles_ledger(jcfg, jst, 0, None, obs)
        got = tstep.run_cycles_ledger(tcfg, tst, 0, with_obs=obs)
    else:
        want = jstep.run_cycles_profile(jcfg, jst, 0)
        got = tstep.run_cycles_profile(tcfg, tst, 0)
    assert_sim_states_equal(want[0], got[0])
    for w, g in zip(want[1:], got[1:]):
        assert_exact(w, g)


def test_profile_zeros_and_constants_match_jax():
    jcfg, tcfg = cfg_pair(16)
    assert_exact(jstep.profile_zeros(jcfg), tstep.profile_zeros(tcfg, "cpu"))
    for name in ("TELEMETRY_COUNTERS", "LEDGER_FIELDS", "LEDGER_OBS_FIELDS",
                 "PROFILE_MISS_CLASSES", "FANOUT_BUCKETS"):
        assert getattr(tstep, name) == getattr(jstep, name), name
    assert tstep.profile_space(tcfg) == jstep.profile_space(jcfg)
    for name in ("PROFILE_ABORT_CLASSES", "PROFILE_STOP_CLASSES"):
        assert getattr(tde, name) == getattr(jde, name), name


@pytest.mark.parametrize("knobs", [
    dict(reference=True, queue_capacity=2),
    dict(queue_capacity=1),
    dict(queue_capacity=4, drop_prob=0.3),
], ids=["mailbox-cap2", "scatter-cap1", "scatter-faults"])
def test_deliver_with_accept_matches_jax(knobs):
    """deliver's accept mask alone, on random candidates against rings
    filled part way: capacity drops, out-of-range receivers and fault
    drops all leave their candidates unaccepted, in (sender, slot)
    layout."""
    knobs = dict(knobs)
    ref = knobs.pop("reference", False)
    jcfg, tcfg = cfg_pair(4 if ref else 16, reference=ref, **knobs)
    N, S, Q = tcfg.num_nodes, tcfg.out_slots, tcfg.queue_capacity
    rng = np.random.default_rng(7)
    ts = PortSystem.from_workload(tcfg, "uniform", trace_len=8, seed=1,
                                  device="cpu").state
    count = rng.integers(0, Q + 1, N).astype(np.int32)
    ts = ts.replace(mb_count=torch.from_numpy(count),
                    mb_head=torch.from_numpy(
                        rng.integers(0, Q, N).astype(np.int32)),
                    arb_rank=torch.from_numpy(
                        rng.permutation(N).astype(np.int32)))
    js = jax_sim_state(convert.sim_numpy_leaves(ts))
    planes = {f: rng.integers(0, 50, (N, S)).astype(np.int32)
              for f in ("addr", "value", "second", "dirstate")}
    planes["type"] = rng.integers(0, 6, (N, S)).astype(np.int32)
    planes["recv"] = rng.integers(-1, N + 2, (N, S)).astype(np.int32)
    planes["sender"] = np.repeat(np.arange(N, dtype=np.int32)[:, None], S, 1)
    bv = rng.integers(0, 2**31, (N, S, tcfg.msg_bitvec_words)).astype(
        np.int32)
    jc = jmail.Candidates(bitvec=jnp.asarray(bv.view(np.uint32)),
                          **{k: jnp.asarray(v) for k, v in planes.items()})
    tc = tmail.Candidates(bitvec=torch.from_numpy(bv),
                          **{k: torch.from_numpy(v)
                             for k, v in planes.items()})
    new_count = np.maximum(count - 1, 0).astype(np.int32)
    want = jmail.deliver(jcfg, js, jc, js.arb_rank, js.mb_head,
                         jnp.asarray(new_count), with_accept=True)
    got = tmail.deliver(tcfg, ts, tc, ts.arb_rank, ts.mb_head,
                        torch.from_numpy(new_count), with_accept=True)
    assert_exact(want[0]["enq_accept"], got[0]["enq_accept"])
    assert got[0]["enq_accept"].shape == (N, S)
    assert_trees_equal(want, got)
    plain = tmail.deliver(tcfg, ts, tc, ts.arb_rank, ts.mb_head,
                          torch.from_numpy(new_count))
    assert "enq_accept" not in plain[0]
    acc = got[0]["enq_accept"]
    assert 0 < int(acc.sum()) < int((tc.type != 0).sum())


@pytest.mark.parametrize("txn_width", [1, 3])
def test_run_sync_profile_matches_jax(txn_width):
    jcfg, tcfg = cfg_pair(16, txn_width=txn_width, max_instrs=24)
    sim = PortSystem.from_workload(tcfg, "uniform", trace_len=24, seed=2,
                                   device="cpu").state
    tst = tse.from_sim_state(tcfg, sim)
    jst = jax_state(convert.to_numpy(tst))
    want = jse.run_sync_profile(jcfg, jst, 10)
    got = tse.run_sync_profile(tcfg, tst, 10)
    assert_states_equal(want[0], got[0])
    assert_exact(want[1], got[1], "rd.")
    assert_exact(want[2], got[2], "wr.")
    m = got[0].metrics
    assert int(got[1].sum()) + int(got[2].sum()) == int(m.instrs_retired)


def _deep_pair():
    jcfg, tcfg = cfg_pair(16, **BENCH_DEEP)
    tst = tse.procedural_state(tcfg, 24, device="cpu")
    return jcfg, jax_state(convert.to_numpy(tst)), tcfg, tst


def test_round_step_deep_stats_match_jax():
    jcfg, jst, tcfg, tst = _deep_pair()
    # jitted: the eager JAX deep round takes twice the compile
    want = jax.jit(lambda s: jde.round_step_deep(jcfg, s,
                                                 return_stats=True))(jst)
    got = tde.round_step_deep(tcfg, tst, fold_impl="plain",
                              return_stats=True)
    assert_states_equal(want[0], got[0])
    assert_exact(want[1], got[1], "stats.")
    assert_states_equal(want[0], tde.round_step_deep(tcfg, tst,
                                                     fold_impl="plain"))
    assert int(got[1]["n_ret"]) == int(got[0].metrics.instrs_retired)


def test_run_deep_profile_matches_jax():
    jcfg, jst, tcfg, tst = _deep_pair()
    assert_exact(jde.deep_profile_zeros(jcfg),
                 tde.deep_profile_zeros(tcfg, "cpu"))
    want = jde.run_deep_profile(jcfg, jst, 6)
    got = tde.run_deep_profile(tcfg, tst, 6)
    assert_states_equal(want[0], got[0])
    assert_exact(want[1], got[1], "prof.")
    prof = got[1]
    assert int(prof["n_ret"].sum()) == int(got[0].metrics.instrs_retired)
    assert int(prof["rd"].sum() + prof["wr"].sum()) <= int(
        prof["n_ret"].sum())
    assert int(prof["poison_raised"]) >= int(prof["poison_committed"]) > 0


@pytest.mark.parametrize("kw", [
    dict(with_events=True, return_stats=True),
    dict(with_events=True, return_profile=True),
    dict(return_stats=True, return_profile=True),
    dict(return_stats=True, fold_impl="kernel"),
    dict(return_profile=True, fold_impl="kernel"),
], ids=["events+stats", "events+profile", "stats+profile",
        "stats-kernel", "profile-kernel"])
def test_excluded_deep_capture_pairs_raise(kw):
    """One round returns one extra value, and the anatomy needs the
    plain fold: the JAX ValueErrors, "plain" in the place of "xla"."""
    _, _, tcfg, tst = _deep_pair()
    kw = dict(kw)
    kw.setdefault("fold_impl", "plain")
    with pytest.raises(ValueError, match="exclusive|plain fold"):
        tde.round_step_deep(tcfg, tst, **kw)


@pytest.mark.parametrize("capture", ["telemetry", "ledger", "obs",
                                     "profile", "sync-profile",
                                     "deep-profile"])
def test_captures_leave_the_run_unchanged(capture):
    """A capture changes nothing of the machine: its final state equals
    the plain run's, leaf for leaf, and its input state is untouched
    (the two-pass verbs replay from it)."""
    if capture in ("sync-profile", "deep-profile"):
        if capture == "deep-profile":
            _, _, cfg, st0 = _deep_pair()
            plain = tse.run_rounds(cfg, st0, 3, fold_impl="plain")
            got = tde.run_deep_profile(cfg, st0, 3)[0]
        else:
            _, cfg = cfg_pair(16, txn_width=3, procedural="uniform",
                              max_instrs=1)
            st0 = tse.procedural_state(cfg, 16, device="cpu")
            plain = tse.run_rounds(cfg, st0, 6)
            got = tse.run_sync_profile(cfg, st0, 6)[0]
        before = convert.to_numpy(st0)
        for k, v in convert.to_numpy(got).items():
            np.testing.assert_array_equal(v, convert.to_numpy(plain)[k], k)
        assert convert.leaves_digest(convert.to_numpy(st0)) == \
            convert.leaves_digest(before)
        return
    _, _, cfg, st0 = _systems("false_sharing16")
    before = convert.sim_numpy_leaves(st0)
    plain = tstep.run_cycles(cfg, st0, 30)
    got = {"telemetry": lambda: tstep.run_cycles_telemetry(cfg, st0, 30),
           "ledger": lambda: tstep.run_cycles_ledger(cfg, st0, 30),
           "obs": lambda: tstep.run_cycles_ledger(cfg, st0, 30,
                                                  with_obs=True),
           "profile": lambda: tstep.run_cycles_profile(cfg, st0, 30),
           }[capture]()[0]
    assert_sim_states_equal(plain, got)
    after = convert.sim_numpy_leaves(st0)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], k)
    assert dataclasses.is_dataclass(got)
