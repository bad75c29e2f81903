"""The message-level engine's pieces: the port against the JAX package
on the same inputs, exactly (int32; sharer words compare as bit
patterns).

Bit helpers on random words; ``dequeue``, ``message_phase`` and a whole
cycle on states staged with ``push_message`` (one message of every type,
in both INV modes, on top of a machine some cycles into a run);
``deliver`` on random candidates, and its two sort branches against each
other; ``instruction_phase`` with the issue knobs, the order replay and
the admission window.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu import state as jstate
from ue22cs343bb1_openmp_assignment_tpu.ops import frontend as jfront
from ue22cs343bb1_openmp_assignment_tpu.ops import handlers as jhand
from ue22cs343bb1_openmp_assignment_tpu.ops import mailbox as jmail
from ue22cs343bb1_openmp_assignment_tpu.ops import step as jstep
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch import state as tstate
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import frontend as tfront
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import handlers as thand
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import mailbox as tmail
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step as tstep
from ue22cs343bb1_openmp_assignment_tpu_torch.types import Msg, Op

from tests.torch_parity import (as_numpy, assert_sim_states_equal,
                                assert_trees_equal, cfg_pair, jax_sim_state)

MINI = "tests/fixtures/mini"


def _words(rng, shape):
    """Random uint32 words with 0, bit 31 alone and all ones mixed in."""
    w = rng.integers(0, 2**32, shape, dtype=np.uint64)
    flat = w.reshape(-1)
    flat[::7] = 0
    flat[1::7] = 1 << 31
    flat[2::11] = 2**32 - 1
    return w.astype(np.uint32)


def _port(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                            if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("W", [1, 3])
def test_bit_helpers_match_jax(W):
    rng = np.random.default_rng(W)
    bv = _words(rng, (40, W))
    node = rng.integers(0, 32 * W, (40,)).astype(np.int32)
    node[:4] = [0, 31, 32 * W - 1, 32 * (W - 1)]
    jbv, jn = jnp.asarray(bv), jnp.asarray(node)
    tbv, tn = _port(bv), torch.from_numpy(node)
    for name, want, got in [
            ("bit_get", jstate.bit_get(jbv, jn), tstate.bit_get(tbv, tn)),
            ("bit_set", jstate.bit_set(jbv, jn), tstate.bit_set(tbv, tn)),
            ("bit_clear", jstate.bit_set(jbv, jn, on=False),
             tstate.bit_set(tbv, tn, on=False)),
            ("bit_single", jstate.bit_single(W, jn),
             tstate.bit_single(W, tn)),
            ("popcount", jstate.popcount(jbv), tstate.popcount(tbv)),
            ("ctz", jstate.ctz(jbv), tstate.ctz(tbv))]:
        assert_trees_equal(want, got, name)
    lat = np.concatenate([np.arange(1, 70), 2 ** np.arange(31) - 1,
                          2 ** np.arange(31), [2**31 - 1]]).astype(np.int32)
    lat = np.maximum(lat, 1)
    want = 31 - np.asarray(jax.lax.clz(jnp.asarray(lat)))
    assert np.array_equal(tstate.floor_log2(torch.from_numpy(lat)).numpy(),
                          want)


def _mid_run(reference: bool, cycles: int):
    """(jax cfg, port cfg, JAX state, port state): a machine ``cycles``
    cycles into its run; the mini fixture (reference config, mailbox
    INV) or procedural_uniform at 16 nodes in scatter mode."""
    from ue22cs343bb1_openmp_assignment_tpu.models.system import (
        CoherenceSystem)
    if reference:
        jcfg, tcfg = cfg_pair(4, reference=True)
        sys_ = CoherenceSystem.from_test_dir(MINI, jcfg)
    else:
        jcfg, tcfg = cfg_pair(16, queue_capacity=8, max_instrs=24)
        sys_ = CoherenceSystem.from_workload(jcfg, "procedural_uniform")
    st = sys_.state
    for _ in range(cycles):
        st = jstep.cycle(jcfg, st)
    port = convert.sim_from_numpy(tcfg, convert.sim_numpy_leaves(st),
                                  device="cpu")
    return jcfg, tcfg, st, port


@pytest.fixture(scope="module", params=["reference-mailbox", "scale-scatter"])
def mid_run(request):
    return _mid_run(request.param == "reference-mailbox", 6)


@pytest.mark.parametrize("msg", [m for m in Msg if m is not Msg.NONE],
                         ids=lambda m: m.name)
def test_message_phase_and_cycle_match_jax(mid_run, msg):
    """One staged message of each type at a node whose ring is empty,
    plus whatever the run left queued: the dequeued view, every handler
    output, and the whole cycle after it, equal."""
    jcfg, tcfg, jst, tst = mid_run
    N = jcfg.num_nodes
    rng = np.random.default_rng(int(msg))
    empty = np.nonzero(np.asarray(jst.mb_count) == 0)[0]
    node = int(empty[0]) if empty.size else 0
    home = node if msg in (Msg.READ_REQUEST, Msg.WRITE_REQUEST,
                           Msg.UPGRADE, Msg.FLUSH, Msg.FLUSH_INVACK,
                           Msg.EVICT_SHARED, Msg.EVICT_MODIFIED) \
        else int(rng.integers(0, N))
    kw = dict(type=msg, sender=int(rng.integers(0, N)),
              addr=(home << jcfg.block_bits) | int(rng.integers(0, 4)),
              value=int(rng.integers(0, 256)),
              second=int(rng.integers(0, N)),
              dirstate=int(rng.integers(0, 3)),
              bitvec=int(rng.integers(0, 2**N)) if N <= 8 else 0)
    jst = jmail.push_message(jcfg, jst, node, **kw)
    tst = tmail.push_message(tcfg, tst, node, **kw)
    assert_sim_states_equal(jst, tst, "pushed.")
    jmv, jh, jc = jmail.dequeue(jcfg, jst)
    tmv, th, tc = tmail.dequeue(tcfg, tst)
    assert_trees_equal((tuple(jmv), jh, jc), (tuple(tmv), th, tc), "deq.")
    assert_trees_equal(jhand.message_phase(jcfg, jst, jmv),
                       thand.message_phase(tcfg, tst, tmv), "handlers.")
    assert_sim_states_equal(jstep.cycle(jcfg, jst), tstep.cycle(tcfg, tst),
                            "cycle.")


def _random_candidates(cfg, rng, p_send=0.6):
    N, S, W = cfg.num_nodes, cfg.out_slots, cfg.msg_bitvec_words
    send = rng.random((N, S)) < p_send
    planes = dict(
        type=np.where(send, rng.integers(0, 13, (N, S)), int(Msg.NONE)),
        # a few receivers out of range: dropped uncounted
        recv=rng.integers(-1, N + 2, (N, S)),
        sender=np.broadcast_to(np.arange(N)[:, None], (N, S)),
        addr=rng.integers(0, 256, (N, S)),
        value=rng.integers(0, 256, (N, S)),
        second=rng.integers(0, N, (N, S)),
        dirstate=rng.integers(0, 3, (N, S)))
    bv = _words(rng, (N, S, W))
    jc = jmail.Candidates(**{k: jnp.asarray(v, jnp.int32)
                             for k, v in planes.items()},
                          bitvec=jnp.asarray(bv))
    tc = tmail.Candidates(**{k: torch.tensor(np.asarray(v), dtype=torch.int32)
                             for k, v in planes.items()}, bitvec=_port(bv))
    return jc, tc


@pytest.mark.parametrize("qcap,p_send", [(4, 0.9), (32, 0.5)],
                         ids=["overflow", "roomy"])
def test_deliver_matches_jax_and_its_sort_branches(qcap, p_send,
                                                   monkeypatch):
    """Random candidates into part-full rings: the same rings, counts
    and drop count as JAX; the two-sort branch (taken only at very
    large N) gives the same as the fused key."""
    jcfg, tcfg = cfg_pair(32, queue_capacity=qcap)
    rng = np.random.default_rng(qcap)
    st = tstate.init_state(tcfg, device="cpu")
    count = rng.integers(0, qcap + 1, 32).astype(np.int32)
    head = rng.integers(0, qcap, 32).astype(np.int32)
    mb = rng.integers(-5, 300, tuple(st.mb_pack.shape)).astype(np.int32)
    st = st.replace(mb_pack=torch.from_numpy(mb),
                    mb_count=torch.from_numpy(count),
                    mb_head=torch.from_numpy(head))
    jst = jax_sim_state(convert.sim_numpy_leaves(st))
    jc, tc = _random_candidates(jcfg, rng, p_send)
    arb = rng.permutation(32).astype(np.int32)
    nh = rng.integers(0, qcap, 32).astype(np.int32)
    nc = np.minimum(count, rng.integers(0, qcap + 1, 32)).astype(np.int32)
    want = jmail.deliver(jcfg, jst, jc, jnp.asarray(arb), jnp.asarray(nh),
                         jnp.asarray(nc))
    args = (tcfg, st, tc, torch.from_numpy(arb), torch.from_numpy(nh),
            torch.from_numpy(nc))
    got = tmail.deliver(*args)
    assert_trees_equal(want, got, "deliver.")
    assert int(got[1]) > 0 or qcap == 32

    fused = tmail.arrival_order

    def two_sorts(key_recv, prio, valid, span, _fused):
        return fused(key_recv, prio, valid, span, False)

    monkeypatch.setattr(tmail, "arrival_order", two_sorts)
    assert_trees_equal(got, tmail.deliver(*args), "two-sort.")


def test_arrival_order_branches_agree():
    rng = np.random.default_rng(9)
    recv = torch.from_numpy(rng.integers(0, 50, (3, 400)).astype(np.int32))
    prio = torch.from_numpy(np.stack([rng.permutation(400)
                                      for _ in range(3)]).astype(np.int32))
    valid = torch.from_numpy(rng.random((3, 400)) < 0.7)
    a = tmail.arrival_order(recv, prio, valid, 401, True)
    b = tmail.arrival_order(recv, prio, valid, 401, False)
    assert torch.equal(a, b)


@pytest.mark.parametrize("knobs", ["plain", "issue", "admission", "replay"])
def test_instruction_phase_matches_jax(knobs):
    """Random caches and traces, some nodes blocked: the fetch, the
    classification, the requests and the write-through as JAX, with the
    issue gate, the admission window or the order replay on."""
    N, T = 24, 6
    kw = dict(queue_capacity=8, max_instrs=T)
    if knobs == "admission":
        kw["admission_window"] = 8
    jcfg, tcfg = cfg_pair(N, **kw)
    rng = np.random.default_rng(len(knobs))
    ops = rng.integers(0, 2, (N, T)).astype(np.int32)
    addr = ((rng.integers(0, N, (N, T)) << tcfg.block_bits)
            | rng.integers(0, 16, (N, T))).astype(np.int32)
    val = rng.integers(0, 256, (N, T)).astype(np.int32)
    cnt = rng.integers(0, T + 1, N).astype(np.int32)
    init = {}
    if knobs == "issue":
        init = dict(issue_delay=rng.integers(0, 4, N),
                    issue_period=rng.integers(0, 3, N))
    if knobs == "replay":
        init = dict(order_rank=rng.integers(0, 5, (N, T)))
    st = tstate.init_state(tcfg, instr_arrays=(ops, addr, val, cnt),
                           device="cpu", **init)
    ca = np.where(rng.random((N, 4)) < 0.5, addr[:, :4],
                  rng.integers(0, N << 4, (N, 4))).astype(np.int32)
    st = st.replace(
        cache_addr=torch.from_numpy(ca),
        cache_state=torch.from_numpy(rng.integers(0, 4, (N, 4))
                                     .astype(np.int32)),
        instr_idx=torch.from_numpy(rng.integers(-1, T, N).astype(np.int32)),
        waiting=torch.from_numpy(rng.random(N) < 0.2),
        cycle=torch.tensor(5, dtype=torch.int32))
    st.metrics.instrs_retired = torch.tensor(2, dtype=torch.int32)
    jst = jax_sim_state(convert.sim_numpy_leaves(st))
    may = rng.random(N) < 0.8
    want = jfront.instruction_phase(jcfg, jst, jnp.asarray(may))
    got = tfront.instruction_phase(tcfg, st, torch.from_numpy(may))
    assert_trees_equal(want, got, f"{knobs}.")
    assert as_numpy(got[2]["issued"]).any()


def test_push_message_fills_and_drops_like_jax():
    jcfg, tcfg = cfg_pair(4, reference=True, queue_capacity=2)
    jst = jstate.init_state(jcfg)
    tst = tstate.init_state(tcfg, device="cpu")
    for i in range(3):                     # the third one drops
        kw = dict(type=Msg.INV, sender=i, addr=0x10 + i, bitvec=2**31 + i)
        jst = jmail.push_message(jcfg, jst, 2, **kw)
        tst = tmail.push_message(tcfg, tst, 2, **kw)
    assert_sim_states_equal(jst, tst)
    assert int(tst.mb_count[2]) == 2


def test_cycle_captures_of_a_later_slice_raise():
    """The captures ported in slice 11: each returns the JAX contract's
    extra output after the state, in the JAX order, and leaves the state
    equal to the cycle without it."""
    jcfg, tcfg = cfg_pair(4, reference=True)
    st = tstate.init_state(tcfg, device="cpu")
    jst = jstate.init_state(jcfg)
    plain = tstep.cycle(tcfg, st)
    assert dataclasses.is_dataclass(plain)
    kws = {"with_telemetry": dict(with_telemetry=True),
           "with_ledger": dict(with_ledger=True),
           "with_obs": dict(with_ledger=True, with_obs=True),
           "with_profile": dict(with_profile=True)}
    for cap, kw in kws.items():
        if cap == "with_profile":
            kw = dict(kw, prof=tstep.profile_zeros(tcfg, "cpu"))
            jkw = dict(with_profile=True, prof=jstep.profile_zeros(jcfg))
        else:
            jkw = kw
        out = tstep.cycle(tcfg, st, **kw)
        want = jstep.cycle(jcfg, jst, **jkw)
        assert isinstance(out, tuple) and len(out) == 2, cap
        assert_sim_states_equal(plain, out[0])
        assert_trees_equal(want[1], out[1], f"{cap}.")
    out = tstep.cycle(tcfg, st, with_events=True, with_telemetry=True,
                      with_ledger=True)
    assert len(out) == 4 and "fetch" in out[1] and "counters" in out[2]
    assert "enq_accept" in out[3]
    assert int(Op.NOP) == 2


@pytest.mark.parametrize("reference", [True, False],
                         ids=["mailbox", "scatter"])
def test_empty_candidates_match_jax(reference):
    jcfg, tcfg = cfg_pair(8, reference=reference)
    assert_trees_equal(tuple(jmail.empty_candidates(jcfg)),
                       tuple(tmail.empty_candidates(tcfg, "cpu")))
