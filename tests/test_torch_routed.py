"""Routed phase-3 delivery: the port's transports against the JAX
package's, exactly.

The pure pieces one to one (``bucket_lanes`` per shard, ``_pack_lanes``,
``_unpack_lanes``, ``wire_bytes``) and the routers' inbound lanes
against the JAX ``make_router`` (the all_to_all router on 8 virtual
devices). The contract of tests/test_shardmap_comm.py's routed-delivery
test: ``make_transport_runner`` over 8 shards, with both transports (the
ring kernel's plain version on the CPU), leaves every SimState leaf equal
to the unsharded JAX ``step.run_cycles``. Lane-cap truncation is counted
as dropped; one shard runs the cycle unrouted and says so.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu.models.system import (
    CoherenceSystem as JaxSystem)
from ue22cs343bb1_openmp_assignment_tpu.ops import mailbox as jmail
from ue22cs343bb1_openmp_assignment_tpu.ops import step as jstep
from ue22cs343bb1_openmp_assignment_tpu.parallel import rdma_comm as jrdma
from ue22cs343bb1_openmp_assignment_tpu.parallel import (
    shardmap_comm as jsm)
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import mailbox as tmail
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step as tstep
from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import (
    mesh, rdma_comm, ring_kernel, sharded_step, shardmap_comm)

from tests.test_torch_async_units import _random_candidates
from tests.torch_parity import (assert_sim_states_equal, assert_trees_equal,
                                cfg_pair)

N, D = 64, 8


def _lanes_inputs(cap=None, seed=0):
    """Random candidates of a 64-node machine: (jax cfg, port cfg, JAX
    and port (ctype, recv, prio, fields), lane geometry)."""
    jcfg, tcfg = cfg_pair(N, queue_capacity=32)
    rng = np.random.default_rng(seed)
    jc, tc = _random_candidates(jcfg, rng)
    arb = rng.permutation(N).astype(np.int32)
    jprio = jmail.candidate_prio(jcfg, jnp.asarray(arb))
    tprio = tmail.candidate_prio(tcfg, torch.from_numpy(arb))
    L, S = N // D, tcfg.out_slots
    geo = dict(N=N, D=D, L=L, cap=cap if cap is not None else L * S,
               Fw=6 + tcfg.msg_bitvec_words)
    return (jcfg, tcfg, (jc.type, jc.recv, jprio, jsm.pack_fields(jc)),
            (tc.type, tc.recv, tprio, shardmap_comm.pack_fields(tc)), geo)


@pytest.mark.parametrize("cap", [None, 3], ids=["lossless", "cap3"])
def test_bucket_pack_unpack_match_jax_per_shard(cap):
    """Shard by shard, the batched bucketing equals JAX's per-shard
    ``bucket_lanes`` (truncation counts included), and the wire image
    packs and unpacks the same."""
    _, _, jin, tin, geo = _lanes_inputs(cap)
    L = geo["L"]
    got = shardmap_comm.bucket_lanes(
        *shardmap_comm.shard_planes(D, L, *tin), **geo)
    packed = rdma_comm._pack_lanes(*got[:4])
    for s in range(D):
        rows = slice(s * L, (s + 1) * L)
        want = jsm.bucket_lanes(*(x[rows] for x in jin), **geo)
        assert_trees_equal(want, tuple(x[s] for x in got), f"shard {s}.")
        jpacked = jrdma._pack_lanes(*want[:4])
        assert_trees_equal(jpacked, packed[s], f"pack {s}.")
        assert_trees_equal(jrdma._unpack_lanes(jpacked),
                           rdma_comm._unpack_lanes(packed[s]),
                           f"unpack {s}.")
    if cap is not None:
        assert int(got[4].sum()) > 0


def test_wire_bytes_match_jax():
    for nodes, shards in ((64, 8), (256, 8), (64, 2), (4096, 4)):
        jcfg, tcfg = cfg_pair(nodes)
        for transport in ("rdma", "all_to_all"):
            for cap in (None, 5):
                assert rdma_comm.wire_bytes(tcfg, shards, cap, transport) \
                    == jrdma.wire_bytes(jcfg, shards, cap, transport)
    with pytest.raises(ValueError):
        rdma_comm.wire_bytes(cfg_pair(64)[1], 7)


@pytest.mark.parametrize("cap", [None, 3], ids=["lossless", "cap3"])
def test_routers_match_jax_all_to_all_router(cap):
    """The inbound lane pools of the port's all_to_all and rdma routers
    equal the JAX all_to_all router's on 8 virtual devices, field by
    field (the ring's plain version does the rdma exchange here)."""
    if len(jax.devices()) < D:
        pytest.skip("needs 8 (virtual) JAX devices")
    from ue22cs343bb1_openmp_assignment_tpu.parallel import make_mesh
    jcfg, tcfg, jin, tin, _ = _lanes_inputs(cap, seed=4)
    want = jsm.make_router(jcfg, make_mesh(jax.devices()[:D]),
                           lane_cap=cap)(*jin)
    layout = mesh.make_layout(N, D, device="cpu")
    for make in (shardmap_comm.make_router, rdma_comm.make_rdma_router):
        got = make(tcfg, layout, lane_cap=cap)(*tin)
        assert_trees_equal(
            tuple(want),
            (got.valid.reshape(-1), got.recv.reshape(-1),
             got.prio.reshape(-1),
             got.fields.reshape(-1, got.fields.shape[-1]), got.truncated),
            f"{make.__name__}.")


@pytest.mark.parametrize("transport", ["rdma", "all_to_all"])
def test_transport_runner_matches_unsharded_jax(transport):
    """16 cycles at 64 nodes over 8 shards: every leaf equal to the
    unsharded JAX run (the uniform workload, made by the JAX package and
    carried across)."""
    jcfg, tcfg = cfg_pair(N, queue_capacity=32, max_instrs=8,
                          transport=transport)
    jsys = JaxSystem.from_workload(jcfg, "uniform", trace_len=8, seed=3)
    want = jstep.run_cycles(jcfg, jsys.state, 16)
    start = convert.sim_from_numpy(tcfg, convert.sim_numpy_leaves(
        jsys.state), device="cpu")
    run = sharded_step.make_transport_runner(
        tcfg, mesh.make_layout(N, D, device="cpu"), 16)
    assert run.transport == transport
    before = ring_kernel.exchange.launches
    assert_sim_states_equal(want, run(start))
    assert ring_kernel.exchange.launches == before    # the CPU: plain
    one = sharded_step.make_transport_cycle(
        tcfg, mesh.make_layout(N, D, device="cpu"))
    assert one.transport == transport
    assert_sim_states_equal(jstep.cycle(jcfg, jsys.state), one(start))


def test_local_enqueue_sort_branches_agree(monkeypatch):
    """The two-stable-sort branch (taken only where the fused key leaves
    int32) enqueues exactly as the fused key."""
    _, tcfg = cfg_pair(N, queue_capacity=2)
    sys_ = tstep.run_cycles(tcfg, _port_uniform(tcfg), 6)
    layout = mesh.make_layout(N, D, device="cpu")
    fused = sharded_step.make_transport_runner(tcfg, layout, 10)(sys_)
    orig = rdma_comm.arrival_order
    monkeypatch.setattr(rdma_comm, "arrival_order",
                        lambda r, p, v, span, _f: orig(r, p, v, span, False))
    two = sharded_step.make_transport_runner(tcfg, layout, 10)(sys_)
    assert_trees_equal(convert.sim_numpy_leaves(fused),
                       convert.sim_numpy_leaves(two))
    assert int(fused.metrics.msgs_dropped) > 0


def _port_uniform(tcfg, trace_len=8):
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    return CoherenceSystem.from_workload(
        dataclasses.replace(tcfg, max_instrs=trace_len),
        "procedural_uniform", device="cpu").state


def test_lane_cap_truncation_counts_as_dropped():
    """A lane cap below a shard's out-slots truncates in priority order;
    routed delivery counts the truncated rows as dropped messages."""
    _, tcfg = cfg_pair(N, queue_capacity=64, max_instrs=8)
    st = tstep.run_cycles(tcfg, _port_uniform(tcfg), 3)
    layout = mesh.make_layout(N, D, device="cpu")
    got = {}

    def capture(cfg_, state, cand, arb_rank, new_head, new_count):
        got["trunc"] = rdma_comm.outbox_lanes(cfg_, layout, cand, arb_rank,
                                              lane_cap=1)[4]
        return rdma_comm.make_routed_deliver(cfg_, layout, lane_cap=1)(
            cfg_, state, cand, arb_rank, new_head, new_count)

    after = tstep.cycle(tcfg, st, deliver_fn=capture)
    truncated = int(got["trunc"].sum())
    assert truncated > 0
    assert int(after.metrics.msgs_dropped - st.metrics.msgs_dropped) \
        == truncated
    lossless = tstep.cycle(tcfg, st, deliver_fn=rdma_comm.make_routed_deliver(
        tcfg, layout))
    assert int(lossless.metrics.msgs_dropped) == int(st.metrics.msgs_dropped)


def test_one_shard_or_drop_prob_runs_unrouted():
    _, tcfg = cfg_pair(N, queue_capacity=32, max_instrs=8)
    st = _port_uniform(tcfg)
    one = sharded_step.make_transport_runner(
        tcfg, mesh.make_layout(N, 1, device="cpu"), 5)
    assert one.transport == "none"
    assert_trees_equal(convert.sim_numpy_leaves(one(st)),
                       convert.sim_numpy_leaves(tstep.run_cycles(tcfg, st,
                                                                 5)))
    faulty = dataclasses.replace(tcfg, drop_prob=0.25)
    layout = mesh.make_layout(N, D, device="cpu")
    assert not rdma_comm.supported(faulty)
    assert sharded_step.make_transport_runner(faulty, layout,
                                              1).transport == "none"
    with pytest.raises(ValueError, match="drop_prob"):
        rdma_comm.make_routed_deliver(faulty, layout)
    with pytest.raises(ValueError, match="transport"):
        rdma_comm.make_routed_deliver(tcfg, layout, transport="gspmd")
    with pytest.raises(ValueError, match="shard"):
        mesh.make_layout(N, 7, device="cpu")
    assert rdma_comm.native(torch.device("cuda")) and not rdma_comm.native(
        st.cycle)


@pytest.mark.parametrize("shape", [(1, 1, 5, 9), (4, 4, 7, 7),
                                   (8, 8, 3, 9)])
def test_ring_plain_versions(shape):
    """On the CPU both forms of the exchange run their plain versions:
    inbox[d][s] = outbox[s][d], no launch counted."""
    g = torch.Generator().manual_seed(1)
    ob = torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                       dtype=torch.int32)
    before = ring_kernel.exchange.launches
    ib = ring_kernel.exchange(ob)
    for s in range(shape[0]):
        for d in range(shape[0]):
            assert torch.equal(ib[d, s], ob[s, d])
    assert torch.equal(ring_kernel.exchange(ob, impl="plain"), ib)
    across = ring_kernel.exchange_across(list(ob.unbind(0)))
    assert all(torch.equal(a, b) for a, b in zip(across, ib.unbind(0)))
    assert ring_kernel.exchange.launches == before
    with pytest.raises(ValueError, match="impl"):
        ring_kernel.exchange(ob, impl="fast")
    assert ring_kernel.io_contract_bytes(*shape[1:]) == (
        (4 * ob.numel(),) * 2)
