"""The rdma mailbox transport: lane exchange by the ring kernel and the
home-shard enqueue.

The port of the JAX package's ``parallel/rdma_comm.py``. Each shard
packs its outbox lanes into ONE ``[D, cap, 2 + Fw]`` int32 wire image
(column 0 the receiver with -1 for an empty row, column 1 the
arbitration priority, then the payload), the lane exchange moves it
(``ring_kernel.exchange``, the CUDA kernel on a card), and each shard
enqueues what it received with the exact shard-local image of
``ops.mailbox.deliver``. A cycle's writes other than delivery are all
own-row, so phase-3 delivery is the only cross-shard traffic, and
``make_routed_deliver`` swaps in for ``mailbox.deliver`` alone (the
``deliver_fn`` of ``ops.step.cycle``). Every receiver is owned by one
shard and ``prio`` is a global total order, so the rings come out bit
for bit as the unsharded delivery leaves them.

The shards of a ``parallel.mesh.ShardLayout`` share the state's device:
the D shards are virtual, and every per-shard step (bucketing, exchange,
enqueue) runs once over a leading shard axis. Both transports share one
router (``shardmap_comm.make_router``); rdma hands it ``ring_lanes`` as
its exchange. Placing shards of the state on several cards is a later
slice; the kernel's across-cards form is
``ring_kernel.exchange_across``.
"""

from __future__ import annotations

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.mailbox import (
    arrival_order, candidate_prio, ring_scatter, segment_ranks)
from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import ring_kernel
from ue22cs343bb1_openmp_assignment_tpu_torch.parallel.mesh import (
    ShardLayout)
from ue22cs343bb1_openmp_assignment_tpu_torch.parallel.shardmap_comm import (
    bucket_lanes, geometry, make_router, pack_fields, shard_planes)

I32 = torch.int32
TRANSPORTS = ("rdma", "all_to_all")


def supported(cfg: SystemConfig) -> bool:
    """Can the routed transports deliver this config? Fault injection
    draws one global sequence in arbitration order, which a per-shard
    delivery cannot reproduce, so routing needs drop_prob 0."""
    return cfg.drop_prob == 0.0


def native(x) -> bool:
    """Does the ring kernel run natively for ``x`` (a tensor or a
    device): is it on a CUDA device? Elsewhere the wrappers run the
    plain version."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    return dev.type == "cuda"


def wire_bytes(cfg: SystemConfig, n_shards: int,
               lane_cap: int | None = None,
               transport: str = "rdma") -> int:
    """Bytes of the D * (D - 1) non-self lanes of one exchange: an
    all_to_all row is 3 + Fw words (a widened valid plane, recv, prio,
    payload), an rdma row 2 + Fw (validity rides in recv's -1)."""
    if cfg.num_nodes % n_shards:
        raise ValueError(
            f"{cfg.num_nodes} nodes do not shard over {n_shards} devices")
    L = cfg.num_nodes // n_shards
    cap = lane_cap if lane_cap is not None else L * cfg.out_slots
    Fw = 6 + cfg.msg_bitvec_words
    words = {"all_to_all": 3 + Fw, "rdma": 2 + Fw}[transport]
    return n_shards * (n_shards - 1) * cap * words * 4


def _pack_lanes(ob_valid, ob_recv, ob_prio, ob_fields) -> torch.Tensor:
    """[..., cap, 2 + Fw] wire image: recv (-1 = invalid), prio, payload."""
    return torch.cat([torch.where(ob_valid, ob_recv, -1)[..., None],
                      ob_prio[..., None], ob_fields], dim=-1)


def _unpack_lanes(ib) -> tuple:
    """Invert :func:`_pack_lanes`; invalid rows decode to (False, 0, 0,
    0...), the all_to_all router's zero-filled lanes."""
    recv = ib[..., 0]
    valid = recv >= 0
    return valid, torch.where(valid, recv, 0), ib[..., 1], ib[..., 2:]


def _local_enqueue(N: int, L: int, S: int, Q: int, ib_valid, ib_recv,
                   ib_prio, ib_fields, mb_pack, new_head, new_count):
    """The shard-local image of ``mailbox.deliver``'s enqueue, for every
    shard at once.

    ``ib_*`` are the D inbox pools ([D, F] rows, [D, F, Fw] payload; every
    receiver of pool d is owned by shard d); ``mb_pack``, ``new_head``
    and ``new_count`` are the whole machine's. Per shard: the same sort
    key (fused when it fits int32, else two stable sorts), segment
    ranks, capacity test and ring positions as deliver, with receivers
    rebased to local rows. Returns (mb_pack, mb_count, dropped [D])."""
    D, F = ib_valid.shape
    dev = ib_valid.device
    base = (torch.arange(D, dtype=I32, device=dev) * L)[:, None]
    lr = torch.where(ib_valid, ib_recv - base, L)        # local receiver
    prio_span = N * S                                    # prio < N * S
    order = arrival_order(lr, ib_prio, ib_valid, prio_span,
                          (L + 1) * prio_span + prio_span < 2**31)
    r_s = torch.gather(lr, 1, order)
    v_s = torch.gather(ib_valid, 1, order)
    rank, _ = segment_ranks(r_s, v_s)
    g = (base + torch.where(v_s, r_s, 0)).to(torch.int64)   # global row
    accept = v_s & (rank < (Q - new_count)[g])
    dropped = (v_s & ~accept).sum(1, dtype=I32)
    pos = (new_head[g] + new_count[g] + rank) % Q
    Fw = ib_fields.shape[-1]
    pack = torch.gather(ib_fields, 1, order[..., None].expand(D, F, Fw))
    mb_pack, mb_count = ring_scatter(
        mb_pack, new_count, torch.where(accept, g, N).reshape(-1),
        torch.where(accept, pos, 0).reshape(-1), accept.reshape(-1),
        pack.reshape(D * F, Fw).T)
    return mb_pack, mb_count, dropped


def outbox_lanes(cfg: SystemConfig, layout: ShardLayout, cand, arb_rank,
                 lane_cap: int | None = None) -> tuple:
    """Every shard's outbox lanes for one cycle's candidates: the
    (ob_valid, ob_recv, ob_prio, ob_fields, truncated) of
    ``bucket_lanes``; ``_pack_lanes(*lanes[:4])`` is the ring kernel's
    input."""
    D, N, S, L, cap, Fw = geometry(cfg, layout, lane_cap)
    prio = candidate_prio(cfg, arb_rank)
    return bucket_lanes(*shard_planes(D, L, cand.type, cand.recv, prio,
                                      pack_fields(cand)),
                        N=N, D=D, L=L, cap=cap, Fw=Fw)


def ring_lanes(ob) -> tuple:
    """The rdma lane exchange of the four outbox lane tensors: pack them
    into the wire image, exchange it (the ring kernel on a card), unpack
    the inboxes."""
    return _unpack_lanes(ring_kernel.exchange(_pack_lanes(*ob)))


def make_rdma_router(cfg: SystemConfig, layout: ShardLayout,
                     lane_cap: int | None = None):
    """Build ``route(ctype, recv, prio, fields) -> RoutedMsgs``: the
    all_to_all router with its exchange replaced by the ring kernel on
    the packed wire image (bit-identical output)."""
    return make_router(cfg, layout, lane_cap, exchange=ring_lanes)


def make_routed_deliver(cfg: SystemConfig, layout: ShardLayout,
                        lane_cap: int | None = None,
                        transport: str | None = None):
    """Build a ``deliver_fn`` for ``ops.step.cycle``: routed phase-3
    delivery. The router of ``transport`` (default ``cfg.transport``:
    "rdma", the ring kernel on the wire image, or "all_to_all", the
    plain exchange of the four lane tensors), then the shard-local
    enqueue. Same return as ``mailbox.deliver``. Lane-cap truncation
    counts as dropped (0 at the lossless default cap)."""
    if not supported(cfg):
        raise ValueError(
            "routed delivery requires cfg.drop_prob == 0 (the global "
            "fault-injection draw order cannot be reproduced per shard)")
    D, N, S, L, cap, Fw = geometry(cfg, layout, lane_cap)
    transport = transport if transport is not None else cfg.transport
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, not "
                         f"{transport!r}")
    route = {"rdma": make_rdma_router, "all_to_all": make_router}[
        transport](cfg, layout, lane_cap)
    Q = cfg.queue_capacity

    def deliver_fn(cfg_, state, cand, arb_rank, new_head, new_count):
        r = route(cand.type, cand.recv, candidate_prio(cfg_, arb_rank),
                  pack_fields(cand))
        mb_pack, mb_count, enq_dropped = _local_enqueue(
            N, L, S, Q, r.valid, r.recv, r.prio, r.fields, state.mb_pack,
            new_head, new_count)
        dropped = enq_dropped.sum(dtype=I32) + r.truncated
        updates = dict(mb_pack=mb_pack, mb_head=new_head,
                       mb_count=mb_count, fault_key=state.fault_key)
        return updates, dropped, torch.zeros((), dtype=I32,
                                             device=dropped.device)

    deliver_fn.transport = transport
    return deliver_fn
