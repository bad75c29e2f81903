"""Vectorized mailbox: dequeue gather and delivery sort/scatter.

The port of the JAX package's ``ops/mailbox.py``. All N rings live in
one plane-major ``[6 + Wm, N, Q]`` tensor (``state.SimState.mb_pack``).
Per cycle every non-empty node gathers its head message, and every
candidate message carries ``(receiver, priority)`` with priority
``arb_rank[sender] * out_slots + slot``: one sort over all candidates
gives each receiver's arrival order (the seedable stand-in for the
reference's lock-acquisition order, ``assignment.c:741-765``), and one
scatter writes the accepted candidates into the rings. Candidates beyond
a ring's free capacity are dropped and counted (``assignment.c:754-762``,
quirk 6).

Every sort is stable, as ``jnp.argsort`` is. The delivery scatter sends
its dropped lanes to one spare ring row past the last node, which is
sliced off: kept lanes are unique, so the scatter is exact and needs no
host sync. With ``with_accept`` (the message-ledger capture of
``ops.step``), ``deliver`` also returns the final accept mask in the
[N, out_slots] candidate layout, un-permuted by one scatter through the
arrival order (JAX ``ops/mailbox.py:233``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
    MB_ADDR, MB_BV0, MB_DIRSTATE, MB_SECOND, MB_SENDER, MB_TYPE, MB_VALUE)
from ue22cs343bb1_openmp_assignment_tpu_torch.types import Msg
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import random as jr

INT32_MAX = 2**31 - 1
I32 = torch.int32


class MsgView(NamedTuple):
    """Per-node view of this cycle's dequeued message (masked by has_msg)."""

    has_msg: torch.Tensor   # [N] bool
    type: torch.Tensor      # [N] (Msg.NONE where no message)
    sender: torch.Tensor    # [N]
    addr: torch.Tensor      # [N]
    value: torch.Tensor     # [N]
    second: torch.Tensor    # [N]
    dirstate: torch.Tensor  # [N]
    bitvec: torch.Tensor    # [N, Wm] uint32 words as int32 patterns


class Candidates(NamedTuple):
    """Per-(node, out-slot) candidate messages of this cycle; the slot
    order is each sender's program order (config.out_slots)."""

    type: torch.Tensor      # [N, S] (Msg.NONE = no message)
    recv: torch.Tensor      # [N, S]
    sender: torch.Tensor    # [N, S]
    addr: torch.Tensor      # [N, S]
    value: torch.Tensor     # [N, S]
    second: torch.Tensor    # [N, S]
    dirstate: torch.Tensor  # [N, S]
    bitvec: torch.Tensor    # [N, S, Wm]


def empty_candidates(cfg: SystemConfig, device) -> Candidates:
    N, S, W = cfg.num_nodes, cfg.out_slots, cfg.msg_bitvec_words
    z = torch.zeros((N, S), dtype=I32, device=device)
    return Candidates(
        type=torch.full((N, S), int(Msg.NONE), dtype=I32, device=device),
        recv=z, sender=z, addr=z, value=z, second=z, dirstate=z,
        bitvec=torch.zeros((N, S, W), dtype=I32, device=device))


def dequeue(cfg: SystemConfig, state) -> tuple:
    """Gather each node's head message; advance head and count where the
    ring is non-empty (``assignment.c:174-177``). Returns (MsgView,
    new_head, new_count)."""
    N = cfg.num_nodes
    rows = torch.arange(N, dtype=torch.int64, device=state.mb_head.device)
    has = state.mb_count > 0
    h = state.mb_head
    row = state.mb_pack[:, rows, torch.where(has, h, 0)]       # [P, N]
    view = MsgView(
        has_msg=has,
        type=torch.where(has, row[MB_TYPE], int(Msg.NONE)),
        sender=row[MB_SENDER], addr=row[MB_ADDR], value=row[MB_VALUE],
        second=row[MB_SECOND], dirstate=row[MB_DIRSTATE],
        bitvec=row[MB_BV0:].T)
    new_head = torch.where(has, (h + 1) % cfg.queue_capacity, h)
    new_count = state.mb_count - has.to(I32)
    return view, new_head, new_count


def candidate_prio(cfg: SystemConfig, arb_rank) -> torch.Tensor:
    """[N, S] global delivery priority: the sender's arbitration rank,
    then the program-order slot."""
    S = cfg.out_slots
    return (arb_rank.to(I32)[:, None] * S
            + torch.arange(S, dtype=I32, device=arb_rank.device)[None, :])


def pack_candidates(cand: Candidates) -> torch.Tensor:
    """[6 + Wm, N, S] payload planes, the layout the ring scatter writes
    (shared with the routed transports)."""
    flat = torch.stack([cand.type, cand.sender, cand.addr, cand.value,
                        cand.second, cand.dirstate], dim=0)
    return torch.cat([flat, cand.bitvec.movedim(-1, 0)], dim=0)


def segment_ranks(bucket: torch.Tensor, valid: torch.Tensor) -> tuple:
    """(rank, seg_start) of each row within its run of equal buckets,
    along the last axis. ``bucket``/``valid`` are sorted so that equal
    buckets are adjacent and invalid rows last; an invalid row is a run
    of its own."""
    F = bucket.shape[-1]
    idx = torch.arange(F, dtype=torch.int64, device=bucket.device)
    first = torch.ones(bucket.shape[:-1] + (1,), dtype=torch.bool,
                       device=bucket.device)
    is_start = torch.cat(
        [first, (bucket[..., 1:] != bucket[..., :-1]) | ~valid[..., 1:]],
        dim=-1)
    seg_start = torch.cummax(
        torch.where(is_start, idx, -1), dim=-1).values
    return (idx - seg_start).to(I32), seg_start


def arrival_order(key_recv, prio, valid, span: int,
                  fused: bool) -> torch.Tensor:
    """Stable argsort along the last axis by (receiver, prio), invalid
    rows last: one sort of the fused int32 key ``recv * span + prio``
    when it fits (``fused``), else two stable sorts, prio first."""
    if fused:
        key = torch.where(valid, key_recv * span + prio, INT32_MAX)
        return torch.argsort(key, dim=-1, stable=True)
    order1 = torch.argsort(torch.where(valid, prio, INT32_MAX), dim=-1,
                           stable=True)
    key2 = torch.where(torch.gather(valid, -1, order1),
                       torch.gather(key_recv, -1, order1), INT32_MAX)
    return torch.gather(order1, -1, torch.argsort(key2, dim=-1,
                                                  stable=True))


def ring_scatter(mb_pack, mb_count, tgt_r, tgt_p, accept, pack):
    """Write ``pack`` [P, F] into the rings at (tgt_r, tgt_p) [F] and add
    ``accept`` to the counts; dropped lanes carry tgt_r == N (the spare
    row, sliced off). Kept lanes are unique.

    The store goes through a plane-last view so that the indexed axes
    lead, and the counts through ``scatter_add_``: the same writes and
    adds as a leading-slice store and ``index_add_``, in the forms that
    ``torch.func.vmap`` batches as one launch each (the serving layer's
    wave runs ``cycle`` over a job axis; vmap runs ``index_add_`` with a
    batched index once per job)."""
    P, N, Q = mb_pack.shape
    out = torch.cat([mb_pack, mb_pack.new_zeros((P, 1, Q))], dim=1)
    out.permute(1, 2, 0)[tgt_r.to(torch.int64),
                         tgt_p.to(torch.int64)] = pack.transpose(0, 1)
    cnt = torch.cat([mb_count, mb_count.new_zeros(1)])
    cnt.scatter_add_(0, tgt_r.to(torch.int64), accept.to(I32))
    return out[:, :N], cnt[:N]


def deliver(cfg: SystemConfig, state, cand: Candidates, arb_rank,
            new_head, new_count, *, with_accept: bool = False) -> tuple:
    """Scatter candidates into the rings with deterministic arbitration
    (lower arb_rank enqueues first at every receiver). Returns (state
    updates dict, dropped count, injected count) as the JAX deliver.

    With ``with_accept=True`` the updates dict also carries
    ``enq_accept``: the final per-candidate accept mask (after capacity
    and fault drops) scattered back to the [N, S] (sender, slot) layout,
    for the message ledger (``ops.step.cycle(with_ledger=True)``); the
    caller pops it before ``state.replace``.

    When cfg.drop_prob > 0, each otherwise-accepted message is dropped
    with that probability (fault injection): ``state.fault_key`` splits
    into a draw key and the next key, a Bernoulli draw over the sorted
    candidates drops the hits, and the survivors are re-ranked within
    their receiver's run so the ring writes stay dense."""
    N, S, Q = cfg.num_nodes, cfg.out_slots, cfg.queue_capacity
    F = N * S
    c_type = cand.type.reshape(F)
    recv = cand.recv.reshape(F)
    # out-of-range receivers (the ctz sentinel of an empty sharer set)
    # are dropped here, uncounted
    valid = (c_type != int(Msg.NONE)) & (recv >= 0) & (recv < N)
    prio = candidate_prio(cfg, arb_rank).reshape(F)
    order = arrival_order(recv, prio, valid, F + 1,
                          N * (F + 1) + F < 2**31)
    r_s = recv[order]
    v_s = valid[order]
    rank, seg_start = segment_ranks(r_s, v_s)
    # capacity: free slots after this cycle's dequeue
    safe_r = torch.where(v_s, r_s, 0).to(torch.int64)
    accept = v_s & (rank < (Q - new_count)[safe_r])
    dropped = (v_s & ~accept).sum(dtype=I32)
    fault_key = state.fault_key
    injected = torch.zeros((), dtype=I32, device=dropped.device)
    if cfg.drop_prob > 0.0:
        k_draw, fault_key = jr.split(fault_key)
        hit = accept & jr.bernoulli(k_draw, cfg.drop_prob, accept.shape)
        injected = hit.sum(dtype=I32)
        accept = accept ^ hit
        # seg_start >= 0 everywhere (a run starts at row 0)
        excl = torch.cumsum(accept, 0, dtype=I32) - accept.to(I32)
        rank = excl - excl[seg_start]
    pos = (new_head[safe_r] + new_count[safe_r] + rank) % Q
    pack = pack_candidates(cand).reshape(-1, F)[:, order]
    mb_pack, mb_count = ring_scatter(
        state.mb_pack, new_count, torch.where(accept, r_s, N),
        torch.where(accept, pos, 0), accept, pack)
    updates = dict(mb_pack=mb_pack, mb_head=new_head, mb_count=mb_count,
                   fault_key=fault_key)
    if with_accept:
        # undo the arbitration sort: accept[i] belongs to candidate
        # order[i] (a permutation, so the scatter is exact)
        acc = torch.zeros(F, dtype=torch.bool, device=accept.device)
        acc[order] = accept
        updates["enq_accept"] = acc.reshape(N, S)
    return updates, dropped, injected


def push_message(cfg: SystemConfig, state, receiver: int, *, type,
                 sender=0, addr=0, value=0, second=0, dirstate=0,
                 bitvec=0):
    """Host-side single-message enqueue (test and debug injection): the
    tail append of ``sendMessage`` (``assignment.c:751-764``); a full
    ring drops silently, like the reference."""
    r = receiver
    count = int(state.mb_count[r])
    if count >= cfg.queue_capacity:
        return state
    tail = (int(state.mb_head[r]) + count) % cfg.queue_capacity
    words = [(int(bitvec) >> (32 * w)) & 0xFFFFFFFF
             for w in range(cfg.msg_bitvec_words)]
    row = [int(type), int(sender), int(addr), int(value), int(second),
           int(dirstate)] + [w - (1 << 32) if w >> 31 else w for w in words]
    mb_pack = state.mb_pack.clone()
    mb_pack[:, r, tail] = torch.tensor(row, dtype=I32,
                                       device=mb_pack.device)
    mb_count = state.mb_count.clone()
    mb_count[r] += 1
    return state.replace(mb_pack=mb_pack, mb_count=mb_count)
