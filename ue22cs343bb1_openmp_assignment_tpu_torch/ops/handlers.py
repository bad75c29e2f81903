"""The 13 protocol message handlers, vectorized over all nodes.

The port of the JAX package's ``ops/handlers.py``: the ``switch
(msg.type)`` of ``assignment.c:190-618`` as masked, branch-free updates
of each node's own state and candidate out-messages in static slots,
with the reference's five behavioural quirks (the JAX module's
docstring lists them). Sharer words are uint32 patterns in int32.
"""

from __future__ import annotations

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import codec
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.mailbox import MsgView
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
    bit_single, ctz, popcount)
from ue22cs343bb1_openmp_assignment_tpu_torch.types import (CacheState,
                                                            DirState, Msg)

I32 = torch.int32


def select(conds, choices, default):
    """``jnp.select``: the choice of the first true condition, else
    ``default`` (all broadcast together)."""
    out = default
    for c, v in zip(reversed(conds), reversed(choices)):
        out = torch.where(c, v, out)
    return out


def block_of(cfg: SystemConfig, addr):
    """Block index of ``addr``, clamped into [0, M) as a JAX gather
    clamps it (only a mem_size that is not a power of two can leave)."""
    b = codec.block_index(cfg, addr)
    if (1 << cfg.block_bits) > cfg.mem_size:
        b = b.clamp(0, cfg.mem_size - 1)
    return b


def message_phase(cfg: SystemConfig, state, mv: MsgView):
    """All message-handler effects of this cycle.

    Returns (updates, cand_parts, inv_scatter, stats) with the layout of
    the JAX ``message_phase``: per-node write intents (masks and values),
    the primary / secondary / INV / eviction candidate fields, the
    scatter-mode invalidation (mask, addr, bitvec) and the metric masks.
    """
    N, W = cfg.num_nodes, cfg.bitvec_words
    dev = mv.type.device
    rows = torch.arange(N, dtype=I32, device=dev)
    has, t = mv.has_msg, mv.type

    # decode (assignment.c:186-188)
    p_home = codec.home_node(cfg, mv.addr)
    p_block = block_of(cfg, mv.addr)
    p_cidx = codec.cache_index(cfg, mv.addr)

    # own-state gathers
    dirst = state.dir_state[rows, p_block]
    dirbv = state.dir_bitvec[rows, p_block]          # [N, W]
    memv = state.memory[rows, p_block]
    cl_addr = state.cache_addr[rows, p_cidx]
    cl_val = state.cache_val[rows, p_cidx]
    cl_state = state.cache_state[rows, p_cidx]

    def m(ty: int) -> torch.Tensor:
        return has & (t == int(ty))

    is_rr = m(Msg.READ_REQUEST)
    is_rrd = m(Msg.REPLY_RD)
    is_wbint = m(Msg.WRITEBACK_INT)
    is_flush = m(Msg.FLUSH)
    is_upg = m(Msg.UPGRADE)
    is_rid = m(Msg.REPLY_ID)
    is_inv = m(Msg.INV)
    is_wreq = m(Msg.WRITE_REQUEST)
    is_rwr = m(Msg.REPLY_WR)
    is_wbinv = m(Msg.WRITEBACK_INV)
    is_fia = m(Msg.FLUSH_INVACK)
    is_es = m(Msg.EVICT_SHARED)
    is_em = m(Msg.EVICT_MODIFIED)

    at_home = rows == p_home
    sender_bit = bit_single(W, mv.sender)            # [N, W]
    second_bit = bit_single(W, mv.second)
    d_em = dirst == int(DirState.EM)
    d_s = dirst == int(DirState.S)
    d_u = dirst == int(DirState.U)
    owner = ctz(dirbv)                               # current owner if EM

    flush_home = is_flush & at_home
    flush_second = is_flush & (rows == mv.second)
    fia_home = is_fia & at_home
    fia_second = is_fia & (rows == mv.second)

    # EVICT_SHARED home bookkeeping (assignment.c:559-589)
    es_home = is_es & at_home
    es_bv2 = dirbv & ~sender_bit
    es_nsh = popcount(es_bv2)
    es_new_owner = ctz(es_bv2)
    es_promote_self = es_home & (es_nsh == 1) & (es_new_owner == rows)
    es_notify = es_home & (es_nsh == 1) & (es_new_owner != rows)

    # cache fills (REPLY_RD / FLUSH@req / REPLY_ID / REPLY_WR /
    # FLUSH_INVACK@req)
    fill = is_rrd | flush_second | is_rid | is_rwr | fia_second
    fill_val = torch.where(is_rrd | flush_second, mv.value, state.cur_val)
    fill_state = torch.where(
        is_rrd,
        torch.where(mv.dirstate == int(DirState.S), int(CacheState.SHARED),
                    int(CacheState.EXCLUSIVE)),
        torch.where(flush_second, int(CacheState.SHARED),
                    int(CacheState.MODIFIED))).to(I32)

    # eviction of the displaced line: a tag-mismatch check everywhere
    # except REPLY_WR, which replaces unconditionally (no-op on INVALID)
    evict_checked = is_rrd | flush_second | is_rid | fia_second
    live_line = cl_state != int(CacheState.INVALID)
    evict_fire = ((evict_checked & (cl_addr != mv.addr) & live_line)
                  | (is_rwr & live_line))

    # cache state writes
    inv_hits = is_inv & (cl_addr == mv.addr)
    cs_mask = (is_wbint | inv_hits | is_wbinv | (is_es & ~at_home)
               | es_promote_self | fill)
    cs_val = select(
        [fill, is_wbint, inv_hits | is_wbinv],
        [fill_state, int(CacheState.SHARED), int(CacheState.INVALID)],
        torch.full((N,), int(CacheState.EXCLUSIVE), dtype=I32, device=dev))

    # directory writes
    ds_mask = ((is_rr & d_u) | flush_home | is_upg | is_wreq
               | (es_home & (es_nsh <= 1)) | is_em)
    ds_val = select(
        [flush_home, (es_home & (es_nsh == 0)) | is_em],
        [int(DirState.S), int(DirState.U)],
        torch.full((N,), int(DirState.EM), dtype=I32, device=dev))

    dbv_mask = ((is_rr & (d_s | d_u)) | flush_home | is_upg | is_wreq
                | fia_home | es_home | is_em)
    dbv_val = select(
        [((is_rr & d_s) | flush_home)[:, None],
         ((is_rr & d_u) | is_upg | is_wreq)[:, None],
         fia_home[:, None], es_home[:, None]],
        [dirbv | torch.where(flush_home[:, None], second_bit, sender_bit),
         sender_bit, second_bit, es_bv2],
        torch.zeros_like(dirbv))

    # memory writes (assignment.c:307,520,602)
    mem_mask = flush_home | fia_home | is_em

    # waiting flag (quirk 2: FLUSH / FLUSH_INVACK clear it regardless)
    wait_clear = is_rrd | is_flush | is_rid | is_rwr | is_fia

    updates = dict(
        cache_idx=p_cidx, cache_state=(cs_mask, cs_val),
        cache_addr=(fill, mv.addr), cache_val=(fill, fill_val),
        mem=(mem_mask, p_block, mv.value),
        dir_state=(ds_mask, p_block, ds_val),
        dir_bv=(dbv_mask, p_block, dbv_val),
        wait_clear=wait_clear,
    )

    # candidate out-messages
    none = torch.full((N,), int(Msg.NONE), dtype=I32, device=dev)
    zero = torch.zeros((N,), dtype=I32, device=dev)
    zbv = torch.zeros((N, cfg.msg_bitvec_words), dtype=I32, device=dev)
    others_bv = dirbv & ~sender_bit   # UPGRADE / WRITE_REQUEST@S sharers
    grants_em = is_upg | (is_wreq & d_s)

    # primary send (slot 0): each handler's first sendMessage
    pri_mask = is_rr | is_wbint | is_upg | is_wreq | is_wbinv | es_notify
    pri_type = select(
        [is_rr & d_em, is_rr, is_wbint, grants_em, is_wreq & d_u, is_wreq,
         is_wbinv, es_notify],
        [int(Msg.WRITEBACK_INT), int(Msg.REPLY_RD), int(Msg.FLUSH),
         int(Msg.REPLY_ID), int(Msg.REPLY_WR), int(Msg.WRITEBACK_INV),
         int(Msg.FLUSH_INVACK), int(Msg.EVICT_SHARED)], none)
    pri_type = torch.where(pri_mask, pri_type, none)
    pri_recv = select(
        [is_rr & d_em, is_rr | is_upg, is_wbint | is_wbinv,
         is_wreq & d_em, is_wreq, es_notify],
        [owner, mv.sender, p_home, owner, mv.sender, es_new_owner], zero)
    pri_value = select(
        [is_rr & d_em, is_rr, is_wbint | is_wbinv, is_wreq & d_em,
         es_notify],
        [zero, memv, cl_val, mv.value, memv], zero)
    pri_second = select(
        [is_rr & d_em, is_wreq & d_em, is_wbint | is_wbinv],
        [mv.sender, mv.sender, mv.second], zero)
    pri_dirstate = torch.where(is_rr & d_s, int(DirState.S),
                               int(DirState.EM)).to(I32)
    if cfg.inv_mode == "mailbox":
        # REPLY_ID carries the sharers-minus-requester set for the
        # requester's INV fan-out (assignment.c:345,364-373)
        pri_bitvec = torch.where(grants_em[:, None], others_bv, zbv)
    else:
        # scatter mode: the home applies the invalidations itself
        pri_bitvec = zbv

    # secondary send (slot 1): FLUSH / FLUSH_INVACK to the
    # secondReceiver; WRITEBACK_INT dedups home == requester,
    # WRITEBACK_INV does not (quirk 3)
    sec_mask = (is_wbint & (p_home != mv.second)) | is_wbinv
    sec_type = torch.where(
        sec_mask,
        torch.where(is_wbint, int(Msg.FLUSH), int(Msg.FLUSH_INVACK)).to(I32),
        none)

    # INV fan-out (assignment.c:364-373): one slot per potential target
    # in mailbox mode; in scatter mode the home applies it (ops.step)
    if cfg.inv_mode == "mailbox":
        targets = torch.arange(N, dtype=I32, device=dev)
        tw = torch.div(targets, 32, rounding_mode="floor").to(torch.int64)
        bits = (mv.bitvec[:, tw] >> (targets % 32)[None, :]) & 1   # [N, N]
        inv_mask = is_rid[:, None] & (bits == 1)
        inv_type = torch.where(inv_mask, int(Msg.INV),
                               int(Msg.NONE)).to(I32)
        inv_recv = targets[None, :].expand(N, N)
        inv_addr = mv.addr[:, None].expand(N, N)
        inv_scatter = None
    else:
        inv_type = inv_recv = inv_addr = None
        inv_scatter = (grants_em, mv.addr, others_bv)

    # eviction notice (last slot), handleCacheReplacement
    # (assignment.c:767-804): EVICT_MODIFIED carries the dirty value
    ev_mod = evict_fire & (cl_state == int(CacheState.MODIFIED))
    ev_type = torch.where(
        evict_fire,
        torch.where(ev_mod, int(Msg.EVICT_MODIFIED),
                    int(Msg.EVICT_SHARED)).to(I32),
        none)
    ev_value = torch.where(ev_mod, cl_val, 0)

    cand_parts = dict(
        pri=(pri_type, pri_recv, mv.addr, pri_value, pri_second,
             pri_dirstate, pri_bitvec),
        sec=(sec_type, mv.second, mv.addr, cl_val, mv.second),
        inv=(inv_type, inv_recv, inv_addr),
        ev=(ev_type, codec.home_node(cfg, cl_addr), cl_addr, ev_value),
    )
    stats = dict(
        msg_type_onehot=(has, t),
        invalidations=inv_hits,
        evictions=evict_fire,
        unblocked=wait_clear & state.waiting,
    )
    return updates, cand_parts, inv_scatter, stats


# ---------------------------------------------------------------------------
# Row-extraction registry for analysis/protocol_table.py.
#
# TRANSITION_ANCHORS names, per message type, the assignment.c line
# ranges the vectorized handler above transcribes — the same anchors
# each declarative table Row must cite, so verify_table's anchor pass
# can prove the table and this module describe the same reference code
# (a renamed/renumbered handler breaks the cross-check loudly instead
# of silently drifting). QUIRKS is the machine-readable index of the
# five behavioral quirks documented in the module docstring; table rows
# reference them by id.
# ---------------------------------------------------------------------------

TRANSITION_ANCHORS = {
    "READ_REQUEST": ("assignment.c:199-210", "assignment.c:211-236"),
    "WRITE_REQUEST": ("assignment.c:407-421", "assignment.c:423-437",
                      "assignment.c:440-457"),
    "REPLY_RD": ("assignment.c:240-258",),
    "REPLY_WR": ("assignment.c:461-470",),
    "REPLY_ID": ("assignment.c:352-384",),
    "INV": ("assignment.c:389-399",),
    "UPGRADE": ("assignment.c:326-348",),
    "WRITEBACK_INV": ("assignment.c:474-498",),
    "WRITEBACK_INT": ("assignment.c:262-281", "assignment.c:262-286"),
    "FLUSH": ("assignment.c:301-322", "assignment.c:310-322",
              "assignment.c:322"),
    "FLUSH_INVACK": ("assignment.c:510-535", "assignment.c:522-535",
                     "assignment.c:535"),
    "EVICT_SHARED": ("assignment.c:549-558", "assignment.c:559-565",
                     "assignment.c:559-589", "assignment.c:566-589"),
    "EVICT_MODIFIED": ("assignment.c:596-616",),
}

QUIRKS = {
    1: "replies fill from the latched instruction value, not the message",
    2: "FLUSH/FLUSH_INVACK clear waitingForReply unconditionally",
    3: "WRITEBACK_INT dedups the home==requester double-send; "
       "WRITEBACK_INV does not",
    4: "read-miss-on-EM defers the directory update to the FLUSH; "
       "write-miss updates it immediately",
    5: "blind-by-index cache writes (no tag check)",
}
