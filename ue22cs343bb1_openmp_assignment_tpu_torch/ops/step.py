"""The message-level cycle and its runners.

The port of the JAX package's ``ops/step.py``. One ``cycle`` is one trip
around the reference's per-thread event loop (``assignment.c:165-737``)
for every node at once:

  phase 1  every node with a queued message dequeues one and runs its
           handler (``ops.handlers``);
  phase 2  every idle, unblocked node fetches one instruction
           (``ops.frontend``); a node never does both in one cycle;
  phase 3  all candidate messages are delivered by one arbitration-
           sorted scatter (``ops.mailbox.deliver``, or a ``deliver_fn``
           such as the routed transports of ``parallel.rdma_comm``), and
           in scatter INV mode the homes' invalidations are applied.

The runners are Python loops over cycles. ``run_chunked_to_quiescence``
reads the quiescence flag (one host sync) only between ``chunk``-cycle
blocks, where the JAX runner's ``while_loop`` tests it, so cycle counts
agree with the reference; ``run_to_quiescence`` is chunk 1.

Only the packed commit of the JAX cycle is ported (its ``_PACKED_COMMIT``
seam serves the JAX index auditor). Each family's row commit is a
one-hot ``where`` over the row's columns: the same writes as the JAX
drop-scatter, whose kept lanes are one per node. ``run_cycles_traced``
stacks the per-cycle event record. The telemetry, ledger, obs and
profile captures are a later slice.
"""

from __future__ import annotations

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import codec
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (frontend, handlers,
                                                          mailbox)
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (LAT_BUCKETS,
                                                            SimState,
                                                            floor_log2)
from ue22cs343bb1_openmp_assignment_tpu_torch.types import CacheState

I32 = torch.int32
_LATER = ("with_telemetry", "with_ledger", "with_obs", "with_profile")


def cycle(cfg: SystemConfig, state: SimState, with_events: bool = False,
          message_phase=None, with_telemetry: bool = False,
          with_ledger: bool = False, with_obs: bool = False,
          deliver_fn=None, with_profile: bool = False, prof=None):
    """Advance the whole machine by one cycle (the JAX signature).

    ``with_events=True`` also returns this cycle's event record (per-node
    fetches and dequeues, the data of the reference's ``DEBUG_INSTR`` /
    ``DEBUG_MSG`` tracing) as a dict of [N] tensors: ``(state, events)``.
    ``message_phase`` overrides the handler phase; ``deliver_fn``
    overrides phase-3 delivery (the contract of ``mailbox.deliver``).
    The other captures raise NotImplementedError.
    """
    later = [name for name, on in zip(
        _LATER, (with_telemetry, with_ledger, with_obs, with_profile)) if on]
    if later:
        raise NotImplementedError(
            f"{', '.join(later)}: the telemetry, ledger, obs and profile "
            "captures are a later slice of the port (ROADMAP.md slice 8)")
    if message_phase is None:
        message_phase = handlers.message_phase
    N, C, M = cfg.num_nodes, cfg.cache_size, cfg.mem_size
    dev = state.cycle.device
    rows = torch.arange(N, dtype=I32, device=dev)

    # phase 1: message handlers
    mv, new_head, new_count = mailbox.dequeue(cfg, state)
    m_upd, m_cand, inv_scatter, m_stats = message_phase(cfg, state, mv)

    # phase 2: instruction frontend (message-idle, unblocked nodes)
    may_issue = ~mv.has_msg & ~state.waiting
    f_upd, f_req, f_stats = frontend.instruction_phase(cfg, state,
                                                       may_issue)

    # merge write intents (disjoint by node: message XOR instruction)
    has = mv.has_msg
    cidx = torch.where(has, m_upd["cache_idx"], f_upd["cache_idx"])
    c_hot = cidx[:, None] == torch.arange(C, dtype=I32, device=dev)

    def commit(plane, key):
        (mm, mval), (fm, fval) = m_upd[key], f_upd[key]
        mask = torch.where(has, mm, fm)
        val = torch.where(has, mval, fval)
        return torch.where(c_hot & mask[:, None], val[:, None], plane)

    cache_state = commit(state.cache_state, "cache_state")
    cache_addr = commit(state.cache_addr, "cache_addr")
    cache_val = commit(state.cache_val, "cache_val")

    # memory / directory: the handlers emit one block index for all
    # three (p_block); the first set mask's index is authoritative
    mm, mi, mval = m_upd["mem"]
    dm, di, dval = m_upd["dir_state"]
    bm, bi, bval = m_upd["dir_bv"]
    hidx = torch.where(mm, mi, torch.where(dm, di, bi))
    h_hot = hidx[:, None] == torch.arange(M, dtype=I32, device=dev)
    memory = torch.where(h_hot & mm[:, None], mval[:, None], state.memory)
    dir_state = torch.where(h_hot & dm[:, None], dval[:, None],
                            state.dir_state)
    dir_bitvec = torch.where((h_hot & bm[:, None])[..., None],
                             bval[:, None, :], state.dir_bitvec)

    waiting = (state.waiting & ~m_upd["wait_clear"]) | f_upd["wait_set"]
    # stall-watchdog input: the cycle the current wait began (-1 idle)
    waiting_since = torch.where(
        waiting,
        torch.where(f_upd["wait_set"], state.cycle, state.waiting_since),
        -1)

    fetch, l_op, l_addr, l_val = f_upd["latch"]
    cur_op = torch.where(fetch, l_op, state.cur_op)
    cur_addr = torch.where(fetch, l_addr, state.cur_addr)
    cur_val = torch.where(fetch, l_val, state.cur_val)

    cand = assemble_candidates(cfg, mv, m_cand, f_req, rows)

    # phase 3: delivery
    deliver = deliver_fn if deliver_fn is not None else mailbox.deliver
    mb_upd, dropped, injected = deliver(cfg, state, cand, state.arb_rank,
                                        new_head, new_count)

    # scatter-mode INV application: a broadcast for address a comes only
    # from home(a), which handles one message a cycle, so each cached
    # line needs one lookup at its home
    inv_applied = torch.zeros((), dtype=I32, device=dev)
    if inv_scatter is not None:
        im, ia, ibv = inv_scatter                  # [N], [N], [N, W]
        h = codec.home_node(cfg, cache_addr).clamp(0, N - 1)    # [N, C]
        active = im[h] & (ia[h] == cache_addr)     # the sentinel never hits
        tw = torch.div(rows, 32, rounding_mode="floor")[:, None].expand(N, C)
        word = ibv[h, tw]                          # [N, C]
        kill = active & (((word >> (rows % 32)[:, None]) & 1) == 1)
        kill_live = kill & (cache_state != int(CacheState.INVALID))
        inv_applied = kill_live.sum(dtype=I32)
        cache_state = torch.where(kill, int(CacheState.INVALID),
                                  cache_state)

    # metrics: one stacked reduction of every per-node delta
    mt = state.metrics
    has_t, t = m_stats["msg_type_onehot"]
    K = mt.msgs_processed.shape[0]
    type_onehot = ((torch.arange(K, dtype=I32, device=dev)[:, None]
                    == t[None, :]) & has_t[None, :])               # [K, N]
    lat = (state.cycle - state.waiting_since).clamp(min=1)
    bucket = floor_log2(lat).clamp(0, LAT_BUCKETS - 1)
    lat_onehot = ((torch.arange(LAT_BUCKETS, dtype=I32, device=dev)[:, None]
                   == bucket[None, :])
                  & m_stats["unblocked"][None, :])                 # [B, N]
    counters = torch.stack([
        f_stats["issued"], f_stats["read_hits"], f_stats["write_hits"],
        f_stats["read_misses"], f_stats["write_misses"],
        f_stats["upgrades"], m_stats["invalidations"],
        m_stats["evictions"]])                                     # [8, N]
    deltas = torch.cat([counters, type_onehot, lat_onehot]).sum(
        1, dtype=I32)                                              # [8+K+B]
    metrics = mt.replace(
        cycles=mt.cycles + 1,
        instrs_retired=mt.instrs_retired + deltas[0],
        read_hits=mt.read_hits + deltas[1],
        write_hits=mt.write_hits + deltas[2],
        read_misses=mt.read_misses + deltas[3],
        write_misses=mt.write_misses + deltas[4],
        upgrades=mt.upgrades + deltas[5],
        msgs_processed=mt.msgs_processed + deltas[8:8 + K],
        msgs_dropped=mt.msgs_dropped + dropped,
        msgs_injected_dropped=mt.msgs_injected_dropped + injected,
        invalidations=mt.invalidations + deltas[6] + inv_applied,
        evictions=mt.evictions + deltas[7],
        lat_hist=mt.lat_hist + deltas[8 + K:],
        mb_depth_peak=torch.maximum(mt.mb_depth_peak,
                                    mb_upd["mb_count"].max()),
    )

    new_state = state.replace(
        cache_addr=cache_addr, cache_val=cache_val, cache_state=cache_state,
        memory=memory, dir_state=dir_state, dir_bitvec=dir_bitvec,
        instr_idx=f_upd["new_idx"], cur_op=cur_op, cur_addr=cur_addr,
        cur_val=cur_val, waiting=waiting, waiting_since=waiting_since,
        cycle=state.cycle + 1, metrics=metrics, **mb_upd)
    if not with_events:
        return new_state
    events = {
        # instruction fetch (assignment.c:649-652)
        "fetch": fetch, "op": l_op, "addr": l_addr, "value": l_val,
        # message dequeue (assignment.c:179-182)
        "msg": mv.has_msg, "msg_sender": mv.sender,
        "msg_type": mv.type, "msg_addr": mv.addr,
    }
    return new_state, events


def assemble_candidates(cfg: SystemConfig, mv, m_cand, f_req,
                        rows) -> mailbox.Candidates:
    """The [N, S] candidate planes: slot 0 is the message phase's
    primary send XOR the frontend's request, slot 1 the secondary send,
    then (mailbox mode) the N INV fan-out slots, last the eviction."""
    N, Wm = cfg.num_nodes, cfg.msg_bitvec_words
    dev = rows.device
    zero = torch.zeros((N,), dtype=I32, device=dev)
    zbv = torch.zeros((N, Wm), dtype=I32, device=dev)
    pt, pr, pa, pv, ps, pd, pb = m_cand["pri"]
    rt, rr_, ra, rv = f_req
    use_req = ~mv.has_msg
    s0 = (torch.where(use_req, rt, pt), torch.where(use_req, rr_, pr),
          torch.where(use_req, ra, pa), torch.where(use_req, rv, pv),
          torch.where(use_req, 0, ps), torch.where(use_req, 0, pd))
    s0_bitvec = torch.where(use_req[:, None], zbv, pb)
    st_, sr_, sa_, sv_, ss_ = m_cand["sec"]
    et_, er_, ea_, ev_ = m_cand["ev"]
    sec = (st_, sr_, sa_, sv_, ss_, zero)
    ev = (et_, er_, ea_, ev_, zero, zero)
    if cfg.inv_mode == "mailbox":
        it_, ir_, ia_ = m_cand["inv"]
        zn = torch.zeros((N, N), dtype=I32, device=dev)
        inv = (it_, ir_, ia_, zn, zn, zn)
        planes = [torch.cat([torch.stack([a, b], 1), i, e[:, None]], 1)
                  for a, b, i, e in zip(s0, sec, inv, ev)]
        bitvec = torch.cat([torch.stack([s0_bitvec, zbv], 1),
                            torch.zeros((N, N, Wm), dtype=I32, device=dev),
                            zbv[:, None]], 1)
    else:
        planes = [torch.stack([a, b, e], 1) for a, b, e in zip(s0, sec, ev)]
        bitvec = torch.stack([s0_bitvec, zbv, zbv], 1)
    c_type, c_recv, c_addr, c_value, c_second, c_dirstate = planes
    return mailbox.Candidates(
        type=c_type, recv=c_recv, sender=rows[:, None].expand_as(c_type),
        addr=c_addr, value=c_value, second=c_second, dirstate=c_dirstate,
        bitvec=bitvec)


# -- runners ---------------------------------------------------------------

def run_cycles(cfg: SystemConfig, state: SimState, num_cycles: int,
               deliver_fn=None) -> SimState:
    """Run a fixed number of cycles."""
    for _ in range(num_cycles):
        state = cycle(cfg, state, deliver_fn=deliver_fn)
    return state


def run_cycles_traced(cfg: SystemConfig, state: SimState, num_cycles: int,
                      message_phase=None):
    """Run ``num_cycles`` cycles collecting the per-cycle event record:
    (state, events) with events a dict of [num_cycles, N] tensors, the
    data of the reference's printf tracing (``utils.eventlog`` renders it
    in the ``instruction_order.txt`` line format). ``message_phase`` is
    the handler-phase override ``cycle`` takes, so a mutated engine's
    run can be traced too."""
    per_cycle = []
    for _ in range(num_cycles):
        state, ev = cycle(cfg, state, with_events=True,
                          message_phase=message_phase)
        per_cycle.append(ev)
    if not per_cycle:
        N = cfg.num_nodes
        _, ev = cycle(cfg, state, with_events=True,
                      message_phase=message_phase)
        return state, {k: v.new_empty((0, N)) for k, v in ev.items()}
    return state, {k: torch.stack([ev[k] for ev in per_cycle])
                   for k in per_cycle[0]}


def run_chunked_to_quiescence(cfg: SystemConfig, state: SimState,
                              chunk: int = 32, max_cycles: int = 100_000,
                              message_phase=None,
                              deliver_fn=None) -> SimState:
    """while not quiescent and cycle < max_cycles: run `chunk` cycles.

    The predicate is read once per chunk (one host sync), so a run may
    pass quiescence or ``max_cycles`` by up to chunk - 1 cycles; a
    quiescent state is a fixpoint of ``cycle`` apart from the cycle
    counters, so the final state is the same."""
    while bool(~state.quiescent() & (state.cycle < max_cycles)):
        for _ in range(chunk):
            state = cycle(cfg, state, message_phase=message_phase,
                          deliver_fn=deliver_fn)
    return state


def run_to_quiescence(cfg: SystemConfig, state: SimState,
                      max_cycles: int = 100_000,
                      message_phase=None) -> SimState:
    """Run until no work remains, stopping exactly at max_cycles."""
    return run_chunked_to_quiescence(cfg, state, 1, max_cycles,
                                     message_phase)
