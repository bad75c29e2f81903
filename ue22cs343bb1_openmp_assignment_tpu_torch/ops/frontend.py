"""Instruction side of the cycle: fetch, hit/miss classification and
requests.

The port of the JAX package's ``ops/frontend.py`` (``assignment.c:
632-735``). A node fetches only when its mailbox is empty and it is not
blocked, so messages drain first. Hit: tag match and not INVALID. A
read hit does nothing; a read miss sends READ_REQUEST to the home and
blocks; a write hit on M/E writes through (state MODIFIED); a write hit
on S sends UPGRADE and blocks; a write miss sends WRITE_REQUEST with the
value and blocks.

The schedule knobs: ``issue_delay``/``issue_period`` gate issue by
cycle, ``order_rank`` replays a recorded global order (one retirement at
a time), and ``cfg.admission_window`` caps the requests in flight
machine-wide, admitting in node order.
"""

from __future__ import annotations

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import codec
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.handlers import select
from ue22cs343bb1_openmp_assignment_tpu_torch.types import (CacheState, Msg,
                                                            Op)

I32 = torch.int32


def instruction_phase(cfg: SystemConfig, state, may_issue):
    """Instruction-fetch effects for the nodes in `may_issue`. Returns
    (updates, request_part, stats) as the JAX ``instruction_phase``."""
    N = cfg.num_nodes
    dev = may_issue.device
    rows = torch.arange(N, dtype=I32, device=dev)

    # schedule gate (inert at delay 0, period 1)
    since = state.cycle - state.issue_delay
    gate = (since >= 0) & (since % state.issue_period.clamp(min=1) == 0)
    if state.order_rank.shape[-1]:
        # interleaving replay: instruction i of node n issues only when
        # order_rank[n, i] instructions have retired machine-wide
        nxt = (state.instr_idx + 1).clamp(0, state.order_rank.shape[-1] - 1)
        gate = gate & (state.order_rank[rows, nxt]
                       == state.metrics.instrs_retired)

    has_more = state.instr_idx < state.instr_count - 1  # assignment.c:632
    fetch = may_issue & gate & has_more

    idx = torch.where(fetch, state.instr_idx + 1, 0)
    op = state.instr_op[rows, idx]
    addr = state.instr_addr[rows, idx]
    val = state.instr_val[rows, idx]

    i_home = codec.home_node(cfg, addr)
    i_cidx = codec.cache_index(cfg, addr)
    cl_addr = state.cache_addr[rows, i_cidx]
    cl_state = state.cache_state[rows, i_cidx]

    is_read = fetch & (op == int(Op.READ))
    is_write = fetch & (op == int(Op.WRITE))
    hit = (cl_addr == addr) & (cl_state != int(CacheState.INVALID))

    read_hit = is_read & hit
    read_miss = is_read & ~hit
    write_hit_me = is_write & hit & (
        (cl_state == int(CacheState.MODIFIED))
        | (cl_state == int(CacheState.EXCLUSIVE)))
    write_hit_s = is_write & hit & ~write_hit_me
    write_miss = is_write & ~hit

    # admission control: a gated node retries the fetch next cycle
    if cfg.admission_window is not None:
        wants = read_miss | write_hit_s | write_miss
        inflight = state.waiting.sum(dtype=I32)
        w32 = wants.to(I32)
        rank = torch.cumsum(w32, 0, dtype=I32) - w32   # exclusive prefix
        admit = inflight + rank < cfg.admission_window
        keep = ~wants | admit
        fetch = fetch & keep
        read_miss = read_miss & admit
        write_hit_s = write_hit_s & admit
        write_miss = write_miss & admit
        read_hit = read_hit & keep
        write_hit_me = write_hit_me & keep

    # local write-through on an M/E hit (assignment.c:708-710)
    updates = dict(
        cache_idx=i_cidx,
        cache_state=(write_hit_me,
                     torch.full((N,), int(CacheState.MODIFIED), dtype=I32,
                                device=dev)),
        cache_addr=(torch.zeros((N,), dtype=torch.bool, device=dev), addr),
        cache_val=(write_hit_me, val),
        wait_set=read_miss | write_hit_s | write_miss,
        fetch=fetch,
        new_idx=torch.where(fetch, state.instr_idx + 1, state.instr_idx),
        latch=(fetch, op, addr, val),
    )

    req_type = select(
        [read_miss, write_hit_s, write_miss],
        [int(Msg.READ_REQUEST), int(Msg.UPGRADE), int(Msg.WRITE_REQUEST)],
        torch.full((N,), int(Msg.NONE), dtype=I32, device=dev))
    # UPGRADE and WRITE_REQUEST carry the value (assignment.c:716-731)
    req_value = torch.where(is_write, val, 0)
    request_part = (req_type, i_home, addr, req_value)

    stats = dict(
        read_hits=read_hit,
        write_hits=write_hit_me | write_hit_s,
        read_misses=read_miss,
        write_misses=write_miss,
        upgrades=write_hit_s,
        issued=fetch,
    )
    return updates, request_part, stats
