"""Protocol-invariant checking of the message-level machine.

The port of the JAX package's ``ops/invariants.py``. Two tiers:

* :func:`step_violations`: invariants that hold after every cycle, even
  mid-transaction (directory / sharer-bitvector consistency, state
  ranges, ring occupancy); a violation means the engine is broken.
* :func:`quiescent_violations`: the single-writer / coherence contract,
  valid once traffic has drained. Under racy workloads it is a
  diagnostic, not an engine assert: the protocol tracks no INV-acks
  (``assignment.c:358-361``), so an INV may legally race a fill (the JAX
  module's docstring has the argument).

Everything returns ``{name: violation count}`` with 0-d int32 tensors,
so nothing syncs with the host until the caller asks.
"""

from __future__ import annotations

import functools
import operator

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import codec
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (SimState,
                                                            bit_get,
                                                            popcount)
from ue22cs343bb1_openmp_assignment_tpu_torch.types import (CacheState,
                                                            DirState)

I32 = torch.int32


def _count(pred) -> torch.Tensor:
    return pred.sum(dtype=I32)


def step_predicates(cfg: SystemConfig, state: SimState) -> dict:
    """Engine-tier predicates as violation masks (True = violated)."""
    pc = popcount(state.dir_bitvec)                       # [N, M]
    is_em = state.dir_state == int(DirState.EM)
    is_s = state.dir_state == int(DirState.S)
    is_u = state.dir_state == int(DirState.U)
    return {
        "em_not_single_owner": is_em & (pc != 1),
        "shared_without_sharers": is_s & (pc < 1),
        "unowned_with_sharers": is_u & (pc != 0),
        "dir_state_out_of_range":
            (state.dir_state < 0) | (state.dir_state > int(DirState.U)),
        "cache_state_out_of_range":
            ~functools.reduce(operator.or_,
                              [state.cache_state == s
                               for s in cfg.allowed_cache_states]),
        "mailbox_count_oob":
            (state.mb_count < 0) | (state.mb_count > cfg.queue_capacity),
        "mailbox_head_oob":
            (state.mb_head < 0) | (state.mb_head >= cfg.queue_capacity),
        "waiting_past_trace_end":
            state.waiting & (state.instr_idx >= state.instr_count),
        "memory_not_byte": (state.memory < 0) | (state.memory > 0xFF),
    }


def step_violations(cfg: SystemConfig, state: SimState) -> dict:
    """Invariants that must hold after every cycle, as counts."""
    return {k: _count(v) for k, v in step_predicates(cfg, state).items()}


def quiescent_predicates(cfg: SystemConfig, state: SimState) -> dict:
    """Coherence-tier predicates as violation masks (True = violated)."""
    N, C, M = cfg.num_nodes, cfg.cache_size, cfg.mem_size
    dev = state.cache_addr.device
    rows = torch.arange(N, dtype=I32, device=dev)[:, None]

    valid = state.cache_state != int(CacheState.INVALID)  # [N, C]
    h = codec.home_node(cfg, state.cache_addr).clamp(0, N - 1)
    b = codec.block_index(cfg, state.cache_addr).clamp(0, M - 1)
    dstate = state.dir_state[h, b]                        # [N, C]
    dbv = state.dir_bitvec[h, b]                          # [N, C, W]
    my_bit = bit_get(dbv, rows.expand(N, C))

    is_m = state.cache_state == int(CacheState.MODIFIED)
    is_e = state.cache_state == int(CacheState.EXCLUSIVE)
    is_s = state.cache_state == int(CacheState.SHARED)

    # owned-copy and copy counts per home block: out-of-place
    # scatter-adds, which torch.func.vmap batches (the model checker)
    flat = (h * M + b).reshape(-1).to(torch.int64)
    owners = torch.zeros(N * M, dtype=I32, device=dev).scatter_add(
        0, flat, (is_m | is_e).to(I32).reshape(-1)).reshape(N, M)
    copies = torch.zeros(N * M, dtype=I32, device=dev).scatter_add(
        0, flat, valid.to(I32).reshape(-1)).reshape(N, M)
    mem_val = state.memory[h, b]
    return {
        "valid_line_unknown_to_home": valid & ~my_bit,
        "exclusive_line_dir_not_em":
            (is_m | is_e) & (dstate != int(DirState.EM)),
        "shared_line_dir_unowned": is_s & (dstate == int(DirState.U)),
        "multiple_owners": owners > 1,
        "owner_with_other_copies": (owners == 1) & (copies > 1),
        "clean_line_stale_value":
            (is_e | is_s) & (state.cache_val != mem_val),
        "phantom_sharers": popcount(state.dir_bitvec) != copies,
    }


def quiescent_violations(cfg: SystemConfig, state: SimState) -> dict:
    """The full coherence contract, valid once quiescent(), as counts."""
    return {k: _count(v)
            for k, v in quiescent_predicates(cfg, state).items()}


def all_violations(cfg: SystemConfig, state: SimState,
                   quiescent: bool = False) -> dict:
    out = step_violations(cfg, state)
    if quiescent:
        out.update(quiescent_violations(cfg, state))
    return out


def assert_invariants(cfg: SystemConfig, state: SimState,
                      quiescent: bool = False) -> None:
    """Raise AssertionError naming every violated invariant and its
    count (``quiescent=True`` adds the coherence tier)."""
    v = {k: int(n) for k, n in all_violations(cfg, state,
                                                quiescent).items()}
    bad = {k: n for k, n in v.items() if n}
    if bad:
        raise AssertionError(f"protocol invariants violated: {bad}")


def coherence_report(cfg: SystemConfig, state: SimState) -> dict:
    """Coherence-tier counts as plain ints (the racy-workload
    diagnostic)."""
    return {k: int(v)
            for k, v in quiescent_violations(cfg, state).items()}


def run_cycles_checked(cfg: SystemConfig, state: SimState,
                       num_cycles: int) -> tuple:
    """Run `num_cycles` cycles summing the per-cycle step violations;
    returns (final state, {name: total})."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops.step import cycle
    acc = {k: torch.zeros((), dtype=I32, device=state.cycle.device)
           for k in step_predicates(cfg, state)}
    for _ in range(num_cycles):
        state = cycle(cfg, state)
        v = step_violations(cfg, state)
        acc = {k: acc[k] + v[k] for k in acc}
    return state, acc
