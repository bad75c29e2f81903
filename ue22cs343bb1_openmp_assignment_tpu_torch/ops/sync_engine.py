"""Transactional engine: state, constructors, invariants and runners.

The port of the JAX package's ``ops/sync_engine.py`` for the deep-window
engine (``cfg.deep_window``). Each round commits whole coherence
transactions atomically (the design is in the JAX module's docstring
and in ``ops/deep_engine.py``); the directory is always exact, so it is
a flat ``[N << block_bits, DM_COLS]`` table of per-entry state, sharer
count, owner, memory, round-tagged fan-out action, requester and claim
key, with no sharer bitvector.

State is a dataclass of int32 tensors on one device. The runners are
Python loops over rounds: ``run_sync_to_quiescence`` reads the
quiescence flag (one host sync) only between ``chunk``-round blocks,
exactly where the JAX runner's ``while_loop`` tests it, so round counts
and claim-key countdowns agree with the reference round for round.

The txn_width == 1 and multi-transaction rounds, event tracing, phase
streaming and seed ensembles are a later slice of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.procedural import (
    M32, mix32, mulmod32, u32)
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
    build_instr_arrays, cold_memory)
from ue22cs343bb1_openmp_assignment_tpu_torch.types import (CacheState,
                                                            DirState)

# dm column layout: one row per (home, block) entry; row index == the
# packed address (codec.make_address).
DM_STATE, DM_COUNT, DM_OWNER, DM_MEM, DM_ACT, DM_REQ, DM_CLAIM = (
    0, 1, 2, 3, 4, 5, 6)
DM_COLS = 7
INT32_MAX = 2**31 - 1

METRIC_FIELDS = ("rounds", "instrs_retired", "read_hits", "write_hits",
                 "read_misses", "write_misses", "upgrades", "conflicts",
                 "evictions", "invalidations", "promotions")
STATE_FIELDS = ("cache_addr", "cache_val", "cache_state", "dm",
                "instr_pack", "instr_count", "idx", "horizon", "seed",
                "round")


@dataclasses.dataclass
class SyncMetrics:
    """Run counters, each a 0-d int32 tensor (JAX SyncMetrics fields)."""

    rounds: torch.Tensor
    instrs_retired: torch.Tensor
    read_hits: torch.Tensor
    write_hits: torch.Tensor
    read_misses: torch.Tensor
    write_misses: torch.Tensor
    upgrades: torch.Tensor
    conflicts: torch.Tensor
    evictions: torch.Tensor
    invalidations: torch.Tensor
    promotions: torch.Tensor

    @classmethod
    def zeros(cls, device) -> "SyncMetrics":
        return cls(**{f: torch.zeros((), dtype=torch.int32, device=device)
                      for f in METRIC_FIELDS})

    def replace(self, **kw) -> "SyncMetrics":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SyncState:
    """Machine state (JAX SyncState fields; N nodes, C lines, T trace).

    cache_addr/cache_val/cache_state [N, C]; dm [N << block_bits,
    DM_COLS]; instr_pack [N, T, 2] ([op << 28 | addr, value], one
    placeholder slot for procedural machines); instr_count, idx,
    horizon [N]; seed and round 0-d. All int32, all on one device."""

    cache_addr: torch.Tensor
    cache_val: torch.Tensor
    cache_state: torch.Tensor
    dm: torch.Tensor
    instr_pack: torch.Tensor
    instr_count: torch.Tensor
    idx: torch.Tensor
    horizon: torch.Tensor
    seed: torch.Tensor
    round: torch.Tensor
    metrics: SyncMetrics

    @property
    def num_nodes(self) -> int:
        return self.cache_addr.shape[0]

    @property
    def device(self) -> torch.device:
        return self.dm.device

    def quiescent(self) -> torch.Tensor:
        return torch.all(self.idx >= self.instr_count)

    def replace(self, **kw) -> "SyncState":
        return dataclasses.replace(self, **kw)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def _fresh_dm(cfg: SystemConfig, memory: torch.Tensor) -> torch.Tensor:
    """Cold flat directory rows: every entry Unowned with `memory`'s
    image in DM_MEM, DM_ACT pre-stamped with an impossible round tag and
    the claim column above every reachable key."""
    N, M = cfg.num_nodes, cfg.mem_size
    S = 1 << cfg.block_bits
    dev = memory.device
    dm = torch.zeros((N * S, DM_COLS), dtype=torch.int32, device=dev)
    dm[:, DM_STATE] = int(DirState.U)
    dm[:, DM_ACT] = -4
    dm[:, DM_CLAIM] = INT32_MAX
    rows = (torch.arange(N, device=dev)[:, None] * S
            + torch.arange(M, device=dev)[None, :]).reshape(-1)
    dm[rows, DM_MEM] = memory.reshape(N * M).to(torch.int32)
    return dm


def _cold_state(cfg: SystemConfig, dev, instr_pack, instr_count,
                seed: int) -> SyncState:
    N, C = cfg.num_nodes, cfg.cache_size
    return SyncState(
        cache_addr=torch.full((N, C), cfg.invalid_address,
                              dtype=torch.int32, device=dev),
        cache_val=torch.zeros((N, C), dtype=torch.int32, device=dev),
        cache_state=torch.full((N, C), int(CacheState.INVALID),
                               dtype=torch.int32, device=dev),
        dm=_fresh_dm(cfg, cold_memory(cfg, dev)),
        instr_pack=instr_pack,
        instr_count=instr_count,
        idx=torch.zeros((N,), dtype=torch.int32, device=dev),
        horizon=torch.full((N,), 1 << 20, dtype=torch.int32, device=dev),
        seed=_i32(seed, dev),
        round=_i32(0, dev),
        metrics=SyncMetrics.zeros(dev),
    )


def procedural_state(cfg: SystemConfig, length: int, seed: int = 0,
                     device=None) -> SyncState:
    """A SyncState whose instructions come from cfg.procedural —
    `length` instructions per node with O(1) trace storage (the
    instr_pack placeholder has one slot; rounds never read it in
    procedural mode). Built directly in the flat dm layout, O(N)."""
    if not cfg.procedural:
        raise ValueError("cfg.procedural must name a generator")
    dev = _device.resolve(device)
    N = cfg.num_nodes
    return _cold_state(
        cfg, dev, torch.zeros((N, 1, 2), dtype=torch.int32, device=dev),
        torch.full((N,), int(length), dtype=torch.int32, device=dev),
        seed)


def from_traces(cfg: SystemConfig, traces=None, seed: int = 0,
                device=None, instr_arrays=None) -> SyncState:
    """A fresh machine running stored traces: the JAX package's
    ``from_sim_state(cfg, init_state(cfg, traces), seed)``, built
    directly. ``traces``: per-node lists of (op, addr, value);
    ``instr_arrays``: prebuilt (op, addr, val, count) arrays instead."""
    dev = _device.resolve(device)
    op, addr, val, count = build_instr_arrays(
        cfg, dev, traces=traces, instr_arrays=instr_arrays)
    pack = torch.stack([(op << 28) | addr, val], dim=-1).contiguous()
    return _cold_state(cfg, dev, pack, count, seed)


def to_sim_arrays(cfg: SystemConfig, st: SyncState):
    """(memory, dir_state, dir_bitvec) host arrays in the message-level
    engine's layout. The sharer bitvector is derived from cache tags —
    exact, because the transactional engine keeps the directory exact."""
    N, M, W = cfg.num_nodes, cfg.mem_size, cfg.bitvec_words
    S = 1 << cfg.block_bits
    dm = st.dm.cpu().numpy().reshape(N, S, DM_COLS)[:, :M]
    ca = st.cache_addr.cpu().numpy()
    cs = st.cache_state.cpu().numpy()
    bv = np.zeros((N, M, W), np.uint32)
    holder, _ = np.nonzero(cs != int(CacheState.INVALID))
    a = ca[cs != int(CacheState.INVALID)].astype(np.int64)
    home, block = a >> cfg.block_bits, a & (S - 1)
    ok = (home >= 0) & (home < N) & (block < M)
    np.bitwise_or.at(bv, (home[ok], block[ok], holder[ok] // 32),
                     (np.uint32(1) << (holder[ok] % 32)).astype(np.uint32))
    return dm[:, :, DM_MEM], dm[:, :, DM_STATE], bv


def to_dump_view(cfg: SystemConfig, st: SyncState):
    """A SimState-shaped view for utils.golden.state_to_dumps."""
    import types as _t
    memory, dir_state, bv = to_sim_arrays(cfg, st)
    return _t.SimpleNamespace(
        memory=memory, dir_state=dir_state, dir_bitvec=bv,
        cache_addr=st.cache_addr.cpu().numpy(),
        cache_val=st.cache_val.cpu().numpy(),
        cache_state=st.cache_state.cpu().numpy())


def _assert_round_budget(cfg: SystemConfig, start_round, n: int) -> None:
    """Entry round + requested rounds must stay inside the claim-key
    budget (claim keys count down from claim_max_rounds)."""
    start = int(start_round)
    budget = claim_max_rounds(cfg)
    assert start + n < budget, (
        f"round {start} + {n} rounds exceeds the claim-key budget "
        f"{budget} at {cfg.num_nodes} nodes; chain phases via "
        "continue_with_traces to reset the round counter")


def reset_claims(dm: torch.Tensor) -> torch.Tensor:
    """Clear DM_CLAIM to the idle sentinel (arbitration is transient
    per-round state, never outcome)."""
    dm = dm.clone()
    dm[:, DM_CLAIM] = INT32_MAX
    return dm


def slot_bits(cfg: SystemConfig) -> int:
    """Lane-key slot-index bit width (SB): with absorption waves a
    node's same-entry events carry their window slot index in the
    DM_CLAIM lane key; single-wave configs spend no slot bits."""
    return (0 if cfg.deep_waves == 1
            else max(1, (cfg.deep_slots - 1).bit_length()))


def claim_max_rounds(cfg: SystemConfig) -> int:
    """Hard bound on rounds per machine (DM_CLAIM key-packing budget)."""
    prio_bits = max(1, (cfg.num_nodes - 1).bit_length())
    if cfg.deep_window:
        st_bit = 1 if cfg.deep_read_storm else 0
        return min((1 << (30 - prio_bits - 1 - slot_bits(cfg)
                          - st_bit)) - 1,
                   (1 << 20) - 1)
    return (1 << (30 - prio_bits)) - 1


def check_exact_directory(cfg: SystemConfig, st: SyncState) -> dict:
    """Assert the engine's core invariant; return a summary report.

    An entry's sharer count equals the number of valid cache lines
    holding its tag, EM entries have exactly one holder (the recorded
    owner, in M/E), S entries have only SHARED holders, U entries none.
    Raises AssertionError on violation. Host-side, vectorized numpy."""
    N, C, M = cfg.num_nodes, cfg.cache_size, cfg.mem_size
    S = 1 << cfg.block_bits
    E = N * S
    ca = st.cache_addr.cpu().numpy()
    cs = st.cache_state.cpu().numpy()
    dm = st.dm.cpu().numpy()
    valid = cs != int(CacheState.INVALID)
    addrs = ca[valid]
    assert addrs.size == 0 or (addrs.min() >= 0 and addrs.max() < E), (
        "valid cache line holds an out-of-range tag")
    holders = np.bincount(addrs, minlength=E)
    shared_h = np.bincount(ca[valid & (cs == int(CacheState.SHARED))],
                           minlength=E)
    owned_h = holders - shared_h
    d_state, d_count = dm[:, DM_STATE], dm[:, DM_COUNT]
    is_u = d_state == int(DirState.U)
    is_em = d_state == int(DirState.EM)
    is_s = d_state == int(DirState.S)
    assert np.all(is_u | is_em | is_s), "directory row with corrupt state"
    block_ok = (np.arange(E) & (S - 1)) < M
    assert np.all(is_u[~block_ok] | (holders[~block_ok] == 0)), (
        "stride-hole entry is claimed")
    assert np.all(holders[is_u] == 0), "U entry has holders"
    assert np.all((d_count[is_em] == 1) & (holders[is_em] == 1)
                  & (owned_h[is_em] == 1)), (
        "EM entry without exactly one M/E holder")
    assert np.all((d_count[is_s] == holders[is_s]) & (d_count[is_s] >= 1)
                  & (owned_h[is_s] == 0)), (
        "S entry count/holder-state mismatch")
    em_rows = np.nonzero(is_em)[0]
    owners = dm[em_rows, DM_OWNER]
    assert owners.size == 0 or (owners.min() >= 0 and owners.max() < N), (
        "EM owner id out of range")
    ci = (em_rows & (S - 1)) % C
    assert np.all((ca[owners, ci] == em_rows)
                  & (cs[owners, ci] != int(CacheState.INVALID))
                  & (cs[owners, ci] != int(CacheState.SHARED))), (
        "EM entry's recorded owner does not hold the line M/E")
    return {
        "entries_u": int(is_u[block_ok].sum()),
        "entries_em": int(is_em.sum()),
        "entries_s": int(is_s.sum()),
        "cached_lines": int(valid.sum()),
    }


def _round_key_rs(cfg: SystemConfig, round_, seed, rows: torch.Tensor):
    """Per-round claim key on (round, seed): a decreasing round
    countdown in the high bits, a reseeded bijective node-priority
    permutation in the low bits. uint32 arithmetic in int64 (see
    procedural.py); round_/seed are 0-d tensors on rows' device."""
    N = cfg.num_nodes
    prio_bits = max(1, (N - 1).bit_length())
    mask = (1 << prio_bits) - 1
    dev = rows.device
    r = torch.as_tensor(round_, device=dev)
    h = mix32(mulmod32(u32(r), 0x9E3779B9)
              ^ mulmod32(u32(torch.as_tensor(seed, device=dev)),
                         0x85EBCA77))
    x = u32(rows)
    x = (mulmod32(x, ((h << 1) | 1) & M32) + (h >> 7)) & mask
    x = x ^ (x >> max(1, prio_bits // 2))
    x = mulmod32(x, 0x9E3779B9 | 1) & mask
    prio = x.to(torch.int32)
    # clamped at 0: past the budget every round shares countdown 0 (the
    # runners assert the budget up front, so only direct round_step
    # callers can get there)
    countdown = torch.clamp(claim_max_rounds(cfg) - r.to(torch.int32),
                            min=0).to(torch.int32)
    return (countdown << prio_bits) | prio


# -- rounds and runners ------------------------------------------------------

def round_step(cfg: SystemConfig, st: SyncState,
               fold_impl: str = "kernel") -> SyncState:
    """One transactional round. Deep-window configs run the whole round
    as one kernel (``deep_round_kernel.round_step_deep_fused``) under
    ``cfg.fused_round`` where ``deep_round_kernel.supported(cfg)``
    holds, as the JAX package dispatches to its fused TPU kernel, and
    ``deep_engine.round_step_deep`` otherwise. ``fold_impl="plain"``
    runs either path's plain version on any device. The txn_width == 1
    and multi-transaction rounds are a later slice."""
    if not cfg.deep_window:
        raise NotImplementedError(
            "only the deep-window round (cfg.deep_window) is ported; the "
            "txn_width == 1 and multi-transaction rounds are slice 3 of "
            "the port (ROADMAP.md)")
    if cfg.fused_round:
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
            deep_round_kernel)
        if deep_round_kernel.supported(cfg):
            return deep_round_kernel.round_step_deep_fused(cfg, st,
                                                           fold_impl)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops.deep_engine import (
        round_step_deep)
    return round_step_deep(cfg, st, fold_impl=fold_impl)


def run_rounds(cfg: SystemConfig, st: SyncState, n: int,
               fold_impl: str = "kernel") -> SyncState:
    _assert_round_budget(cfg, st.round, n)
    for _ in range(n):
        st = round_step(cfg, st, fold_impl)
    return st


def run_sync_to_quiescence(cfg: SystemConfig, st: SyncState,
                           chunk: int = 32, max_rounds: int = 100_000,
                           fold_impl: str = "kernel") -> SyncState:
    """Run until every trace is fully retired, testing quiescence only
    between ``chunk``-round blocks (the JAX runner's granularity)."""
    _assert_round_budget(cfg, st.round, max_rounds)
    r = int(st.round)
    limit = r + max_rounds
    while r < limit and not bool(st.quiescent()):
        for _ in range(chunk):
            st = round_step(cfg, st, fold_impl)
        r += chunk
    return st
