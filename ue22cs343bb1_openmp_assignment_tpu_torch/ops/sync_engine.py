"""Transactional engine: state, constructors, invariants, rounds and
runners.

The port of the JAX package's ``ops/sync_engine.py``. Each round commits
whole coherence transactions atomically (the design and the
serialization argument are in the JAX module's docstring); the directory
is always exact, so it is a flat ``[N << block_bits, DM_COLS]`` table of
per-entry state, sharer count, owner, memory, round-tagged fan-out
action, requester and claim key, with no sharer bitvector.

Three rounds, dispatched by ``round_step``:

- ``cfg.deep_window``: the deep-window round (``ops/deep_engine``, or
  the fused round kernel of ``ops/deep_round_kernel``);
- ``txn_width == 1``: a burst of up to ``drain_depth`` cache hits and
  one transaction per node (``_round_step_single``);
- ``txn_width > 1``: a window of ``drain_depth + txn_width``
  instructions with up to ``txn_width`` transactions per node
  (``_round_step_multi``).

Under ``cfg.pallas_burst`` on a procedural workload each round runs as
one CUDA kernel: the txn_width 1 round in ``ops/sync_round_kernel``
(burst, claim, commit, fan-out and counters in one launch), the
txn_width > 1 round in ``ops/sync_multi_round_kernel`` (both window
folds, claim, commit, fan-out and counters in one launch), where the
JAX package routes the node-local part of both through its Pallas
kernels. ``_round_step_single(use_kernel=True)`` keeps the burst alone
as a kernel (``ops/sync_burst_kernel``), and
``sync_window_kernel.round_step_multi_kernel`` the two window folds
(``ops/sync_window_kernel``). Outside the fused rounds the claim
scatter-min, the row gather, the commit scatter and the fan-out are
plain tensor code, held to the JAX index semantics by
``deep_engine.TorchIndexOps``.

State is a dataclass of int32 tensors on one device. The runners are
Python loops over rounds: ``run_sync_to_quiescence`` reads the
quiescence flag (one host sync) only between ``chunk``-round blocks,
exactly where the JAX runner's ``while_loop`` tests it, so round counts
and claim-key countdowns agree with the reference round for round.

Seed ensembles (``make_ensemble``, ``run_ensemble_to_quiescence``)
stack R machines on a leading axis. On a procedural config that the
fused round kernels take, an ensemble round is one launch of the
kernel's replica axis for all R machines; every other config steps each
replica through ``round_step``. ``run_sync_profile`` (JAX
``ops/sync_engine.py:1376``) folds the rounds' retirement records into
per-(node, address) read and write planes for the coherence profiler;
it steps ``round_step(..., with_events=True)``, which takes the plain
rounds on every device, as in JAX (no fused round takes the event
record).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import codec
from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.deep_fold import wi
from ue22cs343bb1_openmp_assignment_tpu_torch.procedural import (
    M32, mix32, mulmod32, procedural_instr, u32)
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
    build_instr_arrays, cold_memory)
from ue22cs343bb1_openmp_assignment_tpu_torch.types import (CacheState,
                                                            DirState, Op)

# dm column layout: one row per (home, block) entry; row index == the
# packed address (codec.make_address).
DM_STATE, DM_COUNT, DM_OWNER, DM_MEM, DM_ACT, DM_REQ, DM_CLAIM = (
    0, 1, 2, 3, 4, 5, 6)
DM_COLS = 7
INT32_MAX = 2**31 - 1
# per-round action codes scattered at a directory entry (DM_ACT holds
# (round << 2) | action) and applied by every cached line holding that
# entry's tag: the stand-in for the INV / WRITEBACK_INT /
# EVICT_SHARED-promotion fan-outs
ACT_NONE, ACT_KILL, ACT_DOWNGRADE, ACT_PROMOTE = 0, 1, 2, 3
I32 = torch.int32

METRIC_FIELDS = ("rounds", "instrs_retired", "read_hits", "write_hits",
                 "read_misses", "write_misses", "upgrades", "conflicts",
                 "evictions", "invalidations", "promotions")
STATE_FIELDS = ("cache_addr", "cache_val", "cache_state", "dm",
                "instr_pack", "instr_count", "idx", "horizon", "seed",
                "round")


class SyncMetrics:
    """Run counters (the JAX SyncMetrics fields), held in one [11] int32
    buffer in METRIC_FIELDS order ([R, 11] in an ensemble of R machines);
    each field reads as a view of its column (0-d, or [R]). A round
    updates all of them with one add, or inside the fused round kernel,
    not with a launch per field."""

    __slots__ = ("_buf",)

    def __init__(self, buf: torch.Tensor):
        if (buf.dim() not in (1, 2) or buf.shape[-1] != len(METRIC_FIELDS)
                or buf.dtype != torch.int32):
            raise ValueError(f"SyncMetrics takes an int32 "
                             f"[{len(METRIC_FIELDS)}] or "
                             f"[R, {len(METRIC_FIELDS)}] buffer, not "
                             f"{buf.dtype} {tuple(buf.shape)}")
        self._buf = buf

    @classmethod
    def zeros(cls, device) -> "SyncMetrics":
        return cls(torch.zeros((len(METRIC_FIELDS),), dtype=torch.int32,
                               device=device))

    def buffer(self) -> torch.Tensor:
        """The [11] (or [R, 11]) int32 buffer the fields are views of."""
        return self._buf

    def after_round(self, deltas: torch.Tensor) -> "SyncMetrics":
        """The counters one round later: ``rounds`` + 1 and the other
        ten fields, in METRIC_FIELDS order, + ``deltas`` [10] (or
        [R, 10])."""
        step = torch.nn.functional.pad(deltas, (1, 0), value=1)
        return SyncMetrics(self._buf + step)


for _i, _f in enumerate(METRIC_FIELDS):
    setattr(SyncMetrics, _f,
            property(lambda self, i=_i: self._buf[..., i],
                     doc=f"``{_f}`` (0-d, or [R])"))


@dataclasses.dataclass
class SyncState:
    """Machine state (JAX SyncState fields; N nodes, C lines, T trace).

    cache_addr/cache_val/cache_state [N, C]; dm [N << block_bits,
    DM_COLS]; instr_pack [N, T, 2] ([op << 28 | addr, value], one
    placeholder slot for procedural machines); instr_count, idx,
    horizon [N]; seed and round 0-d. All int32, all on one device. An
    ensemble (``make_ensemble``) has a leading replica axis R on every
    leaf."""

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
        """cache_addr's first dimension: N of one machine, but R of an
        ensemble (read N from the config there)."""
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
    rows = (torch.arange(N, dtype=torch.int64, device=dev)[:, None] * S
            + torch.arange(M, dtype=torch.int64,
                           device=dev)[None, :]).reshape(-1)
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


def from_sim_state(cfg: SystemConfig, sim_state, seed: int = 0) -> SyncState:
    """Adopt a pre-run message-level SimState (``state.init_state``, the
    same loaders and workloads): its cold caches, memory image and
    traces, on its device. The engines share initial conditions, not
    mid-flight state."""
    N = cfg.num_nodes
    dev = sim_state.cache_addr.device
    return SyncState(
        cache_addr=sim_state.cache_addr, cache_val=sim_state.cache_val,
        cache_state=sim_state.cache_state,
        dm=_fresh_dm(cfg, sim_state.memory),
        instr_pack=torch.stack(
            [(sim_state.instr_op << 28) | sim_state.instr_addr,
             sim_state.instr_val], dim=-1).contiguous(),
        instr_count=sim_state.instr_count,
        idx=torch.zeros((N,), dtype=I32, device=dev),
        horizon=torch.full((N,), 1 << 20, dtype=I32, device=dev),
        seed=_i32(seed, dev), round=_i32(0, dev),
        metrics=SyncMetrics.zeros(dev))


# lint: host
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


# lint: host
def to_dump_view(cfg: SystemConfig, st: SyncState):
    """A SimState-shaped view for utils.golden.state_to_dumps."""
    import types as _t
    memory, dir_state, bv = to_sim_arrays(cfg, st)
    return _t.SimpleNamespace(
        memory=memory, dir_state=dir_state, dir_bitvec=bv,
        cache_addr=st.cache_addr.cpu().numpy(),
        cache_val=st.cache_val.cpu().numpy(),
        cache_state=st.cache_state.cpu().numpy())


# lint: host
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


def continue_with_traces(cfg: SystemConfig, st: SyncState, traces=None,
                         instr_arrays=None) -> SyncState:
    """Stream the next trace phase into a retired machine (a host-side
    phase boundary: it reads the quiescence flag). Caches, the directory
    table and metrics persist; the instruction stream, the round counter
    and the round-tagged claim and action columns reset, so the
    claim-key budget is per phase."""
    if not bool(st.quiescent()):
        raise ValueError(
            "continue_with_traces needs a fully retired machine")
    dev = st.device
    op, addr, val, count = build_instr_arrays(
        cfg, dev, traces=traces, instr_arrays=instr_arrays)
    dm = reset_claims(st.dm)
    dm[:, DM_ACT] = -4
    N = cfg.num_nodes
    return st.replace(
        dm=dm,
        instr_pack=torch.stack([(op << 28) | addr, val], dim=-1).contiguous(),
        instr_count=count,
        idx=torch.zeros((N,), dtype=I32, device=dev),
        horizon=torch.full((N,), 1 << 20, dtype=I32, device=dev),
        round=_i32(0, dev))


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


# -- rounds ------------------------------------------------------------------

def _round_key(cfg: SystemConfig, st: SyncState, rows: torch.Tensor):
    """Per-round claim key of this state's round and seed; unique per
    node."""
    return _round_key_rs(cfg, st.round, st.seed, rows)


def _index_ops():
    # deep_engine imports this module's constants, so its import waits
    # until a round runs
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops.deep_engine import (
        TorchIndexOps)
    return TorchIndexOps()


def instr_window(cfg: SystemConfig, idx, instr_count, instr_pack,
                 width: int):
    """The next ``width`` instructions of every node from its cursor,
    (w_oa, w_val, w_live) each [N, width]: the procedural hash
    (``instr_pack`` is not read), or one clamped gather of the stored
    traces (indexed in int64: N x T can pass 2^31)."""
    N = cfg.num_nodes
    dev = idx.device
    rows = torch.arange(N, dtype=I32, device=dev)
    offs = torch.arange(width, dtype=I32, device=dev)[None, :]
    w_idx = idx[:, None] + offs
    w_live = w_idx < instr_count[:, None]
    if cfg.procedural:
        w_oa, w_val = procedural_instr(cfg, rows[:, None], w_idx)
    else:
        T = instr_pack.shape[1]
        w_flat = (rows[:, None].to(torch.int64) * T
                  + torch.clamp(w_idx, max=T - 1).to(torch.int64))
        w = instr_pack.reshape(N * T, 2)[w_flat]
        w_oa, w_val = w[..., 0], w[..., 1]
    return w_oa, w_val, w_live


def burst_phase(cfg: SystemConfig, w_oa, w_val, w_live, ca, cv, cs):
    """Phases 1 and 2a of the single-transaction round on a built window
    [N, H+1] and the round-start cache [N, C]: (d, rh_n, wh_n, oa, val,
    live, cv', cs') — the burst length, its read- and write-hit counts,
    the stopped instruction (window slot d) and the cache values and
    states after the burst's writes.

    Within a burst only hits execute, and hits never change a line's
    tag or hit/miss class, so every window position is classified
    against the round-start cache and the burst is the leading all-hit
    prefix of the first H positions (slot H is only ever the
    transaction candidate)."""
    C, H = cfg.cache_size, cfg.drain_depth
    INV = int(CacheState.INVALID)
    MOD = int(CacheState.MODIFIED)
    w_op, w_addr = w_oa >> 28, w_oa & 0x0FFFFFFF
    w_ci = codec.cache_index(cfg, w_addr).to(torch.int64)       # [N, H+1]
    wl_addr = torch.gather(ca, 1, w_ci)
    wl_state = torch.gather(cs, 1, w_ci)
    w_tagok = (wl_addr == w_addr) & (wl_state != INV)
    w_rdhit = w_live & (w_op == int(Op.READ)) & w_tagok
    w_wrhit = w_live & (w_op == int(Op.WRITE)) & w_tagok & (
        (wl_state == MOD) | (wl_state == int(CacheState.EXCLUSIVE)))
    # in-trace NOPs retire with no effect
    w_hit = w_rdhit | w_wrhit | (w_live & (w_op == int(Op.NOP)))
    prefix = torch.cumprod(w_hit[:, :H].to(I32), dim=1, dtype=I32)
    d = torch.sum(prefix, dim=1, dtype=I32)                      # [N] <= H
    in_burst = prefix != 0
    rh_n = torch.sum(w_rdhit[:, :H] & in_burst, dim=1, dtype=I32)
    wh_n = torch.sum(w_wrhit[:, :H] & in_burst, dim=1, dtype=I32)
    # burst writes: the last write to a line wins; any write leaves it
    # MODIFIED
    c_iota = torch.arange(C, dtype=torch.int64, device=ca.device)[None, :]
    for k in range(H):
        wmask = ((w_wrhit[:, k] & in_burst[:, k])[:, None]
                 & (w_ci[:, k:k + 1] == c_iota))
        cv = torch.where(wmask, w_val[:, k:k + 1], cv)
        cs = torch.where(wmask, MOD, cs)
    at_d = d[:, None].to(torch.int64)
    return (d, rh_n, wh_n, torch.gather(w_oa, 1, at_d)[:, 0],
            torch.gather(w_val, 1, at_d)[:, 0],
            torch.gather(w_live, 1, at_d)[:, 0], cv, cs)


def _claim(ix, dm: torch.Tensor, c_idx: torch.Tensor, keys: torch.Tensor):
    """dm with the scatter-min of ``keys`` at rows ``c_idx`` applied to
    its DM_CLAIM column (duplicate indices by design; index E drops)."""
    out = dm.clone()
    out[:, DM_CLAIM] = ix.scatter_min(dm[:, DM_CLAIM], c_idx, keys)
    return out


def _fan_out(cfg: SystemConfig, st: SyncState, ix, dm, ca, cs, ax: int):
    """Apply this round's actions to the cached lines: every valid line
    looks up the action at its own tag's entry (the entry index is the
    tag, so a hit is tag-matched), and each promoted line reports itself
    as its entry's new EM owner. ``ca``/``cs`` are [N, C] (``ax`` 1) or
    [C, N] (``ax`` 0). Returns (cs, dm, lines killed [N], promoted [N])."""
    N = cfg.num_nodes
    E = N << cfg.block_bits
    INV = int(CacheState.INVALID)
    rows = torch.arange(N, dtype=I32, device=dm.device).unsqueeze(ax)
    line_e = torch.clamp(ca, 0, E - 1)
    line_dm = ix.gather_rows(dm, line_e)
    fresh = (line_dm[..., DM_ACT] >> 2) == st.round
    a_code = torch.where(fresh, line_dm[..., DM_ACT] & 3, ACT_NONE)
    valid = (cs != INV) & (line_dm[..., DM_REQ] != rows)
    kill = valid & (a_code == ACT_KILL)
    down = valid & (a_code == ACT_DOWNGRADE)
    promo = valid & (a_code == ACT_PROMOTE)
    cs = torch.where(kill, INV,
                     torch.where(down, int(CacheState.SHARED),
                                 torch.where(promo,
                                             int(CacheState.EXCLUSIVE),
                                             cs)))
    dm = ix.scatter_col(dm, torch.where(promo, line_e, E).reshape(-1),
                        DM_OWNER, rows.expand_as(ca).reshape(-1))
    return (cs, dm, torch.sum(kill, dim=ax, dtype=I32),
            torch.sum(promo, dim=ax, dtype=I32))


def _round_step_single(cfg: SystemConfig, st: SyncState,
                       with_events: bool = False,
                       use_kernel: bool = False,
                       fold_impl: str = "kernel"):
    """Advance every node by one burst of hits plus one transaction
    (JAX ``_round_step_single``).

    ``use_kernel`` runs the burst phase (window, hit classification,
    burst writes, stop-slot pick) through ``sync_burst_kernel.burst``
    (``plain_burst`` under ``fold_impl="plain"``); otherwise it is
    ``burst_phase`` on the window built here. ``with_events`` (not with
    ``use_kernel``: the kernel builds no window) also returns the
    round's retirement record: per node and window slot (op, addr,
    value, retired)."""
    N, C = cfg.num_nodes, cfg.cache_size
    H = cfg.drain_depth
    E = N << cfg.block_bits
    dev = st.device
    ix = _index_ops()
    rows = torch.arange(N, dtype=I32, device=dev)
    INV = int(CacheState.INVALID)
    MOD = int(CacheState.MODIFIED)
    D_U, D_S, D_EM = int(DirState.U), int(DirState.S), int(DirState.EM)

    ca, cv, cs = st.cache_addr, st.cache_val, st.cache_state
    idx0 = st.idx

    if use_kernel:
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
            sync_burst_kernel as sbk)
        burst = sbk.burst if fold_impl == "kernel" else sbk.plain_burst
        d, rh_n, wh_n, oa, val, live, cv, cs = burst(
            cfg, ca, cv, cs, idx0, st.instr_count)
    else:
        w_oa, w_val, w_live = instr_window(cfg, idx0, st.instr_count,
                                           st.instr_pack, H + 1)
        d, rh_n, wh_n, oa, val, live, cv, cs = burst_phase(
            cfg, w_oa, w_val, w_live, ca, cv, cs)
    op, addr = oa >> 28, oa & 0x0FFFFFFF
    ci = codec.cache_index(cfg, addr)
    at_ci = ci[:, None].to(torch.int64)
    l_addr = torch.gather(ca, 1, at_ci)[:, 0]
    l_val = torch.gather(cv, 1, at_ci)[:, 0]
    l_state = torch.gather(cs, 1, at_ci)[:, 0]
    tag_ok = (l_addr == addr) & (l_state != INV)
    is_rd, is_wr = op == int(Op.READ), op == int(Op.WRITE)
    upg = live & is_wr & tag_ok & (l_state == int(CacheState.SHARED))
    rd_miss = live & is_rd & ~tag_ok
    wr_miss = live & is_wr & ~tag_ok
    txn = rd_miss | wr_miss | upg
    # (a leftover hit at the stop position waits for the next round)

    e1 = torch.clamp(addr, 0, E - 1)                 # entry index == address
    has_victim = txn & ~tag_ok & (l_state != INV) & (l_addr != addr)
    e2 = torch.clamp(l_addr, 0, E - 1)

    # ---- conflict resolution: seeded-hash priority, scatter-min ----------
    key = _round_key(cfg, st, rows)
    c_idx = torch.cat([torch.where(txn, e1, E),
                       torch.where(has_victim, e2, E)])
    dm_claimed = _claim(ix, st.dm, c_idx, torch.cat([key, key]))

    # ---- gather directory rows + owner value -----------------------------
    dm12 = ix.gather_rows(dm_claimed, torch.stack([e1, e2], dim=1))
    dm1, dm2 = dm12[:, 0], dm12[:, 1]
    got = dm12[:, :, DM_CLAIM]
    win = txn & (got[:, 0] == key) & (~has_victim | (got[:, 1] == key))
    d1s, d1c, d1o, d1m = dm1[:, 0], dm1[:, 1], dm1[:, 2], dm1[:, 3]
    d_u = d1s == D_U
    d_em = d1s == D_EM
    # the EM owner's copy after its burst: same-round local writes by
    # the owner are visible (hits order before transactions)
    safe_o = torch.clamp(d1o, 0, N - 1)
    val_o = ix.gather(cv.reshape(-1), safe_o * C + ci)

    # ---- transaction outcomes --------------------------------------------
    rd_w, wr_w, up_w = win & rd_miss, win & wr_miss, win & upg
    wlike = wr_w | up_w
    n1s = torch.where(wlike, D_EM, wi(rd_w & d_u, D_EM, D_S))
    n1c = torch.where(wlike | (rd_w & d_u), 1,
                      torch.where(rd_w & d_em, 2, d1c + 1))
    n1o = torch.where(wlike | (rd_w & d_u), rows, d1o)
    n1m = torch.where((rd_w | wr_w) & d_em, val_o, d1m)
    act1 = torch.where(wlike, ACT_KILL,
                       wi(rd_w & d_em, ACT_DOWNGRADE, ACT_NONE))
    # victim entry (EVICT_SHARED / EVICT_MODIFIED semantics)
    ev = win & has_victim
    ev_mod = ev & (l_state == MOD)
    ev_sh = ev & ~ev_mod
    d2c, d2m = dm2[:, 1], dm2[:, 3]
    n2c = torch.where(ev_mod, 0, d2c - 1)
    n2s = torch.where(n2c == 0, D_U, wi(n2c == 1, D_EM, D_S))
    n2m = torch.where(ev_mod, l_val, d2m)
    n2o = dm2[:, 2]     # updated by the promoted line's own scatter
    act2 = wi(ev_sh & (n2c == 1), ACT_PROMOTE, ACT_NONE)

    # ---- commit: one packed scatter for both entries ---------------------
    # winners stamp their entries with this round's action; the claim
    # column is re-written with the winner's own key, the current minimum
    rtag = st.round << 2
    t_idx = torch.cat([torch.where(win, e1, E), torch.where(ev, e2, E)])
    t_dm = torch.cat([
        torch.stack([n1s, n1c, n1o, n1m, rtag | act1, rows, key], dim=1),
        torch.stack([n2s, n2c, n2o, n2m, rtag | act2, rows, key], dim=1)])
    dm = ix.scatter_rows(dm_claimed, t_idx, t_dm)

    cs, dm, kill_n, promo_n = _fan_out(cfg, st, ix, dm, ca, cs, 1)

    # ---- winner fills its own line ---------------------------------------
    fill_state = torch.where(
        rd_w, wi(d_u, int(CacheState.EXCLUSIVE), int(CacheState.SHARED)),
        MOD)
    fill_val = torch.where(rd_w, torch.where(d_em, val_o, d1m), val)
    fmask = ((torch.arange(C, dtype=I32, device=dev)[None, :]
              == ci[:, None]) & win[:, None])
    ca = torch.where(fmask, addr[:, None], ca)
    cv = torch.where(fmask, fill_val[:, None], cv)
    cs = torch.where(fmask, fill_state[:, None], cs)

    # ---- bookkeeping -----------------------------------------------------
    n_ret = d + win.to(I32)
    deltas = torch.sum(torch.stack([
        n_ret, rh_n, wh_n, rd_w.to(I32), wr_w.to(I32), up_w.to(I32),
        (txn & ~win).to(I32), ev.to(I32), kill_n, promo_n]),
        dim=1, dtype=I32)
    new_st = st.replace(cache_addr=ca, cache_val=cv, cache_state=cs,
                        dm=dm, idx=idx0 + n_ret, round=st.round + 1,
                        metrics=st.metrics.after_round(deltas))
    if not with_events:
        return new_st
    # burst slots below d, plus the transaction slot when it won (slot
    # order is program order within the round)
    offs = torch.arange(H + 1, dtype=I32, device=dev)[None, :]
    slot_retired = (offs < d[:, None]) | ((offs == d[:, None])
                                          & win[:, None])
    return new_st, {"retired": slot_retired, "op": w_oa >> 28,
                    "addr": w_oa & 0x0FFFFFFF, "value": w_val}


#: the per-slot transaction records of the window fold, in the order of
#: the window kernel's slot output (``pos``, the step index, follows)
SLOT_FIELDS = ("ok", "e1", "e2", "val", "v_val", "victim", "rd", "wr",
               "up", "v_mod", "rel_ordn", "acq_basen")


def window_fold(cfg: SystemConfig, w_oa, w_val, w_live, ca, cv, cs):
    """The sequential pre-claim fold of the multi-transaction round over
    one window, on [N] vectors: ``w_oa``/``w_val``/``w_live`` are lists
    of W per-step vectors, ``ca``/``cv``/``cs`` lists of C per-line
    vectors. Returns (steps, cv_pre): one record per step, and the cache
    values frozen at each node's first admitted transaction (what foreign
    transactions observe of the node).

    The admission rules (distinct entries with release and reacquire,
    hit admission, dependent hits on E/S-ambiguous read fills) are those
    of JAX ``_round_step_multi``; both the plain round and the plain
    versions of the window kernels run this one fold."""
    C, K = cfg.cache_size, cfg.txn_width
    E = cfg.num_nodes << cfg.block_bits
    INV = int(CacheState.INVALID)
    MOD = int(CacheState.MODIFIED)
    EXC = int(CacheState.EXCLUSIVE)
    SHD = int(CacheState.SHARED)
    kvec = torch.full_like(ca[0], K)
    false = torch.zeros_like(ca[0], dtype=torch.bool)

    ca_f, cv_f, cs_f = list(ca), list(cv), list(cs)
    # per-line ordinal of the window read fill holding it (K = none):
    # writes to such lines are tentative hits, resolved post-claim
    fo_f = [kvec] * C
    cv_pre = list(cv_f)
    frozen, stopped = false, false        # has a txn / window stopped
    n_txn = torch.zeros_like(ca[0])
    fills, victs, steps = [], [], []
    for oa, val, live in zip(w_oa, w_val, w_live):
        op, addr = oa >> 28, oa & 0x0FFFFFFF
        ci = codec.cache_index(cfg, addr)
        l_addr, l_val, l_state, l_fo = ca_f[0], cv_f[0], cs_f[0], fo_f[0]
        onehot = [ci == c for c in range(C)]
        for c in range(1, C):
            m = onehot[c]
            l_addr = torch.where(m, ca_f[c], l_addr)
            l_val = torch.where(m, cv_f[c], l_val)
            l_state = torch.where(m, cs_f[c], l_state)
            l_fo = torch.where(m, fo_f[c], l_fo)
        tag_ok = (l_addr == addr) & (l_state != INV)
        is_rd, is_wr = op == int(Op.READ), op == int(Op.WRITE)
        rd_hit = live & is_rd & tag_ok
        wr_hit = live & is_wr & tag_ok & ((l_state == MOD)
                                          | (l_state == EXC))
        wr_dep = live & is_wr & tag_ok & (l_state == SHD) & (l_fo < K)
        hit = rd_hit | wr_hit | wr_dep | (live & (op == int(Op.NOP)))
        upg = live & is_wr & tag_ok & (l_state == SHD) & (l_fo == K)
        rd_miss = live & is_rd & ~tag_ok
        wr_miss = live & is_wr & ~tag_ok
        e1 = torch.clamp(addr, 0, E - 1)
        has_victim = ~tag_ok & (l_state != INV) & (l_addr != addr)
        e2 = torch.clamp(l_addr, 0, E - 1)
        own1, dup = false, false   # e1 claimed by / re-touched in the window
        rel_ord, acq_base = kvec, kvec
        for te, tv, tord in fills:
            own1 = own1 | (tv & (te == e1))
            # displacing a prior fill is a release (the rows compose)
            rel_ord = torch.where(tv & has_victim & (te == e2), tord,
                                  rel_ord)
        dup = own1
        for te, tv, tord, telig in victs:
            m = tv & (te == e1)
            dup = dup | (m & ~telig)      # reacquire after a SHARED evict
            acq_base = torch.where(m & telig, tord, acq_base)
        # interior hits on unclaimed entries retire tentatively; their
        # safety resolves post-claim and truncates on failure
        hc = hit & ~stopped & frozen & ~own1
        hit_ok = (hit & ~stopped & (~frozen | own1)) | hc
        txn = (rd_miss | wr_miss | upg) & ~stopped
        ok = txn & ~dup & (n_txn < K)
        rel_ord = torch.where(ok, rel_ord, kvec)
        acq_base = torch.where(ok, acq_base, kvec)
        stop_now = ~hit_ok & ~ok & ~stopped
        wlike_f = ok & (wr_miss | upg)
        # a reacquire read fills EXCLUSIVE for certain; any other read
        # fill is E/S-ambiguous and records its ordinal
        ambig_rd = ok & rd_miss & (acq_base == K)
        fill_cs = torch.where(wlike_f, MOD, wi(acq_base < K, EXC, SHD))
        wr_eff = (wr_hit | wr_dep) & hit_ok
        for c in range(C):
            wm = wr_eff & onehot[c]
            cv_f[c] = torch.where(wm, val, cv_f[c])
            cs_f[c] = torch.where(wm, MOD, cs_f[c])
            cv_pre[c] = torch.where(frozen, cv_pre[c], cv_f[c])
        frozen = frozen | ok
        for c in range(C):
            fm = ok & onehot[c]
            ca_f[c] = torch.where(fm, addr, ca_f[c])
            cv_f[c] = torch.where(wlike_f & onehot[c], val, cv_f[c])
            cs_f[c] = torch.where(fm, fill_cs, cs_f[c])
            fo_f[c] = torch.where(fm, torch.where(ambig_rd, n_txn, kvec),
                                  fo_f[c])
        steps.append(dict(
            hit_ok=hit_ok, rd_hit=rd_hit & hit_ok, wr_hit=wr_eff,
            dep=torch.where(wr_dep & hit_ok, l_fo, kvec),
            ok=ok, ordn=torch.where(ok, n_txn, kvec), addr=addr, val=val,
            ci=ci, e1=e1, e2=e2, victim=ok & has_victim,
            rd=ok & rd_miss, wr=ok & wr_miss, up=ok & upg, v_val=l_val,
            v_mod=l_state == MOD, rel_ordn=rel_ord, acq_basen=acq_base,
            hc=hc))
        fills.append((e1, ok, n_txn))
        # a victim is reacquirable when the displaced line was M/E (the
        # node was its sole holder, so the evict leaves the entry
        # Uncached) and it was the entry's first touch (not a release)
        victs.append((e2, ok & has_victim, n_txn,
                      ((l_state == MOD) | (l_state == EXC))
                      & (rel_ord == K)))
        n_txn = n_txn + ok.to(I32)
        stopped = stopped | stop_now
    return steps, cv_pre


def pack_slots(cfg: SystemConfig, steps) -> dict:
    """The steps' transaction records by ordinal: {field: K-list of [N]
    int32 vectors} for SLOT_FIELDS and ``pos`` (the step index); slot j
    holds the record of the step whose transaction ordinal is j, zeros
    where a node has no such transaction."""
    K = cfg.txn_width
    zero = torch.zeros_like(steps[0]["ordn"])
    out = {f: [] for f in SLOT_FIELDS + ("pos",)}
    for j in range(K):
        sel = [s["ordn"] == j for s in steps]
        for f in SLOT_FIELDS:
            acc = zero
            for s, m in zip(steps, sel):
                acc = torch.where(m, s[f].to(I32), acc)
            out[f].append(acc)
        pos = zero
        for k, m in enumerate(sel):
            pos = torch.where(m, k, pos)
        out["pos"].append(pos)
    return out


def replay_fold(cfg: SystemConfig, steps, first_lose, fill_state, fill_val,
                ca, cv, cs, with_retired: bool = False):
    """Apply the retired prefix of a folded window to the round-start
    cache: steps before ``first_lose`` [N] that were admitted, with read
    fills resolved to ``fill_state``/``fill_val`` (K-lists of [N]
    vectors by ordinal). ``ca``/``cv``/``cs`` are C-lists. Returns the
    committed cache lists, the retired/read-hit/write-hit counts [N]
    and, when asked, the per-step retired masks."""
    C, K = cfg.cache_size, cfg.txn_width
    MOD = int(CacheState.MODIFIED)
    ca_c, cv_c, cs_c = list(ca), list(cv), list(cs)
    zero = torch.zeros_like(first_lose)
    n_ret, rh, wh = zero, zero, zero
    retired = []
    for k, s in enumerate(steps):
        r = (k < first_lose) & (s["hit_ok"] | s["ok"])
        if with_retired:
            retired.append(r)
        n_ret = n_ret + r.to(I32)
        rh = rh + (s["rd_hit"] & r).to(I32)
        wh = wh + (s["wr_hit"] & r).to(I32)
        fs, fv = zero, zero
        for j in range(K):
            sj = s["ordn"] == j
            fs = torch.where(sj, fill_state[j], fs)
            fv = torch.where(sj, fill_val[j], fv)
        for c in range(C):
            mc = s["ci"] == c
            wm = s["wr_hit"] & r & mc
            cv_c[c] = torch.where(wm, s["val"], cv_c[c])
            cs_c[c] = torch.where(wm, MOD, cs_c[c])
            fm = s["ok"] & r & mc
            ca_c[c] = torch.where(fm, s["addr"], ca_c[c])
            cv_c[c] = torch.where(fm, fv, cv_c[c])
            cs_c[c] = torch.where(fm, fs, cs_c[c])
    return ca_c, cv_c, cs_c, n_ret, rh, wh, retired


def multi_middle(cfg: SystemConfig, st: SyncState, ix, slot: dict, hc_w,
                 dep_w, he_w, cv_pre: torch.Tensor, ax: int) -> dict:
    """The multi-transaction round between its two folds: claim
    scatter-min, the one row gather, win and truncation resolution,
    transaction outcomes with release and reacquire composition, and
    the commit scatter.

    One body for the round's two layouts. ``ax`` is the slot axis:
    1 for the plain round's [N, K] records and [N, C] prefix cache
    (``_round_step_multi``), 0 for the kernel route's transposed [K, N]
    and [C, N] (``sync_window_kernel.round_step_multi_kernel``).
    ``slot`` maps SLOT_FIELDS + ``pos`` to int32 records; ``hc_w``,
    ``dep_w``, ``he_w`` are W-lists of per-step [N] vectors (interior-hit
    probe, dependent-write ordinal, step entry). Returns the committed
    directory, ``first_lose`` [N], the resolved ``fill_state`` and
    ``fill_val`` (slot layout) and five per-node counts."""
    N, C = cfg.num_nodes, cfg.cache_size
    K = cfg.txn_width
    W = len(he_w)
    E = N << cfg.block_bits
    dev = st.device
    MOD = int(CacheState.MODIFIED)
    EXC = int(CacheState.EXCLUSIVE)
    SHD = int(CacheState.SHARED)
    D_U, D_S, D_EM = int(DirState.U), int(DirState.S), int(DirState.EM)
    rows = torch.arange(N, dtype=I32, device=dev)
    shape = (N, K) if ax == 1 else (K, N)

    def vec(v):
        """An [N] vector against the slot layout."""
        return v.unsqueeze(ax)

    def one(x, j):
        """Slot j of a slot-layout tensor, axis kept."""
        return x.narrow(ax, j, 1)

    exists = slot["ok"] != 0
    e1_s, e2_s = slot["e1"], slot["e2"]
    val_s, v_val_s = slot["val"], slot["v_val"]
    victim_s = slot["victim"] != 0
    rd_s, wr_s, up_s = slot["rd"] != 0, slot["wr"] != 0, slot["up"] != 0
    v_mod_s = (slot["v_mod"] != 0) & victim_s
    # releasing slot r displaces the fill of slot rel_s[r]; a reacquire
    # chains off the post-evict row of slot acqb_s[r] (K = none)
    rel_s = torch.where(exists, slot["rel_ordn"], K)
    acqb_s = torch.where(exists, slot["acq_basen"], K)
    pos_s = slot["pos"]

    # ---- claim + win resolution ------------------------------------------
    key = _round_key(cfg, st, rows)
    c_idx = torch.cat(
        [torch.where(exists.select(ax, j), e1_s.select(ax, j), E)
         for j in range(K)]
        + [torch.where(victim_s.select(ax, j), e2_s.select(ax, j), E)
           for j in range(K)])
    dm_claimed = _claim(ix, st.dm, c_idx, key.repeat(2 * K))
    # one row gather serves the txn entries, the victim entries and the
    # interior-hit safety probes
    g = ix.gather_rows(dm_claimed, torch.cat(
        [e1_s, e2_s, torch.stack(he_w, dim=ax)], dim=ax))
    d1, d2 = g.narrow(ax, 0, K), g.narrow(ax, K, K)
    hgot = g.narrow(ax, 2 * K, W)[..., DM_CLAIM]
    win = exists & (d1[..., DM_CLAIM] == vec(key)) & (
        ~victim_s | (d2[..., DM_CLAIM] == vec(key)))
    # fresh keys of this round sit strictly below every stale key
    prio_bits = max(1, (N - 1).bit_length())
    thresh = (torch.clamp(claim_max_rounds(cfg) - st.round, min=0) + 1) \
        << prio_bits

    # ---- effective primary rows (before commit: truncation needs d_u) ----
    d1s, d1c, d1o, d1m = (d1[..., DM_STATE], d1[..., DM_COUNT],
                          d1[..., DM_OWNER], d1[..., DM_MEM])
    d2c, d2o, d2m = d2[..., DM_COUNT], d2[..., DM_OWNER], d2[..., DM_MEM]
    # a reacquired entry is Uncached with the evict's memory (the flushed
    # value for an M line)
    pe_m = torch.where(v_mod_s, v_val_s, d2m)
    base_u = torch.zeros(shape, dtype=torch.bool, device=dev)
    base_m = torch.zeros(shape, dtype=I32, device=dev)
    for i in range(K):
        m = acqb_s == i
        base_u = base_u | m
        base_m = torch.where(m, one(pe_m, i), base_m)
    d1s = torch.where(base_u, D_U, d1s)
    d1c = torch.where(base_u, 0, d1c)
    d1m = torch.where(base_u, base_m, d1m)
    d_u = d1s == D_U
    d_em = d1s == D_EM

    # tentative writes on own read fills retire iff the fill resolved
    # EXCLUSIVE; interior hits iff their entry carries no fresh foreign
    # claim. The first failure truncates retirement at its step.
    first_bad_hit = torch.full((N,), W, dtype=I32, device=dev)
    for k in range(W):
        dep = dep_w[k]
        dok = torch.zeros((N,), dtype=torch.bool, device=dev)
        for j in range(K):
            dok = dok | ((dep == j) & d_u.select(ax, j))
        hg = hgot.select(ax, k)
        unsafe = ((hc_w[k] & ~((hg >= thresh) | (hg == key)))
                  | ((dep < K) & ~dok))
        first_bad_hit = torch.minimum(first_bad_hit,
                                      wi(unsafe, k, W))
    # committed = the leading prefix of transactions that win their
    # claims and sit before any unsafe hit
    eligible = win & (pos_s < vec(first_bad_hit))
    run = torch.ones((N,), dtype=torch.bool, device=dev)
    cum = []
    for j in range(K):
        run = run & (eligible.select(ax, j) | ~exists.select(ax, j))
        cum.append(run)
    cum = torch.stack(cum, dim=ax)
    commit = exists & cum
    first_lose = torch.minimum(
        torch.amin(torch.where(exists & ~cum, pos_s, W), dim=ax),
        first_bad_hit)

    # ---- transaction outcomes (round-start rows; entries disjoint) -------
    rd_w, wr_w, up_w = commit & rd_s, commit & wr_s, commit & up_s
    wlike = wr_w | up_w
    ci_s = codec.cache_index(cfg, e1_s)
    safe_o = torch.clamp(d1o, 0, N - 1)
    # the owner's line in the prefix cache: [N, C] or [C, N] flat
    val_o = ix.gather(cv_pre.reshape(-1),
                      safe_o * C + ci_s if ax == 1 else ci_s * N + safe_o)
    n1s = wi(wlike | (rd_w & d_u), D_EM, D_S)
    n1c = torch.where(wlike | (rd_w & d_u), 1,
                      torch.where(rd_w & d_em, 2, d1c + 1))
    n1o = torch.where(wlike | (rd_w & d_u), vec(rows), d1o)
    n1m = torch.where((rd_w | wr_w) & d_em, val_o, d1m)
    act1 = torch.where(wlike, ACT_KILL,
                       wi(rd_w & d_em, ACT_DOWNGRADE, ACT_NONE))
    ev = commit & victim_s
    ev_mod = ev & v_mod_s
    ev_sh = ev & ~ev_mod
    n2c = torch.where(ev_mod, 0, d2c - 1)
    n2s = torch.where(n2c == 0, D_U, wi(n2c == 1, D_EM, D_S))
    n2m = torch.where(ev_mod, v_val_s, d2m)
    act2 = wi(ev_sh & (n2c == 1), ACT_PROMOTE, ACT_NONE)

    # ---- release composition: fill-then-self-evict as one row ------------
    # a committed txn r whose victim is slot j's own fill releases slot
    # j: entry e1_j's final row is the acquire outcome followed by the
    # self-eviction, written by slot j's scatter alone
    j_iota = torch.arange(K, dtype=I32, device=dev).unsqueeze(1 - ax)
    released = torch.zeros(shape, dtype=torch.bool, device=dev)
    rel_val = torch.zeros(shape, dtype=I32, device=dev)
    rel_dirty = torch.zeros(shape, dtype=torch.bool, device=dev)
    consumed = torch.zeros(shape, dtype=torch.bool, device=dev)
    for r in range(K):
        m = one(commit, r) & (one(rel_s, r) == j_iota)
        released = released | m
        rel_val = torch.where(m, one(v_val_s, r), rel_val)
        rel_dirty = rel_dirty | (m & one(v_mod_s, r))
        consumed = consumed | (one(commit, r) & (one(acqb_s, r) == j_iota))
    rd_rel_s = released & rd_s & ~d_u & ~d_em                     # rd on S
    r1s = torch.where(wlike | (rd_s & d_u), D_U,
                      torch.where(rd_s & d_em, D_EM,
                                  wi(d1c == 1, D_EM, D_S)))
    r1c = torch.where(wlike | (rd_s & d_u), 0,
                      torch.where(rd_s & d_em, 1, d1c))
    # rel_dirty: a read fill written through a dependent hit before its
    # displacement flushes the written value, like a MODIFIED evict
    r1m = torch.where(wlike | rel_dirty, rel_val,
                      torch.where(rd_s & d_em, val_o, d1m))
    r1a = torch.where(wlike, ACT_KILL,
                      wi((rd_s & d_em) | (rd_rel_s & (d1c == 1)),
                          ACT_PROMOTE, ACT_NONE))
    n1s = torch.where(released, r1s, n1s)
    n1c = torch.where(released, r1c, n1c)
    n1o = torch.where(released, d1o, n1o)
    n1m = torch.where(released, r1m, n1m)
    act1 = torch.where(released, r1a, act1)
    # a release's victim row rides in slot j's composed scatter, and a
    # reacquired entry's row is written by the reacquiring slot alone
    ev_sep = ev & (rel_s == K) & ~consumed

    # ---- commit: one packed scatter for all entries ----------------------
    # whole 7-column rows; committed rows are unique, dropped ones share
    # the spare row
    rtag = st.round << 2
    rowsK = vec(rows).expand(shape)
    keyK = vec(key).expand(shape)
    t_idx = torch.cat([torch.where(commit, e1_s, E).reshape(-1),
                       torch.where(ev_sep, e2_s, E).reshape(-1)])
    t_dm = torch.cat([
        torch.stack([n1s, n1c, n1o, n1m, rtag | act1, rowsK, keyK],
                    dim=-1).reshape(-1, DM_COLS),
        torch.stack([n2s, n2c, d2o, n2m, rtag | act2, rowsK, keyK],
                    dim=-1).reshape(-1, DM_COLS)])
    dm = ix.scatter_rows(dm_claimed, t_idx, t_dm)

    fill_state = torch.where(rd_s, wi(d_u, EXC, SHD), MOD)
    fill_val = torch.where(rd_s, torch.where(d_em, val_o, d1m), val_s)
    # conflicts count claim-arbitration losses only, not slots truncated
    # by an earlier loss or a failed dependent or interior hit
    counts = [torch.sum(x, dim=ax, dtype=I32)
              for x in (rd_w, wr_w, up_w, exists & ~win, ev)]
    return dict(dm=dm, first_lose=first_lose, fill_state=fill_state,
                fill_val=fill_val, counts=counts)


def multi_finish(cfg: SystemConfig, st: SyncState, ix, mid: dict, ca_c,
                 cv_c, cs_c, n_ret, rh_n, wh_n, ax: int) -> SyncState:
    """The end of a multi-transaction round: the fan-out on the replayed
    cache ([N, C] for ``ax`` 1, [C, N] for ``ax`` 0), metrics and
    cursors."""
    cs_c, dm, kill_n, promo_n = _fan_out(cfg, st, ix, mid["dm"], ca_c,
                                         cs_c, ax)
    rd_n, wr_n, up_n, lost_n, ev_n = mid["counts"]
    deltas = torch.sum(torch.stack([
        n_ret, rh_n, wh_n, rd_n, wr_n, up_n, lost_n, ev_n, kill_n,
        promo_n]), dim=1, dtype=I32)
    if ax == 0:
        ca_c, cv_c, cs_c = (t.T.contiguous() for t in (ca_c, cv_c, cs_c))
    return st.replace(cache_addr=ca_c, cache_val=cv_c, cache_state=cs_c,
                      dm=dm, idx=st.idx + n_ret, round=st.round + 1,
                      metrics=st.metrics.after_round(deltas))


def _round_step_multi(cfg: SystemConfig, st: SyncState,
                      with_events: bool = False):
    """Advance every node by a window of up to cfg.txn_width
    transactions (JAX ``_round_step_multi``), in the [N, K] layout and
    in plain tensor code: the window (procedural hash or stored-trace
    gather), the pre-claim fold, the middle, the replay of the retired
    prefix, the fan-out. Per-round index work matches the single round
    (one claim scatter-min, one row gather, one commit scatter, one
    fan-out gather, one promotion scatter) with K-times larger index
    vectors."""
    K = cfg.txn_width
    W = cfg.drain_depth + K
    ix = _index_ops()
    w_oa, w_val, w_live = instr_window(cfg, st.idx, st.instr_count,
                                       st.instr_pack, W)
    cache = [list(t.unbind(1)) for t in (st.cache_addr, st.cache_val,
                                         st.cache_state)]
    steps, cv_pre = window_fold(cfg, w_oa.unbind(1), w_val.unbind(1),
                                w_live.unbind(1), *cache)
    slot = {f: torch.stack(v, dim=1)
            for f, v in pack_slots(cfg, steps).items()}           # [N, K]
    mid = multi_middle(cfg, st, ix, slot, [s["hc"] for s in steps],
                       [s["dep"] for s in steps],
                       [s["e1"] for s in steps],
                       torch.stack(cv_pre, dim=1), 1)
    ca_c, cv_c, cs_c, n_ret, rh_n, wh_n, retired = replay_fold(
        cfg, steps, mid["first_lose"], mid["fill_state"].unbind(1),
        mid["fill_val"].unbind(1), *cache, with_retired=with_events)
    new_st = multi_finish(cfg, st, ix, mid, torch.stack(ca_c, dim=1),
                          torch.stack(cv_c, dim=1),
                          torch.stack(cs_c, dim=1), n_ret, rh_n, wh_n, 1)
    if not with_events:
        return new_st
    return new_st, {"retired": torch.stack(retired, dim=1),
                    "op": w_oa >> 28, "addr": w_oa & 0x0FFFFFFF,
                    "value": w_val}


def round_step(cfg: SystemConfig, st: SyncState,
               fold_impl: str = "kernel", with_events: bool = False):
    """One transactional round; dispatches as JAX ``round_step`` does.

    Deep-window configs run the whole round as one kernel
    (``deep_round_kernel.round_step_deep_fused``) under
    ``cfg.fused_round`` where ``deep_round_kernel.supported(cfg)``
    holds, and ``deep_engine.round_step_deep`` otherwise. The others
    run ``_round_step_single`` (txn_width 1) or ``_round_step_multi``;
    under ``cfg.pallas_burst`` on a procedural workload without event
    tracing they go through the CUDA kernels' wrappers instead: the
    txn_width 1 round as one kernel
    (``sync_round_kernel.round_step_fused``, where
    ``sync_round_kernel.supported(cfg)`` holds; else the burst kernel
    inside ``_round_step_single``), and the other as one kernel too
    (``sync_multi_round_kernel.round_step_fused``, where
    ``sync_multi_round_kernel.supported(cfg)`` holds; else its two
    window folds as kernels,
    ``sync_window_kernel.round_step_multi_kernel``). Unlike the TPU
    kernels these need no tiling of the node axis, so every N takes
    that route; the results are bit-identical either way.

    ``fold_impl="plain"`` runs the plain version of whichever kernel
    the route would launch, on any device. ``with_events`` also returns
    the round's retirement record; a deep round then takes the fold path
    (``round_step_deep``, the fold kernels on the card), never the fused
    round, as in JAX."""
    if fold_impl not in ("kernel", "plain"):
        raise ValueError(f"fold_impl must be 'kernel' or 'plain', "
                         f"not {fold_impl!r}")
    if cfg.deep_window:
        if cfg.fused_round and not with_events:
            from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
                deep_round_kernel)
            if deep_round_kernel.supported(cfg):
                return deep_round_kernel.round_step_deep_fused(
                    cfg, st, fold_impl)
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops.deep_engine \
            import round_step_deep
        return round_step_deep(cfg, st, fold_impl=fold_impl,
                               with_events=with_events)
    use_kernel = False
    if cfg.pallas_burst and cfg.procedural and not with_events:
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
            sync_burst_kernel)
        use_kernel = sync_burst_kernel.supported(cfg)
    if cfg.txn_width == 1:
        if use_kernel:
            from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
                sync_round_kernel)
            if sync_round_kernel.supported(cfg):
                return sync_round_kernel.round_step_fused(cfg, st,
                                                          fold_impl)
        return _round_step_single(cfg, st, with_events,
                                  use_kernel=use_kernel,
                                  fold_impl=fold_impl)
    if use_kernel:
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
            sync_multi_round_kernel, sync_window_kernel)
        if sync_multi_round_kernel.supported(cfg):
            return sync_multi_round_kernel.round_step_fused(cfg, st,
                                                            fold_impl)
        return sync_window_kernel.round_step_multi_kernel(cfg, st,
                                                          fold_impl)
    return _round_step_multi(cfg, st, with_events)


# -- runners -----------------------------------------------------------------

def run_rounds(cfg: SystemConfig, st: SyncState, n: int,
               fold_impl: str = "kernel") -> SyncState:
    _assert_round_budget(cfg, st.round, n)
    for _ in range(n):
        st = round_step(cfg, st, fold_impl)
    return st


def run_rounds_traced(cfg: SystemConfig, st: SyncState, n: int):
    """Run n rounds collecting the retirement record: (state, events)
    with events [n, N, window] tensors (``utils.eventlog.
    sync_to_records``)."""
    _assert_round_budget(cfg, st.round, n)
    per_round = []
    for _ in range(n):
        st, ev = round_step(cfg, st, with_events=True)
        per_round.append(ev)
    return st, {f: torch.stack([ev[f] for ev in per_round])
                for f in ("retired", "op", "addr", "value")}


# lint: host
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


def run_sync_profile(cfg: SystemConfig, st: SyncState, n: int):
    """Run n rounds accumulating per-(node, address) retired-access
    planes for the coherence profiler (``obs/cohprof.py``; JAX
    ``ops/sync_engine.py:1376``).

    Returns ``(state, rd, wr)`` with rd/wr [N, N << block_bits] int32:
    the retired READs and WRITEs of each round's retirement record. The
    planes ride the carry (one flat [N * A] plane each, added into in
    place), so the capture's memory is independent of n; a lane that
    did not retire adds 0 at its clipped address. The rounds are
    ``round_step(..., with_events=True)``: the plain rounds, never a
    fused round kernel, on every device (as the JAX runner's)."""
    _assert_round_budget(cfg, st.round, n)
    N = cfg.num_nodes
    A = N << cfg.block_bits
    dev = st.cache_addr.device
    rows = torch.arange(N, dtype=torch.int64, device=dev)
    rd = torch.zeros(N * A, dtype=I32, device=dev)
    wr = torch.zeros(N * A, dtype=I32, device=dev)
    for _ in range(n):
        st, ev = round_step(cfg, st, with_events=True)
        ret = ev["retired"]                                   # [N, W]
        flat = (rows[:, None] * A
                + ev["addr"].clamp(0, A - 1).to(torch.int64)).reshape(-1)
        rd.index_add_(0, flat, (ret & (ev["op"] == int(Op.READ)))
                      .reshape(-1).to(I32))
        wr.index_add_(0, flat, (ret & (ev["op"] == int(Op.WRITE)))
                      .reshape(-1).to(I32))
    return st, rd.reshape(N, A), wr.reshape(N, A)


# -- ensembles ---------------------------------------------------------------
#
# An ensemble runs R independent machines (other workloads or arbitration
# seeds) on one leading axis: the schedule search of the racy suites
# (utils.search) and throughput at small N. Every path of the port is
# host-bound (PERF.md), so on the fused sync rounds one launch a round for
# all R machines costs about what one machine's launch costs.

def make_ensemble(states) -> SyncState:
    """Stack per-replica SyncStates into one ensemble state: every leaf
    gains a leading replica axis R (cache planes [R, N, C], dm [R, E, 7],
    seed and round [R], the counters [R, 11]), contiguous."""
    return SyncState(
        **{f: torch.stack([getattr(s, f) for s in states])
           for f in STATE_FIELDS},
        metrics=SyncMetrics(torch.stack([s.metrics.buffer()
                                         for s in states])))


def ensemble_replica(st: SyncState, r: int) -> SyncState:
    """Replica r of an ensemble state, as a machine of its own (a copy)."""
    return SyncState(**{f: getattr(st, f)[r].clone() for f in STATE_FIELDS},
                     metrics=SyncMetrics(st.metrics.buffer()[r].clone()))


def _ensemble_kernel(cfg: SystemConfig):
    """The fused round kernel module whose replica axis runs an ensemble
    round of ``cfg`` in one launch, or None: the route ``round_step``
    takes for one machine (procedural, ``cfg.pallas_burst``, no
    deep_window), where that kernel's ``supported(cfg)`` holds."""
    if cfg.deep_window or not (cfg.pallas_burst and cfg.procedural):
        return None
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_burst_kernel, sync_multi_round_kernel, sync_round_kernel)
    if not sync_burst_kernel.supported(cfg):
        return None
    mod = sync_round_kernel if cfg.txn_width == 1 else (
        sync_multi_round_kernel)
    return mod if mod.supported(cfg) else None


def ensemble_round_step(cfg: SystemConfig, st: SyncState,
                        fold_impl: str = "kernel") -> SyncState:
    """One round of every replica of an ensemble, dispatched as
    ``round_step`` dispatches one machine's round.

    Where ``round_step`` would take a fused sync round kernel
    (``sync_round_kernel`` at txn_width 1, ``sync_multi_round_kernel``
    above it), the whole ensemble goes through that wrapper's replica
    axis: one launch for all R replicas on the card (``fold_impl=
    "plain"``: the plain version, a loop over replicas). Every other
    config (stored traces, deep configs fused or fold, the burst and
    window kernel routes) steps each replica through ``round_step`` and
    restacks the results, so on the card a deep ensemble launches its
    kernels R times a round."""
    if fold_impl not in ("kernel", "plain"):
        raise ValueError(f"fold_impl must be 'kernel' or 'plain', "
                         f"not {fold_impl!r}")
    mod = _ensemble_kernel(cfg)
    if mod is not None:
        return mod.round_step_fused(cfg, st, fold_impl)
    R = st.round.shape[0]
    return make_ensemble([round_step(cfg, ensemble_replica(st, r),
                                     fold_impl) for r in range(R)])


# lint: host
def run_ensemble_to_quiescence(cfg: SystemConfig, st: SyncState,
                               chunk: int = 32, max_rounds: int = 100_000,
                               fold_impl: str = "kernel") -> SyncState:
    """Run an ensemble until every replica's traces retire. Every
    replica steps every round, quiescent ones included (a quiescent
    replica is a fixpoint, but its round and ``rounds`` counter
    advance), and "all quiescent" is tested only between ``chunk``-round
    blocks, as the JAX package's vmapped runner does."""
    _assert_round_budget(cfg, st.round[0], max_rounds)
    r = int(st.round[0])
    limit = r + max_rounds
    while r < limit and not bool(st.quiescent()):
        for _ in range(chunk):
            st = ensemble_round_step(cfg, st, fold_impl)
        r += chunk
    return st
