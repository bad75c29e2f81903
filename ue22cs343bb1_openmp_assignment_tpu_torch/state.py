"""Machine state: the cold memory image and instruction tables both
engines build from, and the message-level engine's ``SimState`` with its
metrics and bitvector helpers (the JAX package's ``state.py``).

``initializeProcessor`` (``assignment.c:806-851``): memory block *i* of
node *t* starts at ``(20*t + i) & 0xFF``, directory entries start
Unowned with empty sharer bitvectors, cache lines start INVALID with the
sentinel address. The transactional engine keeps an exact directory and
builds only the memory image and the instruction tables from here.

The batch helpers (``stack_states``, ``index_state``, ``set_state``,
``batch_size``, ``batch_quiescent``) give a SimState a leading job axis:
the serving layer's waves (``ops.step.batched_wave``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.types import Op
from ue22cs343bb1_openmp_assignment_tpu_torch.utils.random import prng_key


def cold_memory(cfg: SystemConfig, device) -> torch.Tensor:
    """[N, M] int32 memory image of a fresh machine."""
    N, M = cfg.num_nodes, cfg.mem_size
    nodes = torch.arange(N, dtype=torch.int32, device=device)[:, None]
    blocks = torch.arange(M, dtype=torch.int32, device=device)[None, :]
    return (20 * nodes + blocks) & 0xFF


def as_int32(a, device) -> torch.Tensor:
    """An int32 tensor on ``device`` from a tensor (on any device), a
    numpy array or a sequence."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device)


def build_instr_arrays(cfg: SystemConfig, device, traces=None,
                       instr_arrays=None):
    """(op, addr, val, count) [N, T] int32 tensors from traces or
    prebuilt arrays; nodes past the end of ``traces`` get empty traces
    padded with NOPs, exactly as the JAX package builds them."""
    N, T = cfg.num_nodes, cfg.max_instrs
    if instr_arrays is not None:
        out = tuple(as_int32(a, device) for a in instr_arrays)
        if out[0].shape[1] != T:
            raise ValueError(
                f"instr_arrays trace length {out[0].shape[1]} != "
                f"cfg.max_instrs {T}")
        return out
    op_h = np.full((N, T), int(Op.NOP), np.int32)
    ad_h = np.zeros((N, T), np.int32)
    va_h = np.zeros((N, T), np.int32)
    cnt_h = np.zeros((N,), np.int32)
    for n, tr in enumerate(traces or []):
        tr = tr[:T]
        cnt_h[n] = len(tr)
        for i, (op, addr, val) in enumerate(tr):
            op_h[n, i] = int(op)
            ad_h[n, i] = int(addr)
            va_h[n, i] = int(val) & 0xFF
    return tuple(torch.from_numpy(a).to(device)
                 for a in (op_h, ad_h, va_h, cnt_h))


# -- the message-level engine's machine state (JAX state.py:36-233) --------
#
# Every field is an int32 tensor, or bool for ``waiting``. The JAX
# package's uint32 leaves (the sharer bitvector ``dir_bitvec`` and the
# fault key) are held as int32 bit patterns: torch's uint32 lacks shifts
# and most arithmetic, and the bit helpers below need only the patterns.

#: buckets of the miss-latency histogram: bucket b counts waits whose
#: issue-to-retire latency in cycles falls in [2^b, 2^(b+1)), the last
#: bucket everything beyond
LAT_BUCKETS = 16

# mb_pack plane layout: six scalar planes, then the bitvector words
MB_TYPE, MB_SENDER, MB_ADDR, MB_VALUE, MB_SECOND, MB_DIRSTATE, MB_BV0 = (
    0, 1, 2, 3, 4, 5, 6)

SIM_METRIC_FIELDS = ("cycles", "instrs_retired", "read_hits", "write_hits",
                     "read_misses", "write_misses", "upgrades",
                     "msgs_processed", "msgs_dropped",
                     "msgs_injected_dropped", "invalidations", "evictions",
                     "lat_hist", "mb_depth_peak")
SIM_FIELDS = ("cache_addr", "cache_val", "cache_state", "memory",
              "dir_state", "dir_bitvec", "instr_op", "instr_addr",
              "instr_val", "instr_count", "instr_idx", "cur_op", "cur_addr",
              "cur_val", "waiting", "waiting_since", "mb_pack", "mb_head",
              "mb_count", "issue_delay", "issue_period", "arb_rank",
              "order_rank", "fault_key", "cycle")
#: leaves the JAX package keeps as uint32 (here int32 bit patterns)
UINT32_FIELDS = ("dir_bitvec", "fault_key")


@dataclasses.dataclass
class Metrics:
    """Run counters (JAX state.Metrics): 0-d int32 tensors, and the
    per-type dequeue counts [13] and latency histogram [LAT_BUCKETS]."""

    cycles: torch.Tensor
    instrs_retired: torch.Tensor
    read_hits: torch.Tensor
    write_hits: torch.Tensor
    read_misses: torch.Tensor
    write_misses: torch.Tensor
    upgrades: torch.Tensor
    msgs_processed: torch.Tensor
    msgs_dropped: torch.Tensor
    msgs_injected_dropped: torch.Tensor
    invalidations: torch.Tensor
    evictions: torch.Tensor
    lat_hist: torch.Tensor
    mb_depth_peak: torch.Tensor

    @classmethod
    def zeros(cls, device) -> "Metrics":
        shapes = {"msgs_processed": (13,), "lat_hist": (LAT_BUCKETS,)}
        return cls(**{f: torch.zeros(shapes.get(f, ()), dtype=torch.int32,
                                     device=device)
                      for f in SIM_METRIC_FIELDS})

    def replace(self, **kw) -> "Metrics":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SimState:
    """The message-level machine (JAX state.SimState). N nodes, C cache
    lines, M memory blocks, T trace length, Q mailbox slots, W sharer
    words, Wm message bitvector words.

    cache_* [N, C]; memory, dir_state [N, M]; dir_bitvec [N, M, W]
    (uint32 words as int32 patterns); instr_* [N, T], instr_count and
    the per-node latches and knobs [N] (``waiting`` bool); mb_pack
    [6 + Wm, N, Q] (plane-major ring); order_rank [N, T] or [N, 0];
    fault_key [2]; cycle 0-d. All on one device."""

    cache_addr: torch.Tensor
    cache_val: torch.Tensor
    cache_state: torch.Tensor
    memory: torch.Tensor
    dir_state: torch.Tensor
    dir_bitvec: torch.Tensor
    instr_op: torch.Tensor
    instr_addr: torch.Tensor
    instr_val: torch.Tensor
    instr_count: torch.Tensor
    instr_idx: torch.Tensor
    cur_op: torch.Tensor
    cur_addr: torch.Tensor
    cur_val: torch.Tensor
    waiting: torch.Tensor
    waiting_since: torch.Tensor
    mb_pack: torch.Tensor
    mb_head: torch.Tensor
    mb_count: torch.Tensor
    issue_delay: torch.Tensor
    issue_period: torch.Tensor
    arb_rank: torch.Tensor
    order_rank: torch.Tensor
    fault_key: torch.Tensor
    cycle: torch.Tensor
    metrics: Metrics

    @property
    def num_nodes(self) -> int:
        return self.cache_addr.shape[0]

    @property
    def device(self) -> torch.device:
        return self.cache_addr.device

    def quiescent(self) -> torch.Tensor:
        """0-d bool: no message queued, no node blocked, traces done."""
        exhausted = self.instr_idx >= self.instr_count - 1
        return ((self.mb_count == 0).all() & (~self.waiting).all()
                & exhausted.all())

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def init_state(cfg: SystemConfig, traces=None, issue_delay=None,
               issue_period=None, instr_arrays=None, arb_rank=None,
               fault_seed: int = 0, order_rank=None,
               device=None) -> SimState:
    """A fresh machine (JAX state.init_state, ``initializeProcessor``,
    ``assignment.c:806-851``) on ``device`` (None: the card)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
    from ue22cs343bb1_openmp_assignment_tpu_torch.types import (
        CacheState, DirState, Msg)
    dev = _device.resolve(device)
    N, C, M = cfg.num_nodes, cfg.cache_size, cfg.mem_size
    Q, W, Wm = cfg.queue_capacity, cfg.bitvec_words, cfg.msg_bitvec_words
    i32 = torch.int32

    def knob(x, default):
        return default if x is None else as_int32(x, dev)

    op, addr, val, count = build_instr_arrays(
        cfg, dev, traces=traces, instr_arrays=instr_arrays)
    mb_pack = torch.zeros((6 + Wm, N, Q), dtype=i32, device=dev)
    mb_pack[MB_TYPE] = int(Msg.NONE)
    return SimState(
        cache_addr=torch.full((N, C), cfg.invalid_address, dtype=i32,
                              device=dev),
        cache_val=torch.zeros((N, C), dtype=i32, device=dev),
        cache_state=torch.full((N, C), int(CacheState.INVALID), dtype=i32,
                               device=dev),
        memory=cold_memory(cfg, dev),
        dir_state=torch.full((N, M), int(DirState.U), dtype=i32,
                             device=dev),
        dir_bitvec=torch.zeros((N, M, W), dtype=i32, device=dev),
        instr_op=op, instr_addr=addr, instr_val=val, instr_count=count,
        instr_idx=torch.full((N,), -1, dtype=i32, device=dev),
        cur_op=torch.zeros((N,), dtype=i32, device=dev),
        cur_addr=torch.zeros((N,), dtype=i32, device=dev),
        cur_val=torch.zeros((N,), dtype=i32, device=dev),
        waiting=torch.zeros((N,), dtype=torch.bool, device=dev),
        waiting_since=torch.full((N,), -1, dtype=i32, device=dev),
        mb_pack=mb_pack,
        mb_head=torch.zeros((N,), dtype=i32, device=dev),
        mb_count=torch.zeros((N,), dtype=i32, device=dev),
        issue_delay=knob(issue_delay,
                         torch.zeros((N,), dtype=i32, device=dev)),
        issue_period=knob(issue_period,
                          torch.ones((N,), dtype=i32, device=dev)),
        arb_rank=knob(arb_rank, torch.arange(N, dtype=i32, device=dev)),
        order_rank=knob(order_rank,
                        torch.zeros((N, 0), dtype=i32, device=dev)),
        fault_key=prng_key(fault_seed, dev),
        cycle=torch.zeros((), dtype=i32, device=dev),
        metrics=Metrics.zeros(dev),
    )


def continue_with_traces(cfg: SystemConfig, state: SimState, traces=None,
                         instr_arrays=None) -> SimState:
    """Stream the next trace phase into a quiescent machine (JAX
    ``state.continue_with_traces``): run to quiescence, swap in the next
    ``max_instrs``-sized chunk, continue. Caches, memories, directories,
    mailboxes and metrics persist; only the instruction stream resets.
    The new arrays go to the state's device. A host-side phase boundary:
    it reads the quiescence flag.

    Raises ValueError if the machine is not quiescent (in-flight
    messages or blocked nodes would interleave with the new phase).
    """
    if not bool(state.quiescent()):
        raise ValueError(
            "continue_with_traces needs a quiescent machine: messages "
            "in flight or nodes blocked (run to quiescence first)")
    dev = state.instr_op.device
    op, addr, val, count = build_instr_arrays(
        cfg, dev, traces=traces, instr_arrays=instr_arrays)
    return state.replace(
        instr_op=op, instr_addr=addr, instr_val=val, instr_count=count,
        instr_idx=torch.full((cfg.num_nodes,), -1, dtype=torch.int32,
                             device=dev))


def fault_key_from_seed(seed: int, device=None) -> torch.Tensor:
    """The fault-injection key of ``seed`` (JAX ``state.fault_key_from_seed``:
    ``jax.random.key_data(PRNGKey(seed))`` as uint32), as the [2] int32
    bit patterns every uint32 leaf of the port holds, on ``device``
    (None: the card)."""
    return prng_key(seed, device)


# -- batching: a leading job axis over the whole machine -------------------
#
# JAX state.py:303-360. Every SimState leaf keys its minor axes off the
# node axis, so the whole machine (caches, directory, traces, mailboxes,
# fault key, metrics) batches under one extra leading axis: a [B, ...]
# SimState of B independent machines, which ops.step's wave runners step
# with ``torch.func.vmap(cycle)``. The helpers below are the way in and
# out of the batch. ``state_leaves`` / ``from_leaves`` flatten a state
# to the tuple of tensors that vmap maps over (SIM_LEAVES order).

#: every leaf of a SimState in ``state_leaves`` order
SIM_LEAVES = SIM_FIELDS + tuple(f"metrics.{f}" for f in SIM_METRIC_FIELDS)


def state_leaves(state: SimState) -> tuple:
    """The state's tensors in SIM_LEAVES order."""
    return (tuple(getattr(state, f) for f in SIM_FIELDS)
            + tuple(getattr(state.metrics, f) for f in SIM_METRIC_FIELDS))


def from_leaves(leaves) -> SimState:
    """Inverse of ``state_leaves``."""
    n = len(SIM_FIELDS)
    return SimState(**dict(zip(SIM_FIELDS, leaves[:n])),
                    metrics=Metrics(**dict(zip(SIM_METRIC_FIELDS,
                                               leaves[n:]))))


def stack_states(states) -> SimState:
    """Stack per-job SimStates (identical shapes, one device) into one
    batched state with a leading job axis: leaf [..] -> [B, ..]."""
    return from_leaves(tuple(torch.stack(xs)
                             for xs in zip(*map(state_leaves, states))))


def index_state(bstate: SimState, i: int) -> SimState:
    """Job ``i`` of a batched state, as a copy: a later ``set_state`` or
    wave step cannot change it (the JAX contract, where the donated
    batch is never read again)."""
    return from_leaves(tuple(x[i].clone() for x in state_leaves(bstate)))


def set_state(bstate: SimState, i: int, state: SimState) -> SimState:
    """Write ``state`` into slot ``i`` of the batch, in place, and return
    the batch: the admission primitive of the serving layer. A wave
    runner's output batch shares its read-only leaves (the instruction
    and issue tables, ``ops.step._RO_FIELDS``) with the batch it was
    given, so this write reaches every earlier batch of the same run;
    only ``index_state`` copies are left as they were."""
    for b, s in zip(state_leaves(bstate), state_leaves(state)):
        b[i].copy_(s)
    return bstate


def batch_size(bstate: SimState) -> int:
    return bstate.cache_addr.shape[0]


def batch_quiescent(bstate: SimState) -> torch.Tensor:
    """[B] bool: ``SimState.quiescent`` of each job of a batched state."""
    exhausted = bstate.instr_idx >= bstate.instr_count - 1
    return ((bstate.mb_count == 0).all(-1) & (~bstate.waiting).all(-1)
            & exhausted.all(-1))


# -- bitvector helpers: uint32 words held as int32 patterns ---------------
#
# ``(w >> b) & 1`` reads bit b for any b in [0, 32) even though torch's
# shift is arithmetic; masks wider than one bit and counts go through
# int64 copies of the words masked to 32 bits.

_M32 = 0xFFFFFFFF


def bit_get(bv: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """bv [..., W] -> bool [...]: is `node`'s bit set (node in range)."""
    word = torch.div(node, 32, rounding_mode="floor").to(torch.int64)
    w = torch.gather(bv, -1, word[..., None])[..., 0]
    return ((w >> (node % 32)) & 1).bool()


def bit_single(num_words: int, node: torch.Tensor) -> torch.Tensor:
    """A bitvector with exactly `node`'s bit set: [...] -> [..., W]."""
    words = torch.arange(num_words, dtype=torch.int32, device=node.device)
    mask = (words == torch.div(node[..., None], 32,
                               rounding_mode="floor")).to(torch.int32)
    return mask << (node[..., None] % 32)


def bit_set(bv: torch.Tensor, node: torch.Tensor, on: bool = True):
    """bv with `node`'s bit set (or cleared)."""
    bit = bit_single(bv.shape[-1], node)
    return bv | bit if on else bv & ~bit


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit pattern (int32 in, int64 out)."""
    x = x.to(torch.int64) & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def popcount(bv: torch.Tensor) -> torch.Tensor:
    """Set bits over the words; bv [..., W] -> [...] int32."""
    return _popcount32(bv).sum(-1).to(torch.int32)


def _log2_pow2(x: torch.Tensor) -> torch.Tensor:
    """Exact log2 of a power of two held in int64 (x in [1, 2^32))."""
    out = torch.zeros_like(x)
    for k, mask in enumerate((0xAAAAAAAA, 0xCCCCCCCC, 0xF0F0F0F0,
                              0xFF00FF00, 0xFFFF0000)):
        out = out + ((x & mask) != 0).to(torch.int64) * (1 << k)
    return out


def ctz(bv: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit over the words (``__builtin_ctz``,
    ``assignment.c:209``); 32 * W when no bit is set. [..., W] -> [...]."""
    W = bv.shape[-1]
    x = bv.to(torch.int64) & _M32
    low = x & -x                                   # the isolated low bit
    empty = bv == 0
    word_ctz = _log2_pow2(torch.where(empty, 1, low))
    base = torch.arange(W, dtype=torch.int64, device=bv.device) * 32
    cand = torch.where(empty, 32 * W, base + word_ctz)
    return cand.min(-1).values.to(torch.int32)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 x) of int32 x >= 1 (``31 - clz(x)``), by integer
    binary search: exact for every int32, no float."""
    out = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        out = out + big.to(x.dtype) * s
        x = torch.where(big, x >> s, x)
    return out
