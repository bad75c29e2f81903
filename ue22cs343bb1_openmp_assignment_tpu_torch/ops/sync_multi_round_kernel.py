"""The whole txn_width >= 2 round as one cooperative CUDA kernel for Hopper.

``csrc/sync_multi_round.cu`` replaces the JAX package's Pallas kernels
``ops/pallas_window.py:_window_kernel`` and ``_replay_kernel`` together
with the eager round around them (``round_step_multi_pallas``): one
launch runs the pre-claim window fold (``csrc/sync_window.cuh``, the
fold body the window kernels share), the claim key and its scatter-min,
the verdicts, the interior-hit and dependent-write checks, the commit
prefix, the transaction and eviction outcomes with release and
reacquire composition, the commit, the replay fold, the fan-out, the
cursors and the metric counters. It reads the state as the engine holds
it (cache planes [N, C], no transposes) and writes the next round's
state; what it shares with the txn_width 1 round kernel is in
``csrc/sync_round.cuh``.

``plain_round`` is the plain version: ``sync_engine._round_step_multi``
(the procedural window, the folds and the middle in PyTorch, no kernel)
on the same tensors. For a CUDA tensor ``fused_round`` launches the
kernel on the current stream or raises (a refused cooperative launch
included); it never falls back, to the window kernels or to the plain
version. For a CPU tensor it runs ``plain_round``. It counts its
launches in ``fused_round.launches``. The kernel's scratch is allocated
once for each (device, size) and reused by every later launch of that
size.
"""

from __future__ import annotations

import ctypes

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_burst_kernel as sbk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_round_kernel as srk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.sync_engine import (
    DM_COLS, METRIC_FIELDS, SyncMetrics, SyncState, _round_step_multi,
    claim_max_rounds)

_KERNEL = "sync multi round kernel"
I32 = torch.int32


def supported(cfg: SystemConfig) -> bool:
    """Does the round kernel take ``cfg``? The procedural 'uniform'
    stream without deep_window (``sync_burst_kernel.supported``) at
    txn_width >= 2, with at most 32 lines a node (held in registers) and
    a window of at most 127 steps (a step index in 7 bits of a slot
    record)."""
    return (sbk.supported(cfg) and cfg.txn_width >= 2
            and cfg.cache_size <= 32
            and cfg.drain_depth + cfg.txn_width < 128)


def defines(cfg: SystemConfig) -> tuple:
    """The fold's constants (cache lines, txn_width, window steps, the
    hash's constants), the claim key's priority bits and the claim-key
    round budget, for ``cfg``."""
    if not supported(cfg):
        raise ValueError("the sync multi round kernel takes procedural "
                         "'uniform' configs without deep_window at "
                         "txn_width >= 2, cache_size <= 32, drain_depth + "
                         "txn_width < 128 (see supported())")
    prio_bits = max(1, (cfg.num_nodes - 1).bit_length())
    return sbk.procedural_defines(cfg) + (
        ("SW_K", cfg.txn_width), ("SW_W", cfg.drain_depth + cfg.txn_width),
        ("SR_PB", prio_bits), ("SR_CMR", claim_max_rounds(cfg)))


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sync_multi_round.argtypes = [p] * 17 + [i, p]
    lib.sync_multi_round.restype = i
    lib.sync_multi_round_scratch_ints.argtypes = [i]
    lib.sync_multi_round_scratch_ints.restype = ctypes.c_longlong
    lib.sync_multi_round_grid.argtypes = [i]
    lib.sync_multi_round_grid.restype = i
    for fn in (lib.sync_multi_round_smem_bytes,
               lib.sync_multi_round_static_smem_bytes):
        fn.argtypes = []
        fn.restype = i


LIBRARY = kernel_build.Library(
    "sync_multi_round", "sync_multi_round.cu",
    ("sync_round.cuh", "sync_window.cuh", "hash32.cuh"), defines, _bind,
    {r"sync_multi_round_kernel": "multi_round"})


def io_contract_bytes(cfg: SystemConfig) -> tuple:
    """(input_bytes, output_bytes) of one launch: each input read once,
    each output written once. The operands are those of the txn_width 1
    round kernel (``sync_round_kernel.io_contract_bytes``)."""
    return srk.io_contract_bytes(cfg)


#: {(device, int32 elements): scratch}: the kernel's per-node scratch,
#: made at the first launch that needs that size on that device and
#: reused (every launch writes what it reads of it). The size depends on
#: N and on the config's K, W and C, so configs of one N may differ.
_SCRATCH = {}


def _scratch(lib, dev: torch.device, n: int) -> torch.Tensor:
    key = (dev, lib.sync_multi_round_scratch_ints(n))
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.empty((key[1],), dtype=I32, device=dev)
    return _SCRATCH[key]


def launch(cfg: SystemConfig, ca, cv, cs, dm, idx, cnt, round_, seed,
           metrics):
    """Launch the kernel on the current stream; returns (cache_addr,
    cache_val, cache_state [N, C], dm [E, 7], idx [N], round (0-d),
    metrics [11]). Counts the launch on ``fused_round``."""
    N, C = cfg.num_nodes, cfg.cache_size
    E = N << cfg.block_bits
    dev = dm.device
    if dev.type != "cuda":
        raise ValueError(f"{_KERNEL}: tensors on {dev}, not CUDA")
    ins = [("cache_addr", ca, (N, C)), ("cache_val", cv, (N, C)),
           ("cache_state", cs, (N, C)), ("dm", dm, (E, DM_COLS)),
           ("idx", idx, (N,)), ("instr_count", cnt, (N,)),
           ("round", round_, ()), ("seed", seed, ()),
           ("metrics", metrics, (len(METRIC_FIELDS),))]
    for name, t, shape in ins:
        kernel_build.check_operand(_KERNEL, name, t, shape, dev)
    # the kernel reads the cache rows and dm in 16-byte words
    for name, t, _ in ins[:4]:
        if t.data_ptr() % 16:
            raise ValueError(f"{_KERNEL}: {name} must start on a 16-byte "
                             "boundary")
    lib = LIBRARY.load(cfg)
    outs = [torch.empty(shape, dtype=I32, device=dev)
            for _, _, shape in ins[:5]]
    outs += [torch.empty((), dtype=I32, device=dev),
             torch.empty((len(METRIC_FIELDS),), dtype=I32, device=dev)]
    scratch = _scratch(lib, dev, N)
    err = lib.sync_multi_round(
        *[ctypes.c_void_p(t.data_ptr()) for _, t, _ in ins],
        *[ctypes.c_void_p(t.data_ptr()) for t in outs],
        ctypes.c_void_p(scratch.data_ptr()), N,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    fused_round.launches += 1
    return tuple(outs)


def fused_round(cfg: SystemConfig, ca, cv, cs, dm, idx, cnt, round_, seed,
                metrics):
    """One txn_width >= 2 round: cache planes [N, C] x3, dm [E, 7], idx
    and instr_count [N], round and seed (0-d), the counters [11] (in
    METRIC_FIELDS order); returns the next round's (cache_addr,
    cache_val, cache_state, dm, idx, round, metrics), all int32. The
    kernel for CUDA tensors, ``plain_round`` for CPU tensors."""
    if not dm.is_cuda:
        return plain_round(cfg, ca, cv, cs, dm, idx, cnt, round_, seed,
                           metrics)
    return launch(cfg, ca, cv, cs, dm, idx, cnt, round_, seed, metrics)


fused_round.launches = 0


def plain_round(cfg: SystemConfig, ca, cv, cs, dm, idx, cnt, round_, seed,
                metrics):
    """``fused_round``'s plain version, on any device: the tensor code of
    ``sync_engine._round_step_multi`` (the procedural window, the two
    folds and the middle built in PyTorch, no kernel)."""
    st = SyncState(cache_addr=ca, cache_val=cv, cache_state=cs, dm=dm,
                   instr_pack=None, instr_count=cnt, idx=idx, horizon=None,
                   seed=seed, round=round_,
                   metrics=SyncMetrics(metrics))
    out = _round_step_multi(cfg, st)
    return (out.cache_addr, out.cache_val, out.cache_state, out.dm,
            out.idx, out.round, out.metrics.buffer())


def round_inputs(cfg: SystemConfig, st: SyncState) -> tuple:
    """The arguments of ``fused_round`` for the next round of ``st``."""
    return srk.round_inputs(cfg, st)


def round_step_fused(cfg: SystemConfig, st: SyncState,
                     impl: str = "kernel") -> SyncState:
    """One txn_width >= 2 round through the round kernel
    (``impl="kernel"``, which takes the plain round for CPU tensors) or
    through ``plain_round`` on any device (``impl="plain"``);
    bit-identical to ``sync_engine._round_step_multi``."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', not {impl!r}")
    fn = fused_round if impl == "kernel" else plain_round
    ca, cv, cs, dm, idx, round_, metrics = fn(*round_inputs(cfg, st))
    return st.replace(cache_addr=ca, cache_val=cv, cache_state=cs, dm=dm,
                      idx=idx, round=round_,
                      metrics=SyncMetrics(metrics))
