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
launches in ``fused_round.launches``: one a round, whatever R. The
kernel's scratch is allocated once for each (device, size) and reused by
every later launch of that size.

As ``ops/sync_round_kernel``, every function takes one machine or an
ensemble of R machines with a leading replica axis, which the kernel's
replica axis runs in one launch (one machine is R = 1); the plain
version runs once a replica.
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
    SyncMetrics, SyncState, _round_step_multi, claim_max_rounds)

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
    lib.sync_multi_round.argtypes = [p] * 17 + [i, i, p]
    lib.sync_multi_round.restype = i
    lib.sync_multi_round_scratch_ints.argtypes = [i, i]
    lib.sync_multi_round_scratch_ints.restype = ctypes.c_longlong
    lib.sync_multi_round_grid.argtypes = [i, i]
    lib.sync_multi_round_grid.restype = i
    for fn in (lib.sync_multi_round_smem_bytes,
               lib.sync_multi_round_static_smem_bytes):
        fn.argtypes = []
        fn.restype = i


LIBRARY = kernel_build.Library(
    "sync_multi_round", "sync_multi_round.cu",
    ("sync_round.cuh", "sync_window.cuh", "hash32.cuh"), defines, _bind,
    {r"sync_multi_round_kernel": "multi_round"})


def io_contract_bytes(cfg: SystemConfig, reps: int = 1) -> tuple:
    """(input_bytes, output_bytes) of one launch for ``reps`` machines:
    each input read once, each output written once. The operands are
    those of the txn_width 1 round kernel
    (``sync_round_kernel.io_contract_bytes``)."""
    return srk.io_contract_bytes(cfg, reps)


#: {(device, int32 elements): scratch}: the kernel's scratch, made at
#: the first launch that needs that size on that device and reused
#: (every launch writes what it reads of it). The size depends on R, N
#: and the config's K, W and C, so configs of one N may differ.
_SCRATCH = {}


def _scratch(lib, dev: torch.device, reps: int, n: int) -> torch.Tensor:
    key = (dev, lib.sync_multi_round_scratch_ints(reps, n))
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.empty((key[1],), dtype=I32, device=dev)
    return _SCRATCH[key]


def launch(cfg: SystemConfig, ca, cv, cs, dm, idx, cnt, round_, seed,
           metrics):
    """Launch the kernel on the current stream for one machine or an
    ensemble (``sync_round_kernel.check_operands``); returns (cache_addr,
    cache_val, cache_state, dm, idx, round, metrics) with the operands'
    leading shape. Counts the launch on ``fused_round``."""
    reps, lead = srk.check_operands(_KERNEL, cfg, ca, cv, cs, dm, idx, cnt,
                                    round_, seed, metrics)
    dev = dm.device
    lib = LIBRARY.load(cfg)
    outs = srk.new_outputs(cfg, lead, dev)
    scratch = _scratch(lib, dev, reps, cfg.num_nodes)
    err = lib.sync_multi_round(
        *[ctypes.c_void_p(t.data_ptr()) for t in (ca, cv, cs, dm, idx, cnt,
                                                  round_, seed, metrics)],
        *[ctypes.c_void_p(t.data_ptr()) for t in outs],
        ctypes.c_void_p(scratch.data_ptr()), reps, cfg.num_nodes,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    fused_round.launches += 1
    return tuple(outs)


def fused_round(cfg: SystemConfig, ca, cv, cs, dm, idx, cnt, round_, seed,
                metrics):
    """One txn_width >= 2 round: cache planes [N, C] x3, dm [E, 7], idx
    and instr_count [N], round and seed (0-d), the counters [11] (in
    METRIC_FIELDS order), each with a leading replica axis R for an
    ensemble; returns the next round's (cache_addr, cache_val,
    cache_state, dm, idx, round, metrics) in the same shapes, all int32.
    The kernel for CUDA tensors (one launch for all R), ``plain_round``
    for CPU tensors."""
    if not dm.is_cuda:
        return plain_round(cfg, ca, cv, cs, dm, idx, cnt, round_, seed,
                           metrics)
    return launch(cfg, ca, cv, cs, dm, idx, cnt, round_, seed, metrics)


fused_round.launches = 0


def plain_round(cfg: SystemConfig, ca, cv, cs, dm, idx, cnt, round_, seed,
                metrics):
    """``fused_round``'s plain version, on any device: the tensor code of
    ``sync_engine._round_step_multi`` (the procedural window, the two
    folds and the middle built in PyTorch, no kernel); for an ensemble,
    once a replica."""
    if round_.dim() == 1:
        return srk.per_replica(plain_round, cfg, (ca, cv, cs, dm, idx, cnt,
                                                  round_, seed, metrics))
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
    """One txn_width >= 2 round of a machine or an ensemble through the
    round kernel (``impl="kernel"``, which takes the plain round for CPU
    tensors) or through ``plain_round`` on any device (``impl="plain"``);
    bit-identical to ``sync_engine._round_step_multi``."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', not {impl!r}")
    fn = fused_round if impl == "kernel" else plain_round
    ca, cv, cs, dm, idx, round_, metrics = fn(*round_inputs(cfg, st))
    return st.replace(cache_addr=ca, cache_val=cv, cache_state=cs, dm=dm,
                      idx=idx, round=round_,
                      metrics=SyncMetrics(metrics))
