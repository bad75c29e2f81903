"""The whole txn_width 1 round as one cooperative CUDA kernel for Hopper.

``csrc/sync_round.cu`` replaces the JAX package's Pallas kernel
``ops/pallas_burst.py:_kernel`` together with the eager round around it:
one launch runs the burst (``csrc/sync_burst.cuh``, the device function
the burst kernel shares), the claim key and its scatter-min, the
verdicts, the transaction and eviction outcomes, the commit, the
fan-out, the fills, the cursors and the metric counters. It reads the
state as the engine holds it (cache planes [N, C], no transposes) and
writes the next round's state.

``plain_round`` is the plain version: ``sync_engine._round_step_single``
(the burst on the built window, no kernel) on the same tensors. For a
CUDA tensor ``fused_round`` launches the kernel on the current stream or
raises (a refused cooperative launch included); it never falls back.
For a CPU tensor it runs ``plain_round``. It counts its launches in
``fused_round.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_burst_kernel as sbk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.sync_engine import (
    DM_COLS, METRIC_FIELDS, SyncMetrics, SyncState, _round_step_single,
    claim_max_rounds)

_KERNEL = "sync round kernel"
I32 = torch.int32


def supported(cfg: SystemConfig) -> bool:
    """Does the round kernel take ``cfg``? The procedural 'uniform'
    stream without deep_window (``sync_burst_kernel.supported``) at
    txn_width 1, with at most 32 lines a node (held in registers)."""
    return (sbk.supported(cfg) and cfg.txn_width == 1
            and cfg.cache_size <= 32)


def defines(cfg: SystemConfig) -> tuple:
    """The burst's constants, the claim key's priority bits and the
    claim-key round budget, for ``cfg``."""
    if not supported(cfg):
        raise ValueError("the sync round kernel takes procedural 'uniform' "
                         "configs without deep_window at txn_width 1, "
                         "cache_size <= 32 (see supported())")
    prio_bits = max(1, (cfg.num_nodes - 1).bit_length())
    return sbk.defines(cfg) + (("SR_PB", prio_bits),
                               ("SR_CMR", claim_max_rounds(cfg)))


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sync_round.argtypes = [p] * 17 + [i, p]
    lib.sync_round.restype = i
    lib.sync_round_scratch_ints.argtypes = [i]
    lib.sync_round_scratch_ints.restype = ctypes.c_longlong
    lib.sync_round_grid.argtypes = [i]
    lib.sync_round_grid.restype = i
    for fn in (lib.sync_round_smem_bytes, lib.sync_round_static_smem_bytes):
        fn.argtypes = []
        fn.restype = i


LIBRARY = kernel_build.Library("sync_round", "sync_round.cu",
                               ("sync_burst.cuh", "sync_round.cuh",
                                "hash32.cuh"), defines,
                               _bind, {r"sync_round_kernel": "round"})


def io_contract_bytes(cfg: SystemConfig) -> tuple:
    """(input_bytes, output_bytes) of one launch: each input read once,
    each output written once (cache 3 x [N, C], dm [E, 7], idx,
    instr_count, round, seed, the 11 counters in; cache, dm, idx, round
    and the counters out)."""
    N, C = cfg.num_nodes, cfg.cache_size
    E = N << cfg.block_bits
    n_metrics = len(METRIC_FIELDS)
    elems_in = 3 * C * N + E * DM_COLS + 2 * N + 2 + n_metrics
    elems_out = 3 * C * N + E * DM_COLS + N + 1 + n_metrics
    return 4 * elems_in, 4 * elems_out


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
    scratch = torch.empty((lib.sync_round_scratch_ints(N),), dtype=I32,
                          device=dev)
    err = lib.sync_round(
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
    """One txn_width 1 round: cache planes [N, C] x3, dm [E, 7], idx and
    instr_count [N], round and seed (0-d), the counters [11] (in
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
    ``sync_engine._round_step_single`` (the procedural window and the
    burst built in PyTorch, no kernel)."""
    st = SyncState(cache_addr=ca, cache_val=cv, cache_state=cs, dm=dm,
                   instr_pack=None, instr_count=cnt, idx=idx, horizon=None,
                   seed=seed, round=round_,
                   metrics=SyncMetrics(metrics))
    out = _round_step_single(cfg, st)
    return (out.cache_addr, out.cache_val, out.cache_state, out.dm,
            out.idx, out.round, out.metrics.buffer())


def round_inputs(cfg: SystemConfig, st: SyncState) -> tuple:
    """The arguments of ``fused_round`` for the next round of ``st``."""
    return (cfg, st.cache_addr, st.cache_val, st.cache_state, st.dm,
            st.idx, st.instr_count, st.round, st.seed, st.metrics.buffer())


def round_step_fused(cfg: SystemConfig, st: SyncState,
                     impl: str = "kernel") -> SyncState:
    """One txn_width 1 round through the round kernel (``impl="kernel"``,
    which takes the plain round for CPU tensors) or through
    ``plain_round`` on any device (``impl="plain"``); bit-identical to
    ``sync_engine._round_step_single``."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', not {impl!r}")
    fn = fused_round if impl == "kernel" else plain_round
    ca, cv, cs, dm, idx, round_, metrics = fn(*round_inputs(cfg, st))
    return st.replace(cache_addr=ca, cache_val=cv, cache_state=cs, dm=dm,
                      idx=idx, round=round_,
                      metrics=SyncMetrics(metrics))
