"""The whole txn_width 1 round as one cooperative CUDA kernel for Hopper.

``csrc/sync_round.cu`` replaces the JAX package's Pallas kernel
``ops/pallas_burst.py:_kernel`` together with the eager round around it:
one launch runs the burst (``csrc/sync_burst.cuh``, the device function
the burst kernel shares), the claim key and its scatter-min, the
verdicts, the transaction and eviction outcomes, the commit, the
fan-out, the fills, the cursors and the metric counters. It reads the
state as the engine holds it (cache planes [N, C], no transposes) and
writes the next round's state.

Every function takes one machine (cache planes [N, C], round and seed
0-d) or an ensemble of R machines with a leading replica axis (cache
planes [R, N, C], round and seed [R], the counters [R, 11]): the kernel's
replica axis runs all R machines in one launch, and one machine is the
launch at R = 1, the same entry point.

``plain_round`` is the plain version: ``sync_engine._round_step_single``
(the burst on the built window, no kernel) on the same tensors, for an
ensemble once a replica with the outputs stacked. For a CUDA tensor
``fused_round`` launches the kernel on the current stream or raises (a
refused cooperative launch included); it never falls back. For a CPU
tensor it runs ``plain_round``. It counts its launches in
``fused_round.launches``: one a round, whatever R.
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
    lib.sync_round.argtypes = [p] * 17 + [i, i, p]
    lib.sync_round.restype = i
    lib.sync_round_scratch_ints.argtypes = [i, i]
    lib.sync_round_scratch_ints.restype = ctypes.c_longlong
    lib.sync_round_grid.argtypes = [i, i]
    lib.sync_round_grid.restype = i
    for fn in (lib.sync_round_smem_bytes, lib.sync_round_static_smem_bytes):
        fn.argtypes = []
        fn.restype = i


LIBRARY = kernel_build.Library("sync_round", "sync_round.cu",
                               ("sync_burst.cuh", "sync_round.cuh",
                                "hash32.cuh"), defines,
                               _bind, {r"sync_round_kernel": "round"})


def io_contract_bytes(cfg: SystemConfig, reps: int = 1) -> tuple:
    """(input_bytes, output_bytes) of one launch for ``reps`` machines:
    each input read once, each output written once (cache 3 x [N, C],
    dm [E, 7], idx, instr_count, round, seed, the 11 counters in; cache,
    dm, idx, round and the counters out; all of it a replica)."""
    N, C = cfg.num_nodes, cfg.cache_size
    E = N << cfg.block_bits
    n_metrics = len(METRIC_FIELDS)
    elems_in = 3 * C * N + E * DM_COLS + 2 * N + 2 + n_metrics
    elems_out = 3 * C * N + E * DM_COLS + N + 1 + n_metrics
    return 4 * elems_in * reps, 4 * elems_out * reps


def check_operands(kernel: str, cfg: SystemConfig, ca, cv, cs, dm, idx,
                   cnt, round_, seed, metrics) -> tuple:
    """Check the operands of a fused sync round kernel's launch: one
    machine (round 0-d) or R of them (round [R], every operand with the
    leading axis R), int32, contiguous, on one CUDA device, the cache
    planes and dm 16-byte aligned (the kernel reads them in 16-byte
    words). Returns (R, the operands' leading shape: () or (R,))."""
    N, C = cfg.num_nodes, cfg.cache_size
    E = N << cfg.block_bits
    dev = dm.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: tensors on {dev}, not CUDA")
    if round_.dim() > 1:
        raise ValueError(f"{kernel}: round has shape {tuple(round_.shape)},"
                         " not () or (R,)")
    lead = tuple(round_.shape)
    reps = lead[0] if lead else 1
    if reps < 1:
        raise ValueError(f"{kernel}: an ensemble of 0 replicas")
    ins = (("cache_addr", ca, (N, C)), ("cache_val", cv, (N, C)),
           ("cache_state", cs, (N, C)), ("dm", dm, (E, DM_COLS)),
           ("idx", idx, (N,)), ("instr_count", cnt, (N,)),
           ("round", round_, ()), ("seed", seed, ()),
           ("metrics", metrics, (len(METRIC_FIELDS),)))
    for name, t, shape in ins:
        kernel_build.check_operand(kernel, name, t, lead + shape, dev)
    for name, t, _ in ins[:4]:
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start on a 16-byte "
                             "boundary")
    return reps, lead


def new_outputs(cfg: SystemConfig, lead: tuple, dev) -> list:
    """The output tensors of one launch: (cache_addr, cache_val,
    cache_state, dm, idx, round, metrics), each with the leading shape
    ``lead``."""
    N, C = cfg.num_nodes, cfg.cache_size
    E = N << cfg.block_bits
    return [torch.empty(lead + shape, dtype=I32, device=dev)
            for shape in ((N, C), (N, C), (N, C), (E, DM_COLS), (N,), (),
                          (len(METRIC_FIELDS),))]


def launch(cfg: SystemConfig, ca, cv, cs, dm, idx, cnt, round_, seed,
           metrics):
    """Launch the kernel on the current stream for one machine or an
    ensemble (``check_operands``); returns (cache_addr, cache_val,
    cache_state, dm, idx, round, metrics) with the operands' leading
    shape. Counts the launch on ``fused_round``."""
    reps, lead = check_operands(_KERNEL, cfg, ca, cv, cs, dm, idx, cnt,
                                round_, seed, metrics)
    dev = dm.device
    lib = LIBRARY.load(cfg)
    outs = new_outputs(cfg, lead, dev)
    scratch = torch.empty(
        (lib.sync_round_scratch_ints(reps, cfg.num_nodes),), dtype=I32,
        device=dev)
    err = lib.sync_round(
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
    """One txn_width 1 round: cache planes [N, C] x3, dm [E, 7], idx and
    instr_count [N], round and seed (0-d), the counters [11] (in
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


def per_replica(plain, cfg: SystemConfig, args: tuple) -> tuple:
    """``plain`` (a plain round on one machine's operands) on each
    replica of an ensemble's operands ``args``, the outputs stacked."""
    outs = [plain(cfg, *(t[r] for t in args))
            for r in range(args[6].shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def plain_round(cfg: SystemConfig, ca, cv, cs, dm, idx, cnt, round_, seed,
                metrics):
    """``fused_round``'s plain version, on any device: the tensor code of
    ``sync_engine._round_step_single`` (the procedural window and the
    burst built in PyTorch, no kernel); for an ensemble, once a
    replica."""
    if round_.dim() == 1:
        return per_replica(plain_round, cfg, (ca, cv, cs, dm, idx, cnt,
                                              round_, seed, metrics))
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
    """One txn_width 1 round of a machine or an ensemble through the
    round kernel (``impl="kernel"``, which takes the plain round for CPU
    tensors) or through ``plain_round`` on any device (``impl="plain"``);
    bit-identical to ``sync_engine._round_step_single``."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', not {impl!r}")
    fn = fused_round if impl == "kernel" else plain_round
    ca, cv, cs, dm, idx, round_, metrics = fn(*round_inputs(cfg, st))
    return st.replace(cache_addr=ca, cache_val=cv, cache_state=cs, dm=dm,
                      idx=idx, round=round_,
                      metrics=SyncMetrics(metrics))
