"""The burst phase of the single-transaction round as a CUDA kernel for
Hopper, and its wrapper.

``csrc/sync_burst.cu`` replaces the JAX package's Pallas kernel
``ops/pallas_burst.py:_kernel``. ``burst`` has the signature and the
return of ``pallas_burst.burst``: from the round-start cache and the
cursors it gives each node's burst length ``d``, its read- and write-hit
counts, the stopped instruction (``oa``, ``val``, ``live``) and the
cache values and states after the burst's writes. The procedural
instruction hash runs inside the kernel; no window tensor is built. The
burst body is the device function of ``csrc/sync_burst.cuh``, which the
fused txn_width 1 round (``ops/sync_round_kernel``, the main path) runs
too; ``sync_engine._round_step_single(use_kernel=True)`` is the route
that still launches this kernel.

For a CUDA tensor ``burst`` launches the kernel on the current stream or
raises; it never falls back. For a CPU tensor it runs ``plain_burst``,
the plain PyTorch version beside it. It counts its launches in
``burst.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
from ue22cs343bb1_openmp_assignment_tpu_torch.procedural import M32

_KERNEL = "sync burst kernel"
I32 = torch.int32


def supported(cfg: SystemConfig) -> bool:
    """Do the sync window kernels (burst, window, replay) take ``cfg``?

    They compute the procedural 'uniform' stream in their body, so they
    need it; the window kernels keep per-transaction tables in 32-bit
    masks. There is no condition on the number of nodes: the TPU kernels
    tile the node axis at 1024 (``pallas_burst.tileable``), these take
    any N."""
    return (cfg.procedural == "uniform" and not cfg.deep_window
            and cfg.txn_width <= 32)


def procedural_defines(cfg: SystemConfig) -> tuple:
    """The compile-time constants of the in-kernel instruction hash and
    address codec (``csrc/hash32.cuh``) for ``cfg``."""
    if not supported(cfg):
        raise ValueError("the sync window kernels take procedural "
                         "'uniform' configs without deep_window, "
                         "txn_width <= 32 (see supported())")
    return (("SW_C", cfg.cache_size), ("SW_BLOCK_BITS", cfg.block_bits),
            ("SW_M", cfg.mem_size),
            ("SW_SEED_TERM", f"{cfg.proc_seed * 2654435761 & M32}u"),
            ("SW_LOCAL_PERMILLE", cfg.proc_local_permille),
            ("SW_WRITE_PERMILLE", cfg.proc_write_permille))


def defines(cfg: SystemConfig) -> tuple:
    return procedural_defines(cfg) + (("SB_H", cfg.drain_depth),)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sync_burst.argtypes = [p] * 13 + [i, p]
    lib.sync_burst.restype = i


LIBRARY = kernel_build.Library("sync_burst", "sync_burst.cu",
                               ("sync_burst.cuh", "hash32.cuh"), defines,
                               _bind,
                               {r"sync_burst_kernel": "burst"})


def io_contract_bytes(cfg: SystemConfig) -> tuple:
    """(input_bytes, output_bytes) of one launch: each input read once,
    each output written once (3C + 2 rows in, 6 + 2C rows out, N int32
    each)."""
    N, C = cfg.num_nodes, cfg.cache_size
    return 4 * N * (3 * C + 2), 4 * N * (6 + 2 * C)


def launch(cfg: SystemConfig, ca_t, cv_t, cs_t, idx2, cnt2):
    """Launch the kernel on the current stream on the transposed planes
    (cache [C, N] x3, idx and cnt [1, N]); returns d, rh, wh, oa, val,
    live [1, N] each and cv, cs [C, N]. Counts the launch on ``burst``."""
    N, C = cfg.num_nodes, cfg.cache_size
    dev = ca_t.device
    if dev.type != "cuda":
        raise ValueError(f"{_KERNEL}: tensors on {dev}, not CUDA")
    ins = [("cache_addr", ca_t, C), ("cache_val", cv_t, C),
           ("cache_state", cs_t, C), ("idx", idx2, 1),
           ("instr_count", cnt2, 1)]
    for name, t, rows in ins:
        kernel_build.check_operand(_KERNEL, name, t, (rows, N), dev)
    outs = [torch.empty((rows, N), dtype=I32, device=dev)
            for rows in (1,) * 6 + (C, C)]
    err = LIBRARY.load(cfg).sync_burst(
        *[ctypes.c_void_p(t.data_ptr()) for _, t, _ in ins],
        *[ctypes.c_void_p(t.data_ptr()) for t in outs],
        ctypes.c_int(N),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    burst.launches += 1
    return outs


def burst(cfg: SystemConfig, ca, cv, cs, idx, cnt):
    """The burst phase for all nodes, in engine layout: cache planes
    [N, C], cursors [N]. Returns (d, rh_n, wh_n, oa, val, live, cv',
    cs'): [N] vectors (``live`` bool) and the [N, C] cache values and
    states after the burst. The kernel for CUDA tensors, ``plain_burst``
    for CPU tensors."""
    if not ca.is_cuda:
        return plain_burst(cfg, ca, cv, cs, idx, cnt)
    d, rh, wh, oa, val, lv, cv_t, cs_t = launch(
        cfg, ca.T.contiguous(), cv.T.contiguous(), cs.T.contiguous(),
        idx[None, :].contiguous(), cnt[None, :].contiguous())
    return (d[0], rh[0], wh[0], oa[0], val[0], lv[0] != 0,
            cv_t.T.contiguous(), cs_t.T.contiguous())


burst.launches = 0


def plain_burst(cfg: SystemConfig, ca, cv, cs, idx, cnt):
    """``burst``'s plain PyTorch version, on any device: the procedural
    window of H+1 slots, then ``sync_engine.burst_phase``, the tensor
    code the plain round runs."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    return se.burst_phase(
        cfg, *se.instr_window(cfg, idx, cnt, None, cfg.drain_depth + 1),
        ca, cv, cs)
