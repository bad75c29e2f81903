"""The fused deep round as one cooperative CUDA kernel for Hopper.

The counterpart of the JAX package's ``ops/pallas_round.py``, with its
public names: ``supported``, ``io_contract_bytes``, ``fused_round`` (the
kernel call, ``_call_round`` there) and ``round_step_deep_fused``.
``csrc/deep_round.cu`` replaces ``pallas_round._round_kernel``: one
launch runs the three window folds, the claim scatter-min, the verdicts
and absorption waves, the merge of own rows, request composition, reply
patches and the fan-out, and writes the directory, the committed cache,
the retirement counts and the metric delta rows. The window build before
it and ``_finish_round_deep`` after it stay plain PyTorch, as in JAX.

``plain_round`` is the plain version: ``deep_engine.deep_round_core``
with the plain folds (``deep_fold_kernel.PLAIN``) and ``TorchIndexOps``,
the same code the fold path runs. For a CUDA tensor ``fused_round``
launches the kernel on the current stream or raises (a refused
cooperative launch included); it never falls back. For a CPU tensor it
runs ``plain_round``. It counts its launches in ``fused_round.launches``.
"""

from __future__ import annotations

import ctypes
import types

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    deep_fold_kernel as dfk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.deep_engine import (
    TorchIndexOps, _finish_round_deep, deep_round_core, window)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.sync_engine import (
    DM_COLS, DM_COUNT, DM_MEM, DM_OWNER, DM_STATE, SyncState,
    claim_max_rounds)

_KERNEL = "deep round kernel"


def supported(cfg: SystemConfig) -> bool:
    """Does the round kernel take ``cfg``?

    Deep-window configs without the read storm (whose duplicate storm
    rows and per-entry reader counts stay on the fold path, as in JAX),
    within the kernel's 32-bit masks (cache_size, 1 << block_bits and
    deep_slots <= 32). Unlike ``pallas_round.supported`` there is no
    cap on the contenders per entry: the TPU kernel needs one for its
    f32 exponent-ladder scatter-min, and this kernel's is an atomicMin."""
    return (cfg.deep_window and not cfg.deep_read_storm
            and max(cfg.cache_size, 1 << cfg.block_bits,
                    cfg.deep_slots) <= 32)


def defines(cfg: SystemConfig) -> tuple:
    """The compile-time constants of the round kernel for ``cfg``: the
    fold's, the number of absorption waves and the flag mode."""
    if not supported(cfg):
        raise ValueError("the deep round kernel takes deep-window configs "
                         "without the read storm (see supported())")
    return dfk.defines(cfg) + (("DR_WAVES", cfg.deep_waves),
                               ("DR_EXACT", int(cfg.deep_exact_flags)))


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.deep_round.argtypes = [p] * 14 + [i, i, i, p]
    lib.deep_round.restype = i
    lib.deep_round_scratch_ints.argtypes = [i]
    lib.deep_round_scratch_ints.restype = ctypes.c_longlong
    lib.deep_round_grid.argtypes = [i]
    lib.deep_round_grid.restype = i


LIBRARY = kernel_build.Library("deep_round", "deep_round.cu",
                               ("deep_fold.cuh",), defines, _bind,
                               {r"deep_round_kernel": "round"})


def io_contract_bytes(cfg: SystemConfig) -> tuple:
    """(input_bytes, output_bytes) of one launch: each input read once,
    each output written once (``pallas_round.io_contract_bytes``)."""
    N, C, S = cfg.num_nodes, cfg.cache_size, 1 << cfg.block_bits
    E = N * S
    W = cfg.drain_depth + cfg.txn_width
    elems_in = 2 * N + E * DM_COLS + 3 * C * N + 3 * W * N + N
    elems_out = E * DM_COLS + 3 * C * N + N + 10 * N
    return 4 * elems_in, 4 * elems_out


def launch(cfg: SystemConfig, params, dm, ca_t, cv_t, cs_t, w_oa, w_val,
           w_live, hor):
    """Launch the round kernel on the current stream; returns (dm [E, 7],
    cache [3C, N], n_ret [1, N], delta rows [10, N]). Counts the launch
    on ``fused_round``."""
    N, C, S = cfg.num_nodes, cfg.cache_size, 1 << cfg.block_bits
    W = cfg.drain_depth + cfg.txn_width
    dev = dm.device
    if dev.type != "cuda":
        raise ValueError(f"{_KERNEL}: tensors on {dev}, not CUDA")
    ins = [("params", params, 2, N), ("dm", dm, N * S, DM_COLS),
           ("cache_addr", ca_t, C, N), ("cache_val", cv_t, C, N),
           ("cache_state", cs_t, C, N), ("w_oa", w_oa, W, N),
           ("w_val", w_val, W, N), ("w_live", w_live, W, N),
           ("horizon", hor, 1, N)]
    for name, t, rows, cols in ins:
        kernel_build.check_operand(_KERNEL, name, t, (rows, cols), dev)
    lib = LIBRARY.load(cfg)
    outs = [torch.empty(shape, dtype=torch.int32, device=dev)
            for shape in ((N * S, DM_COLS), (3 * C, N), (1, N), (10, N))]
    scratch = torch.empty((lib.deep_round_scratch_ints(N),),
                          dtype=torch.int32, device=dev)
    prio_bits = max(1, (N - 1).bit_length())
    err = lib.deep_round(
        *[ctypes.c_void_p(t.data_ptr()) for _, t, _, _ in ins],
        *[ctypes.c_void_p(t.data_ptr()) for t in outs],
        ctypes.c_void_p(scratch.data_ptr()), N, prio_bits,
        claim_max_rounds(cfg),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {err}")
    fused_round.launches += 1
    return tuple(outs)


def fused_round(cfg: SystemConfig, params, dm, ca_t, cv_t, cs_t, w_oa,
                w_val, w_live, hor):
    """One deep round from the built window: params [2, N] (round,
    seed), dm [E, 7], cache planes [C, N] x3, window [W, N] x3 (w_live
    int32), horizon [1, N]; returns (dm, cache [3C, N] address/value/
    state, n_ret [1, N], delta rows [10, N]), all int32. The kernel for
    CUDA tensors, ``plain_round`` for CPU tensors."""
    if not dm.is_cuda:
        return plain_round(cfg, params, dm, ca_t, cv_t, cs_t, w_oa, w_val,
                           w_live, hor)
    return launch(cfg, params, dm, ca_t, cv_t, cs_t, w_oa, w_val, w_live,
                  hor)


fused_round.launches = 0


def plain_round(cfg: SystemConfig, params, dm, ca_t, cv_t, cs_t, w_oa,
                w_val, w_live, hor):
    """``fused_round``'s plain version, on any device: the round middle
    (``deep_round_core``) with the plain folds and ``TorchIndexOps``."""
    N, S = cfg.num_nodes, 1 << cfg.block_bits
    dm_own = dm.reshape(N, S, DM_COLS)
    tiles = (ca_t, cv_t, cs_t,
             tuple(dm_own[:, :, col].T.contiguous()
                   for col in (DM_STATE, DM_COUNT, DM_OWNER, DM_MEM)))
    st = types.SimpleNamespace(horizon=hor[0])
    win = (w_oa, w_val, w_live != 0)
    folds = dfk.PLAIN

    def fold_flags_fn(oc):
        return folds["flags"](cfg, st, tiles, *win, oc)

    def fold_replay_fn(bad, oc):
        return folds["replay"](cfg, st, tiles, *win, bad, oc)

    core = deep_round_core(cfg, dm, params[0, 0], params[1, 0],
                           folds["pre"](cfg, st, tiles, *win),
                           fold_flags_fn, fold_replay_fn, TorchIndexOps())
    cache = torch.cat([core["ca_c"], core["cv_c"], core["cs_c"]], dim=0)
    return (core["dm"], cache, core["rp"]["n_ret"][None, :],
            core["delta_rows"])


def round_inputs(cfg: SystemConfig, st: SyncState) -> tuple:
    """The arguments of ``fused_round`` for the next round of ``st``:
    the built window and the transposed cache planes."""
    N = cfg.num_nodes
    w_oa, w_val, w_live = window(cfg, st)
    params = torch.stack([st.round.expand(N), st.seed.expand(N)])
    return (cfg, params, st.dm, st.cache_addr.T.contiguous(),
            st.cache_val.T.contiguous(), st.cache_state.T.contiguous(),
            w_oa, w_val, w_live.to(torch.int32), st.horizon[None, :])


def round_step_deep_fused(cfg: SystemConfig, st: SyncState,
                          impl: str = "kernel") -> SyncState:
    """One deep round through the round kernel (``impl="kernel"``,
    which takes the plain round for CPU tensors) or through
    ``plain_round`` on any device (``impl="plain"``); bit-identical to
    ``deep_engine.round_step_deep``. ``pallas_round.round_step_deep_fused``
    is the JAX counterpart."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', not {impl!r}")
    C = cfg.cache_size
    fn = fused_round if impl == "kernel" else plain_round
    dm, cache, nret, delta = fn(*round_inputs(cfg, st))
    core = dict(ca_c=cache[:C], cv_c=cache[C:2 * C], cs_c=cache[2 * C:],
                dm=dm, rp=dict(n_ret=nret[0]), delta_rows=delta)
    return _finish_round_deep(cfg, st, core)
