"""The window folds of the multi-transaction round as CUDA kernels for
Hopper, their wrappers, and the round that runs through them.

``csrc/sync_window.cu`` replaces the two Pallas kernels of the JAX
package's ``ops/pallas_window.py`` around one fold body
(``csrc/sync_window.cuh``):

- ``window`` (``_window_kernel`` / ``_call_window``), before the claim:
  runs the W-step fold and emits the per-slot transaction records
  [13K, N], the per-step hit-probe, dependent-write and entry records
  [3W, N], and the prefix cache values [C, N];
- ``replay`` (``_replay_kernel`` / ``_call_replay``), after the claim:
  re-runs the same fold and applies the retired prefix, with the
  truncation point and the resolved fill states and values now known:
  the committed cache [3C, N] and the retired, read-hit and write-hit
  counts [3, N].

Both compute the procedural instruction hash in their body. Between
them ``round_step_multi_kernel`` (``round_step_multi_pallas`` in JAX)
does the claim scatter-min, the row gather, outcomes and the commit
scatter in plain tensor code, in the kernels' transposed [K, N] layout:
``sync_engine.multi_middle``, the same body the plain round runs in
[N, K].

These kernels are the TPU kernels' direct counterparts. The main path
at txn_width >= 2 is the fused round (``ops/sync_multi_round_kernel``,
one launch a round around the same fold body); ``round_step`` takes
this route only where the fused round does not take the config.

For a CUDA tensor a wrapper launches its kernel on the current stream
or raises; it never falls back. For a CPU tensor it runs its plain
version (``plain_window``, ``plain_replay``: ``sync_engine.window_fold``
restricted to the same outputs). Launches are counted in
``window.launches`` and ``replay.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.sync_burst_kernel import (
    procedural_defines, supported)

_KERNEL = "sync window kernel"
I32 = torch.int32
#: rows of the slot output: SLOT_FIELDS then pos, K rows each
N_SLOT = len(se.SLOT_FIELDS) + 1
#: step records, W rows each: interior-hit probe, dependent-write
#: ordinal, step entry
STEP_FIELDS = ("hc", "dep", "e1")


def defines(cfg: SystemConfig) -> tuple:
    """The compile-time constants of both kernels for ``cfg``; raises
    for a config they do not take."""
    if cfg.txn_width < 2:
        raise ValueError("the window kernels run the multi-transaction "
                         "round: txn_width must be >= 2")
    return procedural_defines(cfg) + (
        ("SW_K", cfg.txn_width), ("SW_W", cfg.drain_depth + cfg.txn_width))


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sync_window.argtypes = [p] * 8 + [i, p]
    lib.sync_window_replay.argtypes = [p] * 10 + [i, p]
    lib.sync_window.restype = i
    lib.sync_window_replay.restype = i


LIBRARY = kernel_build.Library(
    "sync_window", "sync_window.cu", ("sync_window.cuh", "hash32.cuh"),
    defines, _bind, {r"sync_window_kernel": "window",
                     r"sync_replay_kernel": "replay"})


def io_rows(cfg: SystemConfig, kernel: str):
    """(input rows, output rows) of ``kernel`` ("window" or "replay"):
    every operand is an int32 [rows, N] plane."""
    C, K = cfg.cache_size, cfg.txn_width
    W = cfg.drain_depth + K
    common = 3 * C + 2
    return {"window": (common, [N_SLOT * K, len(STEP_FIELDS) * W, C]),
            "replay": (common + 1 + 2 * K, [3 * C, 3])}[kernel]


def io_contract_bytes(cfg: SystemConfig, kernel: str) -> tuple:
    """(input_bytes, output_bytes) of one launch of ``kernel``: each
    input read once, each output written once."""
    rows_in, rows_out = io_rows(cfg, kernel)
    return 4 * cfg.num_nodes * rows_in, 4 * cfg.num_nodes * sum(rows_out)


def _launch(kernel: str, cfg: SystemConfig, ca_t, cv_t, cs_t, idx2, cnt2,
            *extra):
    N, C, K = cfg.num_nodes, cfg.cache_size, cfg.txn_width
    dev = ca_t.device
    if dev.type != "cuda":
        raise ValueError(f"{_KERNEL}: tensors on {dev}, not CUDA")
    ins = [("cache_addr", ca_t, C), ("cache_val", cv_t, C),
           ("cache_state", cs_t, C), ("idx", idx2, 1),
           ("instr_count", cnt2, 1)]
    ins += [(name, t, rows) for (name, rows), t in zip(
        (("first_lose", 1), ("fill_state", K), ("fill_val", K)), extra)]
    for name, t, rows in ins:
        kernel_build.check_operand(f"{_KERNEL} ({kernel})", name, t,
                                   (rows, N), dev)
    outs = [torch.empty((rows, N), dtype=I32, device=dev)
            for rows in io_rows(cfg, kernel)[1]]
    lib = LIBRARY.load(cfg)
    fn = lib.sync_window if kernel == "window" else lib.sync_window_replay
    err = fn(*[ctypes.c_void_p(t.data_ptr()) for _, t, _ in ins],
             *[ctypes.c_void_p(t.data_ptr()) for t in outs],
             ctypes.c_int(N),
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{_KERNEL} ({kernel}) launch failed: "
                           f"CUDA error {err}")
    WRAPPERS[kernel].launches += 1
    return tuple(outs)


def window(cfg: SystemConfig, ca_t, cv_t, cs_t, idx2, cnt2):
    """The pre-claim window fold on the transposed planes (cache [C, N]
    x3, idx and instr_count [1, N]): (slot records [13K, N], step
    records [3W, N], prefix cache values [C, N]), all int32. The kernel
    for CUDA tensors, ``plain_window`` for CPU tensors."""
    if not ca_t.is_cuda:
        return plain_window(cfg, ca_t, cv_t, cs_t, idx2, cnt2)
    return _launch("window", cfg, ca_t, cv_t, cs_t, idx2, cnt2)


def replay(cfg: SystemConfig, ca_t, cv_t, cs_t, idx2, cnt2, first_lose,
           fill_state, fill_val):
    """The post-claim replay fold: ``window``'s inputs, the truncation
    point ``first_lose`` [1, N] and the resolved ``fill_state`` and
    ``fill_val`` [K, N]; returns (committed cache [3C, N] address/value/
    state, n_ret/rh/wh [3, N]). The kernel for CUDA tensors,
    ``plain_replay`` for CPU tensors."""
    if not ca_t.is_cuda:
        return plain_replay(cfg, ca_t, cv_t, cs_t, idx2, cnt2, first_lose,
                            fill_state, fill_val)
    return _launch("replay", cfg, ca_t, cv_t, cs_t, idx2, cnt2, first_lose,
                   fill_state, fill_val)


window.launches = 0
replay.launches = 0
WRAPPERS = {"window": window, "replay": replay}


# -- plain versions ----------------------------------------------------------

def _plain_fold(cfg: SystemConfig, ca_t, cv_t, cs_t, idx2, cnt2):
    """``sync_engine.window_fold`` on the kernels' operands, over the
    procedural window."""
    w_oa, w_val, w_live = se.instr_window(
        cfg, idx2[0], cnt2[0], None, cfg.drain_depth + cfg.txn_width)
    return se.window_fold(cfg, w_oa.unbind(1), w_val.unbind(1),
                          w_live.unbind(1), ca_t.unbind(0),
                          cv_t.unbind(0), cs_t.unbind(0))


def plain_window(cfg: SystemConfig, ca_t, cv_t, cs_t, idx2, cnt2):
    """``window``'s plain PyTorch version, on any device."""
    steps, cv_pre = _plain_fold(cfg, ca_t, cv_t, cs_t, idx2, cnt2)
    slots = se.pack_slots(cfg, steps)
    slotmat = torch.stack([v for f in se.SLOT_FIELDS + ("pos",)
                           for v in slots[f]])
    stepmat = torch.stack([s[f].to(I32) for f in STEP_FIELDS
                           for s in steps])
    return slotmat, stepmat, torch.stack(cv_pre)


def plain_replay(cfg: SystemConfig, ca_t, cv_t, cs_t, idx2, cnt2,
                 first_lose, fill_state, fill_val):
    """``replay``'s plain PyTorch version, on any device."""
    steps, _ = _plain_fold(cfg, ca_t, cv_t, cs_t, idx2, cnt2)
    ca_c, cv_c, cs_c, n_ret, rh, wh, _ = se.replay_fold(
        cfg, steps, first_lose[0], fill_state.unbind(0),
        fill_val.unbind(0), ca_t.unbind(0), cv_t.unbind(0),
        cs_t.unbind(0))
    return torch.stack(ca_c + cv_c + cs_c), torch.stack([n_ret, rh, wh])


PLAIN = {"window": plain_window, "replay": plain_replay}


# -- the round ---------------------------------------------------------------

def round_inputs(cfg: SystemConfig, st: se.SyncState) -> tuple:
    """The arguments of ``window`` for the next round of ``st`` (and the
    first six of ``replay``): the transposed cache planes and cursors."""
    return (cfg, st.cache_addr.T.contiguous(), st.cache_val.T.contiguous(),
            st.cache_state.T.contiguous(), st.idx[None, :].contiguous(),
            st.instr_count[None, :].contiguous())


def unpack_window(cfg: SystemConfig, slotmat, stepmat):
    """(slot, hc_w, dep_w, he_w) of ``sync_engine.multi_middle`` from
    the window fold's outputs: {field: [K, N]} and the step records as
    W-lists of [N] vectors."""
    K = cfg.txn_width
    W = cfg.drain_depth + K
    slot = {f: slotmat[i * K:(i + 1) * K]
            for i, f in enumerate(se.SLOT_FIELDS + ("pos",))}
    return (slot, list((stepmat[:W] != 0).unbind(0)),
            list(stepmat[W:2 * W].unbind(0)),
            list(stepmat[2 * W:].unbind(0)))


def round_step_multi_kernel(cfg: SystemConfig, st: se.SyncState,
                            fold_impl: str = "kernel") -> se.SyncState:
    """One multi-transaction round with its two folds through the window
    kernels (``fold_impl="kernel"``: the kernels for CUDA tensors, their
    plain versions for CPU tensors) or through the plain versions on any
    device (``fold_impl="plain"``), in the transposed [K, N] layout.
    Bit-identical to ``sync_engine._round_step_multi``. Needs a
    procedural workload and txn_width > 1; records no events."""
    if fold_impl not in ("kernel", "plain"):
        raise ValueError(f"fold_impl must be 'kernel' or 'plain', "
                         f"not {fold_impl!r}")
    if not supported(cfg) or cfg.txn_width < 2:
        raise ValueError("round_step_multi_kernel needs a procedural "
                         "'uniform' config with txn_width >= 2")
    C = cfg.cache_size
    folds = WRAPPERS if fold_impl == "kernel" else PLAIN
    ix = se._index_ops()
    args = round_inputs(cfg, st)
    slotmat, stepmat, cv_pre = folds["window"](*args)
    mid = se.multi_middle(cfg, st, ix, *unpack_window(cfg, slotmat,
                                                      stepmat), cv_pre, 0)
    cache, cnts = folds["replay"](
        *args, mid["first_lose"][None, :].contiguous(),
        mid["fill_state"].contiguous(), mid["fill_val"].contiguous())
    return se.multi_finish(cfg, st, ix, mid, cache[:C], cache[C:2 * C],
                           cache[2 * C:], cnts[0], cnts[1], cnts[2], 0)
