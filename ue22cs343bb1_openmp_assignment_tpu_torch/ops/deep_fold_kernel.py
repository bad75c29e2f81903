"""The deep-window fold as a CUDA kernel for Hopper, and its wrappers.

``csrc/deep_fold.cu`` replaces the JAX package's three Pallas fold
kernels (``ops/pallas_deep.py``: ``_pre_kernel``, ``_flags_kernel``,
``_replay_kernel``) with one body and three output modes. The wrappers
``fold_pre``, ``fold_flags`` and ``fold_replay`` have the outputs of
``pallas_deep.fold_pre``/``fold_flags``/``fold_replay``, in the same
transposed [rows, N] layout.

For a CUDA tensor a wrapper launches the kernel on the current stream
or raises; it never falls back. For a CPU tensor it runs the plain
version, ``deep_engine._fold_deep`` restricted to the same outputs.
Each wrapper counts its launches in ``<wrapper>.launches``.

Building: ``csrc/deep_fold.cu`` holds the three thin kernels around the
fold body in ``csrc/deep_fold.cuh`` (which the fused round kernel shares);
``ops/kernel_build`` compiles it, one library per (C, S, Q, G, W, waves,
storm) combination, at first use.
"""

from __future__ import annotations

import ctypes

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.deep_engine import (
    F_MARK, F_POISON, _fold_deep)


def defines(cfg: SystemConfig) -> tuple:
    """The compile-time constants of the kernel for ``cfg``; raises for
    a config the kernel does not take."""
    if max(cfg.cache_size, 1 << cfg.block_bits, cfg.deep_slots) > 32:
        raise ValueError("the deep fold kernel keeps boolean tables in "
                         "32-bit masks: cache_size, 1 << block_bits and "
                         "deep_slots must be <= 32")
    return (("DF_C", cfg.cache_size), ("DF_S", 1 << cfg.block_bits),
            ("DF_BLOCK_BITS", cfg.block_bits), ("DF_Q", cfg.deep_slots),
            ("DF_G", cfg.deep_ownerval_slots),
            ("DF_W", cfg.drain_depth + cfg.txn_width),
            ("DF_WAVES1", int(cfg.deep_waves == 1)),
            ("DF_STORM", int(cfg.deep_read_storm)))


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.deep_fold_pre.argtypes = [p] * 13 + [i, p]
    lib.deep_fold_flags.argtypes = [p] * 13 + [i, p]
    lib.deep_fold_replay.argtypes = [p] * 18 + [i, p]
    for fn in (lib.deep_fold_pre, lib.deep_fold_flags,
               lib.deep_fold_replay):
        fn.restype = ctypes.c_int


#: the kernel template is instantiated once per mode: 0 pre, 1 flags,
#: 2 replay
LIBRARY = kernel_build.Library(
    "deep_fold", "deep_fold.cu", ("deep_fold.cuh",), defines, _bind,
    {r"deep_fold_kernelILi0E": "pre", r"deep_fold_kernelILi1E": "flags",
     r"deep_fold_kernelILi2E": "replay"})


def io_rows(cfg: SystemConfig, mode: str):
    """(input rows, output rows) of the kernel in ``mode``: every
    operand is an int32 [rows, N] plane."""
    C, S = cfg.cache_size, 1 << cfg.block_bits
    Q, G = cfg.deep_slots, cfg.deep_ownerval_slots
    W = cfg.drain_depth + cfg.txn_width
    common = 3 * C + 4 * S + 3 * W + 1
    return {"pre": (common, [3 * Q, S]),
            "flags": (common + S, [S]),
            "replay": (common + Q + S, [7 * C, 7 * S, 4 * Q, 2 * G, 7])}[mode]


def launch(mode: str, cfg: SystemConfig, st, tiles, w_oa, w_val, w_live,
           *extra):
    """Launch the kernel in ``mode`` ("pre", "flags" or "replay") on the
    current stream and return its raw [rows, N] int32 outputs. ``extra``
    is (ocode,) for flags and (bad, ocode) for replay. Counts the launch
    on the mode's wrapper."""
    C, S = cfg.cache_size, 1 << cfg.block_bits
    Q, N = cfg.deep_slots, cfg.num_nodes
    W = cfg.drain_depth + cfg.txn_width
    ca_t, cv_t, cs_t, dm_t4 = tiles
    dev = ca_t.device
    extra_rows = {"pre": (), "flags": (("ocode", S),),
                  "replay": (("bad", Q), ("ocode", S))}[mode]
    if len(extra) != len(extra_rows):
        raise ValueError(f"deep fold kernel ({mode}): takes "
                         f"{len(extra_rows)} extra inputs, got {len(extra)}")
    if dev.type != "cuda":
        raise ValueError(f"deep fold kernel: tensors on {dev}, not CUDA")
    ins = [("cache_addr", ca_t, C), ("cache_val", cv_t, C),
           ("cache_state", cs_t, C)]
    ins += [(f"dm[{j}]", t, S) for j, t in enumerate(dm_t4)]
    ins += [("w_oa", w_oa, W), ("w_val", w_val, W),
            ("w_live", w_live.to(torch.int32).contiguous(), W),
            ("horizon", st.horizon[None, :], 1)]
    ins += [(name, t, rows) for (name, rows), t in zip(extra_rows, extra)]
    for name, t, rows in ins:
        kernel_build.check_operand("deep fold kernel", name, t, (rows, N),
                                   dev)
    outs = [torch.empty((rows, N), dtype=torch.int32, device=dev)
            for rows in io_rows(cfg, mode)[1]]
    fn = getattr(LIBRARY.load(cfg), f"deep_fold_{mode}")
    err = fn(*[ctypes.c_void_p(t.data_ptr()) for _, t, _ in ins],
             *[ctypes.c_void_p(t.data_ptr()) for t in outs],
             ctypes.c_int(N),
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"deep fold kernel ({mode}) launch failed: "
                           f"CUDA error {err}")
    WRAPPERS[mode].launches += 1
    return outs


def _flags_dict(flag_t):
    return dict(mark=(flag_t & F_MARK) != 0,
                poison=(flag_t & F_POISON) != 0)


def fold_pre(cfg: SystemConfig, st, tiles, w_oa, w_val, w_live):
    """Pre-pass fold: kind/ent/sval [Q, N] and mark/poison [S, N]."""
    Q = cfg.deep_slots
    if not w_oa.is_cuda:
        return plain_pre(cfg, st, tiles, w_oa, w_val, w_live)
    slots, flags = launch("pre", cfg, st, tiles, w_oa, w_val, w_live)
    return dict(kind=slots[:Q], ent=slots[Q:2 * Q], sval=slots[2 * Q:],
                **_flags_dict(flags))


def fold_flags(cfg: SystemConfig, st, tiles, w_oa, w_val, w_live, ocode):
    """Flag-pass fold: mark/poison [S, N], truncated by ocode [S, N]."""
    if not w_oa.is_cuda:
        return plain_flags(cfg, st, tiles, w_oa, w_val, w_live, ocode)
    flags, = launch("flags", cfg, st, tiles, w_oa, w_val, w_live, ocode)
    return _flags_dict(flags)


def fold_replay(cfg: SystemConfig, st, tiles, w_oa, w_val, w_live, bad,
                ocode):
    """Replay fold with slot verdicts bad [Q, N] and own-lane codes
    ocode [S, N]: the subset of the final carry the round middle
    consumes, in the transposed tile layout."""
    C, S = cfg.cache_size, 1 << cfg.block_bits
    Q, G = cfg.deep_slots, cfg.deep_ownerval_slots
    if not w_oa.is_cuda:
        return plain_replay(cfg, st, tiles, w_oa, w_val, w_live, bad,
                            ocode)
    cache, dm, slots, gmat, cnt = launch("replay", cfg, st, tiles, w_oa,
                                         w_val, w_live, bad, ocode)
    return dict(
        ca=cache[:C], cv=cache[C:2 * C], cs=cache[2 * C:3 * C],
        cv_src=cache[3 * C:4 * C], cv_req=cache[4 * C:5 * C],
        cv_req_src=cache[5 * C:6 * C], lwh=cache[6 * C:] != 0,
        dms=dm[:S], dmc=dm[S:2 * S], dmo=dm[2 * S:3 * S],
        dmm=dm[3 * S:4 * S], dmm_src=dm[4 * S:5 * S],
        touched=dm[5 * S:6 * S] != 0, act_acc=dm[6 * S:],
        comm=slots[:Q] != 0, rel=slots[Q:2 * Q] != 0,
        relv=slots[2 * Q:3 * Q], reld=slots[3 * Q:] != 0,
        g_owner=gmat[:G], g_ci=gmat[G:],
        n_ret=cnt[0], rh=cnt[1], wh=cnt[2],
        cnt=dict(rd_miss=cnt[3], wr_miss=cnt[4], upg=cnt[5], ev=cnt[6]))


fold_pre.launches = 0
fold_flags.launches = 0
fold_replay.launches = 0
WRAPPERS = {"pre": fold_pre, "flags": fold_flags, "replay": fold_replay}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {mode: fn.launches for mode, fn in WRAPPERS.items()}


# -- plain versions (deep_engine._fold_deep restricted to the outputs) -------

_REPLAY_FIELDS = ("ca", "cv", "cs", "cv_src", "cv_req", "cv_req_src", "lwh",
                  "dms", "dmc", "dmo", "dmm", "dmm_src", "touched",
                  "act_acc", "comm", "rel", "relv", "reld", "g_owner",
                  "g_ci", "n_ret", "rh", "wh", "cnt")


def plain_pre(cfg: SystemConfig, st, tiles, w_oa, w_val, w_live):
    fin = _fold_deep(cfg, st, tiles, w_oa, w_val, w_live)
    return {f: fin[f] for f in ("kind", "ent", "sval", "mark", "poison")}


def plain_flags(cfg: SystemConfig, st, tiles, w_oa, w_val, w_live, ocode):
    fin = _fold_deep(cfg, st, tiles, w_oa, w_val, w_live, ocode=ocode)
    return {f: fin[f] for f in ("mark", "poison")}


def plain_replay(cfg: SystemConfig, st, tiles, w_oa, w_val, w_live, bad,
                 ocode):
    fin = _fold_deep(cfg, st, tiles, w_oa, w_val, w_live, bad=bad,
                     ocode=ocode)
    return {f: fin[f] for f in _REPLAY_FIELDS}


PLAIN = {"pre": plain_pre, "flags": plain_flags, "replay": plain_replay}

