"""ctypes bindings for the native C++ engine (builds on first use).

The port's copy of the JAX package's ``native/bindings.py``. Exposes
:class:`NativeEngine`, semantically identical to the message-level
engine (``ops/step.cycle``): same cycle model, arbitration, schedule
knobs, and protocol quirks. It is the host-side oracle and the CLI's
``--engine native`` path; it runs on the host on any machine, with or
without a card. ``engine.cpp`` beside this file is compiled with g++ at
the first ``load_library()`` call (never at import) into ``build/``
here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "engine.cpp")
_CXX = os.environ.get("CXX", "g++")
# CXXFLAGS overrides the flags; the flag string participates in the
# cache key, so a debug build gets its own cached library instead of
# silently reusing the default one
_CXXFLAGS = shlex.split(os.environ.get(
    "CXXFLAGS", "-O2 -std=c++17 -fPIC -Wall -Wextra"))
_lock = threading.Lock()
_lib = None

_METRIC_NAMES = ("cycles", "instrs_retired", "read_hits", "write_hits",
                 "read_misses", "write_misses", "upgrades", "msgs_dropped",
                 "invalidations", "evictions")


def _lib_path() -> str:
    """Build-cache path keyed on the source + compiler command hash.

    No binary is checked in (and mtime comparisons lie after a fresh
    clone, where checkout order decides which file is newer): the
    library is compiled on first use into ``build/`` under a name that
    embeds a content hash, so a source or flag change can never pick up
    a stale binary, and repeat imports reuse the cached build."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join([_CXX] + _CXXFLAGS).encode())
    return os.path.join(_DIR, "build",
                        f"libcoherence_native-{h.hexdigest()[:16]}.so")


def _build(lib_path: str) -> None:
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = lib_path + f".tmp{os.getpid()}"
    try:
        subprocess.run([_CXX] + _CXXFLAGS + ["-shared", "-o", tmp, _SRC],
                       check=True)
        os.replace(tmp, lib_path)   # atomic: concurrent builds both succeed
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = _lib_path()
        if not os.path.exists(lib_path):
            _build(lib_path)
        lib = ctypes.CDLL(lib_path)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.sim_create.restype = ctypes.c_void_p
        lib.sim_create.argtypes = [ctypes.c_int32] * 5
        lib.sim_destroy.argtypes = [ctypes.c_void_p]
        lib.sim_load_trace.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                       i32p, i32p, i32p, ctypes.c_int32]
        lib.sim_set_schedule.argtypes = [ctypes.c_void_p, i32p, i32p]
        lib.sim_set_arbitration.argtypes = [ctypes.c_void_p, i32p]
        lib.sim_set_admission.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.sim_set_inv_mode.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.sim_run.restype = ctypes.c_int64
        lib.sim_run.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.sim_quiescent.restype = ctypes.c_int32
        lib.sim_quiescent.argtypes = [ctypes.c_void_p]
        lib.sim_export_state.argtypes = [ctypes.c_void_p, i32p, i32p, i32p,
                                         i32p, i32p, u32p]
        lib.sim_export_metrics.argtypes = [ctypes.c_void_p, i64p]
        _lib = lib
        return lib


def _as_i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeEngine:
    """Host-side deterministic coherence engine (C++, ctypes-bound)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self._lib = load_library()
        self._h = self._lib.sim_create(cfg.num_nodes, cfg.cache_size,
                                       cfg.mem_size, cfg.queue_capacity,
                                       cfg.max_instrs)
        if cfg.admission_window is not None:
            self._lib.sim_set_admission(self._h, cfg.admission_window)
        self._lib.sim_set_inv_mode(
            self._h, 0 if cfg.inv_mode == "mailbox" else 1)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.sim_destroy(h)
            self._h = None

    def load_traces(self, traces: Sequence[Sequence[tuple]]) -> None:
        """traces: per-node [(op, addr, value), ...] (utils.trace format)."""
        for node, tr in enumerate(traces):
            ops = np.ascontiguousarray([t[0] for t in tr], np.int32)
            addrs = np.ascontiguousarray([t[1] for t in tr], np.int32)
            vals = np.ascontiguousarray([t[2] for t in tr], np.int32)
            self._lib.sim_load_trace(self._h, node, _as_i32p(ops),
                                     _as_i32p(addrs), _as_i32p(vals),
                                     len(tr))

    def load_instr_arrays(self, op, addr, val, count) -> None:
        op, addr, val = (np.asarray(a, np.int32) for a in (op, addr, val))
        count = np.asarray(count, np.int32)
        for node in range(self.cfg.num_nodes):
            n = int(count[node])
            o = np.ascontiguousarray(op[node, :n])
            a = np.ascontiguousarray(addr[node, :n])
            v = np.ascontiguousarray(val[node, :n])
            self._lib.sim_load_trace(self._h, node, _as_i32p(o), _as_i32p(a),
                                     _as_i32p(v), n)

    def set_schedule(self, delays: Optional[Sequence[int]] = None,
                     periods: Optional[Sequence[int]] = None) -> None:
        d = (np.ascontiguousarray(delays, np.int32)
             if delays is not None else None)
        p = (np.ascontiguousarray(periods, np.int32)
             if periods is not None else None)
        self._lib.sim_set_schedule(
            self._h, _as_i32p(d) if d is not None else None,
            _as_i32p(p) if p is not None else None)

    def set_arbitration(self, rank: Sequence[int]) -> None:
        r = np.ascontiguousarray(rank, np.int32)
        self._lib.sim_set_arbitration(self._h, _as_i32p(r))

    def run(self, max_cycles: int = 1_000_000) -> int:
        return int(self._lib.sim_run(self._h, max_cycles))

    @property
    def quiescent(self) -> bool:
        return bool(self._lib.sim_quiescent(self._h))

    def export_state(self) -> dict:
        cfg = self.cfg
        N, C, M, W = (cfg.num_nodes, cfg.cache_size, cfg.mem_size,
                      cfg.bitvec_words)
        ca = np.empty((N, C), np.int32)
        cv = np.empty((N, C), np.int32)
        cs = np.empty((N, C), np.int32)
        mem = np.empty((N, M), np.int32)
        ds = np.empty((N, M), np.int32)
        bv = np.empty((N, M, W), np.uint32)
        self._lib.sim_export_state(
            self._h, _as_i32p(ca), _as_i32p(cv), _as_i32p(cs), _as_i32p(mem),
            _as_i32p(ds), bv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return dict(cache_addr=ca, cache_val=cv, cache_state=cs, memory=mem,
                    dir_state=ds, dir_bitvec=bv)

    def metrics(self) -> dict:
        out = np.empty(10, np.int64)
        self._lib.sim_export_metrics(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return dict(zip(_METRIC_NAMES, out.tolist()))
