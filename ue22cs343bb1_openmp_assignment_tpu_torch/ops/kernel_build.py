"""Building and loading the port's CUDA kernel libraries.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with ctypes. A config's shapes and branches are ``-D`` defines, so there
is one library per (source, defines) pair, cached under
``build/torch_kernels/`` by a hash of the source, the headers it
includes, the defines and the flags, and built at first use (never at
import: a CPU-only machine imports every module).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import subprocess
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


class Library:
    """One kernel source and its per-config libraries.

    ``defines(cfg)`` gives the ``-D`` constants (and raises for a config
    the kernel does not take); ``bind(lib)`` sets the C entry points'
    ctypes signatures; ``kernels`` maps a regex on a ptxas entry
    function name to the short name ``ptxas_summary`` reports it under.
    """

    def __init__(self, name: str, source: str, headers: tuple, defines,
                 bind, kernels: dict):
        self.name = name
        self.source = CSRC / source
        self.headers = tuple(CSRC / h for h in headers)
        self.defines = defines
        self._bind = bind
        self.kernels = kernels
        self._paths_cache = {}
        self._loaded = {}

    def paths(self, defs: tuple):
        """(library, ptxas log) paths for the defines ``defs``."""
        if defs not in self._paths_cache:
            h = hashlib.sha256()
            for path in (self.source,) + self.headers:
                h.update(path.read_bytes())
            h.update(repr((defs, NVCC_FLAGS)).encode())
            stem = BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}"
            self._paths_cache[defs] = (stem.with_suffix(".so"),
                                       stem.with_suffix(".ptxas.txt"))
        return self._paths_cache[defs]

    def library_path(self, cfg) -> pathlib.Path:
        """Where the library for ``cfg`` is (or will be) built."""
        return self.paths(self.defines(cfg))[0]

    def command(self, defs: tuple, out: pathlib.Path) -> list:
        return ([nvcc(), *NVCC_FLAGS]
                + [f"-D{k}={v}" for k, v in defs]
                + ["-o", str(out), str(self.source)])

    def load(self, cfg) -> ctypes.CDLL:
        """The loaded library for ``cfg``, built if not cached."""
        defs = self.defines(cfg)
        if defs not in self._loaded:
            so, _ = self.paths(defs)
            if not so.exists():
                build([(self, cfg)])
            lib = ctypes.CDLL(str(so))
            self._bind(lib)
            self._loaded[defs] = lib
        return self._loaded[defs]

    def ptxas_log(self, cfg) -> str:
        """What ``nvcc -Xptxas -v`` said when the library for ``cfg``
        was built; empty if it was not built here."""
        _, ptxas = self.paths(self.defines(cfg))
        return ptxas.read_text() if ptxas.exists() else ""

    def ptxas_summary(self, cfg) -> dict:
        """{kernel: {"registers", "stack", "spill_stores",
        "spill_loads", "smem"}} from the library's ptxas log
        (:func:`parse_ptxas`); empty if it was not built here."""
        return parse_ptxas(self.ptxas_log(cfg), self.kernels)


def parse_ptxas(report: str, kernels: dict) -> dict:
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads",
    "smem"}} from the text of ``nvcc -Xptxas -v``; ``kernels`` maps a
    regex on an entry function's name to the short name it is reported
    under (``Library.kernels``). ``smem`` is the static shared memory
    ptxas reports (0 where it reports none)."""
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = next((short for pat, short in kernels.items()
                        if re.search(pat, m.group(1))), None)
            if cur is not None:
                out[cur] = {"smem": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                out[cur]["smem"] = int(m.group(1))
    return out


def check_operand(kernel: str, name: str, t, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous int32 tensor of ``shape`` on
    ``device``: what a kernel's C interface takes."""
    if t.device != device or t.dtype != torch.int32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous int32 "
            f"{list(shape)} tensor on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


# lint: host
def build(jobs) -> dict:
    """Build the libraries of ``jobs`` ((Library, cfg) pairs) that are
    not cached yet, one nvcc process per library, all started together.
    Returns {(library name, defines): seconds} for the libraries built
    here. Raises on a failed build with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lib, cfg in jobs:
        defs = lib.defines(cfg)
        so, _ = lib.paths(defs)
        if (lib.name, defs) in procs or so.exists():
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        build.nvcc_runs += 1
        proc = subprocess.Popen(lib.command(defs, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs[(lib.name, defs)] = (lib, proc, tmp, time.perf_counter())
    took, errors = {}, []
    for key, (lib, proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        took[key] = time.perf_counter() - t0
        so, ptxas = lib.paths(key[1])
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {lib.name} {dict(key[1])}:\n"
                          f"{log}")
            continue
        ptxas.write_text(log)
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


#: nvcc processes started by ``build`` in this process
build.nvcc_runs = 0
