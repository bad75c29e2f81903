"""The cooperative round kernels' CUDA sources, built on the CPU.

``csrc/sync_round.cu`` (the txn_width 1 round) and
``csrc/sync_multi_round.cu`` (txn_width >= 2) are compiled with g++
against ``tests/cuda_stub.h``, a CPU stand-in for the CUDA runtime (a
std::thread for each CUDA thread, std::barrier for the barriers, one
block a launch), and their C entry points are called with ctypes on CPU
tensors. Each launch is held to the wrapper's plain version
(``sync_round_kernel.plain_round``, ``sync_multi_round_kernel.
plain_round``) on the same tensors, every output equal, round after
round from a mid-run state, at up to 100 nodes (past 64 a thread runs
more than one node), the contended configs included (locality 0.3:
releases, reacquires, dependent writes and truncation within a few
rounds).

This checks the kernels' logic and their races between nodes, not what
nvcc makes of them: the card's check is ``tests/test_torch_cuda.py`` and
``chip_smoke.py``. Skips where g++ is absent.
"""

import ctypes
import dataclasses
import os
import pathlib
import shutil
import subprocess

import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_multi_round_kernel as smk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_round_kernel as srk)

STUB = pathlib.Path(__file__).resolve().with_name("cuda_stub.h")
GXX_FLAGS = ("-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w")

#: {wrapper module: (C entry point, its scratch size function)}
KERNELS = {srk: ("sync_round", "sync_round_scratch_ints"),
           smk: ("sync_multi_round", "sync_multi_round_scratch_ints")}

CASES = {
    # name: (module, nodes, txn_width, drain_depth, overrides, warm-up
    # rounds, rounds)
    "round-n1-c2-h1": (srk, 1, 1, 1, dict(cache_size=2, mem_size=8), 2, 3),
    "round-n33-c2-h4": (srk, 33, 1, 4, dict(cache_size=2, mem_size=32,
                                             proc_local_permille=300), 3, 3),
    "round-n64-contended": (srk, 64, 1, 4, dict(proc_local_permille=300),
                            4, 4),
    "round-n100-c8-h16": (srk, 100, 1, 16, dict(cache_size=8, mem_size=8),
                          3, 3),
    "multi-n1-k2-h1": (smk, 1, 2, 1, dict(cache_size=2, mem_size=8), 2, 3),
    "multi-n33-k3-c2-h4": (smk, 33, 3, 4, dict(cache_size=2, mem_size=32,
                                                proc_local_permille=300),
                           3, 3),
    "multi-n64-k2-contended": (smk, 64, 2, 1,
                               dict(proc_local_permille=300), 4, 5),
    "multi-n64-k3-contended": (smk, 64, 3, 4,
                               dict(proc_local_permille=300), 4, 5),
    "multi-n64-k4-c8-h1": (smk, 64, 4, 1, dict(cache_size=8, mem_size=8,
                                                proc_local_permille=500),
                           3, 3),
    "multi-n100-k3-h4": (smk, 100, 3, 4, {}, 3, 3),
}


def case_cfg(case: str) -> SystemConfig:
    mod, n, K, H, kw, _, _ = CASES[case]
    cfg = SystemConfig.scale(num_nodes=n, drain_depth=H, txn_width=K)
    return dataclasses.replace(
        cfg, **dict(dict(procedural="uniform", max_instrs=1,
                         proc_local_permille=800, pallas_burst=True), **kw))


def gxx_command(lib: kernel_build.Library, cfg, include: pathlib.Path,
                out: pathlib.Path) -> list:
    """g++ building ``lib``'s source for ``cfg`` against the stub."""
    return (["g++", *GXX_FLAGS, f"-I{include}", f"-I{kernel_build.CSRC}"]
            + [f"-D{k}={v}" for k, v in lib.defines(cfg)]
            + ["-o", str(out), "-x", "c++", str(lib.source)])


@pytest.fixture(scope="module")
def stub_libs(tmp_path_factory):
    """{case: loaded library}, every case's library built by its own g++
    process, all started together."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (builds the CUDA sources against a CPU stub)")
    root = tmp_path_factory.mktemp("cuda_stub")
    include = root / "include"
    include.mkdir()
    for name in ("cuda_runtime.h", "cooperative_groups.h"):
        (include / name).write_text(f'#include "{STUB}"\n')
    procs = {}
    for case in CASES:
        mod = CASES[case][0]
        out = root / f"{case}.so"
        procs[case] = (out, subprocess.Popen(
            gxx_command(mod.LIBRARY, case_cfg(case), include, out),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, errors = {}, []
    for case, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{case}:\n{log}")
            continue
        lib = ctypes.CDLL(str(out))
        CASES[case][0]._bind(lib)
        libs[case] = lib
    assert not errors, "\n".join(errors)
    return libs


def stub_round(mod, lib, cfg, ca, cv, cs, dm, idx, cnt, round_, seed,
               metrics):
    """One launch of the stub-built kernel on CPU tensors, with the
    wrapper's operands and outputs."""
    N, C = cfg.num_nodes, cfg.cache_size
    E = N << cfg.block_bits
    entry, scratch_ints = KERNELS[mod]
    outs = [torch.empty(shape, dtype=torch.int32) for shape in
            ((N, C), (N, C), (N, C), (E, se.DM_COLS), (N,), (),
             (len(se.METRIC_FIELDS),))]
    scratch = torch.full((getattr(lib, scratch_ints)(N),), -7,
                         dtype=torch.int32)
    ins = (ca, cv, cs, dm, idx, cnt, round_, seed, metrics)
    err = getattr(lib, entry)(
        *[ctypes.c_void_p(t.data_ptr()) for t in ins + tuple(outs)],
        ctypes.c_void_p(scratch.data_ptr()), N, None)
    assert err == 0, f"{entry}: error {err}"
    return tuple(outs)


@pytest.mark.parametrize("case", list(CASES))
def test_stub_built_round_kernel_equals_plain_round(stub_libs, case):
    mod, n, K, _, _, warm, rounds = CASES[case]
    cfg = case_cfg(case)
    assert mod.supported(cfg)
    lib = stub_libs[case]
    st = se.run_rounds(cfg, se.procedural_state(cfg, 200, seed=5,
                                                device="cpu"), warm,
                       fold_impl="plain")
    conflicts = 0
    for r in range(rounds):
        args = mod.round_inputs(cfg, st)[1:]
        want = mod.plain_round(cfg, *args)
        got = stub_round(mod, lib, cfg, *args)
        for name, a, b in zip(("cache_addr", "cache_val", "cache_state",
                               "dm", "idx", "round", "metrics"), got, want):
            assert torch.equal(a, b), (
                f"{case}, round {warm + r + 1}: {name} differs at "
                f"{int((a != b).sum())} elements")
        conflicts += int(want[6][7] - args[8][7])
        st = mod.round_step_fused(cfg, st, "plain")
    assert int(st.metrics.instrs_retired) > 0
    if n > 1:
        assert conflicts > 0, "no claim was contested"
    se.check_exact_directory(cfg, st)


def test_stub_grid_is_one_block(stub_libs):
    """The stub holds one block of 64 threads: past 64 nodes a thread
    runs more than one node, which the 100-node cases exercise."""
    assert stub_libs["round-n100-c8-h16"].sync_round_grid(100) == 1
    assert stub_libs["multi-n100-k3-h4"].sync_multi_round_grid(100) == 1
    assert os.path.exists(STUB)
