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
rounds). The kernels' replica axis is held the same way on ensembles of
R = 1 and R = 3 machines (the stub's one block then serves the three
replicas in turn, flushing each one's counters after every phase), and a
mutant whose replica view puts a replica's directory rows at the wrong
offset, so that its claims land in another replica's dm, must be caught.

The threefry kernel of the jax.random twin (``csrc/threefry.cu``, an
ordinary launch) is built the same way and held to its plain version
(``utils.random.plain_block``) word for word, draws and key pairs, over
grids of one to seventeen blocks; a mutant with one rotation changed
must be caught.

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
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import threefry_kernel
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import random as jr

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


#: the mutant: replica r's directory rows start r x n rows in, not r x E,
#: so a replica's claims and commits land in its neighbour's dm
MUTANT_CASE = "round-n64-contended"
MUTANT = ("const size_t rows = (size_t)r * E * DM_COLS;",
          "const size_t rows = (size_t)r * a.n * DM_COLS;")


def gxx_command(lib: kernel_build.Library, cfg, include: pathlib.Path,
                out: pathlib.Path, csrc=kernel_build.CSRC) -> list:
    """g++ building ``lib``'s source (from ``csrc``) for ``cfg`` against
    the stub."""
    return (["g++", *GXX_FLAGS, f"-I{include}", f"-I{csrc}"]
            + [f"-D{k}={v}" for k, v in lib.defines(cfg)]
            + ["-o", str(out), "-x", "c++",
               str(pathlib.Path(csrc) / lib.source.name)])


@pytest.fixture(scope="module")
def stub_libs(tmp_path_factory):
    """{case: loaded library}, every case's library built by its own g++
    process, all started together, and the mutant's under "mutant"."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (builds the CUDA sources against a CPU stub)")
    root = tmp_path_factory.mktemp("cuda_stub")
    include = root / "include"
    include.mkdir()
    for name in ("cuda_runtime.h", "cooperative_groups.h"):
        (include / name).write_text(f'#include "{STUB}"\n')
    mutant_csrc = root / "mutant_csrc"
    shutil.copytree(kernel_build.CSRC, mutant_csrc)
    header = mutant_csrc / "sync_round.cuh"
    text = header.read_text()
    assert text.count(MUTANT[0]) == 1
    header.write_text(text.replace(*MUTANT))
    procs = {}
    builds = [(case, case, kernel_build.CSRC) for case in CASES]
    builds.append(("mutant", MUTANT_CASE, mutant_csrc))
    for name, case, csrc in builds:
        mod = CASES[case][0]
        out = root / f"{name}.so"
        procs[name] = (out, mod, subprocess.Popen(
            gxx_command(mod.LIBRARY, case_cfg(case), include, out, csrc),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, errors = {}, []
    for name, (out, mod, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}:\n{log}")
            continue
        lib = ctypes.CDLL(str(out))
        mod._bind(lib)
        libs[name] = lib
    assert not errors, "\n".join(errors)
    return libs


def stub_round(mod, lib, cfg, ca, cv, cs, dm, idx, cnt, round_, seed,
               metrics):
    """One launch of the stub-built kernel on CPU tensors, with the
    wrapper's operands and outputs: one machine, or an ensemble (a
    leading replica axis on every operand)."""
    entry, scratch_ints = KERNELS[mod]
    lead = tuple(round_.shape)
    reps = lead[0] if lead else 1
    outs = srk.new_outputs(cfg, lead, torch.device("cpu"))
    scratch = torch.full(
        (getattr(lib, scratch_ints)(reps, cfg.num_nodes),), -7,
        dtype=torch.int32)
    ins = (ca, cv, cs, dm, idx, cnt, round_, seed, metrics)
    err = getattr(lib, entry)(
        *[ctypes.c_void_p(t.data_ptr()) for t in ins + tuple(outs)],
        ctypes.c_void_p(scratch.data_ptr()), reps, cfg.num_nodes, None)
    assert err == 0, f"{entry}: error {err}"
    return tuple(outs)


OUTPUTS = ("cache_addr", "cache_val", "cache_state", "dm", "idx", "round",
           "metrics")


def mid_run_ensemble(case: str, reps: int) -> se.SyncState:
    """An ensemble of ``reps`` machines of the case's config, mid-run:
    replica r with seed 5 + r after warm-up + r rounds (so the replicas'
    rounds, keys and states all differ)."""
    warm = CASES[case][5]
    cfg = case_cfg(case)
    return se.make_ensemble([
        se.run_rounds(cfg, se.procedural_state(cfg, 200, seed=5 + r,
                                               device="cpu"), warm + r,
                      fold_impl="plain") for r in range(reps)])


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
    runs more than one node, which the 100-node cases exercise, and an
    ensemble's replicas take turns in that block."""
    for reps in (1, 3):
        assert stub_libs["round-n100-c8-h16"].sync_round_grid(reps,
                                                              100) == 1
        assert stub_libs["multi-n100-k3-h4"].sync_multi_round_grid(
            reps, 100) == 1
    assert os.path.exists(STUB)


@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_stub_built_replica_axis_equals_plain_round(stub_libs, case, reps):
    """The replica axis: R machines in one launch, each held to its own
    plain round (the plain version loops over the replicas), every
    output equal, round after round."""
    mod, _, _, _, _, _, rounds = CASES[case]
    cfg = case_cfg(case)
    lib = stub_libs[case]
    ens = mid_run_ensemble(case, reps)
    for r in range(rounds):
        args = mod.round_inputs(cfg, ens)[1:]
        want = mod.plain_round(cfg, *args)
        got = stub_round(mod, lib, cfg, *args)
        for name, a, b in zip(OUTPUTS, got, want):
            assert a.shape == b.shape, (name, a.shape, b.shape)
            assert torch.equal(a, b), (
                f"{case}, R={reps}, round {r + 1}: {name} differs at "
                f"{int((a != b).sum())} elements")
        ens = mod.round_step_fused(cfg, ens, "plain")
    for r in range(reps):
        se.check_exact_directory(cfg, se.ensemble_replica(ens, r))
    assert bool((ens.metrics.instrs_retired > 0).all())


def test_stub_mutant_claims_across_replicas_are_caught(stub_libs):
    """The mutant's replicas 1 and 2 claim and commit in rows of their
    neighbour: the launch at R = 3 differs from the plain rounds, while
    at R = 1 (no other replica) it still equals them."""
    mod = CASES[MUTANT_CASE][0]
    cfg = case_cfg(MUTANT_CASE)
    lib = stub_libs["mutant"]
    for reps, caught in ((1, False), (3, True)):
        args = mod.round_inputs(cfg, mid_run_ensemble(MUTANT_CASE,
                                                      reps))[1:]
        want = mod.plain_round(cfg, *args)
        got = stub_round(mod, lib, cfg, *args)
        differ = [name for name, a, b in zip(OUTPUTS, got, want)
                  if not torch.equal(a, b)]
        assert bool(differ) == caught, (reps, differ)


# -- the threefry kernel -------------------------------------------------------

#: the threefry mutant: the second group's last rotation 24 -> 25
THREEFRY_MUTANT = ("THREEFRY_ROUNDS(17, 29, 16, 24)\n  x0 += k1;",
                   "THREEFRY_ROUNDS(17, 29, 16, 25)\n  x0 += k1;")


@pytest.fixture(scope="module")
def threefry_libs(tmp_path_factory):
    """{"kernel": the stub-built threefry library, "mutant": its
    mutant's}, both g++ processes started together."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (builds the CUDA sources against a CPU stub)")
    root = tmp_path_factory.mktemp("threefry_stub")
    include = root / "include"
    include.mkdir()
    for name in ("cuda_runtime.h", "cooperative_groups.h"):
        (include / name).write_text(f'#include "{STUB}"\n')
    mutant_csrc = root / "mutant_csrc"
    mutant_csrc.mkdir()
    text = threefry_kernel.LIBRARY.source.read_text()
    assert text.count(THREEFRY_MUTANT[0]) == 1
    (mutant_csrc / "threefry.cu").write_text(text.replace(*THREEFRY_MUTANT))
    procs = {name: (root / f"{name}.so", subprocess.Popen(
        gxx_command(threefry_kernel.LIBRARY, None, include,
                    root / f"{name}.so", csrc),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, csrc in (("kernel", kernel_build.CSRC),
                           ("mutant", mutant_csrc))}
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{name}:\n{log}"
        lib = ctypes.CDLL(str(out))
        threefry_kernel._bind(lib)
        libs[name] = lib
    return libs


def stub_threefry(lib, key: torch.Tensor, n: int, pair: bool):
    out = torch.full((n, 2) if pair else (n,), -7, dtype=torch.int32)
    err = lib.threefry(ctypes.c_void_p(key.data_ptr()),
                       ctypes.c_void_p(out.data_ptr()), n, int(pair), 0,
                       None)
    assert err == 0, f"threefry: error {err}"
    return out


@pytest.mark.parametrize("pair", [False, True], ids=["draws", "pairs"])
@pytest.mark.parametrize("n", [1, 2, 31, 256, 4097])
def test_stub_built_threefry_equals_plain(threefry_libs, n, pair):
    """Counters 0 .. n - 1 under keys of seeds 0, 1 and 2^31 + 5 and a
    key from a chain of splits: every word equal to the plain version's
    (4097 counters: 17 blocks of 256 threads)."""
    keys = [jr.prng_key(s, "cpu") for s in (0, 1, 2**31 + 5)]
    keys.append(jr.split(jr.split(keys[2], 3)[2], 5)[4])
    for key in keys:
        want = jr.plain_block(key, n, pair)
        got = stub_threefry(threefry_libs["kernel"], key, n, pair)
        assert torch.equal(got, want), (
            f"n={n}, key {key.tolist()}: {int((got != want).sum())} words "
            "differ")


def test_stub_threefry_grid_and_mutant(threefry_libs):
    """The grid: one block for a handful of counters, a block per 256,
    capped at 4096 blocks (a thread then takes several counters). The
    mutant's draws differ from the plain version's."""
    lib = threefry_libs["kernel"]
    assert [lib.threefry_grid(n) for n in (0, 1, 256, 257, 4097,
                                           1 << 24)] == [1, 1, 1, 2, 17,
                                                         4096]
    key = jr.prng_key(3, "cpu")
    assert not torch.equal(stub_threefry(threefry_libs["mutant"], key, 64,
                                         False),
                           jr.plain_block(key, 64))
