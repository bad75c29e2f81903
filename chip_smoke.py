#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero):

1. device: nvidia-smi name and power limit, torch and CUDA versions;
2. build: the deep-window fold kernel (csrc/deep_fold.cu), the fused
   round kernel (csrc/deep_round.cu), the sync window engine's
   window/replay and burst kernels (csrc/sync_window.cu,
   csrc/sync_burst.cu) and its fused txn_width 1 and txn_width >= 2
   rounds (csrc/sync_round.cu, csrc/sync_multi_round.cu) for every
   config used below, one nvcc per library, all started together;
   ptxas registers and spill bytes;
3. kernel vs plain: each fold mode (pre, flags, replay) and the round
   kernel on inputs taken mid-run (after 8 rounds of deep@4096), kernel
   against its plain PyTorch version on the same tensors, bit for bit;
   the round kernel also in a contended 256-node config (three
   absorption waves, attempt-based flags). The kernel's device time,
   the plain version's CUDA-event time, and the bound: bytes moved over
   HBM rate or integer operations over the int32 rate (the integer
   instructions of the kernel's SASS, counted with ``cuobjdump``; for
   the deep rows capped by the recorded work of DEEP_WORK_PER_NODE,
   both printed);
4. card vs CPU: 64 rounds of a 256-node copy of the bench deep config
   on the card through the fold kernels and through the round kernel,
   each against the plain round on the CPU, every state leaf and metric
   equal;
5. main paths: ``TransactionalSystem.procedural`` at the bench deep
   defaults (4096 nodes x 4096 instructions, chunk 64) to quiescence
   through the fold kernels (``fused_round`` off), then through the
   round kernel (``fused_round`` on, the bench's default on a card),
   each with the launch counts set to 0 just before and read just
   after: every kernel of the path launched, none of the other path's;
   equal round counts and equal final states, exact-directory
   invariant; then 8 rounds of each path at 65536 nodes with
   deep_slots=2, equal states;
6. the sync window engine, the same way: the window, replay and burst
   kernels against their plain versions on inputs taken 8 rounds into
   sync@4096 (txn_width 3 / drain_depth 4, and txn_width 1 /
   drain_depth 16) and in a contended 256-node config (locality 0.3:
   releases, reacquires, dependent hits, truncation); the fused
   txn_width 1 round (csrc/sync_round.cu) and the fused txn_width >= 2
   round (csrc/sync_multi_round.cu) against their plain_round at
   sync@4096 (txn_width 1 / drain_depth 16, txn_width 3 / drain_depth
   4), in the contended config and at 65536 nodes (the grid capped),
   their time, bound, ptxas and shared-memory figures; 256 nodes x 64
   rounds through the kernels on the card against the plain rounds on
   the CPU; then ``TransactionalSystem.procedural`` at the sync bench
   defaults (4096 nodes x 4096 instructions, chunk 64) to quiescence, at
   txn_width 3 on three routes, the fused round (sync_multi_round ==
   rounds, window and replay 0), the window kernels around the eager
   round middle (window == replay == rounds) and the plain rounds, and
   at txn_width 1 on three routes, the fused round (sync_round ==
   rounds, sync_burst 0), the burst kernel inside the eager round
   (sync_burst == rounds) and the plain rounds, each with a
   torch.profiler window (device launches, busy ms and idle share a
   round): equal rounds and states, every instruction retired; 4 rounds
   at 1048576 nodes (txn_width 2) through the fused round against the
   plain rounds; 8 rounds of the 4096-node txn_width 3 machine on stored
   traces made from a seed, card against CPU;
7. seed ensembles (slice 8): at the sync bench defaults (txn_width 3 /
   drain_depth 4, then txn_width 1 / drain_depth 16), R = 8 machines
   (seeds 0-7) to quiescence through ``run_ensemble_to_quiescence``:
   one sync_multi_round (sync_round) launch an ensemble round and no
   other, every replica bit-identical to its solo fused run, ms an
   ensemble round and aggregate instrs/sec against 8 x the solo ms a
   round, a torch.profiler window; the replica axis against its plain
   version at R = 8 on mid-run inputs (time, bound, plain time, ptxas);
   R = 64 x 4096 nodes for 16 rounds (replicas 0, 21, 42, 63 equal to
   their solo runs; the kernel timed there); R = 3 x 256 nodes x 64
   rounds on the card against the CPU; the stored-trace seed sweep
   (``utils.search.match_accepted``) of tests/fixtures/mini on the card
   against the CPU; a deep ensemble of R = 2 for 8 rounds through the
   round kernel against solo runs; and ``CoherenceSystem.run_traced`` of
   tests/fixtures/mini on the card (events equal to the CPU's, per-node
   projection equal to instruction_order.txt);
8. the message-level engine (async) and its routed delivery: the ring
   exchange kernel (csrc/ring_exchange.cu) against its plain version on
   the outbox lanes of the cycle 64 cycles into async@4096 (D = 4 and
   D = 8), every word equal, with its device time, the plain version's
   and the library call's (``transpose(0, 1).contiguous()``); 256 nodes
   x 32 instructions of ``procedural_uniform`` on the card, unrouted and
   routed through the ring at D = 4, against the CPU, every leaf equal,
   and the in-repo fixture tests/fixtures/mini (reference config,
   mailbox INV) with dumps byte-identical to the CPU's; then
   ``CoherenceSystem.from_workload`` at the async bench defaults (4096
   nodes, queue capacity 64, scatter INV, locality 0.8, chunk 64) with
   the trace cut from 4096 to 512 instructions a node, to quiescence
   three ways (plain ``mailbox.deliver``, routed through the ring kernel
   at D = 4, routed through all_to_all at D = 4): equal cycles and
   states, every instruction retired, no drops, the final state equal
   to the JAX package's (its digest and invariant counts, recorded by
   scripts/async_reference.py: the workload is racy, so both invariant
   tiers have counts there, the same on both sides), ring launches ==
   cycles on the rdma run and 0 on the others; and, with two or more
   cards, one exchange across real cards against its plain version.

The line before the last is the card's name and power limit as
nvidia-smi reports them; before it, one JSON object with a row per
kernel. The last line is the JSON result. Needs one card, no network
and no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

# the bench's deep defaults (config: bench.deep_config)
BENCH = dict(num_nodes=4096, trace_len=4096, chunk=64)
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s, and
# int32 operations/s derived from the 67 TFLOP/s float32 rate (128 fp32
# lanes x 2 flops per FMA per SM clock) as 64 int32 lanes x 1 op
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
TPU_KERNELS = {
    "pre": "ue22cs343bb1_openmp_assignment_tpu/ops/pallas_deep.py:109",
    "flags": "ue22cs343bb1_openmp_assignment_tpu/ops/pallas_deep.py:142",
    "replay": "ue22cs343bb1_openmp_assignment_tpu/ops/pallas_deep.py:121",
    "round": "ue22cs343bb1_openmp_assignment_tpu/ops/pallas_round.py:383",
    "sync_window":
        "ue22cs343bb1_openmp_assignment_tpu/ops/pallas_window.py:161",
    "sync_replay":
        "ue22cs343bb1_openmp_assignment_tpu/ops/pallas_window.py:206",
    "sync_burst": "ue22cs343bb1_openmp_assignment_tpu/ops/pallas_burst.py:42",
    # the fused txn_width 1 round replaces the same TPU kernel with the
    # eager round around it
    "sync_round": "ue22cs343bb1_openmp_assignment_tpu/ops/pallas_burst.py:42",
    # the fused txn_width >= 2 round replaces the window (:161) and replay
    # (:206) kernels with the eager round around them
    "sync_multi_round":
        "ue22cs343bb1_openmp_assignment_tpu/ops/pallas_window.py:161",
    "ring": "ue22cs343bb1_openmp_assignment_tpu/parallel/rdma_comm.py:105",
}
CSRC = "ue22cs343bb1_openmp_assignment_tpu_torch/csrc/"
SOURCES = {"pre": CSRC + "deep_fold.cu", "flags": CSRC + "deep_fold.cu",
           "replay": CSRC + "deep_fold.cu", "round": CSRC + "deep_round.cu",
           "sync_window": CSRC + "sync_window.cu",
           "sync_replay": CSRC + "sync_window.cu",
           "sync_burst": CSRC + "sync_burst.cu",
           "sync_round": CSRC + "sync_round.cu",
           "sync_multi_round": CSRC + "sync_multi_round.cu",
           "ring": CSRC + "ring_exchange.cu"}
FOLD_MODES = ("pre", "flags", "replay")
SYNC_KERNELS = ("sync_window", "sync_replay", "sync_burst", "sync_round",
                "sync_multi_round")
#: The recorded work of the deep rows (the three fold modes and the
#: round), in integer operations a node: what ``sass_ops`` counted on
#: the SASS of the one-thread-per-node kernels that the shared-memory
#: fold replaced (csrc/deep_fold.cu and csrc/deep_round.cu with their
#: tables in registers, at deep@4096, printed as ``N x {per_node}`` by
#: that tree's chip_smoke.py). A deep row's work is the smaller of this
#: and what the current kernel issues (``deep_work``): the function
#: needs no more than either, and a redesign that issues more does not
#: raise the yardstick it is judged by.
DEEP_WORK_PER_NODE = {"pre": 10915, "flags": 10928, "replay": 17983,
                      "round": 43829}


class SmokeFailure(Exception):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def bench_cfg(num_nodes: int, fused: bool = False, **kw):
    from ue22cs343bb1_openmp_assignment_tpu_torch.bench import deep_config
    return dataclasses.replace(deep_config(num_nodes), fused_round=fused,
                               **kw)


def contended_cfg():
    """The round kernel's contended check: 256 nodes at locality 0.3,
    three absorption waves, attempt-based flags."""
    return bench_cfg(256, True, proc_local_permille=300, deep_waves=3,
                     deep_exact_flags=False)


def sync_cfg(num_nodes: int, txn_width: int, kernels: bool = True, **kw):
    """The bench's sync config (txn_width 3 / drain_depth 4, or
    drain_depth 16 at txn_width 1), through the kernels or the plain
    rounds."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.bench import sync_config
    return dataclasses.replace(
        sync_config(num_nodes, txn_width, window_kernels=kernels), **kw)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps calls, after a warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(fn, kernel: str = "") -> float:
    """Median device time of the launches of ``kernel`` in fn() (every
    launch when ``kernel`` is empty). The profiler now and then returns
    a window without the card's events (it can miss the first
    milliseconds of a window, which may be all of a short one); such a
    window is taken again, at most twice, each time with fn() run four
    times as often, before the phase fails."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.bench import device_events
    fn()
    for attempt in range(3):
        events, _ = device_events(
            lambda: [fn() for _ in range(4 ** attempt)])
        times = [us for name, us in events if kernel in name]
        if times:
            return statistics.median(times) / 1e3
    raise SmokeFailure(f"the profiler saw no {kernel or 'device'} launch "
                       "in three windows")


# SASS opcodes that do no integer work of the kernel: memory, control
# flow, atomics, fences, the uniform datapath (prefix U) and register,
# predicate and lane moves
_NOT_OPS = {"BRA", "BSSY", "BSYNC", "BREAK", "EXIT", "RET", "CALL",
            "WARPSYNC", "BAR", "NOP", "YIELD", "S2R", "CS2R", "S2UR", "R2UR",
            "MOV", "P2R", "R2P", "ATOM", "ATOMG", "RED", "REDG", "MEMBAR",
            "ERRBAR", "CGAERRBAR", "CCTL", "SHFL", "VOTE", "ENDCOLLECTIVE"}


def _is_op(opcode: str) -> bool:
    base = opcode.split(".")[0]
    return not (base in _NOT_OPS or base.startswith(("LD", "ST", "U"))
                or opcode.startswith("IMAD.MOV"))


def sass_ops(sass: str, function: str, steps: int, w_loops: int,
             barriers: int = 0, every_path: bool = False,
             block_barriers: int = 0) -> dict:
    """Integer operations per node of the kernel whose mangled name
    matches ``function``, counted on its machine code (``cuobjdump
    -sass``): the integer instructions that every thread runs for a
    node whatever the data.

    ``every_path`` is for the deep kernels, whose folds read their
    tables from shared memory and whose window loops end early: block
    barriers sit beside the grid barriers, so no code is fenced off, and
    every instruction of a window loop counts, on every path (the most
    a loop iteration can issue; ``steps`` is then the loop's
    iterations). The window loops are the ``w_loops`` innermost loops
    with the most integer instructions, among those nested in another
    loop (the round kernel's node loops) where any is, else among all
    (the fold kernel). The choice is checked: each chosen loop reads
    shared memory (the fold's tables) and holds at least twice the
    integer instructions of any loop passed over.

    - Main code is everything up to the last EXIT; the blocks after it
      run only when a warp diverges at a barrier.
    - Each grid barrier (``barriers`` of them) is the code between a
      pair of BAR.SYNC: the master thread's atomic and spin loop. It is
      left out, as are atomic and fence instructions anywhere. The last
      ``block_barriers`` BAR.SYNC are block barriers after the last grid
      barrier (the fused sync rounds' reduction of their counters).
    - Loops are backward branches. The fold's window loops (``w_loops``
      of them) are the loops nested deepest (in the round kernel's node
      loops; in the fused sync rounds, node loops inside replica loops),
      or the kernel's only loop; each counts ``steps`` times, every
      other instruction once. The round kernel's loops over
      the E directory rows (its claim copy) thus count once per node,
      which undercounts.
    - A forward branch makes the stretch it jumps over data-dependent,
      so that stretch is left out, except for a loop's guard (a branch
      over a whole loop to just past its end) and branches into the
      blocks after the main code.
    """
    import re
    ins, cur = [], None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z0-9_.]+)(.*?);", line)
        if m and cur and re.search(function, cur):
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    exits = [at for at, op, _ in ins if op.split(".")[0] == "EXIT"]
    if not exits:
        raise SmokeFailure(f"{function}: no kernel of that name in the SASS")
    end = exits[-1]
    ins = [i for i in ins if i[0] <= end]
    bars = [at for at, op, _ in ins if op.startswith("BAR.SYNC")]
    if not every_path and len(bars) != 2 * barriers + block_barriers:
        raise SmokeFailure(f"{function}: {len(bars)} BAR.SYNC for "
                           f"{barriers} grid barriers and {block_barriers} "
                           "block barriers")
    grid_bars = bars[:2 * barriers]
    fences = [] if every_path else list(zip(grid_bars[::2], grid_bars[1::2]))

    def fenced(at):
        return any(lo <= at <= hi for lo, hi in fences)

    jumps = []
    for at, op, rest in ins:
        m = re.search(r"(0x[0-9a-f]+)\s*$", rest.strip())
        if op.split(".")[0] == "BRA" and m and not fenced(at):
            to = int(m.group(1), 16)
            if to != at and to <= end:     # not the trap, not a tail jump
                jumps.append((at, to))
    loops = [(to, at) for at, to in jumps if to < at]
    def depth(lp):
        return sum(1 for o in loops
                   if o != lp and o[0] <= lp[0] and lp[1] <= o[1])

    nested = [lp for lp in loops if depth(lp)]
    deepest = max((depth(lp) for lp in loops), default=0)
    wl = loops if len(loops) == 1 else [lp for lp in nested
                                        if depth(lp) == deepest]
    if every_path:
        def count(lp, ok):
            return sum(1 for at, op, _ in ins
                       if lp[0] <= at <= lp[1] and ok(op))
        inner = [lp for lp in (nested or loops)
                 if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                            for o in loops)]
        inner.sort(key=lambda lp: count(lp, _is_op))
        wl, passed = sorted(inner[len(inner) - w_loops:]), inner[:-w_loops]
        most_passed = max((count(lp, _is_op) for lp in passed), default=0)
        if (len(inner) < w_loops
                or any(count(lp, lambda op: op.startswith("LDS")) == 0
                       or count(lp, _is_op) < 2 * most_passed
                       for lp in wl)):
            raise SmokeFailure(
                f"{function}: no {w_loops} window loops stand out: "
                f"integer instructions of the innermost loops "
                f"{[count(lp, _is_op) for lp in inner]}, shared-memory "
                f"reads {[count(lp, lambda op: op.startswith('LDS')) for lp in inner]}")
    elif len(wl) != w_loops:
        raise SmokeFailure(f"{function}: expected {w_loops} window loops, "
                           f"found {len(wl)} among {len(loops)} loops")
    skips = [(at, to) for at, to in jumps if to > at
             and not any(at < lo and hi < to <= hi + 64 for lo, hi in loops)]
    sure = [(at, op) for at, op, _ in ins if not fenced(at)
            and not any(a < at < t for a, t in skips)]
    in_w = [sum(1 for at, op in ([(at, op) for at, op, _ in ins]
                                 if every_path else sure)
                if lo <= at <= hi and _is_op(op)) for lo, hi in wl]
    once = sum(1 for at, op in sure if _is_op(op)
               and not any(lo <= at <= hi for lo, hi in wl))
    return dict(per_node=sum(in_w) * steps + once, per_step=in_w, once=once,
                skippable=len(ins) - len(sure), instructions=len(ins))


def kernel_sass(library, cfg) -> str:
    """``cuobjdump -sass`` of ``library`` (a kernel_build.Library) built
    for ``cfg``."""
    import os
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    out = subprocess.run([tool if os.path.exists(tool) else "cuobjdump",
                          "-sass", str(library.library_path(cfg))],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise SmokeFailure(f"cuobjdump failed: {out.stderr.strip()}")
    return out.stdout


def fold_inputs(cfg, st) -> dict:
    """{mode: argument tuple} of the three folds for the next round of
    ``st``: the pre-pass inputs, and the ocode/bad that the round middle
    hands the flag and replay folds, taken by running the middle with
    the plain folds through capturing callbacks."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import deep_engine
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops.deep_fold_kernel \
        import PLAIN
    tiles = deep_engine.state_tiles(cfg, st)
    win = deep_engine.window(cfg, st)
    got = {}

    def flags_fn(oc):
        return PLAIN["flags"](cfg, st, tiles, *win, oc)

    def replay_fn(bad, oc):
        got.update(bad=bad, ocode=oc)
        return PLAIN["replay"](cfg, st, tiles, *win, bad, oc)

    deep_engine.deep_round_core(cfg, st.dm, st.round, st.seed,
                                PLAIN["pre"](cfg, st, tiles, *win),
                                flags_fn, replay_fn,
                                deep_engine.TorchIndexOps())
    base = (cfg, st, tiles) + tuple(win)
    return {"pre": base, "flags": base + (got["ocode"],),
            "replay": base + (got["bad"], got["ocode"])}


def flat_outputs(d) -> list:
    """(name, tensor) pairs of a wrapper's outputs: a dict, nested or
    not, by sorted key, or a tuple by position."""
    if isinstance(d, tuple):
        return [(str(i), t) for i, t in enumerate(d)]
    out = []
    for k in sorted(d):
        v = d[k]
        out += flat_outputs(v) if isinstance(v, dict) else [(k, v)]
    return out


def compare(label: str, k_out: list, p_out: list) -> int:
    """Bit-identity of a kernel's outputs and its plain version's;
    returns the largest absolute difference (0)."""
    import torch
    torch.cuda.synchronize()
    if [n for n, _ in k_out] != [n for n, _ in p_out]:
        raise SmokeFailure(f"{label}: kernel and plain outputs differ in "
                           "their fields")
    for (name, kt), (_, pt) in zip(k_out, p_out):
        if kt.shape != pt.shape or kt.dtype != pt.dtype:
            raise SmokeFailure(f"{label}.{name}: {kt.dtype} "
                               f"{tuple(kt.shape)} vs plain {pt.dtype} "
                               f"{tuple(pt.shape)}")
        diff = (kt.to(torch.int64) - pt.to(torch.int64)).abs()
        e = int(diff.max()) if diff.numel() else 0
        if e:
            raise SmokeFailure(f"{label}.{name}: kernel differs from plain "
                               f"at {int((diff != 0).sum())} elements "
                               f"(max |d| {e})")
    return 0


def fold_iterations(cfg, unroll: int) -> int:
    """Iterations of the fold's window loop over the W steps of ``cfg``
    when the kernel runs ``unroll`` steps an iteration (its
    ``deep_*_window_unroll()``; the steps left over run outside the
    loop)."""
    return (cfg.drain_depth + cfg.txn_width) // unroll


def deep_work(kernel: str, issued: int) -> int:
    """Integer operations a node of a deep row's bound: what the
    current kernel issues (``issued``, its SASS count), capped by the
    recorded work of ``kernel``."""
    return min(DEEP_WORK_PER_NODE[kernel], issued)


def deep_io_bytes(cfg, kernel: str) -> int:
    """Bytes a deep kernel ("pre", "flags", "replay" or "round") must
    move at ``cfg``: each input read once, each output written once."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_fold_kernel as dfk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_round_kernel as drk)
    if kernel == "round":
        return sum(drk.io_contract_bytes(cfg))
    in_rows, out_rows = dfk.io_rows(cfg, kernel)
    return 4 * cfg.num_nodes * (in_rows + sum(out_rows))


def row(name: str, kernel: str, ms: float, plain_ms: float, io_bytes: int,
        ops: int) -> dict:
    t_bytes = io_bytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return dict(name=name, route="cuda", source=SOURCES[kernel],
                replaces=TPU_KERNELS[kernel], launches=0, max_abs_err=0,
                ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def phase_build(jobs) -> None:
    """Build every (library, config) of ``jobs``, all nvcc processes
    started together; print what ptxas said of each kernel."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
    t0 = time.perf_counter()
    took = kernel_build.build(jobs)
    say("build", f"{len(took)} librar{'y' if len(took) == 1 else 'ies'} "
        f"built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k[0]} {s:.1f} s' for k, s in took.items())})")
    for lib, cfg in jobs:
        for kernel, info in lib.ptxas_summary(cfg).items():
            nodes = cfg.num_nodes if cfg is not None else "any"
            say("build", f"{lib.name} N={nodes} "
                f"{dict(lib.defines(cfg))} {kernel}: {info}")


def phase_kernel_vs_plain(cfg) -> tuple:
    """Fold modes against their plain versions at mid-run inputs; returns
    (rows, the mid-run state)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_fold_kernel as dfk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    # mid-run inputs, made with the plain folds so that a faulty kernel
    # cannot shape them
    st = se.procedural_state(cfg, BENCH["trace_len"], device="cuda")
    st = se.run_rounds(cfg, st, 8, fold_impl="plain")
    args = fold_inputs(cfg, st)
    sass = kernel_sass(dfk.LIBRARY, cfg)
    lib = dfk.LIBRARY.load(cfg)
    smem = lib.deep_fold_smem_bytes()
    iterations = fold_iterations(cfg, lib.deep_fold_window_unroll())
    rows = {}
    for mode, wrapper in dfk.WRAPPERS.items():
        plain = dfk.PLAIN[mode]
        a = args[mode]
        k_out = flat_outputs(wrapper(*a))
        compare(mode, k_out, flat_outputs(plain(*a)))
        # the kernel's own device time (CUPTI, through torch.profiler):
        # CUDA events around a launch would include the host's launch
        # overhead, which is longer than the kernel
        ms = kernel_ms(lambda: [wrapper(*a) for _ in range(20)],
                       "deep_fold_kernel")
        plain_ms = event_ms(lambda: plain(*a), 3)
        io_bytes = deep_io_bytes(cfg, mode)
        count = sass_ops(sass, rf"deep_fold_kernelILi{FOLD_MODES.index(mode)}E",
                         iterations, 1, every_path=True)
        work = deep_work(mode, count["per_node"])
        ops = work * cfg.num_nodes
        rows[mode] = row(f"deep_fold_{mode}", mode, ms, plain_ms, io_bytes,
                         ops)
        say("kernel", f"{mode}: bit-identical to plain over "
            f"{len(k_out)} outputs; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms, bound {rows[mode]['bound_ms']:.5f} ms "
            f"({rows[mode]['bound_by']}: {io_bytes} B, {ops} integer ops "
            f"= N x {work}, the smaller of the kernel's N x "
            f"{count['per_node']} ({count}) and the recorded N x "
            f"{DEEP_WORK_PER_NODE[mode]}); {smem} B of dynamic shared "
            f"memory a block")
    return rows, st


def phase_round_vs_plain(cfg, st) -> dict:
    """The round kernel against plain_round at the mid-run state ``st``
    of deep@4096 and in the contended config; returns its row."""
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_round_kernel as drk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    cfg = dataclasses.replace(cfg, fused_round=True)
    args = drk.round_inputs(cfg, st)
    k_out = flat_outputs(drk.fused_round(*args))
    compare("round", k_out, flat_outputs(drk.plain_round(*args)))
    con = contended_cfg()
    cst = se.run_rounds(con, se.procedural_state(
        con, BENCH["trace_len"], device="cuda"), 6, fold_impl="plain")
    cargs = drk.round_inputs(con, cst)
    compare("round (contended)", flat_outputs(drk.fused_round(*cargs)),
            flat_outputs(drk.plain_round(*cargs)))
    torch.cuda.synchronize()
    ms = kernel_ms(lambda: [drk.fused_round(*args) for _ in range(20)],
                   "deep_round_kernel")
    plain_ms = event_ms(lambda: drk.plain_round(*args), 3)
    io_bytes = deep_io_bytes(cfg, "round")
    lib = drk.LIBRARY.load(cfg)
    count = sass_ops(kernel_sass(drk.LIBRARY, cfg), r"deep_round_kernel",
                     fold_iterations(cfg, lib.deep_round_window_unroll()),
                     2 + int(cfg.deep_exact_flags), every_path=True)
    work = deep_work("round", count["per_node"])
    ops = work * cfg.num_nodes
    r = row("deep_round", "round", ms, plain_ms, io_bytes, ops)
    say("kernel", f"round: bit-identical to plain_round over {len(k_out)} "
        f"outputs at deep@4096 and in the contended 256-node config "
        f"(waves 3, attempt flags); kernel {ms:.4f} ms (grid "
        f"{lib.deep_round_grid(cfg.num_nodes)} blocks, "
        f"{lib.deep_round_smem_bytes()} B of dynamic shared memory a "
        f"block), plain {plain_ms:.2f} ms, bound {r['bound_ms']:.5f} ms "
        f"({r['bound_by']}: {io_bytes} B, {ops} integer ops = N x {work}, "
        f"the smaller of the kernel's N x {count['per_node']} ({count}) "
        f"and the recorded N x {DEEP_WORK_PER_NODE['round']})")
    return r


def phase_card_vs_cpu() -> None:
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    import numpy as np
    t0 = time.perf_counter()
    cfg = bench_cfg(256)
    want = convert.to_numpy(se.run_rounds(cfg, se.procedural_state(
        cfg, BENCH["trace_len"], device="cpu"), 64))
    t_cpu = time.perf_counter() - t0
    for fused in (False, True):
        cfg = bench_cfg(256, fused)
        t0 = time.perf_counter()
        card = se.run_rounds(cfg, se.procedural_state(
            cfg, BENCH["trace_len"], device="cuda"), 64)
        got = convert.to_numpy(card)
        for k in want:
            if not np.array_equal(want[k], got[k]):
                raise SmokeFailure(
                    f"card ({'round' if fused else 'fold'} kernels) and CPU "
                    f"differ in leaf {k} after 64 rounds at 256 nodes")
        se.check_exact_directory(cfg, card)
        say("card-vs-cpu", f"256 nodes x 64 rounds through the "
            f"{'round kernel' if fused else 'fold kernels'}: {len(want)} "
            f"leaves equal to the CPU's (card "
            f"{time.perf_counter() - t0:.1f} s, cpu {t_cpu:.1f} s, retired "
            f"{int(got['metrics.instrs_retired'])})")


def _drive(cfg, run, warm: bool = False):
    """Run ``run(system)`` from a fresh machine with every launch count
    set to 0 just before and read just after; (result, seconds,
    counts). ``warm`` first makes the same run once and discards it, so
    that a run of a few rounds is not timed on a cold allocator."""
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional \
        import TransactionalSystem
    sys0 = TransactionalSystem.procedural(cfg, BENCH["trace_len"],
                                          device="cuda")
    if warm:
        run(sys0)
    torch.cuda.synchronize()
    bench.reset_launch_counts()
    t0 = time.perf_counter()
    done = run(sys0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return done, wall, bench.launch_counts()


def phase_main_path(rows: dict) -> None:
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    import numpy as np
    length = BENCH["trace_len"]
    finals = {}
    for fused in (False, True):
        cfg = bench_cfg(BENCH["num_nodes"], fused)
        done, wall, counts = _drive(cfg,
                                    lambda s: s.run(chunk=BENCH["chunk"]))
        m = done.metrics
        if not done.quiescent:
            raise SmokeFailure("deep@4096 did not reach quiescence")
        if m["instrs_retired"] != cfg.num_nodes * length:
            raise SmokeFailure(f"retired {m['instrs_retired']} of "
                               f"{cfg.num_nodes * length}")
        inv = done.check_invariants()
        mine = ("round",) if fused else FOLD_MODES
        for kernel, n in counts.items():
            if kernel in mine and n <= 0:
                raise SmokeFailure(f"main path launched the {kernel} "
                                   "kernel no time")
            if kernel not in mine and n:
                raise SmokeFailure(f"the {'fused' if fused else 'fold'} "
                                   f"path launched the {kernel} kernel")
            if kernel in mine:
                rows[kernel]["launches"] = n
        if fused and counts["round"] != m["rounds"]:
            raise SmokeFailure(f"{counts['round']} round launches in "
                               f"{m['rounds']} rounds")
        finals[fused] = (m["rounds"], convert.to_numpy(done.state))
        say("main", f"deep@4096 x {length} through the "
            f"{'round kernel' if fused else 'fold kernels'}: quiescent "
            f"after {m['rounds']} rounds, "
            f"{m['instrs_retired'] / wall:.6g} instrs/sec, "
            f"{wall * 1e3 / m['rounds']:.4f} ms/round, wall {wall:.2f} s, "
            f"launches {counts}, invariant {inv}")
    (r0, a), (r1, b) = finals[False], finals[True]
    if r0 != r1 or any(not np.array_equal(a[k], b[k]) for k in a):
        raise SmokeFailure(f"the fused round ({r1} rounds) and the fold "
                           f"path ({r0} rounds) end in different states")
    say("main", f"fused and fold paths: same {r0} rounds, every leaf equal")

    states = {}
    for fused in (False, True):
        big = bench_cfg(65536, fused)
        st, wall, counts = _drive(big, lambda s: s.run_rounds(8))
        inv = st.check_invariants()
        states[fused] = convert.to_numpy(st.state)
        say("main", f"deep@65536 (deep_slots=2) x 8 rounds through the "
            f"{'round kernel' if fused else 'fold kernels'}: retired "
            f"{st.instrs_retired}, {wall * 1e3 / 8:.3f} ms/round, launches "
            f"{counts}, invariant {inv}")
    if any(not np.array_equal(states[False][k], states[True][k])
           for k in states[False]):
        raise SmokeFailure("deep@65536: fused and fold paths differ")


# -- the sync window engine ---------------------------------------------------

SYNC_BIG = 1048576      # the size only this engine reaches


def sync_contended_cfg(txn_width: int):
    """256 nodes at locality 0.3: releases, reacquires, dependent hits
    and truncation all occur within a few rounds."""
    return sync_cfg(256, txn_width, proc_local_permille=300)


def _sync_mid_run(cfg, rounds: int):
    """A machine ``rounds`` rounds into its run, made by the plain
    rounds so that a faulty kernel cannot shape its own inputs."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    plain = dataclasses.replace(cfg, pallas_burst=False)
    return se.run_rounds(plain, se.procedural_state(
        plain, BENCH["trace_len"], device="cuda"), rounds)


def replay_inputs(cfg, st, args, window_out) -> tuple:
    """The replay fold's arguments for the round whose window fold gave
    ``window_out``: the round middle's first_lose, fill_state and
    fill_val after ``window``'s arguments."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_window_kernel as swk)
    slotmat, stepmat, cv_pre = window_out
    mid = se.multi_middle(cfg, st, se._index_ops(),
                          *swk.unpack_window(cfg, slotmat, stepmat), cv_pre,
                          0)
    return args + (mid["first_lose"][None, :].contiguous(),
                   mid["fill_state"].contiguous(),
                   mid["fill_val"].contiguous())


def _sync_row(name, library, cfg, kernel_fn, plain_fn, args, io_bytes,
              steps_needed: int) -> dict:
    """Time one sync kernel against its plain version on ``args`` and
    bound it: bytes over the HBM rate, or the integer instructions of
    its SASS (the window loop counted once per step that this run's data
    needs, ``steps_needed`` over all nodes) over the int32 rate."""
    kname = name + "_kernel"
    ms = kernel_ms(lambda: [kernel_fn(*args) for _ in range(20)], kname)
    plain_ms = event_ms(lambda: plain_fn(*args), 3)
    count = sass_ops(kernel_sass(library, cfg), kname, 1, 1)
    ops = count["per_step"][0] * steps_needed + count["once"] * cfg.num_nodes
    r = row(name, name, ms, plain_ms, io_bytes, ops)
    say("kernel", f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
        f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}: {io_bytes} B, "
        f"{ops} integer ops = {steps_needed} steps x "
        f"{count['per_step'][0]} + N x {count['once']}: {count})")
    return r


def phase_sync_kernels() -> dict:
    """The window, replay and burst kernels against their plain versions
    at sync@4096 mid-run and in the contended config; returns their
    rows."""
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_burst_kernel as sbk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_window_kernel as swk)
    N = BENCH["num_nodes"]
    rows = {}
    for cfg, warm in ((sync_cfg(N, 3), 8), (sync_contended_cfg(3), 6)):
        st = _sync_mid_run(cfg, warm)
        args = swk.round_inputs(cfg, st)
        want = swk.plain_window(*args)
        k_out = flat_outputs(swk.window(*args))
        compare(f"sync_window@{cfg.num_nodes}", k_out, flat_outputs(want))
        rargs = replay_inputs(cfg, st, args, want)
        wantr = swk.plain_replay(*rargs)
        kr_out = flat_outputs(swk.replay(*rargs))
        compare(f"sync_replay@{cfg.num_nodes}", kr_out, flat_outputs(wantr))
        W = cfg.drain_depth + cfg.txn_width
        say("kernel", f"sync window and replay at {cfg.num_nodes} nodes "
            f"(locality {cfg.proc_local_permille / 1000}): "
            f"{len(k_out)} + {len(kr_out)} output planes bit-identical to "
            f"plain; {int((want[0][:cfg.txn_width] != 0).sum())} "
            f"transactions, {int((rargs[6] < W).sum())} truncated windows, "
            f"{int(wantr[1][0].sum())} retired")
        if cfg.num_nodes != N:
            continue
        rows["sync_window"] = _sync_row(
            "sync_window", swk.LIBRARY, cfg, swk.window, swk.plain_window,
            args, sum(swk.io_contract_bytes(cfg, "window")), W * N)
        # a replay needs the steps it retires and the one that ends them
        need = int(torch.clamp(wantr[1][0] + 1, max=W).sum())
        rows["sync_replay"] = _sync_row(
            "sync_replay", swk.LIBRARY, cfg, swk.replay, swk.plain_replay,
            rargs, sum(swk.io_contract_bytes(cfg, "replay")), need)
    for cfg, warm in ((sync_cfg(N, 1), 8), (sync_contended_cfg(1), 6)):
        st = _sync_mid_run(cfg, warm)
        args = (cfg, st.cache_addr, st.cache_val, st.cache_state, st.idx,
                st.instr_count)
        want = sbk.plain_burst(*args)
        k_out = flat_outputs(sbk.burst(*args))
        compare(f"sync_burst@{cfg.num_nodes}", k_out, flat_outputs(want))
        say("kernel", f"sync burst at {cfg.num_nodes} nodes (locality "
            f"{cfg.proc_local_permille / 1000}): {len(k_out)} outputs "
            f"bit-identical to plain; {int(want[0].sum())} burst hits")
        if cfg.num_nodes == N:
            # a burst needs its d hits and the slot that stops it
            rows["sync_burst"] = _sync_row(
                "sync_burst", sbk.LIBRARY, cfg, sbk.burst, sbk.plain_burst,
                args, sum(sbk.io_contract_bytes(cfg)),
                int((want[0] + 1).sum()))
    return rows


#: more nodes than the fused rounds' grids have threads: their node loops
#: go round more than once
SYNC_ROUND_BIG = 65536


def _fused_vs_plain(name: str, mod, txn_width: int):
    """A fused sync round kernel (module ``mod``, C entry points named
    after ``name``) against its plain_round, bit for bit in every output,
    on inputs taken mid-run at sync@4096, in the contended config and at
    SYNC_ROUND_BIG nodes (the grid capped); returns the sync@4096 (config,
    state, arguments, plain outputs)."""
    N = BENCH["num_nodes"]
    for cfg, warm in ((sync_cfg(N, txn_width), 8),
                      (sync_contended_cfg(txn_width), 6),
                      (sync_cfg(SYNC_ROUND_BIG, txn_width), 4)):
        n = cfg.num_nodes
        st = _sync_mid_run(cfg, warm)
        args = mod.round_inputs(cfg, st)
        grid = getattr(mod.LIBRARY.load(cfg), f"{name}_grid")
        if grid(1, n) <= 0:
            raise SmokeFailure(f"{name}@{n}: no grid (CUDA error "
                               f"{-grid(1, n)})")
        if n == SYNC_ROUND_BIG and grid(1, n) != grid(1, 2 * n):
            raise SmokeFailure(f"{name}@{n}: grid {grid(1, n)} is not "
                               "capped")
        want = mod.plain_round(*args)
        k_out = flat_outputs(mod.fused_round(*args))
        compare(f"{name}@{n}", k_out, flat_outputs(want))
        say("kernel", f"{name} at {n} nodes (txn_width {txn_width}, "
            f"drain_depth {cfg.drain_depth}, locality "
            f"{cfg.proc_local_permille / 1000}, {warm} rounds in): "
            f"{len(k_out)} outputs bit-identical to plain_round; grid "
            f"{grid(1, n)} blocks of 64 for {n} nodes; retired "
            f"{int(want[6][1] - args[9][1])}, conflicts "
            f"{int(want[6][7] - args[9][7])}, evictions "
            f"{int(want[6][8] - args[9][8])}; grid {grid(1, n)}")
        if n == N:
            bench = (cfg, st, args, want)
    return bench


def phase_sync_round_kernel() -> dict:
    """The fused txn_width 1 round against plain_round (drain_depth 16)
    as ``_fused_vs_plain`` says; returns its row, timed and bounded at
    sync@4096."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_round_kernel as srk)
    cfg, st, args, _ = _fused_vs_plain("sync_round", srk, 1)
    plain_ms = event_ms(lambda: srk.plain_round(*args), 3)
    return _fused_row("sync_round", srk, cfg, args,
                      round_loops("sync_round", cfg, st), plain_ms)


def phase_sync_multi_round_kernel() -> dict:
    """The fused txn_width >= 2 round against plain_round (txn_width 3,
    drain_depth 4) as ``_fused_vs_plain`` says; returns its row, timed
    and bounded at sync@4096."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_multi_round_kernel as smk)
    cfg, st, args, _ = _fused_vs_plain("sync_multi_round", smk, 3)
    plain_ms = event_ms(lambda: smk.plain_round(*args), 3)
    return _fused_row("sync_multi_round", smk, cfg, args,
                      round_loops("sync_multi_round", cfg, st), plain_ms)


def round_loops(name: str, cfg, st) -> dict:
    """The iterations that the next round of ``st`` (one machine, or an
    ensemble: summed over its replicas) needs of the fused kernel's
    per-node loops. sync_round: the burst's d hits and the slot that
    stops it. sync_multi_round: the pre-claim fold runs to the step that
    stops it (that step included), the probe scan over the steps before
    the stop (it ends early at an unsafe step, which this count does not
    see), the replay over the steps it retires."""
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_burst_kernel as sbk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_multi_round_kernel as smk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_window_kernel as swk)
    if st.round.dim() == 1:
        per = [round_loops(name, cfg, se.ensemble_replica(st, r))
               for r in range(st.round.shape[0])]
        return {k: sum(p[k] for p in per) for k in per[0]}
    if name == "sync_round":
        d = sbk.plain_burst(cfg, st.cache_addr, st.cache_val,
                            st.cache_state, st.idx, st.instr_count)[0]
        return {"burst slots": int((d + 1).sum())}
    args = smk.round_inputs(cfg, st)
    retired = smk.plain_round(*args)[6][1] - args[9][1]
    steps, _ = swk._plain_fold(cfg, *swk.round_inputs(cfg, st)[1:])
    before_stop = sum((s["hit_ok"] | s["ok"]).to(torch.int64)
                      for s in steps)
    W = cfg.drain_depth + cfg.txn_width
    return {"fold steps": int(torch.clamp(before_stop + 1, max=W).sum()),
            "probe steps": int(before_stop.sum()),
            "replay steps": int(retired)}


def _fused_row(name: str, mod, cfg, args, loops: dict,
               plain_ms: float, reps: int = 1) -> dict:
    """The row of a fused sync round kernel (module ``mod``, kernel and C
    entry points named after ``name``) timed on ``args`` at ``cfg``: 20
    launches under the profiler, the bound from its bytes and from the
    integer instructions of its SASS (each loop nested in a node loop
    counted for the iterations ``loops`` gives it, in address order, the
    rest once a node), ptxas registers and spills, dynamic and static
    shared memory read from the library. ``reps``: the replicas of an
    ensemble's ``args`` (every byte and node counted ``reps`` times)."""
    kname = f"{name}_kernel"
    ms = kernel_ms(lambda: [mod.fused_round(*args) for _ in range(20)],
                   kname)
    count = sass_ops(kernel_sass(mod.LIBRARY, cfg), kname, 1, len(loops),
                     barriers=3, block_barriers=2)
    N = cfg.num_nodes
    ops = (sum(per * n for per, n in zip(count["per_step"], loops.values()))
           + count["once"] * N * reps)
    io_bytes = sum(mod.io_contract_bytes(cfg, reps))
    r = row(name, name, ms, plain_ms, io_bytes, ops)
    ptx = next(iter(mod.LIBRARY.ptxas_summary(cfg).values()), {})
    lib = mod.LIBRARY.load(cfg)
    static_smem = getattr(lib, f"{name}_static_smem_bytes")()
    if static_smem < 0:
        raise SmokeFailure(f"{name}: cudaFuncGetAttributes failed (CUDA "
                           f"error {-static_smem})")
    r.update(registers=ptx.get("registers"),
             spill_bytes=ptx.get("spill_stores", 0)
             + ptx.get("spill_loads", 0),
             dynamic_smem_bytes=getattr(lib, f"{name}_smem_bytes")(),
             static_smem_bytes=static_smem)
    say("kernel", f"{name} at R = {reps}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms, "
        f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}: {io_bytes} B, "
        f"{ops} integer ops = "
        + " + ".join(f"{n} {what} x {per}" for per, (what, n)
                     in zip(count["per_step"], loops.items()))
        + f" + {reps} x N x {count['once']}: {count}); ptxas {ptx}; "
        f"{r['dynamic_smem_bytes']} B of dynamic shared memory a block (the "
        f"launch's), {static_smem} B static (cudaFuncGetAttributes); grid "
        f"{getattr(lib, f'{name}_grid')(reps, N)} blocks of 64")
    return r


def _leaves_differ(a: dict, b: dict):
    import numpy as np
    return next((k for k in a if not np.array_equal(a[k], b[k])), None)


def phase_sync_card_vs_cpu() -> None:
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    for K in (3, 1):
        t0 = time.perf_counter()
        plain = sync_cfg(256, K, kernels=False)
        want = convert.to_numpy(se.run_rounds(plain, se.procedural_state(
            plain, BENCH["trace_len"], device="cpu"), 64))
        cfg = sync_cfg(256, K)
        card = se.run_rounds(cfg, se.procedural_state(
            cfg, BENCH["trace_len"], device="cuda"), 64)
        got = convert.to_numpy(card)
        bad = _leaves_differ(want, got)
        if bad:
            raise SmokeFailure(f"sync txn_width {K}: the kernels on the "
                               f"card and the plain round on the CPU differ "
                               f"in leaf {bad} after 64 rounds at 256 nodes")
        se.check_exact_directory(cfg, card)
        say("card-vs-cpu", f"sync txn_width {K}, 256 nodes x 64 rounds "
            f"through the kernels: {len(want)} leaves equal to the CPU's "
            f"plain rounds ({time.perf_counter() - t0:.1f} s, retired "
            f"{int(got['metrics.instrs_retired'])})")


def _stored_traces(cfg, seed: int):
    """(op, addr, val, count) [N, max_instrs] numpy arrays: uniform
    reads and writes at locality 0.8, made from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    N, T = cfg.num_nodes, cfg.max_instrs
    local = rng.random((N, T)) < 0.8
    home = np.where(local, np.arange(N)[:, None], rng.integers(0, N, (N, T)))
    addr = (home << cfg.block_bits) | rng.integers(0, cfg.mem_size, (N, T))
    return (rng.integers(0, 2, (N, T)).astype(np.int32),
            addr.astype(np.int32),
            rng.integers(0, 256, (N, T)).astype(np.int32),
            np.full((N,), T, np.int32))


def _step_route(step):
    """``run`` for ``_drive``: ``step`` round after round to quiescence,
    as ``run_sync_to_quiescence`` runs them (quiescence tested between
    chunk-round blocks)."""
    def run(sys0):
        st = sys0.state
        while not bool(st.quiescent()):
            for _ in range(BENCH["chunk"]):
                st = step(st)
        return dataclasses.replace(sys0, state=st)
    return run


#: the profiler window of a fused sync route, long enough that the kernel
#: events the profiler misses near a window's edges do not matter (32
#: rounds of the fused txn_width 1 route, about 6 ms under the profiler,
#: showed about 0.7 of its one launch a round on an H100); the eager and
#: plain routes' rounds take milliseconds each, and their hundreds to
#: thousands of launches a round make a long window slow to read back, so
#: theirs is shorter
PROFILE_ROUNDS = {"fused round": 128, "other": 16}


def _sync_routes(rows: dict, txn_width: int) -> None:
    """sync@4096 x 4096 to quiescence on three routes, in one process:
    the fused round (one kernel a round, the bench's route on a card),
    the eager round around the TPU kernels' counterparts (at txn_width
    1 the burst kernel, ``_round_step_single(use_kernel=True)``; else the
    window and replay kernels, ``round_step_multi_kernel``), and the
    plain rounds. Each run's launch counts are set to 0 just before it
    and read just after, and give its kernels' rows their launches; each
    route's torch.profiler window (PROFILE_ROUNDS, 16 rounds in) gives
    its device launches, busy ms and idle share a round, and how many
    launches of the route's kernels the profiler saw."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench, convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_window_kernel as swk)
    N, length, K = BENCH["num_nodes"], BENCH["trace_len"], txn_width
    fused, plain = sync_cfg(N, K), sync_cfg(N, K, kernels=False)
    if K == 1:
        eager, eager_kernels = "burst kernel", ("sync_burst",)

        def eager_step(st):
            return se._round_step_single(fused, st, use_kernel=True)
    else:
        eager, eager_kernels = "window kernels", ("sync_window",
                                                  "sync_replay")

        def eager_step(st):
            return swk.round_step_multi_kernel(fused, st)
    routes = {
        "fused round": (fused, lambda s: s.run(chunk=BENCH["chunk"]),
                        lambda st: se.round_step(fused, st),
                        ("sync_round" if K == 1 else "sync_multi_round",)),
        eager: (fused, _step_route(eager_step), eager_step, eager_kernels),
        "plain rounds": (plain, lambda s: s.run(chunk=BENCH["chunk"]),
                         lambda st: se.round_step(plain, st), ())}
    mid = se.run_rounds(plain, se.procedural_state(plain, length,
                                                   device="cuda"), 16)
    finals = {}
    for route, (cfg, run, step, mine) in routes.items():
        done, wall, counts = _drive(cfg, run)
        m = done.metrics
        if not done.quiescent:
            raise SmokeFailure(f"sync@{N} txn_width {K} ({route}) did not "
                               "reach quiescence")
        if m["instrs_retired"] != N * length:
            raise SmokeFailure(f"retired {m['instrs_retired']} of "
                               f"{N * length}")
        inv = done.check_invariants()
        for kernel, n in counts.items():
            want = m["rounds"] if kernel in mine else 0
            if n != want:
                raise SmokeFailure(
                    f"sync txn_width {K} ({route}): {n} launches of the "
                    f"{kernel} kernel in {m['rounds']} rounds, expected "
                    f"{want}")
            if kernel in mine:
                rows[kernel]["launches"] = n
        rounds = PROFILE_ROUNDS.get(route, PROFILE_ROUNDS["other"])
        prof = bench.profile_steps(step, mid, rounds)
        seen = "".join(
            f" ({prof['kernel_calls_per_round'].get(k, 0) * rounds:.0f}"
            f" of the {k} kernel seen)" for k in mine)
        finals[route] = (m["rounds"], convert.to_numpy(done.state))
        say("main", f"sync@{N} x {length}, txn_width {K}, drain_depth "
            f"{cfg.drain_depth}, through the {route}: quiescent after "
            f"{m['rounds']} rounds, {m['instrs_retired'] / wall:.6g} "
            f"instrs/sec, {wall * 1e3 / m['rounds']:.4f} ms/round, wall "
            f"{wall:.2f} s, launches "
            f"{ {k: v for k, v in counts.items() if v} }, invariant {inv}; "
            f"profile of {rounds} rounds: "
            f"{prof['device_launches_per_round']:.2f} device launches"
            f"{seen}, "
            f"busy {prof['device_busy_ms_per_round']:.4f} ms, idle share "
            f"{prof['device_idle_share']:.3f}, "
            f"{prof['wall_ms_per_round']:.4f} ms/round under the profiler, "
            f"kernels {prof['kernel_ms_per_round']}")
    (r0, a) = finals["fused round"]
    for route in (eager, "plain rounds"):
        r1, b = finals[route]
        bad = _leaves_differ(a, b)
        if r0 != r1 or bad:
            raise SmokeFailure(f"sync txn_width {K}: the fused round ({r0} "
                               f"rounds) and the {route} ({r1}) end in "
                               f"different states (leaf {bad})")
    say("main", f"sync txn_width {K}: fused round, {eager} and plain "
        f"rounds, same {r0} rounds, every leaf equal")


def phase_sync_main_path(rows: dict) -> None:
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    N = BENCH["num_nodes"]
    _sync_routes(rows, 3)
    _sync_routes(rows, 1)

    states = {}
    for kernels in (True, False):
        big = sync_cfg(SYNC_BIG, 2, kernels)
        st, wall, counts = _drive(big, lambda s: s.run_rounds(4), warm=True)
        if kernels and not (counts["sync_multi_round"] == 4
                            and counts["sync_window"] == 0
                            and counts["sync_replay"] == 0):
            raise SmokeFailure(f"sync@{SYNC_BIG}: launches {counts}")
        inv = st.check_invariants()
        states[kernels] = convert.to_numpy(st.state)
        say("main", f"sync@{SYNC_BIG} (txn_width 2) x 4 rounds (after a warm-up "
            f"run) through the "
            f"{'fused round' if kernels else 'plain rounds'}: "
            f"retired "
            f"{st.instrs_retired}, {wall * 1e3 / 4:.3f} ms/round, "
            f"invariant {inv}")
        del st
    bad = _leaves_differ(states[True], states[False])
    if bad:
        raise SmokeFailure(f"sync@{SYNC_BIG}: fused and plain rounds "
                           f"differ in leaf {bad}")
    del states

    # the 4096-node txn_width 3 machine on stored traces (the plain
    # rounds: the kernels compute a procedural stream only)
    cfg = dataclasses.replace(sync_cfg(N, 3, kernels=False),
                              procedural=None, max_instrs=32)
    traces = _stored_traces(cfg, seed=0)
    t0 = time.perf_counter()
    card = se.run_rounds(cfg, se.from_traces(cfg, instr_arrays=traces,
                                             device="cuda"), 8)
    cpu = se.run_rounds(cfg, se.from_traces(cfg, instr_arrays=traces,
                                            device="cpu"), 8)
    bad = _leaves_differ(convert.to_numpy(cpu), convert.to_numpy(card))
    if bad:
        raise SmokeFailure(f"stored traces: card and CPU differ in {bad}")
    inv = se.check_exact_directory(cfg, card)
    retired = int(card.metrics.instrs_retired)
    if retired <= 0:
        raise SmokeFailure("stored traces: nothing retired in 8 rounds")
    say("main", f"sync@{N} txn_width 3 on stored traces ({cfg.max_instrs} "
        f"instructions a node, seed 0) x 8 rounds: card equal to CPU, "
        f"retired {retired}, invariant {inv} "
        f"({time.perf_counter() - t0:.1f} s)")


# -- seed ensembles, the deep round's event record and traced runs ---------

#: the ensemble route's sizes: R machines of the sync bench config
ENSEMBLE = dict(reps=8, big_reps=64, big_rounds=16)
MINI = "tests/fixtures/mini"


def _seeds_ensemble(cfg, reps: int, device="cuda"):
    """(ensemble, solo states): ``reps`` fresh machines of ``cfg`` at the
    bench's trace length, seeds 0 .. reps - 1."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    solos = [se.procedural_state(cfg, BENCH["trace_len"], seed=s,
                                 device=device) for s in range(reps)]
    return se.make_ensemble(solos), solos


def _replica_equals_solo(ens, r: int, solo, where: str) -> None:
    """Replica r of ``ens`` equals ``solo`` (its machine run alone through
    the fused round for as many rounds), every leaf and counter."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    bad = _leaves_differ(convert.to_numpy(solo),
                         convert.to_numpy(se.ensemble_replica(ens, r)))
    if bad:
        raise SmokeFailure(f"{where}: replica {r} differs from its solo run "
                           f"in leaf {bad}")


def _ensemble_to_quiescence(rows: dict, txn_width: int) -> None:
    """R = 8 seeds of sync@4096 x 4096 to quiescence through
    ``run_ensemble_to_quiescence``: one fused launch an ensemble round and
    no other launch, each replica bit-identical to its solo fused run,
    the ensemble's ms a round and aggregate instrs/sec against 8 x the
    solo ms a round, and a torch.profiler window of the route."""
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    N, K, R = BENCH["num_nodes"], txn_width, ENSEMBLE["reps"]
    cfg = sync_cfg(N, K)
    name = "sync_round" if K == 1 else "sync_multi_round"
    ens0, solos = _seeds_ensemble(cfg, R)
    torch.cuda.synchronize()
    bench.reset_launch_counts()
    t0 = time.perf_counter()
    ens = se.run_ensemble_to_quiescence(cfg, ens0, BENCH["chunk"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = bench.launch_counts()
    rounds = int(ens.round[0])
    if not bool(ens.quiescent()):
        raise SmokeFailure(f"ensemble R={R} txn_width {K} did not reach "
                           "quiescence")
    others = {k: v for k, v in counts.items() if v and k != name}
    if counts[name] != rounds or others:
        raise SmokeFailure(f"ensemble R={R} txn_width {K}: {counts[name]} "
                           f"{name} launches in {rounds} rounds, others "
                           f"{others}")
    rows[name]["ensemble_launches"] = counts[name]
    retired = int(ens.metrics.instrs_retired.sum())
    if retired != R * N * BENCH["trace_len"]:
        raise SmokeFailure(f"ensemble retired {retired}")
    solo_walls, solo_rounds = [], []
    for r, st in enumerate(solos):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = se.run_sync_to_quiescence(cfg, st, BENCH["chunk"])
        torch.cuda.synchronize()
        solo_walls.append(time.perf_counter() - t0)
        solo_rounds.append(int(done.round))
        done = se.run_rounds(cfg, done, rounds - int(done.round))
        _replica_equals_solo(ens, r, done, f"ensemble txn_width {K}")
    solo_ms = statistics.median(w * 1e3 / n
                                for w, n in zip(solo_walls, solo_rounds))
    mid = se.run_rounds(cfg, solos[0], 16)
    mid = se.make_ensemble([mid.replace(seed=st.seed) for st in solos])
    prof = bench.profile_steps(lambda st: se.ensemble_round_step(cfg, st),
                               mid, PROFILE_ROUNDS["fused round"])
    rows[name].update(
        ensemble_ms_per_round=wall * 1e3 / rounds,
        ensemble_instrs_per_s=retired / wall,
        solo_ms_per_round_x8=R * solo_ms)
    say("ensemble", f"sync@{N} x {BENCH['trace_len']}, txn_width {K}, "
        f"drain_depth {cfg.drain_depth}, R = {R} (seeds 0-{R - 1}) through "
        f"run_ensemble_to_quiescence: quiescent after {rounds} rounds "
        f"(solo runs {min(solo_rounds)}-{max(solo_rounds)}), {name} "
        f"launches {counts[name]}, no other launch; "
        f"{wall * 1e3 / rounds:.4f} ms/ensemble round, "
        f"{retired / wall:.6g} instrs/sec in all, wall {wall:.2f} s; solo "
        f"fused runs {solo_ms:.4f} ms/round (median of {R}), 8 x solo "
        f"{R * solo_ms:.4f} ms; every replica bit-identical to its solo "
        f"run; profile of {PROFILE_ROUNDS['fused round']} ensemble rounds: "
        f"{prof['device_launches_per_round']:.2f} device launches, busy "
        f"{prof['device_busy_ms_per_round']:.4f} ms, idle share "
        f"{prof['device_idle_share']:.3f}, "
        f"{prof['wall_ms_per_round']:.4f} ms/round under the profiler, "
        f"kernels {prof['kernel_ms_per_round']}")


def _ensemble_kernel_rows(rows: dict, txn_width: int) -> None:
    """The replica axis against the plain version at R = 8 on mid-run
    inputs (8 seeds, 8 plain rounds in), then R = 64 x 4096 nodes for
    ENSEMBLE["big_rounds"] rounds (more work items than resident
    threads): replicas 0, 21, 42 and 63 equal to their solo runs, and
    the kernel timed on the last round's inputs. Adds the R = 8 and
    R = 64 times, bounds and plain times to the solo row."""
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_multi_round_kernel as smk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_round_kernel as srk)
    N, K = BENCH["num_nodes"], txn_width
    cfg = sync_cfg(N, K)
    name, mod = (("sync_round", srk) if K == 1
                 else ("sync_multi_round", smk))
    R = ENSEMBLE["reps"]
    _, solos = _seeds_ensemble(cfg, R)
    ens = se.make_ensemble([se.run_rounds(cfg, st, 8, fold_impl="plain")
                            for st in solos])
    args = mod.round_inputs(cfg, ens)
    compare(f"{name} R={R}", flat_outputs(mod.fused_round(*args)),
            flat_outputs(mod.plain_round(*args)))
    plain_ms = event_ms(lambda: mod.plain_round(*args), 2)
    r8 = _fused_row(name, mod, cfg, args, round_loops(name, cfg, ens),
                    plain_ms, reps=R)

    big = ENSEMBLE["big_reps"]
    ens0, solos = _seeds_ensemble(cfg, big)
    torch.cuda.synchronize()
    bench.reset_launch_counts()
    t0 = time.perf_counter()
    ens = ens0
    for _ in range(ENSEMBLE["big_rounds"]):
        ens = se.ensemble_round_step(cfg, ens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = bench.launch_counts()
    if counts[name] != ENSEMBLE["big_rounds"] or any(
            v for k, v in counts.items() if k != name):
        raise SmokeFailure(f"R={big}: launches {counts}")
    for r in (0, 21, 42, 63):
        solo = se.run_rounds(cfg, solos[r], ENSEMBLE["big_rounds"])
        _replica_equals_solo(ens, r, solo, f"R={big} txn_width {K}")
    args = mod.round_inputs(cfg, ens)
    r64 = _fused_row(name, mod, cfg, args, round_loops(name, cfg, ens),
                     float("nan"), reps=big)
    rows[name].update(
        r8_ms=r8["ms"], r8_bound_ms=r8["bound_ms"],
        r8_bound_by=r8["bound_by"], r8_plain_ms=plain_ms,
        r64_ms=r64["ms"], r64_bound_ms=r64["bound_ms"],
        r64_bound_by=r64["bound_by"],
        r64_ms_per_round=wall * 1e3 / ENSEMBLE["big_rounds"])
    say("ensemble", f"{name} at R = {big} x {N} nodes ({big * N} in all), "
        f"{ENSEMBLE['big_rounds']} rounds: one launch a round, "
        f"{wall * 1e3 / ENSEMBLE['big_rounds']:.4f} ms/ensemble round; "
        f"replicas 0, 21, 42, 63 bit-identical to their solo runs; grid "
        f"{getattr(mod.LIBRARY.load(cfg), name + '_grid')(big, N)} blocks")


def _ensemble_card_vs_cpu() -> None:
    """256 nodes, R = 3, 64 rounds: the kernels' replica axis on the card
    against the plain version on the CPU, every leaf equal."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    for K in (3, 1):
        t0 = time.perf_counter()
        cfg = sync_cfg(256, K)
        out = {}
        for dev in ("cuda", "cpu"):
            ens, _ = _seeds_ensemble(cfg, 3, dev)
            for _ in range(64):
                ens = se.ensemble_round_step(cfg, ens)
            out[dev] = convert.to_numpy(ens)
        bad = _leaves_differ(out["cpu"], out["cuda"])
        if bad:
            raise SmokeFailure(f"ensemble txn_width {K}: card and CPU "
                               f"differ in leaf {bad}")
        say("card-vs-cpu", f"ensemble R = 3 x 256 nodes, txn_width {K}, 64 "
            f"rounds: the replica axis on the card equal to the plain "
            f"rounds on the CPU, {len(out['cpu'])} leaves "
            f"({time.perf_counter() - t0:.1f} s)")


def _seed_sweep_card_vs_cpu() -> None:
    """The stored-trace seed sweep (``utils.search.match_accepted``) on
    tests/fixtures/mini over seeds 0-7, accepted runs made from the CPU's
    replica dumps of seeds 0 and 5: the card's map equals the CPU's."""
    import pathlib
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu_torch.state import init_state
    from ue22cs343bb1_openmp_assignment_tpu_torch.utils import search, trace
    cfg = SystemConfig.reference()
    mini = pathlib.Path(__file__).resolve().parent / MINI
    traces = trace.load_test_dir(str(mini), cfg.num_nodes, cfg.max_instrs)
    cpu = init_state(cfg, traces, device="cpu")
    ens = search.sweep_seeds(cfg, cpu, [0, 5])
    accepted = [search.replica_dumps(cfg, ens, r) for r in range(2)]
    want = search.match_accepted(cfg, cpu, accepted, seeds=range(8))
    got = search.match_accepted(cfg, init_state(cfg, traces, device="cuda"),
                                accepted, seeds=range(8))
    if got != want or got.get(0) != 0:
        raise SmokeFailure(f"seed sweep on {MINI}: card {got}, CPU {want}")
    say("card-vs-cpu", f"seed sweep of {MINI} over seeds 0-7 (stored "
        f"traces, one ensemble): card map {got} equal to the CPU's")


def _deep_ensemble() -> None:
    """R = 2 of deep@4096 through the fused round for 8 rounds (each
    replica its own round kernel launch a round): each replica equal to
    its solo fused run."""
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    cfg = bench_cfg(BENCH["num_nodes"], True)
    ens, solos = _seeds_ensemble(cfg, 2)
    torch.cuda.synchronize()
    bench.reset_launch_counts()
    for _ in range(8):
        ens = se.ensemble_round_step(cfg, ens)
    torch.cuda.synchronize()
    counts = {k: v for k, v in bench.launch_counts().items() if v}
    if counts != {"round": 16}:
        raise SmokeFailure(f"deep ensemble R=2 x 8 rounds: launches {counts}")
    for r, st in enumerate(solos):
        _replica_equals_solo(ens, r, se.run_rounds(cfg, st, 8),
                             "deep ensemble")
    say("ensemble", f"deep@{BENCH['num_nodes']} R = 2 x 8 rounds through the "
        f"round kernel: launches {counts} (one a replica and round), each "
        f"replica bit-identical to its solo fused run")


def _traced_mini() -> None:
    """``CoherenceSystem.run_traced`` of tests/fixtures/mini on the card:
    events equal to the CPU's, and the per-node projection of its lines
    equal to the fixture's instruction_order.txt."""
    import pathlib
    import numpy as np
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.utils import eventlog
    mini = pathlib.Path(__file__).resolve().parent / MINI
    runs = {dev: CoherenceSystem.from_test_dir(str(mini), device=dev)
            .run_traced() for dev in ("cuda", "cpu")}
    (card, ev), (_, want) = runs["cuda"], runs["cpu"]
    if sorted(ev) != sorted(want) or any(
            not np.array_equal(ev[k], want[k]) for k in want):
        raise SmokeFailure("traced mini run: card events differ from CPU's")
    fixture = (mini / "instruction_order.txt").read_text().splitlines()
    lines = eventlog.to_lines(ev)
    if eventlog.per_node_projection(lines) != (
            eventlog.per_node_projection(fixture)):
        raise SmokeFailure("traced mini run: per-node projection differs "
                           "from instruction_order.txt")
    say("traced", f"{MINI} run_traced on the card: {len(lines)} instruction "
        f"lines over {ev['fetch'].shape[0]} cycles, events equal to the "
        f"CPU's, per-node projection equal to instruction_order.txt; "
        f"quiescent {card.quiescent}")


def phase_ensembles(rows: dict) -> None:
    """This slice's paths: the ensemble route at the sync bench defaults
    (txn_width 3 / drain_depth 4 and txn_width 1 / drain_depth 16), its
    kernel rows, card against CPU, the stored-trace seed sweep, a deep
    ensemble and a traced run."""
    t0 = time.perf_counter()
    for K in (3, 1):
        _ensemble_to_quiescence(rows, K)
        _ensemble_kernel_rows(rows, K)
    _ensemble_card_vs_cpu()
    _seed_sweep_card_vs_cpu()
    _deep_ensemble()
    _traced_mini()
    say("ensemble", f"ensemble, sweep and traced phases took "
        f"{time.perf_counter() - t0:.1f} s")


# -- the message-level engine and its routed delivery ----------------------

#: the async main path: the bench's 4096 nodes, its trace cut to 512
#: instructions a node for time (the bench runs 4096)
ASYNC = dict(num_nodes=4096, trace_len=512, chunk=64, shards=4)
#: the JAX package's final state of that run on the CPU, as printed by
#: ``scripts/async_reference.py`` (defaults): its cycles, its nonzero
#: invariant counts and ``convert.leaves_digest`` of its leaves
ASYNC_REFERENCE = {
    "cycles": 2240,
    "step_violations": {"unowned_with_sharers": 16},
    "coherence": {"valid_line_unknown_to_home": 21,
                  "exclusive_line_dir_not_em": 30,
                  "shared_line_dir_unowned": 4, "multiple_owners": 5,
                  "owner_with_other_copies": 4, "clean_line_stale_value": 75,
                  "phantom_sharers": 630},
    "digest": ("d5aa18ca474c9a0085ae96474fd4c6d9"
               "9eebdbc98bd75008d058b2aa38408d88"),
}


def async_cfg(num_nodes: int, trace_len: int, transport: str = "rdma",
              **kw):
    """The async bench config (scatter INV, queue capacity 64, locality
    0.8) with ``trace_len`` instructions a node."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.bench import async_config
    return dataclasses.replace(async_config(num_nodes, trace_len),
                               transport=transport, **kw)


def async_system(cfg, device):
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    return CoherenceSystem.from_workload(cfg, "procedural_uniform",
                                         device=device)


def ring_outboxes(cfg, st, shards: int):
    """The packed outbox lanes [D, D, cap, 2 + Fw] that the rdma
    transport hands the ring kernel in the cycle after ``st``, captured
    from a cycle with plain delivery."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import mailbox, step
    from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import (
        mesh, rdma_comm)
    got = {}

    def capture(cfg_, state, cand, arb_rank, new_head, new_count):
        got["ob"] = rdma_comm._pack_lanes(*rdma_comm.outbox_lanes(
            cfg_, mesh.make_layout(cfg_.num_nodes, shards, device="cuda"),
            cand, arb_rank)[:4])
        return mailbox.deliver(cfg_, state, cand, arb_rank, new_head,
                               new_count)

    step.cycle(cfg, st, deliver_fn=capture)
    return got["ob"]


def phase_ring_kernel() -> dict:
    """The ring exchange against its plain version on the outbox lanes
    64 cycles into async@4096, at D = 4 (the main path's) and D = 8;
    returns its row (D = 4)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import ring_kernel
    cfg = async_cfg(ASYNC["num_nodes"], ASYNC["trace_len"])
    st = step.run_cycles(cfg, async_system(cfg, "cuda").state, 64)
    r = None
    for D in (ASYNC["shards"], 8):
        ob = ring_outboxes(cfg, st, D)
        k_out = [("inbox", ring_kernel.exchange(ob))]
        compare(f"ring D={D}", k_out,
                [("inbox", ring_kernel.plain_exchange(ob))])
        ms = kernel_ms(lambda: [ring_kernel.exchange(ob) for _ in range(20)],
                       "ring_exchange_kernel")
        plain_ms = event_ms(lambda: ring_kernel.plain_exchange(ob), 3)
        # the one PyTorch call that computes the same function, timed on
        # the card as the kernel is (its copy kernel's device time)
        lib_ms = kernel_ms(lambda: [ob.transpose(0, 1).contiguous()
                                    for _ in range(20)])
        io_bytes = sum(ring_kernel.io_contract_bytes(*ob.shape[1:]))
        row_d = dict(row("ring_exchange", "ring", ms, plain_ms, io_bytes, 0),
                     library_ms=lib_ms)
        rows_valid = int((ob[..., 0] >= 0).sum())
        say("kernel", f"ring D={D}: lanes {tuple(ob.shape)} ({rows_valid} "
            f"messages) equal to plain word for word; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, library transpose().contiguous() "
            f"{lib_ms:.4f} ms, bound {row_d['bound_ms']:.5f} ms "
            f"({row_d['bound_by']}: {io_bytes} B)")
        if D == ASYNC["shards"]:
            r = row_d
    return r


def _async_run(cfg, sys0, shards: int, transport: str, chunk: int,
               max_cycles: int):
    """Run ``sys0`` to quiescence with delivery over ``shards`` shards
    (1: unrouted) by ``transport``, launch counts set to 0 just before
    and read just after; (system, seconds, counts)."""
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import (
        mesh, sharded_step)
    cfg = dataclasses.replace(cfg, transport=transport)
    fn = sharded_step.transport_deliver(
        cfg, mesh.make_layout(cfg.num_nodes, shards, device=sys0.state.device))
    sys0 = dataclasses.replace(sys0, cfg=cfg)
    torch.cuda.synchronize()
    bench.reset_launch_counts()
    t0 = time.perf_counter()
    done = sys0.run(max_cycles, chunk=chunk, deliver_fn=fn)
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0, bench.launch_counts()


def phase_async_card_vs_cpu() -> None:
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    t0 = time.perf_counter()
    cfg = dataclasses.replace(async_cfg(256, 32), queue_capacity=32)
    cpu, _, _ = _async_run(cfg, async_system(cfg, "cpu"), 1, "rdma", 16,
                           10_000)
    want = convert.sim_numpy_leaves(cpu.state)
    for shards in (1, ASYNC["shards"]):
        card, wall, counts = _async_run(cfg, async_system(cfg, "cuda"),
                                        shards, "rdma", 16, 10_000)
        bad = _leaves_differ(want, convert.sim_numpy_leaves(card.state))
        route = "plain delivery" if shards == 1 else f"the ring at D={shards}"
        if bad:
            raise SmokeFailure(f"async 256 nodes: the card ({route}) and the "
                               f"CPU differ in leaf {bad}")
        if (counts["ring"] > 0) != (shards > 1):
            raise SmokeFailure(f"async 256 nodes ({route}): {counts['ring']} "
                               "ring launches")
        say("card-vs-cpu", f"async 256 nodes x 32 instructions through "
            f"{route}: {len(want)} leaves equal to the CPU's (cycles "
            f"{card.metrics['cycles']}, retired {card.instrs_retired}, ring "
            f"launches {counts['ring']}, {wall:.1f} s)")
    ref = SystemConfig.reference()
    cpu = CoherenceSystem.from_test_dir("tests/fixtures/mini", ref,
                                        device="cpu").run()
    for shards in (1, 4):
        card, _, counts = _async_run(
            ref, CoherenceSystem.from_test_dir("tests/fixtures/mini", ref,
                                               device="cuda"),
            shards, "rdma", 1, 100_000)
        if card.dumps() != cpu.dumps():
            raise SmokeFailure(f"tests/fixtures/mini over {shards} shard(s): "
                               "the card's dumps differ from the CPU's")
        say("card-vs-cpu", f"tests/fixtures/mini (reference config, mailbox "
            f"INV) on the card over {shards} shard(s): {len(cpu.dumps())} "
            f"dumps byte-identical to the CPU's, {card.metrics['cycles']} "
            f"cycles, ring launches {counts['ring']}")
    say("card-vs-cpu", f"async phases took {time.perf_counter() - t0:.1f} s")


def phase_async_main_path(rows: dict) -> None:
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import invariants
    N, length, D = ASYNC["num_nodes"], ASYNC["trace_len"], ASYNC["shards"]
    cfg = async_cfg(N, length)
    finals = {}
    for shards, transport in ((1, "none"), (D, "rdma"), (D, "all_to_all")):
        done, wall, counts = _async_run(
            cfg, async_system(cfg, "cuda"), shards,
            transport if shards > 1 else "rdma", ASYNC["chunk"],
            200 * length)
        m = done.metrics
        route = ("plain mailbox.deliver" if shards == 1 else
                 f"routed {transport} at D={shards}")
        if not done.quiescent:
            raise SmokeFailure(f"async@{N} ({route}) did not reach "
                               "quiescence")
        if m["instrs_retired"] != N * length or m["msgs_dropped"]:
            raise SmokeFailure(f"async@{N} ({route}): retired "
                               f"{m['instrs_retired']} of {N * length}, "
                               f"{m['msgs_dropped']} messages dropped")
        step_v = {k: int(v) for k, v in invariants.step_violations(
            cfg, done.state).items() if int(v)}
        coherence = {k: v for k, v in invariants.coherence_report(
            cfg, done.state).items() if v}
        digest = convert.leaves_digest(convert.sim_numpy_leaves(done.state))
        got = dict(cycles=m["cycles"], step_violations=step_v,
                   coherence=coherence, digest=digest)
        if got != ASYNC_REFERENCE:
            raise SmokeFailure(f"async@{N} ({route}) differs from the JAX "
                               f"package's run: {got} vs {ASYNC_REFERENCE}")
        want_ring = m["cycles"] if transport == "rdma" else 0
        for kernel, n in counts.items():
            if n != (want_ring if kernel == "ring" else 0):
                raise SmokeFailure(f"async@{N} ({route}): {n} launches of "
                                   f"the {kernel} kernel in {m['cycles']} "
                                   "cycles")
        if transport == "rdma":
            rows["ring"]["launches"] = counts["ring"]
        finals[transport] = (m["cycles"], convert.sim_numpy_leaves(
            done.state))
        say("main", f"async@{N} x {length} (trace cut from the bench's "
            f"4096 for time), queue capacity {cfg.queue_capacity}, scatter "
            f"INV, chunk {ASYNC['chunk']}, through {route}: quiescent after "
            f"{m['cycles']} cycles, {m['instrs_retired'] / wall:.6g} "
            f"instrs/sec, {wall * 1e3 / m['cycles']:.4f} ms/cycle, wall "
            f"{wall:.2f} s, ring launches {counts['ring']}, dropped "
            f"{m['msgs_dropped']}; final state equal to the JAX package's "
            f"(digest {digest[:16]}, invariant counts {step_v} and "
            f"{coherence}: the racy workload's, as in JAX)")
    (c0, a) = finals["none"]
    for transport in ("rdma", "all_to_all"):
        c1, b = finals[transport]
        bad = _leaves_differ(a, b)
        if c0 != c1 or bad:
            raise SmokeFailure(f"async@{N}: {transport} ({c1} cycles) and "
                               f"plain delivery ({c0}) end in different "
                               f"states (leaf {bad})")
    say("main", f"async@{N}: plain, rdma and all_to_all delivery, same "
        f"{c0} cycles, every leaf equal")


def phase_multi_card() -> None:
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import ring_kernel
    n = torch.cuda.device_count()
    if n < 2:
        say("multi-card", f"not run: {n} card (the exchange across cards "
            "needs two or more)")
        return
    D = min(n, ring_kernel.MAX_SHARDS)
    g = torch.Generator().manual_seed(0)
    obs = [torch.randint(-2**31, 2**31 - 1, (D, 3072, 9), generator=g,
                         dtype=torch.int32).to(f"cuda:{s}")
           for s in range(D)]
    got = ring_kernel.exchange_across(obs)
    want = ring_kernel.plain_exchange_across(obs)
    for d in range(D):
        torch.cuda.synchronize(d)
        if not torch.equal(got[d], want[d]):
            raise SmokeFailure(f"exchange across {D} cards: inbox {d} "
                               "differs from plain")
    say("multi-card", f"exchange across {D} cards (peer access, one launch "
        f"per sender): every inbox equal to the per-pair copies")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA card", flush=True)
        return 1
    try:
        import ue22cs343bb1_openmp_assignment_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port package is not importable here ({e}); "
              "run from the root of the repository", flush=True)
        return 1
    t_all = time.perf_counter()
    try:
        card = smi()
        say("device", f"{card}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
            deep_fold_kernel, deep_round_kernel, sync_burst_kernel,
            sync_multi_round_kernel, sync_round_kernel, sync_window_kernel)
        from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import (
            ring_kernel)
        cfg = bench_cfg(BENCH["num_nodes"])
        phase_build(
            [(deep_fold_kernel.LIBRARY, c)
             for c in (cfg, bench_cfg(256), bench_cfg(65536))]
            + [(deep_round_kernel.LIBRARY, c)
               for c in (bench_cfg(BENCH["num_nodes"], True),
                         contended_cfg(), bench_cfg(65536, True))]
            + [(sync_window_kernel.LIBRARY, c)
               for c in (sync_cfg(BENCH["num_nodes"], 3),
                         sync_contended_cfg(3), sync_cfg(SYNC_BIG, 2))]
            + [(sync_burst_kernel.LIBRARY, c)
               for c in (sync_cfg(BENCH["num_nodes"], 1),
                         sync_contended_cfg(1))]
            + [(sync_round_kernel.LIBRARY, c)
               for c in (sync_cfg(BENCH["num_nodes"], 1),
                         sync_contended_cfg(1),
                         sync_cfg(SYNC_ROUND_BIG, 1))]
            + [(sync_multi_round_kernel.LIBRARY, c)
               for c in (sync_cfg(BENCH["num_nodes"], 3),
                         sync_contended_cfg(3),
                         sync_cfg(SYNC_ROUND_BIG, 3),
                         sync_cfg(SYNC_BIG, 2))]
            # one ring library serves every (D, shape): both are run-time
            # arguments
            + [(ring_kernel.LIBRARY, None)])
        rows, st = phase_kernel_vs_plain(cfg)
        rows["round"] = phase_round_vs_plain(cfg, st)
        phase_card_vs_cpu()
        phase_main_path(rows)
        rows.update(phase_sync_kernels())
        rows["sync_round"] = phase_sync_round_kernel()
        rows["sync_multi_round"] = phase_sync_multi_round_kernel()
        phase_sync_card_vs_cpu()
        phase_sync_main_path(rows)
        phase_ensembles(rows)
        rows["ring"] = phase_ring_kernel()
        phase_async_card_vs_cpu()
        phase_async_main_path(rows)
        phase_multi_card()
    except (SmokeFailure, AssertionError, RuntimeError, ValueError) as e:
        print(f"FAIL: {type(e).__name__}: {e}", flush=True)
        return 1
    say("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [rows[k] for k in FOLD_MODES + ("round",)
                                  + SYNC_KERNELS + ("ring",)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
