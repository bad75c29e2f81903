#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero):

1. device: nvidia-smi name and power limit, torch and CUDA versions;
2. build: the deep-window fold kernel (csrc/deep_fold.cu) and the fused
   round kernel (csrc/deep_round.cu) for every config used below, one
   nvcc per library, all started together; ptxas registers and spill
   bytes;
3. kernel vs plain: each fold mode (pre, flags, replay) and the round
   kernel on inputs taken mid-run (after 8 rounds of deep@4096), kernel
   against its plain PyTorch version on the same tensors, bit for bit;
   the round kernel also in a contended 256-node config (three
   absorption waves, attempt-based flags). The kernel's device time,
   the plain version's CUDA-event time, and the bound: bytes moved over
   HBM rate or integer instructions (counted on the kernel's SASS,
   ``cuobjdump``) over the int32 rate;
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
   deep_slots=2, equal states.

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
}
CSRC = "ue22cs343bb1_openmp_assignment_tpu_torch/csrc/"
SOURCES = {"pre": CSRC + "deep_fold.cu", "flags": CSRC + "deep_fold.cu",
           "replay": CSRC + "deep_fold.cu", "round": CSRC + "deep_round.cu"}
FOLD_MODES = ("pre", "flags", "replay")


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


def kernel_ms(fn, kernel: str) -> float:
    """Median device time of the launches of ``kernel`` in fn()."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.bench import device_events
    fn()
    events, _ = device_events(fn)
    times = [us for name, us in events if kernel in name]
    if not times:
        raise SmokeFailure(f"the profiler saw no {kernel} launch")
    return statistics.median(times) / 1e3


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
             barriers: int = 0) -> dict:
    """Integer operations per node of the kernel whose mangled name
    matches ``function``, counted on its machine code (``cuobjdump
    -sass``): the integer instructions that every thread runs for a
    node whatever the data.

    - Main code is everything up to the last EXIT; the blocks after it
      run only when a warp diverges at a barrier.
    - Each grid barrier (``barriers`` of them) is the code between a
      pair of BAR.SYNC: the master thread's atomic and spin loop. It is
      left out, as are atomic and fence instructions anywhere.
    - Loops are backward branches. The fold's window loops (``w_loops``
      of them) are the loops nested in another loop (the round kernel's
      node loops), or the kernel's only loop; each counts ``steps``
      times, every other instruction once. The round kernel's loops over
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
    if len(bars) != 2 * barriers:
        raise SmokeFailure(f"{function}: {len(bars)} BAR.SYNC for "
                           f"{barriers} grid barriers")
    fences = list(zip(bars[::2], bars[1::2]))

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
    nested = [lp for lp in loops
              if any(o != lp and o[0] <= lp[0] and lp[1] <= o[1]
                     for o in loops)]
    wl = loops if len(loops) == 1 else nested
    if len(wl) != w_loops:
        raise SmokeFailure(f"{function}: expected {w_loops} window loops, "
                           f"found {len(wl)} among {len(loops)} loops")
    skips = [(at, to) for at, to in jumps if to > at
             and not any(at < lo and hi < to <= hi + 64 for lo, hi in loops)]
    sure = [(at, op) for at, op, _ in ins if not fenced(at)
            and not any(a < at < t for a, t in skips)]
    in_w = [sum(1 for at, op in sure if lo <= at <= hi and _is_op(op))
            for lo, hi in wl]
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


def phase_build(fold_cfgs, round_cfgs) -> None:
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_fold_kernel as dfk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_round_kernel as drk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import kernel_build
    jobs = ([(dfk.LIBRARY, c) for c in fold_cfgs]
            + [(drk.LIBRARY, c) for c in round_cfgs])
    t0 = time.perf_counter()
    took = kernel_build.build(jobs)
    say("build", f"{len(took)} librar{'y' if len(took) == 1 else 'ies'} "
        f"built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k[0]} {s:.1f} s' for k, s in took.items())})")
    for lib, cfg in jobs:
        for kernel, info in lib.ptxas_summary(cfg).items():
            say("build", f"N={cfg.num_nodes} Q={cfg.deep_slots} "
                f"waves={cfg.deep_waves} exact={cfg.deep_exact_flags} "
                f"{kernel}: {info}")


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
        in_rows, out_rows = dfk.io_rows(cfg, mode)
        io_bytes = 4 * cfg.num_nodes * (in_rows + sum(out_rows))
        count = sass_ops(sass, rf"deep_fold_kernelILi{FOLD_MODES.index(mode)}E",
                         cfg.drain_depth + cfg.txn_width, 1)
        ops = count["per_node"] * cfg.num_nodes
        rows[mode] = row(f"deep_fold_{mode}", mode, ms, plain_ms, io_bytes,
                         ops)
        say("kernel", f"{mode}: bit-identical to plain over "
            f"{len(k_out)} outputs; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms, bound {rows[mode]['bound_ms']:.5f} ms "
            f"({rows[mode]['bound_by']}: {io_bytes} B, {ops} integer ops "
            f"= N x {count['per_node']}: {count})")
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
    io_bytes = sum(drk.io_contract_bytes(cfg))
    barriers = 6 + 2 * (cfg.deep_waves - 1)
    count = sass_ops(kernel_sass(drk.LIBRARY, cfg), r"deep_round_kernel",
                     cfg.drain_depth + cfg.txn_width,
                     2 + int(cfg.deep_exact_flags), barriers)
    ops = count["per_node"] * cfg.num_nodes
    r = row("deep_round", "round", ms, plain_ms, io_bytes, ops)
    grid = drk.LIBRARY.load(cfg).deep_round_grid(cfg.num_nodes)
    say("kernel", f"round: bit-identical to plain_round over {len(k_out)} "
        f"outputs at deep@4096 and in the contended 256-node config "
        f"(waves 3, attempt flags); kernel {ms:.4f} ms ({grid} blocks of "
        f"128), plain {plain_ms:.2f} ms, bound {r['bound_ms']:.5f} ms "
        f"({r['bound_by']}: {io_bytes} B, {ops} integer ops = N x "
        f"{count['per_node']}: {count})")
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


def _drive(cfg, run):
    """Run ``run(system)`` from a fresh machine with every launch count
    set to 0 just before and read just after; (result, seconds,
    counts)."""
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional \
        import TransactionalSystem
    sys0 = TransactionalSystem.procedural(cfg, BENCH["trace_len"],
                                          device="cuda")
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
        cfg = bench_cfg(BENCH["num_nodes"])
        phase_build([cfg, bench_cfg(256), bench_cfg(65536)],
                    [bench_cfg(BENCH["num_nodes"], True), contended_cfg(),
                     bench_cfg(65536, True)])
        rows, st = phase_kernel_vs_plain(cfg)
        rows["round"] = phase_round_vs_plain(cfg, st)
        phase_card_vs_cpu()
        phase_main_path(rows)
    except (SmokeFailure, AssertionError, RuntimeError, ValueError) as e:
        print(f"FAIL: {type(e).__name__}: {e}", flush=True)
        return 1
    say("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [rows[k] for k in FOLD_MODES + ("round",)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
