#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero):

1. device: nvidia-smi name and power limit, torch and CUDA versions;
2. build: the deep-window fold kernel (csrc/deep_fold.cu) for every
   config used below, one nvcc per config, all started together;
   ptxas registers and spill bytes;
3. kernel vs plain: each fold mode (pre, flags, replay) on inputs taken
   mid-run (after 8 rounds of deep@4096), kernel against the plain
   PyTorch fold on the same tensors, bit for bit; the kernel's device
   time, the plain fold's CUDA-event time, and the bound: bytes moved
   over HBM rate or integer instructions (counted per mode on the
   kernel's SASS, ``cuobjdump``) over the int32 rate;
4. card vs CPU: 64 rounds of a 256-node copy of the bench deep config,
   kernel on the card against the plain folds on the CPU, every state
   leaf and metric equal;
5. main path: ``TransactionalSystem.procedural`` at the bench deep
   defaults (4096 nodes x 4096 instructions, chunk 64) to quiescence
   through the kernel, exact-directory invariant, launch counts > 0;
   then 8 rounds at 65536 nodes with deep_slots=2.

The line before the last is the card's name and power limit as
nvidia-smi reports them; before it, one JSON object with a row per
kernel. The last line is the JSON result. Needs one card, no network
and no JAX.
"""

from __future__ import annotations

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
}
SOURCE = "ue22cs343bb1_openmp_assignment_tpu_torch/csrc/deep_fold.cu"


class SmokeFailure(Exception):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def bench_cfg(num_nodes: int):
    from ue22cs343bb1_openmp_assignment_tpu_torch.bench import deep_config
    return deep_config(num_nodes)


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


def kernel_ms(fn) -> float:
    """Median device time of the deep fold kernel's launches in fn()."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.bench import device_events
    fn()
    events, _ = device_events(fn)
    times = [us for name, us in events if "deep_fold_kernel" in name]
    if not times:
        raise SmokeFailure("the profiler saw no deep_fold_kernel launch")
    return statistics.median(times) / 1e3


# SASS opcodes that do no integer work of the fold: memory, control flow,
# the uniform datapath (prefix U) and register/predicate moves
_NOT_OPS = {"BRA", "BSSY", "BSYNC", "BREAK", "EXIT", "RET", "CALL",
            "WARPSYNC", "BAR", "NOP", "YIELD", "S2R", "CS2R", "MOV", "P2R",
            "R2P", "ATOM", "RED"}
MODE_INDEX = {"pre": 0, "flags": 1, "replay": 2}


def _is_op(opcode: str) -> bool:
    base = opcode.split(".")[0]
    return not (base in _NOT_OPS or base.startswith(("LD", "ST", "U"))
                or opcode.startswith("IMAD.MOV"))


def sass_ops(sass: str, mode: str, steps: int) -> dict:
    """Integer operations per node of the kernel in ``mode``, counted on
    its machine code (``cuobjdump -sass``): the integer instructions
    that every thread executes whatever the data, i.e. outside any
    stretch that a forward branch can jump over, with the instructions
    of the window loop (the one backward branch) counted ``steps``
    times. The compiler has already dropped what the mode's outputs do
    not need, so each mode counts its own work."""
    import re
    ins, cur = [], None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*deep_fold_kernelILi(\d)E", line)
        if m:
            cur = int(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z0-9_.]+)(.*?);", line)
        if m and cur == MODE_INDEX[mode]:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    jumps = []
    for at, op, rest in ins:
        if op.split(".")[0] == "BRA":
            to = int(re.search(r"(0x[0-9a-f]+)\s*$", rest.strip()).group(1),
                     16)
            if to != at:                    # not the trap after EXIT
                jumps.append((at, to))
    back = [(at, to) for at, to in jumps if to < at]
    if not ins or len(back) != 1:
        raise SmokeFailure(f"{mode}: expected one window loop in the "
                           f"kernel's SASS, found {len(back)} backward "
                           f"branches in {len(ins)} instructions")
    hi, lo = back[0]
    fwd = [(at, to) for at, to in jumps if to > at]
    sure = [(at, op) for at, op, _ in ins
            if not any(b < at < to for b, to in fwd)]
    loop = sum(1 for at, op in sure if lo <= at <= hi and _is_op(op))
    once = sum(1 for at, op in sure if not lo <= at <= hi and _is_op(op))
    return dict(per_node=loop * steps + once, per_step=loop, once=once,
                skippable=len(ins) - len(sure), instructions=len(ins))


def kernel_sass(cfg) -> str:
    """``cuobjdump -sass`` of the kernel library built for ``cfg``."""
    import os
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_fold_kernel as dfk)
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    out = subprocess.run([tool if os.path.exists(tool) else "cuobjdump",
                          "-sass", str(dfk.library_path(cfg))],
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


def flat_outputs(d: dict) -> list:
    out = []
    for k in sorted(d):
        v = d[k]
        out += flat_outputs(v) if isinstance(v, dict) else [(k, v)]
    return out


def phase_build(cfgs) -> None:
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_fold_kernel as dfk)
    t0 = time.perf_counter()
    took = dfk.build(cfgs)
    say("build", f"{len(took)} librar{'y' if len(took) == 1 else 'ies'} "
        f"built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{s:.1f} s' for s in took.values())})")
    for cfg in cfgs:
        for mode, info in dfk.ptxas_summary(cfg).items():
            say("build", f"N={cfg.num_nodes} Q={cfg.deep_slots} {mode}: "
                f"{info}")


def phase_kernel_vs_plain(cfg) -> dict:
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_fold_kernel as dfk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    # mid-run inputs, made with the plain folds so that a faulty kernel
    # cannot shape them
    st = se.procedural_state(cfg, BENCH["trace_len"], device="cuda")
    st = se.run_rounds(cfg, st, 8, fold_impl="plain")
    args = fold_inputs(cfg, st)
    sass = kernel_sass(cfg)
    rows = {}
    for mode, wrapper in dfk.WRAPPERS.items():
        plain = dfk.PLAIN[mode]
        a = args[mode]
        k_out = flat_outputs(wrapper(*a))
        p_out = flat_outputs(plain(*a))
        torch.cuda.synchronize()
        if [n for n, _ in k_out] != [n for n, _ in p_out]:
            raise SmokeFailure(f"{mode}: kernel and plain outputs differ "
                               "in their fields")
        err = 0
        for (name, kt), (_, pt) in zip(k_out, p_out):
            if kt.shape != pt.shape or kt.dtype != pt.dtype:
                raise SmokeFailure(f"{mode}.{name}: {kt.dtype} "
                                   f"{tuple(kt.shape)} vs plain {pt.dtype} "
                                   f"{tuple(pt.shape)}")
            diff = (kt.to(torch.int64) - pt.to(torch.int64)).abs()
            e = int(diff.max()) if diff.numel() else 0
            if e:
                bad_at = int((diff != 0).sum())
                raise SmokeFailure(f"{mode}.{name}: kernel differs from "
                                   f"plain at {bad_at} elements (max |d| "
                                   f"{e})")
            err = max(err, e)
        # the kernel's own device time (CUPTI, through torch.profiler):
        # CUDA events around a launch would include the host's launch
        # overhead, which is longer than the kernel
        ms = kernel_ms(lambda: [wrapper(*a) for _ in range(20)])
        plain_ms = event_ms(lambda: plain(*a), 3)
        in_rows, out_rows = dfk.io_rows(cfg, mode)
        io_bytes = 4 * cfg.num_nodes * (in_rows + sum(out_rows))
        count = sass_ops(sass, mode, cfg.drain_depth + cfg.txn_width)
        ops = count["per_node"] * cfg.num_nodes
        t_bytes = io_bytes / HBM_BYTES_PER_S
        t_ops = ops / INT32_OPS_PER_S
        rows[mode] = dict(
            name=f"deep_fold_{mode}", route="cuda", source=SOURCE,
            replaces=TPU_KERNELS[mode], launches=0, max_abs_err=err,
            ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None)
        say("kernel", f"{mode}: bit-identical to plain over "
            f"{len(k_out)} outputs; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms, bound {rows[mode]['bound_ms']:.5f} ms "
            f"({rows[mode]['bound_by']}: {io_bytes} B, {ops} integer ops "
            f"= N x {count['per_node']}: {count})")
    return rows


def phase_card_vs_cpu() -> None:
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    import numpy as np
    cfg = bench_cfg(256)
    t0 = time.perf_counter()
    card = se.run_rounds(cfg, se.procedural_state(
        cfg, BENCH["trace_len"], device="cuda"), 64)
    a = convert.to_numpy(card)
    t1 = time.perf_counter()
    cpu = se.run_rounds(cfg, se.procedural_state(
        cfg, BENCH["trace_len"], device="cpu"), 64)
    b = convert.to_numpy(cpu)
    t2 = time.perf_counter()
    for k in a:
        if not np.array_equal(a[k], b[k]):
            raise SmokeFailure(f"card and CPU differ in leaf {k} after 64 "
                               "rounds at 256 nodes")
    se.check_exact_directory(cfg, card)
    say("card-vs-cpu", f"256 nodes x 64 rounds: {len(a)} leaves equal "
        f"(card {t1 - t0:.1f} s, cpu {t2 - t1:.1f} s, retired "
        f"{int(a['metrics.instrs_retired'])})")


def phase_main_path(rows: dict) -> None:
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional \
        import TransactionalSystem
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_fold_kernel as dfk)
    cfg = bench_cfg(BENCH["num_nodes"])
    length = BENCH["trace_len"]
    sys0 = TransactionalSystem.procedural(cfg, length, device="cuda")
    torch.cuda.synchronize()
    dfk.reset_launch_counts()
    t0 = time.perf_counter()
    done = sys0.run(chunk=BENCH["chunk"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dfk.launch_counts()
    m = done.metrics
    if not done.quiescent:
        raise SmokeFailure("deep@4096 did not reach quiescence")
    if m["instrs_retired"] != cfg.num_nodes * length:
        raise SmokeFailure(f"retired {m['instrs_retired']} of "
                           f"{cfg.num_nodes * length}")
    inv = done.check_invariants()
    for mode, n in counts.items():
        if n <= 0:
            raise SmokeFailure(f"main path launched the {mode} kernel "
                               "no time")
        rows[mode]["launches"] = n
    say("main", f"deep@4096 x {length}: quiescent after {m['rounds']} "
        f"rounds, {m['instrs_retired'] / wall:.6g} instrs/sec, "
        f"{wall * 1e3 / m['rounds']:.4f} ms/round, wall {wall:.2f} s, "
        f"launches {counts}, invariant {inv}")

    big = bench_cfg(65536)
    st = TransactionalSystem.procedural(big, length, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = st.run_rounds(8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    inv = st.check_invariants()
    say("main", f"deep@65536 (deep_slots=2) x 8 rounds: retired "
        f"{st.instrs_retired}, {wall * 1e3 / 8:.3f} ms/round, "
        f"invariant {inv}")


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
        phase_build([cfg, bench_cfg(256), bench_cfg(65536)])
        rows = phase_kernel_vs_plain(cfg)
        phase_card_vs_cpu()
        phase_main_path(rows)
    except (SmokeFailure, AssertionError, RuntimeError, ValueError) as e:
        print(f"FAIL: {type(e).__name__}: {e}", flush=True)
        return 1
    say("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [rows[m] for m in ("pre", "flags",
                                                    "replay")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
