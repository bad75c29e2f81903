#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero):

1. device: nvidia-smi name and power limit, torch and CUDA versions;
2. build: the deep-window fold kernel (csrc/deep_fold.cu), the fused
   round kernel (csrc/deep_round.cu), the sync window engine's
   window/replay and burst kernels (csrc/sync_window.cu,
   csrc/sync_burst.cu) and its fused txn_width 1 and txn_width >= 2
   rounds (csrc/sync_round.cu, csrc/sync_multi_round.cu), the ring
   exchange and the threefry block of the jax.random twin
   (csrc/threefry.cu) for every config used below, one nvcc per library,
   all started together; ptxas registers and spill bytes;
3. random (slice 9): the threefry kernel against its plain version
   (``utils.random.plain_block``) bit for bit at 1, 2, 31, 4097 and
   4096 x 4096 counters under keys of seeds 0, 1, 2^31 + 5 and a chain
   of splits, draws and key pairs, with its device time, bound, plain
   time and ptxas figures; the card against the JAX package's draws
   pinned in RANDOM_REFERENCE (every generator at 256 nodes x 512, seed
   3; uniform at 4096 x 512, seed 0; a fault-injected async run at 64
   nodes, drop_prob 0.05, to its cap of 1024 cycles); card against CPU:
   a fault-injected async run at 256 nodes (every leaf, fault_key
   included, and injected drops > 0) and a stored-trace sync ensemble as
   ``bench --replicas 4`` builds it (256 nodes x 64); checkpoints on
   the card (deep@4096 fused over 16 rounds, sync@4096 K=1 and K=3 over
   8 rounds, async@4096 uniform with fault injection over 64 cycles):
   saved half way, loaded and continued, equal to the uninterrupted
   run, and loaded on the CPU with equal leaves;
4. kernel vs plain: each fold mode (pre, flags, replay) and the round
   kernel on inputs taken mid-run (after 8 rounds of deep@4096), kernel
   against its plain PyTorch version on the same tensors, bit for bit;
   the round kernel also in a contended 256-node config (three
   absorption waves, attempt-based flags). The kernel's device time,
   the plain version's CUDA-event time, and the bound: bytes moved over
   HBM rate or integer operations over the int32 rate (the integer
   instructions of the kernel's SASS, counted with ``cuobjdump``; for
   the deep rows capped by the recorded work of DEEP_WORK_PER_NODE,
   both printed);
5. card vs CPU: 64 rounds of a 256-node copy of the bench deep config
   on the card through the fold kernels and through the round kernel,
   each against the plain round on the CPU, every state leaf and metric
   equal;
6. main paths: ``TransactionalSystem.procedural`` at the bench deep
   defaults (4096 nodes x 4096 instructions, chunk 64) to quiescence
   through the fold kernels (``fused_round`` off), then through the
   round kernel (``fused_round`` on, the bench's default on a card),
   each with the launch counts set to 0 just before and read just
   after: every kernel of the path launched, none of the other path's;
   equal round counts and equal final states, exact-directory
   invariant; then 8 rounds of each path at 65536 nodes with
   deep_slots=2, equal states;
7. the sync window engine, the same way: the window, replay and burst
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
   defaults (4096 nodes x 4096 instructions, chunk 64), at txn_width 3 on
   three routes, the fused round to quiescence (sync_multi_round ==
   rounds, window and replay 0, every instruction retired), and for
   SYNC_ROUTE_ROUNDS rounds the window kernels around the eager round
   middle (window == replay == rounds) and the plain rounds, and at
   txn_width 1 on three routes, the fused round to quiescence
   (sync_round == rounds, sync_burst 0), and for SYNC_ROUTE_ROUNDS rounds
   the burst kernel inside the eager round (sync_burst == rounds) and the
   plain rounds, each with a torch.profiler window (device launches, busy
   ms and idle share a round): the fused round's final state equal to
   the plain rounds' at quiescence (SYNC_REFERENCE), the cut routes
   equal to the fused round after as many rounds; 4 rounds
   at 1048576 nodes (txn_width 2) through the fused round against the
   plain rounds; 8 rounds of the 4096-node txn_width 3 machine on stored
   traces made from a seed, card against CPU;
8. seed ensembles (slice 8): at the sync bench defaults (txn_width 3 /
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
9. the message-level engine (async) and its routed delivery: the ring
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
   through plain ``mailbox.deliver`` (every instruction retired, no
   drops, the final state equal to the JAX package's: its digest and
   invariant counts, recorded by scripts/async_reference.py; the
   workload is racy, so both invariant tiers have counts there, the same
   on both sides), routed through the ring kernel at D = 4 to
   quiescence (the same final state, ring launches == cycles), and for
   ASYNC["route_cycles"] cycles through all_to_all at D = 4, equal to
   plain delivery after as many cycles (no kernel launched); the JAX
   bench's default
   async workload, ``uniform`` (drawn through the threefry kernel, equal
   to the JAX package's draw), to quiescence, and with fault injection
   (drop_prob 0.01) for 512 cycles: ms/cycle, threefry launches (two a
   cycle with faults, none without), a torch.profiler window of device
   launches a cycle; and, with two or more cards, one exchange across
   real cards against its plain version;
10. the port's CLI (``cli.main`` in this process, no ``--cpu``): the
   bench's cells at full width (sync@4096 x 4096 at txn_width 3 /
   drain_depth 4 and txn_width 1 / drain_depth 16, deep@4096 x 4096 at
   deep_slots 3, async@4096 x 128 ``uniform`` at queue capacity 64),
   each with --check --metrics: the check's exit and line equal to the
   library's check of the same config run through the library in this
   process (where the async engine's engine tier trips on the racy
   traffic, exit 3 in the JAX package too, that run is made again without
   --check), every document valid, equal to the library run's, every
   instruction retired, sync_multi_round / sync_round / round launched
   once a round and threefry on the async run; the same runs at 256
   nodes x 64 with --dump on the card and with --cpu, dumps, stdout and
   stderr equal, and a deep run with --trace-log there (logs equal, the
   fold modes launched on the card); tests/fixtures/mini on the async,
   sync and native engines, card against --cpu; each run's wall seconds
   beside the card's name and power limit;
11. the observability captures and verbs (``obs``, slice 11; sizes in
   OBS), through ``cli.main``: ``stats --timeseries --phases`` of
   async@4096 x 512 ``uniform`` over its first 256 cycles (telemetry
   totals equal to the run's metrics, the plain and telemetry runs'
   walls) and ``profile`` over the same cycles (reads and writes equal
   to the run's, peak device memory); ``profile --engine sync`` at 4096
   x 4096 K=3 over 64 rounds (accesses equal to the retired count of
   the same rounds through the library); ``profile --engine deep`` at
   its cap of 2048 nodes over 8 rounds (the plain folds: no fold or
   round kernel launches, threefry its 12; the abort anatomy against
   the rounds' conflicts and retired counts); every verb (stats on
   three engines, trace, txns, critical-path, profile on three engines)
   and ``--check --flight-dir`` (the ``invariant:check`` incident of the
   tripped engine tier) at 256 nodes x 64, the card against --cpu:
   exit codes, stdout (``extra.phases`` by its names and counts),
   stderr and files equal. The --cpu runs and the two 4096 profiles
   run in child processes beside the card runs of this process; the
   phase prints its time;
12. serving (``serve``, slice 12; sizes in SERVE): 16 jobs of
   ``serve.mixed_jobs`` at 32 nodes x 32 through 8 slots, chunk 32, on
   the card under a VirtualClock: every leaf of every extracted job
   equal to the job run alone on the card (``exact_solo``, in child
   processes), the serve doc and the ``--out-dir`` files equal to the
   same run with --cpu (a child process), byte for byte; a mid-wave
   ``set_state`` swap leaves the neighbours' leaves equal to an
   unswapped batch's; the serving run through the port's bench (``bench
   --serve``: the JAX mix and queue rule, 256 jobs through 256 slots,
   one warm pass and one timed pass, a torch.profiler window of wave
   cycles beside solo cycles): jobs/sec, waves, padding_waste, ms and
   device launches a wave cycle, threefry launches (the warm pass draws
   the traces, the timed passes reuse them: 0), peak device memory,
   every job's digest equal to SERVE_REFERENCE (the JAX package's serve
   on the CPU); the same figures for one slot over the mix's first four
   jobs (``--serve-no-warm``: the run drew their traces); the daemon (``cache-sim-torch daemon`` in
   a child process on a unix socket, both lanes) under an open-loop
   ``soak_daemon`` stream of two job shapes: every result's digest equal
   to SERVE_REFERENCE, ``stats`` and ``top`` documents valid, the
   client-observed p50/p95/p99, rejections and bucket growths, drained
   and shut down;
13. history (slice 13; sizes in HISTORY): ``bench --reps 3 --record H``
   twice at deep@4096 (the round kernel), both entries valid with one
   fingerprint and equal instrs_retired, ``bench-diff --history H
   --against-last`` exit 0 or 4 with its verdict and medians;
   ``bench --read-storm`` (the fold kernels: the fused round refuses
   the storm) and 16 library rounds of its config with the kernel folds
   against the plain folds, every leaf; 16 arrivals of
   ``serve.mixed_jobs`` at 32 x 32 through 8 slots recorded on the card
   by a DaemonCore with a RecordingWriter on a VirtualClock (a child
   process), replayed in process on the card (``cache-sim-torch
   replay``: every digest matched, threefry launched) and with
   ``--cpu`` (a child process): equal replay documents; ``bench-diff
   --latency`` of the recorded against the replayed entry exit 0 or 4;
   ``state.continue_with_traces`` on the async engine at 256 x 64, two
   phases, every leaf equal to the CPU's (a child process).
14. report (slice 14; sizes in REPORT), in a child interpreter:
   ``perf-report --engine deep`` at 4096 x 4096 on the card twice (the
   fold kernels; byte-identical documents, the per-step dispatch record
   launching one of each fold mode), at 256 x 256 on the card and with
   ``--cpu`` (a child process; steps, retired and config equal, each
   side's per-step ops and bytes printed), then ``--pallas --timing`` at
   4096 (one deep_round launch a step, the io-contract row equal to the
   wrapper's contract, measured/model); ``perf-report --engine async``
   at 4096 x 512 ``--shards 4`` (the transport row; a child process on
   the card beside the deep reports, all host-bound); each per-step
   record's aten ops beside the device launches a torch.profiler window
   of the same route counts; ``bench`` at deep@4096 with
   ``--kernel-costs --timer-check --profile-dir --record`` twice (a
   trustworthy barrier, a trace naming deep_round_kernel, equal cost
   vectors, ``bench-diff --bytes`` exit 0); ``dashboard`` over that
   history and the archives (the card's point in the roofline scatter;
   the archives alone render tests/golden/dashboard.* byte for byte).
15. analyze (slice 15; sizes in ANALYZE): ``cache-sim-torch analyze
   --table --litmus --json`` in this process on the card (the model
   checker over the six builtin scopes, verify_table over the three
   tables and conformance on 2n2h, the whole MESI litmus suite with
   iriw, the trace lint): exit 0, the model_check, table and litmus
   blocks' sha256 equal to the JAX package's (ANALYZE_REFERENCE, from
   scripts/analyze_reference.py), no port kernel launched, each prong's
   wall seconds and oracle batches; each handler mutation,
   ``table_guard_overlap`` and ``stale_fill_from_invalid`` exit 1 with
   the JAX package's finding; an oracle batch of the MESI handlers and
   of the MOESI table phase under a torch.profiler window (device
   launches, busy ms, idle share); 16 jobs of ``serve.mixed_jobs`` at 16
   x 16 under moesi and under mesif served on the card, every job's
   digest equal to ANALYZE_REFERENCE, threefry launched.
16. fuzz (slice 16; sizes in FUZZ), in a child process started just
   before the history phase and running beside the history and report
   phases' children and the analyze phase (all host-bound):
   ``cache-sim-torch analyze --skip-model-check --skip-lint --fuzz 16
   --seed 0 --json`` in that process on the card, clean (exit 0) and under
   ``--mutation stale_owner_forward --repro-dir R --flight-dir F``
   (exit 1): the ``fuzz`` blocks' sha256 and the sha256 of every file
   under R and F equal to the JAX package's (FUZZ_REFERENCE, from
   ``scripts/analyze_reference.py --fuzz``), no port kernel launched;
   ``replay`` of the first repro and the first incident gives the JAX
   verb's exit code and verdict line, and ``fixtures.replay`` of the
   repro under the mutation reproduces it; the cycle rate of the async
   runs and a cycle's device launches under a torch.profiler window.

17. walkers (slice 17; sizes in WALKERS), in a child process started
   beside the fuzz child: ``cache-sim-torch analyze --skip-model-check
   --skip-lint --jaxpr --kernel --index --json`` on the card (exit 0;
   the fused round at the claim key's extremes bit-identical to the
   plain round; the deep round's derived shared memory equal to
   ``deep_round_smem_bytes()``; each cooperative kernel's derived grid
   equal to the runtime's; a second load of every library without
   nvcc) and with ``--cpu`` in a child of it (exit 0; the index
   inventory of every target that launched no kernel equal to the
   card's); ``--kernel --mutation`` widen_min_chunk, narrow_ladder_gap,
   lift_storm_gate and ``--index --mutation split_packed_scatter`` exit
   1, each killed with its finding kind; the prongs' seconds, each
   target's aten ops and index sites, indices per instruction and each
   kernel's registers, spills, shared memory and blocks a
   multiprocessor; the phase's time against its 40 s budget.

Each phase's seconds are printed after the last phase.
``python3 chip_smoke.py --serve-run 1024`` runs only the serving run,
at the JAX ``--serve`` mix's 1024 jobs and the median of 3.

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
    # no TPU kernel: on a TPU jax.random lowers to XLA's threefry2x32
    "threefry": "none (XLA's threefry2x32)",
}
CSRC = "ue22cs343bb1_openmp_assignment_tpu_torch/csrc/"
SOURCES = {"pre": CSRC + "deep_fold.cu", "flags": CSRC + "deep_fold.cu",
           "replay": CSRC + "deep_fold.cu", "round": CSRC + "deep_round.cu",
           "sync_window": CSRC + "sync_window.cu",
           "sync_replay": CSRC + "sync_window.cu",
           "sync_burst": CSRC + "sync_burst.cu",
           "sync_round": CSRC + "sync_round.cu",
           "sync_multi_round": CSRC + "sync_multi_round.cu",
           "ring": CSRC + "ring_exchange.cu",
           "threefry": CSRC + "threefry.cu"}
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
             block_barriers: int = 0, pipe: str = "") -> dict:
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
    - ``pipe`` "fma" counts only the IMAD family, which issues to the
      FMA pipe, "alu" only the other integer instructions (the integer
      pipe), "alu_only" those of them that no IMAD could stand in for
      (all but the IADD family); "" counts them all.
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
    def counted(op):
        if not _is_op(op):
            return False
        if pipe == "fma":
            return op.startswith("IMAD")
        if pipe == "alu":
            return not op.startswith("IMAD")
        if pipe == "alu_only":
            return not op.startswith(("IMAD", "IADD"))
        return True

    in_w = [sum(1 for at, op in ([(at, op) for at, op, _ in ins]
                                 if every_path else sure)
                if lo <= at <= hi and counted(op)) for lo, hi in wl]
    once = sum(1 for at, op in sure if counted(op)
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


#: the profiler window of a fused sync route, long enough that the kernel
#: events the profiler misses near a window's edges do not matter (32
#: rounds of the fused txn_width 1 route, about 6 ms under the profiler,
#: showed about 0.7 of its one launch a round on an H100); the eager and
#: plain routes' rounds take milliseconds each, and their hundreds to
#: thousands of launches a round make a long window slow to read back, so
#: theirs is shorter
PROFILE_ROUNDS = {"fused round": 128, "other": 16}

#: the depth of the two sync routes held to the fused round: the eager
#: round around the TPU kernels' counterparts and the plain rounds run
#: this many rounds (cut from quiescence, 1600 rounds at txn_width 3 and
#: 3776 at txn_width 1, for the serve phase's time, and from 200 for the
#: report phase's) and end equal to the fused round after as many rounds
SYNC_ROUTE_ROUNDS = 100
#: the plain rounds' final state at quiescence of each txn_width's run
#: (sync@4096 x 4096, chunk 64), as printed by ``scripts/sync_reference.py``
#: (defaults) on an H100: rounds, retired instructions and
#: ``convert.leaves_digest`` of the leaves. The fused round's run to
#: quiescence must end there. The script's plain rounds are held to the
#: JAX package by tests/test_torch_sync_reference.py at 64 nodes.
SYNC_REFERENCE = {
    3: {"rounds": 1600, "instrs_retired": 16777216,
        "digest": ("027873e473b750f981a2612fc2855950"
                   "7992a1c275d70954e2a1aafe85daa2a3")},
    1: {"rounds": 3776, "instrs_retired": 16777216,
        "digest": ("b5685de82e32e64f75ec0c71f7547172"
                   "1e85a3aac8da878544c9e4af655f3cad")},
}


def _fixed_route(step, rounds: int):
    """``run`` for ``_drive``: ``step`` round after round, ``rounds``
    rounds, no host read."""
    def run(sys0):
        st = sys0.state
        for _ in range(rounds):
            st = step(st)
        return dataclasses.replace(sys0, state=st)
    return run


def _sync_routes(rows: dict, txn_width: int) -> None:
    """sync@4096 x 4096 on three routes, in one process: the fused round
    (one kernel a round, the bench's route on a card) to quiescence, and
    for SYNC_ROUTE_ROUNDS rounds the eager round around the TPU kernels'
    counterparts (at txn_width 1 the burst kernel,
    ``_round_step_single(use_kernel=True)``; else the window and replay
    kernels, ``round_step_multi_kernel``) and the plain rounds, each
    equal to the fused round after as many rounds. Each run's launch
    counts are set to 0 just before it and read just after, and give its
    kernels' rows their launches; each route's torch.profiler window
    (PROFILE_ROUNDS, 16 rounds in) gives its device launches, busy ms and
    idle share a round, and how many launches of the route's kernels the
    profiler saw."""
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
    R = SYNC_ROUTE_ROUNDS
    routes = {
        "fused round": (fused, lambda s: s.run(chunk=BENCH["chunk"]),
                        lambda st: se.round_step(fused, st),
                        ("sync_round" if K == 1 else "sync_multi_round",)),
        eager: (fused, _fixed_route(eager_step, R), eager_step,
                eager_kernels),
        "plain rounds": (plain, lambda s: s.run_rounds(R),
                         lambda st: se.round_step(plain, st), ())}
    mid = se.run_rounds(plain, se.procedural_state(plain, length,
                                                   device="cuda"), 16)
    finals = {}
    for route, (cfg, run, step, mine) in routes.items():
        done, wall, counts = _drive(cfg, run)
        m = done.metrics
        if route == "fused round" and not done.quiescent:
            raise SmokeFailure(f"sync@{N} txn_width {K} ({route}) did not "
                               "reach quiescence")
        if route == "fused round" and m["instrs_retired"] != N * length:
            raise SmokeFailure(f"retired {m['instrs_retired']} of "
                               f"{N * length}")
        if route != "fused round" and m["rounds"] != R:
            raise SmokeFailure(f"sync txn_width {K} ({route}): "
                               f"{m['rounds']} rounds, want {R}")
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
        finals[route] = (m["rounds"], convert.to_numpy(done.state))
        if route == "fused round":
            got = {"rounds": m["rounds"],
                   "instrs_retired": m["instrs_retired"],
                   "digest": convert.leaves_digest(finals[route][1])}
            if got != SYNC_REFERENCE[K]:
                raise SmokeFailure(f"sync@{N} txn_width {K} ({route}): "
                                   f"{got} at quiescence, the plain rounds' "
                                   f"{SYNC_REFERENCE[K]}")
        rounds = PROFILE_ROUNDS.get(route, PROFILE_ROUNDS["other"])
        prof = bench.profile_steps(step, mid, rounds)
        seen = "".join(
            f" ({prof['kernel_calls_per_round'].get(k, 0) * rounds:.0f}"
            f" of the {k} kernel seen)" for k in mine)
        say("main", f"sync@{N} x {length}, txn_width {K}, drain_depth "
            f"{cfg.drain_depth}, through the {route}: "
            f"{'quiescent after' if route == 'fused round' else 'cut at'} "
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
    r0 = finals["fused round"][0]
    cut, _, _ = _drive(fused, lambda s: s.run_rounds(R))
    a = convert.to_numpy(cut.state)
    for route in (eager, "plain rounds"):
        r1, b = finals[route]
        bad = _leaves_differ(a, b)
        if bad:
            raise SmokeFailure(f"sync txn_width {K}: the fused round and "
                               f"the {route} after {r1} rounds differ "
                               f"(leaf {bad})")
    say("main", f"sync txn_width {K}: the fused round quiescent after "
        f"{r0} rounds, its final state the plain rounds' at quiescence "
        f"(SYNC_REFERENCE, digest {SYNC_REFERENCE[K]['digest'][:16]}); the "
        f"{eager} and the plain rounds after {R} rounds equal to the fused "
        f"round's {R}, every leaf")


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
#: instructions a node for time (the bench runs 4096); the all_to_all
#: route runs ``route_cycles`` cycles (cut from quiescence for time,
#: and from 512 for the report phase's)
ASYNC = dict(num_nodes=4096, trace_len=512, chunk=64, shards=4,
             route_cycles=256)
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


#: The JAX package's draws that the card must reproduce (``random``
#: phase), held to the JAX package by tests/test_torch_workloads.py and
#: tests/test_torch_faults.py: ``workload_digest`` of every generator's
#: four arrays at 256 nodes x 512 (``SystemConfig.scale``, seed 3) and of
#: ``uniform`` at 4096 nodes x 512 (seed 0); and the run of the
#: ``uniform`` workload (seed 0) at 64 nodes with drop_prob 0.05 to a cap
#: of 1024 cycles (dropped messages strand requesters: it never
#: quiesces): counters, ``convert.leaves_digest`` of its leaves and the
#: sha256 of its joined dumps.
RANDOM_REFERENCE = {
    "generators": {
        "false_sharing": "b267e17e9f48c037ea752450310e3b80"
                         "77400b7c885e244ba8469977d05c83d0",
        "false_sharing_vars": "b864e3624bffa55bc8032a3a5c6ca898"
                              "fee28067ea5ae85fca307f6dfef6fa07",
        "false_sharing_vars_padded": "144bef356153ad73ce7d4ef0f38efad3"
                                     "051ed125f6f3b5ab64116b68d18576ad",
        "fft": "2937ace95aee65e24b8642bfb4d2658a"
               "271a4685e4b9af1809567ebf1724b4c7",
        "hotspot": "4d946328447151ab9873d8125a621138"
                   "c55cc8317c85ea3bc337b56b44a974fe",
        "lu": "6751d3b7d959409b30a6c783df756cbb"
              "7039cdcf4d148916f492c84844967eb1",
        "procedural_uniform": "f2661add0870d05f2e8331aa6f3e4ed9"
                              "e6950063b607b0ead95ad8925c157c6f",
        "producer_consumer": "0652af83bddb09624fdbfcc82eff57c4"
                             "968ce875ceb97c7ca15684f36cdcdeee",
        "radix": "bcb1978d656da292a9352911573d7fad"
                 "cb69f85b20544a06816e88527018d6f9",
        "uniform": "c00a7136480dc218bc5ddd850dbc7614"
                   "9516518bc5acf41a12b02d626c70bd69",
        "zipf_hotspot": "c64d360f9348dc36c3f24c5d51cf50db"
                        "d67070f2197e5793d83dc1239c31e0d6",
    },
    "uniform_4096": ("4bd359131c477ec834d8b1ff25c44bc1"
                     "8dba790abb13925ec2aead652dc49ea4"),
    "faults": {
        "cycles": 1024, "instrs_retired": 831, "msgs_injected_dropped": 93,
        "digest": ("22c9e98483ef0b2eae89858fd64f72c9"
                   "06f91a7acde998ea1c27cf21e608de32"),
        "dumps": ("eae08fc1ebd60b253de3d830f43509a6"
                  "5a1240eef56e6c432c330dce55ec162e"),
    },
}


def workload_digest(arrays) -> str:
    """``convert.leaves_digest`` of a generator's (op, addr, val, count),
    numpy arrays or tensors on any device."""
    import numpy as np
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    return convert.leaves_digest({
        k: np.asarray(a.cpu() if hasattr(a, "cpu") else a)
        for k, a in zip(("op", "addr", "val", "count"), arrays)})


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
    """async@4096 x 512 through plain delivery and through the ring
    kernel at D = 4 to quiescence, each equal to the JAX package's run
    (ASYNC_REFERENCE); all_to_all at D = 4 for ASYNC["route_cycles"]
    cycles (cut from quiescence for time), equal to plain delivery after
    as many cycles."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import invariants
    N, length, D = ASYNC["num_nodes"], ASYNC["trace_len"], ASYNC["shards"]
    C = ASYNC["route_cycles"]
    cfg = async_cfg(N, length)
    for shards, transport in ((1, "none"), (D, "rdma"), (D, "all_to_all")):
        cut = transport == "all_to_all"
        done, wall, counts = _async_run(
            cfg, async_system(cfg, "cuda"), shards,
            transport if shards > 1 else "rdma", ASYNC["chunk"],
            C if cut else 200 * length)
        m = done.metrics
        route = ("plain mailbox.deliver" if shards == 1 else
                 f"routed {transport} at D={shards}")
        want_ring = m["cycles"] if transport == "rdma" else 0
        for kernel, n in counts.items():
            if n != (want_ring if kernel == "ring" else 0):
                raise SmokeFailure(f"async@{N} ({route}): {n} launches of "
                                   f"the {kernel} kernel in {m['cycles']} "
                                   "cycles")
        if transport == "rdma":
            rows["ring"]["launches"] = counts["ring"]
        if cut:
            if m["cycles"] != C:
                raise SmokeFailure(f"async@{N} ({route}): {m['cycles']} "
                                   f"cycles, want {C}")
            routed = convert.sim_numpy_leaves(done.state)
            say("main", f"async@{N} x {length}, chunk {ASYNC['chunk']}, "
                f"through {route}: cut at {m['cycles']} cycles, "
                f"{wall * 1e3 / m['cycles']:.4f} ms/cycle, wall "
                f"{wall:.2f} s, ring launches {counts['ring']}, retired "
                f"{m['instrs_retired']}, dropped {m['msgs_dropped']}")
            continue
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
        say("main", f"async@{N} x {length} (trace cut from the bench's "
            f"4096 for time), queue capacity {cfg.queue_capacity}, scatter "
            f"INV, chunk {ASYNC['chunk']}, through {route}: quiescent after "
            f"{m['cycles']} cycles, {m['instrs_retired'] / wall:.6g} "
            f"instrs/sec, {wall * 1e3 / m['cycles']:.4f} ms/cycle, wall "
            f"{wall:.2f} s, ring launches {counts['ring']}, dropped "
            f"{m['msgs_dropped']}; final state equal to the JAX package's "
            f"(digest {digest[:16]}, invariant counts {step_v} and "
            f"{coherence}: the racy workload's, as in JAX)")
    plain, _, _ = _async_run(cfg, async_system(cfg, "cuda"), 1, "rdma",
                             ASYNC["chunk"], C)
    bad = _leaves_differ(convert.sim_numpy_leaves(plain.state), routed)
    if bad:
        raise SmokeFailure(f"async@{N}: all_to_all and plain delivery "
                           f"after {C} cycles differ (leaf {bad})")
    say("main", f"async@{N}: all_to_all delivery after {C} cycles equal to "
        f"plain delivery's {C}, every leaf")


# -- the threefry twin of jax.random (slice 9) -------------------------------

#: counts of the kernel-vs-plain check: a lone counter, a split's two,
#: the generators' 5-way split, an odd count, a grid's tail block, and the
#: uniform workload's draw at the bench size (4096 nodes x 4096
#: instructions); the fault draw of one async@4096 cycle joins them
THREEFRY_COUNTS = (1, 2, 5, 31, 4097, 4096 * 4096)
#: the async main path with fault injection: its rate, and the cycles it
#: runs (it never quiesces: dropped messages strand requesters)
FAULTS = dict(drop_prob=0.01, cycles=512, profile_cycles=32)


def threefry_keys(device):
    """Keys of seeds 0, 1 and 2^31 + 5, and one from a chain of splits."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.utils import random as jr
    keys = [jr.prng_key(s, device) for s in (0, 1, 2**31 + 5)]
    keys.append(jr.split(jr.split(keys[2], 3)[1], 5)[4])
    return keys


def _threefry_kernel_vs_plain() -> dict:
    """The kernel against its plain version, bit for bit, at every count
    of THREEFRY_COUNTS, the fault draw of one async@4096 cycle, and every
    key of ``threefry_keys``, draws and key pairs; its time, bound and
    ptxas figures at the largest count; returns its row."""
    import re
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        threefry_kernel as tk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.utils import random as jr
    keys = threefry_keys("cuda")
    fault_n = ASYNC["num_nodes"] * async_cfg(ASYNC["num_nodes"],
                                             ASYNC["trace_len"]).out_slots
    counts = sorted(THREEFRY_COUNTS + (fault_n,))
    for n in counts:
        for key in keys:
            for pair in (False, True):
                compare(f"threefry n={n} pair={pair}",
                        [("out", tk.block(key, n, pair))],
                        [("out", jr.plain_block(key, n, pair))])
    n = THREEFRY_COUNTS[-1]
    key = keys[0]
    ms = kernel_ms(lambda: [tk.block(key, n) for _ in range(20)],
                   "threefry_kernel")
    small = {c: kernel_ms(lambda c=c: [tk.block(key, c) for _ in range(20)],
                          "threefry_kernel") for c in (2, fault_n)}
    plain_ms = event_ms(lambda: jr.plain_block(key, n), 3)
    # Two pipes of 64 lanes an SM issue integer instructions: the IMAD
    # family the FMA pipe, the rest the integer pipe. An add may issue
    # as an IMAD, so the function's floor is the larger of the
    # instructions that need the integer pipe (rotates, xors) over one
    # pipe and all integer instructions over both, in integer-pipe
    # issue slots. This SASS's own split (alu, fma) explains the time.
    sass = kernel_sass(tk.LIBRARY, None)
    threads = tk.LIBRARY.load(None).threefry_grid(n) * 256
    count = {}
    for pipe in ("", "alu_only", "alu", "fma"):
        c = sass_ops(sass, r"threefry_kernelILb0E", 1, 1, pipe=pipe)
        count[pipe or "all"] = (sum(c["per_step"]), c["once"])
    total = {p: n * a + threads * b for p, (a, b) in count.items()}
    ops = max(total["alu_only"], -(-total["all"] // 2))
    sass_bound_ms = max(total["alu"], total["fma"]) / INT32_OPS_PER_S * 1e3
    io_bytes = sum(tk.io_contract_bytes(n))
    r = dict(row("threefry", "threefry", ms, plain_ms, io_bytes, ops))
    ptxas = tk.LIBRARY.ptxas_summary(None)
    _, log = tk.LIBRARY.paths(())
    smem = sorted(set(re.findall(r"(\d+) bytes smem", log.read_text())))
    if not ptxas:
        raise SmokeFailure("threefry: no ptxas report from the build")
    say("random", f"threefry: kernel equal to plain word for word at "
        f"counts {counts} x {len(keys)} keys, draws and key "
        f"pairs; at {n} counters kernel {ms:.4f} ms, plain {plain_ms:.2f} "
        f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}: {io_bytes} B, "
        f"{ops} integer-pipe issue slots = max(integer-pipe-only "
        f"{total['alu_only']}, all {total['all']} / 2); (a counter, a "
        f"thread) by class {count}, {threads} threads); this SASS's bound "
        f"(its busier pipe) {sass_bound_ms:.5f} ms; at 2 counters "
        f"{small[2]:.4f} ms, at {fault_n} (one async@4096 cycle's fault "
        f"draw) {small[fault_n]:.4f} ms; ptxas {ptxas}, shared memory "
        f"{smem or ['0']} B; library call: none (torch's Philox is a "
        "different stream)")
    return r


def _card_matches_jax_draws() -> None:
    """The card reproduces the JAX package's draws (RANDOM_REFERENCE):
    every generator at 256 nodes x 512 (seed 3), uniform at 4096 x 512
    (seed 0), and the fault-injected run at 64 nodes."""
    import hashlib
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu_torch.models import workloads
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    ref = RANDOM_REFERENCE
    cfg = SystemConfig.scale(num_nodes=256)
    got = {name: workload_digest(gen(3, cfg, 512, device="cuda"))
           for name, gen in workloads.GENERATORS.items()}
    bad = sorted(k for k in got if got[k] != ref["generators"].get(k))
    if bad or set(got) != set(ref["generators"]):
        raise SmokeFailure(f"generators on the card differ from the JAX "
                           f"package's draws: {bad}")
    big = workload_digest(workloads.uniform_random(
        0, SystemConfig.scale(num_nodes=4096), 512, device="cuda"))
    if big != ref["uniform_4096"]:
        raise SmokeFailure("uniform at 4096 x 512 on the card differs from "
                           "the JAX package's draw")
    faults = ref["faults"]
    fcfg = SystemConfig.scale(num_nodes=64, drop_prob=0.05)
    done = CoherenceSystem.from_workload(fcfg, "uniform", seed=0,
                                         device="cuda").run(
        faults["cycles"], chunk=64)
    m = done.metrics
    run = {"cycles": m["cycles"], "instrs_retired": m["instrs_retired"],
           "msgs_injected_dropped": m["msgs_injected_dropped"],
           "digest": convert.leaves_digest(
               convert.sim_numpy_leaves(done.state)),
           "dumps": hashlib.sha256("".join(done.dumps()).encode())
           .hexdigest()}
    if run != faults:
        raise SmokeFailure(f"the fault-injected run on the card differs "
                           f"from the JAX package's: {run} vs {faults}")
    say("random", f"card = JAX package: {len(got)} generators at 256 x 512 "
        f"(seed 3), uniform at 4096 x 512 (seed 0), and the fault-injected "
        f"run at 64 nodes (drop_prob 0.05, {m['cycles']} cycles, "
        f"{m['msgs_injected_dropped']} injected drops, leaves digest "
        f"{run['digest'][:16]}, dumps digest {run['dumps'][:16]})")


def _random_card_vs_cpu() -> None:
    """A fault-injected async run at 256 nodes and a stored-trace sync
    ensemble as ``bench --replicas 4`` builds it, card against CPU."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench, convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional \
        import TransactionalSystem
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    cfg = async_cfg(256, 32, drop_prob=0.05)
    leaves = {}
    for dev in ("cpu", "cuda"):
        sys0 = CoherenceSystem.from_workload(cfg, "uniform", seed=0,
                                             device=dev)
        done, wall, counts = _async_run(cfg, sys0, 1, "rdma", 16, 192)
        leaves[dev] = convert.sim_numpy_leaves(done.state)
    bad = _leaves_differ(leaves["cpu"], leaves["cuda"])
    injected = int(leaves["cuda"]["metrics.msgs_injected_dropped"])
    if bad or injected <= 0 or counts["threefry"] != 2 * 192:
        raise SmokeFailure(f"fault-injected async 256 nodes: card and CPU "
                           f"differ in leaf {bad}; {injected} injected "
                           f"drops, {counts['threefry']} threefry launches "
                           "in 192 cycles")
    say("random", f"fault-injected async 256 nodes x 32 (drop_prob 0.05, "
        f"192 cycles): every leaf equal to the CPU's, fault_key "
        f"{leaves['cuda']['fault_key'].tolist()}, {injected} injected drops, "
        f"{counts['threefry']} threefry launches ({wall:.1f} s)")
    scfg = dataclasses.replace(sync_cfg(256, 3), procedural=None,
                               max_instrs=64)
    finals = {}
    for dev in ("cpu", "cuda"):
        ens = se.make_ensemble([TransactionalSystem.from_workload(
            scfg, "uniform", 64, workload_seed=r, seed=r, device=dev,
            **bench.gen_kwargs("uniform", 0.8)).state for r in range(4)])
        finals[dev] = se.run_ensemble_to_quiescence(scfg, ens, 16, 10_000)
    a, b = (convert.to_numpy(finals[d]) for d in ("cpu", "cuda"))
    bad = _leaves_differ(a, b)
    retired = int(finals["cuda"].metrics.instrs_retired.sum())
    if bad or retired != 4 * 256 * 64:
        raise SmokeFailure(f"stored-trace ensemble R=4 x 256: card and CPU "
                           f"differ in leaf {bad}; retired {retired}")
    say("random", f"stored-trace sync ensemble (bench --replicas 4 at 256 "
        f"nodes x 64, uniform seeds 0-3): {int(finals['cuda'].metrics.rounds[0])} "
        f"rounds, every leaf equal to the CPU's, {retired} retired")


def _checkpoints_on_card() -> None:
    """Save mid-run on the card, load, continue: equal to the
    uninterrupted run; the checkpoint loads on the CPU with equal
    leaves. Deep@4096 fused (16 rounds), sync K=1 and K=3 (8 rounds),
    async@4096 uniform with fault injection (64 cycles)."""
    import os
    import tempfile
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional \
        import TransactionalSystem
    from ue22cs343bb1_openmp_assignment_tpu_torch.utils import checkpoint
    N = BENCH["num_nodes"]
    cases = [("deep@4096 fused", TransactionalSystem,
              lambda: TransactionalSystem.procedural(
                  bench_cfg(N, True), BENCH["trace_len"], device="cuda"),
              lambda s, n: s.run_rounds(n), 16, convert.to_numpy)]
    for K in (1, 3):
        cases.append((f"sync@4096 K={K}", TransactionalSystem,
                      lambda K=K: TransactionalSystem.procedural(
                          sync_cfg(N, K), BENCH["trace_len"],
                          device="cuda"),
                      lambda s, n: s.run_rounds(n), 8, convert.to_numpy))
    acfg = async_cfg(N, ASYNC["trace_len"], drop_prob=FAULTS["drop_prob"])
    cases.append(("async@4096 uniform, drop_prob 0.01", CoherenceSystem,
                  lambda: CoherenceSystem.from_workload(acfg, "uniform",
                                                        device="cuda"),
                  lambda s, n: s.run_cycles(n), 64,
                  lambda st: convert.sim_numpy_leaves(st)))
    with tempfile.TemporaryDirectory() as tmp:
        for label, cls, fresh, advance, steps, leaves in cases:
            path = os.path.join(tmp, "ck.npz")
            whole = advance(fresh(), steps)
            half = advance(fresh(), steps // 2)
            half.save(path)
            resumed = advance(cls.load(path), steps // 2)
            bad = _leaves_differ(leaves(whole.state), leaves(resumed.state))
            on_cpu = cls.load(path, device="cpu")
            bad_cpu = _leaves_differ(leaves(half.state), leaves(on_cpu.state))
            if bad or bad_cpu:
                raise SmokeFailure(f"checkpoint {label}: the resumed run "
                                   f"differs in leaf {bad}, the CPU's load in "
                                   f"leaf {bad_cpu}")
            say("random", f"checkpoint {label}: saved after {steps // 2}, "
                f"resumed to {steps}: every leaf equal to the uninterrupted "
                f"run; loaded on the CPU with equal leaves "
                f"({checkpoint.checkpoint_bytes(half.state)} B)")


def phase_random(rows: dict) -> None:
    """This slice's paths: the threefry kernel, the card against the JAX
    package's draws and against the CPU, and checkpoints on the card."""
    t0 = time.perf_counter()
    rows["threefry"] = _threefry_kernel_vs_plain()
    _card_matches_jax_draws()
    _random_card_vs_cpu()
    _checkpoints_on_card()
    say("random", f"random phase took {time.perf_counter() - t0:.1f} s")


def phase_async_uniform(rows: dict) -> None:
    """The async main path on the JAX bench's default workload: uniform
    at 4096 x 512, unrouted, to quiescence, then with fault injection
    (drop_prob 0.01) for FAULTS["cycles"] cycles, each with a
    torch.profiler window; the kernel launches of each run, the
    workload's build included."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    import torch
    N, length = ASYNC["num_nodes"], ASYNC["trace_len"]
    for drop in (0.0, FAULTS["drop_prob"]):
        cfg = async_cfg(N, length, drop_prob=drop)
        torch.cuda.synchronize()
        bench.reset_launch_counts()
        sys0 = CoherenceSystem.from_workload(cfg, "uniform", device="cuda")
        torch.cuda.synchronize()
        built = bench.launch_counts()["threefry"]
        if workload_digest((sys0.state.instr_op, sys0.state.instr_addr,
                            sys0.state.instr_val, sys0.state.instr_count)) \
                != RANDOM_REFERENCE["uniform_4096"]:
            raise SmokeFailure("the async main path's uniform workload "
                               "differs from the JAX package's draw")
        cap = FAULTS["cycles"] if drop else 200 * length
        done, wall, counts = _async_run(cfg, sys0, 1, "rdma",
                                        ASYNC["chunk"], cap)
        m = done.metrics
        cycles = m["cycles"]
        if drop:
            want = 2 * cycles
            if (cycles != cap or counts["threefry"] != want
                    or m["msgs_injected_dropped"] <= 0):
                raise SmokeFailure(f"async@{N} uniform with drop_prob {drop}: "
                                   f"{cycles} cycles, {counts['threefry']} "
                                   f"threefry launches (want {want}), "
                                   f"{m['msgs_injected_dropped']} injected "
                                   "drops")
            rows["threefry"]["launches"] = built + counts["threefry"]
        elif (not done.quiescent or m["instrs_retired"] != N * length
              or counts["threefry"]):
            raise SmokeFailure(f"async@{N} uniform: quiescent "
                               f"{done.quiescent}, retired "
                               f"{m['instrs_retired']}, threefry launches "
                               f"{counts['threefry']}")
        others = {k: v for k, v in counts.items() if v and k != "threefry"}
        if others:
            raise SmokeFailure(f"async@{N} uniform (drop_prob {drop}): "
                               f"launches of {others}")
        st = step.run_cycles(cfg, CoherenceSystem.from_workload(
            cfg, "uniform", device="cuda").state, 64)
        prof = bench.profile_steps(lambda s: step.cycle(cfg, s), st,
                                   FAULTS["profile_cycles"])
        say("main", f"async@{N} x {length} uniform (the JAX bench's default "
            f"workload), plain delivery, drop_prob {drop}: "
            f"{'quiescent after' if not drop else 'ran'} {cycles} cycles, "
            f"{m['instrs_retired'] / wall:.6g} instrs/sec, "
            f"{wall * 1e3 / cycles:.4f} ms/cycle, wall {wall:.2f} s, "
            f"{m['msgs_injected_dropped']} injected drops, "
            f"{m['msgs_dropped']} overflow drops; threefry launches "
            f"{built} building the workload, {counts['threefry']} in the "
            f"run; profiler over {FAULTS['profile_cycles']} cycles: "
            f"{prof['device_launches_per_round']:.2f} device launches a "
            f"cycle, busy {prof['device_busy_ms_per_round']:.4f} ms, idle "
            f"share {prof['device_idle_share']:.3f}, wall "
            f"{prof['wall_ms_per_round']:.4f} ms a cycle, threefry "
            f"{prof['kernel_ms_per_round'].get('threefry', 0):.4f} ms a "
            f"cycle")


# -- the port's CLI ---------------------------------------------------------

#: the CLI's full-width runs (the bench's cells, the async trace cut to
#: 512 instructions a node as in ASYNC) and the kernel each one launches:
#: once a round, or for ``threefry`` at least once; each takes --nodes
#: and --trace-len from CLI
CLI_RUNS = {
    "sync K=3": (["--engine", "sync", "--procedural", "--txn-width", "3",
                  "--drain-depth", "4"], "sync_multi_round"),
    "sync K=1": (["--engine", "sync", "--procedural", "--txn-width", "1",
                  "--drain-depth", "16"], "sync_round"),
    "deep": (["--engine", "sync", "--procedural", "--deep-window",
              "--deep-slots", "3"], "round"),
    "async uniform": (["--workload", "uniform", "--queue-capacity", "64"],
                      "threefry"),
}
#: full width: 4096 nodes x 4096 instructions (async 128: cut from 512
#: to 256 for the serve phase's time, and to 128 for the report
#: phase's); card against CPU: 256 nodes x 64 (cut from 128 for the
#: report phase's time: the CPU's plain deep round takes ~0.3 s)
CLI = dict(nodes=4096, trace_len=4096, async_trace_len=128, small_nodes=256,
           small_trace_len=64)


def cli_argv(name: str, nodes: int, trace_len: int, *extra) -> list:
    argv, _ = CLI_RUNS[name]
    if name == "async uniform":
        trace_len = min(trace_len, CLI["async_trace_len"])
    return argv + ["--nodes", str(nodes), "--trace-len", str(trace_len),
                   *extra]


def cli_configs() -> list:
    """The configs the CLI's runs below build kernels for (kernel routes
    on the card), as (library, config) build jobs."""
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch import cli
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_fold_kernel, deep_round_kernel, sync_multi_round_kernel,
        sync_round_kernel)
    libs = {"sync K=3": sync_multi_round_kernel.LIBRARY,
            "sync K=1": sync_round_kernel.LIBRARY,
            "deep": deep_round_kernel.LIBRARY}
    jobs = []
    for name, lib in libs.items():
        for nodes in (CLI["nodes"], CLI["small_nodes"]):
            args = cli.build_parser().parse_args(
                cli_argv(name, nodes, CLI["trace_len"]))
            cfg = cli.kernel_routes(cli.procedural_config(args),
                                    torch.device("cuda"))
            jobs.append((lib, cfg))
            if name == "deep" and nodes == CLI["small_nodes"]:
                jobs.append((deep_fold_kernel.LIBRARY, cfg))
    return jobs


def run_cli(argv: list) -> tuple:
    """``cli.main(argv)`` in this process, its output captured: (exit
    code, stdout, stderr lines, wall seconds, launch counts), the counts
    set to 0 just before and read just after."""
    import contextlib
    import io
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench, cli
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    bench.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (rc, out.getvalue(), err.getvalue().splitlines(), wall,
            bench.launch_counts())


def _cli_doc(label: str, argv: list, rc: int, err: list) -> dict:
    """The metrics document on the last stderr line of a run that must
    have exited 0, validated by the port's ``obs.schema``."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import schema
    if rc != 0 or not err:
        raise SmokeFailure(f"cli {label} {' '.join(argv)}: exit {rc}, "
                           f"stderr {err[-3:]}")
    return schema.validate(json.loads(err[-1]))


def _library_run(argv: list) -> tuple:
    """``argv``'s config run through the library on the card with the
    CLI's runner and chunk: (metrics document, wall seconds of the run,
    the machine built before the clock starts, and the (exit code, line)
    that ``--check`` must give: the library's own check of the final
    state)."""
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch import cli
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional \
        import TransactionalSystem
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import schema
    args = cli.build_parser().parse_args(argv)
    dev = torch.device("cuda")
    if args.engine == "sync":
        cfg = cli.kernel_routes(cli.procedural_config(args), dev)
        system = TransactionalSystem.procedural(cfg, args.trace_len,
                                                device=dev)
        chunk, passed = 16, "invariant check passed (exact directory); " \
            "report: {}"
    else:
        cfg = SystemConfig.scale(num_nodes=args.nodes,
                                 queue_capacity=args.queue_capacity)
        system = CoherenceSystem.from_workload(
            cfg, args.workload, trace_len=args.trace_len, seed=args.seed,
            device=dev)
        chunk, passed = 1, "invariant check passed; coherence report: {}"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system = system.run(args.max_cycles, chunk=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    try:
        report = (system.check_invariants() if args.engine == "sync" else
                  system.check_invariants(strict_coherence=False))
        check = (0, passed.format(json.dumps(report)))
    except AssertionError as e:
        check = (3, f"invariant check FAILED: {e}")
    if args.engine == "sync":
        doc = schema.from_sync(system.metrics,
                               "deep" if cfg.deep_window else "sync")
    else:
        doc = schema.from_async(system.metrics)
    return doc, wall, check


def _check_launches(label: str, counts: dict, want: dict) -> None:
    """``counts`` launched exactly ``want`` (a count, or ">0"), and no
    other kernel."""
    for kernel, n in counts.items():
        need = want.get(kernel, 0)
        if (n <= 0) if need == ">0" else (n != need):
            raise SmokeFailure(f"cli {label}: {n} {kernel} launches, want "
                               f"{need}; all {counts}")


def _cli_full_width(card: str) -> None:
    """Each full-width run with --check --metrics, its check equal to
    the library's check of the same config's final state. A check that
    fails (the async engine's own engine tier trips on racy ``uniform``
    traffic at this size, in the JAX package too) ends the run with exit
    3 before the document; the run is then made again without --check
    for it."""
    for name, (_, kernel) in CLI_RUNS.items():
        argv = cli_argv(name, CLI["nodes"], CLI["trace_len"], "--check",
                        "--metrics")
        lib_doc, lib_wall, (check_rc, check_line) = _library_run(argv)
        rc, _, err, wall, counts = run_cli(argv)
        got = (rc, err[-1] if check_rc else err[-2] if len(err) > 1 else "")
        if got != (check_rc, check_line):
            raise SmokeFailure(f"cli {name}: --check gave {got}, the "
                               f"library's check {check_rc, check_line}")
        walls = [wall]
        if check_rc:
            argv = cli_argv(name, CLI["nodes"], CLI["trace_len"],
                            "--metrics")
            rc, _, err, wall, counts = run_cli(argv)
            walls.append(wall)
        doc = _cli_doc(name, argv, rc, err)
        length = int(argv[argv.index("--trace-len") + 1])
        if doc["instrs_retired"] != CLI["nodes"] * length:
            raise SmokeFailure(f"cli {name}: retired {doc['instrs_retired']}"
                               f" of {CLI['nodes'] * length}")
        _check_launches(name, counts, {kernel: ">0" if kernel == "threefry"
                                       else doc["steps"]})
        if lib_doc != doc:
            raise SmokeFailure(f"cli {name}: the metrics document differs "
                               f"from the library run's: {doc} vs {lib_doc}")
        say("cli", f"{name} ({' '.join(argv)}): --check exit {check_rc} "
            f"as the library's check ({check_line[:60]}...); exit 0, "
            f"{doc['steps']} {doc['step_unit']}, {doc['instrs_retired']} "
            f"retired, document valid and equal to the library run's; "
            f"{kernel} launches {counts[kernel]}; CLI wall "
            f"{' and '.join(f'{w:.3f}' for w in walls)} s against the "
            f"library's {lib_wall * 1e3 / doc['steps']:.4f} "
            f"ms/{doc['step_unit'][:-1]} x {doc['steps']} = {lib_wall:.3f} s "
            f"({card})")


def _dumps(path) -> dict:
    import pathlib
    return {p.name: p.read_bytes()
            for p in sorted(pathlib.Path(path).iterdir())}


def _card_and_cpu(label: str, argv: list, tmp: str) -> tuple:
    """``argv`` on the card and with --cpu, each into a directory of its
    own: equal exit codes, stdout and stderr, every file byte-identical;
    (exit code, card's files, stderr lines, card wall, card launch
    counts)."""
    import os
    got = {}
    for where in ("card", "cpu"):
        out = os.path.join(tmp, label.replace(" ", "_"), where)
        os.makedirs(out)
        extra = ["--out-dir", out] + (["--cpu"] if where == "cpu" else [])
        log = [a.replace("{out}", out) for a in argv]
        rc, stdout, err, wall, counts = run_cli(log + extra)
        got[where] = (rc, _dumps(out), stdout, err, wall, counts)
    (rc, files, out_c, err, wall, counts), (rc_cpu, files_cpu, out_cpu,
                                            err_cpu, _, _) = (
        got["card"], got["cpu"])
    if sorted(files) != sorted(files_cpu) or any(
            files[k] != files_cpu[k] for k in files):
        bad = next((k for k in files_cpu if files.get(k) != files_cpu[k]),
                   None)
        raise SmokeFailure(f"cli {label}: card and CPU files differ ({bad})")
    if (rc, out_c, err) != (rc_cpu, out_cpu, err_cpu):
        raise SmokeFailure(f"cli {label}: card and CPU exit codes, stdout "
                           f"or stderr differ: {rc} {err[-2:]} vs {rc_cpu} "
                           f"{err_cpu[-2:]}")
    return rc, files, err, wall, counts


def _cli_card_vs_cpu(tmp: str) -> None:
    """The full-width runs at 256 nodes, card against --cpu, each with
    --check --metrics --dump; one whose check fails (exit 3 on both) is
    made again without --check for its dumps and document."""
    N, L = CLI["small_nodes"], CLI["small_trace_len"]
    for name, (_, kernel) in CLI_RUNS.items():
        argv = cli_argv(name, N, L, "--check", "--metrics", "--dump")
        rc, files, err, wall, counts = _card_and_cpu(f"{name} {N}", argv,
                                                     tmp)
        check = f"--check exit {rc} on both"
        if rc == 3:
            argv = cli_argv(name, N, L, "--metrics", "--dump")
            rc, files, err, wall, counts = _card_and_cpu(
                f"{name} {N} unchecked", argv, tmp)
        doc = _cli_doc(f"{name} {N}", argv, rc, err)
        _check_launches(f"{name} {N}", counts, {
            kernel: ">0" if kernel == "threefry" else doc["steps"]})
        say("cli", f"{name} at {N} nodes x {L}: {check}; card and --cpu "
            f"{len(files)} dumps byte-identical, documents equal "
            f"({doc['steps']} {doc['step_unit']}), {kernel} launches "
            f"{counts[kernel]}, card wall {wall:.3f} s")
    argv = cli_argv("deep", N, L, "--metrics", "--dump", "--trace-log",
                    "{out}/order.txt")
    rc, files, err, wall, counts = _card_and_cpu(f"deep trace-log {N}",
                                                 argv, tmp)
    _cli_doc("deep trace-log", argv, rc, err)
    _check_launches("deep trace-log", counts,
                    {"pre": ">0", "flags": ">0", "replay": ">0"})
    lines = files["order.txt"].count(b"\n")
    say("cli", f"deep at {N} nodes x {L} with --trace-log: card and --cpu "
        f"logs ({lines} lines) and dumps byte-identical, documents equal; "
        f"fold launches pre {counts['pre']}, flags {counts['flags']}, "
        f"replay {counts['replay']}, round {counts['round']}; card wall "
        f"{wall:.3f} s")


def _cli_mini(tmp: str) -> None:
    """tests/fixtures/mini on each engine, card against --cpu. The async
    engine and the native oracle share the message-level semantics, so
    their dumps are byte-identical; the transactional engine commits
    another interleaving of this racy fixture and agrees on core 0."""
    import pathlib
    root = str(pathlib.Path(__file__).resolve().parent / "tests" / "fixtures")
    dumps = {}
    for engine in ("async", "sync", "native"):
        argv = ["mini", "--tests-root", root, "--engine", engine,
                "--metrics"]
        rc, files, err, wall, counts = _card_and_cpu(f"mini {engine}",
                                                     argv, tmp)
        doc = _cli_doc(f"mini {engine}", argv, rc, err)
        _check_launches(f"mini {engine}", counts, {})
        dumps[engine] = files
        say("cli", f"{MINI} --engine {engine}: card and --cpu dumps "
            f"byte-identical, documents equal ({doc['steps']} "
            f"{doc['step_unit']}, {doc['instrs_retired']} retired), card "
            f"wall {wall:.3f} s")
    if dumps["async"] != dumps["native"] or len(dumps["async"]) != 4:
        raise SmokeFailure("cli mini: the async and native dumps differ")
    core0 = {e: d["core_0_output.txt"] for e, d in dumps.items()}
    if len(set(core0.values())) != 1:
        raise SmokeFailure("cli mini: core_0_output.txt differs across the "
                           "engines")
    say("cli", f"{MINI}: async and native dumps byte-identical, core 0 "
        "equal on all three engines")


def phase_cli(card: str) -> None:
    """The port's CLI, driven in process through ``cli.main`` on the
    card: the full-width runs against the library, 256 nodes card
    against --cpu (the deep run with --trace-log too), and mini on all
    three engines."""
    import tempfile
    t0 = time.perf_counter()
    say("cli", f"card: {card}")
    _cli_full_width(card)
    with tempfile.TemporaryDirectory() as tmp:
        _cli_card_vs_cpu(tmp)
        _cli_mini(tmp)
    say("cli", f"cli phase took {time.perf_counter() - t0:.1f} s")

# -- the observability captures and verbs -----------------------------------

#: the obs phase's sizes: the full-width async machine (4096 nodes x 512,
#: the cli phase's cell) captured for its first ``cycles`` cycles (cut
#: from 512 for the report phase's time); the
#: sync profile at 4096 x 4096 for 64 rounds; the deep profile at its
#: cap (2048 nodes: 512 MiB of counters) for 8 rounds; every verb at
#: 256 nodes x 64 on the card and with --cpu (the async captures for
#: their first ``small_cycles`` cycles, the flight run to its end; cut
#: from 128 instructions and 192 cycles for the report phase's time)
OBS = dict(nodes=4096, trace_len=512, cycles=256, sync_rounds=64,
           deep_nodes=2048, deep_trace_len=256, deep_rounds=8,
           small_nodes=256, small_trace_len=64, small_cycles=96,
           cpu_children=3, cpu_threads=2)


def obs_small_runs() -> list:
    """(label, argv) of every verb at 256 nodes x 64, "{out}" the run's
    own directory; the flight run is the async CLI with --check
    --flight-dir, whose engine tier trips on this racy traffic (exit 3)
    and dumps the invariant:check incident."""
    w = ["--workload", "uniform", "--nodes", str(OBS["small_nodes"]),
         "--trace-len", str(OBS["small_trace_len"])]
    rc = ["--run-cycles", str(OBS["small_cycles"])]
    return [
        ("stats async", ["stats"] + w + rc + [
            "--timeseries", "--txns", "--phases", "--timeseries-out",
            "{out}/series.json"]),
        ("stats sync", ["stats"] + w + ["--engine", "sync"]),
        ("stats native", ["stats"] + w + ["--engine", "native"]),
        ("trace async", ["trace"] + w + rc + ["--perfetto",
                                              "{out}/trace.json"]),
        ("trace deep", ["trace"] + w + ["--engine", "deep", "--perfetto",
                                        "{out}/trace.json"]),
        ("txns", ["txns"] + w + rc + ["--json", "--perfetto",
                                      "{out}/txns.json"]),
        ("critical-path", ["critical-path"] + w + rc + ["--json"]),
        ("profile async", ["profile"] + w + rc + ["--json"]),
        ("profile sync", ["profile"] + w + ["--engine", "sync", "--json"]),
        ("profile deep", ["profile"] + w + ["--engine", "deep", "--json",
                                            "--run-cycles", "4"]),
        ("flight", w + ["--check", "--flight-dir", "{out}/flight"]),
    ]


def run_verb(argv: list, out: str) -> dict:
    """``cli.main(argv)`` in this process with "{out}" replaced by
    ``out`` (made first), its output captured: exit code, stdout,
    stderr, wall seconds, launch counts (set to 0 just before) and, on a
    card, the peak device memory of the run."""
    import contextlib
    import io
    import os
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench, cli
    os.makedirs(out, exist_ok=True)
    argv = [a.replace("{out}", out) for a in argv]
    card = "--cpu" not in argv
    o, e = io.StringIO(), io.StringIO()
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    bench.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        rc = cli.main(argv)
    if card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"rc": rc, "out": o.getvalue(),
            "err": e.getvalue().replace(out, "{out}"), "wall": wall,
            "launches": bench.launch_counts(),
            "peak_bytes": (torch.cuda.max_memory_allocated() - base
                           if card else None)}


def verb_child(spec_path: str) -> int:
    """A child process of the obs phase: run the spec's verbs (its
    "runs": [label, argv, out] each) with ``run_verb`` and write their
    results as JSON to the spec's "result" path."""
    import torch
    with open(spec_path) as f:
        spec = json.load(f)
    if spec.get("threads"):
        torch.set_num_threads(spec["threads"])
    results = {label: run_verb(argv, out) for label, argv, out in
               spec["runs"]}
    with open(spec["result"], "w") as f:
        json.dump(results, f)
    return 0


def _start_children(tmp: str, groups: list) -> list:
    """One child process per group of (label, argv, out) runs, all
    started together: [(process, result path, log path)]."""
    import os
    kids = []
    for i, (runs, threads) in enumerate(groups):
        spec = os.path.join(tmp, f"child{i}.json")
        with open(spec, "w") as f:
            json.dump({"runs": runs, "threads": threads,
                       "result": os.path.join(tmp, f"child{i}.out.json")}, f)
        log = open(os.path.join(tmp, f"child{i}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.verb_child(sys.argv[1]))", spec],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
            stderr=subprocess.STDOUT)
        kids.append((proc, os.path.join(tmp, f"child{i}.out.json"),
                     log.name))
        log.close()
    return kids


def _join_children(kids: list, timeout: float) -> dict:
    """Wait for every child (killing the rest on a failure or at the
    timeout) and merge their results."""
    merged = {}
    try:
        deadline = time.perf_counter() + timeout
        for proc, result, log in kids:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            if rc != 0:
                with open(log) as f:
                    tail = f.read()[-2000:]
                raise SmokeFailure(f"obs child exited {rc}: {tail}")
            with open(result) as f:
                merged.update(json.load(f))
    finally:
        for proc, _, _ in kids:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return merged


def _files(path) -> dict:
    import pathlib
    root = pathlib.Path(path)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _stdout_doc(label: str, res: dict) -> dict:
    if res["rc"] != 0:
        raise SmokeFailure(f"obs {label}: exit {res['rc']}, stderr "
                           f"{res['err'][-400:]}")
    return json.loads(res["out"])


def _same_run(label: str, card: dict, cpu: dict, card_dir: str,
              cpu_dir: str) -> None:
    """Card and --cpu runs equal: exit codes, stdout (``extra.phases``,
    wall clock, by its phase names and counts), stderr, every file."""
    if card["rc"] != cpu["rc"]:
        raise SmokeFailure(f"obs {label}: exit {card['rc']} on the card, "
                           f"{cpu['rc']} with --cpu: {cpu['err'][-300:]}")
    if label == "stats async":
        a, b = json.loads(card["out"]), json.loads(cpu["out"])
        pa, pb = a["extra"].pop("phases"), b["extra"].pop("phases")
        if a != b or ({k: v["count"] for k, v in pa["phases"].items()}
                      != {k: v["count"] for k, v in pb["phases"].items()}):
            raise SmokeFailure(f"obs {label}: card and --cpu documents "
                               "differ")
    elif card["out"] != cpu["out"]:
        raise SmokeFailure(f"obs {label}: card and --cpu stdout differ")
    if card["err"] != cpu["err"]:
        raise SmokeFailure(f"obs {label}: card and --cpu stderr differ: "
                           f"{card['err'][-300:]} vs {cpu['err'][-300:]}")
    fa, fb = _files(card_dir), _files(cpu_dir)
    if sorted(fa) != sorted(fb) or any(fa[k] != fb[k] for k in fa):
        bad = sorted(k for k in set(fa) | set(fb) if fa.get(k) != fb.get(k))
        raise SmokeFailure(f"obs {label}: card and --cpu files differ: {bad}")


def _obs_full_width(tmp: str, card: str, sync_res: dict,
                    prof_res: dict) -> None:
    """async@4096 x 512: ``stats --timeseries`` over the first
    OBS["cycles"] cycles in this process (telemetry totals equal to the
    plain run's metrics) and, from a child, ``profile`` over the same
    cycles (reads and writes equal to the retired ones, peak memory);
    sync@4096 x 4096 K=3 ``profile`` over 64 rounds (a child; accesses
    equal to the retired instructions of the same rounds through the
    library)."""
    import os
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional \
        import TransactionalSystem
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import cohprof, verbs
    N, L, R = OBS["nodes"], OBS["trace_len"], OBS["cycles"]
    argv = ["stats", "--workload", "uniform", "--nodes", str(N),
            "--trace-len", str(L), "--run-cycles", str(R), "--timeseries",
            "--phases"]
    res = run_verb(argv, os.path.join(tmp, "stats4096"))
    doc = _stdout_doc("stats 4096", res)
    tot = doc["extra"]["telemetry"]["counter_totals"]
    bad = {k: (v, doc[k]) for k, v in tot.items() if v != doc[k]}
    if bad or doc["steps"] != R or doc["instrs_retired"] <= 0:
        raise SmokeFailure(f"obs stats@{N}: telemetry totals differ from "
                           f"the run's metrics: {bad}")
    _check_launches("obs stats 4096", res["launches"], {"threefry": 12})
    ph = doc["extra"]["phases"]["phases"]
    say("obs", f"async@{N} x {L} uniform, stats --timeseries over {R} "
        f"cycles: telemetry counter totals equal to the run's metrics "
        f"({doc['instrs_retired']} retired, {doc['invalidations']} "
        f"invalidations); plain run {ph['run']['seconds']:.3f} s "
        f"({ph['run']['seconds'] * 1e3 / R:.4f} ms/cycle), telemetry run "
        f"{ph['telemetry_run']['seconds']:.3f} s "
        f"({ph['telemetry_run']['seconds'] * 1e3 / R:.4f} ms/cycle), "
        f"host read {ph['device_get']['seconds']:.3f} s; verb wall "
        f"{res['wall']:.3f} s; threefry launches 12 ({card})")
    pdoc = cohprof.validate(_stdout_doc("profile 4096", prof_res))
    acc = pdoc["accesses"]
    want = (doc["read_hits"] + doc["read_misses"],
            doc["write_hits"] + doc["write_misses"])
    if (acc["reads"], acc["writes"]) != want or pdoc["steps"] != R:
        raise SmokeFailure(f"obs profile@{N}: accesses {acc} against the "
                           f"run's retired reads and writes {want}")
    _check_launches("obs profile 4096", prof_res["launches"],
                    {"threefry": 12})
    say("obs", f"async@{N} x {L} profile over {R} cycles: {acc['reads']} "
        f"reads and {acc['writes']} writes equal to the run's, misses "
        f"{pdoc['miss_classes']}, sharing dominant "
        f"{pdoc['sharing']['dominant']}; verb wall {prof_res['wall']:.3f} "
        f"s (a child process, beside the others) against the plain run's "
        f"{ph['run']['seconds']:.3f} s; peak device memory "
        f"{prof_res['peak_bytes'] / 2**30:.3f} GiB ({card})")
    # sync@4096: the same 64 rounds through the library, plain rounds
    K = OBS["sync_rounds"]
    cfg = verbs.profile_config(N, deep=False)
    ts = TransactionalSystem.from_workload(cfg, "uniform", trace_len=N,
                                           device="cuda").run_rounds(K)
    sdoc = cohprof.validate(_stdout_doc("profile sync 4096", sync_res))
    acc = sdoc["accesses"]
    if acc["reads"] + acc["writes"] != ts.metrics["instrs_retired"]:
        raise SmokeFailure(f"obs sync profile@{N}: accesses {acc} against "
                           f"{ts.metrics['instrs_retired']} retired")
    _check_launches("obs profile sync 4096", sync_res["launches"],
                    {"threefry": 12})
    say("obs", f"sync@{N} x {N} K=3 profile over {K} rounds: {acc} equal "
        f"to the {ts.metrics['instrs_retired']} retired by the library's "
        f"{K} rounds; no sync kernel launched (the plain rounds of "
        f"with_events); verb wall {sync_res['wall']:.3f} s (a child), "
        f"peak device memory {sync_res['peak_bytes'] / 2**30:.3f} GiB "
        f"({card})")
    del ts
    torch.cuda.empty_cache()


def _obs_deep(tmp: str, card: str) -> None:
    """The deep profile at its cap (2048 nodes) for OBS["deep_rounds"]
    rounds in this process: the plain folds, so no fold or round kernel
    launches, threefry its 12 building the workload; the abort anatomy
    against the conflicts and retired counts of the same rounds through
    the library (the fused round)."""
    import os
    from ue22cs343bb1_openmp_assignment_tpu_torch import cli
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional \
        import TransactionalSystem
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import cohprof, verbs
    N, L, R = OBS["deep_nodes"], OBS["deep_trace_len"], OBS["deep_rounds"]
    argv = ["profile", "--workload", "uniform", "--nodes", str(N),
            "--trace-len", str(L), "--engine", "deep", "--run-cycles",
            str(R), "--json"]
    res = run_verb(argv, os.path.join(tmp, "deep2048"))
    doc = cohprof.validate(_stdout_doc("profile deep 2048", res))
    _check_launches("obs profile deep 2048", res["launches"],
                    {"threefry": 12})
    cfg = verbs.profile_config(N, deep=True)
    ts = TransactionalSystem.from_workload(cfg, "uniform", trace_len=L,
                                           device="cuda")
    ts = TransactionalSystem(cli.kernel_routes(cfg, ts.state.dm.device),
                             ts.state).run_rounds(R)
    m = ts.metrics
    ab = doc["abort_anatomy"]
    lost = ab["aborts"]["lane_loss"]
    aborted = lost + ab["aborts"]["poison_ghost"] + \
        ab["aborts"]["poison_real"] + ab["aborts"]["mark"]
    if (ab["retired"] != m["instrs_retired"]
            or doc["accesses"]["reads"] + doc["accesses"]["writes"]
            != m["instrs_retired"]
            or not lost <= m["conflicts"] <= aborted):
        raise SmokeFailure(f"obs deep profile@{N}: anatomy {ab['aborts']}, "
                           f"retired {ab['retired']}, against the rounds' "
                           f"conflicts {m['conflicts']} and retired "
                           f"{m['instrs_retired']}")
    say("obs", f"deep@{N} x {L} profile over {R} rounds (plain folds): "
        f"fold and round kernels 0 launches, threefry 12; retired "
        f"{ab['retired']} equal to the library's {R} rounds (fused round); "
        f"lane losses {lost} <= conflicts {m['conflicts']} <= lane losses "
        f"+ aborts {aborted}; poison flags {ab['poison_flags']}; verb wall "
        f"{res['wall']:.3f} s, peak device memory "
        f"{res['peak_bytes'] / 2**30:.3f} GiB ({card})")


def phase_obs(card: str) -> None:
    """The observability captures and the verbs that run them, through
    ``cli.main`` on the card: the full-width async telemetry and profile,
    the sync profile at 4096 and the deep profile at 2048, each held to
    its plain run's metrics; every verb and the flight incident at 256
    nodes x 64 on the card against --cpu (the --cpu runs, the full-width
    profiles and the sync profile in child processes, all started
    together)."""
    import os
    import tempfile
    from ue22cs343bb1_openmp_assignment_tpu_torch.native import bindings
    t0 = time.perf_counter()
    N, L = OBS["nodes"], OBS["trace_len"]
    bindings.load_library()       # built once, before the children start
    with tempfile.TemporaryDirectory() as tmp:
        small = obs_small_runs()
        cpu_runs = [(label, argv + ["--cpu"],
                     os.path.join(tmp, "cpu", label.replace(" ", "_")))
                    for label, argv in small]
        n = OBS["cpu_children"]
        groups = [([r for i, r in enumerate(cpu_runs) if i % n == k],
                   OBS["cpu_threads"]) for k in range(n)]
        groups.append(([("profile 4096", [
            "profile", "--workload", "uniform", "--nodes", str(N),
            "--trace-len", str(L), "--run-cycles", str(OBS["cycles"]),
            "--json"], os.path.join(tmp, "prof4096"))], None))
        groups.append(([("profile sync 4096", [
            "profile", "--workload", "uniform", "--nodes", str(N),
            "--trace-len", str(N), "--engine", "sync", "--run-cycles",
            str(OBS["sync_rounds"]), "--json"],
            os.path.join(tmp, "sync4096"))], None))
        kids = _start_children(tmp, groups)
        try:
            card_res = {}
            for label, argv in small:
                card_res[label] = run_verb(
                    argv, os.path.join(tmp, "card", label.replace(" ", "_")))
            _obs_deep(tmp, card)
        finally:
            child = _join_children(kids, timeout=600)
        for label, argv in small:
            d = label.replace(" ", "_")
            _same_run(label, card_res[label], child[label],
                      os.path.join(tmp, "card", d), os.path.join(tmp, "cpu",
                                                                 d))
            _check_launches(f"obs {label}", card_res[label]["launches"],
                            {"threefry": 12})
        flight = card_res["flight"]
        inc = os.path.join(tmp, "card", "flight", "flight",
                           "incident_invariant")
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import flight as fl
        doc = fl.load_incident(inc)
        if flight["rc"] != 3 or doc["reason"] != "invariant:check":
            raise SmokeFailure(f"obs flight: exit {flight['rc']}, incident "
                               f"{doc.get('reason')}")
        say("obs", f"every verb at {OBS['small_nodes']} nodes x "
            f"{OBS['small_trace_len']}: card and --cpu stdout, stderr and "
            f"files equal ({', '.join(label for label, _ in small)}); "
            f"threefry 12 launches a run and no other kernel; card walls "
            + ", ".join(f"{label} {card_res[label]['wall']:.2f} s"
                        for label, _ in small)
            + f"; the flight run: exit 3, incident {doc['reason']} "
            f"({doc['detail'][:60]}), {doc['cycles_run']} cycles, ring "
            f"{len(doc['ring']['series']['instrs_retired'])} cycles, "
            f"incident.json and trace.perfetto.json equal to --cpu's")
        _obs_full_width(tmp, card, child["profile sync 4096"],
                        child["profile 4096"])
    say("obs", f"obs phase took {time.perf_counter() - t0:.1f} s")


#: The JAX package's per-job results of the serving runs (``serve``
#: phase), printed by ``scripts/serve_reference.py`` (defaults): for
#: each job shape, the first ``hex`` hex digits of
#: ``serve.job_digest`` (sha256 of the job's dumps and metrics doc) of
#: ``serve.mixed_jobs(jobs, nodes=n, trace_len=n)``, job after job.
#: Held to the JAX package by tests/test_torch_serve.py.
SERVE_REFERENCE = {
    "hex": 12,
    "jobs": {"32x32": 1024, "16x16": 640},
    "32x32": (
        "6c123a336ff0bcc2bb6121499adb33e419257f917fb2457ac9e5e0b028ea"
        "054b8cca18b725a68bc1ba3c367f2f85f21ce98766a1f5bb8602c6a488c0"
        "abd08161b0532dd1e1448e7a31077eba6575b8f2a06f62c7106d7486b50e"
        "2a231a7703dddfd2a1acaade5a97d99963fbc2104e3bea471f414d217a03"
        "baa0bc6d081d8c208748618a86877b9dc21343663991ab7699ef83f4739d"
        "513a9375f5e8f7c4a76b84745ebc946078f0bfe6e538512893c9113dfce8"
        "5aaca8edf653477132af4303991a28b7227ec98ec1e6141c9828528e08f8"
        "750c7ee9128eba008e750db48504b45d64c3fdc75b0f99e60010b574d28c"
        "2c9061c54350897c37945821fad03c098d0aa91ea35fd1898bf9d7858b2a"
        "9aaefde4d5270d4f536d8a33686c74abfee44c590a68a82d6701f42f0586"
        "02a8e76ea65bf30a66379115eeeac3973a6c578651681616d6254e272615"
        "0c2f57aa1077b1a774a801f1d2e7bf698525ea7a8417b6a8bc44d2b29c8f"
        "aa0873a0a7689d1130b7dea8f81cda385f1e10fe57ca4a4f5b9d8c3f0f66"
        "f6dbdfc4580d4317547b6bc496e2a03c6c6c94c640299df08dd1701533b7"
        "bb518b20e7f13818c8071ebd0d9a070c08322be6b4351dcab0c6dec0b006"
        "d4c6476e8f5017ae176467e56fab9b9fe5aeee98692f712d1e17fed8d7cc"
        "efb6e895529022f735de9b4d0a7424853f2e3452312e76b1aa969c6f6bf8"
        "89f0aceeb20eda0b2309f5ebd46d9a66a2ff55dde23c610b684ec4ce55cc"
        "459c5720768bbcae9bb83785ac8ff5a592d45e13817a8ea9589638c9d126"
        "c9f9974947f7629748fd8e513c168cdd3d4f3877c9eb4cb283efaa71f57c"
        "87d9e881e9f541699424472a303fe84d27c5227b31a843da36ec4ab3a8bf"
        "b3ac4569bf81f7064e4fce13fc2de86311558de66fbfe70ce0318ca6f501"
        "849917fd29136f0b5884dd999b5df451c320f0cda7cddf0e7a242add7417"
        "64465e3a4a9c4bfa4a63401446bb6266afd06862f22aaac970efc043ae59"
        "b261e3f7d3f99074f970daa38098017f0b09b93103c4f44251e90c8000ad"
        "19295b08a30c3967b9260339016888c0e5f52ccafd65ad8948087b3ab05f"
        "39051059270617872d38c6054127bb2f4c39b23e1a19625b048e3c9771dc"
        "bfe57a1373281cc94fd55d522b66914f1facda57dd681ef5e40bd5fbe819"
        "9d437ba97b5f28e66cca0fb09a3e3186d5a2e9bb771ba71c6d91a37e13dd"
        "c89b46be669c0cd1b211f6767a9f1a0112b7bb3b66ded04d0f7cb7e200c0"
        "224d442560e5e7b418dc82d8962ddb37eb22f469b9e2d57d13b122bb4576"
        "43dd8017a91874d6108203688a669158aee956465630363e45ce8787a2fa"
        "c5e2cb9c89c9e363486f0a378678c7c038abdd04befc01c65db5b3a4a509"
        "99f0170c08ffd416efb9e5534502272067402240c1e9b016ebfec8a7fd1f"
        "95d9e5326222800ae4ae1325cb0aba22fba8f379224fbfe0904dfa948bce"
        "cde6c47ec05477da77ed3c909a853a19b7a7e76b5dbceb5798a840e38c86"
        "b62c4a88f0c63b73210f4613e95ec089e10363b21cbd729cebbbbf4b34f4"
        "288b1f6d578d1ec5942e5f0e70381598433893a3c21bc0de50f11c9d5b8a"
        "dad9c326dc1bc1f1404f0286c737bc946a02df2994317429c5226ef339d4"
        "774ffa5fd40324928379a8d8379ffd4925e07ed0fc29c0a7831b9a774ffe"
        "b178e240bc02e67a0fdfa3d202540a85963047b08cf095639936b867574b"
        "80405b58d437585c591c1f135ed5632c2c91e328fcccdba3cfa52cb1d95f"
        "cbe66920bc8f9e233a297a396b3928f4519eb3bf23e5c8618dbccf963c7f"
        "710cf6ab4cbd97769a13dec3618006e0fc2c507eaa5d9df37203bf540d64"
        "7fc43a165937b46fa122c8b68ef4e02fdcb34734d2e611a7c7add06d2a5f"
        "ab64ad534a17301f41f738209945c59a2c01f2cce2ee18dc954d5223e5c7"
        "96dce038969f75d3477127acf538ed2938fcdc5871258fabf52ca0234e18"
        "709cc7bc10ed363f5ced7d8a8d292e6787c8d313ea3fe0ffb8edd595a0c6"
        "7d88788937d6f4fc540f616d414c99a0ce3cb851948c912c97fa21f615b2"
        "fda875f8adcd9df6f3cf83e2fc4fc30274f819a5037ea987581767b6d8e1"
        "7e7749baaca40be4f465b5c1827ca4084e5f9025353246feb15a3b4f30fe"
        "8114904fd77b70104f6c0ff5fb601399b6aa30d65ea951034eef04f6ba08"
        "755624a3dc0cb7d06e902082d67bbfd8d3717ddc852a11e4b86001684355"
        "de2ceb513da3190d88a821be60468acf62cea0b7b5709575f46673ea4ee2"
        "f7474222aea39ed5a89e4ea85e431d982fd2b78793cb6bcc975f357c77ed"
        "e8dc8c91c1a2bb0e130edf7cd85ef0da89c34566daf32e421fe973affd49"
        "ac0a969e5c0d085a09f9d424644c50ace88c1124eb7838076c8d7cda98d7"
        "613bb0e50cfc8653ffd388ff9e1e7afed8dbc98d8c83be7934d5dd03d435"
        "7ad2b7098377c8f82e15bcfcc36532474f5b89fa3c2450e25091fb860a68"
        "5ec5b60f4dc34dce2f643af8f50893fe93c1081c943b13714c1b9db77c83"
        "cdf2a476a2889227cc2241e89bbb070bacbff9de665c0f933c6508acda4c"
        "a520f25e2ab37aa8f1b8e60eb0d71e3767c9b539042139fb0f69e5db301f"
        "841308d7378d5920cf0de6e177dad11a6f9e7cb865ba7caf0a63036060b3"
        "451d3e3253f96a3ffad550cd747de372264c549cb0058576b3caa4a96099"
        "e95232ede94805305dc6cad7d111953a529105fb4ae950055a912809d19d"
        "5fafa169ca9e9dd22638e1d4c773864b68151295cac62e4ac1358e1c7843"
        "26d4d12d84d3a76f8c5db354b2d83c161c9c3bfed26ec326dbe96cbbf296"
        "662340421cfecb87523fc077eea804ef8e261a4c745781158336f93eadad"
        "d3f85895c1137b80ca770182eff6420fc579f1037163847918f85cb95ba3"
        "138e292cdb7e82ea5d752188095e992b76a242fbc5ef08be79270e8f7aaf"
        "78153f146a8edc7e6cbce520e7381f665c8675ec838665c816b7e4afd323"
        "41ee64778174c8d02b333e3a01a5ea8ea13e08ea3c65ba472232a8d58d41"
        "517f61c28708a92c453005f04708a55f1ea11f2a49cfc9f727973d51f9a6"
        "6ebeb24dceb31501e3f04af0f56ccc3ad8a25abafbb403edbaed5845085d"
        "df4ca54f3ad1ff6beddad6e1a95aed5f76a4940dc893bb2cc1b0808f71be"
        "6b6de009f830baba9d4db40ebe9b79b59292a75c84c71134cd3244aa8022"
        "0c80329dffaeaf8d74a33fd6e7bc2ca0db15ceb561783bcac0a69ed57806"
        "1bbd71f0ba638b0b2dff8b8a47145b9ff7314f470eb0a6f0f29309dab631"
        "3f9193f7390aa6b3fae1fdf6a3853789933fa29a49fdf8a4dd749b8bfb1f"
        "6df51f66ccd9c1115de99f0722e1209a12fb91cb76d9472c556f461defe4"
        "83b705a5ce8092b4d4403bdfa025a4e288d5c980a630ccd47f76e477d7e3"
        "7df2154ae57ed09a6ebd52a17ca4064fa7c27be3ba6528d709b6044753b3"
        "8b809ec551fcc5951c70268849ec6268376bf8fb0904f6326ac232d07861"
        "ea6b4087c5a318223f062eb3e929dcbdddff22a2016f56247060f1cad49a"
        "49f5f3047d6a5ee231da7938f64c08cb684756c1adac290cc17a717f9ebb"
        "dd46d201444e24c7af42542c6c206f1b7942bd0b0dac23902a4e47223918"
        "0a8b492f4c63b7f13f1469cf04e0e882835d3ff595a0832706700f627203"
        "e9ed48e1d948a27b9258c0470794cbe45f87c596fa9873083ef547f63b12"
        "23d161dbaef6bad5645327aed18e158948e8e1f80cc26aac81a8c37d227c"
        "13b5fcb52242cd16483550e3e11cb03a17f25ec19e6efb2629d23f3c8949"
        "6786afca57de7c3bc2fad7a4592993e4a88a0f9d720b8e32bedfef7c9797"
        "311d8c03c5f56e7dbecf9c94b2301671b5b7c6194de692444fc96aafeee0"
        "5265268bcc488894e02ab569b87be2f7ec8591fb94696e27bea8b16f45d8"
        "35361e300a9db70fd26acaec86a77781ff7def684714e4b96d31c6d6c4d1"
        "352b4dd67f5616918a50700712cb76171ad7a8c5c484138acdfdbf9e20ea"
        "19e818269a2762cddbc6229c4ed5c882e13defa442054fada852ebca01a7"
        "ac873b896087060ca26489b7e5b1eccc35eda987167c818d38f0c35b4413"
        "8ce8e21f4330f284710be8275856fe397577f5fbab75cd0509ad4785e0cc"
        "298dec20fc009e29731e584d1069d86dd5954ae19f21fa0fc7c3c35be1b8"
        "d02ae9e180f4a9955131ebd692e110634a81b5940caf0d519308877b915b"
        "d1d077b017ceaedd560e8392626a44bcee9ea7b5be41ba6eb4f0afb5a0fe"
        "9cb14db9dea7331ef26006aff9ebad4ab664f042acae9c20ef47867d82f6"
        "3fc201f0412ce5a93686ba5652bd1250b7b8c1a518fd7e0a4e5b3364596f"
        "08fde42dcad3735179705dcc899910f6f4b014e07833b0a35ef934391c3a"
        "5307f9cdc2878176413f12858f15a4a39400dd38c0b3d0f4e2c0139a758a"
        "88d9d11829d17a560f762bde653edc13ed56961bf6604a09b89aa537f644"
        "bca87cc2c773e89d5588fbad672eceac625891c66c8c1210a60c2aba6aca"
        "268e40d2143033afa70123b920cea66303ca2206915ee35ea09bdbb35b39"
        "8ca317dc4de7d87c434509158c9875ef58607cc8a6f6f39b506fdda3c02d"
        "e0e8ae137a90b9693590946c273211c65ee3ac28d546726b38ce61acd877"
        "0b6095875d242288d419a31f61e0b76894aeec1b8a4739cb46dd18120536"
        "a52ed8be192498e49f032ae166a00f4dce6e2a7b239bced9bdb6f8422fe6"
        "8ead61dcb217caa8d057914e341c3813c28bf06465892f1c5244d847e61b"
        "803edef223a14081005abecd72cc5ffee35176f2ae8a13e31ebbc3a06dd8"
        "3d908e0b3c81ce59670eb75970d8bb08f80a5ff2c3f859e97371f3753aa8"
        "7f3080eb500c48b8821b76940624427ff7b75f1411ba8baa1973ab64d35e"
        "5dcd5941ffb920ddf68f1e0d7aef4bdb909238de892d19bb8fe52dcf1901"
        "eeb2460303222f39f4b2bd388bfa5f85d8ac388d77ea7e3cffd6b73b5818"
        "82909545e9cb251131562d3dbeb69d661fa34fba4a4481551dfff1e1d60d"
        "db1bfb71682d5cb8f99e5ad65b5ee7df081363fb254f85fbcc27633d129a"
        "885488dd3e2e9e230b7c23e1e094a1c881ef3a497cf9dfddf35ea183a47f"
        "98a30f6c8d7e623cc9990a091308216060078dd060e25668d6b38a808b4e"
        "03964766ba2eb6837d6356e3e8036262b21c3aa9a66f111d9e10dc80b71f"
        "2cfc81a1ab920e011f117de4cc2056566936c1bf9e9f9d9acfc546633dc2"
        "b37b6021c4c5488453e0fe729b7181e23aebf5488c89670e24fe4fa5c7b4"
        "e9049623ba6e6a1d6267742482085b093808bff5a587217329e25bfc2feb"
        "f2aae487767fff3c8d8cfdc075f5264f1102876505f746ff3a0d98da3c44"
        "2e685c5976b2810095f619f23442848a6b318e414f07ced801aac506846d"
        "57fffaf650666cc6f5cd5d2ac7854a5e2f563f0044021c6417a7e8d13d9e"
        "10c763b3db3584438bdf59048d49f41e163be8935db7b53afe98cde56241"
        "04e6e40726ed6dc1181ff2ebb4bd922f4d8296796848170c96b163a40d2f"
        "38ce0007364a65903eb3c8e3b9e8cd8f30ade5e39e677c375fe226b9904b"
        "caf657aeebcf8e774a71ab145d055bd9c1760729344482b1dd2915fbfc41"
        "90845e3ecdcc4997fdcf311279d958e40d72d46680a346add34de99498cc"
        "cb015f98496f37188430fe4e6e9807387e0510743d98ffa4f601b6fa959c"
        "bb586a56783779da7e9e56ce72dcd8854fe14dba75d9d6b665a9b63af2ee"
        "1c6a3ca069b142fb113eb73274db1e0d3c673ec458ca2a34fdda4b03bb16"
        "ba7eb54b40b6f10874c9928e98a85b30838ff78a3c684018fae3ce1d9904"
        "a2b38c8fce4a02e74d424acbe89db2b23aa661840cf088454e4b8498e673"
        "1511199fc61d4b86196cd36499ffe3d69ae2f53091e86b2304d05072a0a7"
        "b5f5448735bda4587222b9c0b0c0a2197dd8962374be06d0d143982b3f70"
        "348f7789d8ddde77c7bf5a7bb2d27dcaed7a5d99d4278329ebb97120fc31"
        "0bf8ebb8bfbfd37c063ff80c6e5a8b7266ed84b8f9a528761e7f82bcf8cf"
        "ad143146892c3a2efeec1b89911d1001c72058983cc7ce11510b7a00be55"
        "b32312053cd0a88cc36107f15a4cece73694bf764f58e04f4e61b8562603"
        "095e3bf0410338c25d86c097471c6b47696c650c9022a0e4a58b8197d467"
        "c9b9b86c02a9e432a725608d010a06a60c56b745793e42c01c189210f616"
        "efa40124b8dfc38b6641dba3cfbdf8b616fdbe252543a80300b88a1c227e"
        "856fd396db35d7e03078475d66a56e19d46c0928d2886abcc5ec7bf32c32"
        "1f2aabe539d48a035ff228a611289f239338691210801ab957a900de121b"
        "06564b6d44646091116c2ab9bc790f1a643f6dc67e2928f72792440bc906"
        "d9a4e525d829fe0af26fb56292f90511ed504234250b71d5768c226da3cf"
        "f21530517ebb46343377285eeab5057271335fe4abe094b6e3b4fbdbd480"
        "abb817de88322ef28857172bcc896ce9b4fb230e7005075e123579f54491"
        "90dcd56d899aea0d3a31968509ef4129a998aa189c378f39fbb06ace5f06"
        "626d57959e7385311aa3e04bb8ab131a4600943b0da8df383208367b22fd"
        "2d57e811a0f244c134d57d713cc299a584ac7b1620e2a41a2b6cc68682a0"
        "82b7428762b16b59de9e53084f223fc5740626df0fd8dad07f6f234b0fcf"
        "1372b8c6bceb69bfa1b90236f876d21e9529d7efa66df1914fbeb01badd7"
        "00f05dd6c05820fa06710998c8cb9543df893bdab1dbe679ccddca93e88c"
        "53ff78f04ec39b42c70c830a198bd88131eb524b415c1c5c7561643eaad1"
        "26c4cbf5af955e9148d3472dd10adc4d8b7c93d965bb9be5a8dd1d74f663"
        "c86bf0f91fdd380f5d44f4da18d49d8e460969771dc200bb9ad00dd16b76"
        "a74c94948b8e2d1d309ac296a3c219a8e7c2347014dc6c80907bd953c513"
        "e10e3e6a78824e7f065da3fb51ed00311862fcefa80e7e6ef73784095154"
        "ca58f24f569c565d34f466b5a479c566bb5a2bbd64e526865516cf009e53"
        "ab39efcc8ac53c86c6a84ea809260aa0e73b7a50c78a80a82f9f48976836"
        "c9c3b57c346932995b3983143f9539e552ea4ffa44857d018b6f0c1a4d52"
        "cbdf4fa424322a2bb11c51c8650fed53092a254f1f27e2e131a08a41f246"
        "c40730fbb5937195938b80e3a00b97d846c50ef836002e274df6d4ef4088"
        "d72b16d2caaef7ad747407180671e1bcafc7ac62bdee9074396db7303078"
        "60ca4f4d55062dd81a209dc6588a04f595080ae82a639fafeb63ff4baf25"
        "bb1fb32a05c4559f5656d4d52eb933f1693ab1cc0613dac89290270df65e"
        "42123f993fb20cd9172fbff58d45ee917427873539d414b4b0c233f8ec9a"
        "5b5b7c2b4ccd46d548bc596df8a0c28450f13dc7ad46b836d34d95b79f5e"
        "420b97b591505a9cb45ae712ac576d3a24f2b71f65be9d00f41380190fd9"
        "982762f8090108e671bafbae44461da584ff5eae64f2deab8d27561bca70"
        "9bdac31573678ee13a988cc88646be193c88c8c9a4613a385b53385faaa3"
        "b5ddd7f289c1333c35d526598a2c0d71aadb2738ba4ff174059f0c582093"
        "1dba6b7c85618dde39bbcb580c5fd1a6de580852f6e79371d68ad1ccd9ab"
        "5d13209b58404f1fba777e4c25b24570dfa5b8d3c8c06164377e77c50ddb"
        "3e10f694531d377915ed994097d7706b7fd32fd80e18d6e83dc6b0d139ea"
        "f857a3883dcfed3a029901f61bdbbf3ba286f29471225ead41af94625ed6"
        "25c0cf5115aa2a4fa3dbbd8c9449692ef30c63e134ca38d5ad962785f9f5"
        "64afa58530cced916adaee630007d03a272956922e293a38e2b348590f3e"
        "12cdd5e38e261929ac28903af5026c28de5c62c0f9d5999a0dc815e1fda6"
        "157c37e618c4125bd0823ed319b5ed4c706ae50cf83cc8bcd48b96f5456c"
        "922021c387bf8bffda2ed8fb06faf378aa06453de9e9381782d5214228f9"
        "e9a96196e8d2b47106f8ffd2494bf8566e0963ca8e68040ecb1bf11c6b91"
        "712e5cd443c6ee60619d2ba6a332cd30df4e584c7907053106e3fd9748cf"
        "84dc5796c4eb45322c76f3d323b471bb40f683f7181c5a5f11f0db2275fd"
        "4715192d18c55e9b69dd75bfadb4891e5a1feb3d09a51c4d370b593975a1"
        "07f14dc775d6d25a36d6125340b876f0c8cb6bb51199068d336aa330f056"
        "b6a59b65e6a09bfe3fa54663934c240a56725092fd25f89801c3715a85cc"
        "504f6a6bf99d655ae0ece0d047decd6ee3ced4a99c34edb0f838b15ee319"
        "dbbb20ba6cb05b0917a059e79f94f2097c4611e7bacb49adf5ff6821e370"
        "095ecaac29fef277c0fc8a50edfc9d97d0112d501333bdf4c37dbe854e50"
        "b38df170e052afbe6802817f15de11737ea4b53d6ec1723296baea957f7c"
        "58109f5b67ef56cbb550d446518e2422c1ebbe01e7c72a0654e7626ff36a"
        "895ee19fa4deb55f2dfdd03ef4fb41992e4918b0c1018769f1fd046b6a8a"
        "4ed8d96bb9ca8811e1dfb210762a12678985c3b3cca2b168fd3650f66fc8"
        "846f349b1ccac127fe3ba664471c4a6447eadcef9820cad63d8705697671"
        "17b498a95e082c3bb9713fc2188709f7ba4be586ba290be9b8fae3f0f139"
        "a07d832646215274e1e22a4e7deae64f9615b3907490874d1bc1b086808a"
        "5a1e49ecc5a5e6c31c98807919a0663dec7089c36447c56f"),
    "16x16": (
        "f897a7241d67adad17a63bc08e004265a48cff85d107cbb83b7dd0228066"
        "9ebbaa375a2fb4bff1ecfe9e4082751203c9131096edd6093b1c226a4ee2"
        "0413ea3ec76752452f4ce98ed4cc174933a11d6616103b392b154834378f"
        "067020bdab568a882e7136648e863896b2353202b1af1b9f2d368a150337"
        "44851134d25b19ca3f991695a855c52136688911caa6999136fa4e3776a5"
        "17bbb1fefabef1ab96d93b737e949abafcf2350383855ce4063011c5ccad"
        "7c10dc5256de18c859f91f3beba1a2eb64b9ff3ccfcb8a4d2efe17bcc6a0"
        "414b80321c91222aa90700c8b13ff25356b86dc3efc3f53f5068af10cbf2"
        "57d2aed219aa60854a2f63c3397cb478b28230a9b40f8b9334839412d222"
        "f02b1568ac739588cca442d8469b52274d53e90e0f723439d0ab5918593e"
        "9085bcb69d1e25464a9854b25b24cb7c61782d40d35f3556f552680b7cd6"
        "732c2de5c4d71e5ca0c900e3ae24bbf2a1ee922404ce69de046d4762cadb"
        "1e97ac77525c20f2f7093e42dacb78ea3c7cd4d36c6ed723c2c9937fabc6"
        "c91c9f8ad2e9beb1e2eb45f27d1252c31dcb158f4159cfe33f48e670443b"
        "d1c3b305c0c2ab370178b0cf13a80549f4a0c871350b417d446112e541b4"
        "313e5d0153f307d9c7194a4a8439d8ee537a119818779fe174d9c6515114"
        "58d7fa948a03c02e4624f22e240e21bf5053d547b6a0a7c7cebd294a8970"
        "ee78919c38581c42928dd084809dc8c1325276405b612db28ad969082232"
        "4affa2531de4f4e990e9f7dff1d6a0df5e0f77529b7d3269c7e371ab1c0c"
        "fafc85382bb76578c8d5d0fbe3655488208d4acb1f90a2affdc8b768f1ec"
        "66b0970aaa2a8b6028866b7ffef9ea103bafc6540dd47aee8cc9b2306623"
        "696b95b370d543532c92a0fe69d6cb044d6c332fd5803f9487abf970cf97"
        "b2d1c0c106a9cc048c430d12de1dc0e85fcfc08196940864489239775126"
        "5f881aabb333e72c403a2009ddce262bde2132da3a0894dd66a2af02a38e"
        "3431d820d2bd3e02f52e4e29e242107b32502e9f8503dd81d5495f229bd1"
        "b814d6934afb47c54a9ac036ad1e75e534c56243f416efe700a515f78ff4"
        "fbfbb71c29e650525edc43fa59744e2cc4be6a7cd9b63c81a98ceac5a631"
        "56dd8a37629b0e0b239e4fc4d125a29131afc70a9c2dbb670c2f0111b1da"
        "a803cdb3fc8ab5072ee8bb1c8862c6a66ac295bad46cc4a18b539c489a45"
        "b99e47f2ab8bed7e2fd81c0135f26f4e18cbc827ba3485fa3925d76ba7fa"
        "01132fcc8a82c2edf11185bdcf9dcf7bbdb7bec404402c439257120422ac"
        "f0b2c39f32f852986a8b12f62954f16fbc98259e35ccb79bb04dd0aa877d"
        "38a89e958f797d31be971a14aa2caf5f53c7027af36df116057cf2aa323f"
        "453cc30ba3c4e59867eac0ffeacef24659889903813bbd6b75938b591a28"
        "8202618e374daf3b2a2f6226a256f8cd50e1635ee0c91bcaeb349add6c17"
        "24675fd06bb363963970a322383a4ba48bfb0421effbfc213bab264f08c7"
        "b0784ca7a3c565952b34d81980dee670b1a811f72739a08c989417d76eed"
        "1f874ef4ed18cf77ffe3970fcc4dbafff4a53b1e13d1f095a23f69ebcc25"
        "3fdf4a33b86dd766a8eaa299632fa2b0ee2978350bed91ba0ae401ae4630"
        "ad719f635050f96bbd4d918ad2142589239118f49f10e9c7adc70250f7d9"
        "d0e23776173ba02cccb5a18e96f52370f53cee75bafecc4e899c55249d66"
        "a1fed37cc4dfa891f82dba3dba0496ac2f026be750d0149f269533c7f3ab"
        "e9f61f8d114f80445bfbe692daeae21b91cb6eed5e16a29a201e4ee9adf3"
        "3c8d23a48ab3c35e16b1e3e976b398fcb1689dc815e9be21e9dbb4ebf8c6"
        "849db2e1ccd8d12e709795e211d4624de6997a1cdb129e636df8c81f9727"
        "ff4f6ffeaafcbeddcb5c15d532966d824829046ee8ff0276b65661ebc00b"
        "9fca674ece7bc23a4c7b40995ab1aa43318fc3002e7b5d4f3b2ab89894eb"
        "e78d45fe8b7412cf380e6fb81ea987ca550fa8f970f45d65424156182de1"
        "9521cecb5c7eb60b2778c78497d6148471a59a0a0a2a6177791356450a35"
        "c9408ab2ddff39dd440659baa0046035f2c3499de9f3e18693f933b191be"
        "b7f6e5f94442cc024dc2239443ab2a70e88b418b93786cdfa34d23f16700"
        "e37e365169e074d3b2a0c123fdb2bc25975974e83a6c0b4647a51e5fe22a"
        "bcb9293b2d54b7c32e213203d3236f3ddae0c7ca85e0bac4944f84ddaea6"
        "cb2a22961802b9a021cee594037ba7bd05b83c7ab081854efcbee26df661"
        "2447c66ac97b044772a1525c0a8b02872641088f3ff24e298ecb68070b17"
        "c7fafc0bb642a2c00d42defa6353b8343835356014bbd283559337f07de3"
        "0ccf58349d9be0a42bb41b4df745454a267700a76ed34784e590e47d26b8"
        "c1b3a7eb3feb41d7f04d582fa152f0de58d572521f000caf3c97a1c8ba04"
        "bab4a5b4e4e9889be7aa2ab4cb688c28666f99d0909243ec7059ce54a8cf"
        "7402ac1e19dfa623603b100c30b5451b63ab14340414cd31410b4d49d729"
        "f55a67a8eb6576d8acc34151d3899589b789336cadc78e4ec796d29399fc"
        "9978bcb651e53df1c2cd0d8ada635a373074402f9211ae78664bf02f9648"
        "c9937d6fc83f13ad7339df4ddfe82b154c80eea59e92ff8fcd38bd2b9265"
        "7eee84955cab051a937ce8f817559d8ce52259fcf3f53864b73fc17145bd"
        "4b445336b46f9a030c571eca4ff1e775780053fb442be87d1b0d4cf6e42b"
        "bba14765cf19ddde21628d2db1dc2eabd532df197cc3021779088afe4e01"
        "e8021b97f4282ad383480ffb3b09f440d6c48945665e737a4f484aa60b00"
        "8fe0df2e1aa12ecae5d506d9d789ba91ee2bd2672099fd3bb6765a5a8a43"
        "c70374c3f3818cba56ca31018fb6e32a5e2d5a562ecc81a7b68338a752cf"
        "e313126939818f012b568b4b18abe84fb33fd6171d4ed010c9f7f5b5bb6f"
        "994b83b5cf348c7a9834798adf0148e46da1ecdded23173bb86f70d441b0"
        "bac2661ea418703ec78a2bc27772b9b2d6efbe40e91f12734e2319045c24"
        "d2bf3e3a9e8689117e993b53c5dd1438e29313e5a8fa5faf4e99c2ef1ab1"
        "e3c313772072d3e616b54ccf28aff070361bd78b012dc6ee741732e36e2d"
        "d02c62c2a5cf04abc9a7acd9027d758feef7a374911cc8d2a2fab31aad7c"
        "2d6f987a60a94411ceea6fcd7dee97d86733e327f66e10ce332af3efef4a"
        "c92abd5abfed5fc71fcd455de4141baf809460e7960a6a27e3bb16c281e7"
        "6145b7f1ecb857c8b22195e2a83792a836951405c19798725fda7a6d1555"
        "f36ed7c5f073b9f203cec85a2416f56ca8bb678cbb3a3326075f87307424"
        "63261ff50ead2e9a077087bbeed03cd154ce046804cc3e13ec33da07b360"
        "fe09188e652bae8ec03c813b66201509c7e8bbeadde26154bde7f7b70e00"
        "fd24608ef23a92fb95516342beff9b87ad88708831e1d467f2e01f33cb03"
        "f76cbb0c8401e3492b7fee7d871e5ad079e112e95992604e43378935e434"
        "101ab2ebb00d4374188dc3e880bb787e7966476280650697054e70958c63"
        "5c575063490232c95ae0b5af4fce666def184269cde7aa8298bb1b37b5ba"
        "cd69d12650911b024f304a21f70f8775889e6b588fa5b14ffdf7e395ddf2"
        "f74e700c8c82d7c163f3adbff079451df607f4f950885a966c5869d6edc7"
        "1af1e70da57be7e599560c502c939b7101b531503c8bb493ebeb3c9685d1"
        "d1b6d214c470680f97230cdad6c8b1a31267d3952a5ad1a2020da6bad662"
        "78780578ec670a3803413b101a634e8284b59b7a81ea858ab42179ee247d"
        "0371d3a2e93a18d22b9584066b4794def6476f8d60d725c6065df66c49f4"
        "78b1394dd82e1c197703f70b685c937c0cbc24a502abb4e6948895d1290b"
        "d3b530612d66c600e3aea9f1d3ee29a6a0770350270d907cdc4ae6fef186"
        "15a8575e372b063833eb1a6c5275629ce579ac95f2d6c799959c98c73b14"
        "f8a98cdb99ef64add951cfe4012c9cacea7e2050e6a8a7c65367c30478c6"
        "1547febeb71635307aa07052adae8062b658d380ad1e76bc73f97fe6cf5e"
        "cf1e7896ed4cdc419d870903c2256ad8391285598dbfb321d462287f2a56"
        "568ca952d9b1d00a40f192cac204301bc52b2bc70c2a5114029341c06b6c"
        "ed4126bdb95da1ecc133a0512e9d7d4c7075875354be887089681d0c1eb3"
        "f9bca0eebbd375b7e35bbffc39c8333228678caf58d5db5422aa7443d485"
        "cb1bf1af3e46a64dbc3d659f868892d5ba41aefa42e4ac19fb47cbee0a4a"
        "5f621c4b5008c204fde3b762646b06766788e3e35e64c7e7b09e5f922183"
        "a9f717aa023f22fc47907925e2420e66e4afcf54e7fcf2e57255ee64569a"
        "17062e9b39517707857f8ffd022c31cba7c9a6938a92125dad4bdaaf56ff"
        "c885849796351543c63505429ea832a27143cfe2b256eae6e1e04ab362cb"
        "a1c321c36e1aa000c27b700d2229e4836f0555087c5f3df82313844589b6"
        "a7bafee1a1fc21ee274a22f174fca22c356253d34d6df6877ca8436797ce"
        "3408619e4f062bd5a0ea3ef4ded46500c403bfec710dd8615ee56d901773"
        "9614140b1d69e1bb46c6ce74fff066d37cc4a807d424dbef0e06c8060b9d"
        "cb1ab089e3ac2a5e6a2047befe6bf7654251a7835932863eec7043380545"
        "7f5d12bc3d72c1bd8b9036cd025db536a096f28aa0479de97a737f833697"
        "4b8ea741cb2de1839d5173b5a9b6202f4049c60f818180084813c08090ea"
        "54f011ba863e2f7478b6584925ef49e20d8b6b59b2c98b8c1c4eab918828"
        "315a88222034eab0245a08e639b370cf3304ec3215bd3ce8c78685bed913"
        "bd3601be37fc10cbea8467f1486735d9a8290d2450b3fec668aed3cb789e"
        "17e9d25643547dee238ec120f596aeee9d75cfe48dda505e446465a40baa"
        "b42704eceadd0a4f63b179e94ec8815789428303070b73ab67d212e6a161"
        "1af89f91a9d965341626376f105420be3d1632a99857bf4571729d4a1a9b"
        "1363c582f4c6dda0ee5414e19284fdf1f5b48a9e834adf14fcd950f4778e"
        "caa49b047c0f52f23ef78fe92a30202be573a3d522cd28b11ca96c727989"
        "49b9c18c294b2b172e8c8f5309484256abe046cafdee9c430457c8e0ed7c"
        "7830ce8ef077eacd8313809491349458c3eb2b39276c28c93b6022e11cb2"
        "ce425bd40245b9688cc9f45219db427359d02c0cb2e01488318f4cbec032"
        "b996dd138b0b8c3dd3a4c84ce61b5c5959a6b1363994630ca1cefbcc478d"
        "ee634c71b51e56e7e44583e195621f208af84769ef3f3a4a97317878b25e"
        "cb796ff81342f470d7a0b7d2815e9d643c3ff9f5757cd2ce83b55b7694c7"
        "a7fbc5a54f4c8988deca8c6afd81f0ebc0e0288a08833d777f87b9da0b96"
        "0132dfeed7f417ed417f0ea272a734f166a55c3cad32f3778fc5612b6e25"),
}


# -- serving (slice 12) -------------------------------------------------------

#: sizes of the serve phase: the wave-against-solo check (16 jobs of the
#: mix through 8 slots; the solo runs split over ``solo_children``
#: child processes), the serving run (the JAX ``--serve`` mix and queue
#: rule, 256 slots; cut from 1024 jobs to ``run_jobs``, one full wave
#: (512, two waves, until the report phase came),
#: and from the median of 3 to ``reps`` timed passes, for the script's
#: time: PERF.md section 4; ``chip_smoke.py --serve-run 1024`` runs the
#: whole mix alone), the one-slot baseline (the first ``base_jobs``
#: jobs of the mix, cut from 64 to 4, one of each workload, and to 2 for
#: the report phase's time; one timed pass
#: and no warm pass, the serving run having drawn their traces) and the
#: daemon soak (two job shapes, ``rate`` jobs/s each for ``window_s``
#: seconds, cut from 10 to 5 for the script's time, to 3 for the report
#: phase's)
SERVE = dict(nodes=32, trace_len=32, chunk=32, check_jobs=16, check_slots=8,
             solo_children=2, run_jobs=256, run_slots=256, reps=1,
             profile=16, base_jobs=2, small=16, rate=50.0,
             window_s=3.0, daemon_slots=256, daemon_chunk=16,
             soak_timeout_s=300.0, child_timeout_s=400.0, cpu_threads=2)


def exact_solo(cfg, state, chunk: int, max_cycles: int = 100_000):
    """A job run alone to quiescence, stopping exactly where it quiesces
    (the wave freezes a job at that cycle): ``chunk`` cycles between
    host reads, the last chunk again a cycle at a time
    (``run_chunked_to_quiescence`` at chunk 1)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    while True:
        nxt = step.run_cycles(cfg, state, chunk)
        if bool(nxt.quiescent()) or int(nxt.cycle) >= max_cycles:
            break
        state = nxt
    return step.run_chunked_to_quiescence(cfg, state, 1, max_cycles)


def serve_child(spec_path: str) -> int:
    """A child process of the serve phase. Task "serve_cpu": the check's
    ``serve`` with --cpu (device "cpu") under a VirtualClock into "out",
    its doc written to "result". Task "solo": the check jobs of indices
    ``part`` mod ``parts`` each alone on the card (``exact_solo``), their
    leaves (``convert.sim_numpy_leaves``) written to "result" (npz, one
    key a job and leaf)."""
    import numpy as np
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert, serve
    from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import (
        VirtualClock)
    with open(spec_path) as f:
        spec = json.load(f)
    S = spec["sizes"]
    torch.set_num_threads(S["cpu_threads"])
    specs = serve.mixed_jobs(S["check_jobs"], S["nodes"], S["trace_len"])
    if spec["task"] == "serve_cpu":
        doc = serve.serve(specs, slots=S["check_slots"], chunk=S["chunk"],
                          clock=VirtualClock(), out_dir=spec["out"],
                          device="cpu")
        with open(spec["result"], "w") as f:
            f.write(json.dumps(doc, indent=2))
        return 0
    out = {}
    for s in specs[spec["part"]::spec["parts"]]:
        cfg = serve.job_config(s)
        s0 = st.init_state(cfg, instr_arrays=serve.build_job_arrays(
            cfg, s, "cuda"), device="cuda")
        for k, v in convert.sim_numpy_leaves(
                exact_solo(cfg, s0, S["chunk"])).items():
            out[f"{s.name}__{k}"] = v
    np.savez(spec["result"], **out)
    return 0


def _serve_children(tmp: str) -> list:
    """The serve phase's child processes, all started together: the
    --cpu serve and SERVE["solo_children"] parts of the solo runs;
    [(process, result path, log path)]."""
    import os
    kids = []
    parts = SERVE["solo_children"]
    for task, part in [("serve_cpu", 0)] + [("solo", k)
                                            for k in range(parts)]:
        name = f"{task}{part}"
        result = os.path.join(tmp, f"{name}.result"
                              + (".npz" if task == "solo" else ".json"))
        spec = os.path.join(tmp, f"{name}.spec.json")
        with open(spec, "w") as f:
            json.dump({"task": task, "part": part, "parts": parts,
                       "sizes": SERVE, "result": result,
                       "out": os.path.join(tmp, "cpu_out")}, f)
        log = open(os.path.join(tmp, f"{name}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.serve_child(sys.argv[1]))", spec],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
            stderr=subprocess.STDOUT)
        kids.append((proc, result, log.name))
        log.close()
    return kids


def _wait_kids(kids: list, timeout: float) -> None:
    """Wait for every child (killing the rest on a failure or at the
    timeout)."""
    try:
        deadline = time.perf_counter() + timeout
        for proc, _, log in kids:
            try:
                rc = proc.wait(timeout=max(1.0,
                                           deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"serve child timed out after "
                                   f"{timeout:.0f} s")
            if rc != 0:
                with open(log) as f:
                    tail = f.read()[-2000:]
                raise SmokeFailure(f"serve child exited {rc}: {tail}")
    finally:
        for proc, _, _ in kids:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _serve_check_on_card(tmp: str, card: str):
    """The check's 16 jobs through 8 slots on the card under a
    VirtualClock with --out-dir; every wave's batch captured (host copy)
    for the leaf comparison. Returns (doc, waves)."""
    import os
    from ue22cs343bb1_openmp_assignment_tpu_torch import serve
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import (
        VirtualClock)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    S = SERVE
    specs = serve.mixed_jobs(S["check_jobs"], S["nodes"], S["trace_len"])
    captured = []
    real = step.run_wave_to_quiescence

    def capture(*a, **kw):
        out = real(*a, **kw)
        captured.append(serve.host_state(out))
        return out
    step.run_wave_to_quiescence = capture
    try:
        t0 = time.perf_counter()
        doc = serve.serve(specs, slots=S["check_slots"], chunk=S["chunk"],
                          clock=VirtualClock(),
                          out_dir=os.path.join(tmp, "card_out"),
                          device="cuda")
        wall = time.perf_counter() - t0
    finally:
        step.run_wave_to_quiescence = real
    if doc["jobs_quiesced"] != len(specs) or len(captured) != \
            doc["wave_count"]:
        raise SmokeFailure(f"serve check: {doc['jobs_quiesced']}/"
                           f"{len(specs)} quiesced, {len(captured)} waves "
                           f"captured of {doc['wave_count']}")
    say("serve", f"{len(specs)} jobs of the mix at {S['nodes']} x "
        f"{S['trace_len']} through {S['check_slots']} slots, chunk "
        f"{S['chunk']}, on the card: {doc['wave_count']} waves, "
        f"{wall:.2f} s ({card})")
    return doc, captured


def _mid_wave_swap(card: str) -> None:
    """Two copies of one batch stepped chunk by chunk in lockstep, one
    with a ``set_state`` swap of slot 3 after two chunks: every other
    slot's leaves stay equal, chunk after chunk."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import serve
    from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    S, dev = SERVE, "cuda"
    specs = serve.mixed_jobs(S["check_slots"] + 1, S["nodes"],
                             S["trace_len"])
    cfg = serve.slot_config(specs)
    states = [serve.build_job_state(cfg, cfg, s, dev) for s in specs[:-1]]
    a, b = st.stack_states(states), st.stack_states(states)
    swap = min(3, S["check_slots"] - 1)
    keep = [i for i in range(S["check_slots"]) if i != swap]
    for k in range(5):
        if k == 2:
            b = st.set_state(b, swap, serve.build_job_state(cfg, cfg,
                                                            specs[-1], dev))
        a = step.run_wave_chunk(cfg, a, S["chunk"])[0]
        b = step.run_wave_chunk(cfg, b, S["chunk"])[0]
        for name, x, y in zip(st.SIM_LEAVES, st.state_leaves(a),
                              st.state_leaves(b)):
            if not (x[keep] == y[keep]).all():
                raise SmokeFailure(f"serve swap: leaf {name} of a neighbour "
                                   f"changed after chunk {k}")
    say("serve", f"mid-wave set_state swap of slot {swap} after 2 of 5 "
        f"chunks: the other {len(keep)} slots' leaves equal to the "
        f"unswapped batch's after every chunk ({card})")


def _bench_serve(argv: list) -> dict:
    """``bench.main(["--serve", ...])`` in this process: its JSON line."""
    import contextlib
    import io
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(argv + ["--device", "cuda"])
    if rc != 0:
        raise SmokeFailure(f"bench {' '.join(argv)}: exit {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _reference_digest(shape: str, seed: int) -> str:
    k = SERVE_REFERENCE["hex"]
    if seed >= SERVE_REFERENCE["jobs"][shape]:
        raise SmokeFailure(f"serve: no reference for {shape} seed {seed}")
    return SERVE_REFERENCE[shape][seed * k:(seed + 1) * k]


def _serve_figures(d: dict) -> str:
    prof = d.get("profile") or {}
    solo = d.get("profile_solo") or {}
    peak = d["peak_device_bytes"]
    warm = d["warm_s"] is not None
    return (f"{d['jobs_per_sec']:.3f} jobs/sec (median of "
            f"{len(d['reps_s'])} timed passes, "
            + (f"after one warm pass of {d['warm_s']:.2f} s" if warm else
               "no warm pass")
            + f"), padding_waste {d['padding_waste']:.4f}, {d['waves']} "
            f"waves, {d['wave_cycles']} wave cycles, "
            f"{d['ms_per_wave_cycle']:.3f} ms a wave cycle; device launches "
            f"a wave cycle {prof.get('device_launches_per_round', 0):.1f} "
            f"against {solo.get('device_launches_per_round', 0):.1f} a solo "
            f"cycle (busy {prof.get('device_busy_ms_per_round', 0):.4f} / "
            f"{solo.get('device_busy_ms_per_round', 0):.4f} ms, idle share "
            f"{prof.get('device_idle_share', 0):.3f}); threefry launches "
            + (f"{d['launches_warm']['threefry']} in the warm pass, "
               if warm else "")
            + f"{d['launches']['threefry']} in a timed one; peak device "
            f"memory {(peak or 0) / 2**20:.1f} MiB")


def _serve_common() -> list:
    S = SERVE
    return (["--serve", "--nodes", str(S["nodes"]), "--trace-len",
             str(S["trace_len"]), "--chunk", str(S["chunk"])]
            + (["--profile", str(S["profile"])] if S["profile"] else []))


def _serve_run(tmp: str, card: str, jobs: int, reps: int) -> dict:
    """The serving run through the port's bench (the JAX ``--serve`` mix
    and queue rule, SERVE["run_slots"] slots, ``jobs`` jobs, one warm
    pass then the median of ``reps``); every job's digest, from the warm
    pass's --serve-out-dir files, equal to SERVE_REFERENCE."""
    import os
    from ue22cs343bb1_openmp_assignment_tpu_torch import serve
    S = SERVE
    shape = f"{S['nodes']}x{S['trace_len']}"
    out = os.path.join(tmp, "run_out")
    d = _bench_serve(_serve_common() + [
        "--serve-slots", str(S["run_slots"]), "--serve-jobs", str(jobs),
        "--reps", str(reps), "--serve-out-dir", out])
    if d["jobs_quiesced"] != jobs or d["mb_dropped"]:
        raise SmokeFailure(f"serve run: {d['jobs_quiesced']} quiesced, "
                           f"{d['mb_dropped']} dropped")
    _check_launches("serve run (warm)", d["launches_warm"],
                    {"threefry": ">0"})
    _check_launches("serve run (timed)", d["launches"], {})
    bad = []
    for s in serve.mixed_jobs(jobs, S["nodes"], S["trace_len"]):
        with open(os.path.join(out, s.name, "metrics.json")) as f:
            metrics = json.load(f)["metrics"]
        got = serve.job_digest(serve.read_job_dumps(os.path.join(
            out, s.name), S["nodes"]), metrics)
        if got[:SERVE_REFERENCE["hex"]] != _reference_digest(shape, s.seed):
            bad.append(s.name)
    if bad:
        raise SmokeFailure(f"serve run: {len(bad)} job digests differ from "
                           f"SERVE_REFERENCE: {bad[:8]}")
    say("serve", f"serving run, serve.mixed_jobs({jobs}, {S['nodes']}, "
        f"{S['trace_len']}) through {S['run_slots']} slots, chunk "
        f"{S['chunk']}, queue capacity 64 (bench --serve): all {jobs} "
        f"jobs' digests equal to SERVE_REFERENCE (the JAX package's "
        f"serve); " + _serve_figures(d) + f" ({card})")
    return d


def _serve_baseline(card: str) -> dict:
    """The one-slot baseline through the port's bench: the first
    SERVE["base_jobs"] jobs of the mix, their traces drawn by the
    serving run before it, so one timed pass and no warm pass."""
    S = SERVE
    b = _bench_serve(_serve_common() + [
        "--serve-slots", "1", "--serve-jobs", str(S["base_jobs"]),
        "--reps", "1", "--serve-no-warm"])
    if b["jobs_quiesced"] != S["base_jobs"]:
        raise SmokeFailure(f"serve baseline: {b['jobs_quiesced']} quiesced")
    _check_launches("serve baseline", b["launches"], {})
    say("serve", f"one-slot baseline over the first {S['base_jobs']} jobs "
        f"(bench --serve --serve-slots 1 --serve-no-warm): "
        + _serve_figures(b) + f" ({card})")
    return b


def _daemon_arrivals() -> list:
    """The daemon soak's open-loop stream: ``soak_stream`` at
    SERVE["rate"] jobs/s of each job shape (16 x 16, seed 0, and 32 x
    32, seed 1) over SERVE["window_s"] seconds, the names prefixed by
    their shape."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import soak
    S = SERVE
    out = []
    for seed, n in ((0, S["small"]), (1, S["nodes"])):
        for t, spec in soak.soak_stream(S["rate"], S["window_s"], nodes=n,
                                        trace_len=n, seed=seed):
            out.append((t, dataclasses.replace(spec,
                                               name=f"s{n}.{spec.name}")))
    return sorted(out, key=lambda a: (a[0], a[1].name))


def _start_daemon(tmp: str):
    """``cache-sim-torch daemon`` in a child process on a unix socket
    under ``tmp`` (both lanes, SERVE["daemon_slots"] slots a bucket),
    given one warm-up job of each soak shape: (process, socket)."""
    import os
    from ue22cs343bb1_openmp_assignment_tpu_torch import serve
    from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.client import (
        DaemonClient)
    S = SERVE
    sock = os.path.join(tmp, "daemon.sock")
    argv = [sys.executable, "-m", "ue22cs343bb1_openmp_assignment_tpu_torch.cli",
            "daemon", "--addr", sock, "--slots", str(S["daemon_slots"]),
            "--chunk", str(S["daemon_chunk"]), "--keep-dumps", "--retain",
            "4096", "--quiet"]
    log = open(os.path.join(tmp, "daemon.log"), "w")
    proc = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=log, stderr=subprocess.STDOUT)
    log.close()
    try:
        with DaemonClient(sock) as c:
            c.wait_up(timeout_s=60.0)
            for n in (S["small"], S["nodes"]):
                c.submit(serve.JobSpec(name=f"warm{n}", nodes=n,
                                       trace_len=n), lane="batch")
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    return proc, sock


def _serve_daemon(proc, sock: str, card: str) -> None:
    """The daemon soak: the warm-up jobs done, the open-loop
    ``soak_daemon`` stream of two shapes (so the daemon keeps two
    buckets). Every result's digest equals SERVE_REFERENCE; ``stats``
    passes validate_daemon_stats and ``top`` validate_fleet; drain, then
    shut down. A hang fails through the soak's timeout."""
    import contextlib
    import io
    from ue22cs343bb1_openmp_assignment_tpu_torch import cli, serve, soak
    from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.client import (
        DaemonClient)
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import schema
    S = SERVE
    try:
        arrivals = _daemon_arrivals()
        with DaemonClient(sock) as c:
            for n in (S["small"], S["nodes"]):
                if c.wait(f"warm{n}", timeout_s=120.0)["status"] != "done":
                    raise SmokeFailure("serve daemon: warm-up job not done")
        t0 = time.perf_counter()
        doc = soak.soak_daemon(arrivals, sock, arrival_rate=2 * S["rate"],
                               timeout_s=S["soak_timeout_s"])
        wall = time.perf_counter() - t0
        bad, done = [], 0
        with DaemonClient(sock) as c:
            for _, spec in arrivals:
                r = c.result(spec.name)
                if r.get("status") != "done":
                    continue
                done += 1
                got = serve.job_digest(r["dumps"], r["metrics"])
                if got[:SERVE_REFERENCE["hex"]] != _reference_digest(
                        f"{spec.nodes}x{spec.trace_len}", spec.seed):
                    bad.append(spec.name)
            stats = schema.validate_daemon_stats(c.stats())
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["top", sock, "--once", "--json"])
        fleet = schema.validate_fleet(json.loads(buf.getvalue()))
        with DaemonClient(sock) as c:
            drained = c.drain()
            c.shutdown()
        rc_d = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rejected = len(doc["rejected"])
    if (bad or done != len(arrivals) - rejected or rc != 0 or rc_d != 0
            or not drained.get("drained") or doc["jobs_quiesced"] != done
            or fleet["jobs"]["done"] != stats["jobs"]["done"]):
        raise SmokeFailure(f"serve daemon: {len(bad)} digests differ "
                           f"({bad[:6]}), {done} done of {len(arrivals)} - "
                           f"{rejected} rejected, top rc {rc}, daemon exit "
                           f"{rc_d}, drain {drained}")
    lat = doc["latency"]
    say("serve", f"daemon (child process, unix socket, lanes interactive "
        f"and batch, {S['daemon_slots']} slots a bucket, chunk "
        f"{S['daemon_chunk']}): open-loop soak_daemon of {len(arrivals)} "
        f"jobs ({S['rate']:g} jobs/s of each of {S['small']} x {S['small']}"
        f" and {S['nodes']} x {S['nodes']} over {S['window_s']:g} s) in "
        f"{wall:.2f} s: every one of the {done} results' digests equal to "
        f"SERVE_REFERENCE; client-observed p50 {lat['p50_ms']:.1f} ms, p95 "
        f"{lat['p95_ms']:.1f} ms, p99 {lat['p99_ms']:.1f} ms; rejected "
        f"{rejected}; buckets "
        f"{[b['bucket'] for b in stats['buckets']]}, bucket growths "
        f"{stats['bucket_growths']}, mid-wave swaps "
        f"{stats['mid_wave_swaps']}, {stats['chunks']} chunks, busy "
        f"{stats['busy_s']:.2f} s, drain rate "
        f"{stats['drain_rate_jobs_per_s']:.2f} jobs/s, padding_waste "
        f"{stats['padding_waste']:.4f} (one shape: "
        f"{stats['single_shape_padding_waste']:.4f}); stats valid, top "
        f"valid ({fleet['replicas']} replica); drained and shut down, exit "
        f"0 ({card})")


def phase_serve(card: str) -> None:
    """The serving layer on the card (slice 12): the wave against solo
    runs and against --cpu, a mid-wave swap, the serving run and its
    one-slot baseline through the bench, and the daemon."""
    import os
    import tempfile
    import numpy as np
    from ue22cs343bb1_openmp_assignment_tpu_torch import convert
    from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
    t0 = time.perf_counter()
    S = SERVE
    with tempfile.TemporaryDirectory() as tmp:
        kids = _serve_children(tmp)
        daemon = None
        try:
            daemon = _start_daemon(tmp)
            doc, waves = _serve_check_on_card(tmp, card)
            _mid_wave_swap(card)
            _wait_kids(kids, S["child_timeout_s"])
            # the measured runs start once the children are done
            _serve_run(tmp, card, S["run_jobs"], S["reps"])
            _serve_baseline(card)
            _serve_daemon(*daemon, card)
        finally:
            for proc in [k[0] for k in kids] + ([daemon[0]] if daemon
                                                else []):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        # the card's serve doc and files against the --cpu child's
        with open(kids[0][1]) as f:
            cpu_doc = f.read()
        if json.dumps(doc, indent=2) != cpu_doc:
            raise SmokeFailure("serve: the card's serve doc differs from "
                               "--cpu's")
        fa, fb = _files(os.path.join(tmp, "card_out")), _files(
            os.path.join(tmp, "cpu_out"))
        if sorted(fa) != sorted(fb) or any(fa[k] != fb[k] for k in fa):
            raise SmokeFailure("serve: card and --cpu --out-dir files "
                               "differ")
        # every leaf of every extracted job against its solo run
        solo = {}
        for _, result, _ in kids[1:]:
            with np.load(result) as z:
                solo.update({k: z[k] for k in z.files})
        for span in doc["trace"]["spans"]:
            got = convert.sim_numpy_leaves(st.index_state(
                waves[span["wave"] - 1], span["slot"]))
            for k, v in got.items():
                if not np.array_equal(v, solo[f"{span['job']}__{k}"]):
                    raise SmokeFailure(f"serve: {span['job']} leaf {k} "
                                       "differs from its solo run")
        say("serve", f"every leaf of the {len(doc['trace']['spans'])} "
            f"extracted jobs equal to its solo run on the card (a child "
            f"process; cycles {sorted(doc['jobs'][j]['cycles'] for j in doc['jobs'])}"
            f"); the serve doc and the {len(fa)} --out-dir files equal "
            f"to --cpu's (a child process), byte for byte ({card})")
    say("serve", f"serve phase took {time.perf_counter() - t0:.1f} s")


#: the history phase (slice 13): the bench history at deep@4096 (the
#: bench's defaults, ``reps`` timed runs each, twice), the read storm
#: (the bench at ``storm_trace_len`` instructions a node, cut from 4096
#: for the report phase's time; ``storm_rounds`` library rounds of the
#: kernel folds against the
#: plain folds, which cost 150-200 ms a launch), the recording
#: (``rec_jobs`` arrivals of serve.mixed_jobs at rec_nodes x
#: rec_trace_len, ``rec_gap_s`` apart, through ``rec_slots`` slots,
#: chunk ``rec_chunk``, on a VirtualClock) and continue_with_traces on
#: the async engine (cwt_nodes x cwt_trace_len, two phases, chunk
#: ``cwt_chunk``); the --cpu runs in child processes with
#: ``cpu_threads`` threads each; the phase itself runs in a child
#: process of its own, stopped after ``phase_timeout_s``
HISTORY = dict(reps=3, storm_rounds=16, storm_trace_len=1024, rec_jobs=16,
               rec_nodes=32,
               rec_trace_len=32, rec_slots=8, rec_chunk=16, rec_gap_s=0.005,
               cwt_nodes=256, cwt_trace_len=64, cwt_chunk=64,
               cpu_threads=1, child_timeout_s=400.0,
               phase_timeout_s=600.0)


def history_arrivals() -> list:
    """The recorded stream: serve.mixed_jobs (uniform, false_sharing,
    producer_consumer, hotspot; seed i) at HISTORY["rec_gap_s"] apart,
    alternating over the interactive and batch lanes, named ``rec.*``
    (a name of its own: the serve phase's jobs of the same mix have had
    their traces drawn in this process, and the replay must draw its
    own)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import serve
    H = HISTORY
    specs = serve.mixed_jobs(H["rec_jobs"], nodes=H["rec_nodes"],
                             trace_len=H["rec_trace_len"])
    return [(i * H["rec_gap_s"], dataclasses.replace(s, name=f"rec.{s.name}"),
             ("interactive", "batch")[i % 2]) for i, s in enumerate(specs)]


def continue_run(device) -> tuple:
    """continue_with_traces on the async engine: the bench's async
    config at HISTORY["cwt_nodes"], phase 1 the ``uniform`` traces of
    seed 0 to quiescence, phase 2 those of seed 1 swapped in and run to
    quiescence; (leaves after phase 1, leaves after phase 2, cycles of
    each phase)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench, convert
    from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    H = HISTORY
    cfg = bench.async_config(H["cwt_nodes"], H["cwt_trace_len"])

    def machine(seed):
        return CoherenceSystem.from_workload(cfg, "uniform", seed=seed,
                                             device=device,
                                             local_frac=0.8).state
    s1 = step.run_chunked_to_quiescence(cfg, machine(0), H["cwt_chunk"],
                                        100_000)
    nxt = machine(1)
    s2 = st.continue_with_traces(cfg, s1, instr_arrays=(
        nxt.instr_op, nxt.instr_addr, nxt.instr_val, nxt.instr_count))
    s2 = step.run_chunked_to_quiescence(cfg, s2, H["cwt_chunk"], 100_000)
    if not (bool(s1.quiescent()) and bool(s2.quiescent())):
        raise SmokeFailure("continue_with_traces: a phase did not quiesce")
    c1 = int(s1.metrics.cycles)
    return (convert.sim_numpy_leaves(s1), convert.sim_numpy_leaves(s2),
            c1, int(s2.metrics.cycles) - c1)


def history_child(spec_path: str) -> int:
    """A child process of the history phase. Task "record": the
    recording on the card (a DaemonCore with a RecordingWriter, driven
    by ``daemon.core.drive`` on a VirtualClock) into "rec". Task
    "replay_cpu": ``cache-sim-torch replay REC --cpu --out OUT``. Task
    "continue_cpu": ``continue_run`` on the CPU, its leaves written to
    "result" (npz)."""
    import numpy as np
    import torch
    with open(spec_path) as f:
        spec = json.load(f)
    H = spec["sizes"]
    if spec["task"] == "record":
        from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.core import (
            DaemonCore, attach_recorder, drive)
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import (
            VirtualClock)
        core = DaemonCore(slots=H["rec_slots"], chunk=H["rec_chunk"],
                          clock=VirtualClock(), device="cuda")
        attach_recorder(core, spec["rec"])
        drive(core, history_arrivals())
        core.recorder.close()
        return 0 if core.recorder.results == H["rec_jobs"] else 1
    torch.set_num_threads(H["cpu_threads"])
    if spec["task"] == "replay_cpu":
        from ue22cs343bb1_openmp_assignment_tpu_torch import cli
        return cli.main(["replay", spec["rec"], "--cpu", "--out",
                         spec["out"]])
    one, two, c1, c2 = continue_run("cpu")
    np.savez(spec["result"], cycles=np.array([c1, c2]),
             **{f"p1__{k}": v for k, v in one.items()},
             **{f"p2__{k}": v for k, v in two.items()})
    return 0


def _history_child(tmp: str, task: str, **paths):
    """Start one history child: (process, result path, log path)."""
    import os
    spec = os.path.join(tmp, f"{task}.spec.json")
    result = os.path.join(tmp, f"{task}.result.npz")
    with open(spec, "w") as f:
        json.dump({"task": task, "sizes": HISTORY, "result": result,
                   **paths}, f)
    log = open(os.path.join(tmp, f"{task}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.history_child(sys.argv[1]))", spec],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
        stderr=subprocess.STDOUT)
    log.close()
    return proc, result, log.name


def _bench_line(argv: list) -> tuple:
    """``bench.main(argv)`` on the card in this process: (its JSON line,
    every kernel's launches in its last timed run: the bench sets the
    counts to 0 before each of its runs)."""
    import contextlib
    import io
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    buf = io.StringIO()
    bench.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(argv + ["--device", "cuda"])
    launches = bench.launch_counts()
    if rc != 0:
        raise SmokeFailure(f"bench {' '.join(argv)}: exit {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1]), launches


def _bench_history(tmp: str, card: str) -> None:
    """Two recorded bench runs at deep@4096 and bench-diff of the two."""
    import contextlib
    import io
    import os
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (
        bench_diff, history)
    H = HISTORY
    path = os.path.join(tmp, "history.jsonl")
    lines = []
    for _ in range(2):
        # the line's launches are its timed run's: the call's also count
        # the round launches of the record's dispatch records
        line, _ = _bench_line(["--reps", str(H["reps"]), "--record", path])
        _check_launches("history: bench deep@4096", line["launches"],
                        {"round": ">0"})
        lines.append((line, line["launches"]))
    entries = history.load(path)
    for e in entries:
        history.validate_entry(e)
    if len(entries) != 2 or entries[0]["config"] != entries[1]["config"]:
        raise SmokeFailure("history: the two entries' fingerprints differ")
    if entries[0]["retired"] != entries[1]["retired"] or \
            entries[0]["steps"] != entries[1]["steps"]:
        raise SmokeFailure("history: instrs_retired differs between runs")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_diff.main_bench_diff(["--history", path, "--against-last",
                                         "--json"])
    if rc not in (0, 4):
        raise SmokeFailure(f"history: bench-diff --against-last exit {rc}")
    rep = json.loads(buf.getvalue())
    say("history", f"bench deep@4096 twice with --reps {H['reps']} --record: "
        "both entries valid (cache-sim/bench/v1.4), one fingerprint "
        f"({entries[0]['label']}, platform {entries[0]['config']['platform']}"
        f", device_kind {entries[0]['device_kind']!r}), "
        f"{entries[0]['retired']} instrs retired in {entries[0]['steps']} "
        f"rounds both; instrs/sec {lines[0][0]['instrs_per_sec']:.1f} / "
        f"{lines[1][0]['instrs_per_sec']:.1f}, ms/round "
        f"{lines[0][0]['ms_per_round']:.4f} / "
        f"{lines[1][0]['ms_per_round']:.4f}; bench-diff --against-last: "
        f"{rep['verdict'].upper()} (exit {rc}), medians "
        f"{rep['a']['median_s']} s -> {rep['b']['median_s']} s "
        f"({rep['delta_pct']:+.3f} %), p {rep['p']}; launches in a timed "
        f"run: round {lines[0][1]['round']}, {lines[1][1]['round']} "
        f"({card})")


def _read_storm(card: str) -> None:
    """``bench --read-storm`` (the fold path) and 16 library rounds of
    its config with the kernel folds against the plain folds."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench, convert
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    H = HISTORY
    line, launches = _bench_line(["--read-storm", "--reps", "1",
                                  "--trace-len", str(H["storm_trace_len"])])
    if line["fused_round"] or not line["config"]["read_storm"]:
        raise SmokeFailure("read storm: the bench did not take the fold "
                           "path with the storm on")
    _check_launches("read storm bench", launches,
                    {"pre": ">0", "flags": ">0", "replay": ">0"})
    cfg = bench.deep_config(BENCH["num_nodes"], read_storm=True)
    runs = {}
    for impl in ("kernel", "plain"):
        st0 = se.procedural_state(cfg, BENCH["trace_len"], device="cuda")
        bench.reset_launch_counts()
        runs[impl] = convert.numpy_leaves(
            se.run_rounds(cfg, st0, H["storm_rounds"], impl))
        counts = bench.launch_counts()
        if impl == "kernel":
            storm_launches = counts
        else:
            _check_launches("read storm, plain folds", counts, {})
    for k in runs["plain"]:
        if not (runs["plain"][k] == runs["kernel"][k]).all():
            raise SmokeFailure(f"read storm: leaf {k} after "
                               f"{H['storm_rounds']} rounds differs between "
                               "the kernel and the plain folds")
    say("history", f"bench --read-storm --reps 1 at deep@4096 x "
        f"{H['storm_trace_len']} (fold path): "
        f"{line['instrs_per_sec']:.1f} instrs/sec, {line['rounds']} rounds, "
        f"{line['ms_per_round']:.4f} ms/round; fold launches a run: pre "
        f"{launches['pre']}, flags "
        f"{launches['flags']}, replay {launches['replay']}; "
        f"{H['storm_rounds']} library rounds, kernel folds = plain folds, "
        f"every leaf (kernel folds: pre {storm_launches['pre']}, flags "
        f"{storm_launches['flags']}, replay {storm_launches['replay']}) "
        f"({card})")


def _replay_on_card(tmp: str, rec: str, card: str) -> dict:
    """``cache-sim-torch replay REC --out`` on the card: every digest
    matched; bench-diff --latency of its recorded and replayed entries."""
    import contextlib
    import io
    import os
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench, cli
    out = os.path.join(tmp, "card_replay")
    buf = io.StringIO()
    bench.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["replay", rec, "--out", out])
    wall = time.perf_counter() - t0
    launches = bench.launch_counts()
    if rc != 0:
        raise SmokeFailure(f"replay on the card: exit {rc}: "
                           f"{buf.getvalue()[-1000:]}")
    with open(os.path.join(out, "replay.json")) as f:
        doc = json.load(f)
    if doc["digests_matched"] != HISTORY["rec_jobs"] or \
            doc["digest_mismatches"]:
        raise SmokeFailure(f"replay on the card: {doc['digests_matched']} "
                           f"digests matched, mismatches "
                           f"{doc['digest_mismatches'][:4]}")
    _check_launches("replay on the card", launches, {"threefry": ">0"})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench-diff", "--latency",
                       os.path.join(out, "recorded.entry.json"),
                       os.path.join(out, "replayed.entry.json")])
    if rc not in (0, 4):
        raise SmokeFailure(f"replay: bench-diff --latency exit {rc}")
    lat = doc["latency"]
    say("history", f"replay of the recording (serve.mixed_jobs("
        f"{HISTORY['rec_jobs']}) at {HISTORY['rec_nodes']} x "
        f"{HISTORY['rec_trace_len']}, {HISTORY['rec_slots']} slots, chunk "
        f"{HISTORY['rec_chunk']}, VirtualClock) in process on the card: "
        f"{doc['jobs_quiesced']}/{doc['jobs_total']} quiesced, digests "
        f"{doc['digests_matched']}/{doc['recorded_jobs']} matched, "
        f"{doc['wave_count']} chunks, p50/p95 {lat['p50_ms']:.2f}/"
        f"{lat['p95_ms']:.2f} virtual ms, {wall:.2f} s wall; threefry "
        f"launches {launches['threefry']}; bench-diff --latency recorded "
        f"vs replayed: exit {rc} ({card})")
    return doc


def phase_history(card: str) -> None:
    """The history phase in a fresh interpreter (``history_main``): the
    host-bound bench and replay run up to half again slower at the end
    of this long-lived process than in a new one (PERF.md section 7). Its
    lines go to this process's stdout; a failure there fails here."""
    import os
    import signal
    t0 = time.perf_counter()
    # a process group of its own: a timeout stops its children too
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.history_main(sys.argv[1]))", card],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        start_new_session=True)
    try:
        rc = proc.wait(timeout=HISTORY["phase_timeout_s"])
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"history phase timed out after "
                           f"{HISTORY['phase_timeout_s']:.0f} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if rc != 0:
        raise SmokeFailure(f"history phase exited {rc}")
    say("history", f"history phase took {time.perf_counter() - t0:.1f} s "
        "(a child process)")


def history_main(card: str) -> int:
    """Bench history, the read-storm knob, recording replay and
    continue_with_traces on the card (slice 13); raises on a failure."""
    import os
    import tempfile
    import numpy as np
    t0 = time.perf_counter()
    H = HISTORY
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "rec")
        os.makedirs(rec)
        kids = [_history_child(tmp, "record", rec=rec),
                _history_child(tmp, "continue_cpu")]
        try:
            _bench_history(tmp, card)
            _read_storm(card)
            _wait_kids(kids[:1], H["child_timeout_s"])
            t_rec = time.perf_counter() - t0
            kids.append(_history_child(tmp, "replay_cpu", rec=rec,
                                       out=os.path.join(tmp, "cpu_replay")))
            doc = _replay_on_card(tmp, rec, card)
            t1 = time.perf_counter()
            one, two, c1, c2 = continue_run("cuda")
            t_cwt = time.perf_counter() - t1
            _wait_kids(kids[1:], H["child_timeout_s"])
        finally:
            for proc, _, _ in kids:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        with open(os.path.join(tmp, "cpu_replay", "replay.json")) as f:
            if json.load(f) != doc:
                raise SmokeFailure("replay: the card's replay document "
                                   "differs from --cpu's")
        with np.load(kids[1][1]) as z:
            if list(z["cycles"]) != [c1, c2]:
                raise SmokeFailure("continue_with_traces: cycles differ "
                                   "from the CPU's")
            for tag, leaves in (("p1", one), ("p2", two)):
                for k, v in leaves.items():
                    if not np.array_equal(v, z[f"{tag}__{k}"]):
                        raise SmokeFailure(f"continue_with_traces: {tag} "
                                           f"leaf {k} differs from --cpu")
        say("history", f"replay --cpu (a child process): the replay "
            "document equal to the card's; continue_with_traces, async "
            f"{H['cwt_nodes']} x {H['cwt_trace_len']} (uniform seed 0, "
            f"then seed 1), {c1} + {c2} cycles, {t_cwt:.1f} s on the card: "
            f"every leaf after each phase equal to --cpu's (a child "
            f"process); the recording (a child process, beside the bench "
            f"runs) was done at {t_rec:.1f} s ({card})")
    say("history", f"history work took {time.perf_counter() - t0:.1f} s")
    return 0


REPORT = dict(nodes=4096, trace_len=4096, small_nodes=256,
              small_trace_len=256, small_chunk=8, async_trace_len=512,
              shards=4, timing_reps=3, profile_rounds=32, warm_rounds=16,
              bench_reps=1, bench_trace_len=1024, cpu_threads=2,
              child_timeout_s=420.0,
              phase_timeout_s=600.0)


def report_argv(engine: str, nodes: int, trace_len: int, *extra) -> list:
    return ["perf-report", "--engine", engine, "--nodes", str(nodes),
            "--trace-len", str(trace_len), "--json", *extra]


def _report_doc(label: str, res: dict, card: str) -> dict:
    if res["rc"] != 0:
        raise SmokeFailure(f"report {label}: exit {res['rc']}, stderr "
                           f"{res['err'][-600:]} ({card})")
    return json.loads(res["out"])


def _per_step(doc: dict) -> dict:
    return next(k for k in doc["kernels"] if k["per_step"])


def _route_launches(engine: str, routed: bool) -> float:
    """Device launches a round (a cycle) that a torch.profiler window of
    REPORT["profile_rounds"] counts on the route perf-report attributes:
    its config and workload, REPORT["warm_rounds"] steps in."""
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench, cli
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import perf_report
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    R = REPORT
    cfg = perf_report.report_config(engine, R["nodes"])
    if routed:
        cfg = cli.kernel_routes(cfg, torch.device("cuda"))
    trace = R["trace_len"] if engine == "deep" else R["async_trace_len"]
    sysm = CoherenceSystem.from_workload(cfg, "uniform", trace_len=trace,
                                         seed=0, device="cuda")
    if engine == "async":
        st = step.run_cycles(cfg, sysm.state, R["warm_rounds"])
        prof = bench.profile_steps(lambda s: step.cycle(cfg, s), st,
                                   R["profile_rounds"])
    else:
        st = se.run_rounds(cfg, se.from_sim_state(cfg, sysm.state, seed=0),
                           R["warm_rounds"])
        prof = bench.profile_rounds(cfg, st, R["profile_rounds"], "kernel")
    return prof["device_launches_per_round"]


def _report_deep(tmp: str, card: str, cpu_kids: list,
                 card_kids: list) -> dict:
    """perf-report --engine deep at full width twice (the fold kernels),
    at 256 nodes card against --cpu (``cpu_kids``), then --pallas
    --timing (the fused round kernel), once the async report on the card
    (``card_kids``, whose result this returns) is done."""
    import os
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import perf_report
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_round_kernel as drk)
    R = REPORT
    N, T = R["nodes"], R["trace_len"]
    runs = [run_verb(report_argv("deep", N, T), os.path.join(tmp, f"d{i}"))
            for i in range(2)]
    docs = [_report_doc("deep", r, card) for r in runs]
    if runs[0]["out"] != runs[1]["out"]:
        raise SmokeFailure("report: two perf-report --engine deep runs "
                           "differ")
    ps = _per_step(docs[0])
    if ps["launches"] != {"pre": 1, "flags": 1, "replay": 1}:
        raise SmokeFailure(f"report: deep per-step record launched "
                           f"{ps['launches']}, want one of each fold mode")
    fold_prof = _route_launches("deep", False)
    say("report", f"perf-report --engine deep at {N} x {T} (the fold "
        f"path) twice: byte-identical documents; {docs[0]['steps']} rounds,"
        f" {docs[0]['retired']} retired; per-step record (sync.round_step):"
        f" launches {ps['launches']}, {ps['ops']} aten ops, "
        f"{ps['hbm_bytes']:.0f} HBM bytes, bytes/instr "
        f"{docs[0]['bytes_per_instr']}, bound "
        f"{docs[0]['bound']}; the profiler's device launches a round on "
        f"this route: {fold_prof:.1f}; runs {runs[0]['wall']:.1f} / "
        f"{runs[1]['wall']:.1f} s ({card})")
    small = run_verb(report_argv("deep", R["small_nodes"],
                                 R["small_trace_len"], "--chunk",
                                 str(R["small_chunk"])),
                     os.path.join(tmp, "d256"))
    card_doc = _report_doc("deep 256", small, card)
    cpu = _join_children(cpu_kids, R["child_timeout_s"])
    cpu_doc = _report_doc("deep 256 --cpu", cpu["deep256 cpu"], card)
    for key in ("steps", "retired", "config"):
        if card_doc[key] != cpu_doc[key]:
            raise SmokeFailure(f"report: deep {R['small_nodes']} {key} "
                               f"differs, card {card_doc[key]} vs --cpu "
                               f"{cpu_doc[key]}")
    a, b = _per_step(card_doc), _per_step(cpu_doc)
    say("report", f"perf-report --engine deep at {R['small_nodes']} x "
        f"{R['small_trace_len']}, chunk {R['small_chunk']}, card and --cpu "
        f"(a child process): steps {card_doc['steps']}, retired "
        f"{card_doc['retired']} and config equal; per-step record: card "
        f"{a['ops']} ops, {a['hbm_bytes']:.0f} HBM bytes, launches "
        f"{a['launches']} / CPU {b['ops']} ops, {b['hbm_bytes']:.0f} bytes, "
        f"launches {b['launches']} (the card's fold kernels replace plain "
        f"ops); --cpu child {cpu['deep256 cpu']['wall']:.1f} s ({card})")
    async_res = _join_children(card_kids, R["child_timeout_s"])["async"]
    res = run_verb(report_argv("deep", N, T, "--pallas", "--timing", "--reps",
                               str(R["timing_reps"])),
                   os.path.join(tmp, "dp"))
    doc = _report_doc("deep --pallas", res, card)
    ps = _per_step(doc)
    if ps["launches"] != {"round": 1} or not doc["config"]["pallas"]:
        raise SmokeFailure(f"report: --pallas per-step record launched "
                           f"{ps['launches']}, want one deep_round")
    io = next(k for k in doc["kernels"]
              if k["name"] == "deep.round_fused[io-contract]")
    want = sum(drk.io_contract_bytes(perf_report.report_config("deep", N)))
    if io["hbm_bytes"] != want:
        raise SmokeFailure(f"report: io-contract row {io['hbm_bytes']} != "
                           f"the wrapper's contract {want}")
    t = doc["timing"]
    fused_prof = _route_launches("deep", True)
    say("report", f"perf-report --engine deep --pallas --timing --reps "
        f"{R['timing_reps']} at {N} x {T} (the fused round): per-step "
        f"launches {ps['launches']}, {ps['ops']} aten ops, "
        f"{ps['hbm_bytes']:.0f} HBM bytes; io-contract row "
        f"{io['hbm_bytes']:.0f} B = sum(deep_round_kernel.io_contract_bytes)"
        f"; fused bytes/instr {doc['fused']['bytes_per_instr']} vs "
        f"{doc['bytes_per_instr']}; ns/instr {t['ns_per_instr']}, "
        f"measured/model {t.get('measured_over_model')}, dispatch_bound "
        f"{t['dispatch_bound']}; the profiler's device launches a round on "
        f"this route: {fused_prof:.1f} ({card})")
    return async_res


def report_async_argv() -> list:
    R = REPORT
    return report_argv("async", R["nodes"], R["async_trace_len"],
                       "--shards", str(R["shards"]))


def _report_async(card: str, res: dict) -> None:
    """The async report's checks on ``res``, the child's run_verb of
    ``report_async_argv()`` on the card (beside the deep reports: both
    host-bound, the card idle most of the time)."""
    R = REPORT
    doc = _report_doc("async", res, card)
    tr = doc.get("transport")
    if not tr or tr["n_shards"] != R["shards"] or \
            not tr["rdma_strictly_fewer"]:
        raise SmokeFailure(f"report: async transport row {tr}")
    ps = _per_step(doc)
    prof = _route_launches("async", False)
    say("report", f"perf-report --engine async at {R['nodes']} x "
        f"{R['async_trace_len']} --shards {R['shards']}: {doc['steps']} "
        f"cycles, {doc['retired']} retired; per-step record (step.cycle): "
        f"{ps['ops']} aten ops, {ps['hbm_bytes']:.0f} HBM bytes, launches "
        f"{ps['launches']}; bytes/instr {doc['bytes_per_instr']}; the "
        f"profiler's device launches a cycle: {prof:.1f}; transport row: "
        f"all_to_all {tr['bytes_per_round']['all_to_all']} vs rdma "
        f"{tr['bytes_per_round']['rdma']} B a round "
        f"({100 * tr['savings_frac']:.1f} % less); {res['wall']:.1f} s (a "
        f"child process, beside the deep reports) ({card})")


def _report_bench(tmp: str, card: str) -> str:
    """bench at deep@4096 (REPORT["bench_trace_len"] instructions a node:
    the --profile-dir trace of 4096 is ~190 MB) with the instruments and
    --record, twice; the entries' cost vectors equal and bench-diff
    --bytes exits 0. Returns the history path."""
    import contextlib
    import io
    import os
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (
        bench_diff, history, profiler)
    R = REPORT
    path = os.path.join(tmp, "report_history.jsonl")
    lines = []
    for i in range(2):
        pdir = os.path.join(tmp, f"prof{i}")
        line, _ = _bench_line([
            "--fused-round", "auto", "--kernel-costs", "--timer-check",
            "--profile-dir", pdir, "--record", path, "--reps",
            str(R["bench_reps"]), "--trace-len", str(R["bench_trace_len"])])
        kc = line["phases"]["kernels"]
        if not line["timer_check"]["barrier_trustworthy"]:
            raise SmokeFailure(f"report: bench timer check "
                               f"{line['timer_check']}")
        if not kc["available"] or kc["launches"] != {"round": 64}:
            raise SmokeFailure(f"report: --kernel-costs {kc}")
        trace = os.path.join(pdir, profiler.TRACE_FILE)
        with open(trace) as f:
            if "deep_round_kernel" not in f.read():
                raise SmokeFailure("report: the --profile-dir trace names "
                                   "no deep_round_kernel")
        size = os.path.getsize(trace)
        os.remove(trace)
        lines.append((line, size))
    entries = history.load(path)
    for e in entries:
        history.validate_entry(e)
    a, b = entries
    if a["cost"] != b["cost"] or a["hlo_fingerprint"] != \
            b["hlo_fingerprint"] or not a["cost"]["cost_available"]:
        raise SmokeFailure("report: the two recorded cost vectors differ")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_diff.main_bench_diff(["--history", path, "--against-last",
                                         "--bytes"])
    if rc != 0:
        raise SmokeFailure(f"report: bench-diff --bytes exit {rc}: "
                           f"{buf.getvalue()[-600:]}")
    per = a["cost"]["kernels"][a["cost"]["per_step_kernel"]]
    (l0, s0), (l1, s1) = lines
    say("report", f"bench deep@4096 x {R['bench_trace_len']} --fused-round "
        f"auto --kernel-costs --timer-check --profile-dir --record, --reps "
        f"{R['bench_reps']}, twice: instrs/sec {l0['instrs_per_sec']:.1f} / "
        f"{l1['instrs_per_sec']:.1f}; timer check: block "
        f"{l0['timer_check']['block_until_ready_s']} s, tail "
        f"{l0['timer_check']['device_get_tail_s']} s, trustworthy; "
        f"--kernel-costs (one chunk): {l0['phases']['kernels']['ops']} aten "
        f"ops, launches {l0['phases']['kernels']['launches']}, temp "
        f"{l0['phases']['kernels']['memory'].get('temp_size_in_bytes')} B; "
        f"traces {s0} / {s1} B naming deep_round_kernel; entries valid, "
        f"hlo_fingerprint {a['hlo_fingerprint']} both, bytes/instr "
        f"{a['cost']['bytes_per_instr']} both (per-step "
        f"{per['hbm_bytes']:.0f} B), bench-diff --bytes exit 0; round "
        f"launches in the timed run {l0['launches']['round']} ({card})")
    return path


def _report_dashboard(tmp: str, card: str, hist: str) -> None:
    """dashboard over the recorded history and the archives: the card's
    point in the roofline scatter; the archives alone render the golden
    files."""
    import os
    import torch
    root = os.path.dirname(os.path.abspath(__file__))
    archives = ([os.path.join(root, f"BENCH_r0{i}.json") for i in range(1, 6)]
                + [os.path.join(root, f"MULTICHIP_r0{i}.json")
                   for i in range(1, 7)])
    out = os.path.join(tmp, "dash")
    html, md = os.path.join(out, "d.html"), os.path.join(out, "d.md")
    res = run_verb(["dashboard", "--history", hist, *archives, "--html",
                    html, "--md", md], out)
    if res["rc"] != 0:
        raise SmokeFailure(f"report: dashboard exit {res['rc']}")
    with open(html) as f:
        page = f.read()
    kind = f"{torch.cuda.get_device_name(0)} (ridge 5.0 flop/B)"
    if kind not in page:
        raise SmokeFailure(f"report: the dashboard's roofline has no "
                           f"{kind!r}")
    res = run_verb(["dashboard", *archives, "--html", html, "--md", md], out)
    gold = {}
    for got, name in ((html, "dashboard.html"), (md, "dashboard.md")):
        with open(got, "rb") as f, open(os.path.join(
                root, "tests", "golden", name), "rb") as g:
            gold[name] = f.read() == g.read()
    if res["rc"] != 0 or not all(gold.values()):
        raise SmokeFailure(f"report: the archive-only dashboard differs "
                           f"from tests/golden: {gold}")
    say("report", f"dashboard over the recorded history and the archives: "
        f"the roofline scatter has the card's point ({kind}); the "
        f"archive-only render equals tests/golden/dashboard.html and .md "
        f"byte for byte ({card})")


def phase_report(card: str) -> None:
    """The report phase in a fresh interpreter (``report_main``), as the
    history phase runs. Its lines go to this process's stdout; a failure
    there fails here."""
    import os
    import signal
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.report_main(sys.argv[1]))", card],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        start_new_session=True)
    try:
        rc = proc.wait(timeout=REPORT["phase_timeout_s"])
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"report phase timed out after "
                           f"{REPORT['phase_timeout_s']:.0f} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if rc != 0:
        raise SmokeFailure(f"report phase exited {rc}")
    say("report", f"report phase took {time.perf_counter() - t0:.1f} s "
        "(a child process)")


def report_main(card: str) -> int:
    """perf-report, the bench's instruments and the dashboard on the card
    (slice 14); prints FAIL and exits 1 on a failure."""
    import os
    import tempfile
    t0 = time.perf_counter()
    R = REPORT
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kids = _start_children(tmp, [
                ([("deep256 cpu",
                   report_argv("deep", R["small_nodes"],
                               R["small_trace_len"], "--chunk",
                               str(R["small_chunk"]), "--cpu"),
                   os.path.join(tmp, "cpu256"))], R["cpu_threads"]),
                ([("async", report_async_argv(), os.path.join(tmp, "a"))],
                 None)])
            try:
                async_res = _report_deep(tmp, card, kids[:1], kids[1:])
            finally:
                for proc, _, _ in kids:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            _report_async(card, async_res)
            hist = _report_bench(tmp, card)
            _report_dashboard(tmp, card, hist)
    except (SmokeFailure, AssertionError, RuntimeError, ValueError,
            KeyError) as e:
        print(f"FAIL: report: {type(e).__name__}: {e}", flush=True)
        return 1
    say("report", f"report work took {time.perf_counter() - t0:.1f} s")
    return 0


# -- analyze (slice 15) -----------------------------------------------------

#: the table-protocol serving mix the phase runs (the defaults of
#: scripts/analyze_reference.py's --jobs/--nodes/--trace-len/--slots/
#: --chunk/--hex; a job's digest depends on neither its slot nor its
#: wave) and the oracle batches of its profiler window
ANALYZE = dict(jobs=16, nodes=16, trace_len=16, slots=16, chunk=16, hex=12,
               profile_batches=8)

#: the JAX package's ``cache-sim analyze --table --litmus`` report blocks
#: (sha256 of each under sort_keys, ``analysis.runner.block_digests``) and
#: the job digests of ``serve.mixed_jobs(16, 16, 16)`` under moesi and
#: mesif, from ``JAX_PLATFORMS=cpu python scripts/analyze_reference.py``
ANALYZE_REFERENCE = {
    "model_check": (
        "cfc48e4e706708681fe1279b7715de7cf0d07c3874c15b86ace33a97"
        "5bd0b3d4"),
    "table": (
        "c51a8a6b2c8161b4e153e189d03491bfe6dca337b3f33abdbcd41ec6"
        "22b93a2f"),
    "litmus": (
        "2b37ba7c4314eff40c9d61092cbd1e6f3fbe725a6345c4c8c98d71ca"
        "f65a3951"),
    "serve": {
        "moesi": (
            "97ed85b864c3d004ff2acc1d03035d909637ff85d107cbb89f086cd04701"
            "948d102d464fac9882db5d944082751203c9131096edd60913be73cf02df"
            "00a89e35c71352452f4ce98e0c4f829b587eae47e255ee6db0f0ebda2739"
            "8efb9710d8fd"),
        "mesif": (
            "28b7a28a93df485ffcb54ac2cb3acd18edf9ff85d107cbb825221dcddf2d"
            "b88c1b40cc56a69394cb18504082751203c9131096edd6093b1c226a4ee2"
            "6af1ed4e71bd52452f4ce98ead24c4688633201a7292afe6d5fbcc466231"
            "aab950438937"),
    },
}


def _analyze_json(tmp: str, label: str, argv: list) -> tuple:
    """``cache-sim-torch analyze ARGV --json`` in this process on the
    card: (exit code, report, wall seconds)."""
    import os
    from ue22cs343bb1_openmp_assignment_tpu_torch import cli
    path = os.path.join(tmp, f"{label}.json")
    t0 = time.perf_counter()
    rc = cli.main(["analyze", *argv, "-q", "--json", path])
    took = time.perf_counter() - t0
    with open(path) as fh:
        return rc, json.load(fh), took


def _oracle_profile(card: str) -> None:
    """Device launches, busy ms and idle share of one oracle batch (the
    64 staged transitions of a BFS level moved to the card, the vmapped
    ``step.cycle`` and the engagement probe, the read-back), for the
    handler phase and the MOESI table phase, over a torch.profiler
    window of ANALYZE["profile_batches"] batches."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
        conformance, litmus, model_check)
    scope = model_check.builtin_scopes()["4n1a_sym"]
    for label, sc, mp in (
            ("mesi handlers", scope, None),
            ("moesi table", conformance.variant_scope(scope, "moesi"),
             litmus.message_phase_for("moesi"))):
        ck = model_check.ModelChecker(sc, message_phase=mp)
        a0 = ck._a0
        evs = model_check.enabled_events(sc, a0)
        staged = [ck._stage(a0, evs[i % len(evs)])
                  for i in range(model_check._BATCH)]
        ck.step_batch(ck._batched(staged))
        prof = bench.profile_steps(
            lambda _: ck.step_batch(ck._batched(staged)), None,
            ANALYZE["profile_batches"])
        say("analyze", f"oracle batch ({label}, 64 transitions of "
            f"{sc.name}): {prof['device_launches_per_round']:.1f} device "
            f"launches, {prof['wall_ms_per_round']:.3f} ms wall under the "
            f"profiler, device busy {prof['device_busy_ms_per_round']:.4f} "
            f"ms, idle share {prof['device_idle_share']:.3f}; {card}")


def _analyze_serve(tmp: str, card: str) -> None:
    """The moesi and mesif mixes served on the card, every job's digest
    equal to ANALYZE_REFERENCE, the traces drawn through threefry."""
    import os
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench, serve
    A = ANALYZE
    for proto in ("moesi", "mesif"):
        specs = serve.mixed_jobs(A["jobs"], nodes=A["nodes"],
                                 trace_len=A["trace_len"], protocol=proto)
        out = os.path.join(tmp, proto)
        bench.reset_launch_counts()
        t0 = time.perf_counter()
        doc = serve.serve(specs, slots=A["slots"], chunk=A["chunk"],
                          queue_capacity=64, out_dir=out)
        took = time.perf_counter() - t0
        _check_launches(f"analyze serve {proto}", bench.launch_counts(),
                        {"threefry": ">0"})
        got = "".join(serve.job_digest(
            serve.read_job_dumps(os.path.join(out, s.name), A["nodes"]),
            doc["jobs"][s.name]["metrics"])[:A["hex"]] for s in specs)
        if doc["jobs_quiesced"] != A["jobs"]:
            raise SmokeFailure(f"analyze serve {proto}: "
                               f"{doc['jobs_quiesced']} of {A['jobs']} "
                               "jobs quiesced")
        if got != ANALYZE_REFERENCE["serve"][proto]:
            raise SmokeFailure(f"analyze serve {proto}: job digests differ "
                               "from ANALYZE_REFERENCE")
        say("analyze", f"serve {A['jobs']} {proto} jobs "
            f"({A['nodes']} x {A['trace_len']}, {A['slots']} slots, "
            f"{len(doc['waves'])} waves) on the card: every digest equal "
            f"to the JAX package's, {took:.2f} s wall; {card}")


def phase_analyze(card: str) -> None:
    """``cache-sim-torch analyze --table --litmus --json`` on the card
    (iriw included), its report blocks equal to the JAX package's
    (ANALYZE_REFERENCE) and no port kernel launched; each handler
    mutation, a table and a consistency mutation caught with the JAX
    package's finding; an oracle batch under the profiler; the moesi and
    mesif serving mixes."""
    import tempfile
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
        mutations, runner)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        bench.reset_launch_counts()
        rc, doc, took = _analyze_json(tmp, "gate", ["--table", "--litmus"])
        _check_launches("analyze", bench.launch_counts(), {})
        if rc != 0 or not doc["ok"]:
            raise SmokeFailure(f"analyze --table --litmus exited {rc}")
        got = runner.block_digests(doc)
        for block, digest in got.items():
            if digest != ANALYZE_REFERENCE[block]:
                raise SmokeFailure(f"analyze: the {block} block differs "
                                   "from the JAX package's report")
        states = doc["litmus"]["mesi"]["iriw"]["stats"]["states"]
        say("analyze", f"analyze --table --litmus on the card: exit 0, "
            f"blocks {', '.join(got)} equal to the JAX package's (iriw "
            f"{states} states), 0 lint findings, {took:.2f} s wall; "
            + "; ".join(f"{k} {p['seconds']:.2f} s, {p['oracle_batches']} "
                        f"oracle batches"
                        for k, p in doc["prongs"].items()) + f"; {card}")
        t1 = time.perf_counter()
        for name, (_, scope, expected) in mutations.MUTATIONS.items():
            rc, doc, _ = _analyze_json(tmp, name, ["--mutation", name,
                                                   "--skip-lint"])
            found = [v["name"] for v in doc["model_check"][scope]
                     ["violations"]]
            if rc != 1 or expected not in found:
                raise SmokeFailure(f"analyze --mutation {name}: exit {rc}, "
                                   f"findings {found}, want {expected}")
        rc, doc, _ = _analyze_json(tmp, "table", [
            "--table", "--skip-model-check", "--skip-lint", "--mutation",
            "table_guard_overlap"])
        kinds = [f["kind"] for f in doc["table"]["verify"]["mesi"]
                 ["findings"]]
        if rc != 1 or "determinism_overlap" not in kinds:
            raise SmokeFailure(f"analyze table_guard_overlap: exit {rc}, "
                               f"findings {sorted(set(kinds))}")
        rc, doc, _ = _analyze_json(tmp, "consistency", [
            "--litmus", "--skip-model-check", "--skip-lint", "--mutation",
            "stale_fill_from_invalid"])
        rep = doc["litmus"]["mesi"]["mp_reload"]
        if rc != 1 or rep["ok"] is not False or not rep["unexpected"]:
            raise SmokeFailure(f"analyze stale_fill_from_invalid: exit {rc}"
                               f", litmus mp_reload {rep}")
        say("analyze", f"{len(mutations.MUTATIONS)} handler mutations, "
            "table_guard_overlap (determinism_overlap) and "
            "stale_fill_from_invalid (mp_reload forbidden outcome "
            f"{rep['unexpected'][0]}) each exit 1 with the JAX package's "
            f"finding, {time.perf_counter() - t1:.2f} s wall; {card}")
        _oracle_profile(card)
        _analyze_serve(tmp, card)
    say("analyze", f"analyze phase took {time.perf_counter() - t0:.1f} s")


# -- fuzz (slice 16) --------------------------------------------------------

#: the fuzz phase's runs: ``analyze --fuzz CASES --seed SEED``, clean and
#: under MUTATION with --repro-dir/--flight-dir (the defaults of
#: scripts/analyze_reference.py --fuzz); the finding cases whose async
#: runs give the cycle rate and the cycles of the profiler window
FUZZ = dict(cases=16, seed=0, mutation="stale_owner_forward",
            rate_cases=4, profile_cycles=32, phase_timeout_s=600)

#: from ``JAX_PLATFORMS=cpu python scripts/analyze_reference.py --fuzz``:
#: sha256 of the JAX runner's ``fuzz`` block clean and under the
#: mutation, the JAX replay verb's exit code and verdict line on the first
#: shrunk repro and the first incident, and the sha256 of every file the
#: mutation run wrote under --repro-dir (R) and --flight-dir (F)
FUZZ_REFERENCE = {
    "clean": (
        "6978ec71a50b6edf6d70e82f3736f85c75cbb232236526d30ee1b8f9"
        "32fe2b2e"),
    "stale_owner_forward": (
        "59a199749d0da2ed4135740e38d3a8273153766d4e696377b87b1384"
        "031e76a3"),
    "replay": {
        "fixture": ("repro_0", 1,
                    "replay: fixture verdict 'consistency' (expected "
                    "'state') -> NOT reproduced"),
        "incident": ("incident_0", 0,
                     "replay: flight incident (reason 'fuzz:state') fresh "
                     "verdict 'ok' -> REPRODUCED"),
    },
    "files": {
        "F/incident_0/core_0.txt":
            "db30c96aecc4f8e0f7deb9a45d6fc83d5466f4c14224097e8119d237ddb8a74c",
        "F/incident_0/core_1.txt":
            "76d5faf31eb8e96572e42187415ab0572cacf1f3091a396b61f304e450311901",
        "F/incident_0/incident.json":
            "5feeec28add860edb2d00471006ccfc2755d8170688e9b933c763a581c53e3c0",
        "F/incident_0/repro.json":
            "16f10ea87d40f8702ec9cfb405afc8a8db646d0e7c017b927855d6db2365fc26",
        "F/incident_0/trace.perfetto.json":
            "6f7605f007ef9f86dacc19216e3dc63db44f0c9f1e1e741348e2144fea3d110e",
        "F/incident_1/core_0.txt":
            "504442fa28488699e4af74f4cba846d6fbfe000201c57f51889e5c5e30a0f39a",
        "F/incident_1/core_1.txt":
            "76d5faf31eb8e96572e42187415ab0572cacf1f3091a396b61f304e450311901",
        "F/incident_1/incident.json":
            "39e789da846a2945088b4f349a6ca7a0d3d17776866b410cc36447f660a4f37a",
        "F/incident_1/repro.json":
            "b4a03857d1afda361e77ab1d592bec7de78f1a82ebc6b7755ddf551f49385b6b",
        "F/incident_1/trace.perfetto.json":
            "0cc0b091ab39f1ef8e7c222a3de751948eda472bd46c7daa3b5894b9fab992cd",
        "F/incident_10/core_0.txt":
            "febd2531706cf8631a024df5b4c216bcaa889cfb16e17ba0e01d2720430f705f",
        "F/incident_10/core_1.txt":
            "64173bb00d52637373f13cb5528a2e176d99d5f00845a2ab2d09f838d2d36d36",
        "F/incident_10/incident.json":
            "91bfd04302478460c5879967a36052037c307969a166d099adbe6e5b0c9329e7",
        "F/incident_10/repro.json":
            "0e0e8c122b4e3db658f067c26e82f4c4a06bcd71ed30d1b7d0e899e19d0fce9c",
        "F/incident_10/trace.perfetto.json":
            "108678dba571bb9354b67ebe36f1ce9ba72e8e6fc8a1177934e55fd6c93acbfd",
        "F/incident_12/core_0.txt":
            "b24168ab2c62343f120881a747e189164ab5db1eb1048f86ae662f4b941fc0b1",
        "F/incident_12/core_1.txt":
            "ddb776e3782cecb9dea1bbff79dc4e29f7dcab784a0f1dd4bbe10955a788f0d3",
        "F/incident_12/core_2.txt":
            "127f2c4816407a15a632314184edba5a93c8d84b9d3b989917701d04b485b57e",
        "F/incident_12/core_3.txt":
            "6a3a0c5564fca3f786892e48c951950972a82be25c88b566ce0634a9527157a2",
        "F/incident_12/incident.json":
            "8c7f9f25392427ac9b12dc1d7b3c52a48c7eb5ab655f31f0d9fe18efe593fda2",
        "F/incident_12/repro.json":
            "3dffea0e5ed364adfcce95e0719decb83af2df5e4d0271382891b9fe65133d82",
        "F/incident_12/trace.perfetto.json":
            "275d19e354cd78206d9a8231a634e9494dec3df8f822c06a554afc9b80432acf",
        "F/incident_13/core_0.txt":
            "a84c5c1f8af50489792053f434d217b12d1ea5b5475fa9631254de1466a67b64",
        "F/incident_13/core_1.txt":
            "a15b1c9306d982f18448c544148e76e4edb9e1dd83913d709ab1c24c01a70b48",
        "F/incident_13/incident.json":
            "d5209c94c42bed5bd464a3cfb59a777e879a0cdfe787be79e4fde1e1abffd839",
        "F/incident_13/repro.json":
            "a10a85903efba5d817ad22e64fabe88747daeeaffb80d90fa84fe0be59dfa221",
        "F/incident_13/trace.perfetto.json":
            "afef3ba80cf502ba4c2c12f02bc9fb1b81b85c407510f0781151a397af88e3c3",
        "F/incident_2/core_0.txt":
            "db30c96aecc4f8e0f7deb9a45d6fc83d5466f4c14224097e8119d237ddb8a74c",
        "F/incident_2/core_1.txt":
            "b3b9847dba5bcec2e9f263acdb89765e0d6381e1d204205b66cd3497ea18a76c",
        "F/incident_2/incident.json":
            "4611a2eb52872addc70d600a85d69e0faaeca7a93b1b745bc6068a607b80e5a1",
        "F/incident_2/repro.json":
            "b3039d3c23edde8b9a7ad77e2741f65bbd477a10c18b137f6ba08b1702305b40",
        "F/incident_2/trace.perfetto.json":
            "8bf883e06bc66ef7c4912b6845005aed19311c9beb40ca3e86ed5e67b73fe1f3",
        "F/incident_3/core_0.txt":
            "652ab1f23fd21e7b9cd1fd0e5079db834e0b5032a58846091869efbc97e1cc4d",
        "F/incident_3/core_1.txt":
            "1a45708254ee3d91696dd57b560d270ef4921b69449ef900d06a9b43446942f7",
        "F/incident_3/incident.json":
            "352fdf946b09dd72d42b32ae3a52474b0c77c9cd89165a04a15d6c0d7ba1dfc1",
        "F/incident_3/repro.json":
            "fb36f3ce24c4ae637042d40460b6a59012a826b617c2cfec554b77ab843600e8",
        "F/incident_3/trace.perfetto.json":
            "0607494829f1e84df3ecdb4ffc49ff3c2002a71c2c74749ffc1bac9b12bc006c",
        "F/incident_4/core_0.txt":
            "308d47f8536911466bd6ed34933f568a3aec221f62cd381749d573fc7d09578e",
        "F/incident_4/core_1.txt":
            "20d3070062691bcba42ba6bd0418cbd60055577c9119313681b8509e6df09e4f",
        "F/incident_4/incident.json":
            "893c5511d35cb21aadad3513f7a211007f304610a6efdd63bc52dc4c8d641677",
        "F/incident_4/repro.json":
            "68f08d25a5754c26bc2d096953e69f555c5bc966fed2187230d4e9de370b51c2",
        "F/incident_4/trace.perfetto.json":
            "aa638c7d24103d0b77b0bbeb7c44be7ab15a55e9f39427952d09d9e9448c54b7",
        "F/incident_5/core_0.txt":
            "2c20b7302ff6d43900efdef96c494c86cbf1f23408ce592dc07eeaca4c035c16",
        "F/incident_5/core_1.txt":
            "23c687c360fa39397dc8c930b2d103a0c5e8e343a05311d856636044bbdec92f",
        "F/incident_5/incident.json":
            "04ce037ae4ce8e9298f2a5d238fd045f677897884708997aca4abe8caa65a7fa",
        "F/incident_5/repro.json":
            "8c11bbcfffdcf6e9b1d2267f140a900d4d638dde02974ebc8b42848cb2c04ac1",
        "F/incident_5/trace.perfetto.json":
            "e6e7c19cb1e3c0fc7bb641457349372965843a9afd5c13ed04370a26a09c442d",
        "F/incident_8/core_0.txt":
            "554dbefa94beff34a627d0affc6d9f4683f5613e8b19c8905a14bbeac438dec3",
        "F/incident_8/core_1.txt":
            "b02be7df1e6e08c30d91835b83491dedd0ee44f6bbc9aa35777ea6ce03cebea4",
        "F/incident_8/core_2.txt":
            "a00a7eb719af718685d81190a078d9e3aaadf9f0731958b618c1a78ddf7d5bdc",
        "F/incident_8/core_3.txt":
            "96042548648ece46c431b053dd88ee9db6eaae7f8e1358c9850997ce634b1b43",
        "F/incident_8/incident.json":
            "f8dcbaf60fc09af444cfd71355bb7797a661ee08cb01adcb29e8875eb607dd7b",
        "F/incident_8/repro.json":
            "1af5aebd50dba670bd7f76a97403975a5a9ad99855429e60cfa1ed5e4b041570",
        "F/incident_8/trace.perfetto.json":
            "49b479527be41ffe653131eeb1a2b6b01b08a418cc3b1e002414660c6c9363ba",
        "F/incident_9/core_0.txt":
            "7c6c263304e74792a285c48ed1fb9fcf7f92b0822c2cb8c53e650704ee305411",
        "F/incident_9/core_1.txt":
            "1a45708254ee3d91696dd57b560d270ef4921b69449ef900d06a9b43446942f7",
        "F/incident_9/incident.json":
            "a9858b0a0a6b9be55fc955dace6928bb9f0ef76de13f1df1abc7fd8c490f5524",
        "F/incident_9/repro.json":
            "6e173f7bb4540024cfafb11dd5abc6016321a6e73ff1b8a89da1d75725412f4d",
        "F/incident_9/trace.perfetto.json":
            "b6af7699ecadccd0806dbfbf5504b8b12e7e71a6839197522a8cd51a38e4ed88",
        "R/repro_0/core_0.txt":
            "308d47f8536911466bd6ed34933f568a3aec221f62cd381749d573fc7d09578e",
        "R/repro_0/core_1.txt":
            "21db6eba715d1fa8768280aef51db7f85b915d903a555303c91d60d13e0f38e8",
        "R/repro_0/repro.json":
            "7dc11dcbae1f688c0fe9e63e45be8cde41ca097d8e19b8d47b27307d4eb35433",
        "R/repro_0/trace.perfetto.json":
            "2927c91ac93ee80c9ca99d7ad57ee6c28692b1e2f0f0f7231fa8a08b1e67c4ae",
        "R/repro_1/core_0.txt":
            "b0e00016c1cce8b422b6d58f8e56ac09612d61e765a8b742ee8ae91292791aa8",
        "R/repro_1/core_1.txt":
            "826cd1fbd600df449eb5294616149dced3e1ea1dd79890ca5ac1dd396755ec6d",
        "R/repro_1/repro.json":
            "9bb2d425b0f8446f2468c41867b3ff1c98c0e64aa94bfb36ec567ab50c3621b2",
        "R/repro_1/trace.perfetto.json":
            "dff4e06833b1d6581fb30810627e149e0c35a7443d87b9e89284ea8ec8758a15",
    },
}


def _tree_digests(root, prefix: str) -> dict:
    """{prefix/relative path: sha256} of every file under ``root``."""
    import hashlib
    import pathlib
    root = pathlib.Path(root)
    return {f"{prefix}/{p.relative_to(root)}":
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _fuzz_rates(card: str, cases: list) -> None:
    """Cycles a second of the async runs to quiescence of ``cases`` on
    the card (clean handlers, the host reading quiescence every cycle as
    the fuzzer's runs do), and the device launches a cycle over a
    torch.profiler window of the first case."""
    cases = cases[:FUZZ["rate_cases"]]
    import torch
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import fuzz
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    cycles, secs = 0, 0.0
    for case in cases:
        st = fuzz.case_state(case)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin = step.run_to_quiescence(case.config(), st, fuzz.MAX_CYCLES)
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
        cycles += int(fin.cycle)
    cfg = cases[0].config()
    prof = bench.profile_steps(lambda s: step.cycle(cfg, s),
                               fuzz.case_state(cases[0]),
                               FUZZ["profile_cycles"])
    say("fuzz", f"async runs of the {len(cases)} finding cases to "
        f"quiescence: {cycles} cycles in {secs:.3f} s, "
        f"{cycles / secs:.1f} cycles/s; one cycle of a "
        f"{cfg.num_nodes}-node case: "
        f"{prof['device_launches_per_round']:.1f} device launches, "
        f"{prof['wall_ms_per_round']:.3f} ms wall under the profiler, "
        f"device busy {prof['device_busy_ms_per_round']:.4f} ms, idle "
        f"share {prof['device_idle_share']:.3f}; {card}")


def _start_child(main: str, card: str, name: str):
    """Start ``chip_smoke.<main>(card)`` in a fresh interpreter, its
    output into a temporary log: the fuzz and walkers phases are
    host-bound (the card idles most of their time), so they run beside
    other phases, and a fresh process keeps them off the slowdown this
    long-lived one shows late (section 7 of PERF.md)."""
    import os
    import tempfile
    fd, log_path = tempfile.mkstemp(prefix=f"chip_smoke_{name}",
                                    suffix=".log")
    log = os.fdopen(fd, "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         f"sys.exit(chip_smoke.{main}(sys.argv[1]))", card],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
        stderr=subprocess.STDOUT, start_new_session=True)
    log.close()
    return proc, log_path, time.perf_counter(), name


def _finish_child(started, timeout_s: float) -> None:
    """Wait for a phase's child (killing it, and its children, at the
    timeout), print its output here, and fail if it failed."""
    proc, log_path, t0, name = started
    try:
        rc = proc.wait(timeout=max(1.0, timeout_s
                                   - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"{name} phase timed out after "
                           f"{timeout_s:.0f} s")
    finally:
        with open(log_path) as f:
            print(f.read(), end="", flush=True)
        stop_child(started)
    if rc != 0:
        raise SmokeFailure(f"{name} phase exited {rc}")
    say(name, f"{name} child done {time.perf_counter() - t0:.1f} s after "
        "its start")


def stop_child(started) -> None:
    """Kill a phase's child and its process group if it still runs, and
    remove its log."""
    import os
    import signal
    proc, log_path, _, _ = started
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    if os.path.exists(log_path):
        os.unlink(log_path)


def start_fuzz(card: str):
    """Start the fuzz phase (``fuzz_main``) in a child process."""
    return _start_child("fuzz_main", card, "fuzz")


def finish_fuzz(started) -> None:
    _finish_child(started, FUZZ["phase_timeout_s"])


def phase_fuzz(card: str) -> None:
    """The fuzz phase alone (``fuzz_main`` in a child process)."""
    finish_fuzz(start_fuzz(card))


def fuzz_main(card: str) -> int:
    """The fuzz phase's work; prints FAIL and exits 1 on a failure."""
    try:
        _fuzz_work(card)
    except (SmokeFailure, AssertionError, RuntimeError, ValueError,
            KeyError) as e:
        print(f"FAIL: fuzz: {type(e).__name__}: {e}", flush=True)
        return 1
    return 0


def _fuzz_work(card: str) -> None:
    """``cache-sim-torch analyze --fuzz 16 --seed 0`` on the card, clean
    and under stale_owner_forward with --repro-dir and --flight-dir: the
    exit codes, the ``fuzz`` blocks and every file written equal to the
    JAX package's (FUZZ_REFERENCE), no port kernel launched; the replay
    verb on the first repro and incident gives the JAX verb's exit code
    and verdict line, and the repro replays its verdict under the
    mutation in process; the async runs' cycle rate and a cycle's
    launches."""
    import os
    import tempfile
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
        fixtures, fuzz, mutations, runner)
    F, ref, mut = FUZZ, FUZZ_REFERENCE, FUZZ["mutation"]
    t0 = time.perf_counter()
    argv = ["--skip-model-check", "--skip-lint", "--fuzz", str(F["cases"]),
            "--seed", str(F["seed"])]
    with tempfile.TemporaryDirectory() as tmp:
        bench.reset_launch_counts()
        rc, doc, took = _analyze_json(tmp, "fuzz", argv)
        _check_launches("fuzz clean", bench.launch_counts(), {})
        if rc != 0 or runner.block_digests(doc)["fuzz"] != ref["clean"]:
            raise SmokeFailure(f"analyze --fuzz {F['cases']}: exit {rc}, "
                               "or the fuzz block differs from the JAX "
                               "package's")
        p = doc["prongs"]["fuzz"]
        say("fuzz", f"analyze --fuzz {F['cases']} --seed {F['seed']} on "
            f"the card: exit 0, verdicts {doc['fuzz']['verdicts']}, the "
            f"fuzz block equal to the JAX package's; {took:.2f} s wall, "
            f"{p['cases'] / p['seconds']:.2f} cases/s, {p['cycles']} "
            f"async cycles; {card}")
        r, f = os.path.join(tmp, "R"), os.path.join(tmp, "F")
        bench.reset_launch_counts()
        rc, doc, took = _analyze_json(tmp, "fuzz-mutation", argv + [
            "--mutation", mut, "--repro-dir", r, "--flight-dir", f])
        _check_launches("fuzz mutation", bench.launch_counts(), {})
        if rc != 1 or runner.block_digests(doc)["fuzz"] != ref[mut]:
            raise SmokeFailure(f"analyze --fuzz --mutation {mut}: exit "
                               f"{rc}, or the fuzz block differs from the "
                               "JAX package's")
        files = {**_tree_digests(r, "R"), **_tree_digests(f, "F")}
        if files != ref["files"]:
            bad = sorted(k for k in set(files) | set(ref["files"])
                         if files.get(k) != ref["files"].get(k))
            raise SmokeFailure(f"fuzz {mut}: {len(bad)} file(s) differ "
                               f"from the JAX package's: {bad[:4]}")
        say("fuzz", f"--mutation {mut} --repro-dir --flight-dir: exit 1, "
            f"verdicts {doc['fuzz']['verdicts']}, shrunk "
            + ", ".join(f"{s['instrs_before']}->{s['instrs_after']} in "
                        f"{s['runs']} runs" for s in doc["fuzz"]["shrunk"])
            + f"; the fuzz block and all {len(files)} files equal to the "
            f"JAX package's; {took:.2f} s wall; {card}")
        for kind, (d, want_rc, want_line) in ref["replay"].items():
            path = os.path.join(r if kind == "fixture" else f, d)
            rc, out, _, wall, counts = run_cli(["replay", path])
            _check_launches(f"replay {kind}", counts, {})
            line = out.splitlines()[-1] if out else ""
            if (rc, line) != (want_rc, want_line):
                raise SmokeFailure(f"replay {d}: exit {rc}, {line!r}; the "
                                   f"JAX verb: exit {want_rc}, "
                                   f"{want_line!r}")
            say("fuzz", f"replay {d} on the card: exit {rc}, as the JAX "
                f"verb; {wall:.2f} s wall")
        d = os.path.join(r, ref["replay"]["fixture"][0])
        res = fixtures.replay(d, mutations.MUTATIONS[mut][0])
        if not res["reproduced"]:
            raise SmokeFailure(f"fixtures.replay {d} under {mut}: verdict "
                               f"{res['verdict']}, want "
                               f"{res['expected_verdict']}")
        say("fuzz", f"fixtures.replay of {os.path.basename(d)} under {mut} "
            f"on the card: {res['verdict']}, reproduced")
        _fuzz_rates(card, [fuzz.case_from_dict(x["case"])
                           for x in doc["fuzz"]["findings"]])
    say("fuzz", f"fuzz phase took {time.perf_counter() - t0:.1f} s; {card}")


#: the walkers phase (slice 17): the analyze prongs of the static
#: walkers on the card, the same with --cpu in a child, and each seeded
#: mutation with its prong and finding kind
WALKERS = dict(budget_s=40.0, phase_timeout_s=300.0,
               argv=("--skip-model-check", "--skip-lint", "--jaxpr",
                     "--kernel", "--index"),
               mutations=(("widen_min_chunk", "--kernel", "key_range"),
                          ("narrow_ladder_gap", "--kernel", "field_width"),
                          ("lift_storm_gate", "--kernel",
                           "gate_divergence"),
                          ("split_packed_scatter", "--index",
                           "index_budget")))


def start_walkers(card: str):
    """Start the walkers phase (``walkers_main``) in a child process."""
    return _start_child("walkers_main", card, "walkers")


def finish_walkers(started) -> None:
    _finish_child(started, WALKERS["phase_timeout_s"])


def phase_walkers(card: str) -> None:
    """The walkers phase alone (``walkers_main`` in a child process)."""
    finish_walkers(start_walkers(card))


def walkers_main(card: str) -> int:
    """The walkers phase's work; prints FAIL and exits 1 on a failure."""
    try:
        _walkers_work(card)
    except (SmokeFailure, AssertionError, RuntimeError, ValueError,
            KeyError) as e:
        print(f"FAIL: walkers: {type(e).__name__}: {e}", flush=True)
        return 1
    return 0


def _inventory(doc: dict) -> dict:
    """{target: its index sites (no signatures or buffer tokens)} of the
    index report's targets that launched no kernel of the port."""
    keys = ("primitive", "site", "plane", "operand", "index_shape",
            "update", "trip_weight", "indices")
    return {name: [tuple(op.get(k) for k in keys) for op in t["ops"]]
            for er in doc["index"]["engines"].values()
            for name, t in er["targets"].items()
            if not t["kernel_launches"]}


def _walkers_card_checks(doc: dict) -> None:
    """The card-only contracts of the kernel and replay reports."""
    k = doc["kernel"]
    er = k["exactness"]["extreme_rounds"]
    if not er or er["device"] != "cuda" or not er["equal"]:
        raise SmokeFailure(f"the fused round at the key extremes: {er}")
    deep = next(r for r in k["vmem"]["rows"]
                if r["kernel"] == "deep.round_fused")
    if deep.get("library_dynamic_bytes") != deep["resident_in_bytes"]:
        raise SmokeFailure(f"deep round shared memory: derived "
                           f"{deep['resident_in_bytes']} B, the library "
                           f"{deep.get('library_dynamic_bytes')} B")
    for name, row in k["lowerability"]["kernels"].items():
        for n, g in (row.get("grids") or {}).items():
            if g.get("runtime") != g["derived"]:
                raise SmokeFailure(f"{name} at {n} nodes: derived grid "
                                   f"{g['derived']}, the runtime's "
                                   f"{g.get('runtime')}")
    if doc["jaxpr"]["recompile_guard"]["kernel_nvcc_runs"] != 0:
        raise SmokeFailure("a second load of the kernel libraries ran nvcc")


def _walkers_work(card: str) -> None:
    """``cache-sim-torch analyze --skip-model-check --skip-lint --jaxpr
    --kernel --index`` on the card and with --cpu in a child process
    beside it: exit 0 both; on the card the fused round at the key
    extremes equal to the plain round, the deep round's derived shared
    memory equal to ``deep_round_smem_bytes()``, each cooperative
    kernel's derived grid equal to the runtime's, a second library load
    without nvcc; the index inventory of every target that launched no
    kernel equal to the CPU's; each seeded mutation exits 1 with its
    finding kind. Prints the prongs' seconds, each target's aten ops and
    index sites, indices per instruction and each kernel's ptxas
    figures."""
    import os
    import tempfile
    W = WALKERS
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cpu_json = os.path.join(tmp, "cpu.json")
        cpu = subprocess.Popen(
            [sys.executable, "-m",
             "ue22cs343bb1_openmp_assignment_tpu_torch.analysis", "--cpu",
             *W["argv"], "-q", "--json", cpu_json],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            rc, doc, took = _analyze_json(tmp, "walkers", list(W["argv"]))
            if rc != 0:
                bad = [f for b in ("jaxpr", "kernel", "index")
                       for f in doc[b]["findings"]]
                raise SmokeFailure(f"analyze {' '.join(W['argv'])} on the "
                                   f"card: exit {rc}: {bad[:6]}")
            _walkers_card_checks(doc)
            for mut, prong, kind in W["mutations"]:
                mrc, mdoc, mtook = _analyze_json(
                    tmp, mut, ["--skip-model-check", "--skip-lint", prong,
                               "--mutation", mut])
                rep = mdoc[prong.lstrip("-")]
                kinds = sorted({f["kind"] for f in rep["findings"]})
                if mrc != 1 or not rep.get("mutant_killed") \
                        or kind not in kinds:
                    raise SmokeFailure(f"--mutation {mut}: exit {mrc}, "
                                       f"kinds {kinds}, want {kind}")
                say("walkers", f"{prong} --mutation {mut} on the card: "
                    f"exit 1, killed with {kind} (kinds {kinds}); "
                    f"{mtook:.2f} s")
            out, _ = cpu.communicate(timeout=W["phase_timeout_s"])
        finally:
            if cpu.poll() is None:
                cpu.kill()
                cpu.wait()
        if cpu.returncode != 0:
            raise SmokeFailure(f"analyze --cpu {' '.join(W['argv'])}: exit "
                               f"{cpu.returncode}: {out[-2000:]}")
        with open(cpu_json) as fh:
            cdoc = json.load(fh)
    card_inv, cpu_inv = _inventory(doc), _inventory(cdoc)
    same = sorted(set(card_inv) & set(cpu_inv))
    differ = [t for t in same if card_inv[t] != cpu_inv[t]]
    if differ or not same:
        raise SmokeFailure(f"index inventory on the card != the CPU's for "
                           f"{differ or 'every target'}")
    routed = sorted(set(_inventory(cdoc)) - set(card_inv))
    secs = {n: round(p["seconds"], 2) for n, p in doc["prongs"].items()}
    csecs = {n: round(p["seconds"], 2) for n, p in cdoc["prongs"].items()}
    say("walkers", f"analyze {' '.join(W['argv'])}: exit 0 on the card "
        f"({took:.2f} s; prongs {secs}) and with --cpu (prongs {csecs}); "
        f"the index inventory of {len(same)} kernel-free targets equal, "
        f"card and CPU; kernel-route targets on the card: {routed}")
    j = doc["jaxpr"]
    say("walkers", f"seconds a lint target on the card {j['seconds']}; "
        f"replay guard {j['recompile_guard']['seconds']}")
    say("walkers", "aten ops / index sites a call on the card: "
        + ", ".join(f"{t} {n} / {j['index_sites'].get(t, '-')}"
                    for t, n in j["targets"].items())
        + f"; kernel launches {j['kernel_launches']}")
    say("walkers", "indices/instr: " + ", ".join(
        f"{e} {er['indices_per_instr']} ({er['indices_per_step']}/step, "
        f"{er['probe']['steps']} steps, {er['probe']['retired']} retired)"
        for e, er in doc["index"]["engines"].items()))
    k = doc["kernel"]
    for name, row in k["lowerability"]["kernels"].items():
        occ = row.get("blocks_per_sm")
        say("walkers", f"{name}: {row.get('registers')} registers, "
            f"{row.get('spill_stores', 0)} B spill stores, "
            f"{row.get('smem', 0)} B static smem"
            + (f", {occ['blocks']} blocks/SM ({occ}), grids "
               f"{row['grids']}" if occ else ""))
    for r in k["vmem"]["rows"]:
        say("walkers", f"{r['kernel']}: {r['resident_in_bytes']} B dynamic "
            f"+ {r['resident_out_bytes']} B static shared memory a block, "
            f"library {r.get('library_dynamic_bytes')} / "
            f"{r.get('library_static_bytes')} B")
    er = k["exactness"]["extreme_rounds"]
    say("walkers", f"fused round vs plain round at rounds "
        f"{[r['round'] for r in er['rounds']]} on a contended "
        f"{er['num_nodes']}-node machine: bit-identical")
    took_all = time.perf_counter() - t0
    say("walkers", f"walkers phase took {took_all:.1f} s (budget "
        f"{W['budget_s']:.0f} s: "
        f"{'within' if took_all <= W['budget_s'] else 'OVER'}); {card}")


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


def serve_run_alone(card: str, jobs: int) -> None:
    """``--serve-run JOBS``: the serve phase's serving run alone at
    ``jobs`` jobs of the mix, one warm pass then the median of 3, every
    digest held to SERVE_REFERENCE."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _serve_run(tmp, card, jobs, 3)
    say("serve", f"serving run alone took {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="The port's check on one "
                                 "NVIDIA card (every phase, with no "
                                 "arguments).")
    ap.add_argument("--serve-run", type=int, metavar="JOBS", default=None,
                    help="only the serve phase's serving run, at JOBS jobs "
                         "of the mix (at most 1024, as SERVE_REFERENCE "
                         "pins), median of 3")
    args = ap.parse_args(argv)
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
        if args.serve_run is not None:
            serve_run_alone(card, args.serve_run)
            print(card)
            return 0
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
            deep_fold_kernel, deep_round_kernel, sync_burst_kernel,
            sync_multi_round_kernel, sync_round_kernel, sync_window_kernel)
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
            threefry_kernel)
        from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import (
            ring_kernel)
        from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
            indexcheck)
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
            # one ring library serves every (D, shape), one threefry
            # library every key, count and mode: all run-time arguments
            + [(ring_kernel.LIBRARY, None), (threefry_kernel.LIBRARY, None)]
            # the deep probe config of the analyze walkers (phase 17)
            + [(lib.LIBRARY, indexcheck.engine_config("deep", 8))
               for lib in (deep_fold_kernel, deep_round_kernel)]
            + cli_configs())
        times = {"device + build": time.perf_counter() - t_all}

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            times[name] = time.perf_counter() - t0
            return out
        random_rows = {}
        timed("random", phase_random, random_rows)
        rows, st = timed("kernel vs plain", phase_kernel_vs_plain, cfg)
        rows.update(random_rows)
        rows["round"] = timed("round vs plain", phase_round_vs_plain, cfg,
                              st)
        timed("card vs cpu", phase_card_vs_cpu)
        timed("main (deep)", phase_main_path, rows)
        rows.update(timed("sync kernels", phase_sync_kernels))
        rows["sync_round"] = timed("sync round kernel",
                                   phase_sync_round_kernel)
        rows["sync_multi_round"] = timed("sync multi round kernel",
                                         phase_sync_multi_round_kernel)
        timed("sync card vs cpu", phase_sync_card_vs_cpu)
        timed("main (sync)", phase_sync_main_path, rows)
        timed("ensembles", phase_ensembles, rows)
        rows["ring"] = timed("ring kernel", phase_ring_kernel)
        timed("async card vs cpu", phase_async_card_vs_cpu)
        timed("main (async)", phase_async_main_path, rows)
        timed("async uniform", phase_async_uniform, rows)
        timed("multi-card", phase_multi_card)
        timed("cli", phase_cli, card)
        timed("obs", phase_obs, card)
        timed("serve", phase_serve, card)
        # the fuzz phase's child runs beside the history and report
        # children (this process only waits for them) and the analyze
        # phase
        fuzz_run = start_fuzz(card)
        walkers_run = start_walkers(card)
        try:
            timed("history", phase_history, card)
            timed("report", phase_report, card)
            timed("analyze", phase_analyze, card)
            timed("fuzz (rest)", finish_fuzz, fuzz_run)
            timed("walkers (rest)", finish_walkers, walkers_run)
        finally:
            stop_child(fuzz_run)
            stop_child(walkers_run)
        say("time", ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    except (SmokeFailure, AssertionError, RuntimeError, ValueError) as e:
        print(f"FAIL: {type(e).__name__}: {e}", flush=True)
        return 1
    say("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [rows[k] for k in FOLD_MODES + ("round",)
                                  + SYNC_KERNELS + ("ring", "threefry")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
