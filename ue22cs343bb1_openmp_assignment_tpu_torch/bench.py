"""Throughput benchmark of the port's main paths (one JSON line).

    python -m ue22cs343bb1_openmp_assignment_tpu_torch.bench
        [--engine deep|sync] [--nodes N] [--trace-len L] [--chunk K]
        [--reps R] [--workload NAME] [--local-frac F] [--replicas R]
        [--txn-width K] [--drain-depth H] [--fold-impl kernel|plain]
        [--fused-round auto|on|off] [--window-kernels auto|on|off]
        [--deep-slots S] [--deep-g G] [--deep-waves W] [--deep-slack K]
        [--read-storm] [--no-exact-flags] [--[no-]procedural]
        [--profile ROUNDS] [--device cuda|cpu] [--record PATH]
        [--kernel-costs] [--timer-check] [--profile-dir DIR]
    python -m ue22cs343bb1_openmp_assignment_tpu_torch.bench --engine async
        [--workload NAME] [--queue-capacity Q] [--admission A] [--shards D]
        [--transport rdma|all_to_all] [--profile CYCLES]
        [--ledger | --coherence-profile]
    python -m ue22cs343bb1_openmp_assignment_tpu_torch.bench --serve
        [--serve-slots S] [--serve-jobs J] [--nodes N] [--trace-len L]
        [--chunk K] [--profile CYCLES] [--serve-out-dir DIR | --serve-no-warm]
    python -m ue22cs343bb1_openmp_assignment_tpu_torch.bench --soak
        [--arrival-rate R] [--soak-duration S] [--daemon]

Runs a transactional engine at the JAX ``bench.py``'s defaults (4096
nodes, 4096 uniform instructions per node, locality ``--local-frac``
0.8, chunk 64) to quiescence: one discarded warm-up, then the median of
``--reps`` runs, each clock stop after ``torch.cuda.synchronize()``.
The machine is built before the clock starts.

As in the JAX bench, the sync-like engines generate the ``uniform``
workload procedurally inside the round (``cfg.procedural``, O(1) trace
storage) when it is the workload and ``--replicas`` is 1 (unless
``--no-procedural``); any other workload, an ensemble or
``--no-procedural`` runs as stored traces drawn from the threefry
twin of jax.random (``models.workloads``), whose stored-trace rounds are
the plain PyTorch rounds on the card, as in JAX. ``--replicas R``
(``--engine sync`` only) batches R machines into one ensemble, replica r
the workload of seed r under arbitration seed r
(``sync_engine.make_ensemble``, ``run_ensemble_to_quiescence``);
throughput is summed over the replicas.

``--engine deep`` (the default) is the deep-window engine (drain_depth
13, txn_width 3, deep_slots 3, 2 from 32768 nodes up, one owner-value
slot, slack 4, one wave, exact flags). The knobs of the JAX bench
(``bench.py:356-384``, applied as at ``:565-584``) change them:
``--deep-slots``, ``--deep-g`` (owner-value slots), ``--deep-waves``,
``--deep-slack``, ``--read-storm`` and ``--no-exact-flags``.
``--fused-round`` selects its round: the whole round as one kernel
(``ops/deep_round_kernel``) or the fold path (three fold kernels around
the plain round middle); ``auto``, the default, takes the fused round on
a card where ``supported(cfg)`` holds, as the JAX ``bench.py`` does on a
TPU. The fused round does not take the read storm: ``--read-storm``
runs the fold path.

``--engine sync`` is the sync window engine: txn_width 3 and drain_depth
4 by default, drain_depth 16 at ``--txn-width 1``. ``--window-kernels``
sets ``cfg.pallas_burst``, which routes the whole procedural round
through one kernel: ``ops/sync_multi_round_kernel`` at txn_width >= 2
(the window kernels of ``ops/sync_window_kernel`` where it does not
take the config: more than 32 lines a node), ``ops/sync_round_kernel``
at txn_width 1; ``auto`` turns it on for a card, ``off`` measures the
plain rounds.

``--engine async`` is the message-level engine (``ops.step``) at the JAX
``bench.py``'s async defaults: scatter INV (``SystemConfig.scale``),
queue capacity 64, the ``uniform`` workload at locality 0.8 as stored
traces, chunk 64, run to quiescence (``run_chunked_to_quiescence``).
``--shards D`` routes phase-3 delivery over D shards of the node axis
(``parallel.rdma_comm.make_routed_deliver``): ``--transport rdma`` (the
ring kernel, ``parallel/ring_kernel``) or ``all_to_all`` (the plain lane
exchange); one shard delivers unrouted. ``--ledger`` and
``--coherence-profile`` (JAX ``bench.py:390-406``, ``:709-745``) time
the observability captures instead of the plain run: the plain run's
cycle count is found once (capture off), and each timed run replays
exactly that many cycles under the message ledger
(``obs.txntrace.capture``, chunk ``--chunk``, each chunk's ledger read to
the host) or the coherence-profile planes (``ops.step.
run_cycles_profile``); unrouted only, async only, one of the two.

``--serve`` and ``--soak`` (JAX ``bench.py:30-310``) measure the batched
serving layer instead of one machine, with the JAX bench's rules: the
traffic mix is ``serve.mixed_jobs`` (uniform, false_sharing,
producer_consumer, hotspot; seeds 0..J-1) at the job shape ``--nodes`` x
``--trace-len``, through ``--serve-slots`` batch slots (default 8; 1 is
the sequential baseline), the queue capacity ``max(64, 2 * nodes)``.
``--serve`` times whole ``serve.serve`` passes over ``--serve-jobs`` jobs
(default twice the slots): one warm pass (it draws every job's trace,
which later passes reuse; ``--serve-out-dir`` has it write every job's
dumps and metrics doc), then the median of ``--reps``
(``--serve-no-warm`` times every pass, for a process that has already
drawn these jobs' traces in an earlier ``--serve`` of the same mix and
shape); it reports
jobs/sec with ``padding_waste`` beside it, the waves and wave cycles
(a wave runs chunk-granular to its slowest job), ms a wave cycle, the
launch counts of the warm pass and of one timed pass, and the peak
device memory of the timed passes; ``--profile C`` adds a torch.profiler
window of C wave cycles of a full batch beside C cycles of one machine
of the same shape. ``--soak`` releases ``serve.mixed_jobs``-style
arrivals (``soak.soak_stream`` at ``--arrival-rate`` for
``--soak-duration`` seconds) open-loop and reports the p50/p95/p99 job
latency in ms; the warm pass runs on a VirtualClock. ``--daemon`` sends
the stream through an in-process daemon on a unix socket under a
temporary directory (``soak.soak_daemon``: client-observed latency,
continuous admission, shape buckets). ``--admission A`` caps each
async node's outstanding requests (``cfg.admission_window``), as in JAX.

``--record PATH`` appends the run to a bench history (``obs/history.py``,
``cache-sim/bench/v1.4``, JAX ``bench.py:111-131``, ``:265-312``,
``:570-632``) on every mode: the metric string, the rep times, rounds
or cycles, retired instructions and quiescence, the config fingerprint
with the JAX bench's keys (``platform`` ``gpu`` on the card, ``cpu`` on
the CPU), ``device_kind`` (the card's name, or ``cpu``), the serve block
of ``--serve`` and ``--soak`` and the latency block of ``--soak``. On the
deep, sync and async solo runs it also fills ``hlo_fingerprint`` and
``cost`` from the dispatch records (``obs/roofline.kernel_record``) of
one round or cycle and of one chunk of the runner, on the run's device
and route: ``cost`` is ``roofline.cost_vector(per_step, runner, steps,
retired)``, the input of ``bench-diff --bytes`` (JAX ``bench.py:894-930``;
``null`` for ``--replicas`` above 1, ``--serve`` and ``--soak``, as in
JAX). On the card a record that fails is an error; on the CPU it leaves
a note and the two fields ``null``, as the JAX bench does. Compare
entries with ``cache-sim-torch bench-diff --history PATH
--against-last``.

The instruments of the JAX bench (``bench.py:443``, ``:510-518``,
``:820-845``), on the deep, sync and async runs: ``--kernel-costs``
attaches ``obs.profiler.kernel_cost_report`` of one chunk of the
headline runner (the dispatch record plus memory sizes) to the phase
report (the JSON line's ``phases``: ``execute_dispatch`` and
``device_get_sync`` of the timed runs, and ``kernels``);
``--timer-check`` puts ``obs.profiler.timer_self_check`` of one run into
the line (``timer_check``: is ``torch.cuda.synchronize()`` a real
barrier?); ``--profile-dir DIR`` wraps the timed runs in
``obs.profiler.capture(DIR)``, a torch.profiler Chrome trace in
``DIR/trace.json`` (JAX's ``--profile DIR``; the port's ``--profile R``
is its profiler window).

The JSON line carries instrs/sec, rounds (cycles for the async engine),
ms/round (ms/cycle), the card's name and power limit, the workload and
whether its stream was procedural, which path ran and the kernels'
launch counts of one run. ``--profile R`` adds a torch.profiler window
of R rounds or cycles: device-busy share, device launches and device
time by kernel.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional import (
    TransactionalSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.models.workloads import (
    GENERATORS)
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import profiler, roofline
from ue22cs343bb1_openmp_assignment_tpu_torch.obs.phases import PhaseTimer
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    deep_fold_kernel as dfk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    deep_round_kernel as drk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_burst_kernel as sbk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_multi_round_kernel as smk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_round_kernel as srk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_window_kernel as swk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import threefry_kernel
from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import ring_kernel

#: the port's kernels by the name the profiler reports them under
KERNEL_NAMES = {"fold": "deep_fold_kernel", "round": "deep_round_kernel",
                "sync_burst": "sync_burst_kernel",
                "sync_round": "sync_round_kernel",
                "sync_multi_round": "sync_multi_round_kernel",
                "sync_window": "sync_window_kernel",
                "sync_replay": "sync_replay_kernel",
                "ring": "ring_exchange_kernel",
                "threefry": "threefry_kernel"}


def deep_config(nodes: int, deep_slots=None, deep_g=None,
                deep_waves: int = 1, deep_slack: int = 4,
                read_storm: bool = False, exact_flags: bool = True,
                admission=None) -> SystemConfig:
    """bench.py's deep-engine config at ``nodes`` with its knobs
    (``bench.py:565-584``): deep_slots 3, or 2 from 32768 nodes up, one
    owner-value slot, slack 4, one wave, no read storm, exact flags."""
    if deep_slots is None:
        deep_slots = 2 if nodes >= 32768 else 3
    if deep_g is None:
        deep_g = 1
    cfg = SystemConfig.scale(num_nodes=nodes, drain_depth=13, txn_width=3,
                             admission_window=admission)
    return dataclasses.replace(
        cfg, deep_window=True, deep_slots=deep_slots,
        deep_ownerval_slots=deep_g, deep_horizon_slack=deep_slack,
        deep_waves=deep_waves, deep_read_storm=read_storm,
        deep_exact_flags=exact_flags, procedural="uniform",
        max_instrs=1, proc_local_permille=800)


def sync_config(nodes: int, txn_width: int = 3, drain_depth=None,
                window_kernels: bool = False, admission=None) -> SystemConfig:
    """bench.py's sync-engine config at ``nodes``: txn_width 3 and
    drain_depth 4, or drain_depth 16 at txn_width 1, procedural uniform
    at locality 0.8; ``window_kernels`` sets ``pallas_burst``."""
    if drain_depth is None:
        drain_depth = 16 if txn_width == 1 else 4
    cfg = SystemConfig.scale(num_nodes=nodes, drain_depth=drain_depth,
                             txn_width=txn_width,
                             admission_window=admission)
    return dataclasses.replace(
        cfg, procedural="uniform", max_instrs=1, proc_local_permille=800,
        pallas_burst=window_kernels)


_COUNTED = {"round": drk.fused_round, "sync_burst": sbk.burst,
            "sync_round": srk.fused_round,
            "sync_multi_round": smk.fused_round, "sync_window": swk.window,
            "sync_replay": swk.replay, "ring": ring_kernel.exchange,
            "threefry": threefry_kernel.block}


def counted_wrappers() -> dict:
    """{kernel: wrapper} of every kernel of the port: each wrapper's
    ``launches`` counts its kernel's launches."""
    return dict(dfk.WRAPPERS, **_COUNTED)


def reset_launch_counts() -> None:
    for fn in counted_wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    """Launches of every kernel of the port since the last reset."""
    return {k: fn.launches for k, fn in counted_wrappers().items()}


def with_fused_round(cfg: SystemConfig, mode: str,
                     device: torch.device) -> SystemConfig:
    """``cfg`` with ``fused_round`` set as ``--fused-round`` asks: on,
    off, or ``auto`` (on for a card and a supported config)."""
    ok = drk.supported(cfg)
    want = mode == "on" or (mode == "auto" and device.type == "cuda"
                            and ok)
    if mode == "on" and not ok:
        print("note: --fused-round on needs a supported config (no read "
              "storm); measuring the fold path instead", file=sys.stderr)
        want = False
    return dataclasses.replace(cfg, fused_round=want)


def card_name_and_limit(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else torch.cuda.get_device_name(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_events(fn) -> tuple:
    """(device-side events, wall seconds) of fn() under torch.profiler:
    every kernel, copy and fill the card ran, as (name, microseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return ([(e.name, e.time_range.elapsed_us()) for e in prof.events()
             if e.device_type == DeviceType.CUDA], wall)


def async_config(nodes: int, trace_len: int, queue_capacity: int = 64,
                 admission=None) -> SystemConfig:
    """bench.py's async-engine config at ``nodes``: scatter INV, the
    queue capacity, locality 0.8 (of the ``procedural_uniform``
    workload), ``trace_len`` instructions a node, the admission window
    (None: the reference's drop semantics)."""
    return SystemConfig.scale(num_nodes=nodes, queue_capacity=queue_capacity,
                              max_instrs=trace_len, proc_local_permille=800,
                              admission_window=admission)


def gen_kwargs(workload: str, local_frac: float) -> dict:
    """The generator's keyword arguments the JAX bench passes: the
    locality of the ``uniform`` workload."""
    return {"local_frac": local_frac} if workload == "uniform" else {}


def profile_rounds(cfg, st, rounds: int, fold_impl: str) -> dict:
    """Device-busy share, device launches and device time by kernel over
    `rounds` rounds (the wall time here includes the profiler's cost)."""
    return profile_steps(lambda s: se.round_step(cfg, s, fold_impl), st,
                         rounds)


def profile_steps(step_fn, st, rounds: int) -> dict:
    """Device-busy share, device launches, and device time and calls by
    kernel over `rounds` calls of ``step_fn`` (a round, or a cycle of
    the async engine, whose numbers read per cycle; the wall time here
    includes the profiler's cost)."""
    box = [st]

    def run():
        for _ in range(rounds):
            box[0] = step_fn(box[0])

    events, wall = device_events(run)
    by_name = {}
    for name, us in events:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + us, n + 1)
    busy_us = sum(us for _, us in events)
    ours = {k: [us for name, us in events if kname in name]
            for k, kname in KERNEL_NAMES.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"rounds": rounds, "wall_ms_per_round": wall * 1e3 / rounds,
            "device_busy_ms_per_round": busy_us / 1e3 / rounds,
            "device_idle_share": 1 - busy_us / 1e6 / wall,
            "kernel_ms_per_round": {k: sum(us) / 1e3 / rounds
                                    for k, us in ours.items() if us},
            "kernel_calls_per_round": {k: len(us) / rounds
                                       for k, us in ours.items() if us},
            "device_launches_per_round": len(events) / rounds,
            "top_kernels": [{"name": k[:80], "ms_per_round":
                             us / 1e3 / rounds, "calls_per_round":
                             n / rounds} for k, (us, n) in top]}


def build_parser() -> argparse.ArgumentParser:
    """The bench's flags."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=["deep", "sync", "async"],
                    default="deep")
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--trace-len", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--workload", choices=sorted(GENERATORS),
                    default="uniform")
    ap.add_argument("--local-frac", type=float, default=0.8)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--fold-impl", choices=["kernel", "plain"],
                    default="kernel")
    ap.add_argument("--fused-round", choices=["auto", "on", "off"],
                    default="auto")
    ap.add_argument("--txn-width", type=int, default=3)
    ap.add_argument("--drain-depth", type=int, default=None)
    ap.add_argument("--window-kernels", choices=["auto", "on", "off"],
                    default="auto")
    ap.add_argument("--deep-slots", type=int, default=None,
                    help="deep engine: remote-event slots per window "
                         "(default 3; 2 at >= 32768 nodes)")
    ap.add_argument("--deep-g", type=int, default=None,
                    help="deep engine: owner-value slots per window "
                         "(default 1)")
    ap.add_argument("--deep-waves", type=int, default=1,
                    help="deep engine: absorption waves (default 1)")
    ap.add_argument("--deep-slack", type=int, default=4,
                    help="deep engine: adaptive attempt-horizon slack "
                         "(default 4)")
    ap.add_argument("--read-storm", action="store_true",
                    help="deep engine: bulk-grant all same-round losing "
                         "READ requests per entry (the fold path: the "
                         "fused round does not take it)")
    ap.add_argument("--no-exact-flags", action="store_true",
                    help="deep engine: attempt-based marker/poison flags "
                         "instead of the commit-prefix-exact flag pass")
    ap.add_argument("--procedural", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="sync engines: compute the uniform workload "
                         "inside the round (the default); "
                         "--no-procedural measures stored traces")
    ap.add_argument("--admission", type=int, default=None,
                    help="max concurrent outstanding requests a node "
                         "(cfg.admission_window; None = the reference's "
                         "drop semantics)")
    ap.add_argument("--record", metavar="PATH",
                    help="append this run to a bench-history JSONL "
                         "(cache-sim/bench/v1.4); compare entries with "
                         "`cache-sim-torch bench-diff --history PATH "
                         "--against-last`")
    ap.add_argument("--profile", type=int, default=0, metavar="ROUNDS")
    ap.add_argument("--profile-dir", metavar="DIR",
                    help="capture a torch.profiler Chrome trace of the "
                         "timed runs into DIR (obs.profiler.capture)")
    ap.add_argument("--timer-check", action="store_true",
                    help="run the obs.profiler timer self-check: is "
                         "torch.cuda.synchronize() a real barrier here? "
                         "The result rides in the JSON line")
    ap.add_argument("--kernel-costs", action="store_true",
                    help="attach the dispatch record of one chunk of the "
                         "headline runner (aten ops, bytes, the port's "
                         "kernel launches, memory sizes) to the phase "
                         "report (obs.profiler.kernel_cost_report)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--transport", choices=["rdma", "all_to_all"],
                    default="rdma")
    ap.add_argument("--ledger", action="store_true",
                    help="async engine: time the run under the causal "
                         "message-ledger capture (obs.txntrace.capture)")
    ap.add_argument("--coherence-profile", action="store_true",
                    help="async engine: time the run under the "
                         "coherence-profile planes "
                         "(ops.step.run_cycles_profile)")
    ap.add_argument("--serve", action="store_true",
                    help="measure the batched serving layer: the fixed "
                         "traffic mix through serve.serve() waves, in "
                         "jobs/sec")
    ap.add_argument("--serve-slots", type=int, default=8,
                    help="batch slots a wave for --serve / --soak "
                         "(default 8; 1 = the sequential baseline)")
    ap.add_argument("--serve-jobs", type=int, default=None,
                    help="jobs in the --serve traffic mix (default 2x "
                         "slots so every slot turns over once)")
    ap.add_argument("--soak", action="store_true",
                    help="open-loop latency bench: release the mixed "
                         "stream at --arrival-rate through the soak "
                         "harness and report p95 job latency in ms")
    ap.add_argument("--arrival-rate", type=float, default=20.0,
                    help="--soak: jobs per second released (default 20)")
    ap.add_argument("--soak-duration", type=float, default=2.0,
                    help="--soak: arrival window in seconds (default 2); "
                         "the run drains fully after")
    ap.add_argument("--daemon", action="store_true",
                    help="--soak: route the stream through an "
                         "in-process serving daemon on a temporary unix "
                         "socket")
    ap.add_argument("--max-cycles", type=int, default=None,
                    help="--serve / --soak: the per-job cycle budget "
                         "(default 100000)")
    ap.add_argument("--serve-out-dir", default=None, metavar="DIR",
                    help="--serve: the warm pass writes its per-job "
                         "dumps and metrics docs here (serve --out-dir)")
    ap.add_argument("--serve-no-warm", action="store_true",
                    help="--serve: no warm pass, every pass timed (the "
                         "jobs' traces already drawn in this process by "
                         "an earlier --serve of the same mix and shape)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if args.serve and args.soak:
        print("error: --serve and --soak are exclusive (closed-loop "
              "jobs/sec vs open-loop latency)", file=sys.stderr)
        return 2
    if args.daemon and not args.soak:
        print("error: --daemon is a --soak transport", file=sys.stderr)
        return 2
    if args.serve_no_warm and (args.serve_out_dir or not args.serve):
        print("error: --serve-no-warm is a --serve option, and "
              "--serve-out-dir needs the warm pass", file=sys.stderr)
        return 2
    if args.serve:
        return serve_main(args, dev)
    if args.soak:
        return soak_main(args, dev)
    if args.replicas < 1:
        print("error: --replicas must be at least 1", file=sys.stderr)
        return 2
    if args.engine != "sync" and args.replicas > 1:
        print("error: --replicas needs --engine sync", file=sys.stderr)
        return 2
    if args.ledger and (args.engine != "async" or args.shards != 1):
        print("error: --ledger measures the async engine's message-ledger "
              "capture, unrouted; use --engine async without --shards",
              file=sys.stderr)
        return 2
    if args.coherence_profile and (args.engine != "async" or args.ledger
                                   or args.shards != 1):
        print("error: --coherence-profile measures the async engine's "
              "profiler counter plane; use --engine async without "
              "--ledger/--shards", file=sys.stderr)
        return 2
    if args.engine == "async":
        return async_main(args, dev)
    if args.shards != 1:
        print("error: --shards routes the async engine's delivery; use "
              "--engine async", file=sys.stderr)
        return 2
    if args.engine == "deep" and (args.txn_width,
                                  args.drain_depth) != (3, None):
        print("error: --txn-width and --drain-depth size the sync "
              "engine's window; use --engine sync", file=sys.stderr)
        return 2
    cfg, procedural = engine_config(args, dev)
    ensemble = args.replicas > 1

    def fresh():
        if procedural:
            return se.procedural_state(cfg, args.trace_len, device=dev)
        reps = [TransactionalSystem.from_workload(
                    cfg, args.workload, args.trace_len, workload_seed=r,
                    seed=r, device=dev,
                    **gen_kwargs(args.workload, args.local_frac)).state
                for r in range(args.replicas)]
        return se.make_ensemble(reps) if ensemble else reps[0]

    # stay inside the claim-key round budget at large N (8191 rounds at
    # 65536 nodes), as the JAX bench does
    max_rounds = min(100_000, se.claim_max_rounds(cfg) - 1)
    runner = se.run_ensemble_to_quiescence if ensemble \
        else se.run_sync_to_quiescence

    def run(st, limit=max_rounds):
        return runner(cfg, st, args.chunk, limit, args.fold_impl)

    timer = PhaseTimer()
    runs = timed_runs(args, dev, fresh, run, timer)
    wall = statistics.median(r[0] for r in runs)
    st, launches = runs[0][1], runs[0][2]
    if not bool(st.quiescent()):
        print("error: the run did not reach quiescence", file=sys.stderr)
        return 1
    rounds = int(st.metrics.rounds.reshape(-1)[0])
    retired = int(st.metrics.instrs_retired.sum())
    doc = {"metric": "instrs_per_sec", "instrs_per_sec": retired / wall,
           "rounds": rounds, "ms_per_round": wall * 1e3 / rounds,
           "wall_s": wall, "reps_s": [r[0] for r in runs],
           "instrs_retired": retired, "card": card_name_and_limit(dev),
           "engine": args.engine, "workload": args.workload,
           "procedural": procedural, "replicas": args.replicas,
           "fold_impl": args.fold_impl, "fused_round": cfg.fused_round,
           "window_kernels": cfg.pallas_burst, "launches": launches,
           "phases": timer.report(),
           "config": {"nodes": args.nodes, "trace_len": args.trace_len,
                      "chunk": args.chunk, "deep_slots": cfg.deep_slots,
                      "deep_g": cfg.deep_ownerval_slots,
                      "deep_waves": cfg.deep_waves,
                      "deep_slack": cfg.deep_horizon_slack,
                      "read_storm": cfg.deep_read_storm,
                      "exact_flags": cfg.deep_exact_flags,
                      "admission": cfg.admission_window,
                      "procedural": procedural,
                      "txn_width": cfg.txn_width,
                      "drain_depth": cfg.drain_depth}}
    if args.profile:
        if ensemble:
            st = fresh()
            for _ in range(16):
                st = se.ensemble_round_step(cfg, st, args.fold_impl)
            doc["profile"] = profile_steps(
                lambda s: se.ensemble_round_step(cfg, s, args.fold_impl),
                st, args.profile)
        else:
            st = se.run_rounds(cfg, fresh(), 16, args.fold_impl)
            doc["profile"] = profile_rounds(cfg, st, args.profile,
                                            args.fold_impl)
    instruments(args, dev, cfg, doc, timer, fresh, run,
                lambda st: run(st, args.chunk))
    print(json.dumps(doc))
    if args.record:
        rep = (f", {args.replicas} replicas" if ensemble else "")
        rep += ", procedural" if procedural else ""
        fp = vec = None
        if not ensemble:
            st0 = fresh()
            fp, vec = cost_records(dev, lambda: (
                roofline.kernel_record("sync.round_step", se.round_step,
                                       cfg, st0, args.fold_impl),
                roofline.kernel_record(
                    f"sync.run_to_quiescence[chunk={args.chunk}]",
                    se.run_sync_to_quiescence, cfg, st0, args.chunk,
                    args.chunk, args.fold_impl)), rounds, retired)
        record(args, dev, f"{args.engine}@{args.nodes}", {
            "metric": f"simulated RD/WR instrs/sec @{args.nodes} cores "
                      f"({args.engine} engine, {args.workload}{rep}, 1 "
                      f"chip, {platform(dev)})",
            "value": doc["instrs_per_sec"], "unit": "instrs/sec",
            "vs_baseline": doc["instrs_per_sec"] / 1e8},
            doc, rounds, True, run_fingerprint(args, max_rounds, procedural),
            hlo_fingerprint=fp, cost=vec)
    return 0


def timed_runs(args, dev: torch.device, fresh, run, timer) -> list:
    """One discarded warm-up, then ``--reps`` timed runs of ``run(fresh())``
    (inside ``obs.profiler.capture(--profile-dir)``): [(wall seconds,
    final state, launch counts)], the split of each timed run into
    ``execute_dispatch`` (the call returns) and ``device_get_sync``
    (``torch.cuda.synchronize()`` returns) credited to ``timer``."""
    def one_run(timer=None):
        st = fresh()
        _sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        st = run(st)
        t1 = time.perf_counter()
        _sync(dev)
        t2 = time.perf_counter()
        if timer is not None:
            timer.add("execute_dispatch", t1 - t0)
            timer.add("device_get_sync", t2 - t1)
        return t2 - t0, st, launch_counts()

    one_run()                                   # warm-up, discarded
    with profiler.capture(args.profile_dir):
        return [one_run(timer) for _ in range(args.reps)]


def instruments(args, dev: torch.device, cfg: SystemConfig, doc: dict,
                timer, fresh, run, run_chunk, contracts=None) -> None:
    """The JAX bench's ``--kernel-costs`` and ``--timer-check``: the
    dispatch record of one chunk of the headline runner
    (``run_chunk(state)``; ``cfg`` sizes its kernels' contracts)
    attached to the phase report, and the timer self-check of one
    ``run(fresh())`` in ``doc["timer_check"]``. On the card a record
    that fails is an error."""
    if args.kernel_costs:
        rep = profiler.attach_kernel_costs(timer, run_chunk, fresh(),
                                           cfg=cfg, contracts=contracts)
        if dev.type == "cuda" and not rep["available"]:
            raise RuntimeError(f"--kernel-costs: the dispatch record "
                               f"failed: {rep.get('error')}")
        doc["phases"] = timer.report()
    if args.timer_check:
        doc["timer_check"] = profiler.timer_self_check(
            lambda: run(fresh()), reps=1)


def cost_records(dev: torch.device, records, steps: int,
                 retired: int) -> tuple:
    """(hlo_fingerprint, cost vector) of a history entry from
    ``records()``, the dispatch records (per step, runner) of the
    measured config (JAX ``bench.py:894-930``): the runner's fingerprint
    and ``roofline.cost_vector``. On the card a record that fails is an
    error; on the CPU a failure leaves a note and (None, None), as the
    JAX bench's "recording must never kill the bench" does."""
    try:
        per_rec, run_rec = records()
        bad = [r for r in (per_rec, run_rec) if not r["cost_available"]]
        if bad and dev.type == "cuda":
            raise RuntimeError(f"dispatch record {bad[0]['name']} failed: "
                               f"{bad[0].get('error')}")
        return (run_rec.get("hlo_fingerprint")
                or per_rec.get("hlo_fingerprint"),
                roofline.cost_vector(per_rec, run_rec, steps, retired))
    except Exception as e:
        if dev.type == "cuda":
            raise
        print(f"note: cost vector unavailable: {e}", file=sys.stderr)
        return None, None


def engine_config(args, dev: torch.device) -> tuple:
    """(cfg, procedural) of the deep and sync engines from the bench's
    flags, by the JAX bench's rules (``bench.py:565-584``): the deep
    knobs, the admission window, the procedural stream for the uniform
    workload at ``--replicas`` 1 unless ``--no-procedural``, and the
    kernel routes the device takes."""
    if args.engine == "sync":
        on = args.window_kernels == "on" or (
            args.window_kernels == "auto" and dev.type == "cuda")
        cfg = sync_config(args.nodes, args.txn_width, args.drain_depth, on,
                          admission=args.admission)
    else:
        cfg = with_fused_round(
            deep_config(args.nodes, args.deep_slots, args.deep_g,
                        args.deep_waves, args.deep_slack, args.read_storm,
                        not args.no_exact_flags, args.admission),
            args.fused_round, dev)
    procedural = args.procedural
    if procedural and (args.workload != "uniform" or args.replicas > 1):
        print("note: the procedural stream needs the uniform workload and "
              "--replicas 1; measuring stored traces instead",
              file=sys.stderr)
        procedural = False
    if procedural:
        cfg = dataclasses.replace(
            cfg, proc_local_permille=int(args.local_frac * 1000))
    else:
        cfg = dataclasses.replace(cfg, procedural=None,
                                  max_instrs=args.trace_len)
    return cfg, procedural


def platform(dev: torch.device) -> str:
    """The JAX bench's platform word for ``dev``: ``gpu`` for a CUDA
    card (as JAX names one), else ``cpu``."""
    return "gpu" if dev.type == "cuda" else "cpu"


def run_fingerprint(args, max_cycles: int, procedural: bool,
                    transport=None) -> dict:
    """The JAX bench's fingerprint of one machine's run
    (``bench.py:605-619``) less ``platform`` and ``smoke``; routed
    delivery over shards (``transport``) stands for its ``sharded``."""
    routed = transport not in (None, "none")
    return {"engine": args.engine, "workload": args.workload,
            "nodes": args.nodes, "trace_len": args.trace_len,
            "chunk": args.chunk, "reps": args.reps,
            "max_cycles": max_cycles, "replicas": args.replicas,
            "procedural": procedural, "sharded": routed, "devices": 1,
            "transport": transport if routed else None,
            "ledger": args.ledger,
            "coherence_profile": args.coherence_profile}


def record(args, dev: torch.device, label: str, result: dict, doc: dict,
           steps: int, quiescent: bool, config: dict, serve=None,
           latency=None, hlo_fingerprint=None, cost=None) -> None:
    """Append this run to the history at ``args.record``: one v1.4 entry
    (``obs.history.entry``) whose result is ``result``, whose extra comes
    from the bench's JSON line ``doc``, and whose fingerprint is
    ``config`` (the JAX bench's keys, ``bench.py:115-121``, ``:272-280``,
    ``:605-619``) with the platform and ``smoke`` added; the solo runs
    pass ``hlo_fingerprint`` and ``cost`` (``cost_records``)."""
    import os

    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import history
    extra = {"engine": config["engine"],
             "rep_times_s": doc.get("reps_s") or [doc["wall_s"]],
             "elapsed_s": doc["wall_s"], "steps": steps,
             "retired": doc.get("instrs_retired"), "quiescent": quiescent,
             "phases": doc.get("phases")}
    entry = history.entry(
        label=label, source="bench", result=result, extra=extra,
        config=dict(config, platform=platform(dev), smoke=False),
        sha=history.git_sha(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        captured_at=time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        device_kind=roofline.detect_device_kind(dev),
        hlo_fingerprint=hlo_fingerprint, cost=cost, serve=serve,
        latency=latency)
    history.append(args.record, entry)
    print(f"recorded to {args.record}", file=sys.stderr)


def async_main(args, dev: torch.device) -> int:
    """``--engine async``: the message-level engine to quiescence."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import (
        mesh, sharded_step, shardmap_comm)
    if args.nodes % args.shards:
        print(f"error: --shards {args.shards} must divide --nodes "
              f"{args.nodes}", file=sys.stderr)
        return 2
    cfg = dataclasses.replace(
        async_config(args.nodes, args.trace_len, args.queue_capacity,
                     args.admission),
        transport=args.transport,
        proc_local_permille=int(args.local_frac * 1000))
    layout = mesh.make_layout(args.nodes, args.shards, device=dev)
    deliver_fn = sharded_step.transport_deliver(cfg, layout)
    transport = getattr(deliver_fn, "transport", "none")
    max_cycles = 200 * args.trace_len

    def fresh():
        return CoherenceSystem.from_workload(
            cfg, args.workload, device=dev,
            **gen_kwargs(args.workload, args.local_frac)).state

    def plain(st):
        return step.run_chunked_to_quiescence(cfg, st, args.chunk,
                                              max_cycles,
                                              deliver_fn=deliver_fn)

    run, mode = plain, "plain"
    if args.ledger or args.coherence_profile:
        # the capture replays a fixed cycle count: the plain run's
        cap_cycles = int(plain(fresh()).metrics.cycles)
    if args.ledger:
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import txntrace
        mode = "ledger"

        def run(st):
            return txntrace.capture(cfg, st, cap_cycles, chunk=args.chunk,
                                    stop_on_quiescence=False)[0]
    if args.coherence_profile:
        mode = "coherence_profile"

        def run(st):
            return step.run_cycles_profile(cfg, st, cap_cycles)[0]

    timer = PhaseTimer()
    runs = timed_runs(args, dev, fresh, run, timer)
    wall = statistics.median(r[0] for r in runs)
    st, launches = runs[0][1], runs[0][2]
    if not bool(st.quiescent()):
        print("error: the run did not reach quiescence", file=sys.stderr)
        return 1
    cycles = int(st.metrics.cycles)
    retired = int(st.metrics.instrs_retired)
    doc = {"metric": f"instrs_per_sec (async, {args.workload})",
           "instrs_per_sec": retired / wall, "cycles": cycles,
           "ms_per_cycle": wall * 1e3 / cycles, "wall_s": wall,
           "reps_s": [r[0] for r in runs], "instrs_retired": retired,
           "msgs_dropped": int(st.metrics.msgs_dropped),
           "card": card_name_and_limit(dev), "engine": "async",
           "workload": args.workload, "procedural": False,
           "shards": args.shards, "transport": transport,
           "capture": mode, "launches": launches,
           "phases": timer.report(),
           "config": {"nodes": args.nodes, "trace_len": args.trace_len,
                      "chunk": args.chunk,
                      "queue_capacity": cfg.queue_capacity,
                      "admission": cfg.admission_window,
                      "inv_mode": cfg.inv_mode,
                      "proc_local_permille": cfg.proc_local_permille,
                      "local_frac": args.local_frac}}
    if args.profile:
        # the profiler window steps the cycle with the run's capture on
        st = step.run_cycles(cfg, fresh(), 64, deliver_fn=deliver_fn)
        kw = {"plain": {}, "ledger": {"with_ledger": True},
              "coherence_profile": {"with_profile": True,
                                    "prof": step.profile_zeros(cfg, dev)},
              }[mode]

        def step_fn(s):
            out = step.cycle(cfg, s, deliver_fn=deliver_fn, **kw)
            return out[0] if kw else out
        doc["profile"] = profile_steps(step_fn, st, args.profile)
    ring = None
    if transport == "rdma":
        _, _, _, L, cap, Fw = shardmap_comm.geometry(cfg, layout, None)
        ring = {"ring": ring_kernel.io_contract_bytes(args.shards, cap,
                                                      2 + Fw)}
    instruments(args, dev, cfg, doc, timer, fresh, run,
                lambda st: step.run_chunked_to_quiescence(
                    cfg, st, args.chunk, args.chunk, deliver_fn=deliver_fn),
                contracts=ring)
    print(json.dumps(doc))
    if args.record:
        # the JAX bench's records: the unrouted cycle and runner
        st0 = fresh()
        fp, vec = cost_records(dev, lambda: (
            roofline.kernel_record("step.cycle", step.cycle, cfg, st0),
            roofline.kernel_record(
                f"step.run_chunked[chunk={args.chunk}]",
                step.run_chunked_to_quiescence, cfg, st0, args.chunk,
                args.chunk)), cycles, retired)
        record(args, dev, f"async@{args.nodes}"
               + ("+ledger" if args.ledger else "")
               + ("+cohprof" if args.coherence_profile else ""), {
                   "metric": f"simulated RD/WR instrs/sec @{args.nodes} "
                             f"cores (async engine, {args.workload}, 1 "
                             f"chip, {platform(dev)})",
                   "value": doc["instrs_per_sec"], "unit": "instrs/sec",
                   "vs_baseline": doc["instrs_per_sec"] / 1e8},
               doc, cycles, True, run_fingerprint(args, max_cycles, False,
                                                  transport),
               hlo_fingerprint=fp, cost=vec)
    return 0


def _serving_setup(args):
    """(max_cycles, queue capacity) of the serving benches: the JAX
    bench's budget and its queue rule (the false_sharing member makes
    every node hammer one home block, so capacity scales with nodes)."""
    return args.max_cycles or 100_000, max(64, 2 * args.nodes)


def wave_cycles(doc: dict, chunk: int) -> int:
    """Wave cycles a serve pass ran: each wave runs whole chunks until
    its slowest job is done (the jobs' counters stop at their own)."""
    return sum(chunk * -(-max(doc["jobs"][j]["cycles"] for j in w["jobs"])
                         // chunk) for w in doc["waves"])


def serve_main(args, dev: torch.device) -> int:
    """``--serve``: jobs/sec through the batched serving layer."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import serve as serve_mod
    from ue22cs343bb1_openmp_assignment_tpu_torch import state as st
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    n_jobs = args.serve_jobs or 2 * args.serve_slots
    specs = serve_mod.mixed_jobs(n_jobs, nodes=args.nodes,
                                 trace_len=args.trace_len)
    max_cycles, qcap = _serving_setup(args)

    def one_pass(out_dir=None):
        _sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        doc = serve_mod.serve(specs, slots=args.serve_slots,
                              chunk=args.chunk, max_cycles=max_cycles,
                              queue_capacity=qcap, device=dev,
                              out_dir=out_dir)
        _sync(dev)
        return time.perf_counter() - t0, doc, launch_counts()

    # the warm pass draws every job's trace (later passes reuse them)
    warm_s, doc0, warm_launches = ((None, None, None) if args.serve_no_warm
                                   else one_pass(args.serve_out_dir))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs = [one_pass() for _ in range(args.reps)]
    wall = statistics.median(r[0] for r in runs)
    doc = runs[0][1]
    if any(r[1]["jobs"] != (doc0 or doc)["jobs"] for r in runs):
        print("error: the passes' job documents differ", file=sys.stderr)
        return 1
    cycles = wave_cycles(doc, args.chunk)
    out = {"metric": f"serve jobs/sec @{args.nodes}x{args.trace_len} "
                     f"x{n_jobs} jobs (async engine, mixed traffic)",
           "jobs_per_sec": n_jobs / wall, "padding_waste":
           doc["padding_waste"], "wall_s": wall,
           "reps_s": [r[0] for r in runs], "warm_s": warm_s,
           "slots": args.serve_slots, "jobs": n_jobs,
           "jobs_quiesced": doc["jobs_quiesced"],
           "waves": doc["wave_count"], "wave_cycles": cycles,
           "ms_per_wave_cycle": wall * 1e3 / cycles,
           "mb_dropped": doc["mb_dropped"],
           "instrs_retired": sum(j["metrics"]["instrs_retired"]
                                 for j in doc["jobs"].values()),
           "launches_warm": warm_launches, "launches": runs[0][2],
           "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
           "card": card_name_and_limit(dev), "engine": "async",
           "config": {"nodes": args.nodes, "trace_len": args.trace_len,
                      "chunk": args.chunk, "queue_capacity": qcap,
                      "max_cycles": max_cycles}}
    if args.profile:
        # a full batch of the mix's first jobs, C wave cycles, beside C
        # cycles of one machine of the same shape
        scfg = serve_mod.slot_config(specs, queue_capacity=qcap)
        batch = st.stack_states([
            serve_mod.build_job_state(scfg, scfg, specs[i % n_jobs], dev)
            for i in range(args.serve_slots)])
        out["profile"] = profile_steps(
            lambda b: step._masked_cycles(scfg, b, 1, max_cycles, None),
            batch, args.profile)
        out["profile_solo"] = profile_steps(
            lambda s: step.cycle(scfg, s),
            serve_mod.build_job_state(scfg, scfg, specs[0], dev),
            args.profile)
    print(json.dumps(out))
    quiet = doc["jobs_quiesced"] == doc["jobs_total"]
    if args.record:
        serve = {"slots": args.serve_slots, "jobs": n_jobs,
                 "waves": doc["wave_count"], "devices": 1,
                 "mb_dropped": doc["mb_dropped"],
                 "padding_waste": round(doc["padding_waste"], 4)}
        record(args, dev, f"serve@{args.serve_slots}", {
            "metric": f"serve jobs/sec @{args.nodes}x{args.trace_len} "
                      f"x{n_jobs} jobs (async engine, mixed traffic, "
                      f"{platform(dev)})",
            "value": out["jobs_per_sec"], "unit": "jobs/sec",
            "vs_baseline": 0.0}, out, doc["wave_count"], quiet,
            {"engine": "async", "mode": "serve", "workload": "mixed",
             "nodes": args.nodes, "trace_len": args.trace_len,
             "chunk": args.chunk, "reps": args.reps,
             "max_cycles": max_cycles, "slots": args.serve_slots,
             "jobs": n_jobs, "devices": 1}, serve=serve)
    return 0 if quiet else 1


def soak_main(args, dev: torch.device) -> int:
    """``--soak``: open-loop job latency through the soak harness, in
    process or (``--daemon``) through a daemon on a unix socket."""
    import dataclasses as _dc
    import os
    import tempfile
    import threading
    from ue22cs343bb1_openmp_assignment_tpu_torch import soak as soak_mod
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import (
        VirtualClock)
    max_cycles, qcap = _serving_setup(args)
    arrivals = soak_mod.soak_stream(
        args.arrival_rate, args.soak_duration, nodes=args.nodes,
        trace_len=args.trace_len, seed=0)
    daemon = None
    tmp = tempfile.TemporaryDirectory(prefix="cache-sim-bench-")
    if args.daemon:
        from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.client import (
            DaemonClient)
        from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.core import (
            DaemonCore)
        from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.server import (
            DaemonServer)
        sock = os.path.join(tmp.name, "daemon.sock")
        server = DaemonServer(
            DaemonCore(slots=args.serve_slots, chunk=args.chunk,
                       max_cycles=max_cycles, queue_capacity=qcap,
                       device=dev), sock, quiet=True)
        thread = threading.Thread(target=server.run, daemon=True,
                                  name="bench-daemon")
        thread.start()
        daemon = (sock, server, thread)

    def run(clock=None):
        return soak_mod.soak(arrivals, slots=args.serve_slots,
                             chunk=args.chunk, max_cycles=max_cycles,
                             queue_capacity=qcap,
                             arrival_rate=args.arrival_rate, clock=clock,
                             device=dev)

    try:
        t0 = time.perf_counter()
        if daemon:
            # one throwaway job of the stream shape warms the daemon's
            # bucket before latencies are sampled
            with DaemonClient(daemon[0]) as c:
                c.wait_up()
                c.submit(_dc.replace(arrivals[0][1], name="warmup000"))
                c.wait("warmup000", timeout_s=300.0)
        else:
            run(VirtualClock())
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if daemon:
            doc = soak_mod.soak_daemon(arrivals, daemon[0],
                                       arrival_rate=args.arrival_rate)
        else:
            doc = run()
        wall = time.perf_counter() - t0
    finally:
        if daemon:
            sock, server, thread = daemon
            try:
                with DaemonClient(sock) as c:
                    c.shutdown()
            except (ConnectionError, OSError):
                server.stop()
            thread.join(30.0)
        tmp.cleanup()
    lat = doc["latency"]
    if lat is None:
        print("error: the soak released no jobs (duration too short "
              "for the arrival rate)", file=sys.stderr)
        return 1
    out = {"metric": f"soak p95 job latency @{args.nodes}x"
                     f"{args.trace_len} (async engine, mixed traffic, "
                     f"open loop)",
           "p95_ms": lat["p95_ms"], "latency": lat,
           "verdict": doc["verdict"], "jobs": doc["jobs_total"],
           "jobs_quiesced": doc["jobs_quiesced"],
           "rejected": len(doc.get("rejected") or []),
           "waves": doc["wave_count"], "wall_s": wall, "warm_s": warm_s,
           "mb_dropped": doc["mb_dropped"],
           "padding_waste": doc["padding_waste"],
           "transport": "daemon" if args.daemon else "inproc",
           "card": card_name_and_limit(dev),
           "config": {"nodes": args.nodes, "trace_len": args.trace_len,
                      "chunk": args.chunk, "slots": args.serve_slots,
                      "arrival_rate": args.arrival_rate,
                      "duration_s": args.soak_duration,
                      "queue_capacity": qcap, "max_cycles": max_cycles}}
    if args.daemon:
        out["bucket_growths"] = doc["daemon_stats"]["bucket_growths"]
    print(json.dumps(out))
    quiet = doc["jobs_quiesced"] == doc["jobs_total"]
    if args.record:
        transport = "daemon" if args.daemon else "inproc"
        latency = {
            "p50_ms": lat["p50_ms"], "p95_ms": lat["p95_ms"],
            "p99_ms": lat["p99_ms"], "max_ms": lat["max_ms"],
            "jobs": lat["jobs"], "arrival_rate": float(args.arrival_rate),
            "queue_depth_peak": doc["series_summary"]["queue_depth_peak"],
            "samples_ms": (doc.get("samples_ms")
                           or [round(s["e2e_s"] * 1e3, 6)
                               for s in doc["trace"]["spans"]]),
            "duration_s": float(args.soak_duration),
            "saturated": doc["verdict"]["saturated"],
            "drain_rate_jobs_per_s": doc["drain_rate_jobs_per_s"]}
        serve = {"slots": args.serve_slots, "jobs": doc["jobs_total"],
                 "waves": doc["wave_count"], "devices": 1,
                 "mb_dropped": doc["mb_dropped"],
                 "padding_waste": round(doc["padding_waste"], 4),
                 "transport": transport}
        record(args, dev, f"soak@{args.arrival_rate:g}/s", {
            "metric": f"soak p95 job latency @{args.nodes}x"
                      f"{args.trace_len} (async engine, mixed traffic, "
                      f"open loop, {platform(dev)})",
            "value": round(lat["p95_ms"], 3), "unit": "ms p95",
            "vs_baseline": 0.0}, out, doc["wave_count"], quiet,
            {"engine": "async", "mode": "soak", "workload": "mixed",
             "nodes": args.nodes, "trace_len": args.trace_len,
             "chunk": args.chunk, "max_cycles": max_cycles,
             "slots": args.serve_slots, "arrival_rate": args.arrival_rate,
             "duration_s": args.soak_duration, "transport": transport},
            serve=serve, latency=latency)
    return 0 if quiet else 1


if __name__ == "__main__":
    sys.exit(main())
