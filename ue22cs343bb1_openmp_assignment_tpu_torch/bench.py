"""Throughput benchmark of the port's main paths (one JSON line).

    python -m ue22cs343bb1_openmp_assignment_tpu_torch.bench
        [--engine deep|sync] [--nodes N] [--trace-len L] [--chunk K]
        [--reps R] [--txn-width K] [--drain-depth H]
        [--fold-impl kernel|plain] [--fused-round auto|on|off]
        [--window-kernels auto|on|off] [--profile ROUNDS]
        [--device cuda|cpu]
    python -m ue22cs343bb1_openmp_assignment_tpu_torch.bench --engine async
        [--queue-capacity Q] [--shards D] [--transport rdma|all_to_all]
        [--profile CYCLES]

Runs a transactional engine at the JAX ``bench.py``'s defaults (4096
nodes, 4096 procedural-uniform instructions per node, locality 0.8,
chunk 64) to quiescence: one discarded warm-up, then the median of
``--reps`` runs, each clock stop after ``torch.cuda.synchronize()``.

``--engine deep`` (the default) is the deep-window engine (drain_depth
13, txn_width 3, deep_slots 3, one owner-value slot, slack 4, one wave,
exact flags). ``--fused-round`` selects its round: the whole round as
one kernel (``ops/deep_round_kernel``) or the fold path (three fold
kernels around the plain round middle); ``auto``, the default, takes the
fused round on a card where ``supported(cfg)`` holds, as the JAX
``bench.py`` does on a TPU.

``--engine sync`` is the sync window engine: txn_width 3 and drain_depth
4 by default, drain_depth 16 at ``--txn-width 1``. ``--window-kernels``
sets ``cfg.pallas_burst``, which routes the whole round through one
kernel: ``ops/sync_multi_round_kernel`` at txn_width >= 2 (the window
kernels of ``ops/sync_window_kernel`` where it does not take the config:
more than 32 lines a node), ``ops/sync_round_kernel`` at txn_width 1;
``auto`` turns it on for a card, ``off`` measures the plain rounds.

``--engine async`` is the message-level engine (``ops.step``) at the JAX
``bench.py``'s async defaults: scatter INV (``SystemConfig.scale``),
queue capacity 64, locality 0.8, chunk 64, run to quiescence
(``run_chunked_to_quiescence``). Its stream is ``procedural_uniform``:
the JAX async default ``uniform`` draws from jax.random, whose twin the
port does not have yet, so the metric names the workload. ``--shards D``
routes phase-3 delivery over D shards of the node axis
(``parallel.rdma_comm.make_routed_deliver``): ``--transport rdma`` (the
ring kernel, ``parallel/ring_kernel``) or ``all_to_all`` (the plain lane
exchange); one shard delivers unrouted.

The JSON line carries instrs/sec, rounds (cycles for the async engine),
ms/round (ms/cycle), the card's name and power limit, which path ran and
the kernels' launch counts of one run. ``--profile R`` adds a
torch.profiler window of R rounds or cycles: device-busy share, device
launches and device time by kernel.
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
from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import ring_kernel

#: the port's kernels by the name the profiler reports them under
KERNEL_NAMES = {"fold": "deep_fold_kernel", "round": "deep_round_kernel",
                "sync_burst": "sync_burst_kernel",
                "sync_round": "sync_round_kernel",
                "sync_multi_round": "sync_multi_round_kernel",
                "sync_window": "sync_window_kernel",
                "sync_replay": "sync_replay_kernel",
                "ring": "ring_exchange_kernel"}


def deep_config(nodes: int) -> SystemConfig:
    """bench.py's deep-engine config at ``nodes`` (deep_slots 2 from
    32768 nodes up, as there)."""
    cfg = SystemConfig.scale(num_nodes=nodes, drain_depth=13, txn_width=3)
    return dataclasses.replace(
        cfg, deep_window=True, deep_slots=2 if nodes >= 32768 else 3,
        deep_ownerval_slots=1, deep_horizon_slack=4, procedural="uniform",
        max_instrs=1, proc_local_permille=800)


def sync_config(nodes: int, txn_width: int = 3, drain_depth=None,
                window_kernels: bool = False) -> SystemConfig:
    """bench.py's sync-engine config at ``nodes``: txn_width 3 and
    drain_depth 4, or drain_depth 16 at txn_width 1, procedural uniform
    at locality 0.8; ``window_kernels`` sets ``pallas_burst``."""
    if drain_depth is None:
        drain_depth = 16 if txn_width == 1 else 4
    cfg = SystemConfig.scale(num_nodes=nodes, drain_depth=drain_depth,
                             txn_width=txn_width)
    return dataclasses.replace(
        cfg, procedural="uniform", max_instrs=1, proc_local_permille=800,
        pallas_burst=window_kernels)


_COUNTED = {"round": drk.fused_round, "sync_burst": sbk.burst,
            "sync_round": srk.fused_round,
            "sync_multi_round": smk.fused_round, "sync_window": swk.window,
            "sync_replay": swk.replay, "ring": ring_kernel.exchange}


def reset_launch_counts() -> None:
    dfk.reset_launch_counts()
    for fn in _COUNTED.values():
        fn.launches = 0


def launch_counts() -> dict:
    """Launches of every kernel of the port since the last reset."""
    return dict(dfk.launch_counts(),
                **{k: fn.launches for k, fn in _COUNTED.items()})


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


#: the async engine's stream: the JAX bench's ``uniform`` needs the
#: jax.random twin the port does not have yet
ASYNC_WORKLOAD = "procedural_uniform"


def async_config(nodes: int, trace_len: int,
                 queue_capacity: int = 64) -> SystemConfig:
    """bench.py's async-engine config at ``nodes``: scatter INV, the
    queue capacity, locality 0.8, ``trace_len`` instructions a node."""
    return SystemConfig.scale(num_nodes=nodes, queue_capacity=queue_capacity,
                              max_instrs=trace_len, proc_local_permille=800)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=["deep", "sync", "async"],
                    default="deep")
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--trace-len", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--fold-impl", choices=["kernel", "plain"],
                    default="kernel")
    ap.add_argument("--fused-round", choices=["auto", "on", "off"],
                    default="auto")
    ap.add_argument("--txn-width", type=int, default=3)
    ap.add_argument("--drain-depth", type=int, default=None)
    ap.add_argument("--window-kernels", choices=["auto", "on", "off"],
                    default="auto")
    ap.add_argument("--profile", type=int, default=0, metavar="ROUNDS")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--transport", choices=["rdma", "all_to_all"],
                    default="rdma")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if args.engine == "async":
        return async_main(args, dev)
    if args.shards != 1:
        print("error: --shards routes the async engine's delivery; use "
              "--engine async", file=sys.stderr)
        return 2
    if args.engine == "sync":
        on = args.window_kernels == "on" or (
            args.window_kernels == "auto" and dev.type == "cuda")
        cfg = sync_config(args.nodes, args.txn_width, args.drain_depth, on)
    else:
        if (args.txn_width, args.drain_depth) != (3, None):
            print("error: --txn-width and --drain-depth size the sync "
                  "engine's window; use --engine sync", file=sys.stderr)
            return 2
        cfg = with_fused_round(deep_config(args.nodes), args.fused_round,
                               dev)

    def one_run():
        st = se.procedural_state(cfg, args.trace_len, device=dev)
        _sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        # stay inside the claim-key round budget at large N (8191
        # rounds at 65536 nodes), as the JAX bench does
        st = se.run_sync_to_quiescence(
            cfg, st, args.chunk,
            max_rounds=min(100_000, se.claim_max_rounds(cfg) - 1),
            fold_impl=args.fold_impl)
        _sync(dev)
        return time.perf_counter() - t0, st, launch_counts()

    one_run()                                   # warm-up, discarded
    runs = [one_run() for _ in range(args.reps)]
    wall = statistics.median(r[0] for r in runs)
    st, launches = runs[0][1], runs[0][2]
    if not bool(st.quiescent()):
        print("error: the run did not reach quiescence", file=sys.stderr)
        return 1
    rounds = int(st.metrics.rounds)
    retired = int(st.metrics.instrs_retired)
    doc = {"metric": "instrs_per_sec", "instrs_per_sec": retired / wall,
           "rounds": rounds, "ms_per_round": wall * 1e3 / rounds,
           "wall_s": wall, "reps_s": [r[0] for r in runs],
           "instrs_retired": retired, "card": card_name_and_limit(dev),
           "engine": args.engine, "fold_impl": args.fold_impl,
           "fused_round": cfg.fused_round,
           "window_kernels": cfg.pallas_burst, "launches": launches,
           "config": {"nodes": args.nodes, "trace_len": args.trace_len,
                      "chunk": args.chunk, "deep_slots": cfg.deep_slots,
                      "txn_width": cfg.txn_width,
                      "drain_depth": cfg.drain_depth}}
    if args.profile:
        st = se.run_rounds(cfg, se.procedural_state(
            cfg, args.trace_len, device=dev), 16, args.fold_impl)
        doc["profile"] = profile_rounds(cfg, st, args.profile,
                                        args.fold_impl)
    print(json.dumps(doc))
    return 0


def async_main(args, dev: torch.device) -> int:
    """``--engine async``: the message-level engine to quiescence."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import (
        mesh, sharded_step)
    if args.nodes % args.shards:
        print(f"error: --shards {args.shards} must divide --nodes "
              f"{args.nodes}", file=sys.stderr)
        return 2
    cfg = dataclasses.replace(
        async_config(args.nodes, args.trace_len, args.queue_capacity),
        transport=args.transport)
    deliver_fn = sharded_step.transport_deliver(
        cfg, mesh.make_layout(args.nodes, args.shards, device=dev))
    transport = getattr(deliver_fn, "transport", "none")
    max_cycles = 200 * args.trace_len

    def fresh():
        return CoherenceSystem.from_workload(cfg, ASYNC_WORKLOAD,
                                             device=dev).state

    def one_run():
        st = fresh()
        _sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        st = step.run_chunked_to_quiescence(cfg, st, args.chunk, max_cycles,
                                            deliver_fn=deliver_fn)
        _sync(dev)
        return time.perf_counter() - t0, st, launch_counts()

    one_run()                                   # warm-up, discarded
    runs = [one_run() for _ in range(args.reps)]
    wall = statistics.median(r[0] for r in runs)
    st, launches = runs[0][1], runs[0][2]
    if not bool(st.quiescent()):
        print("error: the run did not reach quiescence", file=sys.stderr)
        return 1
    cycles = int(st.metrics.cycles)
    retired = int(st.metrics.instrs_retired)
    doc = {"metric": f"instrs_per_sec (async, {ASYNC_WORKLOAD})",
           "instrs_per_sec": retired / wall, "cycles": cycles,
           "ms_per_cycle": wall * 1e3 / cycles, "wall_s": wall,
           "reps_s": [r[0] for r in runs], "instrs_retired": retired,
           "msgs_dropped": int(st.metrics.msgs_dropped),
           "card": card_name_and_limit(dev), "engine": "async",
           "workload": ASYNC_WORKLOAD, "shards": args.shards,
           "transport": transport, "launches": launches,
           "config": {"nodes": args.nodes, "trace_len": args.trace_len,
                      "chunk": args.chunk,
                      "queue_capacity": cfg.queue_capacity,
                      "inv_mode": cfg.inv_mode,
                      "proc_local_permille": cfg.proc_local_permille}}
    if args.profile:
        st = step.run_cycles(cfg, fresh(), 64, deliver_fn=deliver_fn)
        doc["profile"] = profile_steps(
            lambda s: step.cycle(cfg, s, deliver_fn=deliver_fn), st,
            args.profile)
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
