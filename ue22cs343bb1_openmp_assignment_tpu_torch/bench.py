"""Throughput benchmark of the port's main path (one JSON line).

    python -m ue22cs343bb1_openmp_assignment_tpu_torch.bench [--nodes N]
        [--trace-len L] [--chunk K] [--reps R] [--fold-impl kernel|plain]
        [--fused-round auto|on|off] [--profile ROUNDS] [--device cuda|cpu]

Runs the deep-window transactional engine at the JAX ``bench.py``'s deep
defaults (4096 nodes, 4096 procedural-uniform instructions per node,
locality 0.8, drain_depth 13, txn_width 3, deep_slots 3, one owner-value
slot, slack 4, one wave, exact flags, chunk 64) to quiescence: one
discarded warm-up, then the median of ``--reps`` runs, each clock stop
after ``torch.cuda.synchronize()``. ``--fused-round`` selects the round:
the whole round as one kernel (``ops/deep_round_kernel``) or the fold
path (three fold kernels around the plain round middle); ``auto``, the
default, takes the fused round on a card where ``supported(cfg)`` holds,
as the JAX ``bench.py`` does on a TPU. The JSON line carries instrs/sec,
rounds, ms/round, the card's name and power limit, which round ran and
the kernels' launch counts of one run. ``--profile R`` adds a
torch.profiler window of R rounds: device-busy share, device launches
and device time by kernel.
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
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se


def deep_config(nodes: int) -> SystemConfig:
    """bench.py's deep-engine config at ``nodes`` (deep_slots 2 from
    32768 nodes up, as there)."""
    cfg = SystemConfig.scale(num_nodes=nodes, drain_depth=13, txn_width=3)
    return dataclasses.replace(
        cfg, deep_window=True, deep_slots=2 if nodes >= 32768 else 3,
        deep_ownerval_slots=1, deep_horizon_slack=4, procedural="uniform",
        max_instrs=1, proc_local_permille=800)


def reset_launch_counts() -> None:
    dfk.reset_launch_counts()
    drk.fused_round.launches = 0


def launch_counts() -> dict:
    """Launches of every kernel of the port since the last reset."""
    return dict(dfk.launch_counts(), round=drk.fused_round.launches)


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


def profile_rounds(cfg, st, rounds: int, fold_impl: str) -> dict:
    """Device-busy share, device launches and device time by kernel over
    `rounds` rounds (the wall time here includes the profiler's cost)."""
    box = [st]

    def run():
        for _ in range(rounds):
            box[0] = se.round_step(cfg, box[0], fold_impl)

    events, wall = device_events(run)
    by_name = {}
    for name, us in events:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + us, n + 1)
    busy_us = sum(us for _, us in events)
    fold_us = sum(us for name, us in events if "deep_fold_kernel" in name)
    round_us = sum(us for name, us in events
                   if "deep_round_kernel" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"rounds": rounds, "wall_ms_per_round": wall * 1e3 / rounds,
            "device_busy_ms_per_round": busy_us / 1e3 / rounds,
            "device_idle_share": 1 - busy_us / 1e6 / wall,
            "fold_kernel_ms_per_round": fold_us / 1e3 / rounds,
            "round_kernel_ms_per_round": round_us / 1e3 / rounds,
            "device_launches_per_round": len(events) / rounds,
            "top_kernels": [{"name": k[:80], "ms_per_round":
                             us / 1e3 / rounds, "calls_per_round":
                             n / rounds} for k, (us, n) in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--trace-len", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--fold-impl", choices=["kernel", "plain"],
                    default="kernel")
    ap.add_argument("--fused-round", choices=["auto", "on", "off"],
                    default="auto")
    ap.add_argument("--profile", type=int, default=0, metavar="ROUNDS")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = with_fused_round(deep_config(args.nodes), args.fused_round, dev)

    def one_run():
        st = se.procedural_state(cfg, args.trace_len, device=dev)
        _sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        st = se.run_sync_to_quiescence(cfg, st, args.chunk,
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
           "fold_impl": args.fold_impl, "fused_round": cfg.fused_round,
           "launches": launches,
           "config": {"nodes": args.nodes, "trace_len": args.trace_len,
                      "chunk": args.chunk, "deep_slots": cfg.deep_slots}}
    if args.profile:
        st = se.run_rounds(cfg, se.procedural_state(
            cfg, args.trace_len, device=dev), 16, args.fold_impl)
        doc["profile"] = profile_rounds(cfg, st, args.profile,
                                        args.fold_impl)
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
