"""Command-line entry point of the port.

    cache-sim-torch <test_directory> [--tests-root DIR] [--out-dir DIR]
    python -m ue22cs343bb1_openmp_assignment_tpu_torch.cli ...

The port of the JAX package's ``cli.py``, with the same flags and the
same output: ``cache-sim-torch <test_directory>`` mirrors the
reference's ``./cache_simulator <test_directory>``
(``assignment.c:126-131``): it loads ``tests/<dir>/core_<n>.txt``
relative to --tests-root, runs to quiescence and writes
``core_<n>_output.txt`` golden dumps into the CWD (or --out-dir). Beyond
the reference: runtime dimensions, synthetic workloads (--workload),
schedule knobs (--delays/--periods/--arb-seed), fault injection,
invariant checks, event logs, checkpoints, seed sweeps and the
``cache-sim/metrics/v1.2`` report (--metrics), on three engines:
``async`` (the message-level engine), ``sync`` (the transactional
engine; --procedural, --txn-width, --deep-window) and ``native`` (the
C++ oracle on the host).

State lives on the card; ``--cpu`` puts every tensor on the CPU, where
each kernel's wrapper runs its plain version. With no card and no
``--cpu`` the CLI exits with an error: it never falls back to the CPU.
On the card the engines take the kernel routes that the config allows,
as the port's bench does: ``pallas_burst`` for a procedural sync config
(``csrc/sync_round.cu`` at txn_width 1, ``csrc/sync_multi_round.cu``
above it) and ``fused_round`` for a deep config that
``deep_round_kernel.supported`` takes (``csrc/deep_round.cu``). The
results are bit-identical on every route, so the dumps, logs and
metrics equal the JAX CLI's.

The verbs ``stats``, ``trace``, ``txns``, ``critical-path`` and
``profile`` run an engine under the observability captures
(``obs/verbs.py``, the port of the JAX ``obs/cli.py`` verbs).
``--flight-dir`` arms the failure flight recorder (``obs/flight.py``) on
the async engine: on a hang, a watchdog trip or a failed ``--check`` it
replays the run from its initial state under the captures and dumps an
incident directory (``incident.json`` with the last ``--flight-ring``
cycles of telemetry, the metrics doc, the transaction summary and the
coherence profile, and ``trace.perfetto.json``).

The serving verbs run the batched serving layer and the daemon:
``serve`` (``serve.py``: a job stream in fixed-shape vmapped waves),
``soak`` (``soak.py``: an open-loop arrival stream, in process or
through a daemon), ``daemon`` (``daemon/server.py``: the long-lived
server), its clients ``submit`` and ``watch`` (``daemon/client.py``) and
``top`` (``obs/fleet.py``: the merged stats of one or more daemons).
Like the engines, ``serve``, ``soak`` and ``daemon`` run on the card
unless given ``--cpu``.

``bench-diff`` (``obs/bench_diff.py``) compares two bench captures or
the last two entries of a bench history (``bench --record``) with the
statistics of ``obs/regress.py``; ``replay`` (``replay.py``) re-drives a
serving recording or a soak incident's recording slice, on the card
unless given ``--cpu``, and checks every job's dump digest.
``perf-report`` (``obs/perf_report.py``) attributes a run's bytes and
launches kernel by kernel (``obs/roofline.py``), on the card unless
given ``--cpu``; ``dashboard`` (``obs/dashboard_verb.py``) renders a
bench history into HTML and markdown and runs no engine. ``analyze``
(``analysis/runner.py``) is the static-analysis gate: the model checker
(its oracle on the card unless given ``--cpu``), the trace lint, the
protocol tables and the litmus suite.

Not ported: ``--engine omp``, which builds the reference's own
``assignment.c``, not part of this repository.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

#: the serving verbs (JAX ``cli.py:634-655``) and the host verbs
#: ``analyze``, ``bench-diff``, ``replay``, ``perf-report`` and
#: ``dashboard`` (``:605-608``, ``:616-618``, ``:656-659``,
#: ``:625-633``): verb -> (module, function)
SERVING_VERBS = {
    "serve": ("serve", "main"), "soak": ("soak", "main"),
    "daemon": ("daemon.server", "main"), "submit": ("daemon.client", "main"),
    "watch": ("daemon.client", "main_watch"), "top": ("obs.fleet", "main"),
    "bench-diff": ("obs.bench_diff", "main_bench_diff"),
    "replay": ("replay", "main"),
    "perf-report": ("obs.perf_report", "main_perfreport"),
    "dashboard": ("obs.dashboard_verb", "main_dashboard"),
    "analyze": ("analysis.runner", "main")}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cache-sim-torch",
        description="directory/MESI coherence simulator on PyTorch and "
                    "CUDA (the port of cache-sim)")
    p.add_argument("test_dir", nargs="?", default=None,
                   help="test directory name (reference-compat positional)")
    p.add_argument("--tests-root", default="tests",
                   help="prefix for <test_dir> (reference hardcodes 'tests/',"
                        " assignment.c:824)")
    p.add_argument("--out-dir", default=".",
                   help="where to write core_<n>_output.txt dumps")
    p.add_argument("--workload", choices=["uniform", "producer_consumer",
                                          "false_sharing",
                                          "false_sharing_vars",
                                          "false_sharing_vars_padded",
                                          "fft", "radix",
                                          "hotspot", "zipf_hotspot",
                                          "lu"],
                   help="run a synthetic workload instead of trace files "
                        "(fft/radix are SPLASH-2-style reference "
                        "patterns; false_sharing_vars[_padded] is the "
                        "colliding-variables stress and its padding fix; "
                        "zipf_hotspot is the heavy-tailed Zipf address "
                        "mix)")
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--trace-len", type=int, default=32)
    p.add_argument("--queue-capacity", type=int, default=None,
                   help="mailbox slots per node (default 256; shape-"
                        "determining, so it cannot change on --resume)")
    p.add_argument("--seed", type=int, default=0,
                   help="workload PRNG seed")
    p.add_argument("--delays", type=int, nargs="*",
                   help="per-node instruction issue delays (schedule knob)")
    p.add_argument("--periods", type=int, nargs="*",
                   help="per-node instruction issue periods (schedule knob)")
    p.add_argument("--arb-seed", type=int,
                   help="seed for the cross-sender arbitration permutation "
                        "(replaces the reference's OS lock-order "
                        "nondeterminism)")
    p.add_argument("--admission", type=int, default=None,
                   help="max concurrent outstanding requests (backpressure "
                        "window preventing mailbox-overflow livelock; "
                        "default: reference drop semantics)")
    p.add_argument("--max-cycles", type=int, default=100_000)
    p.add_argument("--metrics", action="store_true",
                   help="print step metrics as JSON to stderr")
    p.add_argument("--save-checkpoint", metavar="PATH",
                   help="write a full-state checkpoint after the run "
                        "(the JAX package's format; resume with --resume "
                        "in either package)")
    p.add_argument("--resume", metavar="PATH",
                   help="resume from a checkpoint instead of initializing "
                        "(ignores workload/trace/dimension flags)")
    p.add_argument("--run-cycles", type=int, default=None,
                   help="run exactly this many cycles instead of running "
                        "to quiescence (for checkpoint-then-resume runs)")
    p.add_argument("--dump", action="store_true",
                   help="write golden dumps even without a <test_directory>"
                        " (e.g. after --resume)")
    p.add_argument("--check", action="store_true",
                   help="verify engine invariants after the run and report "
                        "coherence diagnostics (the reference's -DDEBUG "
                        "asserts, whole-machine and vectorized; exit 3 on "
                        "violation)")
    p.add_argument("--check-strict", action="store_true",
                   help="like --check but also fail on coherence-tier "
                        "violations (only meaningful for race-free "
                        "schedules; racy workloads can legally leave "
                        "stale copies — the protocol acks no INVs)")
    p.add_argument("--drop-prob", type=float, default=None,
                   help="fault injection: drop each delivered message "
                        "with this probability (stress for the stall "
                        "watchdog; default 0 = off)")
    p.add_argument("--fault-seed", type=int, default=None,
                   help="PRNG seed for --drop-prob injection "
                        "(default 0; on --resume, re-seeds the "
                        "checkpointed fault PRNG when given)")
    p.add_argument("--stall-threshold", type=int, default=100,
                   help="cycles a node may wait on one request before "
                        "the watchdog reports it stalled")
    p.add_argument("--trace-log", metavar="PATH",
                   help="write an instruction_order.txt-format event log "
                        "of the run (the reference's -DDEBUG_INSTR "
                        "tracing, assignment.c:649-652)")
    p.add_argument("--trace-msgs", action="store_true",
                   help="include message-dequeue events in --trace-log "
                        "(the reference's -DDEBUG_MSG, "
                        "assignment.c:179-182)")
    p.add_argument("--flight-dir", metavar="DIR",
                   help="arm the failure flight recorder (obs/flight): "
                        "on a hang, watchdog trip, or --check "
                        "invariant failure, dump a self-contained "
                        "incident dir here (last --flight-ring cycles "
                        "of telemetry + metrics doc + Perfetto trace "
                        "of the deterministic replay)")
    p.add_argument("--flight-ring", type=int, default=64,
                   help="flight recorder ring depth in cycles "
                        "(default 64)")
    p.add_argument("--cpu", action="store_true",
                   help="put every tensor on the CPU (default: the CUDA "
                        "card; without one the CLI exits with an error)")
    p.add_argument("--engine", choices=["async", "sync", "native"],
                   default="async",
                   help="async = message-level engine (reference "
                        "network semantics, schedule knobs, fault "
                        "injection); sync = transactional engine "
                        "(atomic coherence rounds, the throughput "
                        "path); native = host-side C++ engine with "
                        "async semantics (the differential oracle)")
    p.add_argument("--drain-depth", type=int, default=None,
                   help="sync engine: hit-burst length per round")
    p.add_argument("--txn-width", type=int, default=None,
                   help="sync engine: max coherence transactions "
                        "committed per node per round (multi-"
                        "transaction windows; default 1 = classic "
                        "burst-plus-one-transaction rounds)")
    p.add_argument("--procedural", action="store_true",
                   help="sync engine: compute the uniform workload "
                        "procedurally in-round (O(1) trace memory; "
                        "--trace-len may be arbitrarily long); pairs "
                        "with --seed as the stream seed")
    p.add_argument("--deep-window", action="store_true",
                   help="sync engine: deep-window rounds (dense "
                        "own-entry transaction chains + absorbed remote "
                        "events, ops.deep_engine; --drain-depth sizes "
                        "the window, default 13)")
    p.add_argument("--deep-slots", type=int, default=None,
                   help="deep windows: remote-event slots per window "
                        "(default 8; on --resume an omitted flag keeps "
                        "the checkpoint's value)")
    p.add_argument("--deep-waves", type=int, default=None,
                   help="deep windows: absorption waves — up to this "
                        "many fill requests (mixed read/write) compose "
                        "per directory entry per round (max 14; default "
                        "1; on --resume an omitted flag keeps the "
                        "checkpoint's value)")
    p.add_argument("--deep-g", type=int, default=None,
                   help="deep windows: owner-value slots per window "
                        "(default 4, the config's; on --resume an "
                        "omitted flag keeps the checkpoint's value)")
    p.add_argument("--deep-slack", type=int, default=None,
                   help="deep windows: adaptive attempt-horizon slack "
                        "(default 2, the config's; on --resume an "
                        "omitted flag keeps the checkpoint's value)")
    p.add_argument("--read-storm", action="store_true",
                   help="deep windows: bulk-grant all same-round losing "
                        "READ requests per entry (the many-readers "
                        "lever; the fused round does not take it)")
    p.add_argument("--no-exact-flags", action="store_true",
                   help="deep windows: attempt-based marker/poison "
                        "flags instead of the commit-prefix-exact flag "
                        "pass (cfg.deep_exact_flags off)")
    p.add_argument("--sweep-seeds", type=int, metavar="K",
                   help="sync engine: run K arbitration seeds as one "
                        "ensemble and report which seeds reproduce an "
                        "accepted run_* outcome of the test directory "
                        "(the batched replacement for the reference's "
                        "run-until-match harness, test3.sh:6-33); exit 4 "
                        "if no seed matches")
    return p


def _arb_rank(seed: int, num_nodes: int) -> np.ndarray:
    """--arb-seed → arbitration permutation; the single definition keeps
    the engines (and the JAX package's) seed-for-seed comparable."""
    return np.argsort(
        np.random.RandomState(seed).rand(num_nodes)).astype(np.int32)


def _schedule_knobs(args, num_nodes: int) -> dict:
    """--delays/--periods/--arb-seed → state-field overrides as numpy
    arrays (one source of truth for fresh runs and --resume)."""
    kw = {}
    if args.delays:
        kw["issue_delay"] = np.asarray(args.delays, np.int32)
    if args.periods:
        kw["issue_period"] = np.asarray(args.periods, np.int32)
    if args.arb_seed is not None:
        kw["arb_rank"] = _arb_rank(args.arb_seed, num_nodes)
    return kw


def kernel_routes(cfg, dev):
    """``cfg`` as the CLI runs it on ``dev``: on the card, with the
    kernel routes the config allows, as the port's bench takes them (the
    fused deep round where ``deep_round_kernel.supported``, the fused
    sync rounds for a procedural workload). Checkpoints keep the config
    without them, as the JAX CLI writes it."""
    if dev.type != "cuda":
        return cfg
    if cfg.deep_window:
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
            deep_round_kernel)
        return dataclasses.replace(
            cfg, fused_round=deep_round_kernel.supported(cfg))
    if cfg.procedural:
        return dataclasses.replace(cfg, pallas_burst=True)
    return cfg


def _sync_dims(args) -> dict:
    """The transactional engine's dimensions from the flags."""
    dims = dict(num_nodes=args.nodes)
    if args.drain_depth is not None:
        dims["drain_depth"] = args.drain_depth
    if args.txn_width is not None:
        dims["txn_width"] = args.txn_width
    if args.deep_window:
        dims.update(deep_window=True,
                    deep_slots=(8 if args.deep_slots is None
                                else args.deep_slots),
                    deep_waves=(1 if args.deep_waves is None
                                else args.deep_waves),
                    txn_width=dims.get("txn_width", 3))
        dims.setdefault("drain_depth", 13)
        dims.update(_deep_knobs(args))
    return dims


def _deep_knobs(args) -> dict:
    """The config fields of the deep flags that default to the config's
    own values (``--deep-g``, ``--deep-slack``, ``--read-storm``,
    ``--no-exact-flags``): only those the command line sets."""
    over = {}
    if args.deep_g is not None:
        over["deep_ownerval_slots"] = args.deep_g
    if args.deep_slack is not None:
        over["deep_horizon_slack"] = args.deep_slack
    if args.read_storm:
        over["deep_read_storm"] = True
    if args.no_exact_flags:
        over["deep_exact_flags"] = False
    return over


def procedural_config(args):
    """The config of ``--engine sync --procedural`` (parsed ``args``),
    as the JAX CLI builds it, without the kernel routes."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    return SystemConfig.scale(
        procedural="uniform", max_instrs=1, proc_seed=args.seed,
        queue_capacity=args.queue_capacity or 64, **_sync_dims(args))


def _main_sync(args, dev) -> int:
    """--engine sync: the transactional engine's CLI path."""
    import torch

    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    from ue22cs343bb1_openmp_assignment_tpu_torch.utils import (
        checkpoint as ckpt)
    from ue22cs343bb1_openmp_assignment_tpu_torch.utils.golden import (
        write_dumps)

    for flag, why in (("delays", "message-level issue schedules"),
                      ("periods", "message-level issue schedules"),
                      ("drop_prob", "message-drop fault injection"),
                      ("trace_msgs", "message-dequeue event tracing"),
                      ("admission", "mailbox backpressure")):
        if getattr(args, flag):
            print(f"error: --{flag.replace('_', '-')} needs the mailbox "
                  f"network ({why}); use --engine async", file=sys.stderr)
            return 2

    if args.sweep_seeds is not None:
        if args.sweep_seeds < 1:
            print("error: --sweep-seeds must be >= 1", file=sys.stderr)
            return 2
        if not args.test_dir:
            print("error: --sweep-seeds needs a <test_directory> with "
                  "accepted run_* outcomes", file=sys.stderr)
            return 2
        for flag in ("resume", "save_checkpoint", "run_cycles",
                     "trace_log", "check", "check_strict", "metrics",
                     "arb_seed", "dump"):
            if getattr(args, flag) not in (None, False):
                print(f"error: --{flag.replace('_', '-')} cannot combine "
                      "with --sweep-seeds (the sweep reports matches "
                      "only)", file=sys.stderr)
                return 2

    seed = args.arb_seed if args.arb_seed is not None else 0
    if args.resume:
        cfg, st, meta = ckpt.load_checkpoint(args.resume, device=dev)
        if meta.get("kind") != "sync":
            print("error: checkpoint was written by the async engine; "
                  "resume it without --engine sync", file=sys.stderr)
            return 2
        if (args.drain_depth is not None or args.txn_width is not None
                or args.deep_window or args.deep_slots is not None
                or args.deep_waves is not None or _deep_knobs(args)):
            # pure compute knobs (window shape; no state shapes depend
            # on them): overridable on resume; an omitted --deep-slots
            # keeps the checkpoint's slot count
            over = {}
            if args.drain_depth is not None:
                over["drain_depth"] = args.drain_depth
            if args.txn_width is not None:
                over["txn_width"] = args.txn_width
            if args.deep_window:
                over["deep_window"] = True
            if args.deep_waves is not None:
                over["deep_waves"] = args.deep_waves
            if args.deep_slots is not None:
                over["deep_slots"] = args.deep_slots
            over.update(_deep_knobs(args))
            old_cfg = cfg
            cfg = dataclasses.replace(cfg, **over)

            # a new lane-key layout (deep_window, slot bits, read storm)
            # would leave stale DM_CLAIM keys packed under the old one
            def _layout(c):
                return (c.deep_window, se.slot_bits(c),
                        c.deep_read_storm)
            if _layout(old_cfg) != _layout(cfg):
                st = st.replace(dm=se.reset_claims(st.dm))
        if args.arb_seed is not None:
            st = st.replace(seed=torch.tensor(args.arb_seed,
                                              dtype=torch.int32, device=dev))
    else:
        dims = _sync_dims(args)
        if args.procedural:
            cfg = procedural_config(args)
            st = se.procedural_state(cfg, args.trace_len, seed=seed,
                                     device=dev)
        elif args.workload:
            cfg = SystemConfig.scale(
                queue_capacity=args.queue_capacity or 64, **dims)
            system = CoherenceSystem.from_workload(
                cfg, args.workload, trace_len=args.trace_len,
                seed=args.seed, device=dev)
        elif args.test_dir:
            cfg = SystemConfig.reference(**dims)
            path = os.path.join(args.tests_root, args.test_dir)
            try:
                system = CoherenceSystem.from_test_dir(path, cfg,
                                                       device=dev)
            except FileNotFoundError as e:
                print(e, file=sys.stderr)
                return 1
            for n in range(cfg.num_nodes):
                print(f"Processor {n} initialized")  # assignment.c:850
        else:
            print("error: provide <test_directory> or --workload",
                  file=sys.stderr)
            return 2
        if not args.procedural:
            st = se.from_sim_state(cfg, system.state, seed=seed)
    run_cfg = kernel_routes(cfg, dev)

    if args.sweep_seeds is not None:
        # one ensemble of K machines that differ only in their
        # arbitration seed (utils.search), matched against run_* dumps
        from ue22cs343bb1_openmp_assignment_tpu_torch.utils import search
        path = os.path.join(args.tests_root, args.test_dir)
        named = search.load_accepted_named(path, cfg.num_nodes)
        if not named:
            print(f"error: {path} has no run_* accepted-outcome "
                  "directories", file=sys.stderr)
            return 2
        ens = search.sweep_seeds(
            run_cfg, system.state, range(args.sweep_seeds),
            max_rounds=min(args.max_cycles, se.claim_max_rounds(cfg) - 1))
        quiet = torch.all(ens.idx >= ens.instr_count, dim=1).cpu().numpy()
        if not quiet.all():
            print(f"warning: {int((~quiet).sum())} of {args.sweep_seeds} "
                  f"replicas not quiescent after --max-cycles "
                  f"{args.max_cycles} rounds; their dumps cannot match",
                  file=sys.stderr)
        matches = {}
        for r in range(args.sweep_seeds):
            if not quiet[r]:
                continue
            dumps = search.replica_dumps(cfg, ens, r)
            for name, acc in named:
                if dumps == acc:
                    matches[r] = name
                    break
        print(json.dumps({"matches": {str(k): v
                                      for k, v in matches.items()},
                          "seeds_tried": args.sweep_seeds,
                          "accepted_runs": len(named)}))
        return 0 if matches else 4

    if args.trace_log:
        from ue22cs343bb1_openmp_assignment_tpu_torch.utils import eventlog
        chunk = 32
        cap = (args.run_cycles if args.run_cycles is not None
               else args.max_cycles)
        base = int(st.round)
        all_events = []
        done = 0
        while done < cap:
            n = min(chunk, cap - done)
            st, ev = se.run_rounds_traced(run_cfg, st, n)
            all_events.append({k: v.cpu().numpy() for k, v in ev.items()})
            done += n
            if args.run_cycles is None and bool(st.quiescent()):
                break
        merged = {k: np.concatenate([e[k] for e in all_events])
                  for k in all_events[0]} if all_events else {}
        if merged:
            eventlog.write_sync_log(args.trace_log, merged, base)
        else:
            open(args.trace_log, "w").close()
    elif args.run_cycles is not None:
        st = se.run_rounds(run_cfg, st, args.run_cycles)
    else:
        st = se.run_sync_to_quiescence(run_cfg, st, 16, args.max_cycles)
    if args.save_checkpoint:
        ckpt.save_checkpoint(args.save_checkpoint, cfg, st)
    if args.run_cycles is None and not bool(st.quiescent()):
        print(f"warning: not quiescent after {args.max_cycles} rounds "
              "(conflict retries still pending; raise --max-cycles)",
              file=sys.stderr)
    if args.check or args.check_strict:
        try:
            report = se.check_exact_directory(cfg, st)
        except AssertionError as e:
            print(f"invariant check FAILED: {e}", file=sys.stderr)
            return 3
        print(f"invariant check passed (exact directory); report: "
              f"{json.dumps(report)}", file=sys.stderr)
    if args.test_dir or args.dump:
        write_dumps(cfg, se.to_dump_view(cfg, st), args.out_dir)
    if args.metrics:
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (
            schema as obs)
        m = {f: int(getattr(st.metrics, f)) for f in se.METRIC_FIELDS}
        engine = "deep" if cfg.deep_window else "sync"
        print(json.dumps(obs.from_sync(m, engine)), file=sys.stderr)
    return 0


def _main_native(args, dev) -> int:
    """--engine native: the C++ oracle as an execution backend.

    Same observable semantics as the async engine (message-level
    cycles, schedule knobs); it runs on the host. A --workload is drawn
    on ``dev`` (the threefry kernel on the card) and copied to the
    host."""
    import types as _t

    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu_torch.native.bindings import (
        NativeEngine)
    from ue22cs343bb1_openmp_assignment_tpu_torch.utils.golden import (
        write_dumps)
    from ue22cs343bb1_openmp_assignment_tpu_torch.utils.trace import (
        load_test_dir)

    for flag, why in (("drop_prob", "fault injection"),
                      ("trace_log", "event tracing"),
                      ("admission", "admission gating"),
                      ("save_checkpoint", "checkpointing"),
                      ("resume", "checkpointing"),
                      ("check", "vectorized invariant checking"),
                      ("check_strict", "vectorized invariant checking")):
        if getattr(args, flag):
            print(f"error: --{flag.replace('_', '-')} ({why}) is a "
                  "tensor-engine feature; use --engine async",
                  file=sys.stderr)
            return 2

    if args.workload:
        from ue22cs343bb1_openmp_assignment_tpu_torch.models import (
            workloads)
        cfg = SystemConfig.scale(num_nodes=args.nodes,
                                 max_instrs=args.trace_len,
                                 queue_capacity=args.queue_capacity or 256)
        arrs = workloads.GENERATORS[args.workload](
            args.seed, cfg, args.trace_len, device=dev)
        eng = NativeEngine(cfg)
        eng.load_instr_arrays(*(a.cpu().numpy() for a in arrs))
    elif args.test_dir:
        cfg = SystemConfig.reference(num_nodes=args.nodes)
        path = os.path.join(args.tests_root, args.test_dir)
        try:
            traces = load_test_dir(path, cfg.num_nodes, cfg.max_instrs)
        except FileNotFoundError as e:
            print(e, file=sys.stderr)
            return 1
        eng = NativeEngine(cfg)
        eng.load_traces(traces)
        for n in range(cfg.num_nodes):
            print(f"Processor {n} initialized")  # assignment.c:850
    else:
        print("error: provide <test_directory> or --workload",
              file=sys.stderr)
        return 2

    if args.delays or args.periods:
        for knob in ("delays", "periods"):
            vals = getattr(args, knob)
            if vals and len(vals) != cfg.num_nodes:
                print(f"error: --{knob} needs one value per node "
                      f"(got {len(vals)}, --nodes is {cfg.num_nodes})",
                      file=sys.stderr)
                return 2
        eng.set_schedule(args.delays or None, args.periods or None)
    if args.arb_seed is not None:
        eng.set_arbitration(_arb_rank(args.arb_seed, cfg.num_nodes))

    eng.run(args.run_cycles if args.run_cycles is not None
            else args.max_cycles)
    if args.run_cycles is None and not eng.quiescent:
        print(f"warning: not quiescent after {args.max_cycles} cycles",
              file=sys.stderr)
    if args.test_dir or args.dump:
        write_dumps(cfg, _t.SimpleNamespace(**eng.export_state()),
                    args.out_dir)
    if args.metrics:
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (
            schema as obs)
        print(json.dumps(obs.from_native(eng.metrics())), file=sys.stderr)
    return 0


def _main_async(args, dev) -> int:
    """--engine async (the default): the message-level engine."""
    import torch

    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)

    for knob in ("delays", "periods"):
        vals = getattr(args, knob)
        if vals and len(vals) != args.nodes:
            print(f"error: --{knob} needs one value per node "
                  f"(got {len(vals)}, --nodes is {args.nodes})",
                  file=sys.stderr)
            return 2

    if args.resume:
        try:
            system = CoherenceSystem.load(args.resume, device=dev)
        except ValueError as e:
            if "SyncState" in str(e) or "instr_pack" in str(e):
                print("error: checkpoint was written by the transactional "
                      "engine; resume it with --engine sync",
                      file=sys.stderr)
                return 2
            raise
        cfg = system.cfg
        if args.nodes != cfg.num_nodes and (args.delays or args.periods):
            print("error: --delays/--periods with --resume need --nodes to "
                  f"match the checkpoint ({cfg.num_nodes})", file=sys.stderr)
            return 2
        if (args.queue_capacity is not None
                and args.queue_capacity != cfg.queue_capacity):
            print("error: --queue-capacity is shape-determining and cannot "
                  f"change on --resume (checkpoint has "
                  f"{cfg.queue_capacity})", file=sys.stderr)
            return 2
        # behavior knobs (shape-free) override the checkpointed config:
        # the watchdog's recommended recovery path
        cfg_over = {}
        if args.admission is not None:
            cfg_over["admission_window"] = args.admission
        if args.drop_prob is not None:
            cfg_over["drop_prob"] = args.drop_prob
        if cfg_over:
            cfg = dataclasses.replace(cfg, **cfg_over)
            system = dataclasses.replace(system, cfg=cfg)
        # schedule knobs override the checkpointed ones when given
        overrides = {k: torch.as_tensor(v, device=dev)
                     for k, v in _schedule_knobs(args, cfg.num_nodes).items()}
        if args.fault_seed is not None:
            from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
                fault_key_from_seed)
            overrides["fault_key"] = fault_key_from_seed(args.fault_seed, dev)
        if overrides:
            system = dataclasses.replace(
                system, state=system.state.replace(**overrides))
    elif args.workload:
        cfg = SystemConfig.scale(num_nodes=args.nodes,
                                 queue_capacity=args.queue_capacity or 256,
                                 admission_window=args.admission,
                                 drop_prob=args.drop_prob or 0.0)
        init_kw = _schedule_knobs(args, args.nodes)
        init_kw["fault_seed"] = args.fault_seed or 0
        system = CoherenceSystem.from_workload(
            cfg, args.workload, trace_len=args.trace_len, seed=args.seed,
            init_kw=init_kw, device=dev)
    elif args.test_dir:
        init_kw = _schedule_knobs(args, args.nodes)
        init_kw["fault_seed"] = args.fault_seed or 0
        cfg = SystemConfig.reference(num_nodes=args.nodes,
                                     admission_window=args.admission,
                                     drop_prob=args.drop_prob or 0.0)
        path = os.path.join(args.tests_root, args.test_dir)
        try:
            system = CoherenceSystem.from_test_dir(path, cfg, device=dev,
                                                   **init_kw)
        except FileNotFoundError as e:
            print(e, file=sys.stderr)  # clean exit like assignment.c:826-829
            return 1
        for n in range(cfg.num_nodes):
            print(f"Processor {n} initialized")  # assignment.c:850
    else:
        print("error: provide <test_directory> or --workload",
              file=sys.stderr)
        return 2

    # flight recorder: keep the pre-run state; on an incident the
    # deterministic engine replays it under the captures, so the normal
    # path pays nothing
    flight0 = system.state if args.flight_dir else None

    def _flight_dump(reason: str, detail: str = "") -> None:
        if flight0 is None:
            return
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import flight
        fr = flight.FlightRecorder(system.cfg, flight0,
                                   k=args.flight_ring)
        fr.run(max(1, int(system.state.cycle) - int(flight0.cycle)),
               stop_on_quiescence=False)
        out = os.path.join(args.flight_dir,
                           f"incident_{reason.split(':', 1)[0]}")
        fr.dump_incident(out, reason, detail)
        print(f"flight recorder: incident dumped to {out}",
              file=sys.stderr)

    if args.trace_log:
        from ue22cs343bb1_openmp_assignment_tpu_torch.utils import eventlog
        trace_base = int(system.state.cycle)
        if args.run_cycles is not None:
            system, events = system.run_cycles_traced(args.run_cycles)
        else:
            system, events = system.run_traced(args.max_cycles)
        kinds = ("instr", "msg") if args.trace_msgs else ("instr",)
        if events:
            eventlog.write_log(args.trace_log, events, kinds,
                               base_cycle=trace_base)
        else:
            open(args.trace_log, "w").close()
    elif args.run_cycles is not None:
        system = system.run_cycles(args.run_cycles)
    else:
        # quiescence tested every cycle: the JAX run's cycle count
        system = system.run(args.max_cycles, chunk=1)
    if args.save_checkpoint:
        system.save(args.save_checkpoint)
    if args.run_cycles is None and not system.quiescent:
        m = system.metrics
        hint = ""
        if m["msgs_dropped"] > 0:
            hint = (f" ({m['msgs_dropped']} messages dropped on full "
                    "mailboxes — likely livelocked; rerun with --admission "
                    f"{max(1, cfg.queue_capacity // 6)} or a larger "
                    "--queue-capacity)")
        if m["msgs_injected_dropped"] > 0:
            hint += (f" ({m['msgs_injected_dropped']} messages dropped by "
                     f"--drop-prob {cfg.drop_prob} fault injection)")
        print(f"warning: not quiescent after {args.max_cycles} cycles{hint}",
              file=sys.stderr)
        report = system.stall_report(args.stall_threshold)
        if report["count"]:
            print(f"watchdog: {report['count']} node(s) stalled "
                  f">{args.stall_threshold} cycles on one request "
                  f"(first few: {report['nodes'][:4]}); recover by "
                  "resuming a checkpoint with backpressure (--admission) "
                  "or a different schedule", file=sys.stderr)
            _flight_dump("watchdog:stall",
                         f"{report['count']} node(s) stalled "
                         f">{args.stall_threshold} cycles; nodes "
                         f"{report['nodes'][:4]}")
        else:
            _flight_dump("hang:not_quiescent",
                         f"not quiescent after {args.max_cycles} "
                         f"cycles{hint}")

    if args.check or args.check_strict:
        try:
            report = system.check_invariants(
                strict_coherence=args.check_strict)
        except AssertionError as e:
            print(f"invariant check FAILED: {e}", file=sys.stderr)
            _flight_dump("invariant:check", str(e))
            return 3
        if not system.quiescent:
            # the coherence tier is only defined at quiescence
            if args.check_strict:
                print("invariant check FAILED: machine not quiescent — "
                      "coherence tier not checkable", file=sys.stderr)
                _flight_dump("invariant:not_quiescent",
                             "coherence tier not checkable")
                return 3
            print("invariant check passed (engine tier only; not "
                  "quiescent, coherence tier skipped)", file=sys.stderr)
        else:
            print(f"invariant check passed; coherence report: "
                  f"{json.dumps(report)}", file=sys.stderr)
    if args.test_dir or args.dump:  # golden dumps (trace or forced)
        system.write_dumps(args.out_dir)
    if args.metrics:
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (
            schema as obs)
        print(json.dumps(obs.from_async(system.metrics)), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    raw = sys.argv[1:] if argv is None else list(argv)
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import verbs
    if raw[:1] and raw[0] in verbs.VERBS:
        return verbs.main(raw[0], raw[1:])
    if raw[:1] and raw[0] in SERVING_VERBS:
        import importlib
        mod, fn = SERVING_VERBS[raw[0]]
        return getattr(importlib.import_module(
            f"ue22cs343bb1_openmp_assignment_tpu_torch.{mod}"), fn)(raw[1:])
    args = build_parser().parse_args(raw)

    from ue22cs343bb1_openmp_assignment_tpu_torch import device
    try:
        dev = device.resolve("cpu" if args.cpu else None)
    except RuntimeError:
        print("error: no CUDA device is available; pass --cpu to run the "
              "plain PyTorch path on the CPU", file=sys.stderr)
        return 1

    if args.procedural and args.engine != "sync":
        print("error: --procedural needs --engine sync", file=sys.stderr)
        return 2
    if args.procedural and (args.test_dir or args.workload):
        print("error: --procedural generates its own stream; drop the "
              "<test_directory>/--workload argument", file=sys.stderr)
        return 2
    if args.sweep_seeds and args.engine != "sync":
        print("error: --sweep-seeds is an ensemble sweep on the "
              "transactional engine; add --engine sync", file=sys.stderr)
        return 2
    if args.txn_width is not None and args.engine != "sync":
        print("error: --txn-width sizes the transactional engine's "
              "multi-transaction window; add --engine sync",
              file=sys.stderr)
        return 2
    if args.deep_window and args.engine != "sync":
        print("error: --deep-window is a transactional-engine round "
              "mode; add --engine sync", file=sys.stderr)
        return 2
    if _deep_knobs(args) and not (args.deep_window or (
            args.resume and args.engine == "sync")):
        print("error: --deep-g, --deep-slack, --read-storm and "
              "--no-exact-flags are deep-window knobs; add --engine sync "
              "--deep-window", file=sys.stderr)
        return 2
    if args.engine == "sync":
        return _main_sync(args, dev)
    if args.engine == "native":
        return _main_native(args, dev)
    return _main_async(args, dev)


if __name__ == "__main__":
    sys.exit(main())
