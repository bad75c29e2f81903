"""``cache-sim-torch stats | trace | txns | critical-path | profile``:
the observability verbs that run an engine.

The port of the five engine-running verbs of the JAX package's
``obs/cli.py`` (``stats`` :66/:169, ``trace`` :94/:277, ``txns``
:334/:447, ``critical-path`` :358/:508, ``profile`` :1160/:1194), with
the same flags and the same output: ``stats`` prints the
``cache-sim/metrics/v1`` report (``--timeseries`` adds the telemetry
summary, ``--txns`` the transaction-span latency block, ``--phases`` the
wall-clock phases); ``trace`` writes a Perfetto event trace; ``txns``
prints the causal transaction spans (``--json``: the
``cache-sim/txnspans/v1`` doc; ``--perfetto``: the trace with flow
arrows); ``critical-path`` prints the critical path to quiescence;
``profile`` emits the ``cache-sim/profile/v1`` coherence profile of the
async, sync or deep engine.

The captures replay the run: a plain pass finds the step count, then
the capture runs exactly that many steps from the initial state (the
engines are deterministic and functional, so both passes walk the same
trajectory). State lives on the card; ``--cpu`` puts it on the CPU, and
with no card and no ``--cpu`` a verb exits 1 with the port CLI's error:
it never falls back to the CPU. On the card the verbs take the routes
the configs select, as the JAX verbs do: the async engine and the sync
rounds on stored traces are plain tensor code, the deep engine's plain
pass runs the fold kernels, and the captures never launch a fold or
round kernel (``run_sync_profile`` takes the plain rounds,
``run_deep_profile`` the plain folds); a ``uniform`` workload is drawn
through the threefry kernel. A capture's host read sits in the
``device_get`` phase of ``--phases``, as in JAX.

Named ``verbs.py`` because ``cli.py`` is the port's top-level CLI.
"""
# lint: host

from __future__ import annotations

import argparse
import json
import os
import sys

from ue22cs343bb1_openmp_assignment_tpu_torch.convert import host

WORKLOADS = ["uniform", "producer_consumer", "false_sharing",
             "false_sharing_vars", "false_sharing_vars_padded", "fft",
             "radix", "hotspot", "zipf_hotspot", "lu"]

_NO_CARD = ("error: no CUDA device is available; pass --cpu to run the "
            "plain PyTorch path on the CPU")
_NO_INPUT = "error: provide <test_directory> or --workload"


# lint: host
def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("test_dir", nargs="?", default=None,
                   help="test directory name (fixture traces)")
    p.add_argument("--tests-root", default="tests")
    p.add_argument("--workload", choices=WORKLOADS,
                   help="synthetic workload instead of trace files")
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--trace-len", type=int, default=32)
    p.add_argument("--seed", type=int, default=0,
                   help="workload PRNG seed")
    p.add_argument("--max-cycles", type=int, default=100_000)
    p.add_argument("--run-cycles", type=int, default=None,
                   help="run exactly this many cycles/rounds instead "
                        "of running to quiescence")
    p.add_argument("--cpu", action="store_true",
                   help="put every tensor on the CPU (default: the CUDA "
                        "card; without one the verb exits with an error)")


# lint: host
def build_stats_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cache-sim-torch stats",
        description="run a workload and emit the unified metrics "
                    "report (cache-sim/metrics/v1) to stdout")
    _add_common(p)
    p.add_argument("--engine", choices=["async", "sync", "native"],
                   default="async")
    p.add_argument("--timeseries", action="store_true",
                   help="async engine: capture the per-cycle telemetry "
                        "and attach a summary under extra")
    p.add_argument("--txns", action="store_true",
                   help="async engine: replay under the message ledger "
                        "and attach the transaction-span latency "
                        "summary as the v1.1 txn_latency block")
    p.add_argument("--timeseries-out", metavar="PATH",
                   help="also write the full per-cycle series JSON "
                        "(implies --timeseries)")
    p.add_argument("--phases", action="store_true",
                   help="attach wall-clock phase timings under extra "
                        "(off by default: timings are nondeterministic "
                        "and would break golden diffs)")
    p.add_argument("--out", metavar="PATH",
                   help="write the report here instead of stdout")
    return p


# lint: host
def build_trace_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cache-sim-torch trace",
        description="run a workload and export its event record as "
                    "Perfetto/Chrome trace-event JSON")
    _add_common(p)
    p.add_argument("--perfetto", metavar="PATH", required=True,
                   help="output path for the trace-event JSON")
    p.add_argument("--engine", choices=["async", "deep"],
                   default="async",
                   help="async = instr+msg dequeue tracks; deep = "
                        "transactional-engine retirement tracks")
    p.add_argument("--no-msgs", action="store_true",
                   help="async engine: omit the msg tracks")
    return p


# lint: host
def build_txns_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cache-sim-torch txns",
        description="replay a run under the message ledger and print "
                    "the causal transaction spans: per-type latency "
                    "decomposition (queue_wait/dir_service/in_flight/"
                    "ack_wait) and the slowest transactions")
    _add_common(p)
    p.add_argument("--top", type=int, default=10,
                   help="how many slowest transactions to show "
                        "(default 10)")
    p.add_argument("--json", action="store_true",
                   help="emit the full cache-sim/txnspans/v1 document "
                        "instead of the text tables")
    p.add_argument("--perfetto", metavar="PATH",
                   help="also write the event trace with flow arrows "
                        "linking each transaction's request/reply "
                        "slices")
    p.add_argument("--out", metavar="PATH",
                   help="write the report here instead of stdout")
    return p


# lint: host
def build_critpath_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cache-sim-torch critical-path",
        description="compute the critical path to quiescence over the "
                    "run's happens-before DAG and attribute every "
                    "cycle on it to a (node, phase) pair")
    _add_common(p)
    p.add_argument("--json", action="store_true",
                   help="emit the full cache-sim/critpath/v1 report")
    p.add_argument("--out", metavar="PATH",
                   help="write the report here instead of stdout")
    return p


# lint: host
def build_profile_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cache-sim-torch profile",
        description="replay a run under the coherence profiler "
                    "(obs.cohprof) and emit per-line contention "
                    "attribution: miss taxonomy (cold / conflict / "
                    "coherence-invalidation / upgrade), invalidation "
                    "fan-out, sharing-pattern classification, top "
                    "contended lines — and for --engine deep the "
                    "measured abort anatomy (ghost-poison fraction). "
                    "Deterministic: same config, same doc bytes.")
    _add_common(p)
    p.add_argument("--engine", choices=["async", "sync", "deep"],
                   default="async",
                   help="async = full counter plane (misses / inv / "
                        "writebacks / migrations); sync = access "
                        "planes + classifier; deep = access planes + "
                        "abort anatomy")
    p.add_argument("--top", type=int, default=8,
                   help="contended lines to attribute (default 8)")
    p.add_argument("--no-exact-flags", action="store_true",
                   help="deep engine: profile the conservative "
                        "flag-raising path (cfg.deep_exact_flags off)")
    p.add_argument("--json", action="store_true",
                   help="emit the cache-sim/profile/v1 doc instead of "
                        "the text rendering")
    p.add_argument("--out", metavar="PATH",
                   help="write the output here instead of stdout")
    return p


# -- shared ------------------------------------------------------------------

# lint: host
def _device(args):
    """The device of the run, or None (after the error line) when there
    is no card and no --cpu."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import device
    try:
        return device.resolve("cpu" if args.cpu else None)
    except RuntimeError:
        print(_NO_CARD, file=sys.stderr)
        return None


# lint: host
def _async_system(args, dev):
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    if args.workload:
        cfg = SystemConfig.scale(num_nodes=args.nodes)
        return CoherenceSystem.from_workload(
            cfg, args.workload, trace_len=args.trace_len, seed=args.seed,
            device=dev)
    if args.test_dir:
        cfg = SystemConfig.reference(num_nodes=args.nodes)
        path = os.path.join(args.tests_root, args.test_dir)
        return CoherenceSystem.from_test_dir(path, cfg, device=dev)
    return None


# lint: host
def _sync_system(args, cfg, dev):
    """The transactional machine of --workload (stored traces) or the
    test directory, or None."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional \
        import TransactionalSystem
    if args.workload:
        return TransactionalSystem.from_workload(
            cfg, args.workload, trace_len=args.trace_len,
            workload_seed=args.seed, device=dev)
    if args.test_dir:
        path = os.path.join(args.tests_root, args.test_dir)
        return TransactionalSystem.from_test_dir(path, device=dev)
    return None


# lint: host
def _emit(args, doc: dict) -> None:
    text = json.dumps(doc, indent=2, sort_keys=True) + "\n"
    _write(args, text)


# lint: host
def _write(args, text: str) -> None:
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)


# -- stats -------------------------------------------------------------------

# lint: host
def cmd_stats(args, dev) -> int:
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import schema
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs.phases import (
        PhaseTimer)
    timer = PhaseTimer()
    want_ts = args.timeseries or args.timeseries_out

    if args.engine == "native":
        if want_ts or args.txns:
            print("error: --timeseries/--txns are on-device capture; "
                  "use --engine async", file=sys.stderr)
            return 2
        doc = _stats_native(args, timer, dev)
    elif args.engine == "sync":
        if want_ts or args.txns:
            print("error: --timeseries/--txns need the message-level "
                  "engine; use --engine async", file=sys.stderr)
            return 2
        doc = _stats_sync(args, timer, dev)
    else:
        doc = _stats_async(args, timer, want_ts, dev)
    if doc is None:
        print(_NO_INPUT, file=sys.stderr)
        return 2
    if args.phases:
        doc["extra"]["phases"] = timer.report()
    _emit(args, schema.validate(doc))
    return 0


# lint: host
def _stats_async(args, timer, want_ts: bool, dev):
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (schema,
                                                              timeseries)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    with timer.phase("build"):
        system0 = _async_system(args, dev)
    if system0 is None:
        return None
    with timer.phase("run"):
        if args.run_cycles is not None:
            system = system0.run_cycles(args.run_cycles)
        else:
            system = system0.run(args.max_cycles)
    with timer.phase("device_get"):
        m = system.metrics
    doc = schema.from_async(m)
    if want_ts:
        # the telemetry replays the run from the initial state for
        # exactly the cycle count of the plain run
        with timer.phase("telemetry_run"):
            _, telem = step.run_cycles_telemetry(
                system0.cfg, system0.state, int(m["cycles"]))
        with timer.phase("device_get"):
            telem = {k: host(v) for k, v in telem.items()}
            doc["extra"]["telemetry"] = timeseries.summarize(telem)
        if args.timeseries_out:
            with open(args.timeseries_out, "w") as f:
                json.dump(timeseries.to_series(telem), f)
                f.write("\n")
    if args.txns:
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import txntrace
        # the same replay, ledger on
        with timer.phase("ledger_run"):
            _, ledger, base = txntrace.capture(
                system0.cfg, system0.state, int(m["cycles"]),
                stop_on_quiescence=False)
        spans, _ = txntrace.reconstruct(
            system0.cfg, ledger, base,
            arb_rank=host(system0.state.arb_rank))
        doc["txn_latency"] = txntrace.summarize(spans)
    return doc


# lint: host
def _stats_sync(args, timer, dev):
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import schema
    with timer.phase("build"):
        ts = _sync_system(args, SystemConfig.scale(num_nodes=args.nodes),
                          dev)
    if ts is None:
        return None
    with timer.phase("run"):
        if args.run_cycles is not None:
            ts = ts.run_rounds(args.run_cycles)
        else:
            ts = ts.run(max_rounds=args.max_cycles)
    with timer.phase("device_get"):
        m = ts.metrics
    return schema.from_sync(m)


# lint: host
def _stats_native(args, timer, dev):
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu_torch.native.bindings import (
        NativeEngine)
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import schema
    with timer.phase("build"):
        if args.workload:
            from ue22cs343bb1_openmp_assignment_tpu_torch.models import (
                workloads)
            cfg = SystemConfig.scale(num_nodes=args.nodes,
                                     max_instrs=args.trace_len)
            arrs = workloads.GENERATORS[args.workload](
                args.seed, cfg, args.trace_len, device=dev)
            eng = NativeEngine(cfg)
            eng.load_instr_arrays(*(host(a) for a in arrs))
        elif args.test_dir:
            from ue22cs343bb1_openmp_assignment_tpu_torch.utils.trace import (
                load_test_dir)
            cfg = SystemConfig.reference(num_nodes=args.nodes)
            path = os.path.join(args.tests_root, args.test_dir)
            eng = NativeEngine(cfg)
            eng.load_traces(load_test_dir(path, cfg.num_nodes,
                                          cfg.max_instrs))
        else:
            return None
    with timer.phase("run"):
        eng.run(args.run_cycles if args.run_cycles is not None
                else args.max_cycles)
    return schema.from_native(eng.metrics())


# -- trace -------------------------------------------------------------------

# lint: host
def cmd_trace(args, dev) -> int:
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import perfetto
    from ue22cs343bb1_openmp_assignment_tpu_torch.utils import eventlog

    if args.engine == "deep":
        from ue22cs343bb1_openmp_assignment_tpu_torch.config import (
            SystemConfig)
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
            sync_engine as se)
        ts = _sync_system(args, SystemConfig.scale(num_nodes=args.nodes),
                          dev)
        if ts is None:
            print(_NO_INPUT, file=sys.stderr)
            return 2
        if args.run_cycles is not None:
            rounds = args.run_cycles
        else:
            # find the round count first, then replay traced
            done = ts.run(max_rounds=args.max_cycles)
            rounds = int(done.metrics["rounds"])
        _, events = se.run_rounds_traced(ts.cfg, ts.state, rounds)
        records = eventlog.sync_to_records(events)
        num_nodes = ts.cfg.num_nodes
    else:
        system = _async_system(args, dev)
        if system is None:
            print(_NO_INPUT, file=sys.stderr)
            return 2
        base = int(system.state.cycle)
        if args.run_cycles is not None:
            system, events = system.run_cycles_traced(args.run_cycles)
        else:
            system, events = system.run_traced(args.max_cycles)
        records = (eventlog.to_records(events, base) if events else [])
        if args.no_msgs:
            records = [r for r in records if r["kind"] == "instr"]
        num_nodes = system.cfg.num_nodes

    doc = perfetto.build_trace(records, num_nodes)
    perfetto.validate_trace(doc)
    perfetto.write_trace(args.perfetto, doc)
    print(f"wrote {args.perfetto}: {len(records)} events across "
          f"{num_nodes} nodes (open in ui.perfetto.dev)",
          file=sys.stderr)
    return 0


# -- txns and critical-path --------------------------------------------------

# lint: host
def _capture_spans(args, dev):
    """Build the async system, find the run length, and replay exactly
    that many cycles under the message ledger: (spans, trace,
    total_cycles, ledger, cfg), or None when no input was given. The
    plain pass finds the cycle count, so the captured window does not
    depend on the capture's chunk."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import txntrace
    system0 = _async_system(args, dev)
    if system0 is None:
        return None
    if args.run_cycles is not None:
        total = int(args.run_cycles)
    else:
        done = system0.run(args.max_cycles)
        total = int(done.metrics["cycles"])
    _, ledger, base = txntrace.capture(
        system0.cfg, system0.state, total, stop_on_quiescence=False)
    spans, trace = txntrace.reconstruct(
        system0.cfg, ledger, base, arb_rank=host(system0.state.arb_rank))
    return spans, trace, total, ledger, system0.cfg


# lint: host
def _render_txns(spans, total: int, top: int) -> str:
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import txntrace
    lines = [f"transaction spans: {len(spans)} total over {total} "
             f"cycles"]
    table = txntrace.latency_table(spans)
    if table:
        lines.append("")
        lines.append(f"{'type':<12} {'count':>5} {'p50':>5} {'p95':>5} "
                     f"{'p99':>5} {'max':>5} {'mean':>7}")
        for t in sorted(table):
            r = table[t]
            lines.append(f"{t:<12} {r['count']:>5} {r['p50']:>5} "
                         f"{r['p95']:>5} {r['p99']:>5} {r['max']:>5} "
                         f"{r['mean']:>7.2f}")
        lines.append("")
        lines.append(f"{'type':<12} " + " ".join(
            f"{s:>12}" for s in txntrace.SEGMENTS))
        for t in sorted(table):
            segs = table[t]["segments"]
            lines.append(f"{t:<12} " + " ".join(
                f"{segs[s]['total']:>12}" for s in txntrace.SEGMENTS))
    slow = txntrace.top_slowest(spans, top)
    if slow:
        lines.append("")
        lines.append(f"slowest {len(slow)}:")
        for s in slow:
            segs = s["segments"]
            seg_txt = " ".join(f"{k}={segs[k]}"
                               for k in txntrace.SEGMENTS if segs[k])
            tag = "" if s["attributed"] else " [unattributed]"
            lines.append(
                f"  n{s['requester']} 0x{s['addr']:02X} "
                f"{s['type']:<10} issue@{s['t_issue']:>5} "
                f"e2e={s['e2e']:>4}  {seg_txt}{tag}")
    open_spans = [s for s in spans if s["t_end"] is None]
    if open_spans:
        lines.append("")
        lines.append(f"open at capture end: {len(open_spans)}")
    return "\n".join(lines) + "\n"


# lint: host
def cmd_txns(args, dev) -> int:
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (perfetto,
                                                              txntrace)
    res = _capture_spans(args, dev)
    if res is None:
        print(_NO_INPUT, file=sys.stderr)
        return 2
    spans, trace, total, ledger, cfg = res
    if args.perfetto:
        records = txntrace.ledger_to_records(ledger, trace["base_cycle"])
        flows = perfetto.span_flow_events(spans)
        doc = perfetto.build_trace(records, cfg.num_nodes, flows=flows)
        perfetto.validate_trace(doc)
        perfetto.write_trace(args.perfetto, doc)
        print(f"wrote {args.perfetto}: {len(records)} events, "
              f"{len(flows)} flow arrows", file=sys.stderr)
    if args.json:
        _emit(args, txntrace.spans_doc(cfg, spans, total, top=args.top))
    else:
        _write(args, _render_txns(spans, total, args.top))
    return 0


# lint: host
def _render_critpath(report, hot) -> str:
    total = report["total_cycles"]
    pct = (f" ({100.0 * report['length'] / total:.0f}% of "
           f"{total} cycles)" if total else "")
    lines = [f"critical path: {report['length']} cycles"
             f"{pct}, {report['events_on_path']} events"]
    if report["start"]:
        s, e = report["start"], report["end"]
        lines.append(f"  {s['kind']}@n{s['node']} cycle {s['cycle']} "
                     f"-> {e['kind']}@n{e['node']} cycle {e['cycle']}")
    lines.append("")
    lines.append("by phase:")
    for ph, c in report["by_phase"].items():
        if c:
            lines.append(f"  {ph:<14} {c:>6}")
    lines.append("by node:")
    for n, c in report["by_node"].items():
        lines.append(f"  node {n:<9} {c:>6}")
    if hot:
        lines.append("")
        lines.append("hotspots (largest waits on the path):")
        for s in hot:
            what = (f"{s['msg']['type']} from n{s['msg']['src']}"
                    if "msg" in s else "program order")
            lines.append(f"  cycle {s['cycle']:>5} n{s['node']}: "
                         f"waited {s['wait']} ({what})")
    return "\n".join(lines) + "\n"


# lint: host
def cmd_critpath(args, dev) -> int:
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import critpath
    res = _capture_spans(args, dev)
    if res is None:
        print(_NO_INPUT, file=sys.stderr)
        return 2
    _, trace, total, _, _ = res
    report = critpath.critical_path(trace, total_cycles=total)
    if args.json:
        _emit(args, report)
    else:
        _write(args, _render_critpath(report, critpath.hotspots(report)))
    return 0


# -- profile -----------------------------------------------------------------

#: the deep profile's counters (nodes x addr-space int32) may take at
#: most this many bytes (JAX ``obs/cli.py:1237``)
DEEP_PROFILE_BYTES = 1 << 29


# lint: host
def profile_config(nodes: int, deep: bool, exact_flags: bool = True):
    """The config ``profile --engine sync|deep`` runs (JAX
    ``obs/cli.py:1211-1232``): the scale config at txn_width 3 and
    drain_depth 4; for deep, drain_depth 13 and perf-report's deep
    defaults."""
    import dataclasses

    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    cfg = SystemConfig.scale(num_nodes=nodes,
                             drain_depth=13 if deep else 4, txn_width=3)
    if deep:
        cfg = dataclasses.replace(
            cfg, deep_window=True, deep_slots=2 if nodes >= 32768 else 3,
            deep_ownerval_slots=1, deep_horizon_slack=4, deep_waves=1,
            deep_read_storm=False, deep_exact_flags=exact_flags)
    return cfg


# lint: host
def cmd_profile(args, dev) -> int:
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import cohprof

    if args.no_exact_flags and args.engine != "deep":
        print("error: --no-exact-flags is a deep-engine knob; "
              "add --engine deep", file=sys.stderr)
        return 2
    if args.engine == "async":
        system0 = _async_system(args, dev)
        if system0 is None:
            print(_NO_INPUT, file=sys.stderr)
            return 2
        # two passes: the plain run pins the cycle count, the profiled
        # replay from the initial state walks the same trajectory
        if args.run_cycles is not None:
            steps = args.run_cycles
        else:
            steps = int(system0.run(args.max_cycles).metrics["cycles"])
        doc = cohprof.capture_async(system0.cfg, system0.state, steps,
                                    k=args.top)
    else:
        deep = args.engine == "deep"
        cfg = profile_config(args.nodes, deep, not args.no_exact_flags)
        if deep:
            space = args.nodes * (args.nodes << cfg.block_bits)
            if space * 4 > DEEP_PROFILE_BYTES:
                print("error: deep profile plane would need "
                      f"{space * 4 >> 20} MiB (nodes x addr-space "
                      "counters); profile the deep engine at a "
                      "smaller --nodes", file=sys.stderr)
                return 2
        ts = _sync_system(args, cfg, dev)
        if ts is None:
            print(_NO_INPUT, file=sys.stderr)
            return 2
        if args.test_dir:
            cfg = ts.cfg
        if args.run_cycles is not None:
            steps = args.run_cycles
        else:
            steps = int(ts.run(max_rounds=args.max_cycles)
                        .state.metrics.rounds)
        cap = cohprof.capture_deep if deep else cohprof.capture_sync
        doc = cap(cfg, ts.state, steps, k=args.top)
    if args.json:
        _emit(args, doc)
    else:
        _write(args, cohprof.render_text(doc) + "\n")
    return 0


# -- entry points ------------------------------------------------------------

_VERBS = {
    "stats": (build_stats_parser, cmd_stats),
    "trace": (build_trace_parser, cmd_trace),
    "txns": (build_txns_parser, cmd_txns),
    "critical-path": (build_critpath_parser, cmd_critpath),
    "profile": (build_profile_parser, cmd_profile),
}

#: the verbs this module runs (``cli.main`` dispatches them here)
VERBS = tuple(_VERBS)


# lint: host
def main(verb: str, argv) -> int:
    """Parse ``argv`` for ``verb``, resolve the device and run it."""
    build, cmd = _VERBS[verb]
    args = build().parse_args(argv)
    dev = _device(args)
    if dev is None:
        return 1
    return cmd(args, dev)
