"""``cache-sim-torch perf-report``: roofline + memory-traffic attribution.

The port of the JAX package's ``perf-report`` verb (``obs/cli.py:744-1021``,
``build_perfreport_parser``, ``cmd_perfreport``, ``main_perfreport``),
with the same flags and the same ``cache-sim/perfreport/v1`` document:
per-kernel flops / HBM bytes / arithmetic intensity / bound
classification, reduced to bytes per simulated instruction. The cost
records are the port's dispatch records (``obs.roofline.kernel_record``:
the aten ops of one call and the port's kernel launches at their I/O
contracts) where JAX reads XLA's cost model.

The config is built as JAX builds it (deep and sync: ``SystemConfig.
scale`` at drain_depth 13 or 4 and txn_width 3, deep with the bench's
deep defaults; the state from ``CoherenceSystem.from_workload``). The
run and the records use the card unless ``--cpu``; with no card and no
``--cpu`` the verb exits 1 with the port CLI's error. On the card the
deep engine takes the fold kernels (``csrc/deep_fold.cu``);
``--pallas`` takes the kernel routes the port's CLI takes
(``cli.kernel_routes``: the fused deep round, ``csrc/deep_round.cu``).
The sync engine here runs a stored trace, which no kernel takes, so
``--pallas`` prints JAX's note there, as it does on the CPU.

As JAX's, the document carries a ``vmem`` block on the deep engine
(``analysis/kernelcheck.vmem_rows``: the deep kernels' shared memory a
block, from their layout formulas, against the H100's 227 KiB) and an
``index`` block on every engine (``analysis/indexcheck.index_row``: the
hot body's aten index sites and indices a step by plane, recorded on
the report's device, with indices a simulated instruction from the same
steps and retired count as bytes/instr). Without ``--timing`` the
document is byte-identical across runs.

Named ``perf_report.py`` because ``cli.py`` is the port's top-level CLI.
"""
# lint: host

from __future__ import annotations

import argparse
import sys
import time

from ue22cs343bb1_openmp_assignment_tpu_torch.obs import verbs

# lint: host
def build_perfreport_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cache-sim-torch perf-report",
        description="roofline + memory-traffic attribution "
                    "(obs.roofline): per-kernel flops / HBM bytes / "
                    "arithmetic intensity / bound classification from "
                    "the dispatch record of each call (aten ops and the "
                    "port's kernel launches), reduced to bytes per "
                    "simulated instruction — the one-screen answer to "
                    "which kernel moves the bytes. The default report is "
                    "deterministic per build (byte-identical across "
                    "runs); wall-clock ns/instr is opt-in via --timing.")
    verbs._add_common(p)
    p.add_argument("--engine", choices=["async", "sync", "deep"],
                   default="deep",
                   help="engine to attribute (default deep — the "
                        "throughput path)")
    p.add_argument("--chunk", type=int, default=64,
                   help="cycles/rounds per quiescence-check chunk")
    p.add_argument("--pallas", action="store_true",
                   help="on the card: attribute the kernel routes the "
                        "CLI takes (the fused deep round) instead of the "
                        "default path")
    p.add_argument("--timing", action="store_true",
                   help="attach the nondeterministic half: measured "
                        "ns/instr split by PhaseTimer phase and the "
                        "roofline model share per kernel, plus the "
                        "dispatch-bound check (measured >> model)")
    p.add_argument("--reps", type=int, default=3,
                   help="timed repetitions for --timing (default 3)")
    p.add_argument("--device-kind", default=None,
                   help="classify against this device kind's peaks "
                        "instead of the detected one (obs.roofline "
                        "static table)")
    p.add_argument("--shards", type=int, default=None,
                   help="async engine: shard count for the per-"
                        "transport bytes-on-wire row (all_to_all vs "
                        "rdma lane exchange, parallel.rdma_comm."
                        "wire_bytes). Default: the attached card count "
                        "when >1, else 8; must divide --nodes")
    p.add_argument("--profile", action="store_true",
                   help="attach the coherence-profile block "
                        "(obs.cohprof): replay the pinned run under "
                        "the profiler and report sharing patterns, "
                        "contended lines, and (deep) the measured "
                        "abort anatomy next to the bytes they cost")
    p.add_argument("--json", action="store_true",
                   help="emit the full cache-sim/perfreport/v1 doc")
    p.add_argument("--out", metavar="PATH",
                   help="write the report here instead of stdout")
    return p


# lint: host
def report_config(engine: str, nodes: int):
    """The config ``perf-report --engine ENGINE`` attributes, without
    kernel routes (JAX ``obs/cli.py:818-833``)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    if engine == "async":
        return SystemConfig.scale(num_nodes=nodes)
    return verbs.profile_config(nodes, engine == "deep")


# lint: host
def cmd_perfreport(args, dev) -> int:
    import torch

    from ue22cs343bb1_openmp_assignment_tpu_torch import cli
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import roofline
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs.phases import (
        PhaseTimer)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_round_kernel as drk)
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import mailbox, step

    wl = args.workload or "uniform"
    sync_like = args.engine in ("sync", "deep")
    cfg = report_config(args.engine, args.nodes)
    if args.pallas:
        routed = cli.kernel_routes(cfg, dev)
        if sync_like and (routed.fused_round or routed.pallas_burst):
            cfg = routed
        else:
            print("note: --pallas needs a sync-family engine on a TPU "
                  "backend; attributing the XLA path instead",
                  file=sys.stderr)
    system = CoherenceSystem.from_workload(
        cfg, wl, trace_len=args.trace_len, seed=args.seed, device=dev)

    max_cycles = args.max_cycles
    chunk = args.chunk
    if sync_like:
        max_cycles = min(max_cycles, se.claim_max_rounds(cfg) - 1)
        st0 = se.from_sim_state(cfg, system.state, seed=args.seed)

        def run():
            return se.run_sync_to_quiescence(cfg, st0, chunk, max_cycles)

        def steps_of(st):
            return int(st.metrics.rounds)

        per_step_name = "sync.round_step"

        def records():
            recs = [
                roofline.kernel_record(per_step_name, se.round_step, cfg,
                                       st0),
                # one chunk of the runner (XLA counts a while body once)
                roofline.kernel_record(
                    f"sync.run_to_quiescence[chunk={chunk}]",
                    se.run_sync_to_quiescence, cfg, st0, chunk, chunk),
            ]
            if args.engine == "deep" and drk.supported(cfg):
                # the fused round kernel's HBM traffic is its I/O
                # contract, labeled io-contract beside the rows above
                io_in, io_out = drk.io_contract_bytes(cfg)
                recs.append(roofline.io_contract_record(
                    "deep.round_fused[io-contract]", io_in, io_out))
            return recs
    else:
        st0 = system.state

        def run():
            return step.run_chunked_to_quiescence(cfg, st0, chunk,
                                                  max_cycles)

        def steps_of(st):
            return int(st.metrics.cycles)

        per_step_name = "step.cycle"

        def records():
            return [
                roofline.kernel_record(per_step_name, step.cycle, cfg, st0),
                roofline.kernel_record("mailbox.dequeue", mailbox.dequeue,
                                       cfg, st0),
                roofline.kernel_record(
                    f"step.run_chunked[chunk={chunk}]",
                    step.run_chunked_to_quiescence, cfg, st0, chunk,
                    int(st0.cycle) + chunk),
            ]

    # one real run pins the deterministic integers (steps, retired)
    # that turn per-step bytes into bytes/instr
    final = run()
    steps = steps_of(final)
    retired = int(final.metrics.instrs_retired.sum())
    if not bool(final.quiescent()):
        print(f"warning: not quiescent within {max_cycles} "
              f"cycles/rounds; bytes/instr covers the truncated run",
              file=sys.stderr)
    doc = roofline.build_report(
        args.engine,
        {"nodes": args.nodes, "workload": wl,
         "trace_len": args.trace_len, "chunk": chunk,
         "seed": args.seed,
         "pallas": bool(cfg.pallas_burst or cfg.fused_round)},
        records(), per_step_name, steps, retired,
        device_kind=args.device_kind or roofline.detect_device_kind(dev))
    if args.engine == "async":
        # the per-transport bytes-on-wire row: a sibling section of the
        # kernel table, NOT a kernel record
        n_sh = args.shards
        if n_sh is None:
            n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
            n_sh = n_dev if n_dev > 1 else 8
        if args.nodes % n_sh:
            print(f"note: --nodes {args.nodes} does not shard over "
                  f"{n_sh} devices; omitting the transport row",
                  file=sys.stderr)
        else:
            doc["transport"] = roofline.transport_section(cfg, n_sh)
    fused = next((k for k in doc["kernels"]
                  if k.get("basis") == "io-contract"), None)
    if fused is not None and doc["cost_available"]:
        doc["fused"] = {
            "kernel": fused["name"], "basis": "io-contract",
            "bytes_per_instr": round(
                fused["hbm_bytes"] * steps / retired, 6),
            "unfused_bytes_per_instr": doc["bytes_per_instr"],
        }
    if args.engine == "deep":
        # the deep kernels' shared-memory rows, from the kernel-contract
        # verifier's layout formulas (deterministic arithmetic; the
        # libraries' own entries are `analyze --kernel`'s job)
        from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
            kernelcheck)
        doc["vmem"] = kernelcheck.vmem_rows(
            cfg, device_kind=args.device_kind)
    # the index-pressure row (analysis/indexcheck): the hot body's index
    # sites by plane, with indices/instr from the same (steps, retired)
    # integers that pin bytes/instr above
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import (
        indexcheck)
    if args.engine in indexcheck.ENGINES and retired:
        doc["index"] = indexcheck.index_row(args.engine, args.nodes,
                                            device=dev)
        doc["index"]["indices_per_instr"] = round(
            doc["index"]["indices_per_step"] * steps / retired, 3)
    if args.profile:
        # the protocol-behavior sibling of the kernel table: the same
        # pinned (steps, retired) run, replayed under the coherence
        # profiler (obs.cohprof)
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import cohprof
        if args.engine == "async":
            doc["profile"] = cohprof.capture_async(cfg, st0, steps)
        elif args.engine == "deep":
            space = args.nodes * (args.nodes << cfg.block_bits)
            if space * 4 > verbs.DEEP_PROFILE_BYTES:
                print("note: deep profile plane too large at this "
                      "--nodes; omitting the profile block",
                      file=sys.stderr)
            else:
                doc["profile"] = cohprof.capture_deep(cfg, st0, steps)
        else:
            doc["profile"] = cohprof.capture_sync(cfg, st0, steps)
    if args.timing:
        timer = PhaseTimer()
        rep_times = []
        for _ in range(max(1, args.reps)):
            t0 = time.perf_counter()
            st = run()
            t1 = time.perf_counter()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            int(st.metrics.instrs_retired.sum())
            t2 = time.perf_counter()
            timer.add("execute_dispatch", t1 - t0)
            timer.add("device_get_sync", t2 - t1)
            rep_times.append(t2 - t0)
        doc["timing"] = roofline.timing_section(
            timer.report(), doc["kernels"], steps, retired, rep_times)
    if args.json:
        verbs._emit(args, doc)
    else:
        text = roofline.render_text(doc)
        if "profile" in doc:
            from ue22cs343bb1_openmp_assignment_tpu_torch.obs import cohprof
            text += "\n" + cohprof.render_text(doc["profile"]) + "\n"
        verbs._write(args, text)
    return 0


# lint: host
def main_perfreport(argv) -> int:
    args = build_perfreport_parser().parse_args(argv)
    if args.test_dir:
        print("error: perf-report attributes synthetic workloads; "
              "use --workload (default uniform)", file=sys.stderr)
        return 2
    dev = verbs._device(args)
    if dev is None:
        return 1
    return cmd_perfreport(args, dev)
