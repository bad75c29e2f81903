"""``cache-sim-torch bench-diff``: the noise-aware comparison of two
bench captures.

The port of the JAX package's ``bench-diff`` verb (``obs/cli.py:548-741``),
with the same flags, output and exit codes: 0 for noise, an improvement or
a recorded baseline, 4 for a regression, 2 for a usage error or an
incomparable pair. It reads either package's bench history
(``cache-sim/bench/v1`` to ``v1.4``, ``obs/history.py``), archived round
captures (``BENCH_r*.json``) and raw bench output, and adjudicates them with
``obs/regress.py``: the Mann-Whitney U test on rep times, the exact cost
gate (``--bytes``) or the latency samples (``--latency``). On the port's
entries ``--bytes`` compares real cost vectors: ``bench --record`` fills
``cost`` and ``hlo_fingerprint`` on its deep, sync and async solo runs
from the dispatch records of one round or cycle and one chunk of the
runner (``obs/roofline.kernel_record``). Host-side only: it runs no
engine.

Named ``bench_diff.py`` because ``cli.py`` is the port's top-level CLI.
"""
# lint: host

from __future__ import annotations

import argparse
import json
import os
import sys


# lint: host
def build_bench_diff_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cache-sim-torch bench-diff",
        description="noise-aware comparison of two bench captures "
                    "(obs.regress: Mann-Whitney U on rep times + a "
                    "practical bar from recorded rep spread). "
                    "Exit 0 = noise/improvement/baseline, "
                    "4 = regression, 2 = usage/incomparable.")
    p.add_argument("a", nargs="?", default=None,
                   help="baseline capture: BENCH_r*.json round "
                        "capture, raw bench.py output, or a history "
                        "JSONL (its last entry is used)")
    p.add_argument("b", nargs="?", default=None,
                   help="candidate capture (same formats)")
    p.add_argument("--history", metavar="PATH",
                   help="bench history JSONL (see bench.py --record)")
    p.add_argument("--against-last", action="store_true",
                   help="compare the history's newest entry against "
                        "the one before it; with a single entry, "
                        "report 'baseline recorded' and exit 0")
    p.add_argument("--synthetic-slowdown", type=float, metavar="PCT",
                   help="self-test: compare A against a copy of A "
                        "with rep times scaled by (1 + PCT/100) — "
                        "must come out a regression (exit 4)")
    p.add_argument("--bytes", action="store_true",
                   help="compare the recorded deterministic cost "
                        "vectors (obs.roofline, bench.py --record) "
                        "instead of rep times: bytes/instr is exact "
                        "per compiled HLO, so any increase beyond "
                        "--bytes-tol is a regression with the "
                        "offending kernels named — no statistics")
    p.add_argument("--bytes-tol", type=float, default=None,
                   metavar="PCT",
                   help="tolerance for the --bytes gate (default 2.0; "
                        "absorbs benign layout churn, not noise — "
                        "there is none)")
    p.add_argument("--synthetic-bytes", type=float, metavar="PCT",
                   help="self-test (implies --bytes): compare A "
                        "against a copy of A with its cost vector "
                        "scaled by (1 + PCT/100) — must come out a "
                        "regression (exit 4)")
    p.add_argument("--latency", action="store_true",
                   help="compare the recorded open-loop latency "
                        "blocks (bench.py --soak) instead of rep "
                        "times: Mann-Whitney U on the per-job "
                        "samples_ms vectors, practical bar on the "
                        "p95 delta; arrival-rate mismatch is "
                        "incomparable")
    p.add_argument("--synthetic-latency", type=float, metavar="PCT",
                   help="self-test (implies --latency): compare A "
                        "against a copy of A with its latency block "
                        "scaled by (1 + PCT/100) — must come out a "
                        "regression (exit 4)")
    p.add_argument("--min-effect", type=float, default=5.0,
                   metavar="PCT",
                   help="never flag deltas below this percent "
                        "(default 5.0)")
    p.add_argument("--alpha", type=float, default=0.05,
                   help="one-sided significance level (default 0.05; "
                        "note 3v3 reps bottom out at exactly 0.05)")
    p.add_argument("--json", action="store_true",
                   help="emit the full verdict doc as JSON on stdout")
    return p


# lint: host
def _load_bench_entry(path: str):
    """A capture path -> one history entry. History JSONL files
    contribute their newest entry; anything else goes through
    obs.history.ingest_capture."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import history
    try:
        hist = history.load(path)
        if hist:
            return hist[-1]
    except (ValueError, json.JSONDecodeError):
        pass
    return history.ingest_capture(path)


# lint: host
def cmd_bench_diff(args) -> int:
    import copy

    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import history, regress

    def fail(msg: str) -> int:
        print(f"error: {msg}", file=sys.stderr)
        return 2

    want_bytes = args.bytes or args.synthetic_bytes is not None
    want_latency = args.latency or args.synthetic_latency is not None
    if args.bytes_tol is not None and not want_bytes:
        return fail("--bytes-tol only applies with --bytes")
    if want_bytes and want_latency:
        return fail("--bytes and --latency are exclusive")
    synth = [n for n, v in (
        ("--synthetic-slowdown", args.synthetic_slowdown),
        ("--synthetic-bytes", args.synthetic_bytes),
        ("--synthetic-latency", args.synthetic_latency)) if v is not None]
    if len(synth) > 1:
        return fail(" and ".join(synth) + " are exclusive")
    try:
        if args.against_last:
            if not args.history:
                return fail("--against-last requires --history PATH")
            if not os.path.exists(args.history):
                return fail(f"history not found: {args.history}")
            hist = history.load(args.history)
            if not hist:
                return fail(f"history is empty: {args.history}")
            if len(hist) == 1:
                print(f"bench-diff: baseline recorded "
                      f"({hist[0]['label']}, 1 entry in "
                      f"{args.history}); nothing to compare yet")
                return 0
            entry_a, entry_b = hist[-2], hist[-1]
        else:
            if not args.a:
                return fail("provide captures A and B, or "
                            "--history ... --against-last")
            entry_a = _load_bench_entry(args.a)
            if args.synthetic_slowdown is not None:
                scale = 1.0 + args.synthetic_slowdown / 100.0
                entry_b = copy.deepcopy(entry_a)
                entry_b["label"] = (f"{entry_a['label']}"
                                    f"*{scale:g} (synthetic)")
                entry_b["rep_times_s"] = [
                    t * scale for t in entry_a["rep_times_s"]]
            elif args.synthetic_bytes is not None:
                scale = 1.0 + args.synthetic_bytes / 100.0
                entry_b = copy.deepcopy(entry_a)
                entry_b["label"] = (f"{entry_a['label']}"
                                    f"*{scale:g}B (synthetic)")
                cost = entry_b.get("cost")
                if isinstance(cost, dict):
                    if cost.get("bytes_per_instr") is not None:
                        cost["bytes_per_instr"] = round(
                            cost["bytes_per_instr"] * scale, 6)
                    for k in (cost.get("kernels") or {}).values():
                        if k.get("hbm_bytes") is not None:
                            k["hbm_bytes"] = k["hbm_bytes"] * scale
            elif args.synthetic_latency is not None:
                scale = 1.0 + args.synthetic_latency / 100.0
                entry_b = copy.deepcopy(entry_a)
                entry_b["label"] = (f"{entry_a['label']}"
                                    f"*{scale:g}L (synthetic)")
                lat = entry_b.get("latency")
                if isinstance(lat, dict):
                    for k in ("p50_ms", "p95_ms", "p99_ms", "max_ms"):
                        if lat.get(k) is not None:
                            lat[k] = round(lat[k] * scale, 6)
                    if lat.get("samples_ms") is not None:
                        lat["samples_ms"] = [round(x * scale, 6)
                                             for x in lat["samples_ms"]]
            elif args.b:
                entry_b = _load_bench_entry(args.b)
            else:
                return fail("provide capture B (or "
                            "--synthetic-slowdown/--synthetic-bytes/"
                            "--synthetic-latency PCT)")
    except (OSError, ValueError) as e:
        return fail(str(e))

    if want_bytes:
        tol = (regress.DEFAULT_BYTES_TOL_PCT if args.bytes_tol is None
               else args.bytes_tol)
        rep = regress.compare_cost(entry_a, entry_b, tol_pct=tol)
        fmt = regress.format_cost_report
    elif want_latency:
        rep = regress.compare_latency(entry_a, entry_b,
                                      min_effect=args.min_effect / 100.0,
                                      alpha=args.alpha)
        fmt = regress.format_latency_report
    else:
        rep = regress.compare(entry_a, entry_b,
                              min_effect=args.min_effect / 100.0,
                              alpha=args.alpha)
        fmt = regress.format_report
    if args.json:
        print(json.dumps(rep, sort_keys=True))
    else:
        print(fmt(rep))
    if rep["verdict"] == "regression":
        return 4
    if rep["verdict"] == "incomparable":
        return 2
    return 0


# lint: host
def main_bench_diff(argv) -> int:
    return cmd_bench_diff(build_bench_diff_parser().parse_args(argv))
