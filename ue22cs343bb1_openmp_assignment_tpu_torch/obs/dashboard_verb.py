"""``cache-sim-torch dashboard``: render a bench history into static
HTML and markdown.

The port of the JAX package's ``dashboard`` verb (``obs/cli.py:1025-1138``:
``build_dashboard_parser``, ``_ingest_any``, ``cmd_dashboard``,
``main_dashboard``), with the same flags, output and exit codes: capture
files (``BENCH_r*.json``, ``MULTICHIP_r*.json``), ``--history`` (either
package's ``bench --record`` JSONL), ``--html``, ``--md``, ``--json``,
``--litmus`` (a JSON litmus report, read as JAX reads it; the port has
no ``analyze`` yet), ``--recording`` and ``--profile``. It renders
through ``obs/dashboard.py`` and runs no engine, so it needs no device.

Named ``dashboard_verb.py`` because ``obs/dashboard.py`` is the renderer
and ``cli.py`` the port's top-level CLI.
"""
# lint: host

from __future__ import annotations

import argparse
import json
import os
import sys


# lint: host
def build_dashboard_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cache-sim-torch dashboard",
        description="render a bench history into a self-contained "
                    "static HTML + markdown report (obs.dashboard): "
                    "headline instrs/sec trend vs the 1e8 target, "
                    "bench-diff verdict strip, protocol x workload "
                    "coverage cells, the multichip sharded scaling "
                    "curve, the litmus consistency matrix (--litmus), "
                    "and the roofline scatter of recorded cost "
                    "vectors. Deterministic: same history bytes, same "
                    "report bytes.")
    p.add_argument("captures", nargs="*",
                   help="capture files to ingest before rendering: "
                        "BENCH_r*.json round captures and "
                        "MULTICHIP_r*.json dryruns (obs.history "
                        "adapters), in the order given")
    p.add_argument("--history", metavar="PATH",
                   help="bench history JSONL (bench --record); its "
                        "entries precede any ingested captures")
    p.add_argument("--html", metavar="PATH",
                   help="write the self-contained HTML report here")
    p.add_argument("--md", metavar="PATH",
                   help="write the markdown report here")
    p.add_argument("--json", action="store_true",
                   help="print the dashboard model JSON to stdout")
    p.add_argument("--litmus", metavar="PATH",
                   help="a litmus report as JSON (the analyze --litmus "
                        "--json report, or the bare litmus.run_suite "
                        "dict); renders as the protocol x "
                        "consistency-test matrix")
    p.add_argument("--recording", metavar="PATH", action="append",
                   default=[],
                   help="a cache-sim/recording/v1 capture (daemon "
                        "--record artifact or record dir); repeatable; "
                        "renders as the captured-traffic table, each "
                        "row replayable with cache-sim-torch replay")
    p.add_argument("--profile", metavar="PATH", action="append",
                   default=[],
                   help="a cache-sim/profile/v1 doc (cache-sim-torch "
                        "profile --json); repeatable; renders as the "
                        "coherence-profile table (dominant sharing "
                        "pattern, miss mix, ghost-poison fraction)")
    return p


# lint: host
def _ingest_any(path: str) -> dict:
    """Capture path -> history entry, dispatching between the bench
    and multichip adapters by content (filename is a hint only)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import history
    if "MULTICHIP" in os.path.basename(path).upper():
        return history.ingest_multichip(path)
    try:
        return history.ingest_capture(path)
    except ValueError:
        return history.ingest_multichip(path)


# lint: host
def cmd_dashboard(args) -> int:
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (
        dashboard, history)
    if not args.history and not args.captures:
        print("error: provide --history PATH and/or capture files",
              file=sys.stderr)
        return 2
    if not (args.html or args.md or args.json):
        print("error: provide --html PATH, --md PATH, or --json",
              file=sys.stderr)
        return 2
    entries = []
    litmus = None
    recordings = []
    try:
        if args.history:
            entries.extend(history.load(args.history))
        for path in args.captures:
            entries.append(_ingest_any(path))
        if args.litmus:
            with open(args.litmus) as f:
                doc = json.load(f)
            # accept either the full analyze report or the bare matrix
            litmus = doc.get("litmus", doc) if isinstance(doc, dict) \
                else None
            if not isinstance(litmus, dict):
                raise ValueError(f"{args.litmus}: not a litmus report")
        if args.recording:
            from ue22cs343bb1_openmp_assignment_tpu_torch.obs import (
                recording)
            recordings = [recording.load(p) for p in args.recording]
        profiles = []
        for path in args.profile:
            from ue22cs343bb1_openmp_assignment_tpu_torch.obs import cohprof
            with open(path) as f:
                prof = cohprof.validate(json.load(f))
            prof["extra"].setdefault("path", path)
            profiles.append(prof)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    res = dashboard.render(entries, html_path=args.html,
                           md_path=args.md, litmus=litmus,
                           recordings=recordings, profiles=profiles)
    if args.json:
        print(json.dumps(res["model"], sort_keys=True))
    for path in (args.html, args.md):
        if path:
            print(f"wrote {path}", file=sys.stderr)
    return 0


# lint: host
def main_dashboard(argv) -> int:
    return cmd_dashboard(build_dashboard_parser().parse_args(argv))
