"""Bench-history dashboard: the perf trajectory as an artifact.

Until now the repo's performance story lived in PERF.md prose plus an
append-only JSONL nobody rendered. This module turns a bench history
(:mod:`obs.history`: ``BENCH_r*`` ingests, live ``--record`` runs,
``MULTICHIP_r*`` parity dryruns) into two self-contained files:

- **HTML** — inline-SVG charts, zero external assets, openable from a
  CI artifact tab: the headline instrs/sec trend against the 1e8
  north-star line (BASELINE.json), the serving jobs/sec trend
  (``bench.py --serve`` rows, ROADMAP item 2), the bench-diff verdict strip
  (regression/noise/improvement per adjacent pair, obs.regress), the
  per-(protocol x workload) coverage cells as ROADMAP item 4 lands,
  the sharded-parity scaling curve from the multichip dryruns, and the
  roofline scatter (arithmetic intensity vs attainable flops,
  obs.roofline) for every entry that recorded a cost vector.
- **markdown** — the same model as tables, for diffs and PR comments.

Rendering is **deterministic**: no timestamps, no environment probes —
the same history bytes produce the same report bytes, which is what
lets a golden render live under tests/golden/. Host-side and
dependency-free (string assembly only).

The port's copy of the JAX package's ``obs/dashboard.py``, unchanged
apart from its import paths (the port's ``obs.regress``,
``obs.roofline`` and ``obs.recording``). The one place its model may
differ from JAX's: the port's peak table has an ``h100`` row, so an
entry whose ``device_kind`` is an NVIDIA H100's name classifies against
it, where JAX falls back to its generic peaks.
"""
# lint: host

from __future__ import annotations

from typing import List, Optional, Tuple

from ue22cs343bb1_openmp_assignment_tpu_torch.obs import regress, roofline

#: the north star (BASELINE.json): simulated instrs/sec on one chip
TARGET_INSTRS_PER_S = 1e8

_W, _H = 640, 240          # chart viewport
_PAD_L, _PAD_R = 70, 16    # left gutter for axis labels
_PAD_T, _PAD_B = 18, 30

_VERDICT_COLOR = {"regression": "#c0392b", "improvement": "#1e8449",
                  "noise": "#7f8c8d", "incomparable": "#b7950b",
                  "pass": "#1e8449"}


# lint: host
def _workload_from_metric(metric: str) -> Optional[str]:
    """bench.py's metric string embeds "(<engine> engine, <workload>"
    — the only workload record archived captures carry."""
    import re
    m = re.search(r"\(\w+ engine, ([\w-]+)", metric or "")
    return m.group(1) if m else None


# lint: host
def _litmus_cells(litmus: Optional[dict]) -> list:
    """Normalize an ``analyze --litmus`` report ({protocol: {test:
    enumeration report}}, analysis/litmus.run_suite) into flat matrix
    cells sorted (test, protocol)."""
    cells = []
    for proto, tests in (litmus or {}).items():
        for name, rep in tests.items():
            cells.append({
                "protocol": proto, "test": name,
                "ok": rep.get("ok"),
                "budget_exhausted": bool(rep.get("budget_exhausted")),
                "observed": len(rep.get("observed", ())),
                "allowed": len(rep.get("allowed", ())),
                "unexpected": len(rep.get("unexpected", ()))})
    return sorted(cells, key=lambda c: (c["test"], c["protocol"]))


# lint: host
def _recording_rows(recordings: Optional[list]) -> list:
    """Normalize loaded ``cache-sim/recording/v1`` docs
    (obs.recording.load) into the captured-traffic table rows."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import recording
    rows = []
    for rec in recordings or []:
        submits = [r for r in rec["rows"] if r["event"] == "submit"]
        results = [r for r in rec["rows"] if r["event"] == "result"]
        ts = [float(r["t_s"]) for r in rec["rows"]]
        lat = recording.latency_block(rec)
        rows.append({
            "label": rec.get("path") or "?",
            "clock": rec["clock"],
            "jobs": len(submits),
            "results": len(results),
            "quiesced": sum(1 for r in results if r["quiesced"]),
            "duration_s": (max(ts) - min(ts)) if ts else 0.0,
            "arrival_rate": (recording.derived_arrival_rate(rec)
                             if submits else None),
            "p95_ms": None if lat is None else lat["p95_ms"],
        })
    return rows


# lint: host
def _profile_rows(profiles: Optional[list]) -> list:
    """Normalize ``cache-sim/profile/v1`` docs (obs.cohprof) into the
    coherence-profile table rows."""
    rows = []
    for doc in profiles or []:
        mc = doc.get("miss_classes")
        ab = doc.get("abort_anatomy")
        rows.append({
            "label": (doc.get("extra") or {}).get("path")
            or f"{doc['engine']}@{doc['nodes']}",
            "engine": doc["engine"],
            "nodes": doc["nodes"],
            "steps": doc["steps"],
            "dominant": doc["sharing"]["dominant"],
            "classified_lines": doc["sharing"]["classified_lines"],
            "misses": None if mc is None else sum(mc.values()),
            "coherence_misses": None if mc is None
            else mc["coherence_invalidation"],
            "invalidations": (doc["invalidations"] or {}).get("applied")
            if doc.get("invalidations") is not None else None,
            "ghost_fraction": None if ab is None
            else ab["poison_flags"]["ghost_fraction"],
            "top_addr": (doc["top_contended"][0]["addr"]
                         if doc["top_contended"] else None),
        })
    return rows


# lint: host
def build_model(entries: List[dict],
                target: float = TARGET_INSTRS_PER_S,
                litmus: Optional[dict] = None,
                recordings: Optional[list] = None,
                profiles: Optional[list] = None) -> dict:
    """Reduce a loaded history to the renderable model.

    Splits entries into the instrs/sec headline series, the multichip
    scaling series, the bench-diff verdict strip over adjacent headline
    pairs, (protocol x workload) coverage cells (latest entry wins a
    cell; protocol defaults to "mesi" until ROADMAP item 4 records
    one), and the roofline points of every recorded cost vector.
    ``litmus`` is an optional ``analyze --litmus`` suite report; it
    becomes the protocol x test consistency matrix. ``recordings`` is
    an optional list of loaded traffic recordings (obs.recording);
    they become the captured-traffic table, each row replayable with
    ``cache-sim replay``.
    """
    bench = [e for e in entries if e.get("unit") == "instrs/sec"]
    multichip = [e for e in entries
                 if (e.get("config") or {}).get("kind") == "multichip"]
    serving = [{"label": e["label"], "value": float(e["value"]),
                "slots": (e.get("serve") or {}).get("slots"),
                "waves": (e.get("serve") or {}).get("waves"),
                "padding_waste": (e.get("serve") or {}).get(
                    "padding_waste"),
                "mb_dropped": (e.get("serve") or {}).get("mb_dropped")}
               for e in entries if e.get("unit") == "jobs/sec"]
    latency = [{"label": e["label"],
                "value": float(e["latency"]["p95_ms"]),
                "p50_ms": e["latency"]["p50_ms"],
                "p99_ms": e["latency"]["p99_ms"],
                "arrival_rate": e["latency"].get("arrival_rate"),
                "queue_depth_peak": e["latency"].get(
                    "queue_depth_peak"),
                "saturated": e["latency"].get("saturated"),
                "transport": (e.get("serve") or {}).get("transport",
                                                        "inproc")}
               for e in entries if isinstance(e.get("latency"), dict)]
    headline = [{"label": e["label"], "value": float(e["value"]),
                 "engine": (e.get("config") or {}).get("engine"),
                 "vs_target": float(e["value"]) / target}
                for e in bench]
    verdicts = []
    for a, b in zip(bench, bench[1:]):
        rep = regress.compare(a, b)
        verdicts.append({"a": a["label"], "b": b["label"],
                         "verdict": rep["verdict"],
                         "delta_pct": rep.get("delta_pct"),
                         "detail": rep.get("detail")})
    cells = {}
    for e in bench:
        cfg = e.get("config") or {}
        proto = cfg.get("protocol") or "mesi"
        wl = (cfg.get("workload")
              or _workload_from_metric(e.get("metric")) or "?")
        cells[(proto, wl)] = {"label": e["label"],
                              "value": float(e["value"])}
    points = []
    for e in bench:
        cost = e.get("cost")
        if not isinstance(cost, dict) or not cost.get("cost_available"):
            continue
        peaks = roofline.device_peaks(e.get("device_kind") or "unknown")
        for name, k in sorted((cost.get("kernels") or {}).items()):
            if not k.get("cost_available") or not k.get("hbm_bytes"):
                continue
            ai = float(k["flops"]) / float(k["hbm_bytes"])
            attainable = min(peaks["flops_per_s"],
                             ai * peaks["hbm_bytes_per_s"])
            points.append({"entry": e["label"], "kernel": name,
                           "ai": ai, "attainable_flops_per_s": attainable,
                           "device_kind": peaks["kind"],
                           "ridge": peaks["ridge_flops_per_byte"]})
    scaling = [{"label": e["label"], "nodes": float(e["value"]),
                "ok": bool((e.get("config") or {}).get("ok"))}
               for e in multichip]
    return {"target": target, "headline": headline,
            "verdicts": verdicts,
            "cells": {f"{p}/{w}": v
                      for (p, w), v in sorted(cells.items())},
            "roofline": points, "scaling": scaling,
            "serving": serving, "latency": latency,
            "litmus": _litmus_cells(litmus),
            "recordings": _recording_rows(recordings),
            "profiles": _profile_rows(profiles),
            "n_entries": len(entries)}


# lint: host
def _log_points(values: List[float], lo: float,
                hi: float) -> List[Tuple[float, float]]:
    """Map (index, value) to SVG coords on a log-10 y axis."""
    import math
    n = max(1, len(values) - 1)
    span = math.log10(hi) - math.log10(lo)
    pts = []
    for i, v in enumerate(values):
        x = _PAD_L + (_W - _PAD_L - _PAD_R) * (i / n if n else 0.5)
        fy = (math.log10(max(v, lo)) - math.log10(lo)) / span
        y = _H - _PAD_B - (_H - _PAD_T - _PAD_B) * fy
        pts.append((x, y))
    return pts


# lint: host
def _log_y(v: float, lo: float, hi: float) -> float:
    import math
    span = math.log10(hi) - math.log10(lo)
    fy = (math.log10(max(v, lo)) - math.log10(lo)) / span
    return _H - _PAD_B - (_H - _PAD_T - _PAD_B) * fy


# lint: host
def _fmt(x: float) -> str:
    return f"{x:.1f}"


# lint: host
def _decade_grid(lo: float, hi: float) -> List[float]:
    import math
    return [10.0 ** d
            for d in range(math.ceil(math.log10(lo)),
                           math.floor(math.log10(hi)) + 1)]


# lint: host
def _svg_series(title: str, series: List[dict], value_key: str,
                target: Optional[float], unit: str) -> str:
    """One log-y line chart: labeled points, decade gridlines, and an
    optional dashed target line."""
    if not series:
        return f"<p><em>{title}: no entries</em></p>"
    values = [s[value_key] for s in series]
    lo = min(values) / 2
    hi = max(values + ([target] if target else [])) * 2
    out = [f'<svg viewBox="0 0 {_W} {_H}" width="{_W}" height="{_H}" '
           f'role="img" aria-label="{title}">',
           f'<rect width="{_W}" height="{_H}" fill="#fdfefe"/>']
    for g in _decade_grid(lo, hi):
        y = _fmt(_log_y(g, lo, hi))
        out.append(f'<line x1="{_PAD_L}" y1="{y}" x2="{_W - _PAD_R}" '
                   f'y2="{y}" stroke="#eaecee"/>')
        out.append(f'<text x="{_PAD_L - 6}" y="{y}" font-size="10" '
                   f'text-anchor="end" fill="#808b96">{g:.0e}</text>')
    if target:
        ty = _fmt(_log_y(target, lo, hi))
        out.append(f'<line x1="{_PAD_L}" y1="{ty}" x2="{_W - _PAD_R}" '
                   f'y2="{ty}" stroke="#c0392b" stroke-dasharray="6 3"/>')
        out.append(f'<text x="{_W - _PAD_R}" y="{float(ty) - 4:.1f}" '
                   f'font-size="10" text-anchor="end" fill="#c0392b">'
                   f'target {target:.0e} {unit}</text>')
    pts = _log_points(values, lo, hi)
    path = " ".join(f"{'M' if i == 0 else 'L'}{_fmt(x)},{_fmt(y)}"
                    for i, (x, y) in enumerate(pts))
    out.append(f'<path d="{path}" fill="none" stroke="#2471a3" '
               f'stroke-width="2"/>')
    for s, (x, y) in zip(series, pts):
        out.append(f'<circle cx="{_fmt(x)}" cy="{_fmt(y)}" r="3.5" '
                   f'fill="#2471a3"/>')
        out.append(f'<text x="{_fmt(x)}" y="{_H - _PAD_B + 14}" '
                   f'font-size="10" text-anchor="middle" '
                   f'fill="#566573">{s["label"]}</text>')
        out.append(f'<text x="{_fmt(x)}" y="{float(_fmt(y)) - 7:.1f}" '
                   f'font-size="9" text-anchor="middle" '
                   f'fill="#1a5276">{s[value_key]:.3g}</text>')
    out.append("</svg>")
    return "\n".join(out)


# lint: host
def _svg_roofline(points: List[dict]) -> str:
    """Log-log roofline scatter: the bandwidth slope + compute roof of
    each device kind present, with one dot per (entry, kernel)."""
    import math
    if not points:
        return ("<p><em>roofline: no cost vectors recorded yet "
                "(bench.py --record on a cost-model backend)</em></p>")
    ais = [p["ai"] for p in points]
    ai_lo, ai_hi = min(ais + [0.1]) / 4, max(ais + [100.0]) * 4
    devices = {}
    for p in points:
        devices[p["device_kind"]] = roofline.device_peaks(
            p["device_kind"])
    f_hi = max(d["flops_per_s"] for d in devices.values()) * 2
    f_lo = min(min(p["attainable_flops_per_s"] for p in points),
               min(ai_lo * d["hbm_bytes_per_s"]
                   for d in devices.values())) / 2

    def xc(ai):
        fx = ((math.log10(ai) - math.log10(ai_lo))
              / (math.log10(ai_hi) - math.log10(ai_lo)))
        return _PAD_L + (_W - _PAD_L - _PAD_R) * fx

    out = [f'<svg viewBox="0 0 {_W} {_H}" width="{_W}" height="{_H}" '
           f'role="img" aria-label="roofline">',
           f'<rect width="{_W}" height="{_H}" fill="#fdfefe"/>']
    for g in _decade_grid(f_lo, f_hi):
        y = _fmt(_log_y(g, f_lo, f_hi))
        out.append(f'<line x1="{_PAD_L}" y1="{y}" x2="{_W - _PAD_R}" '
                   f'y2="{y}" stroke="#eaecee"/>')
        out.append(f'<text x="{_PAD_L - 6}" y="{y}" font-size="10" '
                   f'text-anchor="end" fill="#808b96">{g:.0e}</text>')
    for kind, d in sorted(devices.items()):
        ridge = d["ridge_flops_per_byte"]
        # bandwidth slope up to the ridge, flat compute roof after
        y0 = _fmt(_log_y(max(ai_lo * d["hbm_bytes_per_s"], f_lo),
                         f_lo, f_hi))
        yr = _fmt(_log_y(d["flops_per_s"], f_lo, f_hi))
        out.append(f'<path d="M{_fmt(xc(ai_lo))},{y0} '
                   f'L{_fmt(xc(ridge))},{yr} '
                   f'L{_fmt(xc(ai_hi))},{yr}" fill="none" '
                   f'stroke="#784212" stroke-width="1.5"/>')
        out.append(f'<text x="{_fmt(xc(ridge))}" '
                   f'y="{float(yr) - 5:.1f}" font-size="10" '
                   f'fill="#784212">{kind} '
                   f'(ridge {ridge:.1f} flop/B)</text>')
    for p in points:
        x = _fmt(xc(p["ai"]))
        y = _fmt(_log_y(p["attainable_flops_per_s"], f_lo, f_hi))
        out.append(f'<circle cx="{x}" cy="{y}" r="4" fill="#2471a3" '
                   f'fill-opacity="0.8"/>')
        out.append(f'<text x="{x}" y="{float(y) + 14:.1f}" '
                   f'font-size="9" text-anchor="middle" '
                   f'fill="#566573">{p["entry"]}:{p["kernel"]}</text>')
    out.append(f'<text x="{_W // 2}" y="{_H - 4}" font-size="10" '
               f'text-anchor="middle" fill="#808b96">arithmetic '
               f'intensity (flops/byte, log)</text>')
    out.append("</svg>")
    return "\n".join(out)


# lint: host
def _litmus_cell_text(c: dict) -> str:
    """pass/fail/outcome-count rendering shared by both artifacts."""
    if c["budget_exhausted"]:
        return "budget"
    tag = "ok" if c["ok"] else "FAIL"
    return f"{tag} ({c['observed']}/{c['allowed']})"


# lint: host
def _litmus_html(cells: list) -> str:
    if not cells:
        return ("<p><em>no litmus report loaded (cache-sim analyze "
                "--litmus --json, then dashboard --litmus "
                "report.json)</em></p>")
    protos = sorted({c["protocol"] for c in cells})
    tests = sorted({c["test"] for c in cells})
    by = {(c["test"], c["protocol"]): c for c in cells}
    head = "".join(f"<th>{p}</th>" for p in protos)
    rows = []
    for t in tests:
        tds = []
        for p in protos:
            c = by.get((t, p))
            if c is None:
                tds.append("<td>—</td>")
                continue
            color = ("#b7950b" if c["budget_exhausted"]
                     else "#1e8449" if c["ok"] else "#c0392b")
            tds.append(f'<td style="color:{color}">'
                       f'{_litmus_cell_text(c)}</td>')
        rows.append(f"<tr><td>{t}</td>{''.join(tds)}</tr>")
    return (f"<table><tr><th>test</th>{head}</tr>"
            + "".join(rows) + "</table>")


# lint: host
def _recordings_html(rows: list) -> str:
    if not rows:
        return ("<p><em>no recordings loaded (capture with "
                "cache-sim daemon --record DIR, then dashboard "
                "--recording DIR)</em></p>")
    trs = []
    for r in rows:
        rate = ("—" if r["arrival_rate"] is None
                else f"{r['arrival_rate']:g}/s")
        p95 = "—" if r["p95_ms"] is None else f"{r['p95_ms']:.4g} ms"
        trs.append(f"<tr><td>{r['label']}</td><td>{r['clock']}</td>"
                   f"<td>{r['jobs']}</td>"
                   f"<td>{r['quiesced']}/{r['results']}</td>"
                   f"<td>{r['duration_s']:.4g} s</td>"
                   f"<td>{rate}</td><td>{p95}</td></tr>")
    return ("<table><tr><th>recording</th><th>clock</th>"
            "<th>jobs</th><th>quiesced/results</th><th>window</th>"
            "<th>offered load</th><th>recorded p95</th></tr>"
            + "".join(trs) + "</table>"
            "<p>replay any row with <code>cache-sim replay "
            "&lt;recording&gt;</code>.</p>")


# lint: host
def _profiles_html(rows: list) -> str:
    if not rows:
        return ("<p><em>no profiles loaded (capture with cache-sim "
                "profile --json --out p.json, then dashboard "
                "--profile p.json)</em></p>")
    trs = []
    for r in rows:
        miss = "—" if r["misses"] is None else (
            f"{r['misses']} ({r['coherence_misses']} coh)")
        inv = ("—" if r["invalidations"] is None
               else f"{r['invalidations']}")
        gf = ("—" if r["ghost_fraction"] is None
              else f"{r['ghost_fraction']:.1%}")
        trs.append(f"<tr><td>{r['label']}</td><td>{r['engine']}</td>"
                   f"<td>{r['nodes']}</td><td>{r['steps']}</td>"
                   f"<td>{r['dominant'] or '—'} "
                   f"({r['classified_lines']} lines)</td>"
                   f"<td>{miss}</td><td>{inv}</td><td>{gf}</td></tr>")
    return ("<table><tr><th>profile</th><th>engine</th><th>nodes</th>"
            "<th>steps</th><th>dominant sharing</th><th>misses</th>"
            "<th>invalidations</th><th>ghost poison</th></tr>"
            + "".join(trs) + "</table>")


# lint: host
def render_html(model: dict) -> str:
    """The self-contained static HTML report."""
    rows = []
    for v in model["verdicts"]:
        c = _VERDICT_COLOR.get(v["verdict"], "#7f8c8d")
        d = ("" if v["delta_pct"] is None
             else f' ({v["delta_pct"]:+.2f}%)')
        why = f' — {v["detail"]}' if v.get("detail") else ""
        rows.append(f'<li><span style="color:{c};font-weight:bold">'
                    f'{v["verdict"].upper()}</span> '
                    f'{v["a"]} &rarr; {v["b"]}{d}{why}</li>')
    verdict_html = ("<ul>" + "".join(rows) + "</ul>") if rows else \
        "<p><em>fewer than two headline entries</em></p>"
    cell_rows = "".join(
        f"<tr><td>{k}</td><td>{v['label']}</td>"
        f"<td>{v['value']:.3g} instrs/sec</td></tr>"
        for k, v in model["cells"].items())
    return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>cache-sim bench dashboard</title>
<style>
body {{ font-family: -apple-system, 'Segoe UI', sans-serif;
        margin: 2em auto; max-width: 52em; color: #212f3d; }}
h1, h2 {{ color: #1a5276; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #d5dbdb; padding: 4px 10px;
          font-size: 14px; }}
</style></head><body>
<h1>cache-sim bench dashboard</h1>
<p>{model["n_entries"]} history entries; north star:
{model["target"]:.0e} simulated instrs/sec on one chip
(BASELINE.json).</p>
<h2>Headline: simulated instrs/sec</h2>
{_svg_series("headline", model["headline"], "value",
             model["target"], "instrs/sec")}
<h2>Serving throughput (jobs/sec)</h2>
{_svg_series("serving", model["serving"], "value", None, "jobs/sec")}
<h2>Open-loop job latency (p95 ms)</h2>
{_svg_series("latency", model["latency"], "value", None, "ms p95")}
<h2>Recordings (captured traffic)</h2>
{_recordings_html(model["recordings"])}
<h2>Coherence profiles (sharing &amp; abort anatomy)</h2>
{_profiles_html(model["profiles"])}
<h2>bench-diff verdicts (adjacent pairs)</h2>
{verdict_html}
<h2>Coverage: protocol &times; workload</h2>
<table><tr><th>cell</th><th>latest</th><th>value</th></tr>
{cell_rows}</table>
<h2>Multichip sharded parity (scaling dryruns)</h2>
{_svg_series("scaling", model["scaling"], "nodes", None, "nodes")}
<h2>Litmus matrix: protocol &times; consistency test</h2>
{_litmus_html(model["litmus"])}
<h2>Roofline (recorded cost vectors)</h2>
{_svg_roofline(model["roofline"])}
</body></html>
"""


# lint: host
def render_markdown(model: dict) -> str:
    """The same model as markdown tables (PR-comment surface)."""
    lines = ["# cache-sim bench dashboard", "",
             f"{model['n_entries']} history entries; north star "
             f"{model['target']:.0e} instrs/sec (BASELINE.json).", "",
             "## Headline (simulated instrs/sec)", "",
             "| entry | engine | instrs/sec | vs target |",
             "|---|---|---:|---:|"]
    for h in model["headline"]:
        lines.append(f"| {h['label']} | {h['engine'] or '?'} "
                     f"| {h['value']:.4g} | {h['vs_target']:.2%} |")
    lines += ["", "## Serving throughput (jobs/sec)", ""]
    if model["serving"]:
        lines += ["| entry | slots | jobs/sec | padding waste "
                  "| waves | mb dropped |",
                  "|---|---:|---:|---:|---:|---:|"]
        for s in model["serving"]:
            slots = "?" if s["slots"] is None else f"{s['slots']}"
            pw = ("?" if s["padding_waste"] is None
                  else f"{s['padding_waste']:.1%}")
            waves = "?" if s["waves"] is None else f"{s['waves']}"
            mbd = ("?" if s["mb_dropped"] is None
                   else f"{s['mb_dropped']}")
            lines.append(f"| {s['label']} | {slots} "
                         f"| {s['value']:.4g} | {pw} "
                         f"| {waves} | {mbd} |")
    else:
        lines.append("*no serving entries yet (bench.py --serve "
                     "--record)*")
    lines += ["", "## Open-loop job latency (p95 ms)", ""]
    if model["latency"]:
        lines += ["| entry | transport | arrival rate | p50 ms "
                  "| p95 ms | p99 ms | queue peak | saturated |",
                  "|---|---|---:|---:|---:|---:|---:|---|"]
        for l in model["latency"]:
            rate = ("?" if l["arrival_rate"] is None
                    else f"{l['arrival_rate']:g}/s")
            qp = ("?" if l["queue_depth_peak"] is None
                  else f"{l['queue_depth_peak']}")
            sat = ("?" if l["saturated"] is None
                   else ("yes" if l["saturated"] else "no"))
            lines.append(f"| {l['label']} | {l['transport']} | {rate} "
                         f"| {l['p50_ms']:.4g} | {l['value']:.4g} "
                         f"| {l['p99_ms']:.4g} | {qp} | {sat} |")
    else:
        lines.append("*no latency entries yet (bench.py --soak "
                     "--record)*")
    lines += ["", "## Recordings (captured traffic)", ""]
    if model["recordings"]:
        lines += ["| recording | clock | jobs | quiesced/results "
                  "| window | offered load | recorded p95 |",
                  "|---|---|---:|---:|---:|---:|---:|"]
        for r in model["recordings"]:
            rate = ("—" if r["arrival_rate"] is None
                    else f"{r['arrival_rate']:g}/s")
            p95 = ("—" if r["p95_ms"] is None
                   else f"{r['p95_ms']:.4g} ms")
            lines.append(f"| {r['label']} | {r['clock']} | {r['jobs']} "
                         f"| {r['quiesced']}/{r['results']} "
                         f"| {r['duration_s']:.4g} s | {rate} "
                         f"| {p95} |")
        lines.append("")
        lines.append("replay any row with `cache-sim replay "
                     "<recording>`.")
    else:
        lines.append("*no recordings loaded (capture with cache-sim "
                     "daemon --record DIR, then dashboard "
                     "--recording DIR)*")
    lines += ["", "## Coherence profiles (sharing & abort anatomy)",
              ""]
    if model["profiles"]:
        lines += ["| profile | engine | nodes | steps "
                  "| dominant sharing | misses | invalidations "
                  "| ghost poison |",
                  "|---|---|---:|---:|---|---:|---:|---:|"]
        for r in model["profiles"]:
            miss = "—" if r["misses"] is None else (
                f"{r['misses']} ({r['coherence_misses']} coh)")
            inv = ("—" if r["invalidations"] is None
                   else f"{r['invalidations']}")
            gf = ("—" if r["ghost_fraction"] is None
                  else f"{r['ghost_fraction']:.1%}")
            lines.append(
                f"| {r['label']} | {r['engine']} | {r['nodes']} "
                f"| {r['steps']} | {r['dominant'] or '—'} "
                f"({r['classified_lines']} lines) | {miss} "
                f"| {inv} | {gf} |")
    else:
        lines.append("*no profiles loaded (capture with cache-sim "
                     "profile --json --out p.json, then dashboard "
                     "--profile p.json)*")
    lines += ["", "## bench-diff verdicts (adjacent pairs)", ""]
    if model["verdicts"]:
        lines += ["| pair | verdict | delta |", "|---|---|---:|"]
        for v in model["verdicts"]:
            d = ("—" if v["delta_pct"] is None
                 else f"{v['delta_pct']:+.2f}%")
            why = f" ({v['detail']})" if v.get("detail") else ""
            lines.append(f"| {v['a']} → {v['b']} "
                         f"| {v['verdict']}{why} | {d} |")
    else:
        lines.append("*fewer than two headline entries*")
    lines += ["", "## Coverage: protocol × workload", "",
              "| cell | latest | instrs/sec |", "|---|---|---:|"]
    for k, v in model["cells"].items():
        lines.append(f"| {k} | {v['label']} | {v['value']:.4g} |")
    lines += ["", "## Multichip sharded parity", ""]
    if model["scaling"]:
        lines += ["| round | max nodes bit-identical | ok |",
                  "|---|---:|---|"]
        for s in model["scaling"]:
            lines.append(f"| {s['label']} | {s['nodes']:.0f} "
                         f"| {'yes' if s['ok'] else 'no'} |")
    else:
        lines.append("*no multichip dryruns ingested*")
    lines += ["", "## Litmus matrix (protocol × consistency test)", ""]
    if model["litmus"]:
        lines += ["| test | protocol | outcome sets | verdict |",
                  "|---|---|---:|---|"]
        for c in model["litmus"]:
            lines.append(f"| {c['test']} | {c['protocol']} "
                         f"| {c['observed']}/{c['allowed']} "
                         f"| {_litmus_cell_text(c)} |")
    else:
        lines.append("*no litmus report loaded (cache-sim analyze "
                     "--litmus --json, then dashboard --litmus "
                     "report.json)*")
    lines += ["", "## Roofline points", ""]
    if model["roofline"]:
        lines += ["| entry | kernel | AI (flop/B) | attainable flop/s "
                  "| device |", "|---|---|---:|---:|---|"]
        for p in model["roofline"]:
            lines.append(
                f"| {p['entry']} | {p['kernel']} | {p['ai']:.3f} "
                f"| {p['attainable_flops_per_s']:.3g} "
                f"| {p['device_kind']} |")
    else:
        lines.append("*no cost vectors recorded yet "
                     "(bench.py --record on a cost-model backend)*")
    return "\n".join(lines) + "\n"


# lint: host
def render(entries: List[dict], html_path: Optional[str] = None,
           md_path: Optional[str] = None,
           litmus: Optional[dict] = None,
           recordings: Optional[list] = None,
           profiles: Optional[list] = None) -> dict:
    """Build the model and write the requested artifacts; returns
    ``{"model", "html_path", "md_path"}``."""
    model = build_model(entries, litmus=litmus, recordings=recordings,
                        profiles=profiles)
    if html_path:
        with open(html_path, "w") as f:
            f.write(render_html(model))
    if md_path:
        with open(md_path, "w") as f:
            f.write(render_markdown(model))
    return {"model": model, "html_path": html_path, "md_path": md_path}
