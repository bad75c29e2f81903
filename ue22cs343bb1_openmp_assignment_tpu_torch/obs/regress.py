"""Noise-aware benchmark comparison: the brain of ``cache-sim bench-diff``.

The question this module answers used to be argued by hand in PERF.md:
"round r04's headline is 3.3% below r03 — regression or link noise?"
With only medians that argument can't be settled; with the full rep
vectors (see :mod:`obs.history`) it can. A delta counts as a
**regression** only when it clears two independent bars:

1. **Statistical**: a one-sided Mann-Whitney U test on the rep-time
   vectors rejects "B is not slower than A" at ``alpha``. Rep counts
   are tiny (3 per side is the norm), so the test is exact — the null
   distribution of U is enumerated over all C(n+m, n) rank splits,
   falling back to the tie-corrected normal approximation only when
   enumeration would exceed ~100k splits. Note the floor: with 3v3
   reps the smallest achievable one-sided p is 1/C(6,3) = 0.05, which
   is why the default alpha is 0.05 and why practical significance
   must carry its share of the decision.
2. **Practical**: the relative median delta exceeds a threshold
   derived from the *recorded* rep spread of both sides —
   ``max(min_effect, spread_a, spread_b)`` where spread is
   (max-min)/median. A machine whose own reps wobble 4% cannot
   testify about a 3% delta.

Worked against the archive: r03 reps [0.850, 0.859, 0.889] vs r04
[0.853, 0.889, 0.891] — median delta +3.5%, spreads ~4.4% — fails the
practical bar: **noise** (matching PERF.md's hand verdict). Scale one
side by 1.10 and the delta (10%) clears the spread while the rank test
hits its exact p = 0.05 floor: **regression**.

Dependency-free (exact combinatorics + math.erf), host-side only.

The port's copy of the JAX package's ``obs/regress.py``, unchanged.
"""

from __future__ import annotations

import math
from itertools import combinations
from typing import List, Optional, Sequence

#: enumerate the exact U null distribution up to this many rank splits
_EXACT_LIMIT = 100_000

#: below this relative delta, never call a regression (compile jitter
#: on the bench link sits at a few percent even on quiet runs)
DEFAULT_MIN_EFFECT = 0.05

DEFAULT_ALPHA = 0.05


# lint: host
def _midranks(pooled: Sequence[float]) -> List[float]:
    """Ranks 1..N with ties sharing their average (mid) rank."""
    order = sorted(range(len(pooled)), key=lambda i: pooled[i])
    ranks = [0.0] * len(pooled)
    i = 0
    while i < len(order):
        j = i
        while (j + 1 < len(order)
               and pooled[order[j + 1]] == pooled[order[i]]):
            j += 1
        mid = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[order[k]] = mid
        i = j + 1
    return ranks


# lint: host
def _u_statistic(a: Sequence[float], b: Sequence[float]) -> float:
    """U for sample b: count of (a_i, b_j) pairs with b_j > a_i,
    ties counting one half. Large U => b stochastically larger."""
    u = 0.0
    for x in a:
        for y in b:
            if y > x:
                u += 1.0
            elif y == x:
                u += 0.5
    return u


# lint: host
def mann_whitney_u(a: Sequence[float], b: Sequence[float]) -> dict:
    """One-sided Mann-Whitney U test of H1 "b tends larger than a".

    Returns {"u", "p", "method"} with method "exact" (null
    distribution enumerated over rank splits, correct under ties) or
    "normal" (tie-corrected approximation) for large samples.
    Requires at least 2 observations per side.
    """
    n, m = len(a), len(b)
    if n < 2 or m < 2:
        raise ValueError(
            f"mann_whitney_u needs >=2 reps per side, got {n} and {m}")
    u_obs = _u_statistic(a, b)
    if math.comb(n + m, m) <= _EXACT_LIMIT:
        # Enumerate every assignment of the pooled values to the two
        # groups; the p-value is the fraction with U >= observed.
        # Enumerating index subsets (not value subsets) keeps tied
        # values distinct, so ties are handled exactly.
        pooled = list(a) + list(b)
        idx = range(n + m)
        count = 0
        total = 0
        for pick in combinations(idx, m):
            pick_set = set(pick)
            bb = [pooled[i] for i in pick]
            aa = [pooled[i] for i in idx if i not in pick_set]
            if _u_statistic(aa, bb) >= u_obs:
                count += 1
            total += 1
        return {"u": u_obs, "p": count / total, "method": "exact"}
    # Normal approximation with tie correction and continuity
    # correction (standard large-sample form).
    mean = n * m / 2.0
    pooled = list(a) + list(b)
    tie_sizes = {}
    for v in pooled:
        tie_sizes[v] = tie_sizes.get(v, 0) + 1
    nn = n + m
    tie_term = sum(t ** 3 - t for t in tie_sizes.values())
    var = (n * m / 12.0) * ((nn + 1) - tie_term / (nn * (nn - 1)))
    if var <= 0:  # all values identical
        return {"u": u_obs, "p": 1.0, "method": "normal"}
    z = (u_obs - mean - 0.5) / math.sqrt(var)
    p = 0.5 * (1.0 - math.erf(z / math.sqrt(2.0)))
    return {"u": u_obs, "p": p, "method": "normal"}


# lint: host
def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


# lint: host
def rel_spread(xs: Sequence[float]) -> float:
    """(max - min) / median — the recorded wobble of one capture."""
    if not xs:
        return 0.0
    med = _median(xs)
    return (max(xs) - min(xs)) / med if med > 0 else 0.0


# lint: host
def compare(entry_a: dict, entry_b: dict,
            min_effect: float = DEFAULT_MIN_EFFECT,
            alpha: float = DEFAULT_ALPHA) -> dict:
    """Compare two bench-history entries (A = baseline, B = candidate).

    Works in rep *times* (seconds; higher = slower), not the headline
    rate, so "B slower than A" is "B's times tend larger". Returns a
    verdict doc::

        {"verdict": "regression" | "improvement" | "noise"
                    | "incomparable",
         "delta_pct",            # (median_b - median_a)/median_a * 100
         "threshold_pct",        # practical-significance bar
         "p", "u", "method",     # rank test (p None when underpowered)
         "flags": [...],         # e.g. "low_power", "not_quiescent:b"
         "a": {...}, "b": {...}} # per-side label/median/spread/reps

    A regression needs BOTH delta_pct >= threshold_pct AND p <= alpha;
    improvements are judged symmetrically (reversed test). With fewer
    than 2 reps on either side the rank test is impossible — the
    verdict is practical-only and flagged "low_power".
    """
    flags = []
    if entry_a.get("metric") != entry_b.get("metric"):
        return {
            "verdict": "incomparable",
            "detail": (f"metric mismatch: {entry_a.get('metric')!r} vs "
                       f"{entry_b.get('metric')!r}"),
            "a": {"label": entry_a.get("label")},
            "b": {"label": entry_b.get("label")},
            "flags": ["metric_mismatch"],
        }
    cfg_a, cfg_b = entry_a.get("config"), entry_b.get("config")
    if cfg_a and cfg_b and cfg_a.get("engine") and cfg_b.get("engine") \
            and cfg_a["engine"] != cfg_b["engine"]:
        return {
            "verdict": "incomparable",
            "detail": (f"engine mismatch: {cfg_a['engine']!r} vs "
                       f"{cfg_b['engine']!r}"),
            "a": {"label": entry_a.get("label")},
            "b": {"label": entry_b.get("label")},
            "flags": ["engine_mismatch"],
        }
    dev_a = entry_a.get("device_kind")
    dev_b = entry_b.get("device_kind")
    if dev_a and dev_b and dev_a != dev_b:
        # times from different silicon never compare; refuse loudly
        # rather than produce a numerically plausible wrong verdict
        return {
            "verdict": "incomparable",
            "detail": (f"incomparable: different device "
                       f"({dev_a!r} vs {dev_b!r})"),
            "a": {"label": entry_a.get("label"), "device_kind": dev_a},
            "b": {"label": entry_b.get("label"), "device_kind": dev_b},
            "flags": ["device_mismatch"],
        }
    hlo_a = entry_a.get("hlo_fingerprint")
    hlo_b = entry_b.get("hlo_fingerprint")
    if hlo_a and hlo_b and hlo_a != hlo_b:
        # informational, not fatal: comparing across code changes is
        # the normal use of bench-diff, but the reader should know the
        # compiled program is not the same one
        flags.append("hlo_changed")
    for side, e in (("a", entry_a), ("b", entry_b)):
        if e.get("quiescent") is False:
            flags.append(f"not_quiescent:{side}")
    reps_a = list(entry_a.get("rep_times_s") or [])
    reps_b = list(entry_b.get("rep_times_s") or [])
    if not reps_a or not reps_b:
        return {
            "verdict": "incomparable",
            "detail": "missing rep_times_s on one side",
            "a": {"label": entry_a.get("label"), "reps": len(reps_a)},
            "b": {"label": entry_b.get("label"), "reps": len(reps_b)},
            "flags": flags + ["no_reps"],
        }
    med_a, med_b = _median(reps_a), _median(reps_b)
    spread_a, spread_b = rel_spread(reps_a), rel_spread(reps_b)
    delta = (med_b - med_a) / med_a
    threshold = max(min_effect, spread_a, spread_b)

    p = u = method = None
    p_impr = None
    if len(reps_a) >= 2 and len(reps_b) >= 2:
        slower = mann_whitney_u(reps_a, reps_b)   # H1: b times larger
        faster = mann_whitney_u(reps_b, reps_a)   # H1: a times larger
        u, method = slower["u"], slower["method"]
        p, p_impr = slower["p"], faster["p"]
        # with too few reps even a perfect separation cannot reach
        # alpha (2v2: floor = 1/C(4,2) ≈ 0.17) — the rank test is
        # structurally mute, so the practical bar decides alone
        if 1.0 / math.comb(len(reps_a) + len(reps_b),
                           min(len(reps_a), len(reps_b))) > alpha:
            flags.append("low_power")
            p = p_impr = None
    else:
        flags.append("low_power")

    if delta >= threshold and (p is None or p <= alpha):
        verdict = "regression"
    elif -delta >= threshold and (p_impr is None or p_impr <= alpha):
        verdict = "improvement"
    else:
        verdict = "noise"

    return {
        "verdict": verdict,
        "delta_pct": round(delta * 100.0, 3),
        "threshold_pct": round(threshold * 100.0, 3),
        "p": p,
        "u": u,
        "method": method,
        "alpha": alpha,
        "flags": flags,
        "a": {"label": entry_a.get("label"),
              "median_s": round(med_a, 6),
              "spread_pct": round(spread_a * 100.0, 3),
              "reps": len(reps_a)},
        "b": {"label": entry_b.get("label"),
              "median_s": round(med_b, 6),
              "spread_pct": round(spread_b * 100.0, 3),
              "reps": len(reps_b)},
    }


#: default tolerance for the exact bytes/instr gate — cost_analysis is
#: deterministic per HLO, so this only absorbs benign layout churn
#: (padding, fusion boundary shifts), not measurement noise
DEFAULT_BYTES_TOL_PCT = 2.0


# lint: host
def compare_cost(entry_a: dict, entry_b: dict,
                 tol_pct: float = DEFAULT_BYTES_TOL_PCT) -> dict:
    """Exact bytes/instr comparison of two history entries' cost
    vectors (A = baseline, B = candidate).

    Unlike :func:`compare`, this needs no reps and no statistics: XLA's
    ``cost_analysis()`` is deterministic per compiled HLO, so any
    bytes/instr increase beyond ``tol_pct`` IS a regression — there is
    no noise to hide behind. Returns a verdict doc::

        {"verdict": "regression" | "improvement" | "pass"
                    | "incomparable",
         "delta_pct",                  # bytes/instr relative delta
         "tol_pct",
         "bytes_per_instr": {"a", "b"},
         "offending_kernels": [{"name", "hbm_bytes_a", "hbm_bytes_b",
                                "delta_pct"}, ...],  # worst first
         "flags": [...], "a": {...}, "b": {...}}

    Incomparable when either side lacks a usable cost vector (no
    ``cost`` recorded, ``cost_available`` false, or bytes/instr
    missing) or when the two entries come from different device kinds.
    """
    flags = []
    dev_a = entry_a.get("device_kind")
    dev_b = entry_b.get("device_kind")
    if dev_a and dev_b and dev_a != dev_b:
        return {
            "verdict": "incomparable",
            "detail": (f"incomparable: different device "
                       f"({dev_a!r} vs {dev_b!r})"),
            "a": {"label": entry_a.get("label"), "device_kind": dev_a},
            "b": {"label": entry_b.get("label"), "device_kind": dev_b},
            "flags": ["device_mismatch"],
        }
    cost_a = entry_a.get("cost")
    cost_b = entry_b.get("cost")
    for side, cost, e in (("a", cost_a, entry_a),
                          ("b", cost_b, entry_b)):
        if (not isinstance(cost, dict)
                or not cost.get("cost_available", False)
                or not isinstance(cost.get("bytes_per_instr"),
                                  (int, float))):
            return {
                "verdict": "incomparable",
                "detail": (f"no usable cost vector on side "
                           f"{side} ({e.get('label')!r})"),
                "a": {"label": entry_a.get("label")},
                "b": {"label": entry_b.get("label")},
                "flags": ["no_cost"],
            }
    hlo_a = entry_a.get("hlo_fingerprint")
    hlo_b = entry_b.get("hlo_fingerprint")
    if hlo_a and hlo_b and hlo_a != hlo_b:
        flags.append("hlo_changed")
    bpi_a = float(cost_a["bytes_per_instr"])
    bpi_b = float(cost_b["bytes_per_instr"])
    if bpi_a <= 0:
        return {
            "verdict": "incomparable",
            "detail": "baseline bytes/instr is zero",
            "a": {"label": entry_a.get("label")},
            "b": {"label": entry_b.get("label")},
            "flags": flags + ["no_cost"],
        }
    delta = (bpi_b - bpi_a) / bpi_a

    # name the kernels that carry the increase, worst first
    kerns_a = cost_a.get("kernels") or {}
    kerns_b = cost_b.get("kernels") or {}
    offending = []
    for name in sorted(set(kerns_a) | set(kerns_b)):
        ba = float((kerns_a.get(name) or {}).get("hbm_bytes", 0.0))
        bb = float((kerns_b.get(name) or {}).get("hbm_bytes", 0.0))
        if bb <= ba:
            continue
        kd = (bb - ba) / ba if ba > 0 else float("inf")
        if kd * 100.0 > tol_pct:
            offending.append({
                "name": name,
                "hbm_bytes_a": ba,
                "hbm_bytes_b": bb,
                "delta_pct": (round(kd * 100.0, 3)
                              if math.isfinite(kd) else None),
            })
    offending.sort(
        key=lambda o: -(o["hbm_bytes_b"] - o["hbm_bytes_a"]))

    if delta * 100.0 > tol_pct:
        verdict = "regression"
    elif -delta * 100.0 > tol_pct:
        verdict = "improvement"
    else:
        verdict = "pass"
    return {
        "verdict": verdict,
        "delta_pct": round(delta * 100.0, 3),
        "tol_pct": tol_pct,
        "bytes_per_instr": {"a": bpi_a, "b": bpi_b},
        "offending_kernels": offending,
        "flags": flags,
        "a": {"label": entry_a.get("label"),
              "device_kind": dev_a,
              "hlo_fingerprint": hlo_a},
        "b": {"label": entry_b.get("label"),
              "device_kind": dev_b,
              "hlo_fingerprint": hlo_b},
    }


# lint: host
def format_cost_report(rep: dict) -> str:
    """Glanceable lines for the bytes gate (JSON is the machine
    surface)."""
    a, b = rep.get("a", {}), rep.get("b", {})
    lines = [(f"bench-diff --bytes: {a.get('label', '?')} -> "
              f"{b.get('label', '?')}: {rep['verdict'].upper()}")]
    if rep["verdict"] == "incomparable":
        lines.append(f"  {rep.get('detail', '')}")
    else:
        bpi = rep.get("bytes_per_instr", {})
        lines.append(
            f"  bytes/instr {bpi.get('a'):.4f} -> {bpi.get('b'):.4f} "
            f"({rep['delta_pct']:+.2f}%, tolerance "
            f"{rep['tol_pct']:.2f}%)")
        for o in rep.get("offending_kernels", []):
            d = (f"{o['delta_pct']:+.2f}%" if o["delta_pct"] is not None
                 else "new traffic")
            lines.append(
                f"    kernel {o['name']}: {o['hbm_bytes_a']:.0f} -> "
                f"{o['hbm_bytes_b']:.0f} HBM bytes/step ({d})")
    if rep.get("flags"):
        lines.append("  flags: " + ", ".join(rep["flags"]))
    return "\n".join(lines)


# lint: host
def compare_latency(entry_a: dict, entry_b: dict,
                    min_effect: float = DEFAULT_MIN_EFFECT,
                    alpha: float = DEFAULT_ALPHA) -> dict:
    """Compare two entries' open-loop latency blocks (A = baseline,
    B = candidate; obs.history v1.4, recorded by ``bench.py --soak``).

    Same two-bar decision as :func:`compare`, but over per-JOB latency
    samples instead of per-rep wall times:

    1. **Statistical**: one-sided Mann-Whitney U on the raw
       ``samples_ms`` vectors (a soak yields tens of samples, so the
       rank test has real power here). Skipped (p None, flagged
       "low_power") when either side recorded fewer than 2 samples.
    2. **Practical**: the p95 relative delta must exceed
       ``min_effect`` — and ONLY ``min_effect``. The rep-spread term
       of :func:`compare` is deliberately absent: job latencies across
       a mixed open-loop stream spread structurally (different
       workloads, different queue positions), so "spread" here is
       signal, not machine wobble; the rank test carries the noise
       question.

    Incomparable when metrics, device kinds, or **arrival rates**
    differ (latency under different offered load measures a different
    operating point), or when either side has no latency block.
    """
    flags = []
    if entry_a.get("metric") != entry_b.get("metric"):
        return {
            "verdict": "incomparable",
            "detail": (f"metric mismatch: {entry_a.get('metric')!r} vs "
                       f"{entry_b.get('metric')!r}"),
            "a": {"label": entry_a.get("label")},
            "b": {"label": entry_b.get("label")},
            "flags": ["metric_mismatch"],
        }
    dev_a = entry_a.get("device_kind")
    dev_b = entry_b.get("device_kind")
    if dev_a and dev_b and dev_a != dev_b:
        return {
            "verdict": "incomparable",
            "detail": (f"incomparable: different device "
                       f"({dev_a!r} vs {dev_b!r})"),
            "a": {"label": entry_a.get("label"), "device_kind": dev_a},
            "b": {"label": entry_b.get("label"), "device_kind": dev_b},
            "flags": ["device_mismatch"],
        }
    lat_a = entry_a.get("latency")
    lat_b = entry_b.get("latency")
    for side, lat, e in (("a", lat_a, entry_a), ("b", lat_b, entry_b)):
        if not isinstance(lat, dict):
            return {
                "verdict": "incomparable",
                "detail": (f"no latency block on side {side} "
                           f"({e.get('label')!r}) — record it with "
                           "bench.py --soak"),
                "a": {"label": entry_a.get("label")},
                "b": {"label": entry_b.get("label")},
                "flags": ["no_latency"],
            }
    rate_a = lat_a.get("arrival_rate")
    rate_b = lat_b.get("arrival_rate")
    if rate_a != rate_b:
        return {
            "verdict": "incomparable",
            "detail": (f"arrival-rate mismatch: {rate_a!r} vs "
                       f"{rate_b!r} jobs/s — latency at different "
                       "offered loads measures different operating "
                       "points"),
            "a": {"label": entry_a.get("label"), "arrival_rate": rate_a},
            "b": {"label": entry_b.get("label"), "arrival_rate": rate_b},
            "flags": ["arrival_rate_mismatch"],
        }
    for side, lat in (("a", lat_a), ("b", lat_b)):
        if lat.get("saturated"):
            flags.append(f"saturated:{side}")
    p95_a = float(lat_a["p95_ms"])
    p95_b = float(lat_b["p95_ms"])
    if p95_a <= 0:
        return {
            "verdict": "incomparable",
            "detail": "baseline p95 is zero",
            "a": {"label": entry_a.get("label")},
            "b": {"label": entry_b.get("label")},
            "flags": flags + ["no_latency"],
        }
    delta = (p95_b - p95_a) / p95_a
    threshold = min_effect

    samp_a = list(lat_a.get("samples_ms") or [])
    samp_b = list(lat_b.get("samples_ms") or [])
    p = u = method = None
    p_impr = None
    if len(samp_a) >= 2 and len(samp_b) >= 2:
        slower = mann_whitney_u(samp_a, samp_b)  # H1: b latencies larger
        faster = mann_whitney_u(samp_b, samp_a)  # H1: a latencies larger
        u, method = slower["u"], slower["method"]
        p, p_impr = slower["p"], faster["p"]
        if 1.0 / math.comb(len(samp_a) + len(samp_b),
                           min(len(samp_a), len(samp_b))) > alpha:
            flags.append("low_power")
            p = p_impr = None
    else:
        flags.append("low_power")

    if delta >= threshold and (p is None or p <= alpha):
        verdict = "regression"
    elif -delta >= threshold and (p_impr is None or p_impr <= alpha):
        verdict = "improvement"
    else:
        verdict = "noise"

    def _side(e, lat, samples):
        return {"label": e.get("label"),
                "p50_ms": lat.get("p50_ms"),
                "p95_ms": lat.get("p95_ms"),
                "p99_ms": lat.get("p99_ms"),
                "queue_depth_peak": lat.get("queue_depth_peak"),
                "samples": len(samples)}

    return {
        "verdict": verdict,
        "delta_pct": round(delta * 100.0, 3),
        "threshold_pct": round(threshold * 100.0, 3),
        "arrival_rate": rate_a,
        "p": p,
        "u": u,
        "method": method,
        "alpha": alpha,
        "flags": flags,
        "a": _side(entry_a, lat_a, samp_a),
        "b": _side(entry_b, lat_b, samp_b),
    }


# lint: host
def format_latency_report(rep: dict) -> str:
    """Glanceable lines for the latency gate (JSON is the machine
    surface)."""
    a, b = rep.get("a", {}), rep.get("b", {})
    lines = [(f"bench-diff --latency: {a.get('label', '?')} -> "
              f"{b.get('label', '?')}: {rep['verdict'].upper()}")]
    if rep["verdict"] == "incomparable":
        lines.append(f"  {rep.get('detail', '')}")
    else:
        lines.append(
            f"  p95 {a.get('p95_ms')}ms -> {b.get('p95_ms')}ms "
            f"({rep['delta_pct']:+.2f}%), practical bar "
            f"{rep['threshold_pct']:.2f}% "
            f"@ {rep.get('arrival_rate')} jobs/s "
            f"({a.get('samples')} vs {b.get('samples')} job samples)")
        if rep.get("p") is not None:
            lines.append(
                f"  Mann-Whitney one-sided p={rep['p']:.4f} "
                f"({rep['method']}, alpha={rep['alpha']})")
    if rep.get("flags"):
        lines.append("  flags: " + ", ".join(rep["flags"]))
    return "\n".join(lines)


# lint: host
def format_report(rep: dict) -> str:
    """Two-to-four human lines for terminal output (JSON is the
    machine surface; this is the glanceable one)."""
    lines = []
    a, b = rep.get("a", {}), rep.get("b", {})
    head = (f"bench-diff: {a.get('label', '?')} -> {b.get('label', '?')}"
            f": {rep['verdict'].upper()}")
    lines.append(head)
    if rep["verdict"] == "incomparable":
        lines.append(f"  {rep.get('detail', '')}")
    else:
        lines.append(
            f"  median {a.get('median_s')}s -> {b.get('median_s')}s "
            f"({rep['delta_pct']:+.2f}%), practical bar "
            f"{rep['threshold_pct']:.2f}% "
            f"(spreads {a.get('spread_pct')}% / {b.get('spread_pct')}%)")
        if rep.get("p") is not None:
            lines.append(
                f"  Mann-Whitney one-sided p={rep['p']:.4f} "
                f"({rep['method']}, alpha={rep['alpha']})")
    if rep.get("flags"):
        lines.append("  flags: " + ", ".join(rep["flags"]))
    return "\n".join(lines)
