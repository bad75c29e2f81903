"""Multi-window error-budget burn-rate alerting (the SRE pattern).

The existing ``--slo p95=<ms>`` gate is an end-of-run verdict: one
percentile over the whole run, checked once. This module is the
CONTINUOUS complement: every finished job is one streaming sample
(good = e2e latency within the SLO threshold, bad = over it), and the
monitor tracks the **error-budget burn rate** over two sliding
windows at once:

    budget    = 1 - objective          (the allowed bad fraction)
    burn(W)   = bad_rate_in_window_W / budget

A burn rate of 1.0 spends the budget exactly at the sustainable pace;
an alert fires when BOTH windows burn at ``factor``x or more — the
fast window (seconds) makes the alert prompt, the slow window
(minutes) keeps a short blip from paging. The pairing is the
multi-window multi-burn-rate rule from the Google SRE workbook: fast
alone is noisy, slow alone is late, together they are neither.

Alerts are edge-triggered with hysteresis: one alert per excursion
into breach (re-armed only after both windows drop back under
``factor``), so a sustained breach emits one ``slo-alert`` event, not
one per job. ``DaemonCore`` feeds the monitor from ``_extract`` and
injects each alert into the events stream (obs.events); ``soak`` and
``replay`` feed it on the client side and turn ``breached()`` into
the process exit code — the continuous verdict the end-of-run
``--slo`` check cannot give.

Deterministic by construction: the monitor never reads a clock — the
caller stamps every sample with its own (injected) time base, so a
VirtualClock session alerts byte-identically across runs.

Host-side and dependency-free (the daemon server and the future
fleet router import this; it must never import torch or the engines).

The port's copy of the JAX package's ``obs/burnrate.py``, unchanged apart from its import paths.
"""
# lint: host

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: default SLO objective: 99% of jobs within the latency threshold
DEFAULT_OBJECTIVE = 0.99

#: default fast/slow window lengths (seconds) and alert factor
DEFAULT_FAST_S = 60.0
DEFAULT_SLOW_S = 300.0
DEFAULT_FACTOR = 2.0


class BurnRateMonitor:
    """Streaming fast+slow-window burn-rate tracker for one SLO.

    ``feed(t_s, latency_s)`` records one finished job and returns the
    alert dict when this sample tips both windows over ``factor`` —
    None otherwise. The caller owns the time base (``t_s`` must be
    non-decreasing); samples older than ``slow_s`` are pruned.
    """

    # lint: host
    def __init__(self, threshold_ms: float,
                 objective: float = DEFAULT_OBJECTIVE,
                 fast_s: float = DEFAULT_FAST_S,
                 slow_s: float = DEFAULT_SLOW_S,
                 factor: float = DEFAULT_FACTOR):
        if threshold_ms <= 0:
            raise ValueError(f"threshold_ms must be > 0, "
                             f"got {threshold_ms}")
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), "
                             f"got {objective}")
        if fast_s <= 0 or slow_s <= 0:
            raise ValueError(f"window lengths must be > 0, "
                             f"got fast={fast_s} slow={slow_s}")
        if fast_s > slow_s:
            raise ValueError(f"fast window ({fast_s}s) must not exceed "
                             f"the slow window ({slow_s}s)")
        if factor <= 0:
            raise ValueError(f"factor must be > 0, got {factor}")
        self.threshold_ms = float(threshold_ms)
        self.objective = float(objective)
        self.budget = 1.0 - float(objective)
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.factor = float(factor)
        self.alerts: List[dict] = []
        self.samples = 0
        self.bad = 0
        self._window: List[Tuple[float, bool]] = []  # (t_s, bad)
        self._alerting = False                       # hysteresis latch

    # lint: host
    def _burn(self, now: float, window_s: float) -> Tuple[float, int, int]:
        """(burn rate, bad, total) over ``[now - window_s, now]``."""
        lo = now - window_s
        total = 0
        bad = 0
        for t, b in self._window:
            if t >= lo:
                total += 1
                bad += int(b)
        if total == 0:
            return 0.0, 0, 0
        return (bad / total) / self.budget, bad, total

    # lint: host
    def feed(self, t_s: float, latency_s: float) -> Optional[dict]:
        """One finished job at time ``t_s`` with end-to-end latency
        ``latency_s``; returns the alert dict iff this sample starts a
        breach excursion (both windows >= factor, previously armed)."""
        bad = float(latency_s) * 1e3 > self.threshold_ms
        self.samples += 1
        self.bad += int(bad)
        self._window.append((float(t_s), bad))
        lo = float(t_s) - self.slow_s
        while self._window and self._window[0][0] < lo:
            self._window.pop(0)
        fast_burn, fast_bad, fast_n = self._burn(t_s, self.fast_s)
        slow_burn, slow_bad, slow_n = self._burn(t_s, self.slow_s)
        breaching = (fast_burn >= self.factor
                     and slow_burn >= self.factor)
        if not breaching:
            self._alerting = False
            return None
        if self._alerting:
            return None                    # one alert per excursion
        self._alerting = True
        alert = {
            "t_s": float(t_s),
            "threshold_ms": self.threshold_ms,
            "objective": self.objective,
            "factor": self.factor,
            "fast_s": self.fast_s,
            "slow_s": self.slow_s,
            "fast_burn": fast_burn,
            "slow_burn": slow_burn,
            "fast_bad": fast_bad,
            "fast_samples": fast_n,
            "slow_bad": slow_bad,
            "slow_samples": slow_n,
        }
        self.alerts.append(alert)
        return alert

    # lint: host
    def breached(self) -> bool:
        return bool(self.alerts)

    # lint: host
    def summary(self) -> dict:
        """The continuous-verdict block a soak/replay doc embeds."""
        now = self._window[-1][0] if self._window else 0.0
        fast_burn, _, fast_n = self._burn(now, self.fast_s)
        slow_burn, _, slow_n = self._burn(now, self.slow_s)
        return {
            "threshold_ms": self.threshold_ms,
            "objective": self.objective,
            "factor": self.factor,
            "fast_s": self.fast_s,
            "slow_s": self.slow_s,
            "samples": self.samples,
            "bad": self.bad,
            "alerts": len(self.alerts),
            "alerting": self._alerting,
            "fast_burn": fast_burn,
            "slow_burn": slow_burn,
            "fast_samples": fast_n,
            "slow_samples": slow_n,
            "last_alert": self.alerts[-1] if self.alerts else None,
        }


# lint: host
def parse_burn_spec(spec: str) -> Dict[str, float]:
    """CLI spec → BurnRateMonitor kwargs. The one required term is the
    latency threshold; everything else defaults::

        "5ms"                                  -> threshold only
        "5ms,objective=0.999,fast=30,slow=120,factor=4"

    Terms: ``objective`` (fraction in (0,1)), ``fast``/``slow``
    (window seconds), ``factor`` (burn multiple)."""
    kw: Dict[str, float] = {}
    names = {"objective": "objective", "fast": "fast_s",
             "slow": "slow_s", "factor": "factor"}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            ms = part[:-2] if part.endswith("ms") else part
            try:
                kw["threshold_ms"] = float(ms)
            except ValueError:
                raise ValueError(f"bad burn-SLO threshold {part!r} "
                                 f"(want e.g. 5ms)")
            continue
        k, v = part.split("=", 1)
        k = k.strip()
        if k not in names:
            raise ValueError(f"unknown burn-SLO term {k!r} "
                             f"(one of {sorted(names)})")
        try:
            kw[names[k]] = float(v)
        except ValueError:
            raise ValueError(f"bad burn-SLO value {v!r} for {k}")
    if "threshold_ms" not in kw:
        raise ValueError(f"burn-SLO spec {spec!r} has no latency "
                         f"threshold (want e.g. \"5ms,factor=2\")")
    return kw


# lint: host
def monitor_from_spec(spec: str) -> BurnRateMonitor:
    return BurnRateMonitor(**parse_burn_spec(spec))
