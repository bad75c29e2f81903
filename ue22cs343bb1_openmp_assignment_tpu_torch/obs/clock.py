"""Injectable monotonic clocks: the one time base of the serving layer.

Every serving timestamp — wave ``wall_s``, job-lifecycle span edges
(serve.SpanBook), soak arrival release — reads the SAME injected clock
object, never ``time.perf_counter()`` inline. Two reasons:

- **One time base.** A wave's ``wall_s`` and the spans of the jobs it
  ran must subtract consistently; mixing clock sources makes the span
  decomposition (queue_wait + run + extract == e2e) drift.
- **Determinism under test.** :class:`VirtualClock` never reads real
  time: it advances only by explicit, deterministic amounts (a fixed
  ``wave_s`` per wave via :meth:`on_wave`, the requested amount via
  :meth:`sleep`). A soak on a VirtualClock therefore emits
  byte-identical ``cache-sim/serve-trace/v1`` docs across runs — the
  determinism gate in tests/test_soak.py — and serving tests stop
  being wall-clock-flaky.

The protocol is three methods; anything implementing them injects:

========== ==========================================================
``now()``     current monotonic seconds (float)
``sleep(s)``  idle until ``s`` seconds pass (real sleep / virtual jump)
``on_wave()`` called once after each batched wave completes; the
              virtual clock charges its fixed per-wave cost here (the
              real clock ignores it — real time passed by itself)
========== ==========================================================

Host-side and dependency-free like the rest of obs.

The port's copy of the JAX package's ``obs/clock.py``, unchanged apart from its import paths.
"""
# lint: host

from __future__ import annotations

import time


class MonotonicClock:
    """The production time base: ``time.perf_counter``."""

    kind = "monotonic"

    # lint: host
    def now(self) -> float:
        return time.perf_counter()

    # lint: host
    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)

    # lint: host
    def on_wave(self) -> None:
        # real time elapsed during the wave on its own
        pass


class VirtualClock(MonotonicClock):
    """Deterministic test clock: time moves only when told to.

    ``now()`` is a pure read; each completed wave costs exactly
    ``wave_s`` virtual seconds (charged by :meth:`on_wave`), and
    ``sleep`` jumps forward by the requested amount. No call ever
    reads real time, so every timestamp derived from this clock is a
    pure function of the call sequence.
    """

    kind = "virtual"

    # lint: host
    def __init__(self, t0: float = 0.0, wave_s: float = 1e-3) -> None:
        if wave_s <= 0:
            raise ValueError(f"wave_s must be > 0, got {wave_s}")
        self._t = float(t0)
        self.wave_s = float(wave_s)

    # lint: host
    def now(self) -> float:
        return self._t

    # lint: host
    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self._t += float(seconds)

    # lint: host
    def on_wave(self) -> None:
        self._t += self.wave_s
