"""Persistent serving daemon: the always-on front door.

The port of the JAX package's ``daemon/``. ``cache-sim-torch serve`` is
a batch program — the whole job stream is present at entry. This
package keeps a serving process up:

- :mod:`protocol` — the newline-delimited JSON socket protocol
  (``submit`` / ``status`` / ``result`` / ``stats`` / ``trace`` /
  ``drain`` / ``shutdown``) and unix/tcp address parsing;
- :mod:`bucketing` — slot shape classes chosen from the queue's shape
  histogram (bounds padding_waste);
- :mod:`core` — the deterministic scheduler: continuous admission
  (mid-wave slot swaps via ``ops.step.run_wave_chunk`` +
  ``state.set_state``), priority lanes with weighted admission, and
  bounded queues with explicit ``rejected`` backpressure;
- :mod:`server` — the socket layer around the core (``cache-sim-torch
  daemon``);
- :mod:`client` — the thin ``cache-sim-torch submit`` client.

The wire format is the JAX package's, so either package's client talks
to either package's server. The core is synchronous and clock-injected:
under a VirtualClock two identical submission schedules emit
byte-identical serve-trace docs. The server adds only transport: handler
threads enqueue into the core under one lock; the scheduler thread owns
every device call.
"""

from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.core import (  # noqa: F401
    DaemonCore, drive)
