"""obs: the host-side observability layer of the port.

So far only :mod:`obs.schema`, the ``cache-sim/metrics/v1.2`` report
that every ``--metrics`` path of the CLI emits. The other modules of the
JAX package's ``obs/`` come with the observability planes (ROADMAP.md).
"""
