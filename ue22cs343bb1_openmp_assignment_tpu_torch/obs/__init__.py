"""obs: the host-side observability layer of the port.

:mod:`obs.schema` (the ``cache-sim/metrics/v1.2`` report of every
``--metrics`` path), copies of the JAX package's host modules that read
the engines' captures (:mod:`obs.phases`, :mod:`obs.timeseries`,
:mod:`obs.txntrace`, :mod:`obs.critpath`, :mod:`obs.perfetto`,
:mod:`obs.cohprof`, :mod:`obs.flight`) and the verbs that run an engine
under them (:mod:`obs.verbs`). The rest of the JAX package's ``obs/``
waits for its slice (ROADMAP.md).
"""
