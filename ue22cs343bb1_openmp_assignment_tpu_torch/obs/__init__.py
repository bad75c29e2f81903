"""obs: the host-side observability layer of the port.

:mod:`obs.schema` (the ``cache-sim/metrics/v1.2`` report of every
``--metrics`` path), copies of the JAX package's host modules that read
the engines' captures (:mod:`obs.phases`, :mod:`obs.timeseries`,
:mod:`obs.txntrace`, :mod:`obs.critpath`, :mod:`obs.perfetto`,
:mod:`obs.cohprof`, :mod:`obs.flight`) and the verbs that run an engine
under them (:mod:`obs.verbs`); the serving documents (:mod:`obs.clock`,
:mod:`obs.events`, :mod:`obs.burnrate`, :mod:`obs.recording`,
:mod:`obs.promexpo`, :mod:`obs.fleet`); the bench history
(:mod:`obs.history`, :mod:`obs.regress`, the ``bench-diff`` verb
:mod:`obs.bench_diff`); and the performance report: :mod:`obs.roofline`
(the peak table with an ``h100`` row and the dispatch record, the
port's stand-in for XLA's cost model), :mod:`obs.profiler`
(``torch.profiler`` capture, cost attribution, the timer self-check),
the ``perf-report`` verb (:mod:`obs.perf_report`), and the bench-history
dashboard (:mod:`obs.dashboard`, the ``dashboard`` verb
:mod:`obs.dashboard_verb`). JAX's ``obs/cli.py`` verbs live in
:mod:`obs.verbs`, :mod:`obs.bench_diff`, :mod:`obs.perf_report` and
:mod:`obs.dashboard_verb`.
"""
