"""The port's ops plane and serving verbs against the JAX package's.

The copies (``obs/promexpo.py``, ``obs/fleet.py``, ``obs/burnrate.py``,
``obs/events.py``, the serving half of ``obs/schema.py``) render and
merge what the JAX modules do, and the verbs ``daemon``, ``submit``,
``watch`` and ``top`` of the port's CLI print what the JAX CLI prints,
each against a daemon of its own package under a VirtualClock. ``watch``
is bounded by a row count; every socket wait has its own timeout and
every server thread is joined in ``finally``.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import threading

import pytest

from ue22cs343bb1_openmp_assignment_tpu import cli as jcli
from ue22cs343bb1_openmp_assignment_tpu.daemon.client import (
    DaemonClient as JaxClient)
from ue22cs343bb1_openmp_assignment_tpu.obs import burnrate as jburn
from ue22cs343bb1_openmp_assignment_tpu.obs import fleet as jfleet
from ue22cs343bb1_openmp_assignment_tpu.obs import promexpo as jprom
from ue22cs343bb1_openmp_assignment_tpu.obs import schema as jschema
from ue22cs343bb1_openmp_assignment_tpu_torch import cli as tcli
from ue22cs343bb1_openmp_assignment_tpu_torch import serve as tserve
from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.client import (
    DaemonClient as PortClient)
from ue22cs343bb1_openmp_assignment_tpu_torch.daemon.core import (
    DaemonCore, attach_emitter, drive)
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import burnrate as tburn
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import events as tevents
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import fleet as tfleet
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import promexpo as tprom
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import schema as tschema
from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import VirtualClock

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _spec(name, nodes=2, trace_len=4, seed=0):
    return tserve.JobSpec(name=name, nodes=nodes, trace_len=trace_len,
                          seed=seed)


def _driven(schedule, **kw):
    core = DaemonCore(slots=2, max_buckets=2, chunk=8, clock=VirtualClock(),
                      device="cpu", **kw)
    em = attach_emitter(core)
    drive(core, schedule)
    return core, em


def _fixed_stats():
    """The fixed stats doc of the JAX package's exposition golden."""
    spec = importlib.util.spec_from_file_location(
        "jax_ops_plane", ROOT / "tests" / "test_ops_plane.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._FIXED_STATS


def test_promexpo_renders_the_golden_and_driven_docs():
    fixed = _fixed_stats()
    assert tprom.render(fixed) == (ROOT / "tests" / "golden" /
                                   "promexpo.txt").read_text()
    core, _ = _driven([(0.0, _spec("a"), "batch"),
                       (0.001, _spec("b", nodes=4), "interactive")])
    st = tschema.validate_daemon_stats(core.stats())
    assert jschema.validate_daemon_stats(json.loads(json.dumps(st)))
    assert tprom.render(st) == jprom.render(st)
    assert tprom.render({"jobs": {"done": 3}}) == jprom.render(
        {"jobs": {"done": 3}})


def test_fleet_merge_matches_jax():
    c1, e1 = _driven([(0.0, _spec("a"), "batch"),
                      (0.001, _spec("b", nodes=4), "interactive")])
    c2, e2 = _driven([(0.0, _spec("x"), "batch"),
                      (0.001, _spec("y", seed=1), "batch")])
    tevents.validate(None, e1.rows, "run")
    docs = [c1.stats(), c2.stats()]
    got = tfleet.merge_stats(docs, labels=["A", "B"])
    want = jfleet.merge_stats(json.loads(json.dumps(docs)),
                              labels=["A", "B"])
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    tschema.validate_fleet(got)
    assert tfleet.render_top(got) == jfleet.render_top(want)
    a = {"edges_ms": [1.0, 2.0], "counts": [1, 0, 0], "count": 1,
         "sum_ms": 0.5}
    with pytest.raises(ValueError, match="mismatched bucket edges"):
        tfleet._merge_hists([a, dict(a, edges_ms=[1.0, 4.0])])
    with pytest.raises(ValueError):
        tfleet.merge_stats([])


def test_burn_rate_monitor_matches_jax():
    spec = "5ms,objective=0.99,fast=60,slow=300,factor=2"
    mons = (tburn.monitor_from_spec(spec), jburn.monitor_from_spec(spec))
    for i in range(400):
        lat = 0.02 if 100 <= i < 220 else 0.001
        got = [m.feed(i * 0.5, lat) for m in mons]
        assert got[0] == got[1], i
    assert mons[0].summary() == mons[1].summary()
    assert mons[0].alerts


def _cli(main, argv):
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        rc = main(argv)
    return rc, o.getvalue(), e.getvalue()


def _daemon_thread(main, sock, extra):
    """``daemon`` of one package's CLI on a thread (VirtualClock)."""
    argv = ["daemon", "--addr", sock, "--slots", "2", "--chunk", "8",
            "--virtual-clock", "--quiet"] + extra
    th = threading.Thread(target=main, args=(argv,), daemon=True)
    th.start()
    return th


def test_serving_verbs_side_by_side(tmp_path):
    """``daemon``, ``submit`` (jobs, --wait, --stats, --drain,
    --shutdown), ``watch`` bounded by --max-rows and ``top --once`` in
    both CLIs, each against a daemon of its own package: equal output."""
    job = json.dumps({"name": "o0", "workload": "uniform", "nodes": 2,
                      "trace_len": 4})
    outs = {}
    for name, main, Client, extra in (
            ("jax", jcli.main, JaxClient, []),
            ("port", tcli.main, PortClient, ["--cpu"])):
        sock = str(tmp_path / f"{name}.sock")
        th = _daemon_thread(main, sock, extra)
        try:
            with Client(sock, timeout_s=30.0) as c:
                c.wait_up(timeout_s=60.0)
            runs = [
                ["submit", "--addr", sock, "--job", job, "--lane",
                 "interactive", "--wait", "--timeout", "120"],
                ["submit", "--addr", sock, "--stats"],
                ["watch", "--addr", sock, "--max-rows", "1", "--json"],
                ["watch", "--addr", sock, "--max-rows", "1"],
                ["top", sock, "--once", "--json"],
                ["top", sock, "--once", "--prom"],
                ["top", sock, "--once"],
                ["submit", "--addr", sock, "--drain", "--shutdown"]]
            outs[name] = [tuple(x.replace(sock, "{sock}") if isinstance(
                x, str) else x for x in _cli(main, argv)) for argv in runs]
            th.join(60.0)
            assert not th.is_alive()
        finally:
            if th.is_alive():
                with Client(sock, timeout_s=10.0) as c:
                    c.shutdown()
                th.join(30.0)
    for i, (a, b) in enumerate(zip(outs["jax"], outs["port"])):
        assert a == b, (i, a, b)
    rc, out, _ = outs["port"][0]
    assert rc == 0 and "result 'o0': done quiesced=True" in out
    stats = json.loads(outs["port"][1][1])
    assert tschema.validate_daemon_stats(stats)["jobs"]["done"] == 1
    tschema.validate_fleet(json.loads(outs["port"][4][1]))
    assert "drained: 1 job(s) done" in outs["port"][-1][2]
