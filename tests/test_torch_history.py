"""The port's bench history, regression comparator, ``bench-diff`` and
``bench --record`` against the JAX package, exactly.

``obs/history.py`` and ``obs/regress.py`` are copies of the JAX modules:
the same seeded inputs give the same entries, verdicts and reports.
``cache-sim-torch bench-diff`` prints what ``cache-sim bench-diff``
prints and exits with its code on the same files. ``bench --record``
writes entries that both packages validate, with the JAX bench's
fingerprint keys (read from the JAX ``bench.py`` source).
"""

import ast
import json
import pathlib

import numpy as np
import pytest

from ue22cs343bb1_openmp_assignment_tpu.obs import cli as jax_obs_cli
from ue22cs343bb1_openmp_assignment_tpu.obs import history as jax_history
from ue22cs343bb1_openmp_assignment_tpu.obs import regress as jax_regress
from ue22cs343bb1_openmp_assignment_tpu_torch import bench
from ue22cs343bb1_openmp_assignment_tpu_torch import cli as port_cli
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import history, regress

import tests.torch_parity  # noqa: F401,E402  (one torch thread a process)

ROOT = pathlib.Path(__file__).resolve().parents[1]
METRIC = "simulated RD/WR instrs/sec @64 cores (deep engine, uniform, 1 chip, cpu)"


def _entry(mod, label, reps, metric=METRIC, seed=0, cost_scale=1.0,
           lat_scale=1.0):
    """One v1.4 entry built by ``mod`` (either package's history) from
    seeded inputs: rep times, a cost vector and a latency block."""
    rng = np.random.default_rng(seed)
    samples = sorted(float(x) for x in
                     np.round(rng.lognormal(1.0, 0.3, 24) * lat_scale, 6))
    q = np.percentile(samples, [50, 95, 99], method="nearest")
    cost = {"cost_available": True,
            "bytes_per_instr": round(1200.0 * cost_scale, 6),
            "kernels": {"round": {"hbm_bytes": 4.0e5 * cost_scale},
                        "fold": {"hbm_bytes": 1.0e5}}}
    latency = {"p50_ms": float(q[0]), "p95_ms": float(q[1]),
               "p99_ms": float(q[2]), "max_ms": samples[-1],
               "jobs": len(samples), "arrival_rate": 20.0,
               "queue_depth_peak": int(rng.integers(1, 9)),
               "samples_ms": samples}
    return mod.entry(label=label, source="test",
                     result={"metric": metric,
                             "value": 1e6 / float(np.median(reps)),
                             "unit": "instrs/sec"},
                     extra={"engine": "deep", "rep_times_s": list(reps),
                            "elapsed_s": float(np.median(reps)),
                            "steps": 64, "retired": 1024,
                            "quiescent": True},
                     config={"engine": "deep", "nodes": 64},
                     device_kind="cpu", cost=cost, latency=latency)


def _reps(rng, n, scale=1.0, spread=0.01):
    return [round(float(x), 6) for x in
            scale * (0.5 + spread * rng.standard_normal(n))]


def _case(name):
    """(entry kwargs a, entry kwargs b) of one regress case, seeded."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "noise":
        return dict(reps=_reps(rng, 3)), dict(reps=_reps(rng, 3), seed=1)
    if name == "slowdown":
        a = _reps(rng, 3)
        return (dict(reps=a), dict(reps=[t * 1.10 for t in a], seed=0,
                                   cost_scale=1.10, lat_scale=1.10))
    if name == "improvement":
        a = _reps(rng, 3)
        return (dict(reps=a), dict(reps=[t * 0.85 for t in a],
                                   cost_scale=0.85, lat_scale=0.85))
    if name == "ties":
        a = [float(x) for x in rng.integers(1, 3, 3)]
        b = [float(x) for x in rng.integers(1, 3, 3)]
        return dict(reps=a), dict(reps=b)
    if name == "two-reps":
        return dict(reps=_reps(rng, 2)), dict(reps=_reps(rng, 2, 1.2))
    assert name == "metric-mismatch"
    return (dict(reps=_reps(rng, 3)),
            dict(reps=_reps(rng, 3), metric=METRIC.replace("64", "128")))


def _pair(mod, name):
    ka, kb = _case(name)
    return _entry(mod, "a", **ka), _entry(mod, "b", **kb)


def test_entries_validate_under_both_packages():
    """A port entry validates under the JAX validator and a JAX entry
    under the port's; built from the same inputs they are equal, and
    both refuse the same corruption."""
    port, jax_ = _entry(history, "x", [0.5, 0.6]), _entry(jax_history, "x",
                                                          [0.5, 0.6])
    assert port == jax_
    assert jax_history.validate_entry(port) is port
    assert history.validate_entry(jax_) is jax_
    for bad in ({**port, "rep_times_s": [0.0]}, {**port, "bogus": 1},
                {**port, "schema": "cache-sim/bench/v9"}):
        with pytest.raises(ValueError) as e_port:
            history.validate_entry(bad)
        with pytest.raises(ValueError) as e_jax:
            jax_history.validate_entry(bad)
        assert str(e_port.value) == str(e_jax.value)
    assert (history.SCHEMA_ID, history.SCHEMA_V1) == (
        jax_history.SCHEMA_ID, jax_history.SCHEMA_V1)


@pytest.mark.parametrize("name", ["BENCH_r03.json", "BENCH_r04.json",
                                  "MULTICHIP_r05.json"])
def test_ingest_archived_captures_equals_jax(name):
    """The archived round captures (read only) ingest to the same
    entries in both packages."""
    path = str(ROOT / name)
    fn = "ingest_multichip" if name.startswith("MULTICHIP") else \
        "ingest_capture"
    assert getattr(history, fn)(path) == getattr(jax_history, fn)(path)


@pytest.mark.parametrize("name", ["noise", "slowdown", "improvement", "ties",
                                  "two-reps", "metric-mismatch"])
def test_regress_equals_jax(name):
    """mann_whitney_u, compare, compare_cost, compare_latency and their
    reports equal the JAX module's on the same seeded entries."""
    a, b = _pair(history, name)
    assert (a, b) == _pair(jax_history, name)
    assert regress.mann_whitney_u(a["rep_times_s"], b["rep_times_s"]) == \
        jax_regress.mann_whitney_u(a["rep_times_s"], b["rep_times_s"])
    assert regress.rel_spread(a["rep_times_s"]) == \
        jax_regress.rel_spread(a["rep_times_s"])
    for cmp, fmt in (("compare", "format_report"),
                     ("compare_cost", "format_cost_report"),
                     ("compare_latency", "format_latency_report")):
        rep = getattr(regress, cmp)(a, b)
        assert rep == getattr(jax_regress, cmp)(a, b), cmp
        assert getattr(regress, fmt)(rep) == getattr(jax_regress, fmt)(rep)


def _history_file(tmp_path, name, *entries):
    path = tmp_path / name
    for e in entries:
        history.append(str(path), e)
    return str(path)


def _bench_diff_cases(tmp_path):
    a, b = _pair(history, "noise")
    slow_a, slow_b = _pair(history, "slowdown")
    bare = dict(a, cost=None)
    return {
        "noise": [_history_file(tmp_path, "a.jsonl", a),
                  _history_file(tmp_path, "b.jsonl", b)],
        "synthetic-regression": [str(ROOT / "BENCH_r03.json"),
                                 "--synthetic-slowdown", "12"],
        "against-last": ["--history", _history_file(
            tmp_path, "h.jsonl", slow_a, slow_b), "--against-last"],
        "against-last-one-entry": ["--history", _history_file(
            tmp_path, "one.jsonl", a), "--against-last", "--json"],
        "latency": ["--latency", _history_file(tmp_path, "la.jsonl", slow_a),
                    _history_file(tmp_path, "lb.jsonl", slow_b)],
        "synthetic-latency": [_history_file(tmp_path, "l.jsonl", a),
                              "--synthetic-latency", "20"],
        "bytes-costless": ["--bytes", _history_file(tmp_path, "c.jsonl",
                                                     bare),
                           _history_file(tmp_path, "d.jsonl", bare)],
        "synthetic-bytes": [_history_file(tmp_path, "s.jsonl", a),
                            "--synthetic-bytes", "20"],
        "usage-no-captures": [],
        "usage-against-last-no-history": ["--against-last"],
        "usage-bytes-and-latency": ["--bytes", "--latency", "x", "y"],
        "usage-bytes-tol": ["--bytes-tol", "3", "x", "y"],
        "usage-two-synthetics": [str(ROOT / "BENCH_r03.json"),
                                 "--synthetic-slowdown", "5",
                                 "--synthetic-bytes", "5"],
        "usage-missing-file": [str(tmp_path / "nope.jsonl"),
                               str(tmp_path / "nope.jsonl")],
    }


def test_bench_diff_equals_the_jax_verb(tmp_path, capsys):
    """``cache-sim-torch bench-diff`` against the JAX verb on the same
    files: the same stdout and exit code in every case (noise, a
    synthetic regression, --against-last, --latency, --bytes on
    cost-less entries, the usage errors)."""
    codes = {}
    for name, argv in _bench_diff_cases(tmp_path).items():
        rc = port_cli.main(["bench-diff", *argv])
        out = capsys.readouterr()
        rc_jax = jax_obs_cli.main_bench_diff(argv)
        out_jax = capsys.readouterr()
        assert (rc, out.out) == (rc_jax, out_jax.out), name
        assert out.err.replace("cache-sim-torch", "cache-sim") == \
            out_jax.err, name
        codes[name] = rc
    assert codes["noise"] == 0 and codes["synthetic-regression"] == 4
    assert codes["against-last"] == 4 and codes["synthetic-bytes"] == 4
    assert codes["bytes-costless"] == 2 and codes["usage-no-captures"] == 2


def _jax_fingerprint_keys():
    """The keys of each ``fingerprint = {...}`` dict in the JAX bench
    (``bench.py``), by the function that builds it."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = {}
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and isinstance(node.value,
                                                            ast.Dict)
                    and [getattr(t, "id", None) for t in node.targets]
                    == ["fingerprint"]):
                keys[fn.name] = {k.value for k in node.value.keys}
    return keys


RECORD_CASES = {
    "deep": ["--nodes", "64", "--trace-len", "16"],
    "sync": ["--engine", "sync", "--nodes", "64", "--trace-len", "16"],
    "async": ["--engine", "async", "--nodes", "64", "--trace-len", "16"],
    "serve": ["--serve", "--nodes", "64", "--trace-len", "16",
              "--serve-slots", "1", "--serve-jobs", "1"],
    "soak": ["--soak", "--nodes", "4", "--trace-len", "4",
             "--serve-slots", "2", "--arrival-rate", "20",
             "--soak-duration", "0.1"],
}


def _fresh_records(mode: str, chunk: int) -> tuple:
    """Dispatch records (one round or cycle, one chunk of the runner) of
    the config ``bench`` runs for ``RECORD_CASES[mode]`` on the CPU,
    built here from the bench's config functions."""
    import dataclasses

    from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
        CoherenceSystem)
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import roofline
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        sync_engine as se)
    if mode == "async":
        cfg = dataclasses.replace(bench.async_config(64, 16),
                                  transport="rdma", proc_local_permille=800)
        st0 = CoherenceSystem.from_workload(cfg, "uniform", device="cpu",
                                            local_frac=0.8).state
        return (roofline.kernel_record("step.cycle", step.cycle, cfg, st0),
                roofline.kernel_record(f"step.run_chunked[chunk={chunk}]",
                                       step.run_chunked_to_quiescence, cfg,
                                       st0, chunk, chunk))
    cfg = (bench.sync_config(64) if mode == "sync"
           else bench.deep_config(64))
    st0 = se.procedural_state(cfg, 16, device="cpu")
    return (roofline.kernel_record("sync.round_step", se.round_step, cfg,
                                   st0),
            roofline.kernel_record(f"sync.run_to_quiescence[chunk={chunk}]",
                                   se.run_sync_to_quiescence, cfg, st0,
                                   chunk, chunk))


@pytest.mark.parametrize("mode", sorted(RECORD_CASES))
def test_bench_record_on_cpu(tmp_path, capsys, mode):
    """``bench --record`` on the CPU appends one v1.4 entry that both
    packages validate, carrying the bench line's numbers and a config
    fingerprint with exactly the JAX bench's keys; on the deep, sync and
    async solo runs its cost vector is that of a fresh dispatch record of
    the same config (``hlo_fingerprint`` the runner record's), on the
    serving runs both stay null, as in JAX."""
    path = tmp_path / "h.jsonl"
    rc = bench.main([*RECORD_CASES[mode], "--chunk", "8", "--reps", "2",
                     "--device", "cpu", "--record", str(path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    (entry,) = history.load(str(path))
    assert jax_history.validate_entry(entry) == entry
    assert entry["schema"] == "cache-sim/bench/v1.4"
    assert entry["rep_times_s"] == line.get("reps_s", [line["wall_s"]])
    assert entry["retired"] == line.get("instrs_retired")
    assert entry["quiescent"] is True and entry["device_kind"] == "cpu"
    if mode in ("serve", "soak"):
        assert entry["hlo_fingerprint"] is None and entry["cost"] is None
    else:
        from ue22cs343bb1_openmp_assignment_tpu_torch.obs import roofline
        assert history.validate_entry(entry) == entry
        per, run = _fresh_records(mode, 8)
        assert entry["cost"] == json.loads(json.dumps(roofline.cost_vector(
            per, run, entry["steps"], entry["retired"])))
        assert entry["cost"]["cost_available"] is True
        assert entry["hlo_fingerprint"] == run["hlo_fingerprint"]
    assert entry["config"]["platform"] == "cpu"
    jax_keys = _jax_fingerprint_keys()
    if mode == "soak":
        assert set(entry["config"]) == jax_keys["_soak_bench"]
        assert entry["label"] == "soak@20/s" and entry["value"] == round(
            line["p95_ms"], 3)
        assert entry["latency"]["samples_ms"] and entry["serve"][
            "transport"] == "inproc"
    elif mode == "serve":
        assert set(entry["config"]) == jax_keys["_serve_bench"]
        assert entry["label"] == "serve@1" and entry["value"] == \
            line["jobs_per_sec"]
        assert entry["serve"]["jobs"] == 1 and entry["steps"] == \
            line["waves"]
    else:
        assert set(entry["config"]) == jax_keys["main"]
        assert entry["label"] == f"{mode}@64"
        assert entry["value"] == line["instrs_per_sec"]
        assert entry["steps"] == line.get("rounds", line.get("cycles"))
    assert entry["metric"].endswith(", cpu)")
