"""The port's serving layer against the JAX package's, exactly.

``state.stack_states`` / ``index_state`` / ``set_state``, the wave
runners of ``ops/step.py`` (one ``cycle`` under ``torch.func.vmap`` over
the job axis, done jobs frozen each cycle) and ``serve.py``: every leaf
of every slot, and the ``serve`` documents and ``--out-dir`` files byte
for byte under a VirtualClock. Both sides run on the CPU at 8 nodes x 8
instructions; the JAX waves share one compile per (slots, chunk).
"""

import dataclasses
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu import serve as jserve
from ue22cs343bb1_openmp_assignment_tpu import state as jst
from ue22cs343bb1_openmp_assignment_tpu.obs.clock import (
    VirtualClock as JaxClock)
from ue22cs343bb1_openmp_assignment_tpu.ops import step as jstep
from ue22cs343bb1_openmp_assignment_tpu_torch import serve as tserve
from ue22cs343bb1_openmp_assignment_tpu_torch import state as tst
from ue22cs343bb1_openmp_assignment_tpu_torch.obs.clock import (
    VirtualClock as PortClock)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step as tstep

from tests.torch_parity import assert_sim_states_equal

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLOTS, CHUNK, MAX = 8, 8, 100_000


def _jax_specs(n=12):
    """The mixed traffic at 8 x 8, three jobs padded on one or both
    axes into the 8 x 8 slot."""
    specs = jserve.mixed_jobs(n, nodes=8, trace_len=8)
    pads = {2: dict(nodes=4, trace_len=4), 5: dict(trace_len=4),
            9: dict(nodes=2)}
    return [dataclasses.replace(s, **pads.get(i, {}))
            for i, s in enumerate(specs)]


def _port(specs):
    return [tserve.JobSpec(**dataclasses.asdict(s)) for s in specs]


def _batches(specs):
    """The same slot-shaped batch on both sides (JAX, port)."""
    jcfg = jserve.slot_config(specs)
    tcfg = tserve.slot_config(_port(specs))
    jb = jst.stack_states([jserve.build_job_state(
        jcfg, jserve.job_config(s), s) for s in specs])
    tb = tst.stack_states([tserve.build_job_state(
        tcfg, tserve.job_config(s), s, "cpu") for s in _port(specs)])
    return jcfg, jb, tcfg, tb


@pytest.fixture(scope="module")
def waves():
    """Both packages' waves to quiescence over the 8 x 8 mix and the
    padded mix (one JAX compile serves both)."""
    out = {}
    for name, specs in (("mixed", jserve.mixed_jobs(SLOTS, 8, 8)),
                        ("padded", _jax_specs(SLOTS))):
        jcfg, jb, tcfg, tb = _batches(specs)
        out[name] = (specs, tcfg,
                     jstep.run_wave_to_quiescence(jcfg, jb, CHUNK, MAX),
                     tstep.run_wave_to_quiescence(tcfg, tb, CHUNK, MAX))
    return out


def test_stack_index_set_state_round_trips():
    specs = _jax_specs(3)
    jcfg, jb, tcfg, tb = _batches(specs)
    assert tst.batch_size(tb) == jst.batch_size(jb) == 3
    assert_sim_states_equal(jb, tb)
    ps = _port(specs)
    for i, s in enumerate(ps):
        one = tserve.build_job_state(tcfg, tserve.job_config(s), s, "cpu")
        assert_sim_states_equal(jst.index_state(jb, i),
                                tst.index_state(tb, i), f"slot {i}: ")
        assert_sim_states_equal(one, tst.index_state(tb, i))
    # index_state is a copy: a later in-place set_state leaves it alone
    got0 = tst.index_state(tb, 0)
    before = {k: x.clone()
              for k, x in zip(tst.SIM_LEAVES, tst.state_leaves(got0))}
    new = tserve.build_job_state(tcfg, tserve.job_config(ps[2]), ps[2],
                                 "cpu")
    out = tst.set_state(tb, 0, new)
    assert out is tb
    for k, x in zip(tst.SIM_LEAVES, tst.state_leaves(got0)):
        assert torch.equal(before[k], x), k
    # slot 0 now holds the new job, its neighbours kept their bits; the
    # JAX set_state agrees leaf for leaf
    jnew = jserve.build_job_state(jcfg, jserve.job_config(specs[2]),
                                  specs[2])
    assert_sim_states_equal(jst.set_state(jb, 0, jnew), tb)
    assert_sim_states_equal(new, tst.index_state(tb, 0))
    np.testing.assert_array_equal(
        np.asarray(jst.batch_quiescent(jb)),
        tst.batch_quiescent(tb).numpy())


@pytest.mark.parametrize("mix", ["mixed", "padded"])
def test_wave_equals_jax_every_leaf_of_every_slot(waves, mix):
    specs, _, jout, tout = waves[mix]
    assert_sim_states_equal(jout, tout, f"{mix}: ")
    assert bool(tst.batch_quiescent(tout).all())


@pytest.mark.parametrize("mix", ["mixed", "padded"])
def test_frozen_jobs_keep_their_solo_cycle_count(waves, mix):
    """Each slot stops at its own quiescence while slot-mates run on:
    its final state is its solo chunk-1 run, cycle counters included."""
    specs, tcfg, _, tout = waves[mix]
    cycles = []
    for i, s in enumerate(_port(specs)):
        solo = tstep.run_to_quiescence(
            tcfg, tserve.build_job_state(tcfg, tserve.job_config(s), s,
                                         "cpu"))
        assert_sim_states_equal(solo, tst.index_state(tout, i),
                                f"{mix} slot {i}: ")
        cycles.append(int(solo.cycle))
    # the wave ran on past the shortest jobs (ran chunk-granular to the
    # longest), so the freeze did real work
    assert min(cycles) < max(cycles)


def test_wave_chunk_equals_jax_chunk_by_chunk():
    specs = _jax_specs(SLOTS)
    jcfg, jb, tcfg, tb = _batches(specs)
    for k in range(64):
        jb, jq, jd = jstep.run_wave_chunk(jcfg, jb, CHUNK, MAX)
        tb, tq, td = tstep.run_wave_chunk(tcfg, tb, CHUNK, MAX)
        assert_sim_states_equal(jb, tb, f"chunk {k}: ")
        np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        if bool(td.all()):
            break
    assert bool(td.all()) and 0 < k < 63


def test_wave_chunk_budget_mask_and_mid_wave_swap():
    """A budget-masked slot (max_cycles) freezes like a quiescent one;
    a set_state swap between chunks leaves its neighbours' bits as the
    JAX swap does."""
    specs = _jax_specs(SLOTS)
    jcfg, jb, tcfg, tb = _batches(specs)
    for _ in range(2):
        jb, _, _ = jstep.run_wave_chunk(jcfg, jb, CHUNK, 16)
        tb, tq, td = tstep.run_wave_chunk(tcfg, tb, CHUNK, 16)
    assert_sim_states_equal(jb, tb)
    assert bool(td.all()) and not bool(tq.all())
    assert int(tb.cycle.max()) == 16
    nxt = jserve.mixed_jobs(20, 8, 8)[17]
    jb = jst.set_state(jb, 3, jserve.build_job_state(
        jcfg, jserve.job_config(nxt), nxt))
    pn = _port([nxt])[0]
    tb = tst.set_state(tb, 3, tserve.build_job_state(
        tcfg, tserve.job_config(pn), pn, "cpu"))
    for _ in range(2):
        jb, _, _ = jstep.run_wave_chunk(jcfg, jb, CHUNK, 16)
        tb, _, _ = tstep.run_wave_chunk(tcfg, tb, CHUNK, 16)
    assert_sim_states_equal(jb, tb)
    assert int(tb.cycle[3]) == 16


def test_wave_runs_the_cycle_body_once_a_cycle(monkeypatch):
    """The wave is one vmapped cycle over the job axis: the Python body
    of ``cycle`` runs once per wave cycle, not once per slot."""
    specs = _port(_jax_specs(SLOTS))
    cfg = tserve.slot_config(specs)
    b = tst.stack_states([tserve.build_job_state(
        cfg, tserve.job_config(s), s, "cpu") for s in specs])
    calls = []
    real = tstep.cycle

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tstep, "cycle", counted)
    tstep.batched_wave_chunk(cfg, b, 5, MAX)
    assert len(calls) == 5


def test_wave_cycle_op_count_does_not_grow_with_slots():
    """Every op of a wave cycle is one batched op: the aten calls of one
    masked wave cycle are the same at 1 and at 8 slots."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[str(func)] += 1
            return func(*args, **(kwargs or {}))

    specs = _port(_jax_specs(SLOTS))
    cfg = tserve.slot_config(specs)
    counts = {}
    for B in (1, SLOTS):
        b = tst.stack_states([tserve.build_job_state(
            cfg, tserve.job_config(s), s, "cpu") for s in specs[:B]])
        b = tstep.batched_wave_chunk(cfg, b, 3, MAX)[0]
        with Count() as c:
            tstep.batched_wave_chunk(cfg, b, 1, MAX)
        counts[B] = c.n
    assert counts[1] == counts[SLOTS]


def _files(root) -> dict:
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_serve_docs_and_out_dir_byte_identical(tmp_path):
    """12 jobs through 8 slots (two waves, slots refilled between them,
    three padded jobs): the summary doc and every file under --out-dir
    (dumps, metrics.json, serve_summary.json, trace.perfetto.json)
    equal the JAX package's under a VirtualClock."""
    specs = _jax_specs(12)
    jd = jserve.serve(specs, slots=SLOTS, chunk=CHUNK, clock=JaxClock(),
                      out_dir=tmp_path / "jax")
    td = tserve.serve(_port(specs), slots=SLOTS, chunk=CHUNK,
                      clock=PortClock(), out_dir=tmp_path / "port",
                      device="cpu")
    assert json.dumps(td, sort_keys=True) == json.dumps(jd, sort_keys=True)
    assert td["wave_count"] == 2 and td["jobs_quiesced"] == 12
    fj, ft = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(fj) == sorted(ft)
    assert len(fj) == sum(s.nodes + 1 for s in specs) + 2
    assert [k for k in fj if fj[k] != ft[k]] == []
    # and each job's dumps equal its solo run's
    for s in _port(specs)[:3]:
        assert tserve.read_job_dumps(tmp_path / "port" / s.name, s.nodes) \
            == tserve.solo_dumps(s, device="cpu")


def test_serve_cli_side_by_side(tmp_path):
    """``serve`` in both CLIs: the same summary line up to the rate, and
    the same per-job files (dumps and metrics.json) under --out-dir."""
    import contextlib
    import io

    from ue22cs343bb1_openmp_assignment_tpu import cli as jcli
    from ue22cs343bb1_openmp_assignment_tpu_torch import cli as tcli
    jobs = tmp_path / "jobs.jsonl"
    jobs.write_text("".join(json.dumps(dataclasses.asdict(s)) + "\n"
                            for s in _jax_specs(12)))
    outs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["serve", "--jobs", str(jobs), "--slots", str(SLOTS),
                       "--chunk", str(CHUNK), "--out-dir",
                       str(tmp_path / name)] + extra)
        assert rc == 0
        line = buf.getvalue().strip().splitlines()[-1]
        outs[name] = re.sub(r"[0-9.]+ jobs/sec", "R jobs/sec", line)
    assert outs["jax"] == outs["port"]
    assert "12/12 jobs quiesced in 2 waves" in outs["port"]
    fj, ft = _files(tmp_path / "jax"), _files(tmp_path / "port")
    per_job = [k for k in fj if "/" in k]
    assert per_job and sorted(fj) == sorted(ft)
    assert [k for k in per_job if fj[k] != ft[k]] == []


@pytest.mark.parametrize("warm", [True, False],
                         ids=["warm-pass", "no-warm-pass"])
def test_bench_serve_on_cpu(capsys, tmp_path, warm):
    """The port's ``bench --serve``: one warm pass (its --serve-out-dir
    files the JAX serve's per-job files) then the median of --reps, or
    with --serve-no-warm every pass timed; the wave cycles are the serve
    doc's, and no kernel launches on the CPU."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    argv = ["--serve", "--serve-slots", "4", "--serve-jobs", "6",
            "--nodes", "8", "--trace-len", "8", "--chunk", str(CHUNK),
            "--reps", "2", "--device", "cpu"]
    extra = (["--serve-out-dir", str(tmp_path / "port")] if warm
             else ["--serve-no-warm"])
    rc = bench.main(argv + extra)
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and doc["jobs_quiesced"] == 6 and len(doc["reps_s"]) == 2
    assert (doc["warm_s"] is not None) is warm
    assert (doc["launches_warm"] is not None) is warm
    assert not any(doc["launches"].values())
    specs = jserve.mixed_jobs(6, nodes=8, trace_len=8)
    jd = jserve.serve(specs, slots=4, chunk=CHUNK, queue_capacity=64,
                      clock=JaxClock(), out_dir=tmp_path / "jax")
    assert doc["waves"] == jd["wave_count"] == 2
    assert doc["wave_cycles"] == bench.wave_cycles(jd, CHUNK)
    if warm:
        fj, ft = _files(tmp_path / "jax"), _files(tmp_path / "port")
        per_job = [k for k in fj if "/" in k]
        assert len(per_job) == 6 * (8 + 1)
        assert [k for k in per_job if fj[k] != ft.get(k)] == []
    assert bench.main(argv + ["--serve-no-warm", "--serve-out-dir",
                              str(tmp_path / "x")]) == 2


def _chip_reference():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_ref",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SERVE_REFERENCE


@pytest.mark.parametrize("shape,jobs", [("32x32", (0, 1, 2, 3, 1023)),
                                        ("16x16", (0, 5, 6, 639))])
def test_serve_reference_sample_is_the_jax_run(shape, jobs):
    """chip_smoke.SERVE_REFERENCE against the JAX package: a job's result
    does not depend on its slot, so a sample of its digests recomputed
    from JAX solo runs (chunk 1: the wave's exact stop) must match."""
    ref = _chip_reference()
    n = int(shape.split("x")[0])
    k = ref["hex"]
    assert len(ref[shape]) == k * ref["jobs"][shape]
    for i in jobs:
        spec = jserve.mixed_jobs(i + 1, nodes=n, trace_len=n)[i]
        cfg = jserve.job_config(spec)
        final = jstep.run_chunked_to_quiescence(
            cfg, jst.init_state(cfg, instr_arrays=jserve.build_job_arrays(
                cfg, spec)), 1, MAX)
        from ue22cs343bb1_openmp_assignment_tpu.utils import golden
        dumps = [golden.format_node_dump(d)
                 for d in golden.state_to_dumps(cfg, final)]
        digest = tserve.job_digest(dumps, jserve.job_metrics_doc(final))
        assert digest[:k] == ref[shape][i * k:(i + 1) * k], (shape, i)


@pytest.mark.slow
def test_serve_reference_is_the_jax_serve_run():
    """The whole of SERVE_REFERENCE recomputed by the JAX package's
    serve (scripts/serve_reference.py; ~5 min on one core)."""
    import importlib.util
    ref = _chip_reference()
    spec = importlib.util.spec_from_file_location(
        "serve_reference", ROOT / "scripts" / "serve_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for shape, jobs in ref["jobs"].items():
        n = int(shape.split("x")[0])
        got = "".join(d[:ref["hex"]] for d in mod.digests(jobs, n, n, 256,
                                                          32))
        assert got == ref[shape], shape
