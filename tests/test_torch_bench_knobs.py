"""The port bench's deep and async knobs, and the two state helpers of
this slice, against the JAX package.

Each knob of the JAX bench (``bench.py:356-416``) sets one config field
by the rules of ``bench.py:565-584``; the port's bench sets the same
field, and a 64-node run on the CPU with the knob set ends after the
same rounds (cycles), with the same instructions retired, as the JAX
library's run of that config. The JAX runs compile one XLA program a
knob (about half a minute each on a CPU), so the fast tier holds the
port to their results pinned in ``JAX_RESULTS``; the ``slow`` test
recomputes every pin from the JAX package.

``state.continue_with_traces`` chains two phases on the message-level
engine exactly as JAX's does, and ``state.fault_key_from_seed`` gives
JAX's key bits.
"""

import argparse
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu import state as jstate
from ue22cs343bb1_openmp_assignment_tpu.config import (
    SystemConfig as JaxConfig)
from ue22cs343bb1_openmp_assignment_tpu.models.system import (
    CoherenceSystem as JaxSystem)
from ue22cs343bb1_openmp_assignment_tpu.ops import step as jstep
from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu_torch import bench, convert, state
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step

from tests.torch_parity import assert_sim_states_equal, cfg_pair

NODES, TRACE_LEN, CHUNK = 64, 8, 1

#: knob -> (bench flags, the config field JAX's bench sets from it, its
#: value there)
KNOBS = {
    "deep-slots": (["--deep-slots", "2"], "deep_slots", 2),
    "deep-g": (["--deep-g", "2"], "deep_ownerval_slots", 2),
    "deep-waves": (["--deep-waves", "2"], "deep_waves", 2),
    "deep-slack": (["--deep-slack", "2"], "deep_horizon_slack", 2),
    "read-storm": (["--read-storm"], "deep_read_storm", True),
    "no-exact-flags": (["--no-exact-flags"], "deep_exact_flags", False),
    "admission": (["--engine", "async", "--admission", "32"],
                  "admission_window", 32),
    "no-procedural": (["--no-procedural"], "procedural", None),
}

#: (steps, instructions retired, digest of every final leaf) of the JAX
#: library's run of each knob's config at NODES x TRACE_LEN, chunk CHUNK
#: (recomputed by test_jax_results_are_the_jax_packages)
JAX_RESULTS = {
    "admission": (61, 512, "34e02577f4d79013e0f846211c179b65"
                           "f2440774f23923918ebf26014b0e8222"),
    "deep-g": (4, 512, "362fdd77fbaaf9a16f4b3b40d88a3819"
                       "6171b424ae587ce93498bf21727f7eeb"),
    "deep-slack": (5, 512, "fdc9e9ae467eb9bdca12aba4aef7dda6"
                           "6a71629f936a5261fc32b421ca86dcc5"),
    "deep-slots": (4, 512, "57bbfe7c45386583f5b0d46d47698308"
                           "0b25d8176902db2ec44e9faf93f550fc"),
    "deep-waves": (4, 512, "64d9a947db078af7de5b083d22ab1609"
                           "34b9f75ec29884d41bc58010c8f78ec2"),
    "no-exact-flags": (5, 512, "324ce1c8cd902b2f3865e382c64d6d03"
                               "16bb507abb6eac8a216502d5aaced82a"),
    "no-procedural": (3, 512, "907a4889ec67a973af221c834b124f94"
                              "78e77e43814b8995b31020a53aa7cd99"),
    "read-storm": (5, 512, "525266104ff86f5c2c116024e19aea76"
                           "c35f7a190032e64ad479decb71261ac4"),
}


def _jax_config(knob):
    """The JAX bench's config of ``knob`` (``bench.py:233-267``)."""
    flags = KNOBS[knob][0]
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="deep")
    ap.add_argument("--deep-slots", type=int, default=None)
    ap.add_argument("--deep-g", type=int, default=None)
    ap.add_argument("--deep-waves", type=int, default=1)
    ap.add_argument("--deep-slack", type=int, default=4)
    ap.add_argument("--read-storm", action="store_true")
    ap.add_argument("--no-exact-flags", action="store_true")
    ap.add_argument("--admission", type=int, default=None)
    ap.add_argument("--procedural", default=True,
                    action=argparse.BooleanOptionalAction)
    args = ap.parse_args(flags)
    sync_like = args.engine != "async"
    cfg = JaxConfig.scale(num_nodes=NODES, admission_window=args.admission,
                          drain_depth=13 if sync_like else 16,
                          txn_width=3 if sync_like else 1)
    if sync_like:
        cfg = dataclasses.replace(
            cfg, deep_window=True,
            deep_slots=(2 if NODES >= 32768 else 3) if args.deep_slots
            is None else args.deep_slots,
            deep_ownerval_slots=args.deep_g or 1,
            deep_horizon_slack=args.deep_slack, deep_waves=args.deep_waves,
            deep_read_storm=args.read_storm,
            deep_exact_flags=not args.no_exact_flags)
    if args.procedural and sync_like:
        cfg = dataclasses.replace(cfg, procedural="uniform", max_instrs=1,
                                  proc_local_permille=800)
    return cfg, sync_like, args.procedural and sync_like


def result(st) -> tuple:
    """(steps, retired, leaves digest) of a final state of either
    package: a transactional state, or a message-level one."""
    if hasattr(st.metrics, "rounds"):
        return (int(np.asarray(st.metrics.rounds)),
                int(np.sum(np.asarray(st.metrics.instrs_retired))),
                convert.leaves_digest(convert.numpy_leaves(st)))
    return (int(np.asarray(st.metrics.cycles)),
            int(np.asarray(st.metrics.instrs_retired)),
            convert.leaves_digest(convert.sim_numpy_leaves(st)))


def jax_result(knob):
    """``result`` of the JAX library's run of ``knob``'s config, as the
    JAX bench runs it (``bench.py:314-378``)."""
    cfg, sync_like, procedural = _jax_config(knob)
    if procedural:
        return result(jse.run_sync_to_quiescence(
            cfg, jse.procedural_state(cfg, TRACE_LEN, seed=0), CHUNK, 5000))
    sysm = JaxSystem.from_workload(cfg, "uniform", trace_len=TRACE_LEN,
                                   seed=0, local_frac=0.8)
    if sync_like:
        return result(jse.run_sync_to_quiescence(
            cfg, jse.from_sim_state(cfg, sysm.state, seed=0), CHUNK, 5000))
    return result(jstep.run_chunked_to_quiescence(cfg, sysm.state, CHUNK,
                                                  5000))


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_bench_knob_sets_jax_field_and_runs(knob, capsys, monkeypatch):
    """The port's bench builds the field JAX's bench sets from the knob,
    names it in the JSON line's config block, and its 64-node CPU run
    with the knob ends on the JAX library run's steps, retired
    instructions and final state (every leaf, by digest)."""
    flags, field, value = KNOBS[knob]
    jcfg = _jax_config(knob)[0]
    assert getattr(jcfg, field) == value
    argv = [*flags, "--nodes", str(NODES), "--trace-len", str(TRACE_LEN),
            "--chunk", str(CHUNK), "--reps", "1", "--device", "cpu"]
    args = bench.build_parser().parse_args(argv)
    if args.engine == "async":
        cfg = bench.async_config(NODES, TRACE_LEN, args.queue_capacity,
                                 args.admission)
    else:
        cfg = bench.engine_config(args, torch.device("cpu"))[0]
        assert cfg.fused_round is False
    assert getattr(cfg, field) == getattr(jcfg, field)
    finals = []
    for mod, name in ((bench.se, "run_sync_to_quiescence"),
                      (step, "run_chunked_to_quiescence")):
        def keep(*a, _fn=getattr(mod, name), **k):
            finals.append(_fn(*a, **k))
            return finals[-1]
        monkeypatch.setattr(mod, name, keep)
    rc = bench.main(argv)
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and len(finals) == 2
    config_key = {"deep_ownerval_slots": "deep_g",
                  "deep_horizon_slack": "deep_slack",
                  "deep_read_storm": "read_storm",
                  "deep_exact_flags": "exact_flags",
                  "admission_window": "admission"}.get(field, field)
    assert doc["config"][config_key] == (
        False if field == "procedural" else value)
    steps = doc.get("rounds", doc.get("cycles"))
    want = tuple(JAX_RESULTS[knob])
    assert (steps, doc["instrs_retired"]) == want[:2]
    assert result(finals[-1]) == want


def test_deep_slots_default_two_from_32768_nodes():
    """The JAX bench's deep_slots rule: 3, and 2 from 32768 nodes up."""
    assert bench.deep_config(32767).deep_slots == 3
    assert bench.deep_config(32768).deep_slots == 2
    assert bench.deep_config(32768, deep_slots=4).deep_slots == 4


def test_cli_deep_knobs(tmp_path, capsys):
    """The CLI's --deep-g, --deep-slack, --read-storm and --no-exact-flags
    set the deep config's fields: its run equals the library's run of
    that config (metrics document and dumps); without --deep-window they
    exit 2."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import cli
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional \
        import TransactionalSystem
    from ue22cs343bb1_openmp_assignment_tpu_torch.obs import schema
    knobs = ["--deep-g", "2", "--deep-slack", "2", "--read-storm",
             "--no-exact-flags", "--deep-slots", "2", "--drain-depth", "4"]
    assert cli.main(["--engine", "sync", "--procedural", "--nodes", "8",
                     "--cpu", *knobs]) == 2
    assert "deep-window knobs" in capsys.readouterr().err
    assert cli.main(["--engine", "sync", "--procedural", "--deep-window",
                     "--nodes", "8", "--trace-len", "4", "--cpu",
                     "--metrics", "--dump", "--out-dir", str(tmp_path),
                     *knobs]) == 0
    got = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    cfg = SystemConfig.scale(
        num_nodes=8, procedural="uniform", max_instrs=1, proc_seed=0,
        queue_capacity=64, deep_window=True, deep_slots=2, deep_waves=1,
        txn_width=3, drain_depth=4, deep_ownerval_slots=2,
        deep_horizon_slack=2, deep_read_storm=True, deep_exact_flags=False)
    ref = TransactionalSystem.procedural(cfg, 4, device="cpu").run(
        100_000, chunk=16)
    assert got == schema.from_sync(ref.metrics, "deep")
    assert [(tmp_path / f"core_{n}_output.txt").read_text()
            for n in range(8)] == ref.dumps()


@pytest.mark.slow
def test_jax_results_are_the_jax_packages():
    """Every pin of JAX_RESULTS is the JAX library's run of its knob."""
    assert {k: jax_result(k) for k in KNOBS} == {
        k: tuple(v) for k, v in JAX_RESULTS.items()}


def _local_traces(rng, cfg, n_instrs):
    """Node-local reads and writes (tests/test_streaming.py)."""
    out = []
    for n in range(cfg.num_nodes):
        tr = []
        for _ in range(n_instrs):
            a = (n << cfg.block_bits) | int(rng.integers(cfg.mem_size))
            tr.append((0, a, 0) if rng.random() < 0.5
                      else (1, a, int(rng.integers(256))))
        out.append(tr)
    return out


def test_continue_with_traces_two_phases_equal_jax():
    """Two phases of 16 nodes, each run to quiescence cycle by cycle in
    both engines: every leaf equal after each phase and after the swap;
    a machine with work left raises JAX's ValueError."""
    jcfg, tcfg = cfg_pair(16, max_instrs=8)
    rng = np.random.default_rng(5)
    p1, p2 = _local_traces(rng, jcfg, 8), _local_traces(rng, jcfg, 8)
    cyc = jax.jit(jstep.cycle, static_argnums=0)
    js = jstate.init_state(jcfg, p1)
    ts = state.init_state(tcfg, p1, device="cpu")
    with pytest.raises(ValueError) as e_port:
        state.continue_with_traces(tcfg, step.cycle(tcfg, ts), traces=p2)
    with pytest.raises(ValueError) as e_jax:
        jstate.continue_with_traces(jcfg, cyc(jcfg, js), traces=p2)
    assert str(e_port.value) == str(e_jax.value)
    for phase, traces in ((1, p2), (2, None)):
        for _ in range(2000):
            if bool(js.quiescent()):
                break
            js, ts = cyc(jcfg, js), step.cycle(tcfg, ts)
        assert bool(js.quiescent()) and bool(ts.quiescent())
        assert_sim_states_equal(js, ts, f"phase {phase}: ")
        if traces is not None:
            js = jstate.continue_with_traces(jcfg, js, traces=traces)
            ts = state.continue_with_traces(tcfg, ts, traces=traces)
            assert_sim_states_equal(js, ts, "swap: ")
            assert ts.instr_op.device.type == "cpu"


def test_fault_key_from_seed_is_jax_bit_for_bit():
    """The uint32 key data of JAX's ``fault_key_from_seed``, as the
    port's int32 bit patterns, for seeds across the int32 range."""
    for seed in (0, 1, 7, 12345, 2**31 - 1, -1, -3):
        port = state.fault_key_from_seed(seed, device="cpu")
        want = np.asarray(jstate.fault_key_from_seed(seed))
        assert want.dtype == np.uint32
        np.testing.assert_array_equal(port.numpy().view(np.uint32), want)
