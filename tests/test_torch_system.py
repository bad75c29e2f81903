"""The slices as a whole: the port's TransactionalSystem to quiescence
equals JAX ``run_sync_to_quiescence`` at a 64-node copy of the bench's
deep config, through the fold path and through the fused round, and at
copies of the bench's sync configs (txn_width 3 and 1), through the
kernel route and through the plain rounds.

Final state, every metric (``rounds`` included: both runners test
quiescence only between ``chunk``-round blocks) and the
``printProcessorState`` dumps must be equal. Exact comparison.
"""

import dataclasses
import functools
import json
import pathlib

import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu.state import init_state
from ue22cs343bb1_openmp_assignment_tpu.utils import golden as jgolden
from ue22cs343bb1_openmp_assignment_tpu_torch import bench
from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional import (
    TransactionalSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    deep_round_kernel as drk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_multi_round_kernel as smk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_round_kernel as srk)

from tests.torch_parity import BENCH_DEEP, assert_states_equal, cfg_pair

LENGTH, CHUNK = 32, 16
NO_LAUNCHES = {"pre": 0, "flags": 0, "replay": 0, "round": 0,
               "sync_burst": 0, "sync_round": 0, "sync_multi_round": 0,
               "sync_window": 0, "sync_replay": 0, "ring": 0,
               "threefry": 0}


@functools.lru_cache(maxsize=None)
def _jax_quiescent():
    jcfg, _ = cfg_pair(64, **BENCH_DEEP)
    return jcfg, jse.run_sync_to_quiescence(
        jcfg, jse.procedural_state(jcfg, LENGTH, seed=2), CHUNK, 2000)


def _assert_matches_jax(got):
    jcfg, want = _jax_quiescent()
    assert got.quiescent and bool(want.quiescent())
    assert_states_equal(want, got.state)
    m = got.metrics
    assert m["rounds"] == int(want.metrics.rounds)
    assert m["rounds"] % CHUNK == 0
    assert m["instrs_retired"] == got.instrs_retired == 64 * LENGTH
    view = jse.to_dump_view(jcfg, want)
    assert got.dumps() == [jgolden.format_node_dump(d)
                           for d in jgolden.state_to_dumps(jcfg, view)]
    assert got.check_invariants() == jse.check_exact_directory(jcfg, want)


def test_run_to_quiescence_matches_jax():
    _, tcfg = cfg_pair(64, **BENCH_DEEP)
    sys_ = TransactionalSystem.procedural(tcfg, LENGTH, seed=2,
                                          device="cpu")
    _assert_matches_jax(sys_.run(max_rounds=2000, chunk=CHUNK))


def test_fused_round_to_quiescence_matches_jax(monkeypatch):
    """TransactionalSystem with fused_round takes the round kernel's
    path (its plain round on the CPU) every round, and ends where the
    JAX reference does."""
    _, tcfg = cfg_pair(64, **dict(BENCH_DEEP, fused_round=True))
    calls = []
    plain_round = drk.plain_round
    monkeypatch.setattr(drk, "plain_round",
                        lambda *a: calls.append(1) or plain_round(*a))
    sys_ = TransactionalSystem.procedural(tcfg, LENGTH, seed=2,
                                          device="cpu")
    got = sys_.run(max_rounds=2000, chunk=CHUNK)
    _assert_matches_jax(got)
    assert len(calls) == got.metrics["rounds"]


def test_run_rounds_and_step_agree():
    _, tcfg = cfg_pair(16, **BENCH_DEEP)
    a = TransactionalSystem.procedural(tcfg, 64, device="cpu")
    b = a.run_rounds(3)
    c = a.step().step().step()
    assert b.metrics == c.metrics and b.metrics["rounds"] == 3
    assert b.dumps() == c.dumps()


def _bench_doc(capsys, *extra):
    rc = bench.main(["--nodes", "16", "--trace-len", "8", "--chunk", "4",
                     "--reps", "1", "--device", "cpu", *extra])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    return json.loads(lines[0])


def test_bench_prints_one_json_line_on_cpu(capsys):
    doc = _bench_doc(capsys)
    assert doc["instrs_retired"] == 16 * 8 and doc["card"] == "cpu"
    assert doc["rounds"] % 4 == 0
    assert doc["launches"] == NO_LAUNCHES
    assert doc["fused_round"] is False      # auto: the card only


def test_bench_stays_inside_the_claim_key_budget(capsys):
    """From 8192 nodes up the claim keys leave fewer rounds than the
    bench's default cap of 100,000 (65,535 at 8192 nodes, 8191 at
    65536): the bench caps its run at the budget instead of refusing to
    start, as the JAX bench does."""
    rc = bench.main(["--nodes", "8192", "--trace-len", "2", "--chunk", "4",
                     "--reps", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    assert json.loads(lines[0])["instrs_retired"] == 8192 * 2


@pytest.mark.parametrize("mode,fused", [("on", True), ("off", False)])
def test_bench_fused_round_flag_on_cpu(capsys, mode, fused):
    """--fused-round on runs the round kernel's path (its plain version
    on the CPU, so no launch), off the fold path; both retire the same
    instructions in the same rounds."""
    doc = _bench_doc(capsys, "--fused-round", mode)
    assert doc["fused_round"] is fused
    assert doc["launches"] == NO_LAUNCHES
    ref = _bench_doc(capsys)
    assert (doc["rounds"], doc["instrs_retired"]) == (
        ref["rounds"], ref["instrs_retired"])


def test_bench_fused_round_auto_needs_a_supported_config(capsys):
    cfg = bench.deep_config(16)
    dev = torch.device("cuda")
    assert bench.with_fused_round(cfg, "auto", dev).fused_round
    storm = dataclasses.replace(cfg, deep_read_storm=True)
    assert not bench.with_fused_round(storm, "auto", dev).fused_round
    assert not bench.with_fused_round(storm, "on", dev).fused_round
    assert "needs a supported config" in capsys.readouterr().err
    assert not bench.with_fused_round(cfg, "off", dev).fused_round


# -- the sync window engine ---------------------------------------------------

SYNC = dict(procedural="uniform", max_instrs=1, proc_local_permille=800)
SYNC_CASES = {
    # name: (nodes, config overrides, instructions per node)
    "multi": (128, dict(SYNC, drain_depth=4, txn_width=3), 48),
    "single": (256, dict(SYNC, drain_depth=16), 32),
}


@functools.lru_cache(maxsize=None)
def _jax_sync_quiescent(case):
    nodes, kw, length = SYNC_CASES[case]
    jcfg, _ = cfg_pair(nodes, **kw)
    return jcfg, jse.run_sync_to_quiescence(
        jcfg, jse.procedural_state(jcfg, length, seed=2), CHUNK, 4000)


@pytest.mark.parametrize("kernels", [True, False],
                         ids=["kernel-route", "plain-rounds"])
@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_sync_run_to_quiescence_matches_jax(case, kernels, monkeypatch):
    """TransactionalSystem.procedural(...).run() on a sync config: final
    state, metrics, dumps and the invariant report equal JAX's. With
    pallas_burst every round goes through the kernel wrappers (their
    plain versions on the CPU): the fused rounds', at txn_width 3 and at
    txn_width 1."""
    nodes, kw, length = SYNC_CASES[case]
    jcfg, want = _jax_sync_quiescent(case)
    _, tcfg = cfg_pair(nodes, **dict(kw, pallas_burst=kernels))
    calls = []
    for mod, name in ((smk, "plain_round"), (srk, "plain_round")):
        fn = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _fn=fn: calls.append(1) or _fn(*a))
    got = TransactionalSystem.procedural(
        tcfg, length, seed=2, device="cpu").run(max_rounds=4000,
                                                chunk=CHUNK)
    assert got.quiescent and bool(want.quiescent())
    assert_states_equal(want, got.state)
    m = got.metrics
    assert m == {f: int(getattr(want.metrics, f)) for f in m}
    assert m["rounds"] % CHUNK == 0
    assert m["instrs_retired"] == got.instrs_retired == nodes * length
    assert len(calls) == (m["rounds"] if kernels else 0)
    view = jse.to_dump_view(jcfg, want)
    assert got.dumps() == [jgolden.format_node_dump(d)
                           for d in jgolden.state_to_dumps(jcfg, view)]
    assert got.check_invariants() == jse.check_exact_directory(jcfg, want)


@pytest.mark.parametrize("txn_width", [1, 3])
def test_from_test_dir_matches_jax_dumps(txn_width):
    """The mini fixture tree at the reference dimensions (no deep
    window): the port's dumps at quiescence are the JAX system's."""
    from ue22cs343bb1_openmp_assignment_tpu.models.transactional import (
        TransactionalSystem as JaxSystem)
    mini = str(pathlib.Path(__file__).resolve().parent / "fixtures" / "mini")
    jcfg, tcfg = cfg_pair(4, reference=True, txn_width=txn_width)
    want = JaxSystem.from_test_dir(mini, jcfg, seed=3).run(chunk=4)
    got = TransactionalSystem.from_test_dir(mini, tcfg, seed=3,
                                            device="cpu").run(chunk=4)
    assert got.quiescent and want.quiescent
    assert got.dumps() == want.dumps()
    assert got.metrics == want.metrics
    assert got.check_invariants() == want.check_invariants()


def test_continue_with_streams_a_second_phase():
    """from_traces -> run -> continue_with -> run on a sync config
    equals the JAX chain of continue_with_traces."""
    from tests.test_torch_sync_round import stored_traces
    jcfg, tcfg = cfg_pair(16, drain_depth=4, txn_width=3, max_instrs=10)
    first, second = stored_traces(jcfg, 11), stored_traces(jcfg, 12)
    traces = [[(int(o), int(a), int(v)) for o, a, v in
               zip(first[0][n, :c], first[1][n, :c], first[2][n, :c])]
              for n, c in enumerate(first[3])]
    js = jse.from_sim_state(jcfg, init_state(jcfg, traces), seed=4)
    js = jse.run_sync_to_quiescence(jcfg, js, 8, 400)
    js = jse.continue_with_traces(jcfg, js, instr_arrays=second)
    js = jse.run_sync_to_quiescence(jcfg, js, 8, 400)
    sys_ = TransactionalSystem.from_traces(tcfg, traces, seed=4,
                                           device="cpu")
    sys_ = sys_.run(max_rounds=400, chunk=8)
    sys_ = sys_.continue_with(instr_arrays=second).run(max_rounds=400,
                                                       chunk=8)
    assert sys_.quiescent
    assert_states_equal(js, sys_.state)
    assert sys_.instrs_retired == int(first[3].sum() + second[3].sum())


@pytest.mark.parametrize("extra,kernels,width", [
    ((), False, 3), (("--window-kernels", "on"), True, 3),
    (("--txn-width", "1", "--window-kernels", "on"), True, 1)],
    ids=["auto", "on", "single-on"])
def test_bench_sync_engine_on_cpu(capsys, extra, kernels, width):
    """--engine sync: the JAX bench's window defaults, the kernel switch
    (auto keeps the plain rounds off the card), launch counts of every
    kernel (none on the CPU)."""
    doc = _bench_doc(capsys, "--engine", "sync", *extra)
    assert doc["engine"] == "sync" and doc["window_kernels"] is kernels
    assert doc["config"]["txn_width"] == width
    assert doc["config"]["drain_depth"] == (16 if width == 1 else 4)
    assert doc["instrs_retired"] == 16 * 8
    assert doc["launches"] == NO_LAUNCHES


def test_bench_window_options_need_the_sync_engine(capsys):
    assert bench.main(["--txn-width", "2", "--device", "cpu"]) == 2
    assert "--engine sync" in capsys.readouterr().err
    cfg = bench.sync_config(4096, window_kernels=True)
    assert (cfg.txn_width, cfg.drain_depth, cfg.pallas_burst,
            cfg.proc_local_permille) == (3, 4, True, 800)
    assert bench.sync_config(64, 1).drain_depth == 16
    assert bench.sync_config(64, 2, drain_depth=7).drain_depth == 7


@pytest.mark.parametrize("extra,transport", [
    ((), "none"), (("--shards", "4"), "rdma"),
    (("--shards", "4", "--transport", "all_to_all"), "all_to_all")],
    ids=["unrouted", "rdma", "all_to_all"])
def test_bench_async_engine_on_cpu(capsys, extra, transport):
    """--engine async runs the message-level engine to quiescence; the
    routed runs end after the same cycles (the CPU runs the ring's plain
    version: no launch)."""
    doc = _bench_doc(capsys, "--engine", "async", "--nodes", "32", *extra)
    assert doc["metric"] == "instrs_per_sec (async, uniform)"
    assert doc["workload"] == "uniform" and doc["procedural"] is False
    assert doc["instrs_retired"] == 32 * 8 and doc["msgs_dropped"] == 0
    assert doc["transport"] == transport and doc["cycles"] % 4 == 0
    assert doc["launches"] == NO_LAUNCHES
    assert doc["config"]["queue_capacity"] == 64
    assert bench.main(["--shards", "2", "--device", "cpu"]) == 2
