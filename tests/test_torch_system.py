"""The slices as a whole: the port's TransactionalSystem to quiescence
equals JAX ``run_sync_to_quiescence`` at a 64-node copy of the bench's
deep config, through the fold path and through the fused round.

Final state, every metric (``rounds`` included: both runners test
quiescence only between ``chunk``-round blocks) and the
``printProcessorState`` dumps must be equal. Exact comparison.
"""

import dataclasses
import functools
import json

import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu.utils import golden as jgolden
from ue22cs343bb1_openmp_assignment_tpu_torch import bench
from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional import (
    TransactionalSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    deep_round_kernel as drk)

from tests.torch_parity import BENCH_DEEP, assert_states_equal, cfg_pair

LENGTH, CHUNK = 32, 16


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
    assert doc["launches"] == {"pre": 0, "flags": 0, "replay": 0,
                               "round": 0}
    assert doc["fused_round"] is False      # auto: the card only


@pytest.mark.parametrize("mode,fused", [("on", True), ("off", False)])
def test_bench_fused_round_flag_on_cpu(capsys, mode, fused):
    """--fused-round on runs the round kernel's path (its plain version
    on the CPU, so no launch), off the fold path; both retire the same
    instructions in the same rounds."""
    doc = _bench_doc(capsys, "--fused-round", mode)
    assert doc["fused_round"] is fused
    assert doc["launches"] == {"pre": 0, "flags": 0, "replay": 0,
                               "round": 0}
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
