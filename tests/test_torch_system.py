"""The slice as a whole: the port's TransactionalSystem to quiescence
equals JAX ``run_sync_to_quiescence`` at a 64-node copy of the bench's
deep config.

Final state, every metric (``rounds`` included: both runners test
quiescence only between ``chunk``-round blocks) and the
``printProcessorState`` dumps must be equal. Exact comparison.
"""

from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu.utils import golden as jgolden
from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional import (
    TransactionalSystem)

from tests.torch_parity import BENCH_DEEP, assert_states_equal, cfg_pair

LENGTH, CHUNK = 32, 16


def test_run_to_quiescence_matches_jax():
    jcfg, tcfg = cfg_pair(64, **BENCH_DEEP)
    want = jse.run_sync_to_quiescence(
        jcfg, jse.procedural_state(jcfg, LENGTH, seed=2), CHUNK, 2000)
    sys_ = TransactionalSystem.procedural(tcfg, LENGTH, seed=2,
                                          device="cpu")
    got = sys_.run(max_rounds=2000, chunk=CHUNK)
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


def test_run_rounds_and_step_agree():
    _, tcfg = cfg_pair(16, **BENCH_DEEP)
    a = TransactionalSystem.procedural(tcfg, 64, device="cpu")
    b = a.run_rounds(3)
    c = a.step().step().step()
    assert b.metrics == c.metrics and b.metrics["rounds"] == 3
    assert b.dumps() == c.dumps()


def test_bench_prints_one_json_line_on_cpu(capsys):
    import json

    from ue22cs343bb1_openmp_assignment_tpu_torch import bench
    rc = bench.main(["--nodes", "16", "--trace-len", "8", "--chunk", "4",
                     "--reps", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    doc = json.loads(lines[0])
    assert doc["instrs_retired"] == 16 * 8 and doc["card"] == "cpu"
    assert doc["rounds"] % 4 == 0
    assert doc["launches"] == {"pre": 0, "flags": 0, "replay": 0}
