"""Built states and golden dumps of the port equal the JAX package's.

``procedural_state`` and ``from_traces`` (the port's direct build of
``from_sim_state(cfg, init_state(cfg, traces))``) must produce the same
leaves, and ``printProcessorState`` dumps of the same state must be
byte-identical through both packages' golden writers. Exact
comparisons throughout.
"""

import pathlib

import numpy as np
import pytest

from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu.state import init_state
from ue22cs343bb1_openmp_assignment_tpu.utils import golden as jgolden
from ue22cs343bb1_openmp_assignment_tpu.utils import trace as jtrace
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional import (
    TransactionalSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as tse

from tests.torch_parity import (BENCH_DEEP, assert_leaves_equal,
                                assert_states_equal, cfg_pair, jax_state)

MINI = pathlib.Path(__file__).resolve().parent / "fixtures" / "mini"
MINI_DEEP = dict(deep_window=True, drain_depth=13, txn_width=3,
                 deep_slots=3, deep_ownerval_slots=1, deep_horizon_slack=4)


def _jax_dumps(cfg, st):
    view = jse.to_dump_view(cfg, st)
    return [jgolden.format_node_dump(d)
            for d in jgolden.state_to_dumps(cfg, view)]


@pytest.mark.parametrize("num_nodes,length,seed", [
    (4, 7, 0), (64, 4096, 3), (4096, 4096, 0)])
def test_procedural_state_matches_jax(num_nodes, length, seed):
    jcfg, tcfg = cfg_pair(num_nodes, **BENCH_DEEP)
    want = jse.procedural_state(jcfg, length, seed=seed)
    got = tse.procedural_state(tcfg, length, seed=seed, device="cpu")
    assert_states_equal(want, got)


@pytest.mark.parametrize("seed", [0, 5])
def test_from_traces_matches_jax_on_mini(seed):
    jcfg, tcfg = cfg_pair(4, reference=True, **MINI_DEEP)
    traces = jtrace.load_test_dir(str(MINI), 4, jcfg.max_instrs)
    want = jse.from_sim_state(jcfg, init_state(jcfg, traces), seed)
    got = TransactionalSystem.from_test_dir(str(MINI), tcfg, seed=seed,
                                            device="cpu").state
    assert_states_equal(want, got)
    # fewer traces than nodes: the rest are empty, NOP-padded
    want = jse.from_sim_state(jcfg, init_state(jcfg, traces[:2]), seed)
    got = tse.from_traces(tcfg, traces[:2], seed=seed, device="cpu")
    assert_states_equal(want, got)


def test_golden_dumps_byte_identical_mid_run(tmp_path):
    """Dumps of one mid-run state (a few port rounds on the mini
    fixture, carried to a JAX SyncState) through both packages."""
    jcfg, tcfg = cfg_pair(4, reference=True, **MINI_DEEP)
    sys_ = TransactionalSystem.from_test_dir(str(MINI), tcfg, device="cpu")
    for _ in range(3):
        sys_ = sys_.step()
        leaves = convert.to_numpy(sys_.state)
        want = _jax_dumps(jcfg, jax_state(leaves))
        assert sys_.dumps() == want
    paths = sys_.write_dumps(str(tmp_path))
    assert [pathlib.Path(p).read_text() for p in paths] == want
    jse.check_exact_directory(jcfg, jax_state(leaves))
    assert sys_.check_invariants() == jse.check_exact_directory(
        jcfg, jax_state(leaves))


def test_dump_view_arrays_match_jax_at_scale():
    """to_sim_arrays (the sharer bitvector rebuilt from cache tags) on a
    64-node state with many cached lines."""
    jcfg, tcfg = cfg_pair(64, **BENCH_DEEP)
    st = tse.run_rounds(tcfg, tse.procedural_state(tcfg, 64, seed=1,
                                                   device="cpu"), 4)
    want = jse.to_sim_arrays(jcfg, jax_state(convert.to_numpy(st)))
    got = tse.to_sim_arrays(tcfg, st)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_convert_round_trip_and_checks():
    jcfg, tcfg = cfg_pair(16, **BENCH_DEEP)
    leaves = convert.numpy_leaves(jse.procedural_state(jcfg, 9, seed=2))
    st = convert.from_numpy(tcfg, leaves, device="cpu")
    assert_leaves_equal(leaves, convert.to_numpy(st))
    bad = dict(leaves, idx=leaves["idx"][:3])
    with pytest.raises(ValueError, match="idx"):
        convert.from_numpy(tcfg, bad, device="cpu")
    with pytest.raises(KeyError, match="metrics.rounds"):
        convert.from_numpy(tcfg, {k: v for k, v in leaves.items()
                                  if k != "metrics.rounds"}, device="cpu")


@pytest.mark.parametrize("num_nodes,kw", [
    (4096, {}), (65536, dict(deep_slots=2)),
    (64, dict(deep_waves=3, deep_slots=6)),
    (256, dict(deep_read_storm=True, deep_waves=2)),
    (16, dict(deep_window=False))])
def test_key_budget_helpers_match_jax(num_nodes, kw):
    jcfg, tcfg = cfg_pair(num_nodes, **dict(BENCH_DEEP, **kw))
    assert tse.slot_bits(tcfg) == jse.slot_bits(jcfg)
    assert tse.claim_max_rounds(tcfg) == jse.claim_max_rounds(jcfg)


def test_reset_claims_matches_jax():
    jcfg, tcfg = cfg_pair(16, **BENCH_DEEP)
    st = tse.run_rounds(tcfg, tse.procedural_state(tcfg, 64, device="cpu"),
                        2)
    want = jse.reset_claims(jax_state(convert.to_numpy(st)).dm)
    got = tse.reset_claims(st.dm)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert not np.array_equal(got.numpy(), st.dm.numpy())
