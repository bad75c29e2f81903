"""The port's seed ensembles equal the JAX package's, and their solo runs.

An ensemble of R = 3 machines that differ in their arbitration seed runs
to quiescence in both packages (``run_ensemble_to_quiescence``): every
leaf and counter of the port's [R, ...] final state must equal JAX's.
Each replica must also equal the port's solo run of that machine to
quiescence, driven on for the rounds the ensemble ran past it (a
quiescent machine is a fixpoint whose round counters advance), every
leaf equal. The cases cover txn_width 1 and 3 on procedural and on
stored traces, and a deep-window config on the fused round and on the
fold path. On the port's side the procedural configs take the fused
round kernels' replica axis (``cfg.pallas_burst``), whose wrappers run
their plain version on the CPU; on JAX's side no Pallas kernel is
reached (``pallas_burst`` and ``fused_round`` off, the XLA rounds, which
the kernels equal). The seed sweep (``utils.search``) is held to JAX's on
``tests/fixtures/mini``, with the accepted runs made from JAX's replica
dumps of two seeds. Every comparison is exact (int32, tolerance 0).
"""

import dataclasses
import pathlib

import numpy as np
import pytest

from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu.state import init_state as jinit
from ue22cs343bb1_openmp_assignment_tpu.utils import search as jsearch
from ue22cs343bb1_openmp_assignment_tpu.utils import trace as jtrace
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional import (
    TransactionalSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import deep_round_kernel
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as tse
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_multi_round_kernel as smk)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
    sync_round_kernel as srk)
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
    init_state as tinit)
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import search

from tests.torch_parity import (BENCH_DEEP, assert_leaves_equal, cfg_pair)
from tests.test_torch_sync_round import stored_traces

MINI = pathlib.Path(__file__).resolve().parent / "fixtures" / "mini"
PROC = dict(procedural="uniform", max_instrs=1, pallas_burst=True)
#: the bench's deep config with a shorter window (drain_depth 5: W = 8)
DEEP = dict(BENCH_DEEP, drain_depth=5, proc_local_permille=500)
SEEDS = (0, 1, 2)
CHUNK = 4

CASES = {
    # name: (nodes, config overrides, procedural trace length)
    "k1-procedural": (16, dict(PROC, drain_depth=4,
                               proc_local_permille=500), 32),
    "k3-procedural": (16, dict(PROC, drain_depth=2, txn_width=3,
                               proc_local_permille=500), 32),
    "k1-stored": (16, dict(drain_depth=4, max_instrs=16), None),
    "k3-stored": (16, dict(drain_depth=2, txn_width=3, max_instrs=16),
                  None),
    "deep-fused": (16, dict(DEEP, fused_round=True), 16),
    "deep-fold": (16, DEEP, 16),
}


def _machines(case):
    """(JAX config, port config, [JAX states], [port states]): one
    machine per seed of SEEDS."""
    nodes, kw, length = CASES[case]
    jcfg, tcfg = cfg_pair(nodes, **kw)
    # JAX without its Pallas kernels (the port's kernels equal them)
    jcfg = dataclasses.replace(jcfg, pallas_burst=False, fused_round=False)
    if length is not None:
        return (jcfg, tcfg,
                [jse.procedural_state(jcfg, length, seed=s) for s in SEEDS],
                [tse.procedural_state(tcfg, length, seed=s, device="cpu")
                 for s in SEEDS])
    arrays = stored_traces(jcfg, 3)
    jsim = jinit(jcfg, instr_arrays=arrays)
    tsim = tinit(tcfg, instr_arrays=arrays, device="cpu")
    return (jcfg, tcfg, [jse.from_sim_state(jcfg, jsim, seed=s)
                         for s in SEEDS],
            [tse.from_sim_state(tcfg, tsim, seed=s) for s in SEEDS])


@pytest.mark.parametrize("case", list(CASES))
def test_ensemble_matches_jax_and_solo_runs(case, monkeypatch):
    jcfg, tcfg, jstates, tstates = _machines(case)
    # the procedural sync cases take one replica-axis call a round
    calls = []
    for mod in (srk, smk):
        plain = mod.plain_round
        monkeypatch.setattr(mod, "plain_round", lambda *a, plain=plain: (
            calls.append(a[7].shape), plain(*a))[1])
    jens = jse.run_ensemble_to_quiescence(
        jcfg, jse.make_ensemble(jstates), CHUNK, 5000)
    tens = tse.run_ensemble_to_quiescence(
        tcfg, tse.make_ensemble(tstates), CHUNK, 5000)
    assert_leaves_equal(convert.numpy_leaves(jens), convert.to_numpy(tens),
                        f"{case} ensemble: ")
    rounds = int(tens.round[0])
    assert bool(tens.quiescent()) and rounds % CHUNK == 0
    assert [int(s) for s in tens.seed] == list(SEEDS)
    fused = tse._ensemble_kernel(tcfg) is not None
    assert fused == (case in ("k1-procedural", "k3-procedural"))
    assert calls.count((len(SEEDS),)) == (rounds if fused else 0)
    if tcfg.fused_round:
        assert deep_round_kernel.supported(tcfg)
    for r, solo in enumerate(tstates):
        monkeypatch.undo()
        solo = tse.run_sync_to_quiescence(tcfg, solo, CHUNK, 5000)
        extra = rounds - int(solo.round)
        assert extra >= 0 and extra % CHUNK == 0
        solo = tse.run_rounds(tcfg, solo, extra)
        assert_leaves_equal(convert.to_numpy(solo),
                            convert.to_numpy(tse.ensemble_replica(tens, r)),
                            f"{case} replica {r} against its solo run: ")
    assert int(tens.metrics.instrs_retired.sum()) > 0


def test_ensemble_replica_round_trip():
    """make_ensemble then ensemble_replica gives each state back, every
    leaf; the counters are one [R, 11] buffer."""
    _, tcfg, _, tstates = _machines("k3-stored")
    ens = tse.make_ensemble(tstates)
    assert ens.metrics.buffer().shape == (3, len(tse.METRIC_FIELDS))
    assert ens.cache_addr.shape == (3, 16, tcfg.cache_size)
    assert ens.round.shape == (3,) and ens.metrics.rounds.shape == (3,)
    for r, st in enumerate(tstates):
        assert_leaves_equal(convert.to_numpy(st),
                            convert.to_numpy(tse.ensemble_replica(ens, r)))


def test_transactional_system_ensemble():
    """``TransactionalSystem.ensemble`` stacks the machine under each
    seed: a leading axis of 3, the seeds in order."""
    _, tcfg = cfg_pair(16, **CASES["k1-procedural"][1])
    sys_ = TransactionalSystem.procedural(tcfg, 8, device="cpu")
    one = sys_.step()
    assert int(one.state.round) == 1
    ens = sys_.ensemble([0, 1, 2])
    assert ens.cache_addr.shape[0] == 3
    assert [int(s) for s in ens.seed] == [0, 1, 2]
    assert ens.dm.shape == (3,) + tuple(sys_.state.dm.shape)


def test_from_sim_state_matches_jax():
    """The transactional state adopted from the pre-run SimState of the
    mini fixture equals JAX's, every leaf."""
    jcfg, tcfg = cfg_pair(4, reference=True)
    traces = jtrace.load_test_dir(str(MINI), 4, jcfg.max_instrs)
    want = jse.from_sim_state(jcfg, jinit(jcfg, traces), seed=5)
    got = tse.from_sim_state(tcfg, tinit(tcfg, traces, device="cpu"),
                             seed=5)
    assert_leaves_equal(convert.numpy_leaves(want), convert.to_numpy(got))


def test_seed_sweep_matches_jax(tmp_path):
    """``match_accepted`` over seeds 0..7 on the mini fixture gives JAX's
    map, with the accepted runs made from JAX's replica dumps of seeds 0
    and 5; ``load_accepted_named`` reads a run_* tree as JAX does."""
    jcfg, tcfg = cfg_pair(4, reference=True)
    traces = jtrace.load_test_dir(str(MINI), 4, jcfg.max_instrs)
    jsim, tsim = jinit(jcfg, traces), tinit(tcfg, traces, device="cpu")
    jens = jsearch.sweep_seeds(jcfg, jsim, [0, 5])
    accepted = [jsearch.replica_dumps(jcfg, jens, r) for r in range(2)]
    tens = search.sweep_seeds(tcfg, tsim, [0, 5])
    assert [search.replica_dumps(tcfg, tens, r) for r in range(2)] == (
        accepted)
    want = jsearch.match_accepted(jcfg, jsim, accepted, seeds=range(8))
    got = search.match_accepted(tcfg, tsim, accepted, seeds=range(8))
    assert got == want and got[0] == 0 and got[5] in (0, 1)
    for i, dumps in enumerate(accepted):
        run = tmp_path / f"run_{i + 1}"
        run.mkdir()
        for n, text in enumerate(dumps):
            (run / f"core_{n}_output.txt").write_text(text)
    assert search.load_accepted_named(str(tmp_path)) == (
        jsearch.load_accepted_named(str(tmp_path)))
    assert search.load_accepted(str(tmp_path)) == accepted
    assert np.all([len(d) == 4 for d in accepted])
