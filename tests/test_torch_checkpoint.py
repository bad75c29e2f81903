"""Checkpoints in the JAX package's format, across the two packages.

A checkpoint the JAX package saves loads in the port with equal leaves
(the message-level SimState mid-run with fault injection on, a stored-
trace sync machine, a deep-window machine, an ensemble), one the port
saves loads in the JAX package, and both packages continue from it to
equal states. A version 3 checkpoint (slot-major mailbox ring, without
the fields added since) migrates on load. Resuming in the port gives the
uninterrupted run's state. Wrong kinds, missing keys and unknown
versions are refused.
"""

import json

import numpy as np
import pytest

from ue22cs343bb1_openmp_assignment_tpu.models.system import (
    CoherenceSystem as JaxSystem)
from ue22cs343bb1_openmp_assignment_tpu.models.transactional import (
    TransactionalSystem as JaxTransactional)
from ue22cs343bb1_openmp_assignment_tpu.utils import checkpoint as jck
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
    CoherenceSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional import (
    TransactionalSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import checkpoint

from tests.torch_parity import (
    BENCH_DEEP, assert_leaves_equal, assert_sim_states_equal,
    assert_states_equal, cfg_pair)


def _sim_pair(cycles: int = 12):
    jcfg, tcfg = cfg_pair(16, max_instrs=16, drop_prob=0.05)
    j = JaxSystem.from_workload(jcfg, "uniform", seed=3).run_cycles(cycles)
    t = CoherenceSystem.from_workload(tcfg, "uniform", seed=3,
                                      device="cpu").run_cycles(cycles)
    assert_sim_states_equal(j.state, t.state)
    return j, t


def _sync_pair(rounds: int = 3):
    jcfg, tcfg = cfg_pair(16, max_instrs=16, drain_depth=4, txn_width=3)
    j = JaxTransactional.from_workload(jcfg, "hotspot", workload_seed=2,
                                       seed=5).run_rounds(rounds)
    t = TransactionalSystem.from_workload(tcfg, "hotspot", workload_seed=2,
                                          seed=5,
                                          device="cpu").run_rounds(rounds)
    assert_states_equal(j.state, t.state)
    return j, t


def test_sim_checkpoints_cross_both_ways_and_continue(tmp_path):
    j, t = _sim_pair()
    j.save(str(tmp_path / "jax.npz"), meta={"note": "mid-run"})
    got = CoherenceSystem.load(str(tmp_path / "jax.npz"), device="cpu")
    assert got.cfg == t.cfg
    assert_sim_states_equal(j.state, got.state)
    t.save(str(tmp_path / "port.npz"))
    back = JaxSystem.load(str(tmp_path / "port.npz"))
    assert_sim_states_equal(back.state, t.state)
    with np.load(tmp_path / "port.npz") as z, \
            np.load(tmp_path / "jax.npz") as w:
        assert z.files == [k for k in w.files]
        for k in z.files:
            assert z[k].dtype == w[k].dtype, k
        assert z["fault_key"].dtype == np.uint32
        assert z["waiting"].dtype == np.bool_
    # both continue, fault draws included, to equal states
    assert_sim_states_equal(back.run_cycles(12).state,
                            got.run_cycles(12).state)
    assert checkpoint.checkpoint_bytes(t.state) == \
        jck.checkpoint_bytes(j.state)
    _, _, meta = checkpoint.load_checkpoint(str(tmp_path / "jax.npz"),
                                            device="cpu")
    assert meta == {"note": "mid-run", "kind": "sim", "format_version": 4}


def test_sync_checkpoints_cross_both_ways_and_continue(tmp_path):
    j, t = _sync_pair()
    j.save(str(tmp_path / "jax.npz"))
    got = TransactionalSystem.load(str(tmp_path / "jax.npz"), device="cpu")
    assert_states_equal(j.state, got.state)
    assert got.state.metrics.buffer().shape == (11,)
    t.save(str(tmp_path / "port.npz"))
    back = JaxTransactional.load(str(tmp_path / "port.npz"))
    assert_states_equal(back.state, t.state)
    assert_states_equal(back.run_rounds(3).state,
                        got.run_rounds(3).state)
    assert checkpoint.checkpoint_bytes(t.state) == \
        jck.checkpoint_bytes(j.state)


def test_deep_and_ensemble_checkpoints_cross_both_ways(tmp_path):
    """A deep-window machine a few rounds in, and an ensemble of two
    sync machines (leading R axis, counters [R, 11]): port -> JAX -> port
    with every leaf equal."""
    _, tcfg = cfg_pair(32, **BENCH_DEEP)
    deep = TransactionalSystem.procedural(tcfg, 24, seed=2, device="cpu")
    deep = deep.run_rounds(4)
    _, t = _sync_pair()
    ens = se.make_ensemble([t.state, t.run_rounds(2).state])
    for name, cfg, state in (("deep", tcfg, deep.state),
                             ("ensemble", t.cfg, ens)):
        checkpoint.save_checkpoint(str(tmp_path / f"{name}.npz"), cfg, state)
        jcfg, jstate, meta = jck.load_checkpoint(str(tmp_path /
                                                     f"{name}.npz"))
        assert meta["kind"] == "sync"
        assert_states_equal(jstate, state)
        jck.save_checkpoint(str(tmp_path / f"{name}-jax.npz"), jcfg, jstate)
        cfg2, again, _ = checkpoint.load_checkpoint(
            str(tmp_path / f"{name}-jax.npz"), device="cpu")
        assert cfg2 == cfg
        assert_states_equal(jstate, again)
        assert checkpoint.checkpoint_bytes(again) == \
            jck.checkpoint_bytes(jstate)
    assert again.metrics.buffer().shape == (2, 11)
    # the ensemble resumes: replica 1 runs on as its solo machine does
    solo = se.run_rounds(t.cfg, se.ensemble_replica(again, 1), 3)
    ens3 = again
    for _ in range(3):
        ens3 = se.ensemble_round_step(t.cfg, ens3)
    assert_states_equal(solo, se.ensemble_replica(ens3, 1))


def _rewrite(path, out, edit_arrays=None, edit_meta=None):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    if edit_meta:
        meta = edit_meta(meta)
    if edit_arrays:
        edit_arrays(arrays)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    with open(out, "wb") as f:
        np.savez(f, **arrays)


def test_version_3_checkpoint_migrates(tmp_path):
    """Format 3 held the mailbox slot-major ([N, Q, P]) and predates
    order_rank, lat_hist and mb_depth_peak (sim) and horizon (sync): the
    port loads it as the JAX package does, with the neutral values."""
    j, _ = _sim_pair()
    j.save(str(tmp_path / "v4.npz"))

    def to_v3(a):
        a["mb_pack"] = np.moveaxis(a["mb_pack"], 0, -1)
        for k in ("order_rank", "metrics.lat_hist", "metrics.mb_depth_peak"):
            del a[k]

    _rewrite(tmp_path / "v4.npz", tmp_path / "v3.npz", to_v3,
             lambda m: dict(m, format_version=3))
    got = CoherenceSystem.load(str(tmp_path / "v3.npz"), device="cpu")
    want = JaxSystem.load(str(tmp_path / "v3.npz"))
    assert_sim_states_equal(want.state, got.state)
    assert tuple(got.state.order_rank.shape) == (16, 0)
    assert int(got.state.metrics.lat_hist.sum()) == 0
    assert np.array_equal(got.state.mb_pack.numpy(),
                          np.asarray(j.state.mb_pack))
    js, _ = _sync_pair()
    js.save(str(tmp_path / "s4.npz"))
    _rewrite(tmp_path / "s4.npz", tmp_path / "s3.npz",
             lambda a: a.pop("horizon"),
             lambda m: dict(m, format_version=3))
    got = TransactionalSystem.load(str(tmp_path / "s3.npz"), device="cpu")
    assert_states_equal(JaxTransactional.load(str(tmp_path /
                                                  "s3.npz")).state,
                        got.state)
    assert bool((got.state.horizon == 1 << 20).all())


@pytest.mark.parametrize("engine", ["sim", "sync"])
def test_resume_equals_the_uninterrupted_run(tmp_path, engine):
    if engine == "sim":
        _, tcfg = cfg_pair(16, max_instrs=12, drop_prob=0.05)
        sys0 = CoherenceSystem.from_workload(tcfg, "radix", seed=4,
                                             device="cpu")
        whole = sys0.run(max_cycles=120)
        half = sys0.run_cycles(37)
        half.save(str(tmp_path / "half.npz"))
        resumed = CoherenceSystem.load(str(tmp_path / "half.npz"),
                                       device="cpu").run(max_cycles=120)
        assert resumed.dumps() == whole.dumps()
        assert_sim_states_equal(whole.state, resumed.state)
    else:
        _, tcfg = cfg_pair(16, max_instrs=12, drain_depth=4, txn_width=1)
        sys0 = TransactionalSystem.from_workload(tcfg, "lu", device="cpu")
        whole = sys0.run(chunk=1)
        half = sys0.run_rounds(5)
        half.save(str(tmp_path / "half.npz"))
        resumed = TransactionalSystem.load(str(tmp_path / "half.npz"),
                                           device="cpu").run(chunk=1)
        assert resumed.quiescent and resumed.dumps() == whole.dumps()
        assert_leaves_equal(convert.to_numpy(whole.state),
                            convert.to_numpy(resumed.state))


def test_refusals(tmp_path):
    _, tcfg = cfg_pair(8, max_instrs=4)
    CoherenceSystem.from_workload(tcfg, device="cpu").save(
        str(tmp_path / "sim.npz"))
    TransactionalSystem.from_workload(tcfg, device="cpu").save(
        str(tmp_path / "sync.npz"))
    with pytest.raises(ValueError, match="TransactionalSystem.load"):
        CoherenceSystem.load(str(tmp_path / "sync.npz"), device="cpu")
    with pytest.raises(ValueError, match="CoherenceSystem.load"):
        TransactionalSystem.load(str(tmp_path / "sim.npz"), device="cpu")
    _rewrite(tmp_path / "sim.npz", tmp_path / "v5.npz",
             edit_meta=lambda m: dict(m, format_version=5))
    with pytest.raises(ValueError, match="format 5"):
        checkpoint.load_checkpoint(str(tmp_path / "v5.npz"), device="cpu")
    _rewrite(tmp_path / "sim.npz", tmp_path / "short.npz",
             edit_arrays=lambda a: a.pop("mb_head"))
    with pytest.raises(ValueError, match="checkpoint fields"):
        checkpoint.load_checkpoint(str(tmp_path / "short.npz"),
                                   device="cpu")
    with np.load(tmp_path / "sim.npz") as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    np.savez(tmp_path / "bare.npz", **arrays)
    with pytest.raises(ValueError, match="__meta__"):
        checkpoint.load_checkpoint(str(tmp_path / "bare.npz"), device="cpu")
