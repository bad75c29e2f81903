"""Fault injection in the port's message-level engine against the JAX
package's.

With ``cfg.drop_prob > 0`` every cycle's delivery splits
``state.fault_key``, drops each otherwise-accepted message on a
Bernoulli draw of the threefry twin of jax.random and re-ranks the
survivors. At 16 nodes, drop_prob 0.05 and 0.25, stepped cycle by cycle
from the ``uniform`` workload: every leaf equal to JAX's after every
cycle (``fault_key`` and ``msgs_injected_dropped`` included), the final
dumps byte-identical. The runner to a cycle cap (dropped messages strand
requesters, so these runs never quiesce) and the stall watchdog agree
with JAX's too, and the fault-injected run whose final state
``chip_smoke.py`` holds the card to is the JAX package's.
"""

import functools
import hashlib

import jax
import numpy as np
import pytest

from ue22cs343bb1_openmp_assignment_tpu.models.system import (
    CoherenceSystem as JaxSystem)
from ue22cs343bb1_openmp_assignment_tpu.ops import failures as jfail
from ue22cs343bb1_openmp_assignment_tpu.ops import step as jstep
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
    CoherenceSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step

from tests.torch_parity import assert_sim_states_equal, cfg_pair


@functools.lru_cache(maxsize=None)
def _jax_cycle():
    return jax.jit(jstep.cycle, static_argnums=0)


def _systems(drop_prob: float, nodes: int = 16, length: int = 16,
             seed: int = 3):
    jcfg, tcfg = cfg_pair(nodes, max_instrs=length, drop_prob=drop_prob)
    return (jcfg, JaxSystem.from_workload(jcfg, "uniform", seed=seed),
            CoherenceSystem.from_workload(tcfg, "uniform", seed=seed,
                                          device="cpu"))


@pytest.mark.parametrize("drop_prob", [0.05, 0.25])
def test_fault_injected_cycles_equal_jax(drop_prob):
    jcfg, jsys, tsys = _systems(drop_prob)
    js, ts = jsys.state, tsys.state
    keys = set()
    for n in range(96):
        js = _jax_cycle()(jcfg, js)
        ts = step.cycle(tsys.cfg, ts)
        assert_sim_states_equal(js, ts, f"drop_prob {drop_prob}, cycle "
                                        f"{n + 1}: ")
        keys.add(tuple(ts.fault_key.tolist()))
    assert len(keys) == 96                      # a new key every cycle
    assert int(ts.metrics.msgs_injected_dropped) > 0
    got = CoherenceSystem(tsys.cfg, ts)
    assert got.dumps() == JaxSystem(jcfg, js).dumps()


def test_fault_injected_runner_and_watchdog_equal_jax():
    """To a cap of 300 cycles (no quiescence: drops strand requesters),
    the chunked runner ends in JAX's state, and the stall watchdog names
    the same stranded nodes."""
    jcfg, jsys, tsys = _systems(0.05, nodes=32)
    want = jsys.run(max_cycles=300)
    got = tsys.run(max_cycles=300, chunk=20)
    assert not got.quiescent and got.metrics["cycles"] == 300
    assert_sim_states_equal(want.state, got.state)
    report = got.stall_report(40)
    assert report == jfail.stall_report(jcfg, want.state, 40)
    assert report["count"] > 0


def test_chip_smoke_fault_reference_is_the_jax_run():
    """chip_smoke.py holds the card's fault-injected run (64 nodes,
    drop_prob 0.05, uniform seed 0, to a cap of 1024 cycles) to numbers
    recorded from the JAX package; recompute them with JAX on the CPU."""
    import chip_smoke
    ref = chip_smoke.RANDOM_REFERENCE["faults"]
    jcfg, _ = cfg_pair(64, drop_prob=0.05)
    done = JaxSystem.from_workload(jcfg, "uniform", seed=0).run(
        max_cycles=ref["cycles"])
    m = done.metrics
    got = {"cycles": m["cycles"], "instrs_retired": m["instrs_retired"],
           "msgs_injected_dropped": m["msgs_injected_dropped"],
           "digest": convert.leaves_digest(
               convert.sim_numpy_leaves(done.state)),
           "dumps": hashlib.sha256("".join(done.dumps()).encode())
           .hexdigest()}
    assert got == ref, got
    assert np.asarray(done.state.fault_key).dtype == np.uint32
