"""The port's copy of the C++ oracle against the JAX package's.

Both copies of ``native/engine.cpp`` are built with g++ (each into its
own package's ``native/build/``) and run side by side: on
tests/fixtures/mini (with and without schedule knobs) and on two
generated workloads drawn by each package's generators, the final
``export_state()`` and ``metrics()`` are equal. On mini the port's
oracle agrees with the port's async engine on every core counter and
the cycle count, as the JAX package's oracle does with its engine. The
tests skip without g++.
"""

import os
import pathlib
import shutil

import jax
import numpy as np
import pytest

from ue22cs343bb1_openmp_assignment_tpu.config import (
    SystemConfig as JaxConfig)
from ue22cs343bb1_openmp_assignment_tpu.models import (
    workloads as jworkloads)
from ue22cs343bb1_openmp_assignment_tpu.native import bindings as jbindings
from ue22cs343bb1_openmp_assignment_tpu_torch import cli
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.models import workloads
from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
    CoherenceSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.native import bindings
from ue22cs343bb1_openmp_assignment_tpu_torch.obs import schema
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import trace

MINI = str(pathlib.Path(__file__).resolve().parent / "fixtures" / "mini")
PORT_NATIVE = pathlib.Path(bindings.__file__).resolve().parent


@pytest.fixture
def gxx():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("g++ is not installed: the native oracle cannot build")


def _engines(case):
    """(JAX engine, port engine), loaded with the same instructions."""
    if case.startswith("mini"):
        jcfg, cfg = JaxConfig.reference(), SystemConfig.reference()
        traces = trace.load_test_dir(MINI)
        loaded = []
        for mod, c in ((jbindings, jcfg), (bindings, cfg)):
            eng = mod.NativeEngine(c)
            eng.load_traces(traces)
            if case == "mini-knobs":
                eng.set_schedule([1, 0, 2, 0], [1, 2, 1, 1])
                eng.set_arbitration(cli._arb_rank(5, 4))
            loaded.append(eng)
        return loaded
    name = case
    kw = dict(num_nodes=16, max_instrs=16, queue_capacity=256)
    jcfg, cfg = JaxConfig.scale(**kw), SystemConfig.scale(**kw)
    want = [np.asarray(a) for a in jworkloads.GENERATORS[name](
        jax.random.PRNGKey(7), jcfg, 16)]
    got = [a.numpy() for a in workloads.GENERATORS[name](
        7, cfg, 16, device="cpu")]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    j, t = jbindings.NativeEngine(jcfg), bindings.NativeEngine(cfg)
    j.load_instr_arrays(*want)
    t.load_instr_arrays(*got)
    return j, t


@pytest.mark.parametrize("case", ["mini", "mini-knobs", "uniform",
                                  "hotspot"])
def test_native_equals_the_jax_oracle(case, gxx):
    j, t = _engines(case)
    assert t.run(50_000) == j.run(50_000)
    assert t.quiescent and j.quiescent
    want, got = j.export_state(), t.export_state()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert t.metrics() == j.metrics()


def test_native_builds_into_the_port_and_matches_its_async_engine(gxx):
    path = pathlib.Path(bindings._lib_path())
    assert path.parent == PORT_NATIVE / "build"
    bindings.load_library()
    assert path.exists()
    cfg = SystemConfig.reference()
    eng = bindings.NativeEngine(cfg)
    eng.load_traces(trace.load_test_dir(MINI))
    eng.run(100_000)
    native = schema.validate(schema.from_native(eng.metrics()))
    system = CoherenceSystem.from_test_dir(MINI, cfg, device="cpu").run(
        chunk=1)
    tensor = schema.validate(schema.from_async(system.metrics))
    for k in schema.CORE_COUNTERS + ("steps",):
        assert native[k] == tensor[k], k
    assert native["mb_dropped"] == tensor["mb_dropped"] == 0
