"""The port's synthetic workload generators against the JAX package's.

Every name in ``models.workloads.GENERATORS``, at 16 nodes x 64 and 33
nodes x 40 instructions, seeds 0 and 7: the four arrays equal JAX's, and
``from_workload`` on both systems (the message-level CoherenceSystem and
the transactional TransactionalSystem) gives leaves equal to JAX's. The
Zipf cdf, built on the host in XLA's float32 order, equals the cdf the
JAX package computes, at every rank count the default reaches and past
it. The port's bench on the CPU: ``--workload`` and ``--replicas``, and
what it refuses.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu.models import workloads as jw
from ue22cs343bb1_openmp_assignment_tpu.models.system import (
    CoherenceSystem as JaxSystem)
from ue22cs343bb1_openmp_assignment_tpu.models.transactional import (
    TransactionalSystem as JaxTransactional)
from ue22cs343bb1_openmp_assignment_tpu_torch import bench
from ue22cs343bb1_openmp_assignment_tpu_torch.models import workloads
from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
    CoherenceSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.models.transactional import (
    TransactionalSystem)
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import random as jr

from tests.torch_parity import (
    assert_sim_states_equal, assert_states_equal, cfg_pair)

SIZES = [(16, 64), (33, 40)]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("nodes,length", SIZES, ids=["16x64", "33x40"])
@pytest.mark.parametrize("name", sorted(workloads.GENERATORS))
def test_generator_and_systems_equal_jax(name, nodes, length, seed):
    jcfg, tcfg = cfg_pair(nodes, max_instrs=length)
    want = jw.GENERATORS[name](jax.random.PRNGKey(seed), jcfg, length)
    got = workloads.GENERATORS[name](seed, tcfg, length, device="cpu")
    # a key tensor draws the same stream as its seed
    again = workloads.GENERATORS[name](jr.prng_key(seed, "cpu"), tcfg,
                                       length)
    for i, (a, b, c) in enumerate(zip(want, got, again)):
        a = np.asarray(a)
        assert b.dtype == torch.int32 and b.shape == a.shape, (i, b.shape)
        assert np.array_equal(a, b.numpy()), (
            f"{name} array {i}: {int((a != b.numpy()).sum())} differ")
        assert torch.equal(b, c)
    assert_sim_states_equal(
        JaxSystem.from_workload(jcfg, name, seed=seed).state,
        CoherenceSystem.from_workload(tcfg, name, seed=seed,
                                      device="cpu").state)
    assert_states_equal(
        JaxTransactional.from_workload(jcfg, name, workload_seed=seed,
                                       seed=seed + 1).state,
        TransactionalSystem.from_workload(tcfg, name, workload_seed=seed,
                                          seed=seed + 1,
                                          device="cpu").state)


def jax_zipf_cdf(jcfg, exponent, hot_ranks) -> np.ndarray:
    """The JAX package's cdf expression (``workloads.py:229-233``)."""
    n_ranks = min(int(hot_ranks), jcfg.num_nodes * jcfg.mem_size)
    ranks = jnp.arange(1, n_ranks + 1, dtype=jnp.float32)
    weights = ranks ** jnp.float32(-exponent)
    return np.asarray(jnp.cumsum(weights) / jnp.sum(weights))


@pytest.mark.parametrize("nodes,exponent,hot_ranks", [
    (16, 1.2, 64), (1, 1.2, 64), (2, 1.2, 64), (3, 1.2, 64),
    (16, 0.7, 5), (16, 2.0, 100), (33, 1.5, 300)])
def test_zipf_cdf_is_the_jax_packages(nodes, exponent, hot_ranks):
    """16, 32, 48 and 64 ranks (the default's reach: min(64, N x 16)),
    fewer than a scan row and past two reduce windows: bit for bit."""
    jcfg, tcfg = cfg_pair(nodes)
    want = jax_zipf_cdf(jcfg, exponent, hot_ranks)
    got = workloads.zipf_cdf(tcfg, exponent, hot_ranks)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


def test_chip_smoke_generator_digests_are_the_jax_packages():
    """The draws chip_smoke.py holds the card to: every generator at 256
    nodes x 512 (seed 3) and uniform at 4096 nodes x 512 (seed 0), as the
    JAX package makes them."""
    import chip_smoke
    from ue22cs343bb1_openmp_assignment_tpu.config import SystemConfig
    ref = chip_smoke.RANDOM_REFERENCE
    cfg = SystemConfig.scale(num_nodes=256)
    got = {name: chip_smoke.workload_digest(
        gen(jax.random.PRNGKey(3), cfg, 512))
        for name, gen in jw.GENERATORS.items()}
    assert got == ref["generators"], got
    big = jw.uniform_random(jax.random.PRNGKey(0),
                            SystemConfig.scale(num_nodes=4096), 512)
    assert chip_smoke.workload_digest(big) == ref["uniform_4096"]
    # the port on the CPU draws the same
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import (
        SystemConfig as TorchConfig)
    assert chip_smoke.workload_digest(workloads.GENERATORS["zipf_hotspot"](
        3, TorchConfig.scale(num_nodes=256), 512, device="cpu")) == \
        ref["generators"]["zipf_hotspot"]


def _bench(capsys, *argv):
    rc = bench.main(["--nodes", "16", "--trace-len", "8", "--chunk", "4",
                     "--reps", "1", "--device", "cpu", *argv])
    out = capsys.readouterr()
    return rc, out.out.strip().splitlines(), out.err


def test_bench_replicas_and_workloads_on_cpu(capsys):
    """--replicas 2 runs an ensemble of stored-trace machines, replica r
    the workload of seed r under arbitration seed r, to quiescence;
    another workload than uniform runs as stored traces; the uniform
    workload alone stays procedural."""
    rc, lines, err = _bench(capsys, "--engine", "sync", "--replicas", "2")
    assert rc == 0 and len(lines) == 1
    doc = json.loads(lines[0])
    assert (doc["replicas"], doc["workload"], doc["procedural"]) == (
        2, "uniform", False)
    assert doc["instrs_retired"] == 2 * 16 * 8
    assert "stored traces" in err
    # replica 1 as the JAX bench builds it (bench.py:663-672)
    from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
    jcfg, tcfg = cfg_pair(16, drain_depth=4, txn_width=3, max_instrs=8)
    want = jse.from_sim_state(jcfg, JaxSystem.from_workload(
        jcfg, "uniform", trace_len=8, seed=1, local_frac=0.8).state, seed=1)
    assert_states_equal(want, TransactionalSystem.from_workload(
        tcfg, "uniform", 8, workload_seed=1, seed=1, device="cpu",
        **bench.gen_kwargs("uniform", 0.8)).state)
    rc, lines, err = _bench(capsys, "--engine", "deep", "--workload",
                            "hotspot")
    doc = json.loads(lines[0])
    assert rc == 0 and doc["procedural"] is False
    assert doc["workload"] == "hotspot" and doc["instrs_retired"] == 16 * 8
    rc, lines, err = _bench(capsys, "--engine", "sync")
    doc = json.loads(lines[0])
    assert rc == 0 and doc["procedural"] is True and not err


@pytest.mark.parametrize("argv,why", [
    (("--replicas", "2"), "--engine sync"),
    (("--engine", "async", "--replicas", "2"), "--engine sync"),
    (("--engine", "sync", "--replicas", "0"), "at least 1")],
    ids=["deep", "async", "zero"])
def test_bench_refuses_replicas_off_the_sync_engine(capsys, argv, why):
    rc, lines, err = _bench(capsys, *argv)
    assert rc == 2 and not lines and why in err


def test_bench_refuses_an_unknown_workload(capsys):
    with pytest.raises(SystemExit):
        bench.main(["--workload", "nope", "--device", "cpu"])
    assert "invalid choice" in capsys.readouterr().err
