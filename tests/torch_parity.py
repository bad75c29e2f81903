"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Both sides run on the CPU. Configs are built twice from one set of
keyword arguments (the JAX package's SystemConfig and the port's copy),
states cross as flat dicts of numpy arrays (``convert.numpy_leaves``),
and every comparison is exact: the engines are int32 throughout.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from ue22cs343bb1_openmp_assignment_tpu.config import (
    SystemConfig as JaxConfig)
from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.config import (
    SystemConfig as TorchConfig)

# One torch thread a test process. pytest-xdist runs several workers on
# the host's cores, and torch's default of one intra-op thread a core in
# each of them oversubscribes the host; the engines' integer ops on these
# small machines gain nothing from more threads, and their results do not
# depend on the count.
torch.set_num_threads(1)

#: bench.py's deep-engine defaults (bench.py:557-584): drain_depth 13,
#: txn_width 3 (W = 16), deep_slots 3, G 1, slack 4, one wave, exact
#: flags on, procedural uniform at locality 0.8
BENCH_DEEP = dict(drain_depth=13, txn_width=3, deep_window=True,
                  deep_slots=3, deep_ownerval_slots=1,
                  deep_horizon_slack=4, procedural="uniform",
                  max_instrs=1, proc_local_permille=800)


def cfg_pair(num_nodes: int, reference: bool = False, **kw):
    """(JAX config, port config) with the same fields: the scale
    config at ``num_nodes``, or the reference dimensions."""
    def make(cls):
        if reference:
            return cls.reference(**kw)
        base = cls.scale(num_nodes=num_nodes)
        return dataclasses.replace(base, **kw)
    return make(JaxConfig), make(TorchConfig)


def jax_state(leaves: dict) -> jse.SyncState:
    """A JAX SyncState from a flat dict of numpy leaves."""
    metrics = jse.SyncMetrics(**{
        k.split(".", 1)[1]: jnp.asarray(v, jnp.int32)
        for k, v in leaves.items() if k.startswith("metrics.")})
    return jse.SyncState(
        **{k: jnp.asarray(v, jnp.int32) for k, v in leaves.items()
           if not k.startswith("metrics.")},
        metrics=metrics)


def assert_leaves_equal(want: dict, got: dict, where: str = "") -> None:
    """Every leaf equal; a failure names the first diverging leaf and
    its first diverging index."""
    assert sorted(want) == sorted(got), (sorted(want), sorted(got))
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape, f"{where}{k}: shape {a.shape} vs {b.shape}"
        if not np.array_equal(a, b):
            idx = tuple(np.argwhere(a != b)[0]) if a.ndim else ()
            raise AssertionError(
                f"{where}{k} diverges at {idx}: jax {a[idx]} vs port "
                f"{b[idx]} ({int(np.sum(a != b))} elements differ)")


def assert_states_equal(jax_st, port_st, where: str = "") -> None:
    assert_leaves_equal(convert.numpy_leaves(jax_st),
                        convert.to_numpy(port_st), where)


def jax_sim_state(leaves: dict):
    """A JAX SimState from a flat dict of numpy leaves in the JAX
    package's dtypes (``convert.sim_numpy_leaves``)."""
    from ue22cs343bb1_openmp_assignment_tpu.state import Metrics, SimState
    metrics = Metrics(**{
        k.split(".", 1)[1]: jnp.asarray(v)
        for k, v in leaves.items() if k.startswith("metrics.")})
    return SimState(**{k: jnp.asarray(v) for k, v in leaves.items()
                       if not k.startswith("metrics.")}, metrics=metrics)


def assert_sim_states_equal(jax_st, port_st, where: str = "") -> None:
    """Every SimState leaf and metric equal, dtypes included."""
    want = convert.sim_numpy_leaves(jax_st)
    got = convert.sim_numpy_leaves(port_st)
    for k in want:
        assert want[k].dtype == got[k].dtype, (
            f"{where}{k}: dtype {want[k].dtype} vs {got[k].dtype}")
    assert_leaves_equal(want, got, where)


def as_numpy(x):
    """A JAX array, a torch tensor or a Python scalar as numpy; uint32
    words compare as their int32 bit patterns."""
    if hasattr(x, "detach"):
        a = x.detach().cpu().numpy()
    else:
        a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def assert_trees_equal(want, got, where: str = "") -> None:
    """Nested dicts / tuples / lists of arrays (JAX on one side, torch on
    the other) equal leaf by leaf; None matches None."""
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), (where, sorted(want), sorted(got))
        for k in want:
            assert_trees_equal(want[k], got[k], f"{where}{k}.")
    elif isinstance(want, (tuple, list)):
        assert len(want) == len(got), (where, len(want), len(got))
        for i, (a, b) in enumerate(zip(want, got)):
            assert_trees_equal(a, b, f"{where}{i}.")
    elif want is None:
        assert got is None, where
    else:
        a, b = as_numpy(want), as_numpy(got)
        assert a.shape == b.shape, f"{where}: shape {a.shape} vs {b.shape}"
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), (
            f"{where}: {int(np.sum(a != b))} elements differ")
