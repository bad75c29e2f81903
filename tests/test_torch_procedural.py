"""The port's uint32 hashes equal the JAX package's bit for bit.

Torch has no usable uint32 arithmetic, so the port computes the
procedural instruction stream and the per-round arbitration keys in
int64 with explicit 32-bit masks (procedural.mulmod32/mix32). Inputs are
made from a seed with numpy; comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu import procedural as jproc
from ue22cs343bb1_openmp_assignment_tpu.ops import sync_engine as jse
from ue22cs343bb1_openmp_assignment_tpu_torch import procedural as tproc
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as tse

from tests.torch_parity import cfg_pair


def _grid(seed):
    """(node, idx) grid at N=4096 with idx up to 2^20: every node
    against 64 random indices plus the extremes."""
    rng = np.random.default_rng(seed)
    nodes = np.arange(4096, dtype=np.int32)[:, None]
    idx = np.concatenate([rng.integers(0, 1 << 20, 62, dtype=np.int32),
                          np.array([0, (1 << 20) - 1], np.int32)])[None, :]
    return nodes, idx


@pytest.mark.parametrize("proc_seed,local,write", [
    (0, 800, 500), (7, 200, 900), (123456, 1000, 0), (2**31 - 1, 0, 1000)])
def test_procedural_instr_matches_jax(proc_seed, local, write):
    jcfg, tcfg = cfg_pair(4096, procedural="uniform", max_instrs=1,
                          proc_seed=proc_seed, proc_local_permille=local,
                          proc_write_permille=write)
    nodes, idx = _grid(proc_seed % 1000)
    j_oa, j_val = jproc.procedural_instr(jcfg, jnp.asarray(nodes),
                                         jnp.asarray(idx))
    t_oa, t_val = tproc.procedural_instr(tcfg, torch.from_numpy(nodes),
                                         torch.from_numpy(idx))
    assert t_oa.dtype == t_val.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(j_oa), t_oa.numpy())
    np.testing.assert_array_equal(np.asarray(j_val), t_val.numpy())


@pytest.mark.parametrize("num_nodes", [4, 64, 4096, 65536])
@pytest.mark.parametrize("round_,seed", [
    (0, 0), (1, 0), (37, 5), (100_000, 3), (8190, 2**31 - 1)])
def test_round_key_matches_jax(num_nodes, round_, seed):
    kw = dict(procedural="uniform", max_instrs=1, deep_window=True,
              deep_slots=3)
    jcfg, tcfg = cfg_pair(num_nodes, **kw)
    rows = np.arange(num_nodes, dtype=np.int32)
    want = jse._round_key_rs(jcfg, jnp.int32(round_), jnp.int32(seed),
                             jnp.asarray(rows))
    got = tse._round_key_rs(tcfg, torch.tensor(round_, dtype=torch.int32),
                            torch.tensor(seed, dtype=torch.int32),
                            torch.from_numpy(rows))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_mulmod32_against_python_ints():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 2**32, 4096, dtype=np.int64)
    m = int(rng.integers(0, 2**32))
    got = tproc.mulmod32(torch.from_numpy(x), m).numpy()
    want = np.array([(int(v) * m) % 2**32 for v in x], dtype=np.int64)
    np.testing.assert_array_equal(got, want)
