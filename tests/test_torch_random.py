"""The port's threefry twin of jax.random against jax.random itself.

``utils.random`` re-implements the threefry2x32 stream of the installed
JAX (0.9.0, ``jax_threefry_partitionable`` at its default True, the
setting the JAX package runs under; no test here changes it): keys from
seeds, ``split``, the 32-bit draws, ``uniform``, ``randint`` and
``bernoulli``, every value equal to JAX's, over shapes (), (7,), (3, 5)
and (64, 33) and seeds 0, 7, 2^31 + 5 and 2^32 - 1. On the CPU every
draw runs the plain version; the kernel's wrapper hands a CPU key to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.ops import threefry_kernel
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import random as jr

SEEDS = [0, 7, 2**31 + 5, 2**32 - 1]
SHAPES = [(), (7,), (3, 5), (64, 33)]
#: randint ranges: [0, 1), [0, 256), [0, N) for the node counts the
#: workloads draw, maxval <= minval (minval comes back), and the widest
RANGES = [(0, 1), (0, 256), (0, 16), (0, 33), (0, 4096), (5, 5), (9, 3),
          (-2**31, 2**31 - 1)]
PROBS = [0.0, 0.05, 0.25, 1.0, 0.7, 0.8, 1.5, -0.5]


def words(a) -> np.ndarray:
    """JAX uint32 words as their int32 patterns (the port's keys)."""
    return np.asarray(a).view(np.int32)


def test_the_jax_package_stream_setting():
    """The twin follows the partitionable stream, JAX 0.9.0's default."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_split(seed):
    jk = jax.random.PRNGKey(seed)
    tk = jr.prng_key(seed, "cpu")
    assert tk.dtype == torch.int32 and np.array_equal(words(jk), tk.numpy())
    assert torch.equal(jr.as_key(np.asarray(jk), "cpu"), tk)
    assert torch.equal(jr.as_key(seed, "cpu"), tk)
    for n in (2, 3, 5):
        assert np.array_equal(words(jax.random.split(jk, n)),
                              jr.split(tk, n).numpy()), n
    # a chain of splits
    jc, tc = jk, tk
    for i in range(4):
        jc = jax.random.split(jc, 3)[i % 3]
        tc = jr.split(tc, 3)[i % 3]
    assert np.array_equal(words(jc), tc.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_draws_equal_jax_random(seed, shape):
    jk = jax.random.PRNGKey(seed)
    tk = jr.prng_key(seed, "cpu")
    bits = jr.random_bits(tk, shape)
    assert bits.shape == shape
    assert np.array_equal(words(jax.random.bits(jk, shape)), bits.numpy())
    want = np.asarray(jax.random.uniform(jk, shape))
    got = jr.uniform(tk, shape).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    want = np.asarray(jax.random.uniform(jk, shape, minval=-2.5,
                                         maxval=3.0))
    got = jr.uniform(tk, shape, -2.5, 3.0).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    for lo, hi in RANGES:
        want = np.asarray(jax.random.randint(jk, shape, lo, hi,
                                             dtype=jnp.int32))
        got = jr.randint(tk, shape, lo, hi).numpy()
        assert got.dtype == want.dtype and np.array_equal(want, got), (
            lo, hi)
    for p in PROBS:
        want = np.asarray(jax.random.bernoulli(jk, p, shape))
        got = jr.bernoulli(tk, p, shape).numpy()
        assert got.dtype == want.dtype == np.bool_
        assert np.array_equal(want, got), p


def test_kernel_wrapper_runs_the_plain_version_for_a_cpu_key():
    """The wrapper's CPU route is the plain block (no launch counted);
    a malformed key is refused."""
    key = jr.prng_key(11, "cpu")
    before = threefry_kernel.block.launches
    for pair in (False, True):
        assert torch.equal(threefry_kernel.block(key, 97, pair),
                           jr.plain_block(key, 97, pair))
    assert threefry_kernel.block(key, 0).shape == (0,)
    assert threefry_kernel.block.launches == before
    with pytest.raises(ValueError, match="2"):
        jr.as_key(torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        jr.randint(key, (2,), 0, 2**31)
    assert threefry_kernel.io_contract_bytes(10) == (8, 40)
    assert threefry_kernel.io_contract_bytes(10, pair=True) == (8, 80)


def test_threefry_block_is_the_known_answer():
    """The cipher itself on the Threefry-2x32 known-answer vectors (20
    rounds; Salmon et al., Random123): key 0 / counter 0 and the pi
    digits key and counter."""
    def block(k0, k1, x0, x1):
        y0, y1 = jr.threefry2x32(k0, k1, torch.tensor([x0]),
                                 torch.tensor([x1]))
        return int(y0), int(y1)
    assert block(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)
    assert block(0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF) == (
        0x1CB996FC, 0xBB002BE7)
    assert block(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3) == (
        0xC4923A9C, 0x483DF7A0)


def test_sass_ops_counts_the_threefry_bound_by_pipe_class():
    """chip_smoke.py bounds the threefry kernel by the function's floor:
    the instructions only the integer pipe issues (all but the IMAD and
    IADD families) and all integer instructions over both pipes; the
    SASS's own split (IMAD to the FMA pipe, the rest to the integer
    pipe) counts apart. A made-up loop of two adds, one IMAD, a rotate
    and an xor."""
    import chip_smoke
    body = ["IADD3 R0, R0, 0x1, RZ", "IADD3 R1, R1, R0, RZ",
            "IMAD.IADD R2, R1, 0x1, R0", "SHF.L.W.U32.HI R3, R2, 0xd, R2",
            "LOP3.LUT R4, R3, R2, RZ, 0x3c, !PT", "BRA 0x0", "EXIT"]
    sass = "\n".join(["Function : fake_kernel"]
                     + [f"  /*{16 * i:04x}*/   {ins} ;"
                        for i, ins in enumerate(body)])
    per_step = {pipe: chip_smoke.sass_ops(sass, "fake", 1, 1,
                                          pipe=pipe)["per_step"]
                for pipe in ("", "alu_only", "alu", "fma")}
    assert per_step == {"": [5], "alu_only": [2], "alu": [4], "fma": [1]}
