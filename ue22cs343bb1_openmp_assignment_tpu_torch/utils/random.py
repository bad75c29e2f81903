"""A threefry-2x32 twin of the ``jax.random`` calls the JAX package makes.

The JAX package draws its synthetic workloads and its fault injection
from ``jax.random`` with the default threefry2x32 generator, under
``jax_threefry_partitionable=True`` (JAX 0.9.0's default). This module
re-implements that stream from the algorithm, bit for bit:

- ``threefry2x32``: the block cipher of ``jax._src.prng.
  _threefry2x32_lowering``: 20 rounds, rotations (13, 15, 26, 6) and
  (17, 29, 16, 24), a key injection after every four rounds with the
  parity constant 0x1BD11BDA.
- ``prng_key``: ``jax.random.PRNGKey(seed)``'s key data, [hi, lo] of
  the seed (0 and ``seed mod 2^32`` for a 32-bit seed).
- ``split``: ``_threefry_split_foldlike``: key i is the cipher of the
  counter pair (hi, lo) of the flat index i (``iota_2x32_shape``).
- ``random_bits``: ``_threefry_random_bits_partitionable``: the 32-bit
  draw at flat index i is ``y0 ^ y1`` of the cipher of (hi, lo) of i.
- ``uniform``, ``randint`` and ``bernoulli`` (mode 'low'): the float32
  and int32 transforms of ``jax._src.random`` on those draws.

Keys are [2] int32 tensors holding the uint32 words as bit patterns (as
the port holds ``fault_key``). A draw runs where its key lies: on a CUDA
key every cipher block goes through the hand-written kernel
(``ops.threefry_kernel``, ``csrc/threefry.cu``), on a CPU key through
the plain version here (``plain_block``). Arithmetic on uint32 values
runs in int64 masked to 32 bits; results are int32 bit patterns.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
from ue22cs343bb1_openmp_assignment_tpu_torch.procedural import (
    M32, mulmod32)

#: the rotation schedule of the two alternating groups of four rounds
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: Threefry's key-schedule parity constant
PARITY = 0x1BD11BDA
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor) -> tuple:
    """The threefry2x32 block of key (k0, k1) on counters (x0, x1): all
    uint32 values held in int64 (keys as Python ints or int64 tensors
    that broadcast against the counters). Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> their int32 bit patterns."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def plain_block(key: torch.Tensor, n: int, pair: bool = False):
    """The cipher of the counters 0 .. n - 1 under ``key`` in plain
    PyTorch, on the key's device: the draws ``y0 ^ y1`` [n], or with
    ``pair`` both words [n, 2] (int32 bit patterns)."""
    k = key.to(torch.int64) & M32
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k[0], k[1], i >> 32, i & M32)
    if pair:
        return _to_int32(torch.stack([y0, y1], dim=-1))
    return _to_int32(y0 ^ y1)


def _block(key: torch.Tensor, n: int, pair: bool = False) -> torch.Tensor:
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import threefry_kernel
    return threefry_kernel.block(key, n, pair)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s [2] key data as int32 patterns:
    [0, seed mod 2^32] (the JAX package runs with 32-bit seeds)."""
    if not -(1 << 63) <= int(seed) < (1 << 64):
        raise ValueError(f"seed {seed} is not a 64-bit integer")
    lo = int(seed) & M32
    return torch.tensor([0, lo - (1 << 32) if lo >> 31 else lo],
                        dtype=torch.int32, device=_device.resolve(device))


def as_key(key, device=None) -> torch.Tensor:
    """A [2] int32 key tensor from an int seed (``prng_key``), a key
    tensor, or an array of the two uint32 (or int32) words. A tensor
    stays on its device unless ``device`` names another."""
    if isinstance(key, (int, np.integer)):
        return prng_key(int(key), device)
    if isinstance(key, torch.Tensor):
        out = key if device is None else key.to(_device.resolve(device))
        out = out.to(torch.int32)
    else:
        a = np.asarray(key)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out = torch.as_tensor(a.astype(np.int32),
                              device=_device.resolve(device))
    if tuple(out.shape) != (2,):
        raise ValueError(f"a threefry key is [2] words, got "
                         f"{tuple(out.shape)}")
    return out.contiguous()


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(d) for d in shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: [num, 2] keys."""
    return _block(key, int(num), pair=True)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits a position (int32 patterns of the uint32 draws of
    ``jax.random.bits(key, shape)``)."""
    shape = _shape(shape)
    return _block(key, math.prod(shape)).reshape(shape)


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32: the draw's top 23
    bits as the mantissa of a float in [1, 2), minus 1, then scaled to
    [minval, maxval) and clamped below at minval."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    floats = mant.view(torch.float32) - 1.0
    if (minval, maxval) == (0.0, 1.0):
        # floats * 1 + 0 and the clamp at 0 leave every value in [0, 1)
        # as it is: skip three launches
        return floats
    # XLA contracts floats * (hi - lo) + lo into one fused multiply-add:
    # the product of two float32 is exact in float64, so the sum rounds
    # once there and once to float32 (as the fused operation, unless the
    # sum needs more than 53 bits)
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = (floats.to(torch.float64) * float(np.float32(hi - lo))
              + float(lo)).to(torch.float32)
    return torch.clamp(scaled, min=float(lo))


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32: two
    draws from the halves of a split, each reduced modulo the span and
    combined with the multiplier 2^32 mod span; ``minval`` where
    ``maxval <= minval``."""
    minval, maxval = int(minval), int(maxval)
    for name, v in (("minval", minval), ("maxval", maxval)):
        if not _INT32_MIN <= v <= _INT32_MAX:
            raise ValueError(f"randint: {name} {v} is outside int32")
    k1, k2 = split(key)
    higher = random_bits(k1, shape).to(torch.int64) & M32
    lower = random_bits(k2, shape).to(torch.int64) & M32
    span = 1 if maxval <= minval else (maxval - minval) & M32
    # 2^32 mod span, in uint32 arithmetic as JAX computes it (the square
    # wraps to 0 where 2^16 mod span is 2^16)
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & M32) % span
    offset = (mulmod32(higher % span, multiplier) + lower % span) & M32
    return (offset % span + minval).to(torch.int32)


def bernoulli(key: torch.Tensor, p: float = 0.5, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode 'low'): a float32
    uniform draw below float32 ``p``.

    Compared in integers, in three launches after the draw instead of
    five: the uniform draw is m / 2^23 exactly, m the draw's top 23
    bits, so it is below p exactly where m < ceil(p * 2^23) (p * 2^23 is
    exact for a float32 p)."""
    threshold = math.ceil(float(np.float32(p)) * (1 << 23))
    mant = (random_bits(key, shape) >> 9) & 0x7FFFFF
    return mant < max(threshold, 0)
