"""Synthetic workload (memory-reference trace) generators.

The port of the JAX package's ``models/workloads.py``: each generator
returns (op, addr, val, count) int32 tensors, [N, trace_len] and [N], on
``device``, bit for bit the JAX package's for the same key and config.
Every generator but ``procedural_uniform`` draws from the threefry twin
of ``jax.random`` (``utils.random``), whose draws run in the hand-written
kernel on the card. ``key`` is a [2] key tensor or an int seed
(``jax.random.PRNGKey(seed)``); ``device`` None means the key tensor's
device, or the card for a seed. The JAX package's
``jax.random.uniform(k, shape) < p`` (p a Python float, so compared in
float32) is ``bernoulli(k, p, shape)`` here, the same draw compared in
integers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import codec
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.procedural import (
    M32, mulmod32, procedural_instr)
from ue22cs343bb1_openmp_assignment_tpu_torch.types import Op
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import random as jr

I32 = torch.int32


def _ids(N: int, dev) -> torch.Tensor:
    return torch.arange(N, dtype=I32, device=dev)[:, None]


def _count(N: int, trace_len: int, dev) -> torch.Tensor:
    return torch.full((N,), trace_len, dtype=I32, device=dev)


def _op(is_write: torch.Tensor) -> torch.Tensor:
    return torch.where(is_write, int(Op.WRITE), int(Op.READ)).to(I32)


def uniform_random(key, cfg: SystemConfig, trace_len: int,
                   local_frac: float = 0.8, write_frac: float = 0.5,
                   device=None):
    """Uniform-random RD/WR mix; ``local_frac`` of accesses hit the
    node's own home memory, the rest a uniformly random remote node."""
    key = jr.as_key(key, device)
    dev, N = key.device, cfg.num_nodes
    k1, k2, k3, k4, k5 = jr.split(key, 5)
    shape = (N, trace_len)
    op = _op(jr.bernoulli(k1, write_frac, shape))
    own = _ids(N, dev).expand(shape)
    remote = jr.randint(k2, shape, 0, N)
    node = torch.where(jr.bernoulli(k3, local_frac, shape), own, remote)
    block = jr.randint(k4, shape, 0, cfg.mem_size)
    addr = codec.make_address(cfg, node, block)
    val = jr.randint(k5, shape, 0, 256)
    return op, addr, val, _count(N, trace_len, dev)


def producer_consumer(key, cfg: SystemConfig, trace_len: int,
                      num_slots: int = 4, device=None):
    """Odd nodes write into even neighbours' memory; even nodes read
    their own blocks back: a ping-pong ownership-transfer stress."""
    key = jr.as_key(key, device)
    dev, N = key.device, cfg.num_nodes
    k1, k2 = jr.split(key)
    shape = (N, trace_len)
    ids = _ids(N, dev)
    is_producer = (ids % 2) == 1
    partner = torch.where(is_producer, ids - 1, ids)
    block = jr.randint(k1, shape, 0, num_slots)
    addr = codec.make_address(cfg, partner.expand(shape), block)
    op = _op(is_producer.expand(shape))
    val = jr.randint(k2, shape, 0, 256)
    return op, addr, val, _count(N, trace_len, dev)


def false_sharing(key, cfg: SystemConfig, trace_len: int,
                  num_hot_blocks: int = 2, device=None):
    """Every node hammers the same few blocks of node 0."""
    key = jr.as_key(key, device)
    dev, N = key.device, cfg.num_nodes
    k1, k2, k3 = jr.split(key, 3)
    shape = (N, trace_len)
    block = jr.randint(k1, shape, 0, num_hot_blocks)
    addr = codec.make_address(cfg, torch.zeros(shape, dtype=I32,
                                               device=dev), block)
    op = _op(jr.bernoulli(k2, 0.5, shape))
    val = jr.randint(k3, shape, 0, 256)
    return op, addr, val, _count(N, trace_len, dev)


def false_sharing_vars(key, cfg: SystemConfig, trace_len: int,
                       vars_per_block: int = 4, padded: bool = False,
                       write_frac: float = 0.75, device=None):
    """Per-node private variables that collide on a coherence unit:
    groupmates (``n // vars_per_block``) share one block; ``padded``
    moves every node's variable to its own home memory."""
    key = jr.as_key(key, device)
    dev, N = key.device, cfg.num_nodes
    k1, k2 = jr.split(key)
    shape = (N, trace_len)
    ids = _ids(N, dev)
    if padded:
        node, block = ids, ids % cfg.mem_size
    else:
        group = torch.div(ids, vars_per_block, rounding_mode="floor")
        node, block = group % N, group % cfg.mem_size
    addr = codec.make_address(cfg, node.expand(shape), block.expand(shape))
    op = _op(jr.bernoulli(k1, write_frac, shape))
    val = jr.randint(k2, shape, 0, 256)
    return op, addr, val, _count(N, trace_len, dev)


def fft_transpose(key, cfg: SystemConfig, trace_len: int, device=None):
    """SPLASH-2 FFT-style butterfly: in stage s node i reads blocks
    homed at partner i XOR 2^s (even slots) and writes its own (odd)."""
    key = jr.as_key(key, device)
    dev, N = key.device, cfg.num_nodes
    k1, k2 = jr.split(key)
    shape = (N, trace_len)
    stages = max(1, (N - 1).bit_length())
    ids = _ids(N, dev)
    t = torch.arange(trace_len, dtype=I32, device=dev)[None, :]
    stage = torch.div(t, 2, rounding_mode="floor") % stages
    partner = (ids ^ torch.bitwise_left_shift(torch.ones_like(stage),
                                              stage)) % N
    is_write = (t % 2) == 1
    node = torch.where(is_write, ids, partner)
    block = jr.randint(k1, shape, 0, cfg.mem_size)
    addr = codec.make_address(cfg, node.expand(shape), block)
    op = _op(is_write).expand(shape).contiguous()
    val = jr.randint(k2, shape, 0, 256)
    return op, addr, val, _count(N, trace_len, dev)


def radix_sort(key, cfg: SystemConfig, trace_len: int, radix: int = 16,
               device=None):
    """SPLASH-2 radix-sort-style: local histogram reads, then writes
    scattered to the node owning each key's digit bucket."""
    key = jr.as_key(key, device)
    dev, N = key.device, cfg.num_nodes
    k1, k2, k3 = jr.split(key, 3)
    shape = (N, trace_len)
    ids = _ids(N, dev)
    t = torch.arange(trace_len, dtype=I32, device=dev)[None, :]
    hist_phase = t < (trace_len // 2)
    digit = jr.randint(k1, shape, 0, radix)
    bucket_node = torch.div(digit * N, radix, rounding_mode="floor") % N
    node = torch.where(hist_phase, ids, bucket_node)
    block = jr.randint(k2, shape, 0, cfg.mem_size)
    addr = codec.make_address(cfg, node, block)
    op = torch.where(hist_phase, int(Op.READ), int(Op.WRITE)).to(I32)
    val = jr.randint(k3, shape, 0, 256)
    return op.expand(shape).contiguous(), addr, val, _count(N, trace_len,
                                                            dev)


def hotspot(key, cfg: SystemConfig, trace_len: int, working_set: int = 2,
            migrate_prob: float = 0.05, write_frac: float = 0.5,
            device=None):
    """Temporal locality: each node revisits a small working set (its
    own, or a per-segment shared region of one hot node) until a
    migration draw starts a new segment."""
    key = jr.as_key(key, device)
    dev, N = key.device, cfg.num_nodes
    k1, k2, k3, k4, k5 = jr.split(key, 5)
    shape = (N, trace_len)
    migrate = jr.bernoulli(k1, migrate_prob, shape)
    seg = torch.cumsum(migrate.to(I32), dim=1, dtype=I32)
    # uint32 hashes in int64, masked to 32 bits (the int32 seg_key wraps
    # the same way)
    seg_key = (_ids(N, dev).to(torch.int64) * 131071 + seg) & M32
    h = mulmod32(seg_key, 0x9E3779B9) >> 8
    h_shared = mulmod32((seg.to(torch.int64) + 0x51ED2705) & M32,
                        0x85EBCA77) >> 8
    own = _ids(N, dev).expand(shape)
    hot = jr.randint(k2, (), 0, N)
    is_hot = (h & 3) == 0
    node = torch.where(is_hot, hot, own)
    base = torch.where(is_hot, h_shared, h >> 2).to(I32) % cfg.mem_size
    off = jr.randint(k3, shape, 0, working_set)
    block = (base + off) % cfg.mem_size
    addr = codec.make_address(cfg, node, block)
    op = _op(jr.bernoulli(k4, write_frac, shape))
    val = jr.randint(k5, shape, 0, 256)
    return op, addr, val, _count(N, trace_len, dev)


# lint: host
def _xla_cpu_sum(x: np.ndarray) -> np.float32:
    """``jnp.sum`` of float32 ``x`` as XLA's CPU backend computes it:
    past 32 elements a reduce-window of 32 (padding split around the
    input, the extra zero at the end) gives partial sums, each added in
    order, and the partials are reduced the same way."""
    while len(x) > 32:
        k = -(-len(x) // 32)
        low = (32 * k - len(x)) // 2
        padded = np.zeros(32 * k, np.float32)
        padded[low:low + len(x)] = x
        x = np.cumsum(padded.reshape(k, 32), axis=1, dtype=np.float32)[:, -1]
    return np.cumsum(x, dtype=np.float32)[-1]


# lint: host
def _xla_cpu_cumsum(x: np.ndarray) -> np.ndarray:
    """``jnp.cumsum`` of float32 ``x`` as XLA's CPU backend computes it:
    past 16 elements, rows of 16 (zero-padded at the end) are scanned in
    order, and each row adds the scan of the rows' totals before it."""
    n = len(x)
    if n <= 16:
        return np.cumsum(x, dtype=np.float32)
    rows = -(-n // 16)
    padded = np.zeros(rows * 16, np.float32)
    padded[:n] = x
    local = np.cumsum(padded.reshape(rows, 16), axis=1, dtype=np.float32)
    before = np.concatenate([np.zeros(1, np.float32),
                             _xla_cpu_cumsum(local[:, -1])[:-1]])
    return (local + before[:, None]).reshape(-1)[:n]


# lint: host
def zipf_cdf(cfg: SystemConfig, exponent: float = 1.2,
             hot_ranks: int = 64) -> np.ndarray:
    """The truncated Zipf law's float32 cdf over the ``hot_ranks`` most
    popular blocks (JAX ``workloads.py:229-233``), built on the host
    whatever the device, so the card and the CPU share it. It follows the
    JAX package's float32 arithmetic on the CPU, not numpy's or torch's,
    which differ from it by a few ulp: ``rank ** -exponent`` is rounded
    once from float64 (XLA's pow is exact to the ulp here, numpy's and
    torch's float32 pow are not), and the cumsum and the sum add in
    XLA's order (``_xla_cpu_cumsum``, ``_xla_cpu_sum``)."""
    n_ranks = min(int(hot_ranks), cfg.num_nodes * cfg.mem_size)
    ranks = np.arange(1, n_ranks + 1, dtype=np.float64)
    weights = (ranks ** float(np.float32(-exponent))).astype(np.float32)
    return _xla_cpu_cumsum(weights) / _xla_cpu_sum(weights)


def zipf_hotspot(key, cfg: SystemConfig, trace_len: int,
                 exponent: float = 1.2, hot_ranks: int = 64,
                 write_frac: float = 0.5, device=None):
    """Heavy-tailed popularity: block popularity follows a truncated Zipf
    law over ``hot_ranks`` blocks, every node sampling the same ranking
    by inverse cdf; ranks map to blocks through a hash."""
    key = jr.as_key(key, device)
    dev, N = key.device, cfg.num_nodes
    k1, k2, k3 = jr.split(key, 3)
    shape = (N, trace_len)
    cdf = torch.from_numpy(zipf_cdf(cfg, exponent, hot_ranks)).to(dev)
    u = jr.uniform(k1, shape)
    # jnp.searchsorted's default side is 'left'
    rank = torch.searchsorted(cdf, u, right=False).to(torch.int64)
    h = mulmod32(rank + 1, 0x9E3779B9)
    node = ((h >> 8) & 0x7FFF).to(I32) % N
    block = ((h >> 16) & 0x7FFF).to(I32) % cfg.mem_size
    addr = codec.make_address(cfg, node, block)
    op = _op(jr.bernoulli(k2, write_frac, shape))
    val = jr.randint(k3, shape, 0, 256)
    return op, addr, val, _count(N, trace_len, dev)


def lu_blocked(key, cfg: SystemConfig, trace_len: int, device=None):
    """SPLASH-2 LU-style blocked factorization: per phase of four slots,
    the pivot block, the row-pivot block, then a local read and write."""
    key = jr.as_key(key, device)
    dev, N = key.device, cfg.num_nodes
    k1, k2 = jr.split(key)
    shape = (N, trace_len)
    ids = _ids(N, dev)
    t = torch.arange(trace_len, dtype=I32, device=dev)[None, :]
    phase = torch.div(t, 4, rounding_mode="floor")
    slot = t % 4
    pivot_owner = phase % N
    pivot_block = phase % cfg.mem_size
    row_owner = (phase + ids) % N
    local_block = jr.randint(k1, shape, 0, cfg.mem_size)
    node = torch.where(slot == 0, pivot_owner,
                       torch.where(slot == 1, row_owner, ids))
    block = torch.where(slot <= 1, pivot_block.expand(shape), local_block)
    addr = codec.make_address(cfg, node, block)
    op = torch.where(slot == 3, int(Op.WRITE), int(Op.READ)).to(I32)
    val = jr.randint(k2, shape, 0, 256)
    return op.expand(shape).contiguous(), addr, val, _count(N, trace_len,
                                                            dev)


def procedural_uniform(key, cfg: SystemConfig, trace_len: int,
                       device=None):
    """(op, addr, val, count) of the procedural 'uniform' stream,
    identical to the sync engine's in-round instructions. The key only
    places the arrays (cfg.proc_seed determines the stream)."""
    dev = jr.as_key(key, device).device
    N = cfg.num_nodes
    nodes = torch.arange(N, dtype=I32, device=dev)[:, None]
    idxs = torch.arange(trace_len, dtype=I32, device=dev)[None]
    oa, val = procedural_instr(cfg, nodes, idxs)
    return (oa >> 28, oa & 0x0FFFFFFF, val, _count(N, trace_len, dev))


GENERATORS = {
    "uniform": uniform_random,
    "producer_consumer": producer_consumer,
    "false_sharing": false_sharing,
    "false_sharing_vars": false_sharing_vars,
    "false_sharing_vars_padded": functools.partial(false_sharing_vars,
                                                   padded=True),
    "fft": fft_transpose,
    "radix": radix_sort,
    "lu": lu_blocked,
    "hotspot": hotspot,
    "zipf_hotspot": zipf_hotspot,
    "procedural_uniform": procedural_uniform,
}
