"""Procedural instruction streams: hash-computed workloads.

The 'uniform' stream as a pure function of (config, node, index), bit
for bit the JAX package's ``procedural.procedural_instr``. The hash is
uint32 arithmetic (multiply, xor, shift, modulo); torch's uint32 dtype
lacks most of those ops, so every step runs in int64, is masked back to
32 bits, and the results are cast to int32 at the end.
"""

from __future__ import annotations

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import codec
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.types import Op

M32 = 0xFFFFFFFF


def u32(x) -> torch.Tensor:
    """An int tensor reinterpreted as uint32, held in int64."""
    return x.to(torch.int64) & M32


def mulmod32(x: torch.Tensor, m) -> torch.Tensor:
    """(x * m) mod 2^32 for x, m in [0, 2^32), without int64 overflow:
    m splits into 16-bit halves so every partial product stays < 2^49.
    ``m`` is a Python int or an int64 tensor."""
    lo, hi = m & 0xFFFF, (m >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & M32) << 16)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style 32-bit finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mulmod32(x, 0x846CA68B)
    return x ^ (x >> 16)


def procedural_instr(cfg: SystemConfig, node, idx):
    """(op << 28 | addr, value) for instruction `idx` of `node`.

    node/idx: broadcastable int tensors. Parameters come from the config
    (proc_seed / proc_local_permille / proc_write_permille)."""
    N, M = cfg.num_nodes, cfg.mem_size
    h = mix32(mulmod32(u32(node), 0x9E3779B9)
              ^ mulmod32(u32(idx), 0x85EBCA77)
              ^ (cfg.proc_seed * 2654435761 & M32))
    h2 = mix32(h ^ 0xC2B2AE35)
    is_write = (h % 1000) < cfg.proc_write_permille
    local = ((h >> 10) % 1000) < cfg.proc_local_permille
    remote = (h2 % N).to(torch.int32)
    home = torch.where(local, node.to(torch.int32), remote)
    block = ((h2 >> 16) % M).to(torch.int32)
    addr = codec.make_address(cfg, home, block)
    op = torch.where(is_write, int(Op.WRITE), int(Op.READ)).to(torch.int32)
    val = ((h >> 21) & 0xFF).to(torch.int32)
    return (op << 28) | addr, val
