"""Address codec: (home node, block index) <-> flat address.

The reference packs an address into one byte — high nibble = home node id,
low nibble = block index (``assignment.c:46-49``), decoded as
``(addr >> 4) & 0x0F`` / ``addr & 0x0F`` (``assignment.c:186-188``) with
``cacheIndex = block % CACHE_SIZE`` (``assignment.c:188``).

Generalized here: the block field is ``cfg.block_bits`` wide (4 when
mem_size=16, identical to the nibble scheme), the node id occupies the
bits above it. Works on Python ints and on JAX arrays alike.
"""

from __future__ import annotations

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig


def home_node(cfg: SystemConfig, addr):
    """Home node id of an address (assignment.c:186,657)."""
    return addr >> cfg.block_bits


def block_index(cfg: SystemConfig, addr):
    """Block index within the home node's memory (assignment.c:187,658)."""
    return addr & ((1 << cfg.block_bits) - 1)


def cache_index(cfg: SystemConfig, addr):
    """Direct-mapped cache slot for an address (assignment.c:188,659)."""
    return block_index(cfg, addr) % cfg.cache_size


def make_address(cfg: SystemConfig, node, block):
    """Compose a flat address from (home node, block index)."""
    return (node << cfg.block_bits) | block
