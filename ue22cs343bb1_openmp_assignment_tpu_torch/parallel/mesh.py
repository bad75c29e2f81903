"""The shard layout of the simulated-node axis.

The JAX package shards the node axis over a ``jax.sharding.Mesh`` and
lets GSPMD place the state. PyTorch has no GSPMD; what the explicit
transports (``shardmap_comm``, ``rdma_comm``) need is only the layout:
D shards of ``L = N / D`` contiguous nodes, shard d owning nodes
``[d * L, (d + 1) * L)`` (``flatten_mesh``'s row-major rule of the JAX
package). Every shard sits on one device, the state's: the D shards are
virtual, and a lane exchange between them moves data within that
device's memory.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """D shards of L contiguous nodes each, all on one device."""

    num_nodes: int
    shards: int
    device: torch.device

    def __post_init__(self):
        if self.shards < 1:
            raise ValueError("a shard layout needs at least one shard")
        if self.num_nodes % self.shards:
            raise ValueError(f"{self.num_nodes} nodes do not shard over "
                             f"{self.shards} shards")

    @property
    def nodes_per_shard(self) -> int:
        return self.num_nodes // self.shards


def make_layout(num_nodes: int, shards: int, device=None) -> ShardLayout:
    """``shards`` shards of the node axis on ``device`` (None: the
    card)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
    return ShardLayout(num_nodes, shards, _device.resolve(device))
