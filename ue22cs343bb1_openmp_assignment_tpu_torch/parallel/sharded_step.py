"""The message-level cycle with routed phase-3 delivery.

The port of the transport half of the JAX package's
``parallel/sharded_step.py`` (``make_transport_cycle``,
``make_transport_runner``): the cycle with its delivery routed across
the shards of a ``mesh.ShardLayout`` by an explicit transport
(``rdma_comm.make_routed_deliver``: the ring kernel, or the all_to_all
lane exchange). As in JAX, a layout of one shard, or a config that
cannot route (``rdma_comm.supported``: drop_prob > 0), runs the
unrouted cycle. That choice is made here, when the function is built,
and the returned function says which in its ``transport`` attribute
("rdma", "all_to_all" or "none").

The GSPMD runners (``make_sharded_cycle``, ``make_sharded_runner``,
``make_sharded_round*``) and node-axis state over several cards are a
later slice.
"""

from __future__ import annotations

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import rdma_comm
from ue22cs343bb1_openmp_assignment_tpu_torch.parallel.mesh import (
    ShardLayout)


def transport_deliver(cfg: SystemConfig, layout: ShardLayout,
                      transport: str | None = None,
                      lane_cap: int | None = None):
    """The routed ``deliver_fn`` for ``layout``, or None where the cycle
    runs unrouted (one shard, or ``rdma_comm.supported`` false)."""
    if layout.shards == 1 or not rdma_comm.supported(cfg):
        return None
    return rdma_comm.make_routed_deliver(cfg, layout, lane_cap=lane_cap,
                                         transport=transport)


def make_transport_cycle(cfg: SystemConfig, layout: ShardLayout,
                         transport: str | None = None,
                         lane_cap: int | None = None):
    """One cycle with routed phase-3 delivery: ``fn(state) -> state``."""
    deliver_fn = transport_deliver(cfg, layout, transport, lane_cap)

    def run(state):
        return step.cycle(cfg, state, deliver_fn=deliver_fn)

    run.transport = getattr(deliver_fn, "transport", "none")
    return run


def make_transport_runner(cfg: SystemConfig, layout: ShardLayout,
                          num_cycles: int, transport: str | None = None,
                          lane_cap: int | None = None):
    """`num_cycles` cycles with routed phase-3 delivery:
    ``fn(state) -> state``."""
    deliver_fn = transport_deliver(cfg, layout, transport, lane_cap)

    def run(state):
        return step.run_cycles(cfg, state, num_cycles,
                               deliver_fn=deliver_fn)

    run.transport = getattr(deliver_fn, "transport", "none")
    return run
