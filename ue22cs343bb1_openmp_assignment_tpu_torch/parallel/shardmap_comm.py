"""Explicit cross-shard message routing: lane bucketing and the
all_to_all lane exchange.

The port of the JAX package's ``parallel/shardmap_comm.py``. Each shard
flattens its [L, S] candidates, sorts them by (destination shard,
priority), ranks them within each destination and places the fitting
rows into [D, cap] outbox lanes; the exchange hands lane d of shard s to
shard d as its lane s. Each candidate keeps its global arbitration
priority, so sorting the inbound rows on (receiver, prio) reproduces the
global delivery order per receiver, bit for bit.

Where JAX runs this per shard under ``shard_map``, the port writes it
once over a leading shard axis: ``bucket_lanes`` takes [D, L, S] planes
and sorts all shards in one batched pass. The all_to_all exchange is
``all_to_all``: ``ring_kernel.plain_exchange`` (a transpose of the two
shard axes) on each of the four lane tensors, the plain version of the
ring kernel. ``make_router`` takes the exchange as an argument, which is
how the rdma transport (``rdma_comm``) puts the ring kernel in its
place.

Capacity: a lane carries up to ``lane_cap`` rows (default L * S, all of
a shard's out-slots: lossless); a fuller lane is truncated in priority
order and counted.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.mailbox import (
    INT32_MAX, Candidates, pack_candidates, segment_ranks)
from ue22cs343bb1_openmp_assignment_tpu_torch.parallel.mesh import (
    ShardLayout)
from ue22cs343bb1_openmp_assignment_tpu_torch.types import Msg

I32 = torch.int32


def pack_fields(cand: Candidates) -> torch.Tensor:
    """[N, S, 6 + Wm] node-major payload rows (the ring's planes moved
    last)."""
    return pack_candidates(cand).movedim(0, -1)


def bucket_lanes(ctype, recv, prio, fields, *, N: int, D: int, L: int,
                 cap: int, Fw: int):
    """Lane bucketing of all D shards at once.

    ``ctype``/``recv``/``prio`` are [D, L, S] (shard d's candidates),
    ``fields`` [D, L, S, Fw]. Returns (ob_valid [D, D, cap] bool,
    ob_recv, ob_prio [D, D, cap], ob_fields [D, D, cap, Fw], truncated
    [D]): ``ob_*[s, d]`` is shard s's lane to shard d, in priority
    order. Per shard the math of the JAX ``bucket_lanes``."""
    dev = ctype.device
    F = ctype[0].numel()
    ctype, recv, prio = (x.reshape(D, F) for x in (ctype, recv, prio))
    fields = fields.reshape(D, F, Fw)
    valid = (ctype != int(Msg.NONE)) & (recv >= 0) & (recv < N)
    dest = torch.where(valid, torch.div(recv, L, rounding_mode="floor"), D)
    key = torch.where(valid, dest * (N * (F // L)) + prio, INT32_MAX)
    order = torch.argsort(key, dim=1, stable=True)
    d_s = torch.gather(dest, 1, order)
    v_s = torch.gather(valid, 1, order)
    rank, _ = segment_ranks(d_s, v_s)
    fit = v_s & (rank < cap)
    truncated = (v_s & ~fit).sum(1, dtype=I32)
    # dropped rows go to the spare lane D of their shard (sliced off)
    src = torch.arange(D, dtype=torch.int64, device=dev)[:, None].expand(D, F)
    tgt = (src, torch.where(fit, d_s, D).to(torch.int64),
           torch.where(fit, rank, 0).to(torch.int64))

    def lanes(vals, fill_shape=()):
        out = vals.new_zeros((D, D + 1, cap) + fill_shape)
        out[tgt] = vals
        return out[:, :D]

    ob_valid = lanes(fit)
    ob_recv = lanes(torch.gather(recv, 1, order))
    ob_prio = lanes(torch.gather(prio, 1, order))
    ob_fields = lanes(torch.gather(
        fields, 1, order[..., None].expand(D, F, Fw)), (Fw,))
    return ob_valid, ob_recv, ob_prio, ob_fields, truncated


class RoutedMsgs(NamedTuple):
    """Every shard's inbound candidates after the exchange: [D, D * cap]
    rows per field (shard d's pool: lane s = rows from shard s). `recv`
    is the global receiver id, always owned by the pool's shard; `prio`
    the global arbitration priority."""

    valid: torch.Tensor     # [D, D * cap] bool
    recv: torch.Tensor      # [D, D * cap]
    prio: torch.Tensor      # [D, D * cap]
    fields: torch.Tensor    # [D, D * cap, 6 + Wm]
    truncated: torch.Tensor  # [] rows dropped to lane caps


def geometry(cfg: SystemConfig, layout: ShardLayout,
             lane_cap: int | None) -> tuple:
    """(D, N, S, L, cap, Fw) of ``layout`` for ``cfg``."""
    N, S = cfg.num_nodes, cfg.out_slots
    if layout.num_nodes != N:
        raise ValueError(f"layout of {layout.num_nodes} nodes for a "
                         f"{N}-node config")
    D, L = layout.shards, layout.nodes_per_shard
    cap = lane_cap if lane_cap is not None else L * S
    return D, N, S, L, cap, 6 + cfg.msg_bitvec_words


def shard_planes(D: int, L: int, *planes):
    """[N, ...] node-major planes as [D, L, ...] (a view)."""
    return tuple(p.reshape((D, L) + tuple(p.shape[1:])) for p in planes)


def all_to_all(ob) -> list:
    """The all_to_all lane exchange of the four outbox lane tensors
    ([D, D, cap, ...] each): the ring kernel's plain version on each."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.parallel import (
        ring_kernel)
    return [ring_kernel.plain_exchange(x) for x in ob]


def make_router(cfg: SystemConfig, layout: ShardLayout,
                lane_cap: int | None = None, exchange=all_to_all):
    """Build ``route(ctype, recv, prio, fields) -> RoutedMsgs`` over
    node-major [N, S] / [N, S, Fw] inputs: lane bucketing, then
    ``exchange`` of the (valid, recv, prio, fields) outbox lanes (by
    default the all_to_all transport)."""
    D, N, S, L, cap, Fw = geometry(cfg, layout, lane_cap)

    def route(ctype, recv, prio, fields) -> RoutedMsgs:
        ob = bucket_lanes(*shard_planes(D, L, ctype, recv, prio, fields),
                          N=N, D=D, L=L, cap=cap, Fw=Fw)
        return RoutedMsgs(*(x.flatten(1, 2) for x in exchange(ob[:4])),
                          ob[4].sum(dtype=I32))

    return route
