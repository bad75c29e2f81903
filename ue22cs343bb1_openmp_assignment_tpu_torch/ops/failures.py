"""Failure detection: the stall watchdog of the message-level machine.

The port of the JAX package's ``ops/failures.py``. The reference has
none: a node whose reply was dropped spins forever
(``assignment.c:624-629``). Here blocking is explicit state
(``waiting``, ``waiting_since``), so detection is a reduction: a node is
stalled when it has waited on its one request for more than
``threshold`` cycles.
"""

from __future__ import annotations

from typing import List

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.state import SimState

DEFAULT_THRESHOLD = 100


def stalled_mask(cfg: SystemConfig, state: SimState,
                 threshold: int = DEFAULT_THRESHOLD) -> torch.Tensor:
    """[N] bool: waiting on one request for > threshold cycles."""
    age = state.cycle - state.waiting_since
    return state.waiting & (state.waiting_since >= 0) & (age > threshold)


def stalled_count(cfg: SystemConfig, state: SimState,
                  threshold: int = DEFAULT_THRESHOLD) -> torch.Tensor:
    return stalled_mask(cfg, state, threshold).sum(dtype=torch.int32)


# lint: host
def stall_report(cfg: SystemConfig, state: SimState,
                 threshold: int = DEFAULT_THRESHOLD,
                 limit: int = 16) -> dict:
    """{"count": stalled nodes, "nodes": up to `limit` entries with the
    stuck request (node, since-cycle, op, addr)}, from one evaluation of
    the mask."""
    mask = stalled_mask(cfg, state, threshold).cpu().numpy()
    ids = mask.nonzero()[0]
    since = state.waiting_since.cpu().numpy()
    op = state.cur_op.cpu().numpy()
    addr = state.cur_addr.cpu().numpy()
    return {"count": int(mask.sum()),
            "nodes": [{"node": int(n), "since_cycle": int(since[n]),
                       "op": "W" if int(op[n]) else "R",
                       "addr": int(addr[n])} for n in ids[:limit]]}


def stalled_nodes(cfg: SystemConfig, state: SimState,
                  threshold: int = DEFAULT_THRESHOLD,
                  limit: int = 16) -> List[dict]:
    """The node list of :func:`stall_report`."""
    return stall_report(cfg, state, threshold, limit)["nodes"]
