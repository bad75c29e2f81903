"""Carry machine state between the JAX package and the port.

The transactional engine has no weights; its state is what carries
across. A state travels as a flat dict of numpy arrays keyed by field
name: the SyncState fields, and the metrics as ``metrics.<name>``.
"""

from __future__ import annotations

import numpy as np
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.sync_engine import (
    METRIC_FIELDS, STATE_FIELDS, SyncMetrics, SyncState)


def numpy_leaves(st) -> dict:
    """The leaves of any object with the SyncState fields (the JAX
    package's SyncState included) as numpy arrays, by field name."""
    out = {f: np.asarray(_host(getattr(st, f))) for f in STATE_FIELDS}
    for f in METRIC_FIELDS:
        out[f"metrics.{f}"] = np.asarray(_host(getattr(st.metrics, f)))
    return out


def to_numpy(st: SyncState) -> dict:
    """The port's state as a flat dict of numpy arrays."""
    return numpy_leaves(st)


def from_numpy(cfg: SystemConfig, leaves: dict, device=None) -> SyncState:
    """A port SyncState from a flat dict of numpy arrays (as made by
    ``numpy_leaves`` from a JAX SyncState), checked against ``cfg``."""
    dev = _device.resolve(device)
    N, C = cfg.num_nodes, cfg.cache_size
    E = N << cfg.block_bits
    want = {"cache_addr": (N, C), "cache_val": (N, C),
            "cache_state": (N, C), "dm": (E, 7), "instr_count": (N,),
            "idx": (N,), "horizon": (N,), "seed": (), "round": ()}
    missing = [f for f in STATE_FIELDS
               + tuple(f"metrics.{m}" for m in METRIC_FIELDS)
               if f not in leaves]
    if missing:
        raise KeyError(f"state leaves missing: {missing}")
    for f, shape in want.items():
        if np.shape(leaves[f]) != shape:
            raise ValueError(f"leaf {f} has shape {np.shape(leaves[f])}, "
                             f"cfg needs {shape}")

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.int32), device=dev)

    metrics = SyncMetrics(**{m: t(leaves[f"metrics.{m}"])
                             for m in METRIC_FIELDS})
    return SyncState(**{f: t(leaves[f]) for f in STATE_FIELDS},
                     metrics=metrics)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x
