"""Carry machine state between the JAX package and the port.

The engines have no weights; their state is what carries across. A
state travels as a flat dict of numpy arrays keyed by field name: the
fields of the transactional engine's SyncState or of the message-level
engine's SimState, and the metrics as ``metrics.<name>``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.sync_engine import (
    METRIC_FIELDS, STATE_FIELDS, SyncMetrics, SyncState)
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
    SIM_FIELDS, SIM_METRIC_FIELDS, UINT32_FIELDS, Metrics, SimState)


def numpy_leaves(st) -> dict:
    """The leaves of any object with the SyncState fields (the JAX
    package's SyncState included) as numpy arrays, by field name."""
    out = {f: np.asarray(host(getattr(st, f))) for f in STATE_FIELDS}
    for f in METRIC_FIELDS:
        out[f"metrics.{f}"] = np.asarray(host(getattr(st.metrics, f)))
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

    metrics = SyncMetrics(t([leaves[f"metrics.{m}"]
                             for m in METRIC_FIELDS]))
    return SyncState(**{f: t(leaves[f]) for f in STATE_FIELDS},
                     metrics=metrics)


def host(x):
    """A tensor (on any device) as a numpy array; anything else as it
    is: the host read of the port's captures and states."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


# -- the message-level engine's SimState ----------------------------------
#
# A SimState travels as a flat dict of numpy arrays in the JAX package's
# dtypes: the SimState fields (``dir_bitvec`` and ``fault_key`` uint32,
# ``waiting`` bool, the rest int32) and the metrics as
# ``metrics.<name>``. The port holds the uint32 leaves as int32 bit
# patterns; the conversion is a bit-for-bit view.

def sim_numpy_leaves(st) -> dict:
    """The leaves of a SimState, the JAX package's or the port's, as
    numpy arrays by field name, in the JAX package's dtypes."""
    out = {}
    for f in SIM_FIELDS:
        a = np.asarray(host(getattr(st, f)))
        out[f] = a.view(np.uint32) if f in UINT32_FIELDS else a
    for f in SIM_METRIC_FIELDS:
        out[f"metrics.{f}"] = np.asarray(host(getattr(st.metrics, f)))
    return out


def sim_from_numpy(cfg: SystemConfig, leaves: dict,
                   device=None) -> SimState:
    """A port SimState from a flat dict of numpy leaves (as made by
    ``sim_numpy_leaves`` from a JAX SimState), checked against cfg."""
    dev = _device.resolve(device)
    N, C, M = cfg.num_nodes, cfg.cache_size, cfg.mem_size
    want = {"cache_addr": (N, C), "memory": (N, M),
            "dir_bitvec": (N, M, cfg.bitvec_words),
            "mb_pack": (6 + cfg.msg_bitvec_words, N, cfg.queue_capacity),
            "instr_op": (N, cfg.max_instrs), "waiting": (N,),
            "fault_key": (2,), "cycle": ()}
    missing = [f for f in SIM_FIELDS
               + tuple(f"metrics.{m}" for m in SIM_METRIC_FIELDS)
               if f not in leaves]
    if missing:
        raise KeyError(f"state leaves missing: {missing}")
    for f, shape in want.items():
        if np.shape(leaves[f]) != shape:
            raise ValueError(f"leaf {f} has shape {np.shape(leaves[f])}, "
                             f"cfg needs {shape}")

    def t(f, a):
        a = np.asarray(a)
        if f == "waiting":
            return torch.as_tensor(a.astype(bool), device=dev)
        if f in UINT32_FIELDS:
            a = a.astype(np.uint32).view(np.int32)
        return torch.as_tensor(np.array(a, dtype=np.int32), device=dev)

    metrics = Metrics(**{m: t(m, leaves[f"metrics.{m}"])
                         for m in SIM_METRIC_FIELDS})
    return SimState(**{f: t(f, leaves[f]) for f in SIM_FIELDS},
                    metrics=metrics)


def leaves_digest(leaves: dict) -> str:
    """sha256 of a flat dict of numpy leaves (names sorted, each name
    then its bytes): one string that pins a whole machine state, the
    same for a JAX state and a port state with equal leaves and dtypes."""
    h = hashlib.sha256()
    for k in sorted(leaves):
        a = np.ascontiguousarray(leaves[k])
        h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()
