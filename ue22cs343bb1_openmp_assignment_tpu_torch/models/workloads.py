"""Synthetic workload (memory-reference trace) generators.

The port of the JAX package's ``models/workloads.py``, as far as it
needs no ``jax.random``: ``procedural_uniform`` materializes the
counter-hash 'uniform' stream (``procedural.procedural_instr``) as
stored [N, trace_len] traces. Every other generator draws from
``jax.random``'s threefry stream and raises until the port has its twin.
"""

from __future__ import annotations

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.procedural import (
    procedural_instr)
from ue22cs343bb1_openmp_assignment_tpu_torch.state import THREEFRY


def procedural_uniform(key, cfg: SystemConfig, trace_len: int,
                       device=None):
    """(op, addr, val, count) int32 tensors of the procedural 'uniform'
    stream, identical to the sync engine's in-round instructions. The
    key is unused: cfg.proc_seed determines the stream."""
    del key
    N = cfg.num_nodes
    nodes = torch.arange(N, dtype=torch.int32, device=device)[:, None]
    idxs = torch.arange(trace_len, dtype=torch.int32, device=device)[None]
    oa, val = procedural_instr(cfg, nodes, idxs)
    return (oa >> 28, oa & 0x0FFFFFFF, val,
            torch.full((N,), trace_len, dtype=torch.int32, device=device))


def _needs_threefry(name: str):
    def gen(*_args, **_kw):
        raise NotImplementedError(
            f"workload {name!r} draws from jax.random; {THREEFRY}")
    gen.__name__ = name
    return gen


GENERATORS = {
    name: _needs_threefry(name)
    for name in ("uniform", "producer_consumer", "false_sharing",
                 "false_sharing_vars", "false_sharing_vars_padded", "fft",
                 "radix", "lu", "hotspot", "zipf_hotspot")}
GENERATORS["procedural_uniform"] = procedural_uniform
