"""Checkpoint / resume for the whole machine state, in the JAX package's
format, so that a checkpoint written by either package loads in the
other.

The port of the JAX package's ``utils/checkpoint.py``. Format version 4:
one ``.npz`` (a zip of npy arrays) with

* one entry per state leaf, keyed by its dotted path in the JAX pytree
  (``cache_state``, ``metrics.rounds``, ...), in the JAX package's
  dtypes: a SimState's ``dir_bitvec`` and ``fault_key`` uint32 and
  ``waiting`` bool, everything else int32 (``convert.sim_numpy_leaves``,
  ``convert.numpy_leaves``);
* ``__config__``: the SystemConfig as JSON;
* ``__meta__``: user metadata, the format version and the state kind
  ("sim": the message-level engine's SimState; "sync": the
  transactional engines' SyncState, an ensemble's included).

The port's SyncMetrics fields are views of one [11] buffer ([R, 11] in
an ensemble): ``save`` writes each field under its own key and ``load``
rebuilds the buffer. ``load`` puts the state on the device it is asked
for (None: the card). A version 3 checkpoint (slot-major mailbox ring)
is migrated on load; fields added after a checkpoint was written resume
from their neutral initial values, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np

from ue22cs343bb1_openmp_assignment_tpu_torch import convert
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
    LAT_BUCKETS, SIM_FIELDS, SIM_METRIC_FIELDS)

#: v4: plane-major mailbox ring ([P, N, Q] mb_pack); v3: packed mailbox
#: tensor, slot-major
FORMAT_VERSION = 4
_CONFIG_KEY = "__config__"
_META_KEY = "__meta__"


def state_kind(state) -> str:
    return "sync" if isinstance(state, se.SyncState) else "sim"


def _leaf_dict(state) -> dict:
    """The state's leaves by dotted path, on the host, in the JAX
    package's dtypes."""
    if state_kind(state) == "sync":
        return convert.numpy_leaves(state)
    return convert.sim_numpy_leaves(state)


def _blob(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def save_checkpoint(path: str, cfg: SystemConfig, state,
                    meta: Optional[dict] = None) -> None:
    """Write a self-describing checkpoint of (cfg, state) to ``path``:
    a SimState or a SyncState (one machine or an ensemble); the kind is
    recorded."""
    arrays = _leaf_dict(state)
    arrays[_CONFIG_KEY] = _blob(dataclasses.asdict(cfg))
    arrays[_META_KEY] = _blob({**(meta or {}), "kind": state_kind(state),
                               "format_version": FORMAT_VERSION})
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _expected(kind: str) -> set:
    if kind == "sync":
        return set(se.STATE_FIELDS) | {f"metrics.{m}"
                                       for m in se.METRIC_FIELDS}
    return set(SIM_FIELDS) | {f"metrics.{m}" for m in SIM_METRIC_FIELDS}


def _sync_state(cfg: SystemConfig, leaves: dict, device) -> se.SyncState:
    """One machine, or an ensemble (a leading replica axis on every
    leaf: ``seed`` is [R]) rebuilt replica by replica."""
    if np.ndim(leaves["seed"]) == 0:
        return convert.from_numpy(cfg, leaves, device=device)
    reps = np.shape(leaves["seed"])[0]
    return se.make_ensemble([
        convert.from_numpy(cfg, {k: v[r] for k, v in leaves.items()},
                           device=device) for r in range(reps)])


def load_checkpoint(path: str, device=None) -> Tuple[SystemConfig, object,
                                                     dict]:
    """Restore (cfg, state, meta) written by ``save_checkpoint`` (of
    either package) with the state on ``device`` (None: the card)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    if _CONFIG_KEY not in arrays or _META_KEY not in arrays:
        raise ValueError(
            f"{path} is not a checkpoint written by save_checkpoint "
            f"(missing {_CONFIG_KEY}/{_META_KEY})")
    cfg_d = json.loads(bytes(arrays.pop(_CONFIG_KEY).tobytes()).decode())
    meta = json.loads(bytes(arrays.pop(_META_KEY).tobytes()).decode())
    version = meta.get("format_version")
    if version == 3:
        # v3 -> v4: the async mailbox ring goes slot-major [N, Q, P] ->
        # plane-major [P, N, Q]; sync checkpoints carry no mb_pack
        if "mb_pack" in arrays:
            arrays["mb_pack"] = np.moveaxis(arrays["mb_pack"], -1, 0)
        version = FORMAT_VERSION
    if version != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format {meta.get('format_version')} != "
            f"supported {FORMAT_VERSION}")
    cfg = SystemConfig(**cfg_d)
    kind = meta.get("kind", "sim")
    expected = _expected(kind)
    # fields added after a checkpoint was written resume from their
    # neutral initial values
    if kind == "sync" and "horizon" not in arrays and "idx" in arrays:
        arrays["horizon"] = np.full(arrays["idx"].shape, 1 << 20, np.int32)
    if kind == "sim":
        if "order_rank" not in arrays and "instr_count" in arrays:
            # replay gating is off by default: resume ungated
            arrays["order_rank"] = np.zeros(
                arrays["instr_count"].shape + (0,), np.int32)
        arrays.setdefault("metrics.lat_hist",
                          np.zeros((LAT_BUCKETS,), np.int32))
        arrays.setdefault("metrics.mb_depth_peak", np.zeros((), np.int32))
    if set(arrays) != expected:
        raise ValueError(f"checkpoint fields {sorted(arrays)} != "
                         f"state fields {sorted(expected)}")
    if kind == "sync":
        state = _sync_state(cfg, arrays, device)
    else:
        state = convert.sim_from_numpy(cfg, arrays, device=device)
    return cfg, state, meta


def checkpoint_bytes(state) -> int:
    """Total checkpoint payload size from shapes and dtypes only (no
    device-to-host copy): the JAX package's count for the same state."""
    if state_kind(state) == "sync":
        return (sum(getattr(state, f).nbytes for f in se.STATE_FIELDS)
                + state.metrics.buffer().nbytes)
    return (sum(getattr(state, f).nbytes for f in SIM_FIELDS)
            + sum(getattr(state.metrics, m).nbytes
                  for m in SIM_METRIC_FIELDS))
