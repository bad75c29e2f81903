"""The transactional engine's retirement record as text and records.

The sync half of the JAX package's ``utils/eventlog.py``: the reference's
only tracing is compile-time printf (``-DDEBUG_INSTR`` logs every
instruction fetch, ``assignment.c:649-652``, the provenance of the
``instruction_order.txt`` fixtures). ``ops.sync_engine.run_rounds_traced``
records the same facts as [rounds, N, window] tensors; this module
renders them byte-compatibly with the reference's line format, or hands
them over as structured records.

The cross-node order is (round, node): one legal serialization.
Per-node projections are program order, as in the reference's logs.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.types import Op

# printf template from the reference (assignment.c:650-651)
_INSTR_FMT = "Processor {n}: instr type={t}, address=0x{a:02X}, value={v}"


def _np_events(events: Dict) -> Dict[str, np.ndarray]:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in events.items()}


def sync_to_records(events: Dict, base_round: int = 0) -> List[dict]:
    """Flatten the [T, N, K] retirement record into (round, node,
    slot)-ordered instr records. Slot order within a round is program
    order. NOP padding retires silently."""
    ev = _np_events(events)
    rt, rn, rk = np.nonzero(ev["retired"])
    return [{"kind": "instr", "cycle": base_round + int(t), "node": int(n),
             "op": int(o), "addr": int(a), "value": int(v)}
            for t, n, o, a, v in zip(
                rt, rn, ev["op"][rt, rn, rk], ev["addr"][rt, rn, rk],
                ev["value"][rt, rn, rk])
            if int(o) != int(Op.NOP)]


def format_record(rec: dict) -> str:
    """One instr record as the reference's printf line."""
    t = "W" if rec["op"] == int(Op.WRITE) else "R"
    return _INSTR_FMT.format(n=rec["node"], t=t, a=rec["addr"],
                             v=rec["value"] & 0xFF)


def write_sync_log(path: str, events: Dict, base_round: int = 0) -> None:
    """Render a retirement record in instruction_order.txt format."""
    with open(path, "w") as f:
        for rec in sync_to_records(events, base_round):
            f.write(format_record(rec) + "\n")
