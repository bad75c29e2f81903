"""Structured event logs as text and records.

The port of the JAX package's ``utils/eventlog.py``. The reference's only
tracing is compile-time printf: ``-DDEBUG_INSTR`` logs every instruction
fetch (``assignment.c:649-652``, the provenance of the
``instruction_order.txt`` fixtures) and ``-DDEBUG_MSG`` every dequeued
message (``assignment.c:179-182``). The engines record the same facts as
tensors: the message-level engine's ``ops.step.run_cycles_traced`` as
[cycles, N] tensors, the transactional engine's ``ops.sync_engine.
run_rounds_traced`` as [rounds, N, window] tensors. This module renders
them byte-compatibly with the reference's line formats, or hands them
over as structured records.

The cross-node order is (cycle, node), or (round, node): one legal
serialization, deterministic and seedable. Per-node projections are
program order, as in the reference's logs.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.types import MSG_NAMES, Op

# printf templates from the reference (assignment.c:650-651, 180-181)
_INSTR_FMT = "Processor {n}: instr type={t}, address=0x{a:02X}, value={v}"
_MSG_FMT = "Processor {n} msg from: {s}, type: {ty}, address: 0x{a:02X}"


def _np_events(events: Dict) -> Dict[str, np.ndarray]:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in events.items()}


def to_records(events: Dict, base_cycle: int = 0) -> List[dict]:
    """Flatten [T, N] event arrays into a (cycle, node)-ordered list of
    dicts: {"kind": "instr"|"msg", "cycle", "node", ...}. A node never
    both dequeues and fetches in one cycle (ops.step), so the order has
    no ties."""
    ev = _np_events(events)
    mt, mn = np.nonzero(ev["msg"])
    msgs = [{"kind": "msg", "cycle": base_cycle + int(t), "node": int(n),
             "sender": int(s), "type": int(ty),
             "type_name": MSG_NAMES[int(ty)], "addr": int(a)}
            for t, n, s, ty, a in zip(
                mt, mn, ev["msg_sender"][mt, mn],
                ev["msg_type"][mt, mn], ev["msg_addr"][mt, mn])]
    ft, fn = np.nonzero(ev["fetch"])
    instrs = [{"kind": "instr", "cycle": base_cycle + int(t),
               "node": int(n), "op": int(o), "addr": int(a),
               "value": int(v)}
              for t, n, o, a, v in zip(
                  ft, fn, ev["op"][ft, fn], ev["addr"][ft, fn],
                  ev["value"][ft, fn])]
    return sorted(msgs + instrs, key=lambda r: (r["cycle"], r["node"]))


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
    """One record as the reference's printf line."""
    if rec["kind"] == "instr":
        t = "W" if rec["op"] == int(Op.WRITE) else "R"
        return _INSTR_FMT.format(n=rec["node"], t=t, a=rec["addr"],
                                 v=rec["value"] & 0xFF)
    return _MSG_FMT.format(n=rec["node"], s=rec["sender"],
                           ty=rec["type"], a=rec["addr"])


def to_lines(events: Dict, kinds=("instr",),
             base_cycle: int = 0) -> List[str]:
    """Render the log; by default only the instruction fetches, the
    ``instruction_order.txt`` surface."""
    return [format_record(r) for r in to_records(events, base_cycle)
            if r["kind"] in kinds]


def write_log(path: str, events: Dict, kinds=("instr",),
              base_cycle: int = 0) -> None:
    with open(path, "w") as f:
        for line in to_lines(events, kinds, base_cycle):
            f.write(line + "\n")


def write_sync_log(path: str, events: Dict, base_round: int = 0) -> None:
    """Render a retirement record in instruction_order.txt format."""
    with open(path, "w") as f:
        for rec in sync_to_records(events, base_round):
            f.write(format_record(rec) + "\n")


def per_node_projection(lines: List[str]) -> Dict[int, List[str]]:
    """Split a rendered (or fixture) log by node id: per-node order is
    program order whatever the interleaving, the property shared with
    the reference's logs."""
    out: Dict[int, List[str]] = {}
    for line in lines:
        if not line.strip():
            continue
        n = int(line.split()[1].rstrip(":"))
        out.setdefault(n, []).append(line.strip())
    return out
