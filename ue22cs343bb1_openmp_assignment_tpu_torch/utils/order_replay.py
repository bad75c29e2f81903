"""Interleaving replay from recorded ``instruction_order.txt`` logs.

The reference's ``-DDEBUG_INSTR`` build prints one line per instruction
fetch (``assignment.c:649-652``); the fixture trees capture the exact
global interleaving that produced each golden set (populated for
``sample``/``test_1``/``test_2``, SURVEY §4). This module parses that
log into a per-instruction *global issue rank* array: instruction i of
node n carries the file position of its line. With
``state.order_rank`` set, the frontend issues instruction i of node n
only when exactly ``order_rank[n, i]`` instructions have issued
machine-wide (ops.frontend) — at most one fetch per cycle, so the
machine reproduces the recorded interleaving exactly, and the
deterministic suites must land byte-for-byte on their goldens
(tests/test_order_replay.py).

The port's copy of the JAX package's ``utils/order_replay.py``, with the
same code: the rank array is numpy on the host, and the port's
``state.init_state(order_rank=...)`` moves it to the machine's device
(tests/test_torch_order_replay.py holds the two copies equal).
"""

from __future__ import annotations

import os
import re
from typing import List, Sequence, Tuple

import numpy as np

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.types import Op

# assignment.c:650-651 printf template
_LINE = re.compile(
    r"Processor (\d+): instr type=([RW]), address=0x([0-9A-Fa-f]+), "
    r"value=(\d+)")


def parse_order_log(lines: Sequence[str]) -> List[Tuple[int, int, int, int]]:
    """[(node, op, addr, value), ...] in recorded global order."""
    out = []
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        m = _LINE.match(ln)
        if not m:
            raise ValueError(f"unparseable instruction_order line: {ln!r}")
        n, t, a, v = m.groups()
        out.append((int(n), int(Op.WRITE if t == "W" else Op.READ),
                    int(a, 16), int(v)))
    return out


def order_rank_from_log(cfg: SystemConfig, lines: Sequence[str],
                        traces) -> np.ndarray:
    """Build the [N, T] ``order_rank`` array for ``state.init_state``.

    Validates the log against the traces: per-node instruction counts
    must match, and each recorded (op, addr) must equal the trace's
    (the reference logs the in-flight instruction verbatim)."""
    N, T = cfg.num_nodes, cfg.max_instrs
    recs = parse_order_log(lines)
    rank = np.full((N, T), np.iinfo(np.int32).max, np.int32)
    seen = [0] * N
    for g, (n, op, addr, _val) in enumerate(recs):
        if n >= N:
            raise ValueError(f"log names node {n}, config has {N}")
        i = seen[n]
        if i >= len(traces[n]):
            raise ValueError(
                f"log has more instructions for node {n} than its trace "
                f"({len(traces[n])})")
        t_op, t_addr, _ = traces[n][i]
        if (int(t_op), int(t_addr)) != (op, addr):
            raise ValueError(
                f"log line {g} (node {n} instr {i}): "
                f"({op}, {addr:#x}) != trace ({int(t_op)}, "
                f"{int(t_addr):#x})")
        rank[n, i] = g
        seen[n] = i + 1
    for n, tr in enumerate(traces):
        if seen[n] != len(tr):
            raise ValueError(
                f"node {n}: log records {seen[n]} instructions, trace "
                f"has {len(tr)}")
    return rank


def load_order_rank(cfg: SystemConfig, suite_dir: str,
                    traces) -> np.ndarray:
    """Read ``<suite_dir>/instruction_order.txt`` into an order_rank
    array (raises FileNotFoundError / ValueError on absent or empty
    logs — test_3/test_4 fixtures ship empty order logs)."""
    path = os.path.join(suite_dir, "instruction_order.txt")
    with open(path) as f:
        lines = f.readlines()
    if not any(ln.strip() for ln in lines):
        raise ValueError(f"{path} is empty (racy suites record no order)")
    return order_rank_from_log(cfg, lines, traces)
