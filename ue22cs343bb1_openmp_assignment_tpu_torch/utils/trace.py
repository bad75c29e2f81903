"""Instruction-trace file I/O.

File format (reference ``assignment.c:833-847``, ``README.md:64-77``):
one instruction per line, ``RD <hexaddr>`` or ``WR <hexaddr> <decvalue>``;
per-node files named ``core_<n>.txt`` inside a test directory. Values are
parsed with C ``%hhu`` semantics (truncate to a byte); addresses with
``%hhx`` (hex, optional 0x prefix).

Divergence note: the reference increments ``instructionCount`` even for a
line that is neither RD nor WR, leaving an *uninitialized stack slot* to
execute as garbage (``assignment.c:833-846``). No shipped fixture contains
such a line; we load them as explicit NOPs (retired with no effect) and
flag them, rather than reproducing undefined behavior.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

from ue22cs343bb1_openmp_assignment_tpu_torch.types import Op

Instr = Tuple[int, int, int]  # (op, address, value)


def parse_trace(text: str, max_instrs: int = 32) -> List[Instr]:
    """Parse one core_<n>.txt body into [(op, addr, value), ...]."""
    out: List[Instr] = []
    for line in text.splitlines():
        if len(out) >= max_instrs:  # MAX_INSTR_NUM cap (assignment.c:833-834)
            break
        if line.startswith("RD"):
            addr = int(line.split()[1], 16) & 0xFF
            out.append((int(Op.READ), addr, 0))
        elif line.startswith("WR"):
            parts = line.split()
            addr = int(parts[1], 16) & 0xFF
            val = int(parts[2]) & 0xFF  # %hhu truncation
            out.append((int(Op.WRITE), addr, val))
        else:
            # reference would execute stack garbage here; we load a NOP
            out.append((int(Op.NOP), 0, 0))
    return out


def load_test_dir(test_dir: str, num_nodes: int = 4,
                  max_instrs: int = 32) -> List[List[Instr]]:
    """Load core_<n>.txt for every node from a test directory.

    Missing file is a hard error, like the reference
    (``assignment.c:826-829``).
    """
    traces = []
    for n in range(num_nodes):
        path = os.path.join(test_dir, f"core_{n}.txt")
        if not os.path.exists(path):
            raise FileNotFoundError(f"Error: could not open file {path}")
        with open(path) as f:
            traces.append(parse_trace(f.read(), max_instrs))
    return traces


def format_trace(instrs: Sequence[Instr]) -> str:
    """Inverse of parse_trace — used by workload generators to emit fixtures."""
    lines = []
    for op, addr, val in instrs:
        if op == Op.READ:
            lines.append(f"RD 0x{addr:02X}")
        elif op == Op.WRITE:
            lines.append(f"WR 0x{addr:02X} {val}")
    return "\n".join(lines) + ("\n" if lines else "")


def save_test_dir(test_dir: str, traces: Sequence[Sequence[Instr]]) -> None:
    os.makedirs(test_dir, exist_ok=True)
    for n, tr in enumerate(traces):
        with open(os.path.join(test_dir, f"core_{n}.txt"), "w") as f:
            f.write(format_trace(tr))
