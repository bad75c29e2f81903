"""Byte-parity golden state dump (and its parser).

Reproduces ``printProcessorState`` (``assignment.c:853-905``) byte for
byte, including its format traps (SURVEY §2 C10 / quirk 8):

* the sharer bitvector renders with C23 ``"0x%08B"`` — **binary** digits
  behind a literal, misleading ``0x`` prefix (sharers {0,1} →
  ``0x00000011``),
* cache rows end in ``" \\t|"`` (space + hard tab, ``assignment.c:898``),
* memory/directory rows print the home-node-prefixed address
  ``(processorId<<4)+i`` (``assignment.c:877,888``),
* ``%2s`` / ``%8s`` right-justification of state names, which lets the
  9-char ``EXCLUSIVE`` overflow its %8s field exactly as C does.

The parser (:func:`parse_dump`) inverts the format so reference golden
files can be round-tripped (formatter proof) and compared structurally.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import List

import numpy as np

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.types import (CACHE_STATE_NAMES,
                                                      DIR_STATE_NAMES)


@dataclass
class NodeDump:
    """Host-side view of one node's dumped state."""

    node_id: int
    memory: np.ndarray      # [M] int
    dir_state: np.ndarray   # [M] int (DirState)
    dir_bitvec: np.ndarray  # [M] int (full integer, words already joined)
    cache_addr: np.ndarray  # [C] int
    cache_val: np.ndarray   # [C] int
    cache_state: np.ndarray # [C] int (CacheState)
    mem_addr: np.ndarray = None  # [M] int; home-prefixed block addresses.
    # Default (reference layout): (node_id << 4) + i, assignment.c:877.

    def __post_init__(self):
        if self.mem_addr is None:
            self.mem_addr = (self.node_id << 4) + np.arange(len(self.memory))


def format_node_dump(d: NodeDump) -> str:
    """Render one node's dump exactly as printProcessorState does."""
    L: List[str] = []
    L.append("=======================================")
    L.append(f" Processor Node: {d.node_id}")
    L.append("=======================================")
    L.append("")
    L.append("-------- Memory State --------")
    L.append("| Index | Address |   Value  |")
    L.append("|----------------------------|")
    for i, v in enumerate(d.memory):
        L.append(f"|  {i:3d}  |  0x{int(d.mem_addr[i]):02X}   |"
                 f"  {int(v):5d}   |")
    L.append("------------------------------")
    L.append("")
    L.append("------------ Directory State ---------------")
    L.append("| Index | Address | State |    BitVector   |")
    L.append("|------------------------------------------|")
    for i in range(len(d.memory)):
        st = DIR_STATE_NAMES[int(d.dir_state[i])]
        bv = int(d.dir_bitvec[i])
        L.append(f"|  {i:3d}  |  0x{int(d.mem_addr[i]):02X}   |  {st:>2s}   |"
                 f"   0x{bv:08b}   |")
    L.append("--------------------------------------------")
    L.append("")
    L.append("------------ Cache State ----------------")
    L.append("| Index | Address | Value |    State    |")
    L.append("|---------------------------------------|")
    for i in range(len(d.cache_addr)):
        st = CACHE_STATE_NAMES[int(d.cache_state[i])]
        L.append(f"|  {i:3d}  |  0x{int(d.cache_addr[i]):02X}   |"
                 f"  {int(d.cache_val[i]):3d}  |  {st:>8s} \t|")
    L.append("----------------------------------------")
    L.append("")
    return "\n".join(L) + "\n"


def state_to_dumps(cfg: SystemConfig, state) -> List[NodeDump]:
    """Pull a SimState (or any pytree with the same fields) to host dumps."""
    mem = np.asarray(state.memory)
    ds = np.asarray(state.dir_state)
    bv = np.asarray(state.dir_bitvec).astype(np.uint64)
    ca, cv, cs = (np.asarray(state.cache_addr), np.asarray(state.cache_val),
                  np.asarray(state.cache_state))
    # join bitvector words into one Python-int-sized value per entry
    joined = np.zeros(bv.shape[:2], dtype=object)
    for w in range(bv.shape[-1]):
        joined = joined + (bv[..., w].astype(object) << (32 * w))
    from ue22cs343bb1_openmp_assignment_tpu_torch import codec
    blocks = np.arange(cfg.mem_size)
    return [NodeDump(node_id=n, memory=mem[n], dir_state=ds[n],
                     dir_bitvec=joined[n], cache_addr=ca[n], cache_val=cv[n],
                     cache_state=cs[n],
                     mem_addr=codec.make_address(cfg, n, blocks))
            for n in range(cfg.num_nodes)]


def write_dumps(cfg: SystemConfig, state, out_dir: str) -> List[str]:
    """Write core_<n>_output.txt files like the reference (assignment.c:860)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for d in state_to_dumps(cfg, state):
        p = os.path.join(out_dir, f"core_{d.node_id}_output.txt")
        with open(p, "w") as f:
            f.write(format_node_dump(d))
        paths.append(p)
    return paths


# -- parser ----------------------------------------------------------------

_MEM_RE = re.compile(r"^\|\s+(\d+)\s+\|\s+0x([0-9A-Fa-f]+)\s+\|\s+(\d+)\s+\|$")
_DIR_RE = re.compile(
    r"^\|\s+(\d+)\s+\|\s+0x([0-9A-Fa-f]+)\s+\|\s+(EM|S|U)\s+\|\s+0x([01]+)\s+\|$")
_CACHE_RE = re.compile(
    r"^\|\s+(\d+)\s+\|\s+0x([0-9A-Fa-f]+)\s+\|\s+(\d+)\s+\|\s+"
    r"(MODIFIED|EXCLUSIVE|SHARED|INVALID) \t\|$")


def parse_dump(text: str) -> NodeDump:
    """Invert format_node_dump on a reference-produced golden file."""
    node_id = int(re.search(r"Processor Node: (\d+)", text).group(1))
    mem_rows, dir_rows, cache_rows = [], [], []
    for line in text.splitlines():
        m = _MEM_RE.match(line)
        if m:
            mem_rows.append((int(m.group(2), 16), int(m.group(3))))
            continue
        m = _DIR_RE.match(line)
        if m:
            dir_rows.append((DIR_STATE_NAMES.index(m.group(3)),
                             int(m.group(4), 2)))
            continue
        m = _CACHE_RE.match(line)
        if m:
            cache_rows.append((int(m.group(2), 16), int(m.group(3)),
                               CACHE_STATE_NAMES.index(m.group(4))))
    return NodeDump(
        node_id=node_id,
        mem_addr=np.array([r[0] for r in mem_rows], dtype=np.int64),
        memory=np.array([r[1] for r in mem_rows], dtype=np.int64),
        dir_state=np.array([r[0] for r in dir_rows], dtype=np.int64),
        dir_bitvec=np.array([r[1] for r in dir_rows], dtype=object),
        cache_addr=np.array([r[0] for r in cache_rows], dtype=np.int64),
        cache_val=np.array([r[1] for r in cache_rows], dtype=np.int64),
        cache_state=np.array([r[2] for r in cache_rows], dtype=np.int64),
    )
