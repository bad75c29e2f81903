"""Cold machine state and instruction tables (the slice of the JAX
package's ``state.py`` the transactional engine needs).

``initializeProcessor`` (``assignment.c:806-851``): memory block *i* of
node *t* starts at ``(20*t + i) & 0xFF``, directory entries start
Unowned, cache lines start INVALID with the sentinel address. The
message-level engine's sharer bitvector and mailboxes are not built:
the transactional engine keeps an exact directory and never reads them.
"""

from __future__ import annotations

import numpy as np
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.types import Op


def cold_memory(cfg: SystemConfig, device) -> torch.Tensor:
    """[N, M] int32 memory image of a fresh machine."""
    N, M = cfg.num_nodes, cfg.mem_size
    nodes = torch.arange(N, dtype=torch.int32, device=device)[:, None]
    blocks = torch.arange(M, dtype=torch.int32, device=device)[None, :]
    return (20 * nodes + blocks) & 0xFF


def build_instr_arrays(cfg: SystemConfig, device, traces=None,
                       instr_arrays=None):
    """(op, addr, val, count) [N, T] int32 tensors from traces or
    prebuilt arrays; nodes past the end of ``traces`` get empty traces
    padded with NOPs, exactly as the JAX package builds them."""
    N, T = cfg.num_nodes, cfg.max_instrs
    if instr_arrays is not None:
        out = tuple(torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                    device=device) for a in instr_arrays)
        if out[0].shape[1] != T:
            raise ValueError(
                f"instr_arrays trace length {out[0].shape[1]} != "
                f"cfg.max_instrs {T}")
        return out
    op_h = np.full((N, T), int(Op.NOP), np.int32)
    ad_h = np.zeros((N, T), np.int32)
    va_h = np.zeros((N, T), np.int32)
    cnt_h = np.zeros((N,), np.int32)
    for n, tr in enumerate(traces or []):
        tr = tr[:T]
        cnt_h[n] = len(tr)
        for i, (op, addr, val) in enumerate(tr):
            op_h[n, i] = int(op)
            ad_h[n, i] = int(addr)
            va_h[n, i] = int(val) & 0xFF
    return tuple(torch.from_numpy(a).to(device)
                 for a in (op_h, ad_h, va_h, cnt_h))
