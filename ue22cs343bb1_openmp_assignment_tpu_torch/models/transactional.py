"""TransactionalSystem — the transactional engine's high-level API.

The port of the JAX package's ``models/transactional.py``: constructors
from a fixture tree, raw traces or the procedural stream, the run verbs,
trace streaming (``continue_with``), metrics, the exact-directory check
and ``printProcessorState`` dumps, for every round of
``ops.sync_engine.round_step`` (deep-window, single- and
multi-transaction). State lives on ``device`` (None means the card; the
CPU only when asked for).

``ensemble`` stacks this machine under several arbitration seeds
(``ops.sync_engine.make_ensemble``). ``from_workload`` runs a synthetic
workload as stored traces; checkpoints (``save``/``load``) are the JAX
package's format (``utils.checkpoint``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import sync_engine as se
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import (
    checkpoint, golden, trace)


@dataclasses.dataclass
class TransactionalSystem:
    """A configured transactional coherence machine with its state."""

    cfg: SystemConfig
    state: se.SyncState

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_test_dir(cls, test_dir: str,
                      cfg: Optional[SystemConfig] = None, seed: int = 0,
                      device=None) -> "TransactionalSystem":
        """Reference-format core_<n>.txt traces (assignment.c:806-851)."""
        cfg = cfg or SystemConfig.reference()
        traces = trace.load_test_dir(test_dir, cfg.num_nodes,
                                     cfg.max_instrs)
        return cls.from_traces(cfg, traces, seed=seed, device=device)

    @classmethod
    def from_traces(cls, cfg: SystemConfig, traces: Sequence,
                    seed: int = 0, device=None) -> "TransactionalSystem":
        return cls(cfg, se.from_traces(cfg, list(traces), seed=seed,
                                       device=device))

    @classmethod
    def from_workload(cls, cfg: SystemConfig, name: str = "uniform",
                      trace_len: Optional[int] = None,
                      workload_seed: int = 0, seed: int = 0, device=None,
                      **gen_kw) -> "TransactionalSystem":
        """A synthetic workload (models.workloads, drawn from
        ``workload_seed``) as stored traces, under arbitration seed
        ``seed``."""
        from ue22cs343bb1_openmp_assignment_tpu_torch.models.system import (
            CoherenceSystem)
        base = CoherenceSystem.from_workload(
            cfg, name, trace_len=trace_len, seed=workload_seed,
            device=device, **gen_kw)
        return cls(base.cfg, se.from_sim_state(base.cfg, base.state, seed))

    @classmethod
    def procedural(cls, cfg: SystemConfig, length: int, seed: int = 0,
                   device=None) -> "TransactionalSystem":
        """`length` hash-computed instructions per node (cfg.procedural)."""
        return cls(cfg, se.procedural_state(cfg, length, seed=seed,
                                            device=device))

    # -- execution ---------------------------------------------------------
    def step(self) -> "TransactionalSystem":
        """Advance one round."""
        return dataclasses.replace(
            self, state=se.round_step(self.cfg, self.state))

    def run(self, max_rounds: int = 100_000,
            chunk: int = 32) -> "TransactionalSystem":
        """Run until every trace retires (quiescence tested per chunk)."""
        final = se.run_sync_to_quiescence(self.cfg, self.state, chunk,
                                          max_rounds)
        return dataclasses.replace(self, state=final)

    def run_rounds(self, n: int) -> "TransactionalSystem":
        return dataclasses.replace(
            self, state=se.run_rounds(self.cfg, self.state, n))

    def continue_with(self, traces=None,
                      instr_arrays=None) -> "TransactionalSystem":
        """Stream the next trace phase into the retired machine."""
        return dataclasses.replace(
            self, state=se.continue_with_traces(
                self.cfg, self.state, traces=traces,
                instr_arrays=instr_arrays))

    # -- ensembles ---------------------------------------------------------
    def ensemble(self, seeds: Sequence[int]) -> se.SyncState:
        """[len(seeds), ...] ensemble of this machine under each seed."""
        return se.make_ensemble(
            [self.state.replace(seed=se._i32(s, self.state.device))
             for s in seeds])

    # -- inspection --------------------------------------------------------
    @property
    def quiescent(self) -> bool:
        return bool(self.state.quiescent())

    @property
    def metrics(self) -> dict:
        m = self.state.metrics
        return {f: int(getattr(m, f)) for f in se.METRIC_FIELDS}

    @property
    def instrs_retired(self) -> int:
        return int(self.state.metrics.instrs_retired)

    def check_invariants(self) -> dict:
        """Exact-directory invariant (valid at any round boundary)."""
        return se.check_exact_directory(self.cfg, self.state)

    def dumps(self) -> List[str]:
        """printProcessorState-format dumps (byte-parity surface)."""
        view = se.to_dump_view(self.cfg, self.state)
        return [golden.format_node_dump(d)
                for d in golden.state_to_dumps(self.cfg, view)]

    def write_dumps(self, out_dir: str) -> List[str]:
        return golden.write_dumps(
            self.cfg, se.to_dump_view(self.cfg, self.state), out_dir)

    # -- persistence -------------------------------------------------------
    def save(self, path: str, meta: Optional[dict] = None) -> None:
        checkpoint.save_checkpoint(path, self.cfg, self.state, meta)

    @classmethod
    def load(cls, path: str, device=None) -> "TransactionalSystem":
        """Resume from a checkpoint (of either package) on ``device``."""
        cfg, state, meta = checkpoint.load_checkpoint(path, device=device)
        if meta.get("kind") != "sync":
            raise ValueError(
                f"{path} holds an async-engine (SimState) checkpoint; "
                "load it with CoherenceSystem.load")
        return cls(cfg, state)
