"""CoherenceSystem: the message-level directory/MESI machine as one
object.

The port of the JAX package's ``models/system.py``: the user-facing
equivalent of ``./cache_simulator <test_dir>`` (load traces, run to
quiescence, dump the golden state) plus synthetic workloads, schedule
knobs, metrics, invariant checks and the stall watchdog. State lives on
``device`` (None means the card; the CPU only when asked for).

The traced runs hand back the event record as numpy arrays on the host
(``utils.eventlog`` renders it). Checkpoints (``save``/``load``) are the
JAX package's format (``utils.checkpoint``): either package loads what
the other wrote.
"""

from __future__ import annotations

import dataclasses
import types
from typing import List, Optional, Sequence

import numpy as np

from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.models import workloads
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
    SIM_METRIC_FIELDS, SimState, init_state)
from ue22cs343bb1_openmp_assignment_tpu_torch.utils import (
    checkpoint, golden, trace)


# lint: host
def dump_view(state: SimState):
    """The dump fields of ``state`` as numpy arrays, the sharer words as
    uint32 (``golden.state_to_dumps`` joins them into one integer)."""
    view = {f: getattr(state, f).cpu().numpy()
            for f in ("memory", "dir_state", "cache_addr", "cache_val",
                      "cache_state")}
    view["dir_bitvec"] = state.dir_bitvec.cpu().numpy().view(np.uint32)
    return types.SimpleNamespace(**view)


@dataclasses.dataclass
class CoherenceSystem:
    """A configured message-level coherence machine with its state."""

    cfg: SystemConfig
    state: SimState

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_test_dir(cls, test_dir: str, cfg: Optional[SystemConfig] = None,
                      device=None, **init_kw) -> "CoherenceSystem":
        """Reference-format core_<n>.txt traces (assignment.c:806-851)."""
        cfg = cfg or SystemConfig.reference()
        traces = trace.load_test_dir(test_dir, cfg.num_nodes, cfg.max_instrs)
        return cls(cfg, init_state(cfg, traces, device=device, **init_kw))

    @classmethod
    def from_workload(cls, cfg: SystemConfig, name: str = "uniform",
                      trace_len: Optional[int] = None, seed: int = 0,
                      init_kw: Optional[dict] = None, device=None,
                      **gen_kw) -> "CoherenceSystem":
        """A synthetic workload (models.workloads) drawn from
        ``jax.random.PRNGKey(seed)``'s stream; init_kw goes to
        state.init_state (issue_delay / issue_period / arb_rank)."""
        trace_len = trace_len or cfg.max_instrs
        if trace_len != cfg.max_instrs:
            cfg = dataclasses.replace(cfg, max_instrs=trace_len)
        dev = _device.resolve(device)
        arrays = workloads.GENERATORS[name](seed, cfg, trace_len,
                                           device=dev, **gen_kw)
        return cls(cfg, init_state(cfg, instr_arrays=arrays, device=dev,
                                   **(init_kw or {})))

    @classmethod
    def from_traces(cls, cfg: SystemConfig, traces: Sequence,
                    device=None, **init_kw) -> "CoherenceSystem":
        return cls(cfg, init_state(cfg, list(traces), device=device,
                                   **init_kw))

    # -- execution ---------------------------------------------------------
    def step(self) -> "CoherenceSystem":
        """Advance one cycle."""
        return dataclasses.replace(self,
                                   state=step.cycle(self.cfg, self.state))

    def run(self, max_cycles: int = 100_000, chunk: int = 1,
            deliver_fn=None) -> "CoherenceSystem":
        """Run to quiescence, testing it every ``chunk`` cycles (1: stop
        exactly there, as the JAX ``run``); ``deliver_fn`` routes
        phase-3 delivery (parallel.rdma_comm.make_routed_deliver)."""
        final = step.run_chunked_to_quiescence(
            self.cfg, self.state, chunk, max_cycles, deliver_fn=deliver_fn)
        return dataclasses.replace(self, state=final)

    def run_cycles(self, n: int) -> "CoherenceSystem":
        return dataclasses.replace(
            self, state=step.run_cycles(self.cfg, self.state, n))

    def run_cycles_traced(self, n: int):
        """run_cycles and the event record: (system, events) with events
        a dict of [n, N] numpy arrays on the host."""
        state, ev = step.run_cycles_traced(self.cfg, self.state, n)
        return (dataclasses.replace(self, state=state),
                {k: v.cpu().numpy() for k, v in ev.items()})

    # lint: host
    def run_traced(self, max_cycles: int = 100_000, chunk: int = 64):
        """Run to quiescence collecting the event log in ``chunk``-cycle
        blocks: (system, events) with events a dict of [cycles, N] numpy
        arrays (``ops.step.run_cycles_traced``), {} if no block ran.

        Event rows are relative to the starting cycle (pass
        ``base_cycle=int(state.cycle)``, read before the run, to
        ``utils.eventlog`` for absolute cycles). ``max_cycles`` is an
        absolute cap on ``state.cycle``, as in ``run``; the last block is
        trimmed so the cap is exact. The run may pass quiescence by up to
        chunk - 1 cycles: a quiescent state is a fixpoint, so only the
        cycle counters advance and those cycles record no events."""
        state = self.state
        chunks = []
        while (not bool(state.quiescent())
               and int(state.cycle) < max_cycles):
            n = min(chunk, max_cycles - int(state.cycle))
            state, ev = step.run_cycles_traced(self.cfg, state, n)
            chunks.append({k: v.cpu().numpy() for k, v in ev.items()})
        events = ({k: np.concatenate([c[k] for c in chunks])
                   for k in chunks[0]} if chunks else {})
        return dataclasses.replace(self, state=state), events

    # -- observability -----------------------------------------------------
    @property
    def quiescent(self) -> bool:
        return bool(self.state.quiescent())

    @property
    def metrics(self) -> dict:
        m = self.state.metrics
        return {f: getattr(m, f).cpu().tolist() for f in SIM_METRIC_FIELDS}

    def dumps(self) -> List[str]:
        """Per-node printProcessorState dumps (byte-parity surface)."""
        return [golden.format_node_dump(d) for d in
                golden.state_to_dumps(self.cfg, dump_view(self.state))]

    def write_dumps(self, out_dir: str) -> List[str]:
        return golden.write_dumps(self.cfg, dump_view(self.state), out_dir)

    @property
    def instrs_retired(self) -> int:
        return int(self.state.metrics.instrs_retired)

    # -- failure detection -------------------------------------------------
    def stall_report(self, threshold: int = 100) -> dict:
        """Nodes blocked on one request for more than `threshold` cycles
        ({"count", "nodes"}); count 0 means healthy."""
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import failures
        return failures.stall_report(self.cfg, self.state, threshold)

    def stalled(self, threshold: int = 100) -> List[dict]:
        return self.stall_report(threshold)["nodes"]

    # -- invariant checking ------------------------------------------------
    def check_invariants(self, strict_coherence: bool = True) -> dict:
        """Engine invariants always assert; the coherence tier asserts
        when ``strict_coherence`` (race-free schedules) and is returned
        as a report otherwise. Returns the coherence counts when
        quiescent, else {}."""
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import invariants
        invariants.assert_invariants(self.cfg, self.state, quiescent=False)
        if not self.quiescent:
            return {}
        report = invariants.coherence_report(self.cfg, self.state)
        if strict_coherence and any(report.values()):
            raise AssertionError(
                f"coherence invariants violated: "
                f"{ {k: v for k, v in report.items() if v} }")
        return report

    def run_checked(self, num_cycles: int) -> "CoherenceSystem":
        """Advance summing the per-cycle invariant violations; raises on
        any."""
        from ue22cs343bb1_openmp_assignment_tpu_torch.ops import invariants
        state, acc = invariants.run_cycles_checked(self.cfg, self.state,
                                                   num_cycles)
        bad = {k: int(v) for k, v in acc.items() if int(v)}
        if bad:
            raise AssertionError(
                f"protocol invariants violated during run: {bad}")
        return dataclasses.replace(self, state=state)

    # -- persistence -------------------------------------------------------
    def save(self, path: str, meta: Optional[dict] = None) -> None:
        """Checkpoint the whole machine at the current cycle boundary."""
        checkpoint.save_checkpoint(path, self.cfg, self.state, meta)

    @classmethod
    def load(cls, path: str, device=None) -> "CoherenceSystem":
        """Resume from a checkpoint (of either package) on ``device``;
        bit-exact continuation."""
        cfg, state, meta = checkpoint.load_checkpoint(path, device=device)
        if meta.get("kind", "sim") != "sim":
            raise ValueError(
                f"{path} holds a SyncState (transactional engine) "
                "checkpoint; load it with TransactionalSystem.load")
        return cls(cfg, state)
