"""Table-handler conformance: prove the table equals the code.

The port of the JAX package's ``analysis/conformance.py``. The
declarative table (:mod:`.protocol_table`) claims to *be* the protocol
that :func:`..ops.handlers.message_phase` implements. This module closes
the loop with an exhaustive small-scope differential: explore a scope's
full (symmetry-reduced) state space, and at **every** reachable
transition run the staged concrete state through *both* the live handler
phase and the table-compiled phase inside the unmodified ``step.cycle``
engine (one ``torch.func.vmap`` over the batch for each), comparing the
complete post-``SimState``, every leaf, for bit equality. The first
divergence fails the gate with a replayable counterexample (event path
from the initial state + the differing leaves, named as the JAX
package's pytree paths name them, + both state renders).

Because the engine's merge makes unmasked update lanes and unaccepted
candidate slots unobservable, full-post-state equality over the whole
reachable space is exactly "the table and the handlers are the same
protocol on this scope".

The same sweep doubles as the table's dynamic audit: each message event
is matched against the table host-side (:func:`.protocol_table.
match_rows`) to record per-row firing coverage, verify exactly one row
matches every reachable receiver valuation, and check each fired row's
``assumes`` precondition.

:class:`ConformanceChecker` subclasses :class:`.model_check.
ModelChecker` for its staging, symmetry and read-back machinery; the
parent's single-phase oracle is never invoked.
"""

from __future__ import annotations

import numpy as np
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import model_check
from ue22cs343bb1_openmp_assignment_tpu_torch.analysis.model_check import (
    _BATCH, ModelChecker, Scope, ScopeTooLarge, enabled_events, to_host)
from ue22cs343bb1_openmp_assignment_tpu_torch.analysis.protocol_table import (
    ProtocolTable, guard_holds, host_atoms, match_rows, table_message_phase)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import handlers, step
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (SIM_LEAVES,
                                                            from_leaves,
                                                            state_leaves)


class ConformanceChecker(ModelChecker):
    """Differential BFS: reference phase vs table-compiled phase."""

    def __init__(self, scope: Scope, table: ProtocolTable,
                 message_phase=None, max_states: int = 50_000,
                 device=None, tally=None):
        super().__init__(scope, message_phase=message_phase,
                         max_states=max_states, device=device,
                         tally=tally)
        self.table = table
        ref_mp = message_phase if message_phase is not None \
            else handlers.message_phase
        tab_mp = table_message_phase(table)
        cfg = self.cfg

        def both(*leaves):
            state = from_leaves(leaves)
            return (state_leaves(step.cycle(cfg, state,
                                            message_phase=ref_mp)),
                    state_leaves(step.cycle(cfg, state,
                                            message_phase=tab_mp)))

        self._pair_oracle = torch.func.vmap(both)

    # -- helpers -----------------------------------------------------------

    def _pair_batch(self, batch: tuple) -> tuple:
        """Both phases' stepped batch, read back to the host as two
        {leaf name: [B, ...] numpy} dicts."""
        ref, tab = self._pair_oracle(*batch)
        self.count_batch()
        out = to_host({**{"ref" + k: v for k, v in zip(SIM_LEAVES, ref)},
                       **{"tab" + k: v for k, v in zip(SIM_LEAVES, tab)}})
        return ({k: out["ref" + k] for k in SIM_LEAVES},
                {k: out["tab" + k] for k in SIM_LEAVES})

    @staticmethod
    def _mismatch_rows(ref: dict, tab: dict, n: int):
        """Per-batch-row any-leaf-differs mask + per-row differing leaf
        names (full SimState compare, bit equality or bust). Leaves are
        labelled as the JAX package's ``keystr`` of the SimState pytree
        path labels them (``.cache_addr``, ``.metrics.cycles``)."""
        bad = np.zeros(n, bool)
        names: list = [[] for _ in range(n)]
        for name in SIM_LEAVES:
            la, lb = ref[name], tab[name]
            neq = (la != lb).reshape(la.shape[0], -1).any(axis=1)[:n]
            if neq.any():
                label = "." + name
                for j in np.flatnonzero(neq):
                    names[j].append(label)
                bad |= neq
        return bad, names

    def _audit_rows(self, a, actor: int, findings: list, coverage: dict,
                    sid: int, parent, states) -> None:
        """Host-side row matching for one message event: coverage +
        reachable-point totality/determinism + `assumes` validation."""
        atoms = host_atoms(self.cfg, a, actor, a.queues[actor][0])
        rows = match_rows(self.table, atoms)
        if len(rows) != 1:
            findings.append(dict(
                check="row_match", state=sid,
                detail=f"{len(rows)} table rows match a reachable "
                       f"receiver valuation {atoms} "
                       f"(rows: {[r.name for r in rows]})",
                path=self.path_to(parent, states, sid)))
            return
        row = rows[0]
        coverage[row.name] = coverage.get(row.name, 0) + 1
        if not guard_holds(row.assumes, atoms):
            findings.append(dict(
                check="assumes_violation", state=sid, row=row.name,
                detail=f"row {row.name} fired on a reachable state that "
                       f"falsifies its assumes precondition ({atoms})",
                path=self.path_to(parent, states, sid)))

    # -- the differential run ---------------------------------------------

    def run(self) -> dict:
        scope = self.scope
        a0 = self._a0
        ids = {a0: 0}
        states = [a0]
        parent = [None]
        findings: list = []
        coverage: dict = {}
        n_msg = n_instr = 0

        frontier = [0]
        diverged = False
        while frontier and not diverged:
            jobs = []
            for sid in frontier:
                jobs.extend((sid, ev)
                            for ev in enabled_events(scope, states[sid]))
            nxt = []
            for start in range(0, len(jobs), _BATCH):
                if diverged:
                    break
                chunk = jobs[start:start + _BATCH]
                batch = self._batched(
                    [self._stage(states[sid], ev) for sid, ev in chunk])
                res_ref, res_tab = self._pair_batch(batch)
                bad, leaf_names = self._mismatch_rows(
                    res_ref, res_tab, len(chunk))
                for j, (sid, ev) in enumerate(chunk):
                    if ev[0] == "msg":
                        n_msg += 1
                        self._audit_rows(states[sid], ev[1], findings,
                                         coverage, sid, parent, states)
                    else:
                        n_instr += 1
                    if bad[j]:
                        # first diverging transition: full counterexample
                        pa, _, _ = self._read_back(states[sid], ev,
                                                   res_ref, j)
                        pb, _, _ = self._read_back(states[sid], ev,
                                                   res_tab, j)
                        findings.append(dict(
                            check="divergence", state=sid,
                            event=self._render_event(states[sid], ev),
                            fields=leaf_names[j],
                            detail=f"handlers and table disagree after "
                                   f"{self._render_event(states[sid], ev)}"
                                   f" (leaves: {leaf_names[j]})",
                            path=self.path_to(parent, states, sid),
                            ref_render=self.render_state(pa),
                            table_render=self.render_state(pb)))
                        diverged = True
                        break
                    new_a, _, _ = self._read_back(states[sid], ev,
                                                  res_ref, j)
                    new_a, gi = self._canon(new_a)
                    nid = ids.get(new_a)
                    if nid is None:
                        nid = len(states)
                        ids[new_a] = nid
                        states.append(new_a)
                        parent.append((sid, ev, gi))
                        nxt.append(nid)
                        if nid >= self.max_states:
                            raise ScopeTooLarge(
                                f"scope {scope.name}: > {self.max_states} "
                                "states")
            frontier = nxt

        uncovered = sorted(r.name for r in self.table.rows
                           if r.name not in coverage)
        return dict(
            scope=scope.describe(),
            table=self.table.name,
            protocol=self.table.protocol,
            stats=dict(
                states=len(states),
                transitions=n_msg + n_instr,
                msg_events=n_msg,
                instr_events=n_instr,
                symmetry_group_order=len(self._group),
                rows_covered=len(coverage),
                rows_total=len(self.table.rows),
            ),
            row_coverage=dict(sorted(coverage.items())),
            uncovered_rows=uncovered,
            findings=findings,
            ok=not findings,
        )


def check_conformance(scope: Scope, table: ProtocolTable,
                      message_phase=None, max_states: int = 50_000,
                      device=None, tally=None) -> dict:
    """One-call convenience mirroring model_check.check_scope."""
    return ConformanceChecker(scope, table, message_phase=message_phase,
                              max_states=max_states, device=device,
                              tally=tally).run()


def variant_scope(scope: Scope, protocol: str) -> Scope:
    """The same scope with cfg.protocol swapped — for model-checking the
    MOESI/MESIF table phases through the unchanged engine."""
    import dataclasses
    return Scope(name=f"{scope.name}_{protocol}",
                 cfg=dataclasses.replace(scope.cfg, protocol=protocol),
                 programs=scope.programs,
                 mem_uniform=scope.mem_uniform)


def extra_scopes() -> dict:
    """Conformance-only scopes, beyond :func:`.model_check.
    builtin_scopes`.

    ``3n2a_ev`` — 3 nodes, two addresses conflicting on one
    direct-mapped line, a reader-evictor racing a reader-upgrader:
    drives every EVICT_SHARED home bookkeeping class (last sharer /
    self-promotion / notify-other / 2+ left), the UPGRADE S-write-hit
    grant, and the sanctioned INV tag-miss no-op — the rows the
    builtin scopes leave dark. 1267 states, exhaustive (trivial
    symmetry group: the three programs are distinct). Kept out of the
    builtin registry so the default ``analyze`` model-check wall-clock
    is unchanged; the union of builtin + extra scope coverage reaches
    every MESI row except the two bystander totality-completions
    (FLUSH/FLUSH_INVACK are only ever routed to home or second, so a
    true bystander delivery cannot occur — the rows exist to close
    the (at_home, at_second) guard product).
    """
    from ue22cs343bb1_openmp_assignment_tpu_torch import codec
    from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
    from ue22cs343bb1_openmp_assignment_tpu_torch.types import Op
    cfg3 = SystemConfig(num_nodes=3, cache_size=1, mem_size=2,
                        queue_capacity=16, max_instrs=4,
                        inv_mode="mailbox")
    a = codec.make_address(cfg3, 0, 0)
    b = codec.make_address(cfg3, 0, 1)
    R, W = int(Op.READ), int(Op.WRITE)
    sc = Scope("3n2a_ev", cfg3, (
        ((R, a, 0),),
        ((R, a, 0), (R, b, 0)),
        ((R, a, 0), (W, a, 6)),
    ))
    return {sc.name: sc}


def conformance_scopes() -> dict:
    """Everything the gate can run over: builtin + conformance-only."""
    scopes = dict(model_check.builtin_scopes())
    scopes.update(extra_scopes())
    return scopes


# referenced for the side effect of keeping the import explicit: the
# checker's scope registry is the conformance gate's scope registry
builtin_scopes = model_check.builtin_scopes
