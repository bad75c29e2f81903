"""Seeded protocol bugs: the analysis gate's own regression suite.

The port of the JAX package's ``analysis/mutations.py``: the handler
mutations (:data:`MUTATIONS`), the consistency mutations
(:data:`CONSISTENCY_MUTATIONS`) and the table mutations
(:data:`TABLE_MUTATIONS`).

Each handler or consistency mutation wraps the real
:func:`..ops.handlers.message_phase` and perturbs exactly one transition
effect, keeping the ``message_phase`` contract (updates, cand_parts,
inv_scatter, stats). It is injected through ``ops/step.cycle``'s
``message_phase`` hook, so the engine around it (merge, delivery,
arbitration) stays the shipped code, and like the handlers it is plain
out-of-place tensor code that runs under ``torch.func.vmap``. ``cache-sim
analyze`` must exit 0 on the shipped handlers and 1 under every one of
them. The consistency mutations keep every per-state invariant and
corrupt only the values a program observes: the litmus enumeration
catches them. The table mutations perturb the declarative table, and
``verify_table`` catches them without running a cycle.

The kernel mutations (:data:`KERNEL_MUTATIONS`, JAX's three names) each
perturb a parameter the port's fused round or its gate really routes
with, and the ``--kernel`` prong (``analysis/kernelcheck``) must kill
each one statically at the headline config with its finding kind. The
CUDA round has no f32 exponent ladder, so the names keep JAX's and the
perturbations are the port's own (each docstring says which). The
index mutation (:data:`INDEX_MUTATIONS`) flips ``ops.step.
_PACKED_COMMIT`` to a bit-identical per-plane commit that only the
``--index`` prong (``analysis/indexcheck``) can see.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import codec
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import handlers
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.handlers import block_of
from ue22cs343bb1_openmp_assignment_tpu_torch.state import bit_single
from ue22cs343bb1_openmp_assignment_tpu_torch.types import DirState, Msg, Op


def _is(mv, ty):
    return mv.has_msg & (mv.type == int(ty))


def _lanes(cfg, mv):
    return torch.arange(cfg.num_nodes, dtype=torch.int32,
                        device=mv.type.device)


def skip_em_bitvec_clear(cfg, state, mv):
    """EVICT_MODIFIED still sets the directory Unowned but forgets to
    clear the owner's sharer bit (the reference clears it at
    ``assignment.c:615-616``). Expected: `unowned_with_sharers`
    engine-tier violation on every post-eviction state."""
    upd, cand, inv, stats = handlers.message_phase(cfg, state, mv)
    m, i, v = upd["dir_bv"]
    upd = dict(upd, dir_bv=(m & ~_is(mv, Msg.EVICT_MODIFIED), i, v))
    return upd, cand, inv, stats


def upgrade_keeps_other_sharers(cfg, state, mv):
    """UPGRADE grants EM ownership without shrinking the sharer set to
    the new owner (the reference overwrites the bitvector with the
    requester's bit, ``assignment.c:346-348``). Expected:
    `em_not_single_owner` engine-tier violation."""
    upd, cand, inv, stats = handlers.message_phase(cfg, state, mv)
    dirbv = state.dir_bitvec[_lanes(cfg, mv), block_of(cfg, mv.addr)]
    m, i, v = upd["dir_bv"]
    keep = _is(mv, Msg.UPGRADE)[:, None]
    upd = dict(upd, dir_bv=(m, i, torch.where(keep, v | dirbv, v)))
    return upd, cand, inv, stats


def no_wait_clear_on_reply_rd(cfg, state, mv):
    """REPLY_RD delivers the fill but never unblocks the requester
    (the reference clears ``waitingForReply`` in every reply handler,
    ``assignment.c:384``). Expected: `deadlock`, a terminal state with
    the reader still blocked. Must run on the read-only scope
    ``2n1a_r``: in the write scopes quirk 2 (FLUSH/FLUSH_INVACK clear
    `waiting` unconditionally) rescues the stranded reader."""
    upd, cand, inv, stats = handlers.message_phase(cfg, state, mv)
    upd = dict(upd,
               wait_clear=upd["wait_clear"] & ~_is(mv, Msg.REPLY_RD))
    return upd, cand, inv, stats


def drop_evict_modified(cfg, state, mv):
    """EVICT_MODIFIED is dequeued and then ignored entirely: no memory
    write-back, no directory update (the reference's handler at
    ``assignment.c:596-616``). Expected: `unhandled_pair` from the
    handler-engagement probe."""
    upd, cand, inv, stats = handlers.message_phase(cfg, state, mv)
    keep = ~_is(mv, Msg.EVICT_MODIFIED)
    cs_m, cs_v = upd["cache_state"]
    fl_m, fl_v = upd["cache_addr"]
    cv_m, cv_v = upd["cache_val"]
    mm, mi, mval = upd["mem"]
    dm, di, dv = upd["dir_state"]
    bm, bi, bv = upd["dir_bv"]
    upd = dict(upd,
               cache_state=(cs_m & keep, cs_v),
               cache_addr=(fl_m & keep, fl_v),
               cache_val=(cv_m & keep, cv_v),
               mem=(mm & keep, mi, mval),
               dir_state=(dm & keep, di, dv),
               dir_bv=(bm & keep, bi, bv),
               wait_clear=upd["wait_clear"] & keep)
    return upd, cand, inv, stats


def stale_owner_forward(cfg, state, mv):
    """READ_REQUEST on a dirty (EM) line replies straight from memory
    instead of forwarding WRITEBACK_INT to the owner (the reference
    forwards at ``assignment.c:277-286``), and registers the requester
    as a sharer while the directory still says EM. Expected:
    `em_not_single_owner`, two presence bits under an EM entry."""
    upd, cand, inv, stats = handlers.message_phase(cfg, state, mv)
    lanes = _lanes(cfg, mv)
    p_block = block_of(cfg, mv.addr)
    dirst = state.dir_state[lanes, p_block]
    dirbv = state.dir_bitvec[lanes, p_block]
    memv = state.memory[lanes, p_block]
    rr_em = (_is(mv, Msg.READ_REQUEST)
             & (lanes == codec.home_node(cfg, mv.addr))
             & (dirst == int(DirState.EM)))
    ty, recv, ad, val, sec, ds, bv = cand["pri"]
    cand = dict(cand, pri=(
        torch.where(rr_em, int(Msg.REPLY_RD), ty),
        torch.where(rr_em, mv.sender, recv), ad,
        torch.where(rr_em, memv, val),
        torch.where(rr_em, 0, sec), ds, bv))
    m, i, v = upd["dir_bv"]
    sender_bit = bit_single(cfg.bitvec_words, mv.sender)
    upd = dict(upd, dir_bv=(
        m | rr_em, i,
        torch.where(rr_em[:, None], dirbv | sender_bit, v)))
    return upd, cand, inv, stats


def evict_shared_keeps_bit(cfg, state, mv):
    """EVICT_SHARED at the home updates the directory state but never
    clears the evictor's presence bit (the reference drops it at
    ``assignment.c:566``). Expected: `unowned_with_sharers` when the
    last sharer leaves or `em_not_single_owner` when the survivor is
    promoted."""
    upd, cand, inv, stats = handlers.message_phase(cfg, state, mv)
    lanes = _lanes(cfg, mv)
    dirbv = state.dir_bitvec[lanes, block_of(cfg, mv.addr)]
    es_home = (_is(mv, Msg.EVICT_SHARED)
               & (lanes == codec.home_node(cfg, mv.addr)))
    m, i, v = upd["dir_bv"]
    upd = dict(upd, dir_bv=(
        m, i, torch.where(es_home[:, None], dirbv, v)))
    return upd, cand, inv, stats


# ---------------------------------------------------------------------------
# Consistency mutants: every per-state invariant stays happy; only the
# values a program observes are corrupted (the litmus enumeration's
# ``mp_reload`` / ``mp_upgrade`` shapes catch them).
# ---------------------------------------------------------------------------


def stale_fill_from_invalid(cfg, state, mv):
    """A read fill (REPLY_RD from the home, or the owner-forwarded
    FLUSH) that lands on a tag-matching (invalidated) resident line
    serves the stale local copy instead of the reply's data. Expected:
    `sc_cycle` and a forbidden ``mp_reload`` outcome."""
    upd, cand, inv, stats = handlers.message_phase(cfg, state, mv)
    lanes = _lanes(cfg, mv)
    cidx = codec.cache_index(cfg, mv.addr)
    stale = ((_is(mv, Msg.REPLY_RD) | _is(mv, Msg.FLUSH))
             & (state.cache_addr[lanes, cidx] == mv.addr)
             & state.waiting & (state.cur_addr == mv.addr)
             & (state.cur_op == int(Op.READ)))
    cv_m, cv_v = upd["cache_val"]
    upd = dict(upd, cache_val=(
        cv_m, torch.where(stale, state.cache_val[lanes, cidx], cv_v)))
    return upd, cand, inv, stats


def skip_inv_fanout(cfg, state, mv):
    """The write commits without its invalidation fan-out: REPLY_ID
    still grants EM ownership, but the sharer-set INVs are never sent
    (mailbox mode) / never applied (scatter mode). Old sharers keep
    valid stale copies and hit on them. Expected: `sc_cycle` and a
    forbidden ``mp_upgrade`` outcome."""
    upd, cand, inv, stats = handlers.message_phase(cfg, state, mv)
    if cand.get("inv") is not None and cand["inv"][0] is not None:
        ty, recv, ad = cand["inv"]
        cand = dict(cand, inv=(
            torch.full_like(ty, int(Msg.NONE)), recv, ad))
    if inv is not None:
        m, a, bv = inv
        inv = (m & False, a, bv)
    return upd, cand, inv, stats


#: name -> (wrapper, litmus test whose enumeration kills it, axioms
#: check the consistency oracle must raise, kill delays, kill periods);
#: the last three serve the fuzzer's consistency oracle (a later slice)
CONSISTENCY_MUTATIONS = {
    "stale_fill_from_invalid": (stale_fill_from_invalid, "mp_reload",
                                "sc_cycle", (2, 0), (0, 4)),
    "skip_inv_fanout": (skip_inv_fanout, "mp_upgrade",
                        "sc_cycle", (0, 0), (0, 12)),
}


# ---------------------------------------------------------------------------
# Table-level mutants: seeded bugs in the declarative protocol table,
# caught statically by verify_table. Each takes a ProtocolTable and
# returns a perturbed copy.
# ---------------------------------------------------------------------------

def table_guard_overlap(table):
    """Widen ``es_home_last``'s guard to all of EVICT_SHARED@home (drop
    the others=0 key): it now overlaps every other es_home_* row.
    Expected: `determinism_overlap`."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.analysis.protocol_table \
        import Guard
    rows = tuple(
        dataclasses.replace(r, guard=Guard(at_home=True))
        if r.name == "es_home_last" else r for r in table.rows)
    return dataclasses.replace(table, name=table.name + "+guard_overlap",
                               rows=rows)


def table_drop_row(table):
    """Delete the EVICT_MODIFIED row outright: a dirty eviction arrives
    and no rule fires. Expected: `totality_hole`."""
    rows = tuple(r for r in table.rows if r.name != "evict_modified")
    return dataclasses.replace(table, name=table.name + "+drop_row",
                               rows=rows)


# name -> (mutator, verify_table finding kind it must trigger)
TABLE_MUTATIONS = {
    "table_guard_overlap": (table_guard_overlap, "determinism_overlap"),
    "table_drop_row": (table_drop_row, "totality_hole"),
}



@contextlib.contextmanager
def widen_min_chunk():
    """Widen the claim key's slot field by one bit without giving the
    bit back in ``claim_max_rounds``: ``deep_engine.slot_bits`` (the
    lane key's layout in the plain round, and the kernel's SB) counts
    one more slot bit than ``sync_engine.claim_max_rounds`` budgets for.
    Looks like headroom for more slots; at the headline (one wave, 4096
    nodes) the fresh-key threshold ``(countdown + 1) << (pb + 2)``
    reaches 2**31 at round 0 and passes int32's sign bit, so every fresh
    key compares as stale. (JAX's mutant widens its f32 ladder's chunk;
    the CUDA round has no ladder.) Expected: `key_range` from the
    exactness pass."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import deep_engine
    old = deep_engine.slot_bits
    deep_engine.slot_bits = lambda cfg: old(cfg) + 1
    try:
        yield
    finally:
        deep_engine.slot_bits = old


@contextlib.contextmanager
def narrow_ladder_gap():
    """Narrow the requester-id field of DM_REQ (and of the fan-out's
    line word) from 16 to 12 bits: ``deep_engine.REQ_BITS``. Looks like
    room for a wider round-value channel; but SystemConfig admits
    deep-window machines of 65536 nodes, whose ids no longer fit, and
    at the headline's 4096 nodes node 4095 is the all-ones field, the
    read storm's "matches nobody" sentinel. (JAX's mutant narrows its
    ladder's exponent gap.) Expected: `field_width` from the exactness
    pass."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import deep_engine
    old = deep_engine.REQ_BITS
    deep_engine.REQ_BITS = 12
    try:
        yield
    finally:
        deep_engine.REQ_BITS = old


@contextlib.contextmanager
def lift_storm_gate():
    """Drop the read-storm structural gate from
    ``deep_round_kernel.supported``, as JAX's mutant drops it from
    ``pallas_round.supported``: the masks fit small storm configs, but
    the storm's duplicate commit rows and per-entry reader counts are
    outside the kernel (``csrc/deep_round.cu`` refuses ``DF_STORM``).
    Expected: `gate_divergence` from the gate pass (supported() says
    yes on the storm probe; the analyzer says no)."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_round_kernel as drk)
    old = drk.supported

    def patched(cfg):
        return cfg.deep_window and max(cfg.cache_size, 1 << cfg.block_bits,
                                       cfg.deep_slots) <= 32

    drk.supported = patched
    try:
        yield
    finally:
        drk.supported = old


#: name -> (context manager seeding the bug, kernelcheck finding kind
#: the --kernel prong must raise). All killed with trace=False: the
#: exactness and gate passes are integer arithmetic.
KERNEL_MUTATIONS = {
    "widen_min_chunk": (widen_min_chunk, "key_range"),
    "narrow_ladder_gap": (narrow_ladder_gap, "field_width"),
    "lift_storm_gate": (lift_storm_gate, "gate_divergence"),
}


@contextlib.contextmanager
def split_packed_scatter():
    """Flip ``ops.step._PACKED_COMMIT``: the cycle's commit becomes one
    gather and one ``index_put_`` a plane (cache_state/addr/val on one
    index vector, memory/dir_state/dir_bitvec on another), unset
    columns writing back their gathered old value. Bit-identical to the
    shipped one-hot commit: the model checker, the fuzzer, conformance
    and every golden dump stay green, but the index sites of
    step.cycle go from 23 to 35 and the per-plane scatters form the
    shared-index / distinct-destination pattern the merge detector
    names. Expected: `index_budget` from the --index prong's budget
    pass, plus merge candidates in step.cycle listing the split planes.
    Only the static index audit can see this mutant."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import step
    old = step._PACKED_COMMIT
    step._PACKED_COMMIT = False
    try:
        yield
    finally:
        step._PACKED_COMMIT = old


#: name -> (context manager seeding the bug, indexcheck finding kind
#: the --index prong must raise). Semantics-preserving by construction:
#: killed by the static inventory alone.
INDEX_MUTATIONS = {
    "split_packed_scatter": (split_packed_scatter, "index_budget"),
}


# name -> (wrapper, scope that exposes it, finding the checker must raise)
MUTATIONS = {
    "skip_em_bitvec_clear": (skip_em_bitvec_clear, "2n2a",
                             "unowned_with_sharers"),
    "upgrade_keeps_other_sharers": (upgrade_keeps_other_sharers, "2n1a",
                                    "em_not_single_owner"),
    "no_wait_clear_on_reply_rd": (no_wait_clear_on_reply_rd, "2n1a_r",
                                  "deadlock"),
    "drop_evict_modified": (drop_evict_modified, "2n2a",
                            "unhandled_pair"),
    "stale_owner_forward": (stale_owner_forward, "2n1a",
                            "em_not_single_owner"),
    "evict_shared_keeps_bit": (evict_shared_keeps_bit, "2n2a",
                               "unowned_with_sharers"),
}
