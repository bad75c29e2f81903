"""Declarative protocol transition table (Murphi-style rule rows).

The port of the JAX package's ``analysis/protocol_table.py``. The
transition relation of ``ops/handlers.py`` (the reference's ``switch
(msg.type)``, ``assignment.c:190-618``) as *data*: a table of
:class:`Row` entries, each a guarded command

    ``(message type, guard over receiver-local predicates) -> effects``

in the rule-table style of Dill's Murphi. Three consumers:

* :mod:`.verify_table`: table-level static passes (totality,
  determinism, ownership conservation, stability, anchor cross-check)
  that need no simulation;
* :func:`table_message_phase`: compiles a table back into a torch
  ``message_phase`` with the exact contract of
  :func:`..ops.handlers.message_phase`, so the model checker and the
  serving waves run table-driven protocols (MESI/MOESI/MESIF) through
  the unmodified ``step.cycle``, under ``torch.func.vmap`` too;
* :mod:`.conformance`: the gate that proves :func:`mesi_table`
  bit-equivalent to the live handlers over whole small-scope state
  spaces.

The MESI table encodes the reference including its five documented
quirks (``ops/handlers.QUIRKS``): every row carries the ``assignment.c``
anchor it transcribes, cross-checked against
``ops/handlers.TRANSITION_ANCHORS``.

**Variant tables.** :func:`moesi_table` demotes a ``WRITEBACK_INT``-ed
owner to OWNED instead of SHARED; :func:`mesif_table` fills the
requester of a dirty line as FORWARD instead of SHARED. Both keep the
reference's write-through demotion (``FLUSH`` updates home memory,
``assignment.c:307``), so OWNED/FORWARD lines are clean and evict via
the ordinary ``EVICT_SHARED`` path.

Guard atoms are receiver-local (home/second role, tag match, directory
state, post-drop sharer count), so compiling a row never needs
information a node does not have. Sharer words are uint32 patterns in
int32, as everywhere in the port (``state.bit_single``/``ctz``/
``popcount``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import codec
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.handlers import (block_of,
                                                                   select)
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (bit_single, ctz,
                                                            popcount)
from ue22cs343bb1_openmp_assignment_tpu_torch.types import (CacheState,
                                                            DirState, Msg)

I32 = torch.int32

_M, _E, _S, _I = (int(CacheState.MODIFIED), int(CacheState.EXCLUSIVE),
                  int(CacheState.SHARED), int(CacheState.INVALID))
_O, _F = int(CacheState.OWNED), int(CacheState.FORWARD)
_EM, _DS, _U = int(DirState.EM), int(DirState.S), int(DirState.U)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Guard:
    """Conjunction of receiver-local predicates; ``None`` = don't-care.

    Set-valued atoms (``cache_state``/``dir_state``/``msg_dirstate``/
    ``others``) match membership; bool atoms match equality.
    ``others`` classifies the post-drop sharer count
    ``popcount(dir_bv & ~sender_bit)`` into ``"0"``/``"1"``/``"2+"``
    (the EVICT_SHARED home bookkeeping, ``assignment.c:559-589``);
    ``new_owner_self`` asks whether ``ctz`` of that set names the
    receiver itself (the self-promotion path, ``assignment.c:586``).
    """

    at_home: bool | None = None
    at_second: bool | None = None
    tag_match: bool | None = None
    home_is_second: bool | None = None
    new_owner_self: bool | None = None
    cache_state: tuple | None = None
    dir_state: tuple | None = None
    msg_dirstate: tuple | None = None
    others: tuple | None = None

    def atoms(self) -> tuple:
        """Names of the atoms this guard constrains."""
        return tuple(f.name for f in dataclasses.fields(self)
                     if getattr(self, f.name) is not None)


# enumeration domain per guard atom (verify_table's product spaces);
# cache_state's domain comes from ProtocolTable.cache_states
_BOOLS = (False, True)
ATOM_DOMAINS = {
    "at_home": _BOOLS,
    "at_second": _BOOLS,
    "tag_match": _BOOLS,
    "home_is_second": _BOOLS,
    "new_owner_self": _BOOLS,
    "dir_state": (_EM, _DS, _U),
    "msg_dirstate": (_EM, _DS, _U),
    "others": ("0", "1", "2+"),
}


# ---------------------------------------------------------------------------
# effects (action atoms)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheWrite:
    """Write the line at ``cache_index(addr)`` — blind by index, no tag
    check, exactly like the C (quirk 5). ``fill=True`` additionally
    installs the message address and a value (``value`` expr)."""

    state: int
    fill: bool = False
    value: str | None = None    # fill value expr: "msg.value" | "cur_val"


@dataclasses.dataclass(frozen=True)
class Replace:
    """Run handleCacheReplacement on the displaced line before a fill
    (``assignment.c:767-804``): emits EVICT_SHARED/EVICT_MODIFIED to the
    victim's home. ``checked=True`` fires only on a tag mismatch;
    ``False`` is REPLY_WR's unconditional call (``assignment.c:467``)."""

    checked: bool = True


@dataclasses.dataclass(frozen=True)
class DirWrite:
    """Write the directory entry for ``block_index(addr)`` in the
    receiver's own directory. ``state`` in {"EM","S","U"} or None
    (keep); ``bv`` a bitvector expr or None (keep)."""

    state: str | None = None
    bv: str | None = None


@dataclasses.dataclass(frozen=True)
class MemWrite:
    """home memory[block] := msg.value (assignment.c:307,520,602)."""


@dataclasses.dataclass(frozen=True)
class ClearWait:
    """Clear waitingForReply — unconditional where quirk 2 says so."""


@dataclasses.dataclass(frozen=True)
class Send:
    """Emit one candidate message. ``slot`` is the engine out-slot
    ("pri" = first sendMessage, "sec" = the secondReceiver copy);
    ``bitvec="others"`` attaches the sharers-minus-requester set
    (REPLY_ID payload in mailbox INV mode; the scatter-mode
    invalidation in scatter INV mode)."""

    slot: str
    type: int
    to: str
    value: str = "0"
    second: str = "0"
    dirstate: str = "EM"
    bitvec: str | None = None


@dataclasses.dataclass(frozen=True)
class InvFanout:
    """Source one INV per set bit of the message's carried sharer set
    (REPLY_ID at the requester, ``assignment.c:364-373``; mailbox INV
    mode only — scatter mode invalidates at the grant, handlers.py)."""


@dataclasses.dataclass(frozen=True)
class CountInval:
    """Count this firing in metrics.invalidations."""


@dataclasses.dataclass(frozen=True)
class Row:
    """One guarded command. ``anchor`` names the assignment.c lines the
    row transcribes (validated against handlers.TRANSITION_ANCHORS);
    ``quirks`` the reference-quirk ids it embodies (handlers.QUIRKS);
    ``assumes`` a precondition the row relies on for invariant
    preservation — not part of the match, verified dynamically by the
    conformance gate on every explored transition."""

    name: str
    msg: int
    guard: Guard
    effects: tuple
    anchor: str
    quirks: tuple = ()
    assumes: Guard = Guard()


@dataclasses.dataclass(frozen=True)
class ProtocolTable:
    """A complete protocol: rows + per-message guard domains.

    ``domains[msg]`` names the atoms that message's rows may key on —
    the product of their :data:`ATOM_DOMAINS` is the totality/
    determinism enumeration space (verify_table).
    """

    name: str
    protocol: str               # SystemConfig.protocol value
    rows: tuple
    domains: dict

    @property
    def cache_states(self) -> tuple:
        base = (_M, _E, _S, _I)
        if self.protocol == "moesi":
            return base + (_O,)
        if self.protocol == "mesif":
            return base + (_F,)
        return base

    def rows_for(self, msg: int) -> tuple:
        return tuple(r for r in self.rows if r.msg == int(msg))


# ---------------------------------------------------------------------------
# the MESI table: ops/handlers.py row by row
# ---------------------------------------------------------------------------

_DOMAINS = {
    int(Msg.READ_REQUEST): ("dir_state",),
    int(Msg.WRITE_REQUEST): ("dir_state",),
    int(Msg.REPLY_RD): ("msg_dirstate",),
    int(Msg.REPLY_WR): (),
    int(Msg.REPLY_ID): (),
    int(Msg.UPGRADE): (),
    int(Msg.INV): ("tag_match",),
    int(Msg.WRITEBACK_INT): ("home_is_second",),
    int(Msg.WRITEBACK_INV): (),
    int(Msg.FLUSH): ("at_home", "at_second"),
    int(Msg.FLUSH_INVACK): ("at_home", "at_second"),
    int(Msg.EVICT_SHARED): ("at_home", "others", "new_owner_self"),
    int(Msg.EVICT_MODIFIED): (),
}


def _mesi_rows(demote_state: int = _S, dirty_fill_state: int = _S) -> tuple:
    """The 29 rows of the reference protocol. ``demote_state`` is what a
    WRITEBACK_INT-ed owner drops to (SHARED; OWNED for MOESI);
    ``dirty_fill_state`` what the FLUSH fill installs at the requester
    of a dirty line (SHARED; FORWARD for MESIF)."""
    RR, WR = int(Msg.READ_REQUEST), int(Msg.WRITE_REQUEST)
    RRD, RWR, RID = int(Msg.REPLY_RD), int(Msg.REPLY_WR), int(Msg.REPLY_ID)
    INV, UPG = int(Msg.INV), int(Msg.UPGRADE)
    WBINV, WBINT = int(Msg.WRITEBACK_INV), int(Msg.WRITEBACK_INT)
    FL, FIA = int(Msg.FLUSH), int(Msg.FLUSH_INVACK)
    ES, EMSG = int(Msg.EVICT_SHARED), int(Msg.EVICT_MODIFIED)
    return (
        # -- READ_REQUEST (home's own directory, read blindly) ------------
        Row("rr_dirty_forward", RR, Guard(dir_state=(_EM,)),
            (Send("pri", WBINT, to="owner", value="0", second="sender"),),
            anchor="assignment.c:199-210", quirks=(4,)),
        Row("rr_shared_grant", RR, Guard(dir_state=(_DS,)),
            (Send("pri", RRD, to="sender", value="mem", dirstate="S"),
             DirWrite(bv="bv|sender")),
            anchor="assignment.c:211-236"),
        Row("rr_unowned_grant", RR, Guard(dir_state=(_U,)),
            (Send("pri", RRD, to="sender", value="mem", dirstate="EM"),
             DirWrite(state="EM", bv="sender")),
            anchor="assignment.c:211-236"),
        # -- REPLY_RD: fill keyed on the carried dirstate -----------------
        Row("reply_rd_fill_shared", RRD, Guard(msg_dirstate=(_DS,)),
            (Replace(checked=True),
             CacheWrite(_S, fill=True, value="msg.value"), ClearWait()),
            anchor="assignment.c:240-258"),
        Row("reply_rd_fill_excl", RRD, Guard(msg_dirstate=(_EM, _U)),
            (Replace(checked=True),
             CacheWrite(_E, fill=True, value="msg.value"), ClearWait()),
            anchor="assignment.c:240-258"),
        # -- WRITEBACK_INT: blind demote + flush; home==requester dedups --
        Row("wbint_demote_dedup", WBINT, Guard(home_is_second=True),
            (CacheWrite(demote_state),
             Send("pri", FL, to="home", value="cache.val",
                  second="msg.second")),
            anchor="assignment.c:262-281", quirks=(3, 5)),
        Row("wbint_demote", WBINT, Guard(home_is_second=False),
            (CacheWrite(demote_state),
             Send("pri", FL, to="home", value="cache.val",
                  second="msg.second"),
             Send("sec", FL, to="second", value="cache.val",
                  second="msg.second")),
            anchor="assignment.c:262-286", quirks=(5,)),
        # -- FLUSH: keyed on (home, second) roles; quirk-2 bystander ------
        Row("flush_home_only", FL, Guard(at_home=True, at_second=False),
            (DirWrite(state="S", bv="bv|second"), MemWrite(), ClearWait()),
            anchor="assignment.c:301-322", quirks=(2,)),
        Row("flush_fill", FL, Guard(at_home=False, at_second=True),
            (Replace(checked=True),
             CacheWrite(dirty_fill_state, fill=True, value="msg.value"),
             ClearWait()),
            anchor="assignment.c:310-322"),
        Row("flush_home_and_second", FL, Guard(at_home=True, at_second=True),
            (DirWrite(state="S", bv="bv|second"), MemWrite(),
             Replace(checked=True),
             CacheWrite(dirty_fill_state, fill=True, value="msg.value"),
             ClearWait()),
            anchor="assignment.c:301-322"),
        Row("flush_bystander", FL, Guard(at_home=False, at_second=False),
            (ClearWait(),),
            anchor="assignment.c:322", quirks=(2,)),
        # -- UPGRADE: unconditional grant (no dir-state key in the C) -----
        Row("upgrade_grant", UPG, Guard(),
            (Send("pri", RID, to="sender", bitvec="others"),
             DirWrite(state="EM", bv="sender")),
            anchor="assignment.c:326-348"),
        # -- REPLY_ID: fill MODIFIED from the latch + INV fan-out ---------
        Row("reply_id_fill", RID, Guard(),
            (Replace(checked=True),
             CacheWrite(_M, fill=True, value="cur_val"),
             InvFanout(), ClearWait()),
            anchor="assignment.c:352-384", quirks=(1,)),
        # -- INV: tag-checked kill; mismatch is the sanctioned no-op ------
        Row("inv_kill", INV, Guard(tag_match=True),
            (CacheWrite(_I), CountInval()),
            anchor="assignment.c:389-399"),
        Row("inv_miss_noop", INV, Guard(tag_match=False), (),
            anchor="assignment.c:389-399"),
        # -- WRITE_REQUEST: immediate dir update on all three (quirk 4) ---
        Row("wreq_dirty", WR, Guard(dir_state=(_EM,)),
            (Send("pri", WBINV, to="owner", value="msg.value",
                  second="sender"),
             DirWrite(state="EM", bv="sender")),
            anchor="assignment.c:440-457", quirks=(4,)),
        Row("wreq_shared", WR, Guard(dir_state=(_DS,)),
            (Send("pri", RID, to="sender", bitvec="others"),
             DirWrite(state="EM", bv="sender")),
            anchor="assignment.c:423-437"),
        Row("wreq_unowned", WR, Guard(dir_state=(_U,)),
            (Send("pri", RWR, to="sender"),
             DirWrite(state="EM", bv="sender")),
            anchor="assignment.c:407-421"),
        # -- REPLY_WR: unconditional replacement, fill from the latch -----
        Row("reply_wr_fill", RWR, Guard(),
            (Replace(checked=False),
             CacheWrite(_M, fill=True, value="cur_val"), ClearWait()),
            anchor="assignment.c:461-470", quirks=(1,)),
        # -- WRITEBACK_INV: blind kill + DOUBLE send, never deduped -------
        Row("wbinv_flush", WBINV, Guard(),
            (CacheWrite(_I),
             Send("pri", FIA, to="home", value="cache.val",
                  second="msg.second"),
             Send("sec", FIA, to="second", value="cache.val",
                  second="msg.second")),
            anchor="assignment.c:474-498", quirks=(3, 5)),
        # -- FLUSH_INVACK: home restores only the bitvector (never the
        #    state — the exclusive_line_dir_not_em quirk source); assumes
        #    the entry is still EM/S: after an EVICT_MODIFIED race has
        #    set it U, this row would resurrect a sharer bit under U
        #    (latent reference quirk; conformance validates the assume
        #    on every explored scope) ---------------------------------
        Row("fia_home_only", FIA, Guard(at_home=True, at_second=False),
            (DirWrite(bv="second"), MemWrite(), ClearWait()),
            anchor="assignment.c:510-535", quirks=(2, 4),
            assumes=Guard(dir_state=(_EM, _DS))),
        Row("fia_fill", FIA, Guard(at_home=False, at_second=True),
            (Replace(checked=True),
             CacheWrite(_M, fill=True, value="cur_val"), ClearWait()),
            anchor="assignment.c:522-535", quirks=(1,)),
        Row("fia_home_and_second", FIA, Guard(at_home=True, at_second=True),
            (DirWrite(bv="second"), MemWrite(),
             Replace(checked=True),
             CacheWrite(_M, fill=True, value="cur_val"), ClearWait()),
            anchor="assignment.c:510-535", quirks=(1, 2, 4),
            assumes=Guard(dir_state=(_EM, _DS))),
        Row("fia_bystander", FIA, Guard(at_home=False, at_second=False),
            (ClearWait(),),
            anchor="assignment.c:535", quirks=(2,)),
        # -- EVICT_SHARED: remote blind promotion; home keyed on the
        #    post-drop sharer count -----------------------------------
        Row("es_remote_promote", ES, Guard(at_home=False),
            (CacheWrite(_E),),
            anchor="assignment.c:549-558", quirks=(5,)),
        Row("es_home_last", ES, Guard(at_home=True, others=("0",)),
            (DirWrite(state="U", bv="bv-sender"),),
            anchor="assignment.c:559-565"),
        Row("es_home_promote_self", ES,
            Guard(at_home=True, others=("1",), new_owner_self=True),
            (DirWrite(state="EM", bv="bv-sender"), CacheWrite(_E)),
            anchor="assignment.c:566-589", quirks=(5,)),
        Row("es_home_promote_other", ES,
            Guard(at_home=True, others=("1",), new_owner_self=False),
            (DirWrite(state="EM", bv="bv-sender"),
             Send("pri", ES, to="new_owner", value="mem")),
            anchor="assignment.c:566-589"),
        Row("es_home_many", ES, Guard(at_home=True, others=("2+",)),
            (DirWrite(bv="bv-sender"),),
            anchor="assignment.c:559-589"),
        # -- EVICT_MODIFIED: write back + release ------------------------
        Row("evict_modified", EMSG, Guard(),
            (DirWrite(state="U", bv="empty"), MemWrite()),
            anchor="assignment.c:596-616"),
    )


@functools.lru_cache(maxsize=None)
def mesi_table() -> ProtocolTable:
    """The reference protocol, quirks and all (the conformance gate
    proves this table bit-equivalent to ops/handlers.py)."""
    return ProtocolTable("mesi", "mesi", _mesi_rows(), dict(_DOMAINS))


@functools.lru_cache(maxsize=None)
def moesi_table() -> ProtocolTable:
    """MOESI: a WRITEBACK_INT-ed owner keeps its line as OWNED instead
    of SHARED (write-through O — see module docstring)."""
    return ProtocolTable("moesi", "moesi", _mesi_rows(demote_state=_O),
                         dict(_DOMAINS))


@functools.lru_cache(maxsize=None)
def mesif_table() -> ProtocolTable:
    """MESIF: the requester that pulls a dirty line fills as FORWARD —
    the newest copy is the designated forwarder (clean, so it evicts
    via EVICT_SHARED like SHARED does)."""
    return ProtocolTable("mesif", "mesif", _mesi_rows(dirty_fill_state=_F),
                         dict(_DOMAINS))


TABLES = {"mesi": mesi_table, "moesi": moesi_table, "mesif": mesif_table}


# ---------------------------------------------------------------------------
# host-side row matching (conformance row coverage + assumes validation)
# ---------------------------------------------------------------------------

def host_atoms(cfg: SystemConfig, a, receiver: int, msg: tuple) -> dict:
    """Guard-atom valuation for `receiver` processing `msg` in abstract
    state `a` (an analysis.model_check.AState). Pure Python — the
    reference semantics of every atom in :class:`Guard`."""
    t, sender, addr, _value, second, ds, _bv = msg
    home = codec.home_node(cfg, addr)
    cidx = codec.cache_index(cfg, addr)
    block = codec.block_index(cfg, addr)
    # the post-drop sharer set the handlers branch on is the RECEIVER'S
    # directory entry, not the message's carried bitvector (which is
    # nonzero only for REPLY_ID grants)
    others = a.dir_bitvec[receiver][block] & ~(1 << sender)
    nsh = bin(others).count("1")
    new_owner = (others & -others).bit_length() - 1 if others else -1
    return {
        "msg": t,
        "at_home": receiver == home,
        "at_second": receiver == second,
        "tag_match": a.cache_addr[receiver][cidx] == addr,
        "home_is_second": home == second,
        "new_owner_self": new_owner == receiver,
        "cache_state": a.cache_state[receiver][cidx],
        "dir_state": a.dir_state[receiver][block],
        "msg_dirstate": ds,
        "others": "0" if nsh == 0 else ("1" if nsh == 1 else "2+"),
    }


def guard_holds(g: Guard, atoms: dict) -> bool:
    for name in g.atoms():
        want = getattr(g, name)
        have = atoms[name]
        if isinstance(want, tuple):
            if have not in want:
                return False
        elif have != want:
            return False
    return True


def match_rows(table: ProtocolTable, atoms: dict) -> list:
    """All rows whose (msg, guard) match the valuation — exactly one on
    a table that passed totality+determinism."""
    return [r for r in table.rows
            if r.msg == atoms["msg"] and guard_holds(r.guard, atoms)]


# ---------------------------------------------------------------------------
# the compiler: table -> torch message_phase
# ---------------------------------------------------------------------------

def _any(masks, template):
    if not masks:
        return torch.zeros_like(template, dtype=torch.bool)
    return functools.reduce(lambda x, y: x | y, masks)


def table_message_phase(table: ProtocolTable):
    """Compile `table` into a ``message_phase(cfg, state, mv)`` with the
    exact contract of :func:`..ops.handlers.message_phase`.

    Bit-exactness contract: at every *observable* position (masked
    update lanes, accepted candidate slots, stats masks) the compiled
    phase computes the same int32 values the hand-written handlers do;
    the engine never reads unmasked lanes or unaccepted slots (ops/step.py
    merge, ops/mailbox.py deliver). The conformance gate checks this over
    whole scope state spaces. The phase is plain out-of-place tensor
    code with no host read, so it runs under ``torch.func.vmap`` (the
    model checker's oracle, the serving waves); the Python loops run
    over the table's static rows only.
    """
    rows = table.rows

    def phase(cfg: SystemConfig, state, mv):
        N, W = cfg.num_nodes, cfg.bitvec_words
        dev = mv.type.device
        lanes = torch.arange(N, dtype=I32, device=dev)
        has, t = mv.has_msg, mv.type

        p_home = codec.home_node(cfg, mv.addr)
        p_block = block_of(cfg, mv.addr)
        p_cidx = codec.cache_index(cfg, mv.addr)

        dirst = state.dir_state[lanes, p_block]
        dirbv = state.dir_bitvec[lanes, p_block]
        memv = state.memory[lanes, p_block]
        cl_addr = state.cache_addr[lanes, p_cidx]
        cl_val = state.cache_val[lanes, p_cidx]
        cl_state = state.cache_state[lanes, p_cidx]

        sender_bit = bit_single(W, mv.sender)
        second_bit = bit_single(W, mv.second)
        bv_others = dirbv & ~sender_bit
        nsh = popcount(bv_others)
        new_owner = ctz(bv_others)

        at_home = lanes == p_home
        at_second = lanes == mv.second
        tag_match = cl_addr == mv.addr
        home_is_second = p_home == mv.second
        new_owner_self = new_owner == lanes

        def const(v):
            return torch.full((N,), int(v), dtype=I32, device=dev)

        zero = const(0)
        none = const(Msg.NONE)
        zbv = torch.zeros((N, cfg.msg_bitvec_words), dtype=I32, device=dev)
        false = torch.zeros((N,), dtype=torch.bool, device=dev)

        def cset(values, x):
            m = false
            for v in values:
                m = m | (x == int(v))
            return m

        def others_in(classes):
            m = false
            for c in classes:
                m = m | ((nsh == 0) if c == "0" else
                         (nsh == 1) if c == "1" else (nsh >= 2))
            return m

        def guard_mask(row: Row):
            g = row.guard
            m = has & (t == row.msg)
            for atom, pred in (("at_home", at_home),
                               ("at_second", at_second),
                               ("tag_match", tag_match),
                               ("home_is_second", home_is_second),
                               ("new_owner_self", new_owner_self)):
                want = getattr(g, atom)
                if want is not None:
                    m = m & (pred if want else ~pred)
            if g.cache_state is not None:
                m = m & cset(g.cache_state, cl_state)
            if g.dir_state is not None:
                m = m & cset(g.dir_state, dirst)
            if g.msg_dirstate is not None:
                m = m & cset(g.msg_dirstate, mv.dirstate)
            if g.others is not None:
                m = m & others_in(g.others)
            return m

        masks = {r.name: guard_mask(r) for r in rows}

        val_exprs = {"0": zero, "msg.value": mv.value, "mem": memv,
                     "cache.val": cl_val, "cur_val": state.cur_val}
        recv_exprs = {"sender": mv.sender, "home": p_home,
                      "owner": ctz(dirbv), "second": mv.second,
                      "new_owner": new_owner}
        second_exprs = {"0": zero, "sender": mv.sender,
                        "msg.second": mv.second}
        ds_exprs = {"EM": const(_EM), "S": const(_DS), "U": const(_U)}
        bv_exprs = {"bv|sender": dirbv | sender_bit,
                    "bv|second": dirbv | second_bit,
                    "sender": sender_bit, "second": second_bit,
                    "bv-sender": bv_others,
                    "empty": torch.zeros_like(dirbv)}

        def gather(kind):
            """(mask, effect, row) triples for one effect class."""
            return [(masks[r.name], e, r) for r in rows for e in r.effects
                    if isinstance(e, kind)]

        def sel(triples, value_of, default):
            """``jnp.select``: the first matching row's value wins."""
            if not triples:
                return default
            return select([m for m, _, _ in triples],
                          [value_of(e, r) for _, e, r in triples], default)

        # ---- cache writes -------------------------------------------------
        cwrites = gather(CacheWrite)
        fills = [(m, e, r) for m, e, r in cwrites if e.fill]
        fill_mask = _any([m for m, _, _ in fills], false)
        fill_val = sel(fills, lambda e, r: val_exprs[e.value], zero)
        cs_mask = _any([m for m, _, _ in cwrites], false)
        cs_val = sel(cwrites, lambda e, r: const(e.state), const(_I))

        # ---- replacement of the displaced line ---------------------------
        repl = gather(Replace)
        checked = _any([m for m, e, _ in repl if e.checked], false)
        uncond = _any([m for m, e, _ in repl if not e.checked], false)
        evict_fire = ((checked & (cl_addr != mv.addr) & (cl_state != _I))
                      | (uncond & (cl_state != _I)))

        # ---- directory writes --------------------------------------------
        dwrites = gather(DirWrite)
        ds_rows = [(m, e, r) for m, e, r in dwrites if e.state is not None]
        bv_rows = [(m, e, r) for m, e, r in dwrites if e.bv is not None]
        ds_mask = _any([m for m, _, _ in ds_rows], false)
        ds_val = sel(ds_rows, lambda e, r: ds_exprs[e.state], const(_U))
        dbv_mask = _any([m for m, _, _ in bv_rows], false)
        dbv_val = sel([(m[:, None], e, r) for m, e, r in bv_rows],
                      lambda e, r: bv_exprs[e.bv], torch.zeros_like(dirbv))

        # ---- memory / waiting --------------------------------------------
        mem_mask = _any([m for m, _, _ in gather(MemWrite)], false)
        wait_clear = _any([m for m, _, _ in gather(ClearWait)], false)

        updates = dict(
            cache_idx=p_cidx, cache_state=(cs_mask, cs_val),
            cache_addr=(fill_mask, mv.addr), cache_val=(fill_mask, fill_val),
            mem=(mem_mask, p_block, mv.value),
            dir_state=(ds_mask, p_block, ds_val),
            dir_bv=(dbv_mask, p_block, dbv_val),
            wait_clear=wait_clear,
        )

        # ---- candidate out-messages --------------------------------------
        sends = gather(Send)
        pri = [(m, e, r) for m, e, r in sends if e.slot == "pri"]
        sec = [(m, e, r) for m, e, r in sends if e.slot == "sec"]
        pri_mask = _any([m for m, _, _ in pri], false)
        pri_type = torch.where(pri_mask,
                               sel(pri, lambda e, r: const(e.type), none),
                               none)
        pri_recv = sel(pri, lambda e, r: recv_exprs[e.to], zero)
        pri_value = sel(pri, lambda e, r: val_exprs[e.value], zero)
        pri_second = sel(pri, lambda e, r: second_exprs[e.second], zero)
        pri_dirstate = sel(pri, lambda e, r: ds_exprs[e.dirstate],
                           const(_EM))
        grants = _any([m for m, e, _ in pri if e.bitvec == "others"], false)
        if cfg.inv_mode == "mailbox":
            pri_bitvec = torch.where(grants[:, None], bv_others, zbv)
        else:
            pri_bitvec = zbv

        sec_mask = _any([m for m, _, _ in sec], false)
        sec_type = torch.where(sec_mask,
                               sel(sec, lambda e, r: const(e.type), none),
                               none)
        sec_recv = sel(sec, lambda e, r: recv_exprs[e.to], zero)
        sec_value = sel(sec, lambda e, r: val_exprs[e.value], zero)
        sec_second = sel(sec, lambda e, r: second_exprs[e.second], zero)

        fan_mask = _any([m for m, _, _ in gather(InvFanout)], false)
        if cfg.inv_mode == "mailbox":
            targets = torch.arange(N, dtype=I32, device=dev)
            tw = torch.div(targets, 32, rounding_mode="floor").to(
                torch.int64)
            bits = (mv.bitvec[:, tw] >> (targets % 32)[None, :]) & 1
            inv_mask = fan_mask[:, None] & (bits == 1)
            inv_type = torch.where(inv_mask, int(Msg.INV),
                                   int(Msg.NONE)).to(I32)
            inv_recv = targets[None, :].expand(N, N)
            inv_addr = mv.addr[:, None].expand(N, N)
            inv_scatter = None
        else:
            inv_type = inv_recv = inv_addr = None
            inv_scatter = (grants, mv.addr, bv_others)

        ev_mod = evict_fire & (cl_state == _M)
        ev_type = torch.where(
            evict_fire,
            torch.where(ev_mod, int(Msg.EVICT_MODIFIED),
                        int(Msg.EVICT_SHARED)).to(I32),
            none)
        ev_recv = codec.home_node(cfg, cl_addr)
        ev_value = torch.where(ev_mod, cl_val, 0)

        cand_parts = dict(
            pri=(pri_type, pri_recv, mv.addr, pri_value, pri_second,
                 pri_dirstate, pri_bitvec),
            sec=(sec_type, sec_recv, mv.addr, sec_value, sec_second),
            inv=(inv_type, inv_recv, inv_addr),
            ev=(ev_type, ev_recv, cl_addr, ev_value),
        )

        stats = dict(
            msg_type_onehot=(has, t),
            invalidations=_any([m for m, _, _ in gather(CountInval)], false),
            evictions=evict_fire,
            unblocked=wait_clear & state.waiting,
        )
        return updates, cand_parts, inv_scatter, stats

    phase.__name__ = f"table_message_phase[{table.name}]"
    return phase
