"""Protocol enumerations and message field layout.

Integer values mirror the reference enums so state dumps and differential
tests line up positionally:

* cache line states: ``assignment.c:17`` (MODIFIED, EXCLUSIVE, SHARED,
  INVALID) — the golden dump indexes a string table by this value
  (``assignment.c:855``).
* directory states: ``assignment.c:28`` (EM, S, U) — dump table at
  ``assignment.c:857``.
* transaction types: ``assignment.c:30-44`` (13 messages).

All are plain ints (not jnp arrays) so they fold into traced constants.
"""

from __future__ import annotations

import enum


class CacheState(enum.IntEnum):
    MODIFIED = 0
    EXCLUSIVE = 1
    SHARED = 2
    INVALID = 3
    # Variant-protocol states (analysis/protocol_table.py). Appended
    # after INVALID so the reference values 0-3 — and every dump/golden
    # that indexes by them — are untouched; INVALID stays the MESI
    # fill/reset sentinel. Only table-driven MOESI/MESIF phases emit
    # these; the range invariant (ops/invariants.py) admits them only
    # when cfg.protocol does.
    OWNED = 4     # MOESI: dirty but shared, owner responds instead of memory
    FORWARD = 5   # MESIF: clean designated forwarder among sharers


class DirState(enum.IntEnum):
    EM = 0  # exclusive-or-modified: block lives in exactly one cache
    S = 1   # shared: block lives in multiple caches
    U = 2   # unowned: block lives in no cache


class Msg(enum.IntEnum):
    """Transaction vocabulary (assignment.c:30-44)."""

    READ_REQUEST = 0    # requester -> home, on read miss
    WRITE_REQUEST = 1   # requester -> home, on write miss
    REPLY_RD = 2        # home -> requester, data for a read
    REPLY_WR = 3        # home -> requester, go-ahead for a write
    REPLY_ID = 4        # home -> requester, sharer id list
    INV = 5             # new owner -> sharers, invalidate
    UPGRADE = 6         # requester -> home, S write-hit promotion
    WRITEBACK_INV = 7   # home -> old owner, flush + invalidate
    WRITEBACK_INT = 8   # home -> old owner, flush + demote to shared
    FLUSH = 9           # old owner -> home (+ requester), data writeback
    FLUSH_INVACK = 10   # old owner -> home + requester, flush + inv-ack
    EVICT_SHARED = 11   # evictor -> home, shared/exclusive line replaced
    EVICT_MODIFIED = 12 # evictor -> home, dirty line replaced (with value)

    # Sentinel for an empty candidate/mailbox slot (never a real message).
    NONE = 13


CACHE_STATE_NAMES = ("MODIFIED", "EXCLUSIVE", "SHARED", "INVALID",
                     "OWNED", "FORWARD")
DIR_STATE_NAMES = ("EM", "S", "U")

MSG_NAMES = tuple(m.name for m in Msg if m is not Msg.NONE)


# Instruction opcodes ('R'/'W' bytes in the reference, assignment.c:51).
class Op(enum.IntEnum):
    READ = 0
    WRITE = 1
    NOP = 2   # padding beyond a node's trace length
