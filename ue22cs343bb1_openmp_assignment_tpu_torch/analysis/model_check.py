"""Small-scope explicit-state model checker for the coherence protocol.

The port of the JAX package's ``analysis/model_check.py``. The dynamic
checker (ops/invariants.py) judges only the states a particular workload
happens to reach. This pass gives the complementary *static* guarantee
over tiny configurations: enumerate EVERY state a 2-4-node, 1-2-address
machine can reach under ALL message interleavings, and verify the
protocol on the whole graph. The transition oracle is the *shipped
engine itself*: each explored transition stages a concrete
:class:`~..state.SimState` and runs one real ``ops.step.cycle`` (so
``ops/handlers.py`` + ``ops/frontend.py`` are the checked artifact, never
a re-model of them). Transitions are staged ``_BATCH`` at a time and
stepped by one ``torch.func.vmap`` of ``cycle`` on the oracle's device
(the card unless ``device="cpu"``); the search itself (symmetry, BFS,
Tarjan SCCs, path rendering, the report) is host Python, copied from the
JAX module, and every number in a report is a Python int or bool.

**Interleaving semantics.** One node acts per step: either it dequeues
and handles its head message, or (empty queue, not blocked, trace
remaining) it fetches one instruction. Node isolation uses the engine's
own schedule gate: the acting node gets ``issue_delay=0``, everyone else
``issue_delay=BIG`` (and only the acting node's queue is staged), so
exactly one node moves per oracle call.

**Checks.** Handler coverage (every dequeued (message, receiver-state)
pair must engage the handler matrix, unless it is the sanctioned INV
tag-miss no-op), the engine-tier invariants
(:func:`..ops.invariants.step_predicates`) on every reachable state, the
coherence tier (:func:`..ops.invariants.quiescent_predicates`) at every
quiescent terminal state with the reference's sanctioned quirks in
:data:`QUIRK_ALLOWLIST`, and progress: no deadlock, and no livelock
(Tarjan SCCs with no path to a terminal state, with a lasso witness).

**Symmetry reduction (Murphi-style, Ip & Dill).** Node ids and memory
blocks are scalarsets: any node permutation composed with a
cache-index-preserving block permutation that maps the programs and the
initial state onto themselves is an automorphism of the transition
graph; the checker stores only the lexicographic minimum of each
successor's orbit, and counterexample paths un-permute each edge on the
way out so rendered witnesses are concrete runs.

analysis/mutations.py seeds handler bugs this checker must catch.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import codec
from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (handlers,
                                                          invariants, step)
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
    LAT_BUCKETS, MB_BV0, MB_TYPE, SIM_LEAVES, from_leaves, init_state,
    state_leaves)
from ue22cs343bb1_openmp_assignment_tpu_torch.types import (
    CACHE_STATE_NAMES, DIR_STATE_NAMES, CacheState, DirState, Msg, Op)

# blocks the frontend issue gate for non-acting nodes (state.issue_delay)
BIG_DELAY = 1 << 20
# fixed oracle batch width: every vmapped call shares one compilation
_BATCH = 64

# Coherence-tier findings the *reference protocol itself* produces at
# quiescence — reported, never silenced, and never counted as failures.
# Root cause for all of them: the protocol tracks no INV-acks
# (``assignment.c:358-361``), so an INV that races an in-flight fill can
# be processed first (tag mismatch -> sanctioned no-op), after which the
# fill installs a copy the directory no longer knows about; the
# blind-by-index WRITEBACK handlers (quirk 5, ``assignment.c:558,586``)
# can similarly resurrect a stale line. Both orderings are legal
# reference behavior (SURVEY §4's accepted run_* variants).
QUIRK_ALLOWLIST = {
    "valid_line_unknown_to_home":
        "stale copy from the unacked-INV race: the directory dropped "
        "this sharer while its fill was in flight (assignment.c:358-361)",
    "phantom_sharers":
        "copy census vs directory popcount disagrees wherever a stale "
        "line survives the unacked-INV race",
    "owner_with_other_copies":
        "the new owner coexists with the stale copy the unacked INV "
        "failed to kill (assignment.c:358-361)",
    "clean_line_stale_value":
        "a stale SHARED copy keeps the pre-race value after home memory "
        "moved on (the reference would serve the same stale read)",
    "shared_line_dir_unowned":
        "stale SHARED copy outliving its directory entry "
        "(EVICT/INV race; blind-by-index writes, quirk 5)",
    "exclusive_line_dir_not_em":
        "directory-update timing (quirk 4): a stale FLUSH from a "
        "superseded WRITEBACK_INT demotes the directory to S after a "
        "racing write already granted EM, and the FLUSH_INVACK home "
        "handler restores only the bitvector, never the state "
        "(assignment.c:199-210,455-457,510-529)",
}


class ScopeTooLarge(RuntimeError):
    """Raised when a scope's reachable graph exceeds max_states."""


@dataclasses.dataclass(frozen=True)
class Scope:
    """One model-checking configuration: dimensions + per-node programs."""

    name: str
    cfg: SystemConfig
    programs: tuple  # per node: tuple of (Op, addr, value)
    # node-symmetric initial memory (block i of every node starts i&0xFF)
    # instead of the reference's node-asymmetric 20*t+i pattern — required
    # for any scope that wants a nontrivial symmetry group
    mem_uniform: bool = False

    def __post_init__(self):
        if self.cfg.bitvec_words != 1 or self.cfg.msg_bitvec_words != 1:
            raise ValueError("scopes assume 1-word sharer bitvectors")
        if self.cfg.inv_mode != "mailbox":
            raise ValueError("scopes drive the exact-reference mailbox "
                             "INV path")
        if len(self.programs) != self.cfg.num_nodes:
            raise ValueError("need exactly one program per node")
        if max(len(p) for p in self.programs) > self.cfg.max_instrs:
            raise ValueError("program longer than cfg.max_instrs")

    def describe(self) -> dict:
        return {
            "name": self.name,
            "num_nodes": self.cfg.num_nodes,
            "cache_size": self.cfg.cache_size,
            "mem_size": self.cfg.mem_size,
            "mem_init": "uniform" if self.mem_uniform else "reference",
            "programs": [[[Op(op).name, int(a), int(v)] for op, a, v in p]
                         for p in self.programs],
        }


def builtin_scopes() -> dict:
    """The shipped small scopes (all addresses home on node 0).

    * ``2n1a`` — 2 nodes, one address, read/write races on it: the
      READ/WRITE_REQUEST, REPLY_*, WRITEBACK_*, FLUSH*, UPGRADE and INV
      paths, including every home==requester dedup quirk.
    * ``2n2a`` — 2 nodes, two addresses conflicting on one direct-mapped
      line: adds the EVICT_SHARED / EVICT_MODIFIED replacement paths.
    * ``3n1a`` — 3 nodes, one address: multi-sharer directory states,
      REPLY_ID fan-out to >1 sharer, EVICT_SHARED owner promotion.
    * ``2n1a_r`` — 2 nodes, one remote-homed address, reads only. The
      liveness scope: in the write scopes a lost reply-unblock is
      masked by quirk 2 (FLUSH/FLUSH_INVACK clear `waiting`
      unconditionally, ``assignment.c:322,535``), so write traffic
      rescues a stranded reader; with reads only, every reply must do
      its own unblocking or the checker sees a deadlock.
    * ``4n1a_sym`` — 4 nodes, one address, one writer racing THREE
      readers: deeper REPLY_ID fan-out, three-way unacked-INV races,
      multi-sharer EVICT promotion chains. Only tractable under the
      state cap because the three readers are interchangeable: the
      S3 automorphism group over nodes {1,2,3} (order 6) folds their
      interleavings into one orbit representative each.
    * ``2n2h`` — 2 nodes, TWO homed addresses (one per node), each
      node writing the remote-homed block then reading its own: both
      directories active at once, crossing request/reply traffic,
      write-miss-on-remote + read-after-invalidate on every
      interleaving. The swap (σ=(01) with the two addresses exchanged)
      is an automorphism — the scope is checked modulo that mirror.
    """
    cfg2 = SystemConfig(num_nodes=2, cache_size=1, mem_size=2,
                        queue_capacity=16, max_instrs=4, inv_mode="mailbox")
    a = codec.make_address(cfg2, 0, 0)
    b = codec.make_address(cfg2, 0, 1)
    r = codec.make_address(cfg2, 1, 0)
    cfg3 = SystemConfig(num_nodes=3, cache_size=1, mem_size=2,
                        queue_capacity=16, max_instrs=4, inv_mode="mailbox")
    a3 = codec.make_address(cfg3, 0, 0)
    cfg4 = SystemConfig(num_nodes=4, cache_size=1, mem_size=2,
                        queue_capacity=16, max_instrs=4, inv_mode="mailbox")
    a4 = codec.make_address(cfg4, 0, 0)
    R, W = int(Op.READ), int(Op.WRITE)
    scopes = [
        Scope("2n1a", cfg2, (
            ((R, a, 0), (W, a, 5)),
            ((W, a, 7), (R, a, 0)),
        )),
        Scope("2n2a", cfg2, (
            ((W, a, 3), (R, b, 0), (R, a, 0)),
            ((W, b, 9), (R, a, 0)),
        )),
        Scope("3n1a", cfg3, (
            ((R, a3, 0),),
            ((R, a3, 0),),
            ((W, a3, 4),),
        )),
        Scope("2n1a_r", cfg2, (
            ((R, r, 0),),
            ((R, r, 0),),
        )),
        Scope("4n1a_sym", cfg4, (
            ((W, a4, 5),),
            ((R, a4, 0),),
            ((R, a4, 0),),
            ((R, a4, 0),),
        ), mem_uniform=True),
        Scope("2n2h", cfg2, (
            ((W, r, 5), (R, a, 0)),
            ((W, a, 5), (R, r, 0)),
        ), mem_uniform=True),
    ]
    return {s.name: s for s in scopes}


@dataclasses.dataclass(frozen=True)
class AState:
    """Canonical (hashable) abstraction of one machine state.

    Everything transition-relevant and nothing else: cache/memory/
    directory contents, per-node trace position, block flag, the
    latched in-flight instruction (quirk 1 fills read it — and quirk 2
    can clear `waiting` with the reply still in flight, so the latch
    matters even for non-waiting nodes), and per-node FIFO message
    queues. Excluded as observationally irrelevant: cycle counters,
    metrics, waiting_since, mailbox ring phase (head position).
    """

    cache_addr: tuple   # [N][C]
    cache_val: tuple
    cache_state: tuple
    memory: tuple       # [N][M]
    dir_state: tuple
    dir_bitvec: tuple   # [N][M] ints (single u32 word)
    instr_idx: tuple    # [N]
    waiting: tuple      # [N] bool
    cur_op: tuple       # [N]
    cur_addr: tuple
    cur_val: tuple
    queues: tuple       # [N] tuples of (type, sender, addr, value,
                        #                second, dirstate, bv_word)
    # per-node tuple of observed READ values in program order — the
    # litmus "registers". Empty (the default) outside litmus mode;
    # ModelChecker(track_obs=True) seeds it with N empty tuples and
    # appends at each read-retire boundary. Part of state identity:
    # outcomes are PATH properties, so two machine states that differ
    # only in what their reads already returned must not merge.
    obs: tuple = ()


def _t2(arr) -> tuple:
    return tuple(tuple(int(x) for x in row) for row in np.asarray(arr))


def _t1(arr) -> tuple:
    return tuple(int(x) for x in np.asarray(arr))



def enabled_events(scope: Scope, a: AState) -> list:
    """Events runnable from `a`: per node, dequeue-one-message XOR
    fetch-one-instruction — the reference's drain-first priority
    (``assignment.c:165-177,624-629``) per node."""
    evs = []
    for n in range(scope.cfg.num_nodes):
        if a.queues[n]:
            evs.append(("msg", n))
        elif not a.waiting[n] and a.instr_idx[n] < len(scope.programs[n]) - 1:
            evs.append(("instr", n))
    return evs


# ---------------------------------------------------------------------------
# symmetry: node/address permutation automorphisms
# ---------------------------------------------------------------------------

# message types whose `second` field carries a live node id (the
# original requester); every other handler leaves/reads it as literal 0
# (handlers.py pri_second/sec_second selects), so permuting a dead field
# would fabricate states the engine never produces
_SECOND_LIVE = frozenset((int(Msg.WRITEBACK_INT), int(Msg.WRITEBACK_INV),
                          int(Msg.FLUSH), int(Msg.FLUSH_INVACK)))


@dataclasses.dataclass(frozen=True)
class _Perm:
    """One automorphism: node permutation σ + block permutation β.

    ``amap`` is the induced address map (home(addr) through σ, block
    through β); β is constrained to preserve cache_index so a line
    never changes its direct-mapped slot under the action.
    """

    sig: tuple        # σ[n] = image of node n
    inv_sig: tuple
    beta: tuple       # β[b] = image of block b
    inv_beta: tuple
    amap: tuple       # addr -> addr over all (home, block) addresses
    bvmap: tuple      # sharer-bitvector word -> permuted word (2^N entries)

    @property
    def is_identity(self) -> bool:
        return (self.sig == tuple(range(len(self.sig)))
                and self.beta == tuple(range(len(self.beta))))


def _make_perm(cfg: SystemConfig, sig, beta) -> _Perm:
    N, M = cfg.num_nodes, cfg.mem_size
    inv_sig = [0] * N
    for n, j in enumerate(sig):
        inv_sig[j] = n
    inv_beta = [0] * M
    for b, j in enumerate(beta):
        inv_beta[j] = b
    amap = [0] * (N << cfg.block_bits)
    for h in range(N):
        for b in range(M):
            src = codec.make_address(cfg, h, b)
            amap[src] = codec.make_address(cfg, sig[h], beta[b])
    bvmap = []
    for w in range(1 << N):
        out = 0
        for n in range(N):
            if (w >> n) & 1:
                out |= 1 << sig[n]
        bvmap.append(out)
    return _Perm(tuple(sig), tuple(inv_sig), tuple(beta), tuple(inv_beta),
                 tuple(amap), tuple(bvmap))


def _apply_perm(cfg: SystemConfig, g: _Perm, a: AState) -> AState:
    """The group action on abstract states: relabel every node-id- and
    address-valued field; permute rows by σ and block columns by β."""
    if g.is_identity:
        return a
    N, C, M = cfg.num_nodes, cfg.cache_size, cfg.mem_size
    n_addr = len(g.amap)

    def ra(addr):  # remap a (possibly sentinel) address value
        return g.amap[addr] if 0 <= addr < n_addr else addr

    cache_addr, cache_val, cache_state = [], [], []
    memory, dir_state, dir_bitvec = [], [], []
    instr_idx, waiting = [], []
    cur_op, cur_addr, cur_val, queues = [], [], [], []
    for j in range(N):
        n = g.inv_sig[j]
        cache_addr.append(tuple(ra(a.cache_addr[n][c]) for c in range(C)))
        cache_val.append(a.cache_val[n])
        cache_state.append(a.cache_state[n])
        memory.append(tuple(a.memory[n][g.inv_beta[b]] for b in range(M)))
        dir_state.append(tuple(a.dir_state[n][g.inv_beta[b]]
                               for b in range(M)))
        dir_bitvec.append(tuple(g.bvmap[a.dir_bitvec[n][g.inv_beta[b]]]
                                for b in range(M)))
        instr_idx.append(a.instr_idx[n])
        waiting.append(a.waiting[n])
        cur_op.append(a.cur_op[n])
        cur_val.append(a.cur_val[n])
        # a never-fetched node's latch is identically (0, 0, 0) — its
        # fields are dead until the first fetch overwrites them, so
        # remapping would fabricate unreachable states
        cur_addr.append(ra(a.cur_addr[n]) if a.instr_idx[n] >= 0
                        else a.cur_addr[n])
        queues.append(tuple(
            (t, g.sig[s], ra(ad), val,
             g.sig[sec] if t in _SECOND_LIVE else sec, ds, g.bvmap[bv])
            for (t, s, ad, val, sec, ds, bv) in a.queues[n]))
    return AState(
        cache_addr=tuple(cache_addr), cache_val=tuple(cache_val),
        cache_state=tuple(cache_state), memory=tuple(memory),
        dir_state=tuple(dir_state), dir_bitvec=tuple(dir_bitvec),
        instr_idx=tuple(instr_idx), waiting=tuple(waiting),
        cur_op=tuple(cur_op), cur_addr=tuple(cur_addr),
        cur_val=tuple(cur_val), queues=tuple(queues),
        # observed values are data, not node ids — only the rows move
        obs=tuple(a.obs[g.inv_sig[j]] for j in range(N)) if a.obs else ())


def _akey(a: AState) -> tuple:
    """Total order over AStates for orbit canonicalization."""
    return (a.cache_addr, a.cache_val, a.cache_state, a.memory,
            a.dir_state, a.dir_bitvec, a.instr_idx, a.waiting,
            a.cur_op, a.cur_addr, a.cur_val, a.queues, a.obs)


def symmetry_group(scope: Scope, a0: AState) -> list:
    """All (σ, β) automorphisms of the scope: β preserves cache_index,
    the per-node programs map onto each other (programs[σ[n]] equals
    node n's program with every address pushed through the induced
    amap), and the initial state is a fixed point. Identity first."""
    cfg = scope.cfg
    N, M, C = cfg.num_nodes, cfg.mem_size, cfg.cache_size
    out = []
    block_perms = [p for p in itertools.permutations(range(M))
                   if all(p[b] % C == b % C for b in range(M))]
    if len(block_perms) > 64:          # scalarset guard for huge scopes
        block_perms = [tuple(range(M))]
    for sig in itertools.permutations(range(N)):
        for beta in block_perms:
            g = _make_perm(cfg, sig, beta)
            if any(tuple((op, g.amap[ad], v) for op, ad, v in
                         scope.programs[n]) != scope.programs[sig[n]]
                   for n in range(N)):
                continue
            if _apply_perm(cfg, g, a0) != a0:
                continue
            out.append(g)
    out.sort(key=lambda g: (not g.is_identity, g.sig, g.beta))
    return out


def _host(t) -> np.ndarray:
    """One tensor on the host as numpy (a device->host copy)."""
    return t.cpu().numpy()


def to_device(leaves: tuple, device) -> tuple:
    """Numpy leaves (int32 or bool) as tensors on ``device``, through one
    host-to-device copy of their concatenation."""
    flat = np.concatenate([np.asarray(x, np.int32).reshape(-1)
                           for x in leaves])
    buf = torch.from_numpy(flat).to(device)
    out, at = [], 0
    for x in leaves:
        t = buf[at:at + x.size].view(x.shape)
        out.append(t.bool() if x.dtype == np.bool_ else t)
        at += x.size
    return tuple(out)


def to_host(named: dict) -> dict:
    """{name: tensor} (int32 or bool, one device) as {name: numpy},
    through one device-to-host copy of their concatenation."""
    flat = _host(torch.cat([t.reshape(-1).to(torch.int32)
                            for t in named.values()]))
    out, at = {}, 0
    for k, t in named.items():
        a = flat[at:at + t.numel()].reshape(tuple(t.shape))
        out[k] = a.astype(bool) if t.dtype == torch.bool else a
        at += t.numel()
    return out


#: the leaves of a stepped state the read-back needs
_READ_BACK = ("cache_addr", "cache_val", "cache_state", "memory",
              "dir_state", "dir_bitvec", "instr_idx", "waiting", "cur_op",
              "cur_addr", "cur_val", "mb_pack", "mb_head", "mb_count",
              "metrics.msgs_dropped")


def _named(state) -> dict:
    """A SimState's leaves by their ``SIM_LEAVES`` name."""
    return dict(zip(SIM_LEAVES, state_leaves(state)))


class ModelChecker:
    """Explicit-state BFS over one scope's reachable graph.

    ``message_phase`` swaps in a (possibly mutated) handler phase with
    the signature of :func:`..ops.handlers.message_phase`; the engine
    around it stays the shipped one (ops/step.cycle's override hook).
    The oracle stages on ``device`` (None: the card).
    """

    def __init__(self, scope: Scope, message_phase=None,
                 max_states: int = 50_000, track_obs: bool = False,
                 final_addrs: tuple = (), device=None, tally=None):
        """``track_obs=True`` switches on litmus mode: every READ retire
        appends its observed value to the node's AState.obs register
        tape, and the report gains an ``outcomes`` key, the sorted set
        of (read observations in node-major program order + final
        values of ``final_addrs``) over all quiescent terminal states,
        closed under the symmetry group. Off by default: the default
        report stays the same (obs stays the empty tuple, which
        canonicalizes away). ``tally``, a dict, gets this checker's
        oracle batches added under ``"batches"``."""
        self.scope = scope
        self.cfg = scope.cfg
        self.max_states = max_states
        self.track_obs = track_obs
        self.final_addrs = tuple(final_addrs)
        self.device = _device.resolve(device)
        #: oracle batches run so far (each one vmapped step.cycle call)
        self.batches = 0
        self.tally = tally
        mp = message_phase if message_phase is not None \
            else handlers.message_phase
        cfg = self.cfg

        def one(*leaves):
            state = from_leaves(leaves)
            phase_out = []

            def probed(cfg_, st, mv):
                phase_out.append(mp(cfg_, st, mv))
                return phase_out[-1]
            new_state = _named(step.cycle(cfg, state,
                                          message_phase=probed))
            # handler-engagement probe on the SAME staged state: did the
            # dequeued message trigger any masked write, wait clear, or
            # outgoing candidate at its receiver? The phase's outputs are
            # those of the call the cycle made on ``mailbox.dequeue`` of
            # this state (the JAX oracle makes that call a second time)
            upd, cand, inv_scatter, _ = phase_out[0]
            engaged = (upd["cache_state"][0] | upd["cache_addr"][0]
                       | upd["mem"][0] | upd["dir_state"][0]
                       | upd["dir_bv"][0] | upd["wait_clear"])
            for part in ("pri", "sec", "ev"):
                engaged = engaged | (cand[part][0] != int(Msg.NONE))
            if cand["inv"][0] is not None:
                engaged = engaged | (cand["inv"][0]
                                     != int(Msg.NONE)).any(dim=1)
            if inv_scatter is not None:
                engaged = engaged | inv_scatter[0]
            return {k: new_state[k] for k in _READ_BACK}, engaged

        self._oracle = torch.func.vmap(one)
        self._step_preds = torch.func.vmap(
            lambda *leaves: invariants.step_predicates(
                cfg, from_leaves(leaves)))
        self._quiet_preds = torch.func.vmap(
            lambda *leaves: invariants.quiescent_predicates(
                cfg, from_leaves(leaves)))
        self._instr_arrays = self._build_instr_arrays()
        s0 = init_state(cfg, traces=[list(p) for p in scope.programs],
                        device="cpu")
        self._fault_key = s0.fault_key.numpy()
        self._a0 = self._initial(s0)
        self._build_sym(self._a0)

    # -- symmetry ----------------------------------------------------------

    def _build_sym(self, a0: AState) -> None:
        """Automorphism group + composition/inverse tables (group order
        is tiny, at most |S_N| on these scopes, so dense tables are
        free)."""
        self._group = symmetry_group(self.scope, a0)
        G = len(self._group)
        idx = {(g.sig, g.beta): i for i, g in enumerate(self._group)}
        self._mul = [[0] * G for _ in range(G)]   # mul[i][j] = g_i ∘ g_j
        self._ginv = [0] * G
        for i, gi in enumerate(self._group):
            for j, gj in enumerate(self._group):
                sig = tuple(gi.sig[s] for s in gj.sig)
                beta = tuple(gi.beta[b] for b in gj.beta)
                k = idx[(sig, beta)]
                self._mul[i][j] = k
                if k == 0:
                    self._ginv[i] = j

    def _canon(self, a: AState):
        """(orbit representative, index of the g with g·a = canon)."""
        if len(self._group) == 1:
            return a, 0
        best, bk, bi = a, _akey(a), 0
        for i in range(1, len(self._group)):
            p = _apply_perm(self.cfg, self._group[i], a)
            k = _akey(p)
            if k < bk:
                best, bk, bi = p, k, i
        return best, bi

    # -- staging: AState -> concrete SimState leaves (numpy) ---------------

    def _build_instr_arrays(self):
        cfg = self.cfg
        N, T = cfg.num_nodes, cfg.max_instrs
        op = np.full((N, T), int(Op.NOP), np.int32)
        addr = np.zeros((N, T), np.int32)
        val = np.zeros((N, T), np.int32)
        count = np.zeros((N,), np.int32)
        for n, prog in enumerate(self.scope.programs):
            count[n] = len(prog)
            for i, (o, a, v) in enumerate(prog):
                op[n, i], addr[n, i], val[n, i] = int(o), int(a), int(v) & 0xFF
        return op, addr, val, count

    def _stage(self, a: AState, event) -> tuple:
        """Concrete state for one transition, as numpy leaves in
        ``SIM_LEAVES`` order: only the acting node can move (its queue
        staged / its issue gate open); everyone else is frozen by an
        empty mailbox + BIG_DELAY. event=None stages the whole state
        verbatim (predicate evaluation)."""
        cfg = self.cfg
        N, Q = cfg.num_nodes, cfg.queue_capacity
        kind, actor = event if event is not None else (None, None)

        mb_pack = np.zeros((7, N, Q), np.int32)
        mb_pack[MB_TYPE] = int(Msg.NONE)
        mb_count = np.zeros((N,), np.int32)
        stage_queues = range(N) if kind is None else \
            ([actor] if kind == "msg" else [])
        for r in stage_queues:
            for i, msg in enumerate(a.queues[r]):
                mb_pack[:6, r, i] = msg[:6]
                mb_pack[MB_BV0, r, i] = np.uint32(msg[6]).view(np.int32)
            mb_count[r] = len(a.queues[r])

        delay = np.full((N,), BIG_DELAY, np.int32)
        if kind == "instr":
            delay[actor] = 0

        waiting = np.asarray(a.waiting, bool)
        op, addr, val, count = self._instr_arrays
        z32 = np.zeros((), np.int32)
        leaves = dict(
            cache_addr=np.asarray(a.cache_addr, np.int32),
            cache_val=np.asarray(a.cache_val, np.int32),
            cache_state=np.asarray(a.cache_state, np.int32),
            memory=np.asarray(a.memory, np.int32),
            dir_state=np.asarray(a.dir_state, np.int32),
            # uint32 sharer words as the port's int32 bit patterns
            dir_bitvec=np.asarray(a.dir_bitvec, np.uint32).view(
                np.int32)[..., None],
            instr_op=op, instr_addr=addr, instr_val=val, instr_count=count,
            instr_idx=np.asarray(a.instr_idx, np.int32),
            cur_op=np.asarray(a.cur_op, np.int32),
            cur_addr=np.asarray(a.cur_addr, np.int32),
            cur_val=np.asarray(a.cur_val, np.int32),
            waiting=waiting,
            waiting_since=np.where(waiting, 0, -1).astype(np.int32),
            mb_pack=mb_pack,
            mb_head=np.zeros((N,), np.int32),
            mb_count=mb_count,
            issue_delay=delay,
            issue_period=np.ones((N,), np.int32),
            arb_rank=np.arange(N, dtype=np.int32),
            order_rank=np.zeros((N, 0), np.int32),
            fault_key=self._fault_key,
            cycle=z32)
        shapes = {"metrics.msgs_processed": (13,),
                  "metrics.lat_hist": (LAT_BUCKETS,)}
        return tuple(leaves[f] if f in leaves
                     else np.zeros(shapes.get(f, ()), np.int32)
                     for f in SIM_LEAVES)

    def _read_back(self, a: AState, event, res: dict, k: int):
        """(next AState, dropped, overflowed) from oracle output row k
        (``res``: the stepped batch's leaves by name, on the host)."""
        cfg = self.cfg
        N, Q = cfg.num_nodes, cfg.queue_capacity
        kind, actor = event
        queues, overflow = [], False
        for r in range(N):
            cnt = int(res["mb_count"][k, r])
            head = int(res["mb_head"][k, r])
            ring = []
            for i in range(cnt):
                slot = (head + i) % Q
                f = res["mb_pack"][k, :, r, slot]
                ring.append((int(f[0]), int(f[1]), int(f[2]), int(f[3]),
                             int(f[4]), int(f[5]),
                             int(np.int32(f[MB_BV0]).view(np.uint32))))
            if kind == "msg" and r == actor:
                # staged ring = the full abstract queue; what remains in
                # it (plus self-sends) IS the next queue
                q = tuple(ring)
            else:
                # staged empty: ring holds only this step's deliveries
                q = a.queues[r] + tuple(ring)
            if len(q) > Q:
                overflow, q = True, q[:Q]
            queues.append(q)
        new = AState(
            cache_addr=_t2(res["cache_addr"][k]),
            cache_val=_t2(res["cache_val"][k]),
            cache_state=_t2(res["cache_state"][k]),
            memory=_t2(res["memory"][k]),
            dir_state=_t2(res["dir_state"][k]),
            dir_bitvec=_t2(res["dir_bitvec"][k][..., 0].view(np.uint32)),
            instr_idx=_t1(res["instr_idx"][k]),
            waiting=tuple(bool(x) for x in res["waiting"][k]),
            cur_op=_t1(res["cur_op"][k]),
            cur_addr=_t1(res["cur_addr"][k]),
            cur_val=_t1(res["cur_val"][k]),
            queues=tuple(queues),
            obs=a.obs)
        if self.track_obs:
            # read-retire boundary? Same rule as the engine's obs_retire
            # ledger plane: a READ retires either at its fetch step (hit:
            # fetch without opening a wait) or at the step that clears
            # its wait (fill / early unblock, quirk 2 included).
            retired_addr = None
            if kind == "instr":
                op, addr, _ = self.scope.programs[actor][
                    new.instr_idx[actor]]
                if Op(op) == Op.READ and not new.waiting[actor]:
                    retired_addr = addr
            elif (a.waiting[actor] and not new.waiting[actor]
                  and a.cur_op[actor] == int(Op.READ)):
                retired_addr = a.cur_addr[actor]
            if retired_addr is not None:
                obs = list(new.obs)
                obs[actor] = obs[actor] + (
                    self._observe(new, actor, retired_addr),)
                new = dataclasses.replace(new, obs=tuple(obs))
        return new, int(res["metrics.msgs_dropped"][k]), overflow


    def _observe(self, a: AState, node: int, addr: int) -> int:
        """The engine's read-observation rule (ops/step.py obs_val):
        the retiring node's own cache line for `addr`, or -1 when the
        line is absent/INVALID at retire."""
        cidx = codec.cache_index(self.cfg, addr)
        if (a.cache_addr[node][cidx] == addr
                and a.cache_state[node][cidx] != int(CacheState.INVALID)):
            return a.cache_val[node][cidx]
        return -1

    def _final_value(self, a: AState, addr: int) -> int:
        """Authoritative value of `addr` at quiescence: the EM owner's
        cache line when the directory records an owner (memory may be
        stale behind a MODIFIED line), home memory otherwise."""
        cfg = self.cfg
        h = codec.home_node(cfg, addr)
        b = codec.block_index(cfg, addr)
        if a.dir_state[h][b] == int(DirState.EM):
            bv = a.dir_bitvec[h][b]
            cidx = codec.cache_index(cfg, addr)
            for n in range(cfg.num_nodes):
                if ((bv >> n) & 1
                        and a.cache_addr[n][cidx] == addr
                        and a.cache_state[n][cidx]
                        != int(CacheState.INVALID)):
                    return a.cache_val[n][cidx]
        return a.memory[h][b]

    def _outcome(self, a: AState) -> tuple:
        """One concrete litmus outcome: every read observation in
        node-major program order, then final_addrs' final values."""
        reads = tuple(v for n in range(self.cfg.num_nodes)
                      for v in a.obs[n])
        return reads + tuple(self._final_value(a, ad)
                             for ad in self.final_addrs)


    def _initial(self, s0) -> AState:
        memory = _t2(s0.memory)
        if self.scope.mem_uniform:
            memory = tuple(
                tuple(i & 0xFF for i in range(self.cfg.mem_size))
                for _ in range(self.cfg.num_nodes))
        return AState(
            cache_addr=_t2(s0.cache_addr), cache_val=_t2(s0.cache_val),
            cache_state=_t2(s0.cache_state), memory=memory,
            dir_state=_t2(s0.dir_state),
            dir_bitvec=_t2(s0.dir_bitvec[..., 0].numpy().view(np.uint32)),
            instr_idx=_t1(s0.instr_idx),
            waiting=tuple(bool(x) for x in s0.waiting.tolist()),
            cur_op=_t1(s0.cur_op), cur_addr=_t1(s0.cur_addr),
            cur_val=_t1(s0.cur_val),
            queues=tuple(() for _ in range(self.cfg.num_nodes)),
            obs=(tuple(() for _ in range(self.cfg.num_nodes))
                 if self.track_obs else ()))

    def _batched(self, staged: list) -> tuple:
        """The staged states as one [_BATCH, ...] batch of leaves on the
        oracle's device, padded with copies of ``staged[0]`` (every
        vmapped call sees one batch shape)."""
        staged = staged + [staged[0]] * (_BATCH - len(staged))
        return to_device(tuple(np.stack(xs) for xs in zip(*staged)),
                         self.device)

    def step_batch(self, batch: tuple) -> tuple:
        """One oracle batch: the vmapped ``step.cycle`` plus the
        engagement probe, read back to the host as ({leaf name: [B, ...]
        numpy}, [B, N] engaged)."""
        res, engaged = self._oracle(*batch)
        self.count_batch()
        out = to_host(dict(res, engaged=engaged))
        return out, out.pop("engaged")

    def count_batch(self) -> None:
        self.batches += 1
        if self.tally is not None:
            self.tally["batches"] = self.tally.get("batches", 0) + 1

    @staticmethod
    def _bad_rows(preds, batch: tuple) -> dict:
        """{predicate name: [_BATCH] bool}, in the predicates' order:
        which batch rows violate it (one device->host copy)."""
        masks = preds(*batch)
        bad = _host(torch.stack([m.reshape(_BATCH, -1).any(dim=1)
                                 for m in masks.values()]))
        return dict(zip(masks, bad))


    # -- message/pair coverage --------------------------------------------

    def _pair_key(self, a: AState, actor: int):
        """(msg type, home/remote, cache-line state, tag match, dir
        state at receiver) of the head message `actor` is about to
        process — the coverage cell of the handler matrix."""
        cfg = self.cfg
        t, _, addr = a.queues[actor][0][:3]
        at_home = codec.home_node(cfg, addr) == actor
        cidx = codec.cache_index(cfg, addr)
        block = codec.block_index(cfg, addr)
        return (Msg(t).name,
                "home" if at_home else "remote",
                CACHE_STATE_NAMES[a.cache_state[actor][cidx]],
                a.cache_addr[actor][cidx] == addr,
                DIR_STATE_NAMES[a.dir_state[actor][block]]
                if at_home else "-")

    @staticmethod
    def _pair_str(pair) -> str:
        t, loc, cs, tag, ds = pair
        tagtxt = "" if tag else " tag-miss"
        dirtxt = f" dir={ds}" if ds != "-" else ""
        return f"{t}@{loc} cache={cs}{tagtxt}{dirtxt}"

    @staticmethod
    def _sanctioned_noop(pair) -> str | None:
        t, _, _, tag, _ = pair
        if t == "INV" and not tag:
            return ("INV on a tag mismatch is the reference's sanctioned "
                    "no-op (assignment.c:389-399): the targeted line was "
                    "already replaced or never filled")
        return None

    # -- rendering ---------------------------------------------------------

    def _render_event(self, src: AState, ev) -> str:
        kind, n = ev
        if kind == "instr":
            op, addr, val = self.scope.programs[n][src.instr_idx[n] + 1]
            w = Op(op) == Op.WRITE
            return (f"node{n} {'W' if w else 'R'} 0x{addr:02x}"
                    + (f"={val}" if w else ""))
        t, sender, addr, value, second, _, bv = src.queues[n][0]
        extra = f" bv={bv:b}" if bv else ""
        return (f"node{n} <- {Msg(t).name} from node{sender} "
                f"0x{addr:02x} val={value} second={second}{extra}")

    def render_state(self, a: AState) -> list:
        cfg, lines = self.cfg, []
        for n in range(cfg.num_nodes):
            cache = " ".join(
                f"[0x{a.cache_addr[n][c]:02x} v={a.cache_val[n][c]} "
                f"{CACHE_STATE_NAMES[a.cache_state[n][c]]}]"
                for c in range(cfg.cache_size))
            d = " ".join(
                f"{DIR_STATE_NAMES[a.dir_state[n][m]]}"
                f":{a.dir_bitvec[n][m]:b}" for m in range(cfg.mem_size))
            q = ", ".join(Msg(m[0]).name for m in a.queues[n]) or "-"
            flag = " WAITING" if a.waiting[n] else ""
            lines.append(f"node{n}: cache {cache} mem={list(a.memory[n])} "
                         f"dir {d} q=[{q}]{flag}")
        return lines

    # -- the run ------------------------------------------------------------

    def run(self) -> dict:
        scope, cfg = self.scope, self.cfg
        a0 = self._a0            # group-invariant, so already canonical
        ids = {a0: 0}
        states = [a0]
        parent = [None]          # per id: (pred_id, event, perm_idx) | None
        adj = [[]]               # per id: list of (event, dst_id)
        terminals = []
        engaged_pairs = {}       # pair -> [count, first_state_id]
        noop_pairs = {}
        violations = []
        n_msg = n_instr = 0

        frontier = [0]
        while frontier:
            jobs = []
            for sid in frontier:
                evs = enabled_events(scope, states[sid])
                if not evs:
                    terminals.append(sid)
                jobs.extend((sid, ev) for ev in evs)
            nxt = []
            for start in range(0, len(jobs), _BATCH):
                chunk = jobs[start:start + _BATCH]
                batch = self._batched(
                    [self._stage(states[sid], ev) for sid, ev in chunk])
                res, engaged = self.step_batch(batch)
                for j, (sid, ev) in enumerate(chunk):
                    new_a, dropped, ovf = self._read_back(
                        states[sid], ev, res, j)
                    new_a, gi = self._canon(new_a)
                    if dropped or ovf:
                        violations.append({
                            "check": "scope_overflow",
                            "name": "scope_overflow",
                            "detail": "mailbox capacity exceeded inside "
                                      "the scope — enlarge queue_capacity",
                            "state": sid,
                            "path": self.path_to(parent, states, sid)})
                    if ev[0] == "msg":
                        n_msg += 1
                        pair = self._pair_key(states[sid], ev[1])
                        bucket = engaged_pairs if bool(engaged[j, ev[1]]) \
                            else noop_pairs
                        if pair not in bucket:
                            bucket[pair] = [0, sid]
                        bucket[pair][0] += 1
                    else:
                        n_instr += 1
                    nid = ids.get(new_a)
                    if nid is None:
                        nid = len(states)
                        ids[new_a] = nid
                        states.append(new_a)
                        parent.append((sid, ev, gi))
                        adj.append([])
                        nxt.append(nid)
                        if nid >= self.max_states:
                            raise ScopeTooLarge(
                                f"scope {scope.name}: > {self.max_states} "
                                "states")
                    adj[sid].append((ev, nid))
            frontier = nxt

        # ---- progress: deadlock + livelock -------------------------------
        quiescent_terms, deadlocks = [], []
        for sid in terminals:
            if any(states[sid].waiting):
                deadlocks.append(sid)
            else:
                quiescent_terms.append(sid)
        for sid in deadlocks:
            path, fin = self._trace_to(parent, states, sid)
            violations.append({
                "check": "deadlock",
                "name": "deadlock",
                "detail": "terminal state with a blocked node (a reply "
                          "was lost or never clears `waiting`)",
                "state": sid,
                "path": path,
                "state_render": self.render_state(fin)})

        # livelock: Tarjan SCCs of the reachable graph; every component
        # with no path to a terminal is a genuine non-progress trap, and
        # a cycle inside it is the lasso witness. (Tarjan emits SCCs in
        # reverse topological order of the condensation, so one forward
        # pass over the emission order resolves can-reach-terminal.)
        comp_id, comps = self._sccs(adj)
        is_term = [False] * len(states)
        for t in terminals:
            is_term[t] = True
        comp_can = [False] * len(comps)
        for ci, members in enumerate(comps):
            ok = any(is_term[v] for v in members)
            if not ok:
                ok = any(comp_can[comp_id[d]]
                         for v in members for _, d in adj[v]
                         if comp_id[d] != ci)
            comp_can[ci] = ok
        stuck_comps = [ci for ci in range(len(comps)) if not comp_can[ci]]
        if stuck_comps:
            n_stuck = sum(len(comps[ci]) for ci in stuck_comps)
            # witness: a stuck SCC that contains a cycle (a stuck state
            # always leads into one — the graph is finite)
            wit = next(
                (ci for ci in stuck_comps
                 if len(comps[ci]) > 1
                 or any(d == comps[ci][0] for _, d in adj[comps[ci][0]])),
                stuck_comps[0])
            cyc = self._cycle_in(adj, comp_id, wit, comps[wit][0])
            entry = cyc[0][0] if cyc else comps[wit][0]
            path, fin = self._trace_to(parent, states, entry)
            mod = (" (cycle shown modulo node/address relabeling)"
                   if len(self._group) > 1 else "")
            violations.append({
                "check": "livelock",
                "name": "livelock",
                "detail": f"{n_stuck} reachable states in "
                          f"{len(stuck_comps)} SCCs cannot reach any "
                          f"terminal state; lasso witness: stem of "
                          f"{len(path)} events + a {len(cyc)}-event "
                          f"message cycle{mod}",
                "state": entry,
                "path": path,
                "cycle": [self._render_event(states[s], ev)
                          for s, ev in cyc],
                "state_render": self.render_state(fin)})

        # ---- handler coverage --------------------------------------------
        sanctioned_noops = []
        for pair in sorted(noop_pairs):
            why = self._sanctioned_noop(pair)
            count, sid = noop_pairs[pair]
            if why is not None:
                sanctioned_noops.append({
                    "pair": self._pair_str(pair), "count": count,
                    "rationale": why})
            else:
                path, fin = self._trace_to(parent, states, sid)
                violations.append({
                    "check": "unhandled_pair",
                    "name": "unhandled_pair",
                    "detail": f"message silently ignored: "
                              f"{self._pair_str(pair)} "
                              f"({count} occurrences)",
                    "state": sid,
                    "path": path,
                    "state_render": self.render_state(fin)})

        # ---- engine-tier invariants on EVERY reachable state -------------
        step_hits = {}
        for start in range(0, len(states), _BATCH):
            chunk = states[start:start + _BATCH]
            batch = self._batched(
                [self._stage(a, None) for a in chunk])
            for name, bad in self._bad_rows(self._step_preds,
                                            batch).items():
                for j in range(len(chunk)):
                    if bad[j] and name not in step_hits:
                        step_hits[name] = start + j
        for name in sorted(step_hits):
            sid = step_hits[name]
            path, fin = self._trace_to(parent, states, sid)
            violations.append({
                "check": "step_invariant", "name": name, "state": sid,
                "detail": f"engine-tier invariant `{name}` violated on a "
                          "reachable state",
                "path": path,
                "state_render": self.render_state(fin)})

        # ---- coherence tier at quiescent terminals -----------------------
        quirks, quiet_hits = {}, {}
        for start in range(0, len(quiescent_terms), _BATCH):
            chunk = quiescent_terms[start:start + _BATCH]
            batch = self._batched(
                [self._stage(states[sid], None) for sid in chunk])
            for name, bad in self._bad_rows(self._quiet_preds,
                                            batch).items():
                for j, sid in enumerate(chunk):
                    if not bad[j]:
                        continue
                    if name in QUIRK_ALLOWLIST:
                        if name not in quirks:
                            quirks[name] = [0, sid]
                        quirks[name][0] += 1
                    elif name not in quiet_hits:
                        quiet_hits[name] = sid
        for name in sorted(quiet_hits):
            sid = quiet_hits[name]
            path, fin = self._trace_to(parent, states, sid)
            violations.append({
                "check": "coherence", "name": name, "state": sid,
                "detail": f"coherence contract `{name}` violated at a "
                          "quiescent state (not a sanctioned quirk)",
                "path": path,
                "state_render": self.render_state(fin)})

        violations.sort(key=lambda v: (v["check"], v.get("name", ""),
                                       v["state"]))
        report = {
            "scope": scope.describe(),
            "stats": {
                "states": len(states),
                "transitions": n_msg + n_instr,
                "msg_events": n_msg,
                "instr_events": n_instr,
                "terminal_states": len(terminals),
                "quiescent_states": len(quiescent_terms),
                "deadlocked_states": len(deadlocks),
                "symmetry_group_order": len(self._group),
                "sccs": len(comps),
            },
            "coverage": {
                "engaged_pairs": sorted(
                    self._pair_str(p) for p in engaged_pairs),
                "sanctioned_noops": sanctioned_noops,
            },
            "quirks": [
                {"name": name, "states": quirks[name][0],
                 "rationale": QUIRK_ALLOWLIST[name],
                 "example_state": quirks[name][1],
                 "example_path": self.path_to(parent, states,
                                              quirks[name][1])}
                for name in sorted(quirks)],
            "violations": violations,
            "ok": not violations,
        }
        if self.track_obs:
            # stored states are orbit representatives; the concrete
            # outcome set is the orbit closure over the group (permuted
            # states are reachable runs, their outcomes row-permute)
            outs = set()
            for sid in quiescent_terms:
                for g in self._group:
                    outs.add(self._outcome(
                        _apply_perm(cfg, g, states[sid])))
            report["outcomes"] = sorted(outs)
        return report

    def _trace_to(self, parent, states, sid):
        """(rendered concrete event path from the initial state, the
        concrete final AState the path actually lands in).

        Stored states are orbit representatives: edge k records the
        permutation π_k with canon = π_k·(raw successor). Unwinding with
        the accumulated h_k = π_k∘h_{k-1} (concrete state t_k =
        h_k⁻¹·c_k, concrete event f_k = h_{k-1}⁻¹·e_k) turns the
        quotient path back into one genuine run of the machine."""
        edges = []
        while parent[sid] is not None:
            pid, ev, gi = parent[sid]
            edges.append((pid, ev, gi))
            sid = pid
        edges.reverse()
        out, h = [], 0
        for pid, ev, gi in edges:
            hin = self._group[self._ginv[h]]
            src = _apply_perm(self.cfg, hin, states[pid])
            out.append(self._render_event(src, (ev[0], hin.sig[ev[1]])))
            h = self._mul[gi][h]
        final = _apply_perm(self.cfg, self._group[self._ginv[h]],
                            states[sid])
        return out, final

    def path_to(self, parent, states, sid) -> list:
        """Counterexample path: rendered events from the initial state."""
        return self._trace_to(parent, states, sid)[0]

    @staticmethod
    def _sccs(adj):
        """Iterative Tarjan: (comp_id per state, components in emission
        order — reverse topological order of the condensation)."""
        n = len(adj)
        index = [-1] * n
        low = [0] * n
        on = [False] * n
        stack: list = []
        comps: list = []
        comp_id = [-1] * n
        counter = 0
        for root in range(n):
            if index[root] != -1:
                continue
            work = [(root, 0)]
            while work:
                v, pi = work[-1]
                if pi == 0:
                    index[v] = low[v] = counter
                    counter += 1
                    stack.append(v)
                    on[v] = True
                descended = False
                out = adj[v]
                for i in range(pi, len(out)):
                    w = out[i][1]
                    if index[w] == -1:
                        work[-1] = (v, i + 1)
                        work.append((w, 0))
                        descended = True
                        break
                    if on[w]:
                        low[v] = min(low[v], index[w])
                if descended:
                    continue
                work.pop()
                if work:
                    u = work[-1][0]
                    low[u] = min(low[u], low[v])
                if low[v] == index[v]:
                    members = []
                    while True:
                        w = stack.pop()
                        on[w] = False
                        comp_id[w] = len(comps)
                        members.append(w)
                        if w == v:
                            break
                    comps.append(members)
        return comp_id, comps

    @staticmethod
    def _cycle_in(adj, comp_id, ci, v0) -> list:
        """A cycle inside SCC `ci` starting the walk at v0: list of
        (state_id, event) edges. Every vertex of a stuck SCC has an
        in-component out-edge, so the greedy walk must revisit."""
        path: list = []
        pos: dict = {}
        v = v0
        while v not in pos:
            pos[v] = len(path)
            step_edge = next(((e, d) for e, d in adj[v]
                              if comp_id[d] == ci), None)
            if step_edge is None:      # trivial SCC without a self-loop
                return []
            path.append((v, step_edge[0]))
            v = step_edge[1]
        return path[pos[v]:]


def check_scope(scope: Scope, message_phase=None,
                max_states: int = 50_000, device=None, tally=None) -> dict:
    """One-call convenience: build a checker, run it, return the report
    (the oracle on ``device``; None: the card)."""
    return ModelChecker(scope, message_phase=message_phase,
                        max_states=max_states, device=device,
                        tally=tally).run()

