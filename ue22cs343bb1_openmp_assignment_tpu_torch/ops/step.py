"""The message-level cycle and its runners.

The port of the JAX package's ``ops/step.py``. One ``cycle`` is one trip
around the reference's per-thread event loop (``assignment.c:165-737``)
for every node at once:

  phase 1  every node with a queued message dequeues one and runs its
           handler (``ops.handlers``);
  phase 2  every idle, unblocked node fetches one instruction
           (``ops.frontend``); a node never does both in one cycle;
  phase 3  all candidate messages are delivered by one arbitration-
           sorted scatter (``ops.mailbox.deliver``, or a ``deliver_fn``
           such as the routed transports of ``parallel.rdma_comm``), and
           in scatter INV mode the homes' invalidations are applied.

The runners are Python loops over cycles. ``run_chunked_to_quiescence``
reads the quiescence flag (one host sync) only between ``chunk``-cycle
blocks, where the JAX runner's ``while_loop`` tests it, so cycle counts
agree with the reference; ``run_to_quiescence`` is chunk 1.

The shipped commit writes each family's row as a one-hot ``where`` over
the row's columns: the same writes as the JAX packed drop-scatter, whose
kept lanes are one per node, with no index site. ``_PACKED_COMMIT`` is
the JAX seam the index auditor's seeded mutation flips (``False``: one
gather and one ``index_put_`` a plane on a shared index vector,
bit-identical, caught only by ``analyze --index``).
``run_cycles_traced`` stacks the per-cycle event record.

The observability captures (JAX ``ops/step.py:39-80``, ``:449-651``):
``with_telemetry`` (the per-cycle counter deltas, dequeues by type,
queue watermarks, directory occupancy and latency histogram),
``with_ledger`` / ``with_obs`` (the message ledger in the JAX dtypes,
with ``mailbox.deliver``'s accept mask) and ``with_profile`` (the
coherence-profile planes). Their runners, ``run_cycles_telemetry``
(JAX ``:706``), ``run_cycles_ledger`` (``:750``) and
``run_cycles_profile`` (``:789``), are Python loops like
``run_cycles_traced``: the samples are stacked per cycle, the profile
rides the carry. The JAX scatter-adds with ``mode="drop"`` become
``index_add_`` on flat views whose dropped lanes add 0 at a clipped
index (one launch each; the int32 adds are exact in any order), and the
last-writer scatter-min goes through a spare tail slot that is sliced
off.

The serving layer's wave runners (JAX ``ops/step.py:885-1008``):
``batched_wave`` / ``run_wave_to_quiescence`` and ``batched_wave_chunk``
/ ``run_wave_chunk`` step a batch of independent machines as one
``cycle`` under ``torch.func.vmap`` over the job axis, freezing the jobs
that are done each cycle; the host reads the [B] done mask once a chunk.
"""

from __future__ import annotations

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import codec
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (frontend, handlers,
                                                          mailbox)
from ue22cs343bb1_openmp_assignment_tpu_torch.state import (
    LAT_BUCKETS, SIM_LEAVES, SimState, batch_quiescent, floor_log2,
    from_leaves, state_leaves)
from ue22cs343bb1_openmp_assignment_tpu_torch.types import (CacheState,
                                                            DirState, Msg,
                                                            Op)

I32 = torch.int32
INT32_MAX = 2**31 - 1

#: names of the per-cycle counter-delta vector of the telemetry sample
#: (cycle(with_telemetry=True) / run_cycles_telemetry), in order: the
#: composition of the cumulative Metrics update
TELEMETRY_COUNTERS = ("instrs_retired", "read_hits", "write_hits",
                      "read_misses", "write_misses", "upgrades",
                      "invalidations", "evictions")

#: fields of the per-cycle message-ledger sample (cycle(with_ledger=
#: True)): the dequeue record, the per-(node, slot) enqueue candidates
#: with the post-arbitration accept mask, the frontend issue/latch record
#: and the wait-clear mask (what obs/txntrace.py reconstructs spans
#: from); ``with_obs=True`` adds the retire observation (LEDGER_OBS_FIELDS)
LEDGER_FIELDS = ("deq_has", "deq_sender", "deq_type", "deq_addr",
                 "enq_accept", "enq_type", "enq_recv", "enq_addr",
                 "fetch", "issue", "op", "addr", "value", "unblocked")
LEDGER_OBS_FIELDS = ("obs_retire", "obs_val")

#: miss-taxonomy columns of the profile's ``miss_node``/``miss_addr``
#: planes: Hill & Smith's 3C classes with conflict and capacity in one
#: (the cache is direct-mapped), plus the coherence invalidation and the
#: upgrade (a write hit on a SHARED line)
PROFILE_MISS_CLASSES = ("cold", "conflict_eviction",
                        "coherence_invalidation", "upgrade")

#: power-of-two buckets of the invalidation fan-out histogram: bucket 0
#: (fan-out 0) is never recorded; bucket b >= 1 holds fan-outs in
#: [2^(b-1), 2^b)
FANOUT_BUCKETS = 16


def profile_space(cfg: SystemConfig) -> int:
    """The profile plane's address axis: the global address space
    ``N << block_bits``."""
    return cfg.num_nodes << cfg.block_bits


def profile_zeros(cfg: SystemConfig, device=None) -> dict:
    """The zeroed profile carry of run_cycles_profile (JAX
    ``ops/step.py:89``): rd / wr / ever [N, A] (per-(node, address)
    reads, writes and ever-fetched), miss_node [N, 4], miss_addr [A, 4]
    (PROFILE_MISS_CLASSES), inv_addr [A], inv_fanout [FANOUT_BUCKETS],
    wb_addr [A], last_writer [A] (-1: none yet), mig_addr [A]. ``device``
    None means the card."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
    dev = _device.resolve(device)
    N, A = cfg.num_nodes, profile_space(cfg)

    def z(*shape):
        return torch.zeros(shape, dtype=I32, device=dev)
    return {
        "rd": z(N, A), "wr": z(N, A),
        "ever": torch.zeros((N, A), dtype=torch.bool, device=dev),
        "miss_node": z(N, 4), "miss_addr": z(A, 4),
        "inv_addr": z(A), "inv_fanout": z(FANOUT_BUCKETS),
        "wb_addr": z(A),
        "last_writer": torch.full((A,), -1, dtype=I32, device=dev),
        "mig_addr": z(A),
    }


#: commit-path seam for the index-pressure auditor's seeded mutation
#: (analysis/mutations.INDEX_MUTATIONS.split_packed_scatter, JAX
#: ``ops/step.py:123-131``). True = the shipped commit: each family's
#: row as a one-hot ``where``, no index site. False = a per-plane
#: commit: one gather and one ``index_put_`` a plane, every plane of a
#: family on one shared index vector, unset columns writing back their
#: gathered old value. Bit-identical to the shipped commit, so every
#: dynamic oracle stays green; only the static index audit
#: (analysis/indexcheck.py) sees it. Production code never flips this.
_PACKED_COMMIT = True


def cycle(cfg: SystemConfig, state: SimState, with_events: bool = False,
          message_phase=None, with_telemetry: bool = False,
          with_ledger: bool = False, with_obs: bool = False,
          deliver_fn=None, with_profile: bool = False, prof=None):
    """Advance the whole machine by one cycle (the JAX signature).

    ``with_events=True`` also returns this cycle's event record (per-node
    fetches and dequeues, the data of the reference's ``DEBUG_INSTR`` /
    ``DEBUG_MSG`` tracing) as a dict of [N] tensors: ``(state, events)``.
    ``message_phase`` overrides the handler phase; ``deliver_fn``
    overrides phase-3 delivery (the contract of ``mailbox.deliver``).

    The captures append their sample to the output tuple in the JAX
    order ``(state, events, telem, ledger, prof)``:

    - ``with_telemetry``: the counter deltas (TELEMETRY_COUNTERS; the
      invalidations include the scatter-mode INV fan-out, as the
      cumulative metric), per-type dequeues, dropped counts, the
      latency-histogram delta, queue-depth watermarks, directory
      occupancy (EM, S, U) and waiting nodes;
    - ``with_ledger``: LEDGER_FIELDS in the JAX dtypes (node ids int8 up
      to 127 nodes, int16 up to 32767; addresses int16 while
      ``cfg.invalid_address`` fits; types int8), the accept mask in
      (sender, slot) layout; ``with_obs`` adds LEDGER_OBS_FIELDS;
    - ``with_profile``: the profile planes of ``prof`` (a
      ``profile_zeros`` dict) after this cycle. The miss taxonomy reads
      the pre-commit cache tags and ``prof["ever"]`` before its update.
      The port updates the planes of ``prof`` in place (the runner's
      carry; at 4096 nodes rd and wr are 1 GiB each) and returns it.
    """
    if message_phase is None:
        message_phase = handlers.message_phase
    N, C, M = cfg.num_nodes, cfg.cache_size, cfg.mem_size
    dev = state.cycle.device
    rows = torch.arange(N, dtype=I32, device=dev)

    # phase 1: message handlers
    mv, new_head, new_count = mailbox.dequeue(cfg, state)
    m_upd, m_cand, inv_scatter, m_stats = message_phase(cfg, state, mv)

    # phase 2: instruction frontend (message-idle, unblocked nodes)
    may_issue = ~mv.has_msg & ~state.waiting
    f_upd, f_req, f_stats = frontend.instruction_phase(cfg, state,
                                                       may_issue)

    # merge write intents (disjoint by node: message XOR instruction)
    has = mv.has_msg
    cidx = torch.where(has, m_upd["cache_idx"], f_upd["cache_idx"])
    c_hot = cidx[:, None] == torch.arange(C, dtype=I32, device=dev)

    def intent(key):
        (mm, mval), (fm, fval) = m_upd[key], f_upd[key]
        return torch.where(has, mm, fm), torch.where(has, mval, fval)

    if _PACKED_COMMIT:
        def commit(plane, key):
            mask, val = intent(key)
            return torch.where(c_hot & mask[:, None], val[:, None], plane)

        cache_state = commit(state.cache_state, "cache_state")
        cache_addr = commit(state.cache_addr, "cache_addr")
        cache_val = commit(state.cache_val, "cache_val")

    # memory / directory: the handlers emit one block index for all
    # three (p_block); the first set mask's index is authoritative
    mm, mi, mval = m_upd["mem"]
    dm, di, dval = m_upd["dir_state"]
    bm, bi, bval = m_upd["dir_bv"]
    hidx = torch.where(mm, mi, torch.where(dm, di, bi))
    if _PACKED_COMMIT:
        h_hot = hidx[:, None] == torch.arange(M, dtype=I32, device=dev)
        memory = torch.where(h_hot & mm[:, None], mval[:, None],
                             state.memory)
        dir_state = torch.where(h_hot & dm[:, None], dval[:, None],
                                state.dir_state)
        dir_bitvec = torch.where((h_hot & bm[:, None])[..., None],
                                 bval[:, None, :], state.dir_bitvec)
    else:
        # the seam's mutant path (never shipped): one gather and one
        # index_put_ a plane, each family's planes sharing one index
        # vector; a node whose mask is unset writes its gathered old
        # value back at the clipped index (one lane a node, so no two
        # writes meet). An index out of range goes with an unset mask,
        # as in the one-hot commit.
        clip_c = cidx.clamp(0, C - 1)
        clip_h = hidx.clamp(0, M - 1)

        def plane_commit(plane, mask, val, clip):
            old = plane[rows, clip]
            keep = mask.reshape(mask.shape + (1,) * (old.ndim - 1))
            return plane.clone().index_put_(
                (rows, clip), torch.where(keep, val, old))

        cache_state = plane_commit(state.cache_state,
                                   *intent("cache_state"), clip_c)
        cache_addr = plane_commit(state.cache_addr, *intent("cache_addr"),
                                  clip_c)
        cache_val = plane_commit(state.cache_val, *intent("cache_val"),
                                 clip_c)
        memory = plane_commit(state.memory, mm, mval, clip_h)
        dir_state = plane_commit(state.dir_state, dm, dval, clip_h)
        dir_bitvec = plane_commit(state.dir_bitvec, bm, bval, clip_h)

    waiting = (state.waiting & ~m_upd["wait_clear"]) | f_upd["wait_set"]
    # stall-watchdog input: the cycle the current wait began (-1 idle)
    waiting_since = torch.where(
        waiting,
        torch.where(f_upd["wait_set"], state.cycle, state.waiting_since),
        -1)

    fetch, l_op, l_addr, l_val = f_upd["latch"]
    cur_op = torch.where(fetch, l_op, state.cur_op)
    cur_addr = torch.where(fetch, l_addr, state.cur_addr)
    cur_val = torch.where(fetch, l_val, state.cur_val)

    cand = assemble_candidates(cfg, mv, m_cand, f_req, rows)

    # phase 3: delivery
    if deliver_fn is not None:
        mb_upd, dropped, injected = deliver_fn(cfg, state, cand,
                                               state.arb_rank, new_head,
                                               new_count)
    else:
        mb_upd, dropped, injected = mailbox.deliver(
            cfg, state, cand, state.arb_rank, new_head, new_count,
            with_accept=with_ledger)
    enq_accept = mb_upd.pop("enq_accept", None)

    # scatter-mode INV application: a broadcast for address a comes only
    # from home(a), which handles one message a cycle, so each cached
    # line needs one lookup at its home
    inv_applied = torch.zeros((), dtype=I32, device=dev)
    kill_live = h = None              # [N, C] live lines the INV killed
    if inv_scatter is not None:
        im, ia, ibv = inv_scatter                  # [N], [N], [N, W]
        h = codec.home_node(cfg, cache_addr).clamp(0, N - 1)    # [N, C]
        active = im[h] & (ia[h] == cache_addr)     # the sentinel never hits
        tw = torch.div(rows, 32, rounding_mode="floor")[:, None].expand(N, C)
        word = ibv[h, tw]                          # [N, C]
        kill = active & (((word >> (rows % 32)[:, None]) & 1) == 1)
        kill_live = kill & (cache_state != int(CacheState.INVALID))
        inv_applied = kill_live.sum(dtype=I32)
        cache_state = torch.where(kill, int(CacheState.INVALID),
                                  cache_state)

    # metrics: one stacked reduction of every per-node delta
    mt = state.metrics
    has_t, t = m_stats["msg_type_onehot"]
    K = mt.msgs_processed.shape[0]
    type_onehot = ((torch.arange(K, dtype=I32, device=dev)[:, None]
                    == t[None, :]) & has_t[None, :])               # [K, N]
    lat = (state.cycle - state.waiting_since).clamp(min=1)
    bucket = floor_log2(lat).clamp(0, LAT_BUCKETS - 1)
    lat_onehot = ((torch.arange(LAT_BUCKETS, dtype=I32, device=dev)[:, None]
                   == bucket[None, :])
                  & m_stats["unblocked"][None, :])                 # [B, N]
    counters = torch.stack([
        f_stats["issued"], f_stats["read_hits"], f_stats["write_hits"],
        f_stats["read_misses"], f_stats["write_misses"],
        f_stats["upgrades"], m_stats["invalidations"],
        m_stats["evictions"]])                                     # [8, N]
    deltas = torch.cat([counters, type_onehot, lat_onehot]).sum(
        1, dtype=I32)                                              # [8+K+B]
    depth_peak = mb_upd["mb_count"].max()
    metrics = mt.replace(
        cycles=mt.cycles + 1,
        instrs_retired=mt.instrs_retired + deltas[0],
        read_hits=mt.read_hits + deltas[1],
        write_hits=mt.write_hits + deltas[2],
        read_misses=mt.read_misses + deltas[3],
        write_misses=mt.write_misses + deltas[4],
        upgrades=mt.upgrades + deltas[5],
        msgs_processed=mt.msgs_processed + deltas[8:8 + K],
        msgs_dropped=mt.msgs_dropped + dropped,
        msgs_injected_dropped=mt.msgs_injected_dropped + injected,
        invalidations=mt.invalidations + deltas[6] + inv_applied,
        evictions=mt.evictions + deltas[7],
        lat_hist=mt.lat_hist + deltas[8 + K:],
        mb_depth_peak=torch.maximum(mt.mb_depth_peak, depth_peak),
    )
    if with_profile:
        _profile_update(cfg, state, prof, rows, mv, m_cand, f_stats,
                        m_stats["unblocked"], fetch, l_addr, cache_addr,
                        kill_live, h)

    new_state = state.replace(
        cache_addr=cache_addr, cache_val=cache_val, cache_state=cache_state,
        memory=memory, dir_state=dir_state, dir_bitvec=dir_bitvec,
        instr_idx=f_upd["new_idx"], cur_op=cur_op, cur_addr=cur_addr,
        cur_val=cur_val, waiting=waiting, waiting_since=waiting_since,
        cycle=state.cycle + 1, metrics=metrics, **mb_upd)
    if not (with_events or with_telemetry or with_ledger or with_profile):
        return new_state
    out = (new_state,)
    if with_events:
        out += ({
            # instruction fetch (assignment.c:649-652)
            "fetch": fetch, "op": l_op, "addr": l_addr, "value": l_val,
            # message dequeue (assignment.c:179-182)
            "msg": mv.has_msg, "msg_sender": mv.sender,
            "msg_type": mv.type, "msg_addr": mv.addr,
        },)
    if with_telemetry:
        out += ({
            "counters": torch.stack([
                deltas[0], deltas[1], deltas[2], deltas[3], deltas[4],
                deltas[5], deltas[6] + inv_applied, deltas[7]]),   # [8]
            "msgs_processed": deltas[8:8 + K],
            "msgs_dropped": dropped,
            "msgs_injected_dropped": injected,
            "lat_hist": deltas[8 + K:],
            # mailbox queue-depth watermarks after this cycle's delivery
            "queue_depth_max": depth_peak,
            "queue_depth_total": mb_upd["mb_count"].sum(dtype=I32),
            "dir_occupancy": torch.stack(
                [(dir_state == int(s)).sum(dtype=I32)
                 for s in (DirState.EM, DirState.S, DirState.U)]),
            "waiting_nodes": waiting.sum(dtype=I32),
        },)
    if with_ledger:
        n_dt = (torch.int8 if N <= 127 else
                torch.int16 if N <= 32767 else I32)
        a_dt = torch.int16 if cfg.invalid_address <= 32767 else I32
        i8 = torch.int8
        ledger = {
            # phase-1 dequeue record (masked by deq_has)
            "deq_has": mv.has_msg, "deq_sender": mv.sender.to(n_dt),
            "deq_type": mv.type.to(i8), "deq_addr": mv.addr.to(a_dt),
            # phase-3 candidates and the final accept mask, (sender,
            # program-order slot) layout
            "enq_accept": enq_accept, "enq_type": cand.type.to(i8),
            "enq_recv": cand.recv.to(n_dt), "enq_addr": cand.addr.to(a_dt),
            # phase-2 fetch latch; issue = this fetch opened a wait
            "fetch": fetch, "issue": f_upd["wait_set"],
            "op": l_op.to(i8), "addr": l_addr.to(a_dt), "value": l_val,
            # wait cleared this cycle (span end)
            "unblocked": m_stats["unblocked"],
        }
        if with_obs:
            # an instruction retires at its fetch (hit) or at its
            # unblock (fill); obs_val is the retiring node's own cached
            # value of the in-flight address after this cycle, -1 where
            # the line is absent or INVALID
            ci = codec.cache_index(cfg, cur_addr).to(torch.int64)
            ledger["obs_retire"] = ((fetch & ~f_upd["wait_set"])
                                    | m_stats["unblocked"])
            ledger["obs_val"] = torch.where(
                (cache_addr[rows, ci] == cur_addr)
                & (cache_state[rows, ci] != int(CacheState.INVALID)),
                cache_val[rows, ci], -1).to(torch.int16)
        out += (ledger,)
    if with_profile:
        out += (prof,)
    return out


def _fan_hist(fan: torch.Tensor) -> torch.Tensor:
    """[FANOUT_BUCKETS] power-of-two histogram of the broadcasting homes'
    fan-outs; fan-out 0 records nothing."""
    fb = (floor_log2(fan.clamp(min=1)) + 1).clamp(1, FANOUT_BUCKETS - 1)
    bins = torch.arange(FANOUT_BUCKETS, dtype=I32, device=fan.device)
    return ((bins[:, None] == fb[None, :])
            & (fan > 0)[None, :]).sum(1, dtype=I32)


def _profile_update(cfg: SystemConfig, state: SimState, prof: dict, rows,
                    mv, m_cand, f_stats, unblocked, fetch, l_addr,
                    cache_addr, kill_live, h) -> None:
    """This cycle's coherence-profile counts, added into ``prof`` in
    place (JAX ``ops/step.py:449-555``). Every scatter of JAX's drops
    its masked lanes; here a masked lane adds 0 at a clipped index."""
    N, C = cfg.num_nodes, cfg.cache_size
    A = profile_space(cfg)
    i64 = torch.int64
    issued = f_stats["issued"]
    rh, wh = f_stats["read_hits"], f_stats["write_hits"]
    rm, wm = f_stats["read_misses"], f_stats["write_misses"]
    upg = f_stats["upgrades"]
    miss = rm | wm
    r64 = rows.to(i64)
    addr_f = l_addr.clamp(0, A - 1).to(i64)
    # miss taxonomy against the pre-commit tags (state.cache_*): tag
    # matches but INVALID -> coherence; no match and never fetched ->
    # cold; otherwise a conflict eviction
    ci_f = codec.cache_index(cfg, l_addr).clamp(0, C - 1).to(i64)
    tag_f = state.cache_addr[r64, ci_f]
    st_f = state.cache_state[r64, ci_f]
    coh = miss & (tag_f == l_addr) & (st_f == int(CacheState.INVALID))
    seen = prof["ever"][r64, addr_f]
    cold = miss & ~coh & ~seen
    conf = miss & ~coh & seen
    classes = torch.stack([cold, conf, coh, upg], dim=1).to(I32)   # [N, 4]
    flat = r64 * A + addr_f
    prof["rd"].view(-1).index_add_(0, flat, (rh | rm).to(I32))
    prof["wr"].view(-1).index_add_(0, flat, (wh | wm).to(I32))
    prof["ever"][r64, addr_f] = seen | issued
    prof["miss_node"] += classes
    prof["miss_addr"].index_add_(0, addr_f, classes)

    if kill_live is not None:
        # scatter mode: victims and fan-out from this cycle's kill plane
        live = kill_live.reshape(-1).to(I32)
        prof["inv_addr"].index_add_(
            0, cache_addr.clamp(0, A - 1).reshape(-1).to(i64), live)
        fan = torch.zeros(N, dtype=I32, device=rows.device)
        fan.index_add_(0, h.reshape(-1).to(i64), live)
        prof["inv_fanout"] += _fan_hist(fan)
    else:
        # mailbox mode: victims where the INV dequeues on a matching
        # tag; fan-out at the home that emitted the INV slots
        ci_m = codec.cache_index(cfg, mv.addr).clamp(0, C - 1).to(i64)
        deq_inv = (mv.has_msg & (mv.type == int(Msg.INV))
                   & (state.cache_addr[r64, ci_m] == mv.addr))
        prof["inv_addr"].index_add_(0, mv.addr.clamp(0, A - 1).to(i64),
                                    deq_inv.to(I32))
        sent = m_cand["inv"][0] == int(Msg.INV)                    # [N, N]
        prof["inv_fanout"] += _fan_hist(sent.sum(1, dtype=I32))

    # dirty writebacks, counted once at the home's dequeue
    wb = (mv.has_msg
          & ((mv.type == int(Msg.FLUSH)) | (mv.type == int(Msg.FLUSH_INVACK))
             | (mv.type == int(Msg.EVICT_MODIFIED)))
          & (codec.home_node(cfg, mv.addr) == rows))
    prof["wb_addr"].index_add_(0, mv.addr.clamp(0, A - 1).to(i64),
                               wb.to(I32))

    # ownership migration: a retiring WRITE on an address whose previous
    # retiring writer was another node; lowest node id wins a collision
    w_ret = (wh & ~upg) | (unblocked & (state.cur_op == int(Op.WRITE)))
    w_a = torch.where(fetch, l_addr, state.cur_addr).clamp(0, A - 1)
    w_a = w_a.to(i64)
    prev = prof["last_writer"][w_a]
    mig = w_ret & (prev >= 0) & (prev != rows)
    prof["mig_addr"].index_add_(0, w_a, mig.to(I32))
    cand_w = torch.full((A + 1,), INT32_MAX, dtype=I32, device=rows.device)
    cand_w.scatter_reduce_(0, torch.where(w_ret, w_a, A), rows, "amin")
    cand_w = cand_w[:A]
    prof["last_writer"].copy_(torch.where(cand_w != INT32_MAX, cand_w,
                                          prof["last_writer"]))


def assemble_candidates(cfg: SystemConfig, mv, m_cand, f_req,
                        rows) -> mailbox.Candidates:
    """The [N, S] candidate planes: slot 0 is the message phase's
    primary send XOR the frontend's request, slot 1 the secondary send,
    then (mailbox mode) the N INV fan-out slots, last the eviction."""
    N, Wm = cfg.num_nodes, cfg.msg_bitvec_words
    dev = rows.device
    zero = torch.zeros((N,), dtype=I32, device=dev)
    zbv = torch.zeros((N, Wm), dtype=I32, device=dev)
    pt, pr, pa, pv, ps, pd, pb = m_cand["pri"]
    rt, rr_, ra, rv = f_req
    use_req = ~mv.has_msg
    s0 = (torch.where(use_req, rt, pt), torch.where(use_req, rr_, pr),
          torch.where(use_req, ra, pa), torch.where(use_req, rv, pv),
          torch.where(use_req, 0, ps), torch.where(use_req, 0, pd))
    s0_bitvec = torch.where(use_req[:, None], zbv, pb)
    st_, sr_, sa_, sv_, ss_ = m_cand["sec"]
    et_, er_, ea_, ev_ = m_cand["ev"]
    sec = (st_, sr_, sa_, sv_, ss_, zero)
    ev = (et_, er_, ea_, ev_, zero, zero)
    if cfg.inv_mode == "mailbox":
        it_, ir_, ia_ = m_cand["inv"]
        zn = torch.zeros((N, N), dtype=I32, device=dev)
        inv = (it_, ir_, ia_, zn, zn, zn)
        planes = [torch.cat([torch.stack([a, b], 1), i, e[:, None]], 1)
                  for a, b, i, e in zip(s0, sec, inv, ev)]
        bitvec = torch.cat([torch.stack([s0_bitvec, zbv], 1),
                            torch.zeros((N, N, Wm), dtype=I32, device=dev),
                            zbv[:, None]], 1)
    else:
        planes = [torch.stack([a, b, e], 1) for a, b, e in zip(s0, sec, ev)]
        bitvec = torch.stack([s0_bitvec, zbv, zbv], 1)
    c_type, c_recv, c_addr, c_value, c_second, c_dirstate = planes
    return mailbox.Candidates(
        type=c_type, recv=c_recv, sender=rows[:, None].expand_as(c_type),
        addr=c_addr, value=c_value, second=c_second, dirstate=c_dirstate,
        bitvec=bitvec)


# -- runners ---------------------------------------------------------------

def run_cycles(cfg: SystemConfig, state: SimState, num_cycles: int,
               deliver_fn=None) -> SimState:
    """Run a fixed number of cycles."""
    for _ in range(num_cycles):
        state = cycle(cfg, state, deliver_fn=deliver_fn)
    return state


def run_cycles_traced(cfg: SystemConfig, state: SimState, num_cycles: int,
                      message_phase=None):
    """Run ``num_cycles`` cycles collecting the per-cycle event record:
    (state, events) with events a dict of [num_cycles, N] tensors, the
    data of the reference's printf tracing (``utils.eventlog`` renders it
    in the ``instruction_order.txt`` line format). ``message_phase`` is
    the handler-phase override ``cycle`` takes, so a mutated engine's
    run can be traced too."""
    per_cycle = []
    for _ in range(num_cycles):
        state, ev = cycle(cfg, state, with_events=True,
                          message_phase=message_phase)
        per_cycle.append(ev)
    if not per_cycle:
        N = cfg.num_nodes
        _, ev = cycle(cfg, state, with_events=True,
                      message_phase=message_phase)
        return state, {k: v.new_empty((0, N)) for k, v in ev.items()}
    return state, {k: torch.stack([ev[k] for ev in per_cycle])
                   for k in per_cycle[0]}


def _stack(samples: list, empty: dict) -> dict:
    """Per-cycle sample dicts stacked into [T, ...] tensors; ``empty``
    (one sample) gives the shapes and dtypes when T is 0."""
    if not samples:
        return {k: v.new_empty((0,) + tuple(v.shape))
                for k, v in empty.items()}
    return {k: torch.stack([x[k] for x in samples]) for k in samples[0]}


def run_cycles_telemetry(cfg: SystemConfig, state: SimState,
                         num_cycles: int, message_phase=None,
                         with_ledger: bool = False):
    """Run ``num_cycles`` cycles collecting the per-cycle telemetry
    (JAX ``ops/step.py:706``): (state, telem) with telem a dict of
    [num_cycles, ...] tensors (``cycle``'s with_telemetry contract), the
    series behind ``stats --timeseries`` and ``obs/timeseries.py``.
    ``with_ledger=True`` also stacks the message ledger: (state, telem,
    ledger). ``message_phase`` is ``cycle``'s handler-phase override."""
    tel, led = [], []
    for _ in range(num_cycles):
        out = cycle(cfg, state, with_telemetry=True,
                    with_ledger=with_ledger, message_phase=message_phase)
        state = out[0]
        tel.append(out[1])
        if with_ledger:
            led.append(out[2])
    if not tel:
        probe = cycle(cfg, state, with_telemetry=True,
                      with_ledger=with_ledger, message_phase=message_phase)
    telem = _stack(tel, None if tel else probe[1])
    if with_ledger:
        return state, telem, _stack(led, None if led else probe[2])
    return state, telem


def run_cycles_ledger(cfg: SystemConfig, state: SimState, num_cycles: int,
                      message_phase=None, with_obs: bool = False):
    """Run ``num_cycles`` cycles collecting only the message ledger (JAX
    ``ops/step.py:750``): (state, ledger), the samples bit-identical to
    ``run_cycles_telemetry(..., with_ledger=True)``'s. ``with_obs=True``
    adds LEDGER_OBS_FIELDS (the axiomatic checker's retire record)."""
    led = []
    for _ in range(num_cycles):
        state, sample = cycle(cfg, state, with_ledger=True,
                              with_obs=with_obs,
                              message_phase=message_phase)
        led.append(sample)
    if not led:
        probe = cycle(cfg, state, with_ledger=True, with_obs=with_obs,
                      message_phase=message_phase)[1]
    return state, _stack(led, None if led else probe)


def run_cycles_profile(cfg: SystemConfig, state: SimState, num_cycles: int,
                       message_phase=None):
    """Run ``num_cycles`` cycles accumulating the coherence-profile planes
    (JAX ``ops/step.py:789``): (state, prof), prof a ``profile_zeros``
    dict on the state's device after accumulation. The planes ride the
    carry, so the capture's memory is independent of the run length."""
    prof = profile_zeros(cfg, state.device)
    for _ in range(num_cycles):
        state, prof = cycle(cfg, state, message_phase=message_phase,
                            with_profile=True, prof=prof)
    return state, prof


# lint: host
def run_chunked_to_quiescence(cfg: SystemConfig, state: SimState,
                              chunk: int = 32, max_cycles: int = 100_000,
                              message_phase=None,
                              deliver_fn=None) -> SimState:
    """while not quiescent and cycle < max_cycles: run `chunk` cycles.

    The predicate is read once per chunk (one host sync), so a run may
    pass quiescence or ``max_cycles`` by up to chunk - 1 cycles; a
    quiescent state is a fixpoint of ``cycle`` apart from the cycle
    counters, so the final state is the same."""
    while bool(~state.quiescent() & (state.cycle < max_cycles)):
        for _ in range(chunk):
            state = cycle(cfg, state, message_phase=message_phase,
                          deliver_fn=deliver_fn)
    return state


def run_to_quiescence(cfg: SystemConfig, state: SimState,
                      max_cycles: int = 100_000,
                      message_phase=None) -> SimState:
    """Run until no work remains, stopping exactly at max_cycles."""
    return run_chunked_to_quiescence(cfg, state, 1, max_cycles,
                                     message_phase)


# -- batched wave runners (the serving layer) -------------------------------
#
# JAX ops/step.py:885-1008. A [B, ...] batch of independent machines
# (state.stack_states) steps as ONE ``cycle`` under torch.func.vmap over
# the job axis: the Python body of ``cycle`` runs once a wave cycle, and
# a wave cycle's launches (one machine's cycle's, the freeze's and the
# done mask's) do not grow with B.
# Each cycle freezes the jobs that are done (quiescent, or at
# ``max_cycles``): they keep their old leaves. A quiescent state is a
# fixpoint of ``cycle`` apart from the cycle counters, so every job ends
# bit-identical to its solo run at chunk 1, cycle count included.

#: leaves ``cycle`` reads and never writes (JAX ``_RO_FIELDS``): they go
#: into the vmapped cycle, and only the other leaves come back
_RO_FIELDS = ("instr_op", "instr_addr", "instr_val", "issue_delay",
              "issue_period", "arb_rank", "order_rank")
_RW = tuple(i for i, f in enumerate(SIM_LEAVES) if f not in _RO_FIELDS)


def _wave_cycle(cfg: SystemConfig, message_phase):
    """``cycle`` vmapped over the job axis, as a function of a batch's
    leaves (state.SIM_LEAVES order) returning the leaves at _RW."""
    if cfg.drop_prob > 0.0:
        raise ValueError("the wave runners step fault-free configs: "
                         "drop_prob > 0 draws inside the cycle, which "
                         "no wave supports (ROADMAP.md, Queue 1 item 5)")

    def one(*leaves):
        out = state_leaves(cycle(cfg, from_leaves(leaves),
                                 message_phase=message_phase))
        return tuple(out[i] for i in _RW)
    return torch.func.vmap(one)


def _wave_done(bstate: SimState, max_cycles: int) -> torch.Tensor:
    """[B] bool: the job is quiescent or out of its cycle budget."""
    return batch_quiescent(bstate) | (bstate.cycle >= max_cycles)


def _masked_cycles(cfg: SystemConfig, bstate: SimState, chunk: int,
                   max_cycles: int, message_phase) -> SimState:
    """``chunk`` wave cycles, each freezing the jobs done before it;
    no host read."""
    step_all = _wave_cycle(cfg, message_phase)
    leaves = list(state_leaves(bstate))
    for _ in range(chunk):
        done = _wave_done(from_leaves(leaves), max_cycles)
        for i, new in zip(_RW, step_all(*leaves)):
            keep = done.reshape(done.shape + (1,) * (new.ndim - 1))
            leaves[i] = torch.where(keep, leaves[i], new)
    return from_leaves(leaves)


def batched_wave(cfg: SystemConfig, bstate: SimState, chunk: int,
                 max_cycles: int, message_phase=None) -> SimState:
    """Run a [B, ...] batch of independent machines until every job is
    quiescent or at ``max_cycles`` (JAX ``ops/step.py:885``): chunks of
    ``chunk`` masked wave cycles, the [B] live mask read on the host once
    before each chunk, where the JAX ``while_loop`` tests it. Every job's
    final state equals its solo ``run_to_quiescence``."""
    while bool((~_wave_done(bstate, max_cycles)).any()):
        bstate = _masked_cycles(cfg, bstate, chunk, max_cycles,
                                message_phase)
    return bstate


def run_wave_to_quiescence(cfg: SystemConfig, bstate: SimState,
                           chunk: int = 32, max_cycles: int = 100_000,
                           message_phase=None) -> SimState:
    """``batched_wave`` (JAX ``ops/step.py:937``, where it is the jitted
    form with the batch donated). The batch passed in is not written,
    but the result shares its read-only leaves (_RO_FIELDS) with it: a
    later ``state.set_state`` on the result writes through to it."""
    return batched_wave(cfg, bstate, chunk, max_cycles, message_phase)


def batched_wave_chunk(cfg: SystemConfig, bstate: SimState, chunk: int,
                       max_cycles: int, message_phase=None) -> tuple:
    """Exactly one ``chunk``-cycle masked slice of a wave (JAX
    ``ops/step.py:954``): the scheduler owns the loop, and between chunks
    the daemon swaps finished jobs out and queued jobs in
    (``state.set_state``) while the other slots are mid-flight. Returns
    ``(bstate, quiescent, done)``, the two [B] bool masks on the batch's
    device (done: quiescent or out of cycle budget); reading them is the
    one host read a chunk."""
    bstate = _masked_cycles(cfg, bstate, chunk, max_cycles, message_phase)
    quiet = batch_quiescent(bstate)
    return bstate, quiet, quiet | (bstate.cycle >= max_cycles)


def run_wave_chunk(cfg: SystemConfig, bstate: SimState, chunk: int = 16,
                   max_cycles: int = 100_000, message_phase=None) -> tuple:
    """``batched_wave_chunk`` (JAX ``ops/step.py:995``, the jitted form
    with the batch donated). The batch passed in is not written, but the
    result shares its read-only leaves (_RO_FIELDS) with it: a later
    ``state.set_state`` on the result writes through to it."""
    return batched_wave_chunk(cfg, bstate, chunk, max_cycles,
                              message_phase)
