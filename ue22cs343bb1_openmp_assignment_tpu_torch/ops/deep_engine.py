"""Deep-window transactional engine: dense own-entry chains plus
absorbed remote requests, in PyTorch.

The port of the JAX package's ``ops/deep_engine.py``; its module
docstring holds the design and the serialization argument, which this
code follows step for step. A round is:

1. the instruction window [W, N] (procedural hash or stored-trace
   gather);
2. the pre-pass fold (every step attempted), giving each node's remote
   event slots and own-entry mark/poison flags;
3. the round middle (``deep_round_core``): the claim scatter-min on
   DM_CLAIM, the dense own-lane codes, the flag-pass fold
   (``cfg.deep_exact_flags``), the verdict gathers, absorption waves and
   read storms, the replay fold, the dense merge of own rows, request
   composition, reply patches and the fan-out;
4. metrics and cursors (``_finish_round_deep``).

The three folds run either as the CUDA kernel (``ops/deep_fold_kernel``,
one thread per node) or as the plain PyTorch fold (``_fold_deep``). The
middle is the same code for both, and is plain tensor code: gathers,
scatters and a scatter-min, held to the JAX index semantics by
``TorchIndexOps`` (clipped gathers, dropped scatters through a spare
row).

The round's anatomy (``return_stats``) and its coherence-profile delta
(``return_profile``; ``run_deep_profile`` sums them, JAX
``ops/deep_engine.py:1216``) read fold internals that the CUDA fold
kernels do not export, so they run the plain folds on any device, as
JAX runs them only on its XLA fold (its Pallas and fused folds never
produce them).
"""

from __future__ import annotations

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch import codec
from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.ops import deep_fold
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.deep_fold import (
    ACT_DOWN, ACT_KILL, ACT_NONE, ACT_PROMOTE, K_EVM, K_EVS, K_PROBE,
    K_RD, K_UP, K_WR, wi)
from ue22cs343bb1_openmp_assignment_tpu_torch.ops.sync_engine import (
    DM_ACT, DM_CLAIM, DM_COLS, DM_COUNT, DM_MEM, DM_OWNER, DM_REQ,
    DM_STATE, INT32_MAX, SyncState, _round_key_rs, claim_max_rounds,
    slot_bits)
from ue22cs343bb1_openmp_assignment_tpu_torch.procedural import (
    procedural_instr)
from ue22cs343bb1_openmp_assignment_tpu_torch.types import (CacheState, Op,
                                                            DirState)

# dense per-own-entry flag bits (fold output, gathered by remote events)
F_MARK, F_POISON = 1, 2

#: width of the requester-id field of DM_REQ and of the fan-out's line
#: word: node ids sit below 1 << REQ_BITS, the read storm's canonical
#: "matches nobody" requester is the all-ones field, the round-value
#: channel sits above the field in DM_REQ and the line's action bits
#: above it in the fan-out word. csrc/deep_round.cu packs the same
#: layout; analysis/kernelcheck derives both words' budgets from it.
REQ_BITS = 16

#: column order of the per-address / per-node abort-attribution planes
#: (round_step_deep(return_profile=True) / run_deep_profile): a slot
#: failed to commit because a GHOST poison flag (never confirmed by the
#: committed replay) or a REAL one aborted it, a mark aborted its
#: eviction notice, it lost its arbitration lane, or its cache-hit probe
#: was unsafe
PROFILE_ABORT_CLASSES = ("poison_ghost", "poison_real", "mark",
                         "lane_loss", "probe")

#: column order of the per-node window-stop counters (the replay fold's
#: stop reasons: slot-budget overflow, ownerval-slot overflow, same-entry
#: re-touch, cross-slot dependency, liveness cap)
PROFILE_STOP_CLASSES = ("over_q", "over_g", "dup", "dep", "live")

I32 = torch.int32

# the carry fields _fold_deep stacks back to [rows, N] tensors
_STACKED = ("ca", "cv", "cs", "cv_src", "rrf", "wf", "lwh", "cv_req",
            "cv_req_src", "dms", "dmc", "dmo", "dmm", "dmm_src",
            "touched", "act_acc", "mark", "poison", "kind", "ent",
            "sval", "comm", "rel", "relv", "reld", "g_owner",
            "g_ci")


def state_tiles(cfg: SystemConfig, st: SyncState):
    """Transposed state views both fold backends consume: cache planes
    [C, N], own-directory planes [S, N] (state/count/owner/mem), all
    contiguous (the kernel reads rows along N)."""
    N, S = cfg.num_nodes, 1 << cfg.block_bits
    dm_own = st.dm.reshape(N, S, DM_COLS)
    dm_t4 = tuple(dm_own[:, :, col].T.contiguous()
                  for col in (DM_STATE, DM_COUNT, DM_OWNER, DM_MEM))
    return (st.cache_addr.T.contiguous(), st.cache_val.T.contiguous(),
            st.cache_state.T.contiguous(), dm_t4)


def window(cfg: SystemConfig, st: SyncState):
    """The round's instruction window (w_oa, w_val, w_live), each
    [W, N]: the procedural hash, or a clamped gather of stored traces."""
    N = cfg.num_nodes
    W = cfg.drain_depth + cfg.txn_width
    T = st.instr_pack.shape[1]
    rows = torch.arange(N, dtype=I32, device=st.device)
    offs_w = torch.arange(W, dtype=I32, device=st.device)[:, None]
    w_idx = st.idx[None, :] + offs_w
    w_live = w_idx < st.instr_count[None, :]
    if cfg.procedural:
        w_oa, w_val = procedural_instr(cfg, rows[None, :], w_idx)
    else:
        w_flat = rows[None, :] * T + torch.clamp(w_idx, max=T - 1)
        w = st.instr_pack.reshape(N * T, 2)[w_flat.long()]
        w_oa, w_val = w[..., 0], w[..., 1]
    return w_oa.contiguous(), w_val.contiguous(), w_live


def _fold_deep(cfg: SystemConfig, st: SyncState, tiles, w_oa, w_val,
               w_live, bad=None, ocode=None):
    """Drive the layout-neutral fold (ops.deep_fold) with a Python loop
    over the W window steps, in [N]-vec layout. Inputs and outputs use
    the transposed tile layout shared with the kernel (cache [C, N],
    own-slice [S, N], slots [Q, N], window [W, N]).

    Pre-pass: bad/ocode None (attempt everything, no truncation);
    replay: bad [Q, N] slot verdicts + ocode [S, N] own-lane codes.
    Returns the final carry with list fields stacked back to [rows, N]
    tensors and the miss counters under ``cnt``."""
    N, C, S = cfg.num_nodes, cfg.cache_size, 1 << cfg.block_bits
    W = cfg.drain_depth + cfg.txn_width
    Q = cfg.deep_slots
    ca_t, cv_t, cs_t, dm_t4 = tiles
    dev = ca_t.device
    rows = torch.arange(N, dtype=I32, device=dev)
    zero = torch.zeros((N,), dtype=I32, device=dev)
    false = torch.zeros((N,), dtype=torch.bool, device=dev)
    c = deep_fold.fold_carry0(
        cfg,
        ca=list(ca_t.unbind(0)), cv=list(cv_t.unbind(0)),
        cs=list(cs_t.unbind(0)),
        dm_rows=dict(dms=list(dm_t4[0].unbind(0)),
                     dmc=list(dm_t4[1].unbind(0)),
                     dmo=list(dm_t4[2].unbind(0)),
                     dmm=list(dm_t4[3].unbind(0))),
        zero=zero, false=false)
    badL = [zero] * Q if bad is None else list(bad.unbind(0))
    ocodeL = [zero] * S if ocode is None else list(ocode.unbind(0))
    for k in range(W):
        c = deep_fold.fold_step(cfg, c, rows, w_oa[k], w_val[k],
                                w_live[k], k, st.horizon, badL, ocodeL)
    out = dict(c)
    for f in _STACKED:
        out[f] = torch.stack(c[f], dim=0)
    out["cnt"] = dict(rd_miss=c["c_rd"], wr_miss=c["c_wr"],
                      upg=c["c_up"], ev=c["c_ev"])
    return out


class TorchIndexOps:
    """The round middle's seven index families with JAX's semantics.

    Gather indices are in range (callers clip, as in the JAX package).
    Scatter indices use the one-past-the-end sentinel E for dropped
    lanes (``mode="drop"`` in JAX); here every index outside [0, E) goes
    to a spare row E that is sliced off, which keeps the ops free of
    host syncs. ``scatter_rows``/``scatter_col`` indices are unique
    among kept lanes, except the read storm's duplicate rows, which are
    bit-identical, so the order of writes cannot show."""

    @staticmethod
    def _spare(idx, E):
        return torch.where((idx >= 0) & (idx < E), idx, E).to(torch.int64)

    def scatter_min(self, dest, idx, vals):
        """dest[idx] = min(dest[idx], vals) with drop semantics."""
        E = dest.shape[0]
        out = torch.cat([dest, dest.new_full((1,), INT32_MAX)])
        out.scatter_reduce_(0, self._spare(idx, E), vals, "amin",
                            include_self=True)
        return out[:E]

    def gather(self, plane, idx):
        """plane[idx] for a 1-D plane; idx any shape, in range."""
        return plane[idx.to(torch.int64)]

    def gather_rows(self, mat, idx):
        """mat[idx] for [M, K] mat -> [*idx.shape, K]."""
        return mat[idx.to(torch.int64)]

    def scatter_rows(self, mat, idx, rows_):
        """mat[idx] = rows_ with drop semantics; idx unique."""
        E = mat.shape[0]
        out = torch.cat([mat, mat.new_zeros((1,) + mat.shape[1:])])
        out[self._spare(idx, E)] = rows_
        return out[:E]

    def scatter_col(self, mat, idx, col, vals):
        """mat[idx, col] = vals with drop semantics; idx unique."""
        E = mat.shape[0]
        out = torch.cat([mat, mat.new_zeros((1,) + mat.shape[1:])])
        out[self._spare(idx, E), col] = vals
        return out[:E]


def round_step_deep(cfg: SystemConfig, st: SyncState,
                    fold_impl: str = "kernel", with_events: bool = False,
                    return_stats: bool = False,
                    return_profile: bool = False):
    """One deep-window round.

    ``fold_impl`` selects how the three W-step folds run: ``"kernel"``
    (the default) calls the CUDA kernel's wrappers, which launch the
    kernel for CUDA tensors and take the plain fold only for CPU
    tensors; ``"plain"`` runs the plain folds (``deep_fold_kernel.PLAIN``,
    the PyTorch ``_fold_deep``) on any device. The round middle is this
    module's code either way.

    ``with_events`` also returns the round's retirement record, read
    from the replay fold's ``n_ret`` (so on the card the event record
    comes through the fold kernels): (state, {"retired", "op", "addr",
    "value"}), each [N, W].

    ``return_stats`` instead returns (state, stats): the round's anatomy
    as 0-d sums (JAX ``ops/deep_engine.py:1122``). ``return_profile``
    instead returns (state, delta): the round's additive coherence-
    profile planes (``deep_profile_zeros``'s keys; JAX ``:1145``). One
    round returns one extra value, so these exclude ``with_events`` and
    each other, and both need ``fold_impl="plain"`` (JAX: its XLA fold):
    they read fold internals (the committed poison flags, the stop
    reasons) that the fold kernels do not export."""
    if fold_impl not in ("kernel", "plain"):
        raise ValueError(f"fold_impl must be 'kernel' or 'plain', "
                         f"not {fold_impl!r}")
    if with_events and return_stats:
        raise ValueError("with_events and return_stats are mutually "
                         "exclusive (one round returns one extra value)")
    if return_profile and (with_events or return_stats):
        raise ValueError("return_profile is exclusive with with_events/"
                         "return_stats (one round returns one extra "
                         "value)")
    if (return_stats or return_profile) and fold_impl != "plain":
        raise ValueError("return_stats/return_profile need the plain fold "
                         "(the CUDA fold kernels do not export the "
                         "anatomy fields)")
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops import (
        deep_fold_kernel as dfk)
    folds = dfk.WRAPPERS if fold_impl == "kernel" else dfk.PLAIN
    tiles = state_tiles(cfg, st)
    win = window(cfg, st)
    pre = folds["pre"](cfg, st, tiles, *win)

    def fold_flags_fn(oc):
        return folds["flags"](cfg, st, tiles, *win, oc)

    def fold_replay_fn(bad, oc):
        if return_stats or return_profile:
            # the whole final carry: the anatomy reads poison, the stop
            # reasons and the truncation flags
            return _fold_deep(cfg, st, tiles, *win, bad=bad, ocode=oc)
        return folds["replay"](cfg, st, tiles, *win, bad, oc)

    core = deep_round_core(cfg, st.dm, st.round, st.seed, pre,
                           fold_flags_fn, fold_replay_fn, TorchIndexOps())
    return _finish_round_deep(cfg, st, core, win[0], win[1], with_events,
                              return_stats, return_profile)


def deep_round_core(cfg: SystemConfig, dm0, round_, seed, pre,
                    fold_flags_fn, fold_replay_fn, ix):
    """The round middle, from the pre-pass fold's slots through the
    fan-out, with every dynamic memory access routed through ``ix`` and
    the two later folds injected as callbacks. ``dm0`` [E, DM_COLS];
    round_/seed 0-d int32 tensors. Returns post-round cache planes
    [C, N], directory [E, DM_COLS], per-node metric delta rows [10, N]
    and the replay-fold output."""
    N, C, S = cfg.num_nodes, cfg.cache_size, 1 << cfg.block_bits
    E = N * S
    Q = cfg.deep_slots
    G = cfg.deep_ownerval_slots
    INV = int(CacheState.INVALID)
    EXC = int(CacheState.EXCLUSIVE)
    SHD = int(CacheState.SHARED)
    D_U, D_S, D_EM = int(DirState.U), int(DirState.S), int(DirState.EM)
    dev = dm0.device
    rows = torch.arange(N, dtype=I32, device=dev)
    dm_own = dm0.reshape(N, S, DM_COLS)
    kind, ent, sval = pre["kind"], pre["ent"], pre["sval"]   # [Q, N]
    is_req = (kind == K_RD) | (kind == K_WR) | (kind == K_UP)
    is_ev = (kind == K_EVS) | (kind == K_EVM)
    is_probe = kind == K_PROBE

    # ---- lane scatter (requests + notices only) --------------------------
    # lane key layout: [countdown | (is_rd) | prio | slot | ev_bit]
    prio_bits = max(1, (N - 1).bit_length())
    SB = slot_bits(cfg)
    rk = _round_key_rs(cfg, round_, seed, rows)
    prio = rk & ((1 << prio_bits) - 1)
    countdown = rk >> prio_bits
    ST = 1 if cfg.deep_read_storm else 0
    key = ((countdown << (prio_bits + 1 + SB + ST))
           | (prio << (1 + SB)))                             # fill key
    key_q = key[None, :]
    if SB:
        key_q = key_q | (torch.arange(Q, dtype=I32, device=dev)[:, None]
                         << 1)
    key_q = torch.where(is_ev, key_q | 1, key_q.expand(Q, N))  # [Q, N]
    if ST:
        key_q = torch.where(kind == K_RD,
                            key_q | (1 << (prio_bits + 1 + SB)), key_q)
    lane_idx = torch.where(is_req | is_ev, ent, E).reshape(-1)
    claim = ix.scatter_min(dm0[:, DM_CLAIM], lane_idx,
                           key_q.reshape(-1))                 # [E]

    safe_ent = torch.clamp(ent, 0, E - 1)
    # fresh lane keys this round sit strictly below every stale key
    thresh = (torch.clamp(claim_max_rounds(cfg) - round_, min=0) + 1) \
        << (prio_bits + 1 + SB + ST)
    pmask = (1 << prio_bits) - 1
    prio_self = prio[None, :]                                # [1, N]
    # chain-yield codes (dense own-slice reads; any fresh key there is
    # foreign)
    own_lane = claim.reshape(N, S).T
    o_fresh = own_lane < thresh                              # [S, N]
    o_ev = (own_lane & 1) == 1
    o_beats = ((own_lane >> (1 + SB)) & pmask) < prio_self
    o_code = (o_fresh.to(I32) * deep_fold.OC_FRESH
              | (o_fresh & o_ev).to(I32) * deep_fold.OC_EV
              | (o_fresh & o_beats).to(I32)
              * deep_fold.OC_BEATS).contiguous()             # [S, N]

    # ---- flag-pass fold: commit-prefix-sharp marker/poison ---------------
    if cfg.deep_exact_flags:
        fpass = fold_flags_fn(o_code)
        flag_mark, flag_poison = fpass["mark"], fpass["poison"]
    else:
        flag_mark, flag_poison = pre["mark"], pre["poison"]
    poison_src = flag_poison

    # ---- gathers: lane-back + dense home flags (ONE fused gather) --------
    flags_arr = (flag_mark.to(I32) * F_MARK
                 + flag_poison.to(I32) * F_POISON).T.reshape(E)
    side = torch.stack([claim, flags_arr], dim=-1)
    got2 = ix.gather_rows(side, safe_ent)                    # [Q, N, 2]
    lane_got, got_flags = got2[..., 0], got2[..., 1]

    # ---- truncation ------------------------------------------------------
    lane_fresh = lane_got < thresh
    lane_is_ev = (lane_got & 1) == 1
    won = lane_got == key_q
    prio_home = (_round_key_rs(cfg, round_, seed,
                               safe_ent >> cfg.block_bits) & pmask)
    home_wins = prio_home < prio_self                        # [Q, N]
    clean_self = ~torch.any(poison_src, dim=0)               # [N]
    req_abort = (is_req & ((got_flags & F_POISON) != 0) & home_wins
                 & ~clean_self[None, :])
    # ---- absorption waves (cfg.deep_waves > 1) ---------------------------
    won_list = [won]
    won_any = won
    for _ in range(cfg.deep_waves - 1):
        cand = is_req & ~req_abort & ~won_any
        wave_idx = torch.where(cand, ent, E).reshape(-1)
        lane_j = ix.scatter_min(
            torch.full((E,), INT32_MAX, dtype=I32, device=dev),
            wave_idx, key_q.reshape(-1))
        won_j = cand & (ix.gather(lane_j, safe_ent) == key_q)
        won_list.append(won_j)
        won_any = won_any | won_j
    # ---- read-storm bulk grant (cfg.deep_read_storm) ---------------------
    ev_abort = is_ev & ((got_flags & F_MARK) != 0) & home_wins
    no = torch.zeros((Q, N), dtype=torch.bool, device=dev)
    if cfg.deep_read_storm:
        evs_ok = lane_is_ev if cfg.deep_waves == 1 else no
        opener = ((kind == K_RD)
                  | ((kind == K_EVS) & ~ev_abort & evs_ok & ~won))
        zone = torch.cumsum(opener.to(I32), dim=0, dtype=I32) >= 1
        storm_slot = ((((kind == K_RD) & ~req_abort)
                       | ((kind == K_EVS) & ~ev_abort & evs_ok))
                      & zone)                                 # [Q, N]
        zone_bad = zone & ~storm_slot
        req_bad = is_req & ((~won_any & ~storm_slot) | req_abort)
        ev_bad = is_ev & ((~won & ~storm_slot) | ev_abort)
    else:
        storm_slot = no
        zone_bad = no
        req_bad = is_req & (~won_any | req_abort)
        ev_bad = is_ev & (~won | ev_abort)
    # probes: a fresh marker is always unsafe; a fresh foreign FILL
    # request only for hits after the node's own first fill request
    probe_bad = is_probe & (((got_flags & F_MARK) != 0)
                            | ((sval != 0) & lane_fresh & ~lane_is_ev))
    bad = (req_bad | ev_bad | probe_bad
           | zone_bad).to(I32).contiguous()                  # [Q, N]

    # ---- replay fold (committed prefix) ----------------------------------
    rp = fold_replay_fn(bad, o_code)

    # ---- dense merge of own rows -----------------------------------------
    # DM_ACT packing: (round << 11) | (act_h << 9) | (promo << 8) |
    # (kw << 4) | dw (wave stamps; JAX deep_engine dense-merge comment)
    rtag = round_ << 11
    acc = rp["act_acc"]                                      # [S, N]
    touched = rp["touched"]
    act_col = torch.where(
        touched,
        rtag
        | (acc == ACT_PROMOTE).to(I32) << 8
        | (acc == ACT_KILL).to(I32) << 4
        | (acc == ACT_DOWN).to(I32),
        dm_own[:, :, DM_ACT].T)
    # g-slot owner values from the committed cache
    g_flat = rp["g_ci"] * N + torch.clamp(rp["g_owner"], 0, N - 1)
    g_vals = ix.gather(rp["cv_req"].reshape(-1), g_flat)     # [G, N]
    dmm_m = rp["dmm"]
    cv_m = rp["cv"]
    cv_req_m = rp["cv_req"]
    for g in range(G):
        dmm_m = torch.where(rp["dmm_src"] == g, g_vals[g:g + 1], dmm_m)
        cv_m = torch.where(rp["cv_src"] == g, g_vals[g:g + 1], cv_m)
        cv_req_m = torch.where(rp["cv_req_src"] == g, g_vals[g:g + 1],
                               cv_req_m)
    merged = torch.stack([
        torch.where(touched, rp["dms"], dm_own[:, :, DM_STATE].T).T,
        torch.where(touched, rp["dmc"], dm_own[:, :, DM_COUNT].T).T,
        torch.where(touched, rp["dmo"], dm_own[:, :, DM_OWNER].T).T,
        torch.where(touched, dmm_m, dm_own[:, :, DM_MEM].T).T,
        act_col.T,
        torch.where(touched, rows[None, :].expand(S, N),
                    dm_own[:, :, DM_REQ].T).T,
        claim.reshape(N, S),
    ], dim=-1).reshape(E, DM_COLS)
    dm = merged

    # ---- request composition (post-merge, per committed slot) ------------
    r_ci = codec.cache_index(cfg, safe_ent)                  # [Q, N]
    req_id = rows[None, :].expand(Q, N)
    commit_acc = no
    rel_acc = no
    patch_acc = no
    fille_acc = no
    fillv_acc = torch.zeros((Q, N), dtype=I32, device=dev)
    aw_acc = torch.zeros((Q, N), dtype=I32, device=dev)
    passes = [((is_req | is_ev) & won_j & ~storm_slot, j + 2, False)
              for j, won_j in enumerate(won_list)]
    if cfg.deep_read_storm:
        passes.append((storm_slot, len(won_list) + 2, True))
    storm_committed = no
    for mask_j, stamp, is_storm in passes:
        commit = mask_j & rp["comm"]
        commit_acc = commit_acc | commit
        if is_storm:
            storm_committed = commit
            # aggregated per-entry reader/evictor counts in ONE
            # scatter-add, fused into the row gather as an extra column
            packed = ((commit & (kind == K_EVS)).to(I32) << 16) \
                | (commit & (kind == K_RD)).to(I32)
            cnt_storm = torch.zeros((E + 1,), dtype=I32, device=dev)
            cnt_storm.index_add_(
                0, TorchIndexOps._spare(
                    torch.where(commit, safe_ent, E).reshape(-1), E),
                packed.reshape(-1))
            g_rows8 = torch.cat([dm, cnt_storm[:E, None]], dim=-1)[
                safe_ent.to(torch.int64)]
            g_rows = g_rows8[..., :DM_COLS]                  # [Q, N, cols]
            kr = g_rows8[..., DM_COLS] & 0xFFFF              # [Q, N]
            ke = g_rows8[..., DM_COLS] >> 16
        else:
            g_rows = ix.gather_rows(dm, safe_ent)            # [Q, N, cols]
        r_state = g_rows[..., DM_STATE]
        r_cnt = g_rows[..., DM_COUNT]
        r_own = g_rows[..., DM_OWNER]
        r_mem = g_rows[..., DM_MEM]
        r_act = g_rows[..., DM_ACT]
        # a pending row (same-round promotion, owner == -1) serves its
        # memory as the owner value
        r_pend = (r_state == D_EM) & (r_own == -1)
        prev_fresh = (r_act >> 11) == round_
        # the round-value channel rides DM_REQ's high bits
        rv_got = torch.where(prev_fresh,
                             (g_rows[..., DM_REQ] >> REQ_BITS) & 0x3FF, 0)
        own_val = torch.where(
            r_pend, r_mem,
            ix.gather(cv_req_m.reshape(-1),
                      r_ci * N + torch.clamp(r_own, 0, N - 1)))
        own_val = torch.where((rv_got & 0x200) != 0, r_mem, own_val)
        own_val = torch.where((rv_got & 0x100) != 0, rv_got & 0xFF,
                              own_val)
        r_u = r_state == D_U
        r_s = r_state == D_S
        r_em = r_state == D_EM
        k_rd = commit & (kind == K_RD)
        k_wr = commit & (kind == K_WR)
        k_up = commit & (kind == K_UP)
        k_evs = commit & (kind == K_EVS)
        k_evm = commit & (kind == K_EVM)
        wlike = k_wr | k_up
        prev_ah = torch.where(prev_fresh, (r_act >> 9) & 3, ACT_NONE)
        prev_promo = prev_fresh & (((r_act >> 8) & 1) == 1)
        prev_kw = torch.where(prev_fresh, (r_act >> 4) & 15, 0)
        prev_dw = torch.where(prev_fresh, r_act & 15, 0)
        tgt_home = r_own == (safe_ent >> cfg.block_bits)
        if is_storm:
            # ---- k-aggregated storm composition (readers first) ---------
            held = torch.where(r_u, 0, torch.where(r_em, 1, r_cnt))
            c2 = held + kr - ke
            solo_u = r_u & (kr == 1) & (ke == 0)
            flush = r_em & ~r_pend & (kr >= 1)
            n_state = wi(c2 == 0, D_U, wi(c2 >= 2, D_S, D_EM))
            n_cnt = c2
            promo_end = (c2 == 1) & (ke >= 1)
            n_own = torch.where(solo_u, req_id,
                                torch.where(promo_end, -1, r_own))
            n_mem = torch.where(flush, own_val, r_mem)
            rel = no
            my_h = wi(flush & tgt_home, ACT_DOWN,
                      wi(promo_end, ACT_PROMOTE, ACT_NONE))
            act_h = torch.where(
                prev_ah == ACT_PROMOTE,
                torch.where(kr >= 1, ACT_DOWN,
                            torch.where(c2 == 0, ACT_NONE, prev_ah)),
                torch.maximum(prev_ah, my_h))
            n_kw = prev_kw
            n_dw = torch.where(flush, stamp, prev_dw)
            n_promo = torch.where(commit, promo_end, prev_promo)
            n_act = (rtag | (act_h << 9)
                     | (n_promo.to(I32) << 8)
                     | (n_kw << 4) | n_dw)
            rv_new = torch.zeros((Q, N), dtype=I32, device=dev)
        else:
            # release: the requester displaced its own window fill of
            # this entry later in the window; the slot commits the
            # fill+evict NET row
            rel = rp["rel"] & (k_rd | wlike)
            relv = rp["relv"]
            evs_cnt = torch.where(r_s, r_cnt - 1, r_cnt)
            n_state = torch.where(
                wlike, D_EM,
                torch.where(
                    k_rd, wi(r_u, D_EM, D_S),
                    torch.where(
                        k_evm | (k_evs & r_em), D_U,
                        torch.where(k_evs & r_s,
                                    wi(evs_cnt == 0, D_U,
                                       wi(evs_cnt == 1, D_EM, D_S)),
                                    r_state))))
            n_cnt = torch.where(
                wlike | (k_rd & r_u), 1,
                torch.where(
                    k_rd & r_em, 2,
                    torch.where(
                        k_rd & r_s, r_cnt + 1,
                        torch.where(k_evm | (k_evs & r_em), 0,
                                    torch.where(k_evs & r_s, evs_cnt,
                                                r_cnt)))))
            n_own = torch.where(
                wlike | (k_rd & r_u), req_id,
                torch.where(k_evs & r_s & (evs_cnt == 1), -1, r_own))
            n_mem = torch.where((k_rd | k_wr) & r_em, own_val,
                                torch.where(k_evm, sval, r_mem))
            # release net-row overrides
            n_state = torch.where(
                rel, torch.where(wlike, D_U,
                                 torch.where(r_em, D_EM, r_state)),
                n_state)
            n_cnt = torch.where(
                rel, torch.where(wlike, 0, torch.where(r_em, 1, r_cnt)),
                n_cnt)
            n_own = torch.where(rel, r_own, n_own)
            n_mem = torch.where(
                rel, torch.where(wlike, relv,
                                 torch.where(r_em, own_val, r_mem)),
                n_mem)
            # ---- wave-stamp act composition -----------------------------
            plain_rd = k_rd & ~rel
            my_h = wi(wlike, ACT_KILL,
                      torch.where(k_rd & r_em & tgt_home,
                                  wi(rel, ACT_PROMOTE, ACT_DOWN),
                                  wi(k_evs & r_s & (evs_cnt == 1),
                                     ACT_PROMOTE, ACT_NONE)))
            act_h = torch.where(
                prev_ah == ACT_PROMOTE,
                wi(wlike, ACT_KILL,
                   wi(k_rd & rel, ACT_PROMOTE,
                      wi(k_rd, ACT_DOWN, ACT_NONE))),
                torch.maximum(prev_ah, my_h))
            n_kw = torch.where(wlike, stamp, prev_kw)
            n_dw = torch.where(plain_rd & r_em & ~tgt_home, stamp,
                               prev_dw)
            promo_set = ((k_evs & r_s & (evs_cnt == 1))
                         | (k_rd & rel & r_em & ~tgt_home))
            promo_clr = wlike | k_evs | k_evm | (plain_rd & r_em)
            n_promo = promo_set | (~promo_clr & prev_promo)
            n_act = (rtag | (act_h << 9)
                     | (n_promo.to(I32) << 8)
                     | (n_kw << 4) | n_dw)
            rv_new = torch.where(
                wlike & ~rel, 0x100 | (sval & 0xFF),
                wi((k_rd & r_u & ~rel) | (k_rd & rel & r_em), 0x200, 0))
        rel_acc = rel_acc | rel
        t_idx = torch.where(commit, safe_ent, E).reshape(-1)
        # multi-slot storm commits write a canonical requester id
        # (0xFFFF, matches nobody) and the entry's lane key so duplicate
        # scatter rows stay bit-identical
        if is_storm:
            multi = (kr + ke) >= 2
            req_col = torch.where(multi, (1 << REQ_BITS) - 1, req_id)
            key_col = torch.where(multi, g_rows[..., DM_CLAIM], key_q)
        else:
            req_col, key_col = req_id, key_q
        t_rows = torch.stack(
            [n_state, n_cnt, n_own, n_mem, n_act,
             req_col | (rv_new << REQ_BITS), key_col],
            dim=-1).reshape(-1, DM_COLS)
        dm = ix.scatter_rows(dm, t_idx, t_rows)

        # reply patches on the requester's cache, applied after the
        # loop in window-slot order
        fill_e = k_rd & r_u
        if is_storm:
            fill_e = fill_e & solo_u
        fill_val = torch.where(wlike, sval,
                               torch.where(r_em, own_val, r_mem))
        patch = (k_rd | wlike) & ~rel
        patch_acc = patch_acc | patch
        fille_acc = fille_acc | fill_e
        fillv_acc = torch.where(patch, fill_val, fillv_acc)
        aw_acc = torch.where(commit & is_req & ~rel, stamp, aw_acc)
    ca_c = rp["ca"]
    cv_rows = list(cv_m.unbind(0))
    cs_rows = list(rp["cs"].unbind(0))
    aw_rows = [torch.zeros((N,), dtype=I32, device=dev)] * C
    lwh = rp["lwh"]
    for q in range(Q):
        m_q, rci_q = patch_acc[q], r_ci[q]
        fe_q, fv_q = fille_acc[q], fillv_acc[q]
        s_q = aw_acc[q] > 0
        for c in range(C):
            # lwh: a write HIT followed the line's last fill, so the
            # fold's value is newest — no patch may touch it
            oh = (rci_q == c) & m_q & ~lwh[c]
            cs_rows[c] = torch.where(oh & fe_q, EXC, cs_rows[c])
            cv_rows[c] = torch.where(oh, fv_q, cv_rows[c])
            ohs = (rci_q == c) & s_q
            aw_rows[c] = torch.where(ohs, aw_acc[q], aw_rows[c])
    cv_c = torch.stack(cv_rows, dim=0)                       # [C, N]
    cs_c = torch.stack(cs_rows, dim=0)
    aw = torch.stack(aw_rows, dim=0)

    # ---- fan-out ---------------------------------------------------------
    # per-entry packed word, gathered once per cached line (REQ_BITS
    # 16): bit 27 fresh, 25-26 act_h, 24 promo, 20-23 kw, 16-19 dw,
    # 0-15 requester
    line_e = torch.clamp(ca_c, 0, E - 1)                     # [C, N]
    fan_fresh = (dm[:, DM_ACT] >> 11) == round_
    rb, req_mask = REQ_BITS, (1 << REQ_BITS) - 1
    fan_packed = (torch.where(fan_fresh,
                              ((dm[:, DM_ACT] & 0x7FF) | 0x800) << rb, 0)
                  | (dm[:, DM_REQ] & req_mask))
    line_f = ix.gather(fan_packed, line_e)                   # [C, N]
    fresh = ((line_f >> (rb + 11)) & 1) == 1
    l_ah = torch.where(fresh, (line_f >> (rb + 9)) & 3, ACT_NONE)
    l_promo = fresh & (((line_f >> (rb + 8)) & 1) == 1)
    l_kw = torch.where(fresh, (line_f >> (rb + 4)) & 15, 0)
    l_dw = torch.where(fresh, (line_f >> rb) & 15, 0)
    l_req = line_f & req_mask
    l_home = line_e >> cfg.block_bits
    i_am_home = l_home == rows[None, :]
    valid = cs_c != INV
    not_self = l_req != rows[None, :]
    kill = valid & torch.where(i_am_home, l_ah == ACT_KILL, aw < l_kw)
    promo = valid & ~kill & torch.where(i_am_home, l_ah == ACT_PROMOTE,
                                        l_promo & not_self)
    down = valid & ~kill & ~promo & torch.where(i_am_home,
                                                l_ah == ACT_DOWN,
                                                aw < l_dw)
    cs_c = torch.where(kill, INV,
                       torch.where(promo, EXC,
                                   torch.where(down, SHD, cs_c)))
    dm = ix.scatter_col(dm, torch.where(promo, line_e, E).reshape(-1),
                        DM_OWNER, rows[None, :].expand(C, N).reshape(-1))

    # ---- bookkeeping -----------------------------------------------------
    cntr = rp["cnt"]
    delta_rows = torch.stack([
        rp["n_ret"], rp["rh"], rp["wh"],
        cntr["rd_miss"],
        cntr["wr_miss"],
        cntr["upg"],
        torch.sum((is_req | is_ev) & ~won_any & ~storm_committed, dim=0,
                  dtype=I32),
        cntr["ev"],
        torch.sum(kill, dim=0, dtype=I32),
        torch.sum(promo, dim=0, dtype=I32),
    ])                                                       # [10, N]
    aborting = req_abort | ev_abort
    return dict(ca_c=ca_c, cv_c=cv_c, cs_c=cs_c, dm=dm, rp=rp,
                delta_rows=delta_rows,
                # dense internals for the stats and profile tails
                kind=kind, is_req=is_req, is_ev=is_ev, won_any=won_any,
                aborting=aborting, probe_bad=probe_bad,
                commit_acc=commit_acc, rel_acc=rel_acc,
                clean_self=clean_self, storm_committed=storm_committed,
                ent=ent, poison_src=poison_src, req_abort=req_abort)


def _finish_round_deep(cfg: SystemConfig, st: SyncState, core,
                       w_oa=None, w_val=None, with_events: bool = False,
                       return_stats: bool = False,
                       return_profile: bool = False):
    """Fold a deep_round_core result back into the SyncState: metrics
    from the per-node delta rows, window-cursor/horizon advance. With
    ``with_events``, also the retirement record of the window
    ``w_oa``/``w_val`` [W, N]: (state, events), each event [N, W]. With
    ``return_stats`` / ``return_profile``, (state, stats) / (state,
    profile delta) as JAX ``_finish_round_deep``."""
    rp = core["rp"]
    deltas = torch.sum(core["delta_rows"], dim=1, dtype=I32)
    out = st.replace(
        cache_addr=core["ca_c"].T.contiguous(),
        cache_val=core["cv_c"].T.contiguous(),
        cache_state=core["cs_c"].T.contiguous(),
        dm=core["dm"], idx=st.idx + rp["n_ret"],
        horizon=torch.clamp(rp["n_ret"] + cfg.deep_horizon_slack, 2,
                            1 << 20),
        round=st.round + 1, metrics=st.metrics.after_round(deltas))
    if return_stats:
        return out, _round_stats(st, core)
    if return_profile:
        return out, _round_profile(cfg, core, w_oa)
    if not with_events:
        return out
    W = w_oa.shape[0]
    offs = torch.arange(W, dtype=I32, device=w_oa.device)[None, :]
    return out, {"retired": offs < rp["n_ret"][:, None],
                 "op": w_oa.T >> 28, "addr": w_oa.T & 0x0FFFFFFF,
                 "value": w_val.T}


def _round_stats(st: SyncState, core) -> dict:
    """The round's anatomy as 0-d int32 sums (JAX
    ``ops/deep_engine.py:1122-1143``)."""
    rp, kind = core["rp"], core["kind"]
    is_req, is_ev = core["is_req"], core["is_ev"]

    def s_(x):
        return torch.sum(x, dtype=I32)
    return dict(
        n_ret=s_(rp["n_ret"]), truncated=s_(rp["truncated"]),
        stopped=s_(rp["stopped"]), seen_req=s_(rp["seen_req"]),
        n_slot=s_(rp["n_slot"]), horizon_sum=s_(st.horizon),
        att_rd=s_(kind == K_RD), att_wr=s_(kind == K_WR),
        att_up=s_(kind == K_UP), att_evs=s_(kind == K_EVS),
        att_evm=s_(kind == K_EVM), att_probe=s_(kind == K_PROBE),
        lost=s_((is_req | is_ev) & ~core["won_any"] & ~core["aborting"]
                & ~core["storm_committed"]),
        abort_poison=s_(core["aborting"] & is_req),
        abort_mark=s_(core["aborting"] & is_ev),
        probe_bad=s_(core["probe_bad"]),
        committed=s_(core["commit_acc"]),
        released=s_(core["rel_acc"]),
        clean=s_(core["clean_self"]),
        storm=s_(core["storm_committed"]),
        stop_overq=s_(rp["s_overq"]), stop_overg=s_(rp["s_overg"]),
        stop_dup=s_(rp["s_dup"]), stop_dep=s_(rp["s_dep"]),
        stop_live=s_(rp["s_live"]))


def _round_profile(cfg: SystemConfig, core, w_oa) -> dict:
    """The round's additive coherence-profile planes (JAX
    ``ops/deep_engine.py:1145-1192``): the abort attribution tells the
    poison flags the committed replay confirmed (rp["poison"]) from the
    ghosts the speculative flag source raised beyond the committed
    prefix. Dropped scatter lanes add 0 at a clipped index."""
    N, S = cfg.num_nodes, 1 << cfg.block_bits
    E = N * S
    W = cfg.drain_depth + cfg.txn_width
    rp = core["rp"]
    dev = w_oa.device
    i64 = torch.int64
    is_req, is_ev = core["is_req"], core["is_ev"]
    real_arr = rp["poison"].T.reshape(E)                       # [E] bool
    ent = torch.clamp(core["ent"], 0, E - 1).to(i64)           # [Q, N]
    flag_real = real_arr[ent]
    lost = ((is_req | is_ev) & ~core["won_any"] & ~core["aborting"]
            & ~core["storm_committed"])
    classes = torch.stack([                                    # [Q, N, 5]
        core["req_abort"] & ~flag_real,
        core["req_abort"] & flag_real,
        core["aborting"] & is_ev,
        lost,
        core["probe_bad"]], dim=-1).to(I32)
    abort_addr = torch.zeros((E, 5), dtype=I32, device=dev)
    abort_addr.index_add_(0, ent.reshape(-1), classes.reshape(-1, 5))
    # retired-access planes from the committed window prefix
    offs = torch.arange(W, dtype=I32, device=dev)[:, None]    # [W, 1]
    ret = offs < rp["n_ret"][None, :]                          # [W, N]
    opw = w_oa >> 28
    rows = torch.arange(N, dtype=i64, device=dev)
    flat = (rows[None, :] * E
            + torch.clamp(w_oa & 0x0FFFFFFF, 0, E - 1).to(i64)).reshape(-1)

    def plane(op: int):
        p = torch.zeros(N * E, dtype=I32, device=dev)
        p.index_add_(0, flat, (ret & (opw == int(op))).reshape(-1).to(I32))
        return p.reshape(N, E)
    return dict(
        rd=plane(Op.READ), wr=plane(Op.WRITE),
        abort_addr=abort_addr,                                 # [E, 5]
        abort_node=torch.sum(classes, dim=0, dtype=I32),       # [N, 5]
        stops=torch.stack([rp["s_overq"], rp["s_overg"], rp["s_dup"],
                           rp["s_dep"], rp["s_live"]]).to(I32),  # [5, N]
        poison_raised=torch.sum(core["poison_src"], dtype=I32),
        poison_committed=torch.sum(rp["poison"], dtype=I32),
        n_ret=rp["n_ret"].to(I32))                             # [N]


def deep_profile_zeros(cfg: SystemConfig, device=None) -> dict:
    """The zeroed accumulator of run_deep_profile, with the keys and
    shapes of round_step_deep's return_profile delta (JAX
    ``ops/deep_engine.py:1202``). ``device`` None means the card."""
    from ue22cs343bb1_openmp_assignment_tpu_torch import device as _device
    dev = _device.resolve(device)
    N, S = cfg.num_nodes, 1 << cfg.block_bits
    E = N * S

    def z(*shape):
        return torch.zeros(shape, dtype=I32, device=dev)
    return dict(rd=z(N, E), wr=z(N, E), abort_addr=z(E, 5),
                abort_node=z(N, 5), stops=z(5, N), poison_raised=z(),
                poison_committed=z(), n_ret=z(N))


def run_deep_profile(cfg: SystemConfig, st: SyncState, n: int):
    """Run n deep rounds accumulating the coherence-profile planes (JAX
    ``ops/deep_engine.py:1216``): (state, prof), prof a
    ``deep_profile_zeros`` dict after summation: retired accesses, the
    PROFILE_ABORT_CLASSES attribution, the PROFILE_STOP_CLASSES window
    stops and the raised / committed poison-flag totals (their ratio is
    the measured ghost fraction). The rounds are ``round_step_deep``
    with the plain folds, on the card too: the fold kernels do not
    export the anatomy, and JAX's runner takes its XLA fold likewise
    (neither its Pallas folds nor its fused round produce the profile).
    No fold or round kernel launches."""
    from ue22cs343bb1_openmp_assignment_tpu_torch.ops.sync_engine import (
        _assert_round_budget)
    _assert_round_budget(cfg, st.round, n)
    prof = deep_profile_zeros(cfg, st.cache_addr.device)
    for _ in range(n):
        st, d = round_step_deep(cfg, st, fold_impl="plain",
                                return_profile=True)
        for k in prof:
            prof[k] += d[k]
    return st, prof
