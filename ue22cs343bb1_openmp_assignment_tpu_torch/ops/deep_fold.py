"""The deep-window fold, layout-neutral, in PyTorch.

Every per-node scalar is a "vec" (an [N] tensor) and every per-node
table ([N, S] own-directory slice, [N, C] cache, [N, Q] slots) is a
Python LIST of vecs, as in the JAX package's ``ops/deep_fold.py``. All
code below is elementwise on vecs plus where-chains over lists; it is
the plain version of the CUDA fold kernel (``csrc/deep_fold.cu``), which
runs the same step per node in registers.

Truncation is computed inside the fold: the replay pass receives the
per-slot badness verdicts and the dense own-lane codes, and stops
retirement at the first bad slot or yield-unsafe own touch. The
pre-pass passes zeros for both, which disables truncation.
"""

from __future__ import annotations

import torch

from ue22cs343bb1_openmp_assignment_tpu_torch.config import SystemConfig
from ue22cs343bb1_openmp_assignment_tpu_torch.types import (CacheState,
                                                            DirState, Op)

# slot kinds (remote events): fill requests, eviction notices, probes
K_NONE, K_RD, K_WR, K_UP, K_EVS, K_EVM, K_PROBE = 0, 1, 2, 3, 4, 5, 6

# dense own-lane code bits (round middle -> replay fold): entry has a
# fresh foreign lane key / that key is an eviction notice / its sender's
# priority beats ours
OC_FRESH, OC_EV, OC_BEATS = 1, 2, 4

# fan-out actions
ACT_NONE, ACT_DOWN, ACT_KILL, ACT_PROMOTE = 0, 1, 2, 3


def wi(cond, a, b):
    """torch.where that stays int32 when both branches are Python ints
    (jnp.where keeps int32 there; torch would make int64)."""
    return torch.where(cond, a, b).to(torch.int32)


def _onehot(idx, n: int):
    """[idx == i for i < n]: the per-entry masks of a vec of list
    indices, computed once and shared by every select/update on it."""
    return [idx == i for i in range(n)]


def _sel(lst, oh):
    """where-chain select: lst[idx] per node, with oh = _onehot(idx)
    (an index matching no entry past the first selects lst[0])."""
    out = lst[0]
    for i in range(1, len(lst)):
        out = torch.where(oh[i], lst[i], out)
    return out


def _at(oh, mask):
    """Per-entry write masks: entry i is written where mask and
    idx == i."""
    return [mask & o for o in oh]


def _put(lst, at, val):
    """lst[idx] = val where mask, per node, with at = _at(oh, mask)."""
    return [torch.where(a, val, r) for a, r in zip(at, lst)]


def fold_carry0(cfg: SystemConfig, ca, cv, cs, dm_rows, zero, false):
    """Initial fold carry. ca/cv/cs: C-lists of vecs; dm_rows: dict of
    S-lists (dms/dmc/dmo/dmm); zero/false: a zero int vec / false vec."""
    C, S = cfg.cache_size, 1 << cfg.block_bits
    Q, G = cfg.deep_slots, cfg.deep_ownerval_slots
    neg1 = zero - 1
    return dict(
        ca=list(ca), cv=list(cv), cs=list(cs),
        cv_src=[neg1] * C, rrf=[false] * C, wf=[false] * C,
        lwh=[false] * C,
        dms=list(dm_rows["dms"]), dmc=list(dm_rows["dmc"]),
        dmo=list(dm_rows["dmo"]), dmm=list(dm_rows["dmm"]),
        dmm_src=[neg1] * S,
        touched=[false] * S, act_acc=[zero] * S,
        mark=[false] * S, poison=[false] * S,
        cv_req=list(cv), cv_req_src=[neg1] * C,
        stopped=false, frozen=false, truncated=false,
        n_slot=zero, n_g=zero, seen_req=false,
        n_ret=zero, rh=zero, wh=zero,
        c_rd=zero, c_wr=zero, c_up=zero, c_ev=zero,
        s_overq=false, s_overg=false, s_dup=false, s_dep=false,
        s_live=false,
        kind=[zero] * Q, ent=[zero] * Q, sval=[zero] * Q,
        comm=[false] * Q,
        rel=[false] * Q, relv=[zero] * Q, reld=[false] * Q,
        g_owner=[zero] * G, g_ci=[zero] * G,
    )


def fold_step(cfg: SystemConfig, c, node, oa, val, live, k, horizon,
              bad, ocode):
    """One window step. c: carry dict (lists of vecs); node: vec of node
    ids; oa/val/live: this step's instruction; k: int step index;
    horizon: attempt-cap vec; bad: Q-list of slot-badness vecs (zeros in
    the pre-pass); ocode: S-list of own-lane code vecs (zeros in the
    pre-pass). Returns the next carry."""
    C, S = cfg.cache_size, 1 << cfg.block_bits
    Q, G = cfg.deep_slots, cfg.deep_ownerval_slots
    INV = int(CacheState.INVALID)
    MOD = int(CacheState.MODIFIED)
    EXC = int(CacheState.EXCLUSIVE)
    SHD = int(CacheState.SHARED)
    D_U, D_S, D_EM = int(DirState.U), int(DirState.S), int(DirState.EM)
    bmask = S - 1
    i32 = torch.int32

    live = live & (horizon > k)
    # cache values as of the node's first fill-request attempt: foreign
    # requests read owner values from THIS snapshot
    cv_req = [torch.where(c["seen_req"], rq, v)
              for rq, v in zip(c["cv_req"], c["cv"])]
    cv_req_src = [torch.where(c["seen_req"], rq, v)
                  for rq, v in zip(c["cv_req_src"], c["cv_src"])]
    op, addr = oa >> 28, oa & 0x0FFFFFFF
    home = addr >> cfg.block_bits
    block = addr & bmask
    is_own = home == node
    ci = block % C           # direct-mapped (codec.cache_index)
    ci_oh = _onehot(ci, C)
    l_addr = _sel(c["ca"], ci_oh)
    l_val = _sel(c["cv"], ci_oh)
    l_state = _sel(c["cs"], ci_oh)
    l_src = _sel(c["cv_src"], ci_oh)
    l_rrf = _sel(c["rrf"], ci_oh)
    l_wf = _sel(c["wf"], ci_oh)
    tag_ok = (l_addr == addr) & (l_state != INV)
    is_rd, is_wr = op == int(Op.READ), op == int(Op.WRITE)
    rd_hit = live & is_rd & tag_ok
    wr_hit = live & is_wr & tag_ok & ((l_state == MOD) | (l_state == EXC))
    wr_sh = live & is_wr & tag_ok & (l_state == SHD)
    nop = live & (op == int(Op.NOP))
    if cfg.deep_waves == 1:
        # single-wave: a write on a line this window filled by a remote
        # READ stops the window
        dep_stop = wr_sh & l_rrf
        upg = wr_sh & ~l_rrf
    else:
        # speculative upgrade (waves >= 2)
        dep_stop = torch.zeros_like(wr_sh)
        upg = wr_sh
    rd_miss = live & is_rd & ~tag_ok
    wr_miss = live & is_wr & ~tag_ok
    is_txn = (upg | rd_miss | wr_miss) & ~dep_stop
    hit = rd_hit | wr_hit | nop

    has_victim = is_txn & ~tag_ok & (l_state != INV) & (l_addr != addr)
    v_block = l_addr & bmask
    v_own = (l_addr >> cfg.block_bits) == node
    v_mod = l_state == MOD

    own_txn = is_txn & is_own
    rem_txn = is_txn & ~is_own
    own_vic = has_victim & v_own
    rem_vic = has_victim & ~v_own
    probe = hit & c["frozen"] & ~is_own & ~l_wf

    # --- own register reads ----------------------------------------------
    t_oh = _onehot(block, S)
    v_oh = _onehot(v_block, S)
    t_dms = _sel(c["dms"], t_oh)
    t_dmc = _sel(c["dmc"], t_oh)
    t_dmo = _sel(c["dmo"], t_oh)
    t_dmm = _sel(c["dmm"], t_oh)
    t_dmm_src = _sel(c["dmm_src"], t_oh)
    t_act = _sel(c["act_acc"], t_oh)
    v_dmc = _sel(c["dmc"], v_oh)
    v_act = _sel(c["act_acc"], v_oh)

    # --- stop conditions ---------------------------------------------------
    if cfg.deep_read_storm:
        # storm mode forfeits release netting (ops/deep_engine)
        rel_hit = [torch.zeros_like(live) for _ in c["kind"]]
    else:
        rel_hit = [((kk >= K_RD) & (kk <= K_UP)) & (ee == l_addr)
                   for kk, ee in zip(c["kind"], c["ent"])]
    rel_any_all = rel_hit[0]
    for rh_ in rel_hit[1:]:
        rel_any_all = rel_any_all | rh_
    rel_any = rel_any_all & rem_vic
    dup_t = dup_v = torch.zeros_like(live)
    if cfg.deep_waves == 1:
        # single-wave rounds: a second remote event on an already-
        # slotted entry cannot commit, so stop the window there
        for kk, ee in zip(c["kind"], c["ent"]):
            isrem = (kk >= K_RD) & (kk <= K_EVM)
            dup_t = dup_t | (isrem & (ee == addr))
            dup_v = dup_v | (isrem & (ee == l_addr))
    dup = (dup_t & rem_txn) | (dup_v & rem_vic & ~rel_any)
    n_need = (rem_txn.to(i32)
              + (rem_vic & ~rel_any_all).to(i32)
              + probe.to(i32))
    over_q = (c["n_slot"] + n_need) > Q
    # EM-with-unresolved-owner (same-round promotion, owner == -1)
    t_em_o = (t_dms == D_EM) & (t_dmo != node) & (t_dmo >= 0)
    t_em_p = (t_dms == D_EM) & (t_dmo == -1)
    t_em = t_em_o | t_em_p
    g_need = own_txn & (rd_miss | wr_miss) & t_em_o
    over_g = g_need & (c["n_g"] >= G)
    stop_now = (~c["stopped"]) & (live & ~nop) & (
        dep_stop | over_q | over_g | dup | ~(hit | is_txn))
    stop_now = stop_now | ((~c["stopped"]) & ~live)
    act = ~c["stopped"] & ~stop_now & (hit | is_txn)
    # stop-reason flags (the profile's window stops; priority order
    # mirrors stop_now)
    was = ~c["stopped"]
    s_live = c["s_live"] | (was & stop_now & ~live)
    s_dep = c["s_dep"] | (was & stop_now & live & dep_stop)
    s_overq = c["s_overq"] | (was & stop_now & live & ~dep_stop & over_q)
    s_overg = c["s_overg"] | (was & stop_now & live & ~dep_stop
                              & ~over_q & over_g)
    s_dup = c["s_dup"] | (was & stop_now & live & ~dep_stop & ~over_q
                          & ~over_g & dup)

    # --- truncation (replay only; pre-pass gets zero bad/ocode) ------------
    o1 = c["n_slot"]
    o2 = o1 + (rem_vic & ~rel_any_all).to(i32)
    o1_oh = _onehot(o1, Q)
    o2_oh = _onehot(o2, Q)
    bad1 = _sel(bad, o1_oh)
    bad2 = _sel(bad, o2_oh)
    slot_bad = ((rem_vic & ~rel_any_all) & act & (bad1 != 0)) \
        | ((rem_txn | probe) & act & (bad2 != 0))
    # chain-yield checks against the own-lane codes
    tc = _sel(ocode, t_oh)
    vc = _sel(ocode, v_oh)
    post = c["seen_req"]
    y_bad = own_txn & ((((tc & OC_EV) != 0) & ((tc & OC_BEATS) != 0))
                       | (post & ((tc & OC_FRESH) != 0)
                          & ((tc & OC_BEATS) != 0)))
    y_bad = y_bad | (own_vic
                     & ((((vc & OC_EV) != 0) & ((vc & OC_BEATS) != 0))
                        | (post & ((vc & OC_FRESH) != 0)
                           & ((vc & OC_BEATS) != 0))))
    y_bad = y_bad | ((rd_hit | wr_hit) & is_own & post
                     & ((tc & OC_FRESH) != 0) & ((tc & OC_EV) == 0))
    truncated = c["truncated"] | ((slot_bad | y_bad) & act)
    r = act & ~truncated

    rem_txn_a = rem_txn & act
    probe_a = probe & act
    g_take = g_need & act
    own_txn_r = own_txn & r
    own_vic_r = own_vic & r
    fill_r = (own_txn | rem_txn) & r

    # --- slot emission (attempt-based) -------------------------------------
    rem_vic_slot = rem_vic & act & ~rel_any_all
    kind, ent, sval = c["kind"], c["ent"], c["sval"]
    comm = c["comm"]
    # release marking is retirement-gated
    mrel_m = rem_vic & r
    rel = [rr | (rh_ & mrel_m) for rr, rh_ in zip(c["rel"], rel_hit)]
    relv = [torch.where(rh_ & mrel_m, l_val, rv)
            for rv, rh_ in zip(c["relv"], rel_hit)]
    reld = [rd_ | (rh_ & mrel_m & v_mod)
            for rd_, rh_ in zip(c["reld"], rel_hit)]
    vic_kind = wi(v_mod, K_EVM, K_EVS)
    at1 = _at(o1_oh, rem_vic_slot)
    kind = _put(kind, at1, vic_kind)
    ent = _put(ent, at1, l_addr.clamp(min=0))
    sval = _put(sval, at1, l_val)
    comm = _put(comm, _at(o1_oh, rem_vic_slot & r), r)
    fp = rem_txn_a | probe_a
    fill_kind = wi(probe, K_PROBE,
                   wi(rd_miss, K_RD, wi(wr_miss, K_WR, K_UP)))
    slot_v = torch.where(probe, c["seen_req"].to(i32), val)
    at2 = _at(o2_oh, fp)
    kind = _put(kind, at2, fill_kind)
    ent = _put(ent, at2, addr.clamp(min=0))
    sval = _put(sval, at2, slot_v)
    comm = _put(comm, _at(o2_oh, rem_txn_a & r), r)
    n_slot = c["n_slot"] + torch.where(act, n_need, 0)
    seen_req = c["seen_req"] | rem_txn_a

    # --- g-slot (own-EM owner value) ---------------------------------------
    at_g = _at(_onehot(c["n_g"], G), g_take)
    g_owner = _put(c["g_owner"], at_g, t_dmo.clamp(min=0))
    g_ci = _put(c["g_ci"], at_g, ci)
    g_id = c["n_g"]
    n_g = c["n_g"] + g_take.to(i32)

    # --- counters ----------------------------------------------------------
    n_ret = c["n_ret"] + r
    rh = c["rh"] + (rd_hit & r)
    wh = c["wh"] + (wr_hit & r)
    c_rd = c["c_rd"] + (rd_miss & r)
    c_wr = c["c_wr"] + (wr_miss & r)
    c_up = c["c_up"] + (upg & r)
    c_ev = c["c_ev"] + (has_victim & r)

    # --- hit write effects -------------------------------------------------
    wm = wr_hit & r
    at_wm = _at(ci_oh, wm)
    cv = _put(c["cv"], at_wm, val)
    cv_src = _put(c["cv_src"], at_wm, torch.zeros_like(val) - 1)
    cs = _put(c["cs"], at_wm, torch.zeros_like(val) + MOD)

    # --- own victim composition --------------------------------------------
    vo = own_vic_r
    ev_m = vo & v_mod
    ev_s = vo & ~v_mod & (l_state == SHD)
    nvc = torch.where(ev_s, v_dmc - 1, 0)
    nvs = wi(ev_s & (nvc >= 2), D_S, wi(ev_s & (nvc == 1), D_EM, D_U))
    promote = ev_s & (nvc == 1)
    at_vo = _at(v_oh, vo)
    at_evm = _at(v_oh, ev_m)
    dms = _put(c["dms"], at_vo, nvs)
    dmc = _put(c["dmc"], at_vo, nvc)
    dmo = _put(c["dmo"], _at(v_oh, vo & promote), torch.zeros_like(nvc) - 1)
    dmm = _put(c["dmm"], at_evm, l_val)
    dmm_src = _put(c["dmm_src"], at_evm, l_src)
    touched = [x | a for a, x in zip(at_vo, c["touched"])]
    act_acc = _put(c["act_acc"], at_vo,
                   torch.maximum(v_act, wi(promote, ACT_PROMOTE, ACT_NONE)))
    v_foreign = ev_s & (v_dmc > 1)
    mark = [x | a for a, x in zip(_at(v_oh, vo & v_foreign), c["mark"])]
    poison = [x | a for a, x in zip(_at(v_oh, vo & c["seen_req"]),
                                    c["poison"])]

    # --- own target composition --------------------------------------------
    to = own_txn_r
    t_u_eff = (t_dms == D_U) | ((t_dms == D_EM) & (t_dmo == node))
    t_s = t_dms == D_S
    o_rd, o_wr, o_up = to & rd_miss, to & wr_miss, to & upg
    wlike = o_wr | o_up
    excl = wlike | (o_rd & t_u_eff)
    nts = wi(excl, D_EM, D_S)
    ntc = torch.where(excl, 1, torch.where(o_rd & t_em, 2, t_dmc + 1))
    nto = torch.where(excl, node, t_dmo)
    flush = (o_rd | o_wr) & t_em_o
    ntm_src = torch.where(flush, g_id, t_dmm_src)
    new_act = wi(wlike & ~t_u_eff, ACT_KILL,
                 wi(o_rd & t_em, ACT_DOWN, ACT_NONE))
    # touching a pending entry overrides the accumulated PROMOTE
    act_override = to & t_em_p
    at_to = _at(t_oh, to)
    dms = _put(dms, at_to, nts)
    dmc = _put(dmc, at_to, ntc)
    dmo = _put(dmo, at_to, nto)
    dmm_src = _put(dmm_src, at_to, ntm_src)
    touched = [x | a for a, x in zip(at_to, touched)]
    act_acc = _put(act_acc, at_to,
                   torch.where(act_override, new_act,
                               torch.maximum(t_act, new_act)))
    t_foreign = (t_s & (t_dmc > upg.to(i32))) | t_em
    mark = [x | a for a, x in zip(_at(t_oh, to & t_foreign), mark)]
    poison = [x | a for a, x in zip(_at(t_oh, to & c["seen_req"]), poison)]

    # --- fills -------------------------------------------------------------
    fstate = wi(is_wr, MOD, wi(own_txn & t_u_eff, EXC, SHD))
    f_val = torch.where(is_wr, val, torch.where(t_em_o, 0, t_dmm))
    f_src = torch.where(is_wr | ~is_own, -1,
                        torch.where(t_em_o, g_id, t_dmm_src))
    fill_at = _at(ci_oh, fill_r)
    ca = _put(c["ca"], fill_at, addr)
    cv = _put(cv, fill_at, f_val)
    cv_src = _put(cv_src, fill_at, f_src)
    cs = _put(cs, fill_at, fstate)
    rrf = _put(c["rrf"], fill_at, rem_txn & rd_miss)
    wf = [x | f for f, x in zip(fill_at, c["wf"])]
    # write-hit-after-last-fill: set on hit writes, cleared by fills
    lwh = [~f & (x | w) for f, w, x in zip(fill_at, at_wm, c["lwh"])]

    frozen = c["frozen"] | (is_txn & ~c["stopped"] & ~stop_now)
    stopped = c["stopped"] | stop_now
    return dict(ca=ca, cv=cv, cs=cs, cv_src=cv_src, rrf=rrf, wf=wf,
                lwh=lwh,
                dms=dms, dmc=dmc, dmo=dmo, dmm=dmm, dmm_src=dmm_src,
                touched=touched, act_acc=act_acc, mark=mark,
                poison=poison, cv_req=cv_req, cv_req_src=cv_req_src,
                stopped=stopped, frozen=frozen, truncated=truncated,
                n_slot=n_slot, n_g=n_g, seen_req=seen_req,
                n_ret=n_ret, rh=rh, wh=wh,
                c_rd=c_rd, c_wr=c_wr, c_up=c_up, c_ev=c_ev,
                s_overq=s_overq, s_overg=s_overg, s_dup=s_dup,
                s_dep=s_dep, s_live=s_live,
                kind=kind, ent=ent, sval=sval, comm=comm,
                rel=rel, relv=relv, reld=reld,
                g_owner=g_owner, g_ci=g_ci)
