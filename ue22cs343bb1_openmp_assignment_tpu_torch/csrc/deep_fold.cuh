// The deep-window fold for one node, as a __device__ function.
//
// Shared by csrc/deep_fold.cu (the three fold kernels: pre, flags,
// replay) and csrc/deep_round.cu (the fused round kernel, which runs the
// same fold three times between its grid-wide phases). The body is
// ops/deep_fold.fold_step iterated over the W window steps, written out
// for a single node; ops/deep_fold.py is its plain version and the
// parity reference. The three modes of the JAX package's Pallas folds
// differ only in their inputs and in which outputs they keep: the
// pre-pass passes zero verdicts and zero own-lane codes, the flag pass
// zero verdicts, the replay both; the compiler drops what a caller does
// not read.
//
// Register pressure: the fold carry is about 170 live int32 values per
// node. C, S, Q, G, W, the block bits and the config branches (waves,
// read storm) are compile-time constants (-D flags per config), every
// per-line / per-entry / per-slot loop is fully unrolled, and dynamic
// table indices are select chains, so the carry stays in registers;
// boolean tables are bit masks. The W loop is not unrolled.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(DF_C) || !defined(DF_S) || !defined(DF_BLOCK_BITS) || \
    !defined(DF_Q) || !defined(DF_G) || !defined(DF_W) ||           \
    !defined(DF_WAVES1) || !defined(DF_STORM)
#error "the build defines DF_C, DF_S, DF_BLOCK_BITS, DF_Q, DF_G, DF_W, DF_WAVES1, DF_STORM"
#endif

namespace dfold {

constexpr int C = DF_C;           // cache lines per node
constexpr int S = DF_S;           // own-directory entries (1 << block_bits)
constexpr int BB = DF_BLOCK_BITS;
constexpr int Q = DF_Q;           // remote-event slots
constexpr int G = DF_G;           // owner-value slots
constexpr int W = DF_W;           // window steps
constexpr bool WAVES1 = DF_WAVES1 != 0;
constexpr bool STORM = DF_STORM != 0;

static_assert(S == (1 << BB), "S must be 1 << block_bits");
static_assert(C <= 32 && S <= 32 && Q <= 32, "bool tables are 32-bit masks");

constexpr int MOD = 0, EXC = 1, SHD = 2, INV = 3;        // CacheState
constexpr int D_EM = 0, D_S = 1, D_U = 2;                // DirState
constexpr int OP_READ = 0, OP_WRITE = 1, OP_NOP = 2;     // Op
constexpr int K_RD = 1, K_WR = 2, K_UP = 3, K_EVS = 4, K_EVM = 5,
              K_PROBE = 6;                               // slot kinds
constexpr int OC_FRESH = 1, OC_EV = 2, OC_BEATS = 4;     // own-lane codes
constexpr int ACT_NONE = 0, ACT_DOWN = 1, ACT_KILL = 2, ACT_PROMOTE = 3;
constexpr int F_MARK = 1, F_POISON = 2;

// A strided int32 plane: element (row r, node i) at p[r * rs + i * ns].
// The fold kernels pass [rows, n] planes (rs = n, ns = 1); the round
// kernel reads the own-directory columns straight out of the [E, 7]
// directory (rs = 7, ns = 7 * S).
struct Plane {
  const int* p;
  int rs;
  int ns;
  __device__ __forceinline__ int operator()(int r, int i) const {
    return p[r * rs + i * ns];
  }
};

struct FoldIn {
  Plane ca, cv, cs;            // [C] cache lines
  Plane dms, dmc, dmo, dmm;    // [S] own-directory state/count/owner/memory
  Plane woa, wval, wlive;      // [W] window: op << 28 | addr, value, live
  const int* hor;              // [n] attempt horizon
};

// The final fold carry (the union of the three modes' outputs).
struct FoldOut {
  int ca[C], cv[C], cs[C], cv_src[C], cv_req[C], cv_req_src[C];
  uint32_t lwh;
  int dms[S], dmc[S], dmo[S], dmm[S], dmm_src[S], act_acc[S];
  uint32_t touched, mark, poison;
  int kind[Q], ent[Q], sval[Q], relv[Q];
  uint32_t comm, rel, reld;
  int g_owner[G], g_ci[G];
  int n_ret, rh, wh, c_rd, c_wr, c_up, c_ev;
};

// lst[idx]; an index matching no entry past the first selects lst[0]
// (deep_fold._sel)
template <int L>
__device__ __forceinline__ int sel(const int (&a)[L], int idx) {
  int out = a[0];
#pragma unroll
  for (int i = 1; i < L; ++i) out = (idx == i) ? a[i] : out;
  return out;
}

// lst[idx] = v where m (deep_fold._upd); out-of-range idx writes nothing
template <int L>
__device__ __forceinline__ void upd(int (&a)[L], int idx, bool m, int v) {
#pragma unroll
  for (int i = 0; i < L; ++i) a[i] = (m && idx == i) ? v : a[i];
}

template <int L>
__device__ __forceinline__ bool bsel(uint32_t w, int idx) {
  return (idx > 0 && idx < L) ? ((w >> idx) & 1u) != 0 : (w & 1u) != 0;
}

template <int L>
__device__ __forceinline__ uint32_t bupd(uint32_t w, int idx, bool m,
                                         bool v) {
  if (m && idx >= 0 && idx < L) {
    const uint32_t bit = 1u << idx;
    w = v ? (w | bit) : (w & ~bit);
  }
  return w;
}

// The fold of `node`'s window with slot verdicts `bad_in` and own-lane
// codes `ocode_in` (zeros disable truncation), into `o`.
__device__ __forceinline__ void fold_node(const FoldIn& a, int node,
                                          const int (&bad_in)[Q],
                                          const int (&ocode_in)[S],
                                          FoldOut& o) {
  int (&ca)[C] = o.ca;
  int (&cv)[C] = o.cv;
  int (&cs)[C] = o.cs;
  int (&cv_src)[C] = o.cv_src;
  int (&cv_req)[C] = o.cv_req;
  int (&cv_req_src)[C] = o.cv_req_src;
  uint32_t rrf = 0, wf = 0, lwh = 0;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    ca[i] = a.ca(i, node);
    cv[i] = a.cv(i, node);
    cs[i] = a.cs(i, node);
    cv_src[i] = -1;
    cv_req[i] = cv[i];
    cv_req_src[i] = -1;
  }
  int (&dms)[S] = o.dms;
  int (&dmc)[S] = o.dmc;
  int (&dmo)[S] = o.dmo;
  int (&dmm)[S] = o.dmm;
  int (&dmm_src)[S] = o.dmm_src;
  int (&act_acc)[S] = o.act_acc;
  int ocode[S];
  uint32_t touched = 0, mark = 0, poison = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    dms[s] = a.dms(s, node);
    dmc[s] = a.dmc(s, node);
    dmo[s] = a.dmo(s, node);
    dmm[s] = a.dmm(s, node);
    dmm_src[s] = -1;
    act_acc[s] = 0;
    ocode[s] = ocode_in[s];
  }
  int bad[Q];
  int (&kind)[Q] = o.kind;
  int (&ent)[Q] = o.ent;
  int (&sval)[Q] = o.sval;
  int (&relv)[Q] = o.relv;
  uint32_t comm = 0, rel = 0, reld = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    bad[q] = bad_in[q];
    kind[q] = 0;
    ent[q] = 0;
    sval[q] = 0;
    relv[q] = 0;
  }
  int (&g_owner)[G] = o.g_owner;
  int (&g_ci)[G] = o.g_ci;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    g_owner[g] = 0;
    g_ci[g] = 0;
  }
  bool stopped = false, frozen = false, truncated = false, seen_req = false;
  int n_slot = 0, n_g = 0;
  int n_ret = 0, rh = 0, wh = 0, c_rd = 0, c_wr = 0, c_up = 0, c_ev = 0;
  const int hor = a.hor[node];

#pragma unroll 1
  for (int k = 0; k < W; ++k) {
    const int oa = a.woa(k, node);
    const int val = a.wval(k, node);
    const bool live = (a.wlive(k, node) != 0) && (k < hor);
    // cache values as of the node's first fill-request attempt
    if (!seen_req) {
#pragma unroll
      for (int i = 0; i < C; ++i) {
        cv_req[i] = cv[i];
        cv_req_src[i] = cv_src[i];
      }
    }
    const int op = oa >> 28;
    const int addr = oa & 0x0FFFFFFF;
    const int block = addr & (S - 1);
    const bool is_own = (addr >> BB) == node;
    const int ci = block % C;
    const int l_addr = sel(ca, ci);
    const int l_val = sel(cv, ci);
    const int l_state = sel(cs, ci);
    const int l_src = sel(cv_src, ci);
    const bool l_rrf = bsel<C>(rrf, ci);
    const bool l_wf = bsel<C>(wf, ci);
    const bool tag_ok = (l_addr == addr) && (l_state != INV);
    const bool is_rd = op == OP_READ, is_wr = op == OP_WRITE;
    const bool rd_hit = live && is_rd && tag_ok;
    const bool wr_hit =
        live && is_wr && tag_ok && (l_state == MOD || l_state == EXC);
    const bool wr_sh = live && is_wr && tag_ok && (l_state == SHD);
    const bool nop = live && (op == OP_NOP);
    const bool dep_stop = WAVES1 ? (wr_sh && l_rrf) : false;
    const bool upg = WAVES1 ? (wr_sh && !l_rrf) : wr_sh;
    const bool rd_miss = live && is_rd && !tag_ok;
    const bool wr_miss = live && is_wr && !tag_ok;
    const bool is_txn = (upg || rd_miss || wr_miss) && !dep_stop;
    const bool hit = rd_hit || wr_hit || nop;

    const bool has_victim =
        is_txn && !tag_ok && (l_state != INV) && (l_addr != addr);
    const int v_block = l_addr & (S - 1);
    const bool v_own = (l_addr >> BB) == node;
    const bool v_mod = l_state == MOD;
    const bool own_txn = is_txn && is_own;
    const bool rem_txn = is_txn && !is_own;
    const bool own_vic = has_victim && v_own;
    const bool rem_vic = has_victim && !v_own;
    const bool probe = hit && frozen && !is_own && !l_wf;

    // own register reads
    const int t_dms = sel(dms, block);
    const int t_dmc = sel(dmc, block);
    const int t_dmo = sel(dmo, block);
    const int t_dmm = sel(dmm, block);
    const int t_dmm_src = sel(dmm_src, block);
    const int t_act = sel(act_acc, block);
    const int v_dmc = sel(dmc, v_block);
    const int v_act = sel(act_acc, v_block);

    // stop conditions
    uint32_t rel_hit = 0;
    if (!STORM) {
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (kind[q] >= K_RD && kind[q] <= K_UP && ent[q] == l_addr)
          rel_hit |= 1u << q;
    }
    const bool rel_any_all = rel_hit != 0;
    const bool rel_any = rel_any_all && rem_vic;
    bool dup_t = false, dup_v = false;
    if (WAVES1) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const bool isrem = kind[q] >= K_RD && kind[q] <= K_EVM;
        dup_t = dup_t || (isrem && ent[q] == addr);
        dup_v = dup_v || (isrem && ent[q] == l_addr);
      }
    }
    const bool dup = (dup_t && rem_txn) || (dup_v && rem_vic && !rel_any);
    const bool vic_slot = rem_vic && !rel_any_all;
    const int n_need = (int)rem_txn + (int)vic_slot + (int)probe;
    const bool over_q = (n_slot + n_need) > Q;
    const bool t_em_o = (t_dms == D_EM) && (t_dmo != node) && (t_dmo >= 0);
    const bool t_em_p = (t_dms == D_EM) && (t_dmo == -1);
    const bool t_em = t_em_o || t_em_p;
    const bool g_need = own_txn && (rd_miss || wr_miss) && t_em_o;
    const bool over_g = g_need && (n_g >= G);
    const bool stop_now =
        (!stopped && live && !nop &&
         (dep_stop || over_q || over_g || dup || !(hit || is_txn))) ||
        (!stopped && !live);
    const bool act = !stopped && !stop_now && (hit || is_txn);

    // truncation (replay verdicts, own-lane yields)
    const int o1 = n_slot;
    const int o2 = o1 + (int)vic_slot;
    const int bad1 = sel(bad, o1);
    const int bad2 = sel(bad, o2);
    const bool slot_bad = (vic_slot && act && bad1 != 0) ||
                          ((rem_txn || probe) && act && bad2 != 0);
    const int tc = sel(ocode, block);
    const int vc = sel(ocode, v_block);
    const bool post = seen_req;
    bool y_bad =
        own_txn && (((tc & OC_EV) && (tc & OC_BEATS)) ||
                    (post && (tc & OC_FRESH) && (tc & OC_BEATS)));
    y_bad = y_bad ||
            (own_vic && (((vc & OC_EV) && (vc & OC_BEATS)) ||
                         (post && (vc & OC_FRESH) && (vc & OC_BEATS))));
    y_bad = y_bad || ((rd_hit || wr_hit) && is_own && post &&
                      (tc & OC_FRESH) && !(tc & OC_EV));
    truncated = truncated || ((slot_bad || y_bad) && act);
    const bool r = act && !truncated;

    const bool rem_txn_a = rem_txn && act;
    const bool g_take = g_need && act;
    const bool fill_r = (own_txn || rem_txn) && r;

    // slot emission (attempt-based); releases are retirement-gated
    const bool rem_vic_slot = rem_vic && act && !rel_any_all;
    const bool mrel_m = rem_vic && r;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (((rel_hit >> q) & 1u) && mrel_m) {
        rel |= 1u << q;
        relv[q] = l_val;
        if (v_mod) reld |= 1u << q;
      }
    }
    upd(kind, o1, rem_vic_slot, v_mod ? K_EVM : K_EVS);
    upd(ent, o1, rem_vic_slot, l_addr > 0 ? l_addr : 0);
    upd(sval, o1, rem_vic_slot, l_val);
    comm = bupd<Q>(comm, o1, rem_vic_slot && r, r);
    const bool fp = rem_txn_a || (probe && act);
    const int fill_kind =
        probe ? K_PROBE : (rd_miss ? K_RD : (wr_miss ? K_WR : K_UP));
    const int slot_v = probe ? (int)seen_req : val;
    upd(kind, o2, fp, fill_kind);
    upd(ent, o2, fp, addr > 0 ? addr : 0);
    upd(sval, o2, fp, slot_v);
    comm = bupd<Q>(comm, o2, rem_txn_a && r, r);
    n_slot += act ? n_need : 0;
    const bool seen_old = seen_req;
    seen_req = seen_req || rem_txn_a;

    // g-slot (own-EM owner value)
    upd(g_owner, n_g, g_take, t_dmo > 0 ? t_dmo : 0);
    upd(g_ci, n_g, g_take, ci);
    const int g_id = n_g;
    n_g += (int)g_take;

    // counters
    n_ret += (int)r;
    rh += (int)(rd_hit && r);
    wh += (int)(wr_hit && r);
    c_rd += (int)(rd_miss && r);
    c_wr += (int)(wr_miss && r);
    c_up += (int)(upg && r);
    c_ev += (int)(has_victim && r);

    // hit write effects
    const bool wm = wr_hit && r;
    upd(cv, ci, wm, val);
    upd(cv_src, ci, wm, -1);
    upd(cs, ci, wm, MOD);

    // own victim composition
    const bool vo = own_vic && r;
    const bool ev_m = vo && v_mod;
    const bool ev_s = vo && !v_mod && (l_state == SHD);
    const int nvc = ev_s ? v_dmc - 1 : 0;
    const int nvs = (ev_s && nvc >= 2) ? D_S : ((ev_s && nvc == 1) ? D_EM : D_U);
    const bool promote = ev_s && (nvc == 1);
    upd(dms, v_block, vo, nvs);
    upd(dmc, v_block, vo, nvc);
    upd(dmo, v_block, vo && promote, -1);
    upd(dmm, v_block, ev_m, l_val);
    upd(dmm_src, v_block, ev_m, l_src);
    touched = bupd<S>(touched, v_block, vo, true);
    const int v_new = promote ? ACT_PROMOTE : ACT_NONE;
    upd(act_acc, v_block, vo, v_act > v_new ? v_act : v_new);
    const bool v_foreign = ev_s && (v_dmc > 1);
    mark = bupd<S>(mark, v_block, vo && v_foreign, true);
    poison = bupd<S>(poison, v_block, vo && seen_old, true);

    // own target composition
    const bool to = own_txn && r;
    const bool t_u_eff = (t_dms == D_U) || ((t_dms == D_EM) && (t_dmo == node));
    const bool t_s = t_dms == D_S;
    const bool o_rd = to && rd_miss, o_wr = to && wr_miss, o_up = to && upg;
    const bool wlike = o_wr || o_up;
    const bool excl = wlike || (o_rd && t_u_eff);
    const int nts = excl ? D_EM : D_S;
    const int ntc = excl ? 1 : ((o_rd && t_em) ? 2 : t_dmc + 1);
    const int nto = excl ? node : t_dmo;
    const bool flush = (o_rd || o_wr) && t_em_o;
    const int ntm_src = flush ? g_id : t_dmm_src;
    const int new_act = (wlike && !t_u_eff)
                            ? ACT_KILL
                            : ((o_rd && t_em) ? ACT_DOWN : ACT_NONE);
    // touching a pending entry overrides the accumulated PROMOTE
    const bool act_override = to && t_em_p;
    upd(dms, block, to, nts);
    upd(dmc, block, to, ntc);
    upd(dmo, block, to, nto);
    upd(dmm_src, block, to, ntm_src);
    touched = bupd<S>(touched, block, to, true);
    upd(act_acc, block, to,
        act_override ? new_act : (t_act > new_act ? t_act : new_act));
    const bool t_foreign = (t_s && t_dmc > (upg ? 1 : 0)) || t_em;
    mark = bupd<S>(mark, block, to && t_foreign, true);
    poison = bupd<S>(poison, block, to && seen_old, true);

    // fills
    const int fstate = is_wr ? MOD : ((own_txn && t_u_eff) ? EXC : SHD);
    const int f_val = is_wr ? val : (t_em_o ? 0 : t_dmm);
    const int f_src = (is_wr || !is_own) ? -1 : (t_em_o ? g_id : t_dmm_src);
    upd(ca, ci, fill_r, addr);
    upd(cv, ci, fill_r, f_val);
    upd(cv_src, ci, fill_r, f_src);
    upd(cs, ci, fill_r, fstate);
    rrf = bupd<C>(rrf, ci, fill_r, rem_txn && rd_miss);
    wf = bupd<C>(wf, ci, fill_r, true);
    // write-hit-after-last-fill: set on hit writes, cleared by fills
    lwh = bupd<C>(lwh, ci, wm, true);
    lwh = bupd<C>(lwh, ci, fill_r, false);

    frozen = frozen || (is_txn && !stopped && !stop_now);
    stopped = stopped || stop_now;
  }

  o.lwh = lwh;
  o.touched = touched;
  o.mark = mark;
  o.poison = poison;
  o.comm = comm;
  o.rel = rel;
  o.reld = reld;
  o.n_ret = n_ret;
  o.rh = rh;
  o.wh = wh;
  o.c_rd = c_rd;
  o.c_wr = c_wr;
  o.c_up = c_up;
  o.c_ev = c_ev;
}

}  // namespace dfold
