// Deep-window fold kernel for Hopper (sm_90a): one thread per node.
//
// Replaces the three Pallas TPU kernels of the JAX package's
// ops/pallas_deep.py, which share one fold body (_run_fold):
//   _pre_kernel    (pre-pass fold: every step attempted; emits the Q
//                   remote-event slots and the own-entry mark/poison flags)
//   _flags_kernel  (flag pass: truncated by the dense own-lane codes;
//                   emits commit-prefix-sharp mark/poison)
//   _replay_kernel (replay fold with the arbitration verdicts applied;
//                   emits the committed cache, own-directory rows, slot
//                   commit/release records, owner-value slots, counters)
// as ONE body with three output modes (template parameter MODE). The
// body is ops/deep_fold.fold_step iterated over the W window steps,
// written out for a single node; ops/deep_fold.py is its plain version
// and the parity reference.
//
// Layout: every input and output keeps the transposed [rows, N] int32
// layout of the Pallas kernels (row r of node i at r * n + i), so the
// round middle is unchanged and loads/stores along N coalesce across a
// warp.
//
// What bounds it on the H100: at the bench shapes (C=4, S=16, Q=3, G=1,
// W=16) a replay call moves about 1.2 KB per node (about 5 MB at
// N=4096, 1.5 us at 3.35 TB/s) and executes about 18k integer
// instructions per node (about 11k in the pre and flag modes; most are
// the select chains of the table reads and writes), about 4.4 us at
// N=4096 on the int32 lanes, so integer work bounds it before memory.
// It runs several times slower than that: launch latency and the
// latency of one thread's long dependent chain are the limit. One thread per node at 128 threads a block gives 32 blocks
// at N=4096, so most of the 132 SMs idle; that is what holds the kernel
// back, and the next step is to split a node's table work across lanes.
//
// Register pressure: the fold carry is about 170 live int32 values per
// node. C, S, Q, G, W, the block bits and the config branches (waves,
// read storm) are compile-time constants (-D flags per config), every
// per-line / per-entry / per-slot loop is fully unrolled, and dynamic
// table indices are select chains, so the carry stays in registers;
// boolean tables are bit masks. The W loop is not unrolled.

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(DF_C) || !defined(DF_S) || !defined(DF_BLOCK_BITS) || \
    !defined(DF_Q) || !defined(DF_G) || !defined(DF_W) ||           \
    !defined(DF_WAVES1) || !defined(DF_STORM)
#error "the build defines DF_C, DF_S, DF_BLOCK_BITS, DF_Q, DF_G, DF_W, DF_WAVES1, DF_STORM"
#endif

namespace {

constexpr int C = DF_C;           // cache lines per node
constexpr int S = DF_S;           // own-directory entries (1 << block_bits)
constexpr int BB = DF_BLOCK_BITS;
constexpr int Q = DF_Q;           // remote-event slots
constexpr int G = DF_G;           // owner-value slots
constexpr int W = DF_W;           // window steps
constexpr bool WAVES1 = DF_WAVES1 != 0;
constexpr bool STORM = DF_STORM != 0;
constexpr int BLOCK = 128;

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

enum Mode { PRE = 0, FLAGS = 1, REPLAY = 2 };

struct FoldArgs {
  const int* ca;      // [C, n]
  const int* cv;
  const int* cs;
  const int* dms;     // [S, n] own-directory state/count/owner/memory
  const int* dmc;
  const int* dmo;
  const int* dmm;
  const int* woa;     // [W, n] window: op << 28 | addr, value, live
  const int* wval;
  const int* wlive;
  const int* hor;     // [n] attempt horizon
  const int* bad;     // [Q, n] slot verdicts (REPLAY)
  const int* ocode;   // [S, n] own-lane codes (FLAGS, REPLAY)
  int* out0;
  int* out1;
  int* out2;
  int* out3;
  int* out4;
  int n;
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

template <int MODE>
__global__ void __launch_bounds__(BLOCK) deep_fold_kernel(FoldArgs a) {
  const int node = blockIdx.x * BLOCK + threadIdx.x;
  const int n = a.n;
  if (node >= n) return;

  int ca[C], cv[C], cs[C], cv_src[C], cv_req[C], cv_req_src[C];
  uint32_t rrf = 0, wf = 0, lwh = 0;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    ca[i] = a.ca[i * n + node];
    cv[i] = a.cv[i * n + node];
    cs[i] = a.cs[i * n + node];
    cv_src[i] = -1;
    cv_req[i] = cv[i];
    cv_req_src[i] = -1;
  }
  int dms[S], dmc[S], dmo[S], dmm[S], dmm_src[S], act_acc[S], ocode[S];
  uint32_t touched = 0, mark = 0, poison = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    dms[s] = a.dms[s * n + node];
    dmc[s] = a.dmc[s * n + node];
    dmo[s] = a.dmo[s * n + node];
    dmm[s] = a.dmm[s * n + node];
    dmm_src[s] = -1;
    act_acc[s] = 0;
    ocode[s] = MODE == PRE ? 0 : a.ocode[s * n + node];
  }
  int bad[Q], kind[Q], ent[Q], sval[Q], relv[Q];
  uint32_t comm = 0, rel = 0, reld = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    bad[q] = MODE == REPLAY ? a.bad[q * n + node] : 0;
    kind[q] = 0;
    ent[q] = 0;
    sval[q] = 0;
    relv[q] = 0;
  }
  int g_owner[G], g_ci[G];
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
    const int oa = a.woa[k * n + node];
    const int val = a.wval[k * n + node];
    const bool live = (a.wlive[k * n + node] != 0) && (k < hor);
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

  const auto flag = [&](int s) {
    return (int)((mark >> s) & 1u) * F_MARK +
           (int)((poison >> s) & 1u) * F_POISON;
  };
  if (MODE == PRE) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      a.out0[q * n + node] = kind[q];
      a.out0[(Q + q) * n + node] = ent[q];
      a.out0[(2 * Q + q) * n + node] = sval[q];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) a.out1[s * n + node] = flag(s);
  } else if (MODE == FLAGS) {
#pragma unroll
    for (int s = 0; s < S; ++s) a.out0[s * n + node] = flag(s);
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      a.out0[i * n + node] = ca[i];
      a.out0[(C + i) * n + node] = cv[i];
      a.out0[(2 * C + i) * n + node] = cs[i];
      a.out0[(3 * C + i) * n + node] = cv_src[i];
      a.out0[(4 * C + i) * n + node] = cv_req[i];
      a.out0[(5 * C + i) * n + node] = cv_req_src[i];
      a.out0[(6 * C + i) * n + node] = (int)((lwh >> i) & 1u);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      a.out1[s * n + node] = dms[s];
      a.out1[(S + s) * n + node] = dmc[s];
      a.out1[(2 * S + s) * n + node] = dmo[s];
      a.out1[(3 * S + s) * n + node] = dmm[s];
      a.out1[(4 * S + s) * n + node] = dmm_src[s];
      a.out1[(5 * S + s) * n + node] = (int)((touched >> s) & 1u);
      a.out1[(6 * S + s) * n + node] = act_acc[s];
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      a.out2[q * n + node] = (int)((comm >> q) & 1u);
      a.out2[(Q + q) * n + node] = (int)((rel >> q) & 1u);
      a.out2[(2 * Q + q) * n + node] = relv[q];
      a.out2[(3 * Q + q) * n + node] = (int)((reld >> q) & 1u);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      a.out3[g * n + node] = g_owner[g];
      a.out3[(G + g) * n + node] = g_ci[g];
    }
    a.out4[0 * n + node] = n_ret;
    a.out4[1 * n + node] = rh;
    a.out4[2 * n + node] = wh;
    a.out4[3 * n + node] = c_rd;
    a.out4[4 * n + node] = c_wr;
    a.out4[5 * n + node] = c_up;
    a.out4[6 * n + node] = c_ev;
  }
}

template <int MODE>
int launch(const FoldArgs& a, void* stream) {
  if (a.n > 0) {
    const int grid = (a.n + BLOCK - 1) / BLOCK;
    deep_fold_kernel<MODE>
        <<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

FoldArgs inputs(const int* ca, const int* cv, const int* cs,
                const int* dms, const int* dmc, const int* dmo,
                const int* dmm, const int* woa, const int* wval,
                const int* wlive, const int* hor, int n) {
  FoldArgs a{};
  a.ca = ca; a.cv = cv; a.cs = cs;
  a.dms = dms; a.dmc = dmc; a.dmo = dmo; a.dmm = dmm;
  a.woa = woa; a.wval = wval; a.wlive = wlive; a.hor = hor;
  a.n = n;
  return a;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" {

int deep_fold_pre(const int* ca, const int* cv, const int* cs,
                  const int* dms, const int* dmc, const int* dmo,
                  const int* dmm, const int* woa, const int* wval,
                  const int* wlive, const int* hor, int* slots,
                  int* flags, int n, void* stream) {
  FoldArgs a = inputs(ca, cv, cs, dms, dmc, dmo, dmm, woa, wval, wlive,
                      hor, n);
  a.out0 = slots;
  a.out1 = flags;
  return launch<PRE>(a, stream);
}

int deep_fold_flags(const int* ca, const int* cv, const int* cs,
                    const int* dms, const int* dmc, const int* dmo,
                    const int* dmm, const int* woa, const int* wval,
                    const int* wlive, const int* hor, const int* ocode,
                    int* flags, int n, void* stream) {
  FoldArgs a = inputs(ca, cv, cs, dms, dmc, dmo, dmm, woa, wval, wlive,
                      hor, n);
  a.ocode = ocode;
  a.out0 = flags;
  return launch<FLAGS>(a, stream);
}

int deep_fold_replay(const int* ca, const int* cv, const int* cs,
                     const int* dms, const int* dmc, const int* dmo,
                     const int* dmm, const int* woa, const int* wval,
                     const int* wlive, const int* hor, const int* bad,
                     const int* ocode, int* cache, int* dm, int* slots,
                     int* gslots, int* counters, int n, void* stream) {
  FoldArgs a = inputs(ca, cv, cs, dms, dmc, dmo, dmm, woa, wval, wlive,
                      hor, n);
  a.bad = bad;
  a.ocode = ocode;
  a.out0 = cache;
  a.out1 = dm;
  a.out2 = slots;
  a.out3 = gslots;
  a.out4 = counters;
  return launch<REPLAY>(a, stream);
}

}  // extern "C"
