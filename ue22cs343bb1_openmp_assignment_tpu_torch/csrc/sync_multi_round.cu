// The whole multi-transaction (txn_width >= 2) round for Hopper
// (sm_90a): one cooperative kernel a round.
//
// Replaces the JAX package's ops/pallas_window.py:_window_kernel and
// _replay_kernel together with the eager round around them
// (round_step_multi_pallas). Mosaic has no vector gather and no atomics,
// so the TPU kernels can only be the node-local folds, and the claim,
// the commit and the fan-out stay XLA ops between and after them. An
// H100 has gathers, atomics and grid-wide barriers, so one launch here
// takes the state as the engine holds it to the next round's state, as
// ops/sync_multi_round_kernel.plain_round does in plain PyTorch
// (ops/sync_engine._round_step_multi's tensor code):
//
//   in:  cache_addr/val/state [R, n, C], read in place (no transposes),
//        dm [R, E, 7], idx and instr_count [R, n], round and seed [R],
//        the 11 metric counters [R, 11];
//   out: the cache planes, dm, idx, round + 1 and the counters.
//
// R is the replica axis of a seed ensemble (ops/sync_engine.
// ensemble_round_step): R independent machines in one launch, between
// the same three grid barriers; one machine is R = 1, the same entry
// point and the same code. As in csrc/sync_round.cu, blocks are given to
// replicas (csrc/sync_round.cuh Team), a row of a 2-D grid a replica:
// each row serves one replica's nodes while the grid holds them all at
// one node a thread, else the resident blocks split evenly over the
// replicas. Every phase runs on
// one replica's view of the operands (replica()): its claims, commits
// and fan-out stay inside its own dm, its cv_pre plane and its slot and
// probe records are its own part of the scratch, its keys come from its
// own round and seed, and its counters are summed by blocks that serve
// it alone.
//
// The fold body is csrc/sync_window.cuh's swin::Fold (one node a
// thread, the procedural hash inline); the claim key, the dm copy, the
// fan-out of a line, the counters and the grid are csrc/sync_round.cuh's,
// which the txn_width 1 round (csrc/sync_round.cu) shares.
//
// Phases (each "|" is a grid barrier, cooperative_groups::this_grid()
// .sync(); the launch is cooperative, so every block is resident):
//
//   P0  the grid copies every replica's dm to dm_out in 16-byte words,
//       and writes each replica's round + 1 and its counters with
//       rounds + 1 |
//   P1  per node: the pre-claim window fold (sync_engine.window_fold)
//       on the round-start cache, up to the step that stops it; each
//       admitted transaction's slot record (entries, values, flags,
//       release and reacquire ordinals, step) and each step's probe
//       word (the entry of an interior hit, or the ordinal of a
//       dependent write) to scratch, with the prefix cache values
//       (cv_pre, frozen at the node's first transaction) in a scratch
//       plane of their own; a signed atomicMin of the claim key on
//       dm_out[e1, DM_CLAIM] for every admitted slot and on
//       dm_out[e2, DM_CLAIM] for every victim slot (an absent slot
//       claims nothing, as index E drops in sync_engine._claim) |
//   P2  per node: sync_engine.multi_middle in registers. The claim
//       words at e1 and e2 decide `win`; the rows at e1 and e2 (with
//       the reacquire base) give d_u, d_em and the outcomes; the probes
//       and the dependent writes give first_bad_hit; the commit prefix
//       and first_lose follow; the owner's value val_o comes from the
//       cv_pre plane; the release composition folds a displaced own
//       fill into its slot's row; the committed rows and the separate
//       eviction rows are written. Then, in the same thread and with no
//       barrier, the replay fold (sync_engine.replay_fold) with
//       first_lose and the fills in registers: the replayed cache to the
//       output planes, idx + n_ret |
//   P3  per node: the fan-out on the output planes (csrc/sync_round.cuh
//       fan_out_line: kill, downgrade, promote, DM_OWNER on promotion);
//       then the block's sums of a replica's 10 metric deltas (P2
//       leaves a node's eight in two scratch words, the fan-out adds
//       the other two), one integer atomicAdd a counter and block
//       (order-free, deterministic).
//
// Why P2 needs no barrier inside it. P2 writes whole dm rows and the
// node's own output cache planes; it reads claim words, rows, its own
// scratch and the cv_pre plane. Every value it reads is settled, or is
// read by a node whose use of it is masked by a loss:
//
// - Claim words. A row at entry x is written in P2 only by the node w
//   holding the minimum claim key on x (keys are unique per node): a
//   committed row at e1 needs the slot's win at e1, a separate eviction
//   row at e2 the win at e2 (a victim slot wins only with both). The
//   row's DM_CLAIM word is rewritten with w's key, the value it already
//   holds, so `win` and the interior-hit probes (`hgot`) read the same
//   word either way.
// - Rows at e1 and e2 of another node's entry. If r reads x's row while
//   w writes it, r claimed x (every admitted slot claims e1, every victim
//   slot e2) and loses that slot. A lost slot j breaks the commit prefix
//   at j: no slot from j on commits, and first_lose <= pos_j, so nothing
//   r derives from slot j's row reaches a committed row or the replay.
// - The dependent-write check (dok) reads d_u of the node's own slot j
//   (the slot whose ambiguous read fill the write is on). The write's
//   step comes after pos_j; if slot j lost, first_lose <= pos_j already,
//   so first_bad_hit at that step changes nothing. If slot j won, its
//   row is settled: only this node writes it, after all its reads.
// - base_m, the reacquire base, reads the victim row of an own slot i.
//   If slot i lost, the reacquiring slot j > i does not commit and its
//   fill is not replayed (as above); if it won, the row is settled.
// - A release: slot r's victim is slot j's own fill (e2_r == e1_j). Slot
//   j's composed row carries r's victim value and dirtiness, which are
//   slot r's own record from P1; both claims are this node's, and the
//   row is written once, by slot j (r's separate eviction row is not
//   written: ev_sep needs rel_ord == K).
// - One node's committed rows are distinct entries: a window admits an
//   entry as e1 once (own1 makes a second touch a dup); a separate
//   eviction row is never at an own e1 (a later fill of the entry is a
//   reacquire that consumes the eviction, an earlier one makes it a
//   release), and two victim slots never name one entry (the second
//   would have to displace a refill of it, which is a release).
// - val_o reads the cv_pre plane, written in P1 and never in P2, and
//   only for a committed slot, whose owner word d1o is settled.
// - The output cache planes are written in P2 by their own node only and
//   read in P3, after a barrier.
//
// The argument holds for each replica of a launch: replicas share no
// row of dm, of the cache planes or of the scratch (a replica's entries
// are clipped into its own [0, E)), so no node reads what another
// replica's nodes write.
//
// P3 reads DM_ACT and DM_REQ and writes DM_OWNER, different words, and
// each node writes only its own cache lines; a promoted entry has one
// holder left (the directory is exact), so its DM_OWNER has one writer.
// P0 | P1 stays a barrier (the atomics need the copied claim words), P1
// | P2 (win needs every claim) and P2 | P3 (the fan-out needs every
// committed row). Three grid barriers.
//
// Per-node values that cross a barrier go through scratch in device
// memory ([R_ROWS, n] a replica, written and read by the same thread,
// coalesced; the cv_pre plane is read by other nodes of the replica too),
// so a thread can run several nodes: the grid is the resident blocks
// (cached occupancy query), one node a thread while the nodes fit,
// larger machines and ensembles loop.
//
// What bounds it on the H100: bytes. At sync@4096 (C 4, K 3, W 7) the
// launch must move dm in and out (65,536 rows of 28 B each way, 3.67 MB)
// and the cache, cursor and counter planes (about 0.46 MB); its integer
// work is the two folds' steps (a hash with three 32-bit divisions, then
// select chains over C lines and K table entries, a few hundred
// instructions a step) and the middle's few hundred a node. What it
// takes is the slowest node's two dependent fold chains, three grid
// barriers and the dm copy. An ensemble of R moves R times the bytes in
// one launch. Its times beside its bound are in PERF.md, section 6.
//
// Semantics kept from JAX's int32: shifts of signed values whose result
// may wrap (round << 2, the key) go through uint32_t; the arithmetic >>
// of DM_ACT, which may be negative, stays signed; idx + n_ret wraps;
// gathers clip and the fold's entries are clipped into [0, E).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sync_round.cuh"
#include "sync_window.cuh"

namespace {

using namespace swin;
using namespace sround;
namespace cg = cooperative_groups;

constexpr int BLOCK = 64;
// At most this many resident blocks an SM (two warps a scheduler)
constexpr int MAX_BLOCKS_PER_SM = 4;
// Dynamic shared memory a block: none (the block's metric partials are
// a static array). The occupancy query and the launch both pass this.
constexpr size_t SMEM_BYTES = 0;
static_assert(W < 128, "a step index fits 7 bits of the slot word");
static_assert(MOD == line::MOD && EXC == line::EXC && SHD == line::SHD &&
                  INV == line::INV,
              "one CacheState");

// Per-node scratch: an int32 [R_ROWS, n] plane, row r of node i at
// r * n + i. Slot fields, K rows each, by transaction ordinal (rows of
// ordinals >= n_txn are not written and not read):
constexpr int S_E1 = 0;      // txn entry (clipped)
constexpr int S_E2 = 1;      // victim entry (clipped)
constexpr int S_VAL = 2;     // the instruction's value
constexpr int S_VVAL = 3;    // the displaced line's value
constexpr int S_BITS = 4;    // B_* | rel_ord << 8 | acq_base << 16 | pos << 24
constexpr int N_SF = 5;
constexpr int B_VICT = 1, B_RD = 2, B_WR = 4, B_UP = 8, B_VMOD = 16;
constexpr int R_SLOT = 0;
// one word a step before the stop: the entry (>= 0) of an interior hit
// to probe, or -1 - dep (dep: the ordinal of the fill a dependent write
// is on, K for none)
constexpr int R_STEP = N_SF * K;
constexpr int R_CVP = R_STEP + W;  // cv_pre, C rows ([C, n] plane)
constexpr int R_META = R_CVP + C;  // n_txn | steps before the stop << 8
// P2's metric deltas of the node, a byte each (every one is at most W):
constexpr int R_CNT0 = R_META + 1;  // n_ret | rh << 8 | wh << 16 | ev << 24
constexpr int R_CNT1 = R_META + 2;  // rd | wr << 8 | up << 16 | conf << 24
constexpr int R_ROWS = R_META + 3;

// The phases take one replica's view (replica()): n nodes, round and
// seed 0-d, scratch [R_ROWS, n].

__device__ __forceinline__ int& slot(const Args& a, int field, int j,
                                     int node) {
  return a.scratch[(size_t)(R_SLOT + field * K + j) * a.n + node];
}

// The fold of `node` from its round-start lines.
__device__ __forceinline__ void start_fold(const Args& a, int node,
                                           Fold& f) {
  int ca[C], cv[C], cs[C];
  load_row<true>(a.ca, node, ca);
  load_row<true>(a.cv, node, cv);
  load_row<true>(a.cs, node, cs);
  f.init_lines(ca, cv, cs);
}

// P1 for one node: the pre-claim fold, its records, its claims.
__device__ __forceinline__ void phase_window(const Args& a, const Keys& k,
                                             int node, int E) {
  const int n = a.n;
  Fold f;
  start_fold(a, node, f);
  const int idx = __ldg(a.idx + node), cnt = __ldg(a.cnt + node);
  const int key = k.key(node);
  int steps = W;
#pragma unroll 1
  for (int s_k = 0; s_k < W; ++s_k) {
    const Step s = f.step(node, idx, cnt, n, E, s_k);
    // the step that stops the window, and every step after it, admits
    // nothing, probes nothing and retires nothing
    if (f.stopped) {
      steps = s_k;
      break;
    }
    a.scratch[(size_t)(R_STEP + s_k) * n + node] = s.hc ? s.e1 : -1 - s.dep;
    if (s.ok) {
      const int j = s.ordn;
      slot(a, S_E1, j, node) = s.e1;
      slot(a, S_E2, j, node) = s.e2;
      slot(a, S_VAL, j, node) = s.val;
      slot(a, S_VVAL, j, node) = s.v_val;
      slot(a, S_BITS, j, node) =
          (s.victim ? B_VICT : 0) | (s.rd ? B_RD : 0) | (s.wr ? B_WR : 0) |
          (s.up ? B_UP : 0) | (s.v_mod ? B_VMOD : 0) | (s.rel_ord << 8) |
          (s.acq_base << 16) | (s_k << 24);
      atomicMin(a.dm_o + (size_t)s.e1 * DM_COLS + DM_CLAIM, key);
      if (s.victim)
        atomicMin(a.dm_o + (size_t)s.e2 * DM_COLS + DM_CLAIM, key);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    a.scratch[(size_t)(R_CVP + c) * n + node] = f.cvp[c];
  a.scratch[(size_t)R_META * n + node] = f.n_txn | (steps << 8);
}

// P2 for one node: verdicts, outcomes, commit, then the replay; its
// metric deltas go to scratch for P3.
__device__ __forceinline__ void phase_commit(const Args& a, const Keys& k,
                                             int round, int node, int E) {
  const int n = a.n;
  const int meta = a.scratch[(size_t)R_META * n + node];
  const int n_txn = meta & 0xFF, steps = meta >> 8;
  const int key = k.key(node);

  // the slot records, the claim verdicts and the rows at e1 and e2
  bool ex[K], win[K], vic[K], rd[K], wr[K], up[K], vmod[K];
  int e1[K], e2[K], val[K], vval[K], rel[K], acq[K], pos[K];
  int d1s[K], d1c[K], d1o[K], d1m[K], d2c[K], d2o[K], d2m[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ex[j] = j < n_txn;
    int bits = 0;
    e1[j] = e2[j] = val[j] = vval[j] = 0;
    d1s[j] = d1c[j] = d1o[j] = d1m[j] = d2c[j] = d2o[j] = d2m[j] = 0;
    win[j] = false;
    if (ex[j]) {
      e1[j] = slot(a, S_E1, j, node);
      e2[j] = slot(a, S_E2, j, node);
      val[j] = slot(a, S_VAL, j, node);
      vval[j] = slot(a, S_VVAL, j, node);
      bits = slot(a, S_BITS, j, node);
      const int* r1 = a.dm_o + (size_t)e1[j] * DM_COLS;
      const int* r2 = a.dm_o + (size_t)e2[j] * DM_COLS;
      const bool v = bits & B_VICT;
      win[j] = r1[DM_CLAIM] == key && (!v || r2[DM_CLAIM] == key);
      d1s[j] = r1[DM_STATE];
      d1c[j] = r1[DM_COUNT];
      d1o[j] = r1[DM_OWNER];
      d1m[j] = r1[DM_MEM];
      if (v) {
        d2c[j] = r2[DM_COUNT];
        d2o[j] = r2[DM_OWNER];
        d2m[j] = r2[DM_MEM];
      }
    }
    vic[j] = bits & B_VICT;
    rd[j] = bits & B_RD;
    wr[j] = bits & B_WR;
    up[j] = bits & B_UP;
    vmod[j] = (bits & B_VMOD) && vic[j];
    rel[j] = ex[j] ? (bits >> 8) & 0xFF : K;
    acq[j] = ex[j] ? (bits >> 16) & 0xFF : K;
    pos[j] = (int)((uint32_t)bits >> 24);
  }

  // a reacquired entry is Uncached with the evict's memory (the flushed
  // value for an M line): the effective primary rows
  bool d_u[K], d_em[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    int base_m = 0;
#pragma unroll
    for (int i = 0; i < K; ++i)
      base_m = acq[j] == i ? (vmod[i] ? vval[i] : d2m[i]) : base_m;
    const bool base_u = acq[j] < K;
    d1s[j] = base_u ? D_U : d1s[j];
    d1c[j] = base_u ? 0 : d1c[j];
    d1m[j] = base_u ? base_m : d1m[j];
    d_u[j] = d1s[j] == D_U;
    d_em[j] = d1s[j] == D_EM;
  }

  // tentative writes on own read fills retire iff the fill resolved
  // EXCLUSIVE; interior hits iff their entry carries no fresh foreign
  // claim (fresh keys of this round sit strictly below every stale
  // key). The first failure truncates retirement at its step.
  const int thresh = (int)((k.countdown + 1u) << PB);
  int first_bad_hit = W;
#pragma unroll 1
  for (int s_k = 0; s_k < steps; ++s_k) {
    const int w = a.scratch[(size_t)(R_STEP + s_k) * n + node];
    bool unsafe;
    if (w >= 0) {
      const int hg = a.dm_o[(size_t)w * DM_COLS + DM_CLAIM];
      unsafe = !(hg >= thresh || hg == key);
    } else {
      const int dep = -1 - w;
      bool dok = false;
#pragma unroll
      for (int j = 0; j < K; ++j) dok = dok || (dep == j && d_u[j]);
      unsafe = dep < K && !dok;
    }
    if (unsafe) {
      first_bad_hit = s_k;
      break;
    }
  }

  // committed = the leading prefix of transactions that win their claims
  // and sit before any unsafe hit
  bool commit[K];
  int first_lose = first_bad_hit;
  bool run = true;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    run = run && ((win[j] && pos[j] < first_bad_hit) || !ex[j]);
    commit[j] = ex[j] && run;
    if (ex[j] && !run) first_lose = pos[j] < first_lose ? pos[j] : first_lose;
  }

  // the transaction outcomes, the release composition, the commit
  const int rtag = (int)((uint32_t)round << 2);
  int fill_state[K], fill_val[K];
  int n_rd = 0, n_wr = 0, n_up = 0, n_conf = 0, n_ev = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool rd_w = commit[j] && rd[j], wr_w = commit[j] && wr[j],
               up_w = commit[j] && up[j];
    const bool wlike = wr_w || up_w;
    int val_o = 0;
    if (commit[j] && d_em[j]) {
      // the EM owner's line in the prefix cache
      const int ci = (e1[j] & S_MASK) % C;
      val_o = a.scratch[(size_t)(R_CVP + ci) * n + clip(d1o[j], 0, n - 1)];
    }
    const bool acq1 = wlike || (rd_w && d_u[j]);
    int n1s = acq1 ? D_EM : D_S;
    int n1c = acq1 ? 1 : (rd_w && d_em[j] ? 2 : d1c[j] + 1);
    int n1o = acq1 ? node : d1o[j];
    int n1m = ((rd_w || wr_w) && d_em[j]) ? val_o : d1m[j];
    int act1 = wlike ? ACT_KILL
                     : (rd_w && d_em[j] ? ACT_DOWNGRADE : ACT_NONE);
    const bool ev = commit[j] && vic[j];
    const bool ev_mod = ev && vmod[j];
    const int n2c = ev_mod ? 0 : d2c[j] - 1;
    const int n2s = n2c == 0 ? D_U : (n2c == 1 ? D_EM : D_S);
    const int n2m = ev_mod ? vval[j] : d2m[j];
    const int act2 = (ev && !ev_mod && n2c == 1) ? ACT_PROMOTE : ACT_NONE;

    // a committed txn r whose victim is slot j's own fill releases slot
    // j: entry e1_j's final row is the acquire outcome followed by the
    // self-eviction, written by slot j alone
    bool released = false, rel_dirty = false, consumed = false;
    int rel_val = 0;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const bool m = commit[r] && rel[r] == j;
      released = released || m;
      rel_val = m ? vval[r] : rel_val;
      rel_dirty = rel_dirty || (m && vmod[r]);
      consumed = consumed || (commit[r] && acq[r] == j);
    }
    if (released) {
      const bool rd_rel = rd[j] && !d_u[j] && !d_em[j];   // rd on S
      const bool gone = wlike || (rd[j] && d_u[j]);
      const bool rd_em = rd[j] && d_em[j];
      n1s = gone ? D_U : (rd_em ? D_EM : (d1c[j] == 1 ? D_EM : D_S));
      n1c = gone ? 0 : (rd_em ? 1 : d1c[j]);
      n1o = d1o[j];
      // a read fill written through a dependent hit before its
      // displacement flushes the written value, like a MODIFIED evict
      n1m = (wlike || rel_dirty) ? rel_val : (rd_em ? val_o : d1m[j]);
      act1 = wlike ? ACT_KILL
                   : ((rd_em || (rd_rel && d1c[j] == 1)) ? ACT_PROMOTE
                                                         : ACT_NONE);
    }
    if (commit[j]) {
      int* row = a.dm_o + (size_t)e1[j] * DM_COLS;
      const int out[DM_COLS] = {n1s, n1c, n1o, n1m, rtag | act1, node, key};
#pragma unroll
      for (int c = 0; c < DM_COLS; ++c) row[c] = out[c];
    }
    // a release's victim row rides in slot j's composed row, and a
    // reacquired entry's row is written by the reacquiring slot alone
    if (ev && rel[j] == K && !consumed) {
      int* row = a.dm_o + (size_t)e2[j] * DM_COLS;
      const int out[DM_COLS] = {n2s, n2c, d2o[j], n2m, rtag | act2, node,
                                key};
#pragma unroll
      for (int c = 0; c < DM_COLS; ++c) row[c] = out[c];
    }
    fill_state[j] = rd[j] ? (d_u[j] ? EXC : SHD) : MOD;
    fill_val[j] = rd[j] ? (d_em[j] ? val_o : d1m[j]) : val[j];
    n_rd += rd_w ? 1 : 0;
    n_wr += wr_w ? 1 : 0;
    n_up += up_w ? 1 : 0;
    // conflicts count claim-arbitration losses only
    n_conf += (ex[j] && !win[j]) ? 1 : 0;
    n_ev += ev ? 1 : 0;
  }

  // the replay: the retired prefix applied to the round-start cache
  // (steps from first_lose on, and from the stop on, retire nothing)
  Fold f;
  start_fold(a, node, f);
  int ca_c[C], cv_c[C], cs_c[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ca_c[c] = f.ca[c];
    cv_c[c] = f.cv[c];
    cs_c[c] = f.cs[c];
  }
  const int idx = __ldg(a.idx + node), cnt = __ldg(a.cnt + node);
  const int last = first_lose < steps ? first_lose : steps;
  int n_ret = 0, rh = 0, wh = 0;
#pragma unroll 1
  for (int s_k = 0; s_k < last; ++s_k) {
    const Step s = f.step(node, idx, cnt, n, E, s_k);
    const bool r = s.hit_ok || s.ok;
    n_ret += r ? 1 : 0;
    rh += (s.rd_hit && r) ? 1 : 0;
    const bool wm = s.wr_hit && r;
    wh += wm ? 1 : 0;
    const bool fill = s.ok && r;
    int fs = 0, fv = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      fs = s.ordn == j ? fill_state[j] : fs;
      fv = s.ordn == j ? fill_val[j] : fv;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool mc = s.ci == c;
      cv_c[c] = (wm && mc) ? s.val : cv_c[c];
      cs_c[c] = (wm && mc) ? MOD : cs_c[c];
      ca_c[c] = (fill && mc) ? s.addr : ca_c[c];
      cv_c[c] = (fill && mc) ? fv : cv_c[c];
      cs_c[c] = (fill && mc) ? fs : cs_c[c];
    }
  }
  store_row(a.ca_o, node, ca_c);
  store_row(a.cv_o, node, cv_c);
  store_row(a.cs_o, node, cs_c);
  a.idx_o[node] = (int)((uint32_t)idx + (uint32_t)n_ret);
  a.scratch[(size_t)R_CNT0 * n + node] =
      n_ret | (rh << 8) | (wh << 16) | (n_ev << 24);
  a.scratch[(size_t)R_CNT1 * n + node] =
      n_rd | (n_wr << 8) | (n_up << 16) | (n_conf << 24);
}

// P3 for one node: the fan-out over its replayed lines, and P2's metric
// deltas.
__device__ __forceinline__ void phase_fanout(const Args& a, int round,
                                             int node, int E,
                                             int (&acc)[N_DELTAS]) {
  // the scratch words first: the fan-out's DM_OWNER stores may alias
  // them as far as the compiler knows, so loads after it would wait
  const int c0 = a.scratch[(size_t)R_CNT0 * a.n + node];
  const int c1 = a.scratch[(size_t)R_CNT1 * a.n + node];
  int ca[C], cs[C];
  load_row<false>(a.ca_o, node, ca);
  load_row<false>(a.cs_o, node, cs);
#pragma unroll
  for (int c = 0; c < C; ++c)
    fan_out_line(a.dm_o, E, round, node, ca[c], cs[c], acc);
  store_row(a.cs_o, node, cs);
  acc[M_RET] += c0 & 0xFF;
  acc[M_RH] += (c0 >> 8) & 0xFF;
  acc[M_WH] += (c0 >> 16) & 0xFF;
  acc[M_EV] += (c0 >> 24) & 0xFF;
  acc[M_RD] += c1 & 0xFF;
  acc[M_WR] += (c1 >> 8) & 0xFF;
  acc[M_UP] += (c1 >> 16) & 0xFF;
  acc[M_CONF] += (c1 >> 24) & 0xFF;
}

__global__ void __launch_bounds__(BLOCK) sync_multi_round_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int n = a.n, E = (int)((uint32_t)n << SW_BLOCK_BITS);
  // the block's first replica's round and keys, read before the dm
  // copy; Team comes from the launch's indices, taken afresh in each
  // phase rather than kept across the barriers
  const RoundKeys first = round_keys(a.round, a.seed, team<BLOCK>().group);
  Team t;

  copy_dm(a.dm, a.dm_o, (size_t)a.reps * E * DM_COLS, grid_first<BLOCK>(),
          grid_threads<BLOCK>());
  start_counters(a, grid_first<BLOCK>(), grid_threads<BLOCK>());
  grid.sync();
  t = team<BLOCK>();
#pragma unroll 1
  for (int r = t.group; r < a.reps; r += t.groups) {
    const Args v = replica<C, R_ROWS>(a, r, E);
    const RoundKeys rk =
        r == t.group ? first : round_keys(a.round, a.seed, r);
#pragma unroll 1
    for (int node = t.node0; node < n; node += t.nstride)
      phase_window(v, rk.k, node, E);
  }
  grid.sync();
  t = team<BLOCK>();
#pragma unroll 1
  for (int r = t.group; r < a.reps; r += t.groups) {
    const Args v = replica<C, R_ROWS>(a, r, E);
    const RoundKeys rk =
        r == t.group ? first : round_keys(a.round, a.seed, r);
#pragma unroll 1
    for (int node = t.node0; node < n; node += t.nstride)
      phase_commit(v, rk.k, rk.round, node, E);
  }
  grid.sync();
  t = team<BLOCK>();
#pragma unroll 1
  for (int r = t.group; r < a.reps; r += t.groups) {
    const Args v = replica<C, R_ROWS>(a, r, E);
    const int round = r == t.group ? first.round : __ldg(v.round);
    int acc[N_DELTAS];
#pragma unroll
    for (int j = 0; j < N_DELTAS; ++j) acc[j] = 0;
#pragma unroll 1
    for (int node = t.node0; node < n; node += t.nstride)
      phase_fanout(v, round, node, E, acc);
    flush_counters<BLOCK>(acc, v.metrics_o);
  }
}

Grid<BLOCK, MAX_BLOCKS_PER_SM, SMEM_BYTES> the_grid;

}  // namespace

// Plain C entry points (bound with ctypes).
extern "C" {

// int32 elements of the scratch buffer the kernel needs for reps
// replicas of n nodes
long long sync_multi_round_scratch_ints(int reps, int n) {
  return (long long)R_ROWS * n * reps;
}

// dynamic shared memory a block that the occupancy query and the
// launch pass
int sync_multi_round_smem_bytes() { return (int)SMEM_BYTES; }

// the kernel's static shared memory a block, from the loaded image
// (cudaFuncGetAttributes), or -(CUDA error)
int sync_multi_round_static_smem_bytes() {
  cudaFuncAttributes attr;
  const cudaError_t e =
      cudaFuncGetAttributes(&attr, sync_multi_round_kernel);
  return e == cudaSuccess ? (int)attr.sharedSizeBytes : -(int)e;
}

// the grid the launch for reps replicas of n nodes uses (>= 1), or
// -(CUDA error)
int sync_multi_round_grid(int reps, int n) {
  dim3 grid;
  const int err =
      the_grid.grid_for(sync_multi_round_kernel, reps > 0 ? reps : 1,
                        n > 0 ? n : 1, &grid);
  return err ? -err : (int)(grid.x * grid.y);
}

// One round of reps machines of n nodes each, launched cooperatively on
// `stream` without synchronising; returns the launch's CUDA error (0 on
// success). reps >= 1, n >= 1.
int sync_multi_round(const int* ca, const int* cv, const int* cs,
                     const int* dm, const int* idx, const int* cnt,
                     const int* round, const int* seed, const int* metrics,
                     int* ca_o, int* cv_o, int* cs_o, int* dm_o, int* idx_o,
                     int* round_o, int* metrics_o, int* scratch, int reps,
                     int n, void* stream) {
  if (n <= 0 || reps <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid;
  const int err = the_grid.grid_for(sync_multi_round_kernel, reps, n, &grid);
  if (err) return err;
  Args a = {ca,    cv,      cs,        dm,      idx,  cnt,  round,
            seed,  metrics, ca_o,      cv_o,    cs_o, dm_o, idx_o,
            round_o, metrics_o, scratch, n,     reps};
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)sync_multi_round_kernel, grid, dim3(BLOCK), args, SMEM_BYTES,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
