// Fused deep round for Hopper (sm_90a): one cooperative kernel a round.
//
// Replaces the JAX package's ops/pallas_round.py:_round_kernel (its body
// _round_body: the three window folds around deep_engine.deep_round_core,
// launched by _call_round). One launch takes the built window and the
// state to the round's directory, committed cache, retirement counts and
// metric delta rows, as ops/deep_round_kernel.plain_round does in plain
// PyTorch (deep_engine.deep_round_core with the plain folds).
//
// Three choices of the TPU kernel do not carry over, and this kernel
// makes others:
//
// - One-hot routing. Mosaic has no vector gather, so the TPU kernel
//   routes every gather and scatter of the round middle through exact
//   one-hot f32 matmuls, and the claim scatter-min through a chunked
//   exponent ladder that caps the contenders per entry at 2^14. Here
//   they are plain loads, stores and a signed atomicMin, with the index
//   semantics of deep_engine.TorchIndexOps: gathers clip to [0, E),
//   scatters drop indices outside it. There is no contender cap.
// - All state resident in one program, grid (1,). The directory alone
//   is [E, 7] int32 (1.75 MiB at N=4096), far over a block's 227 KB of
//   shared memory. State lives in device memory (at N=4096 it all fits
//   the 50 MB L2), one thread runs one node at a time, and the phases
//   of the round are separated by grid-wide barriers
//   (cooperative_groups::this_grid().sync(); the launch is cooperative,
//   so every block is resident). What a later phase needs goes to
//   scratch in device memory (`scratch`, allocated by the wrapper).
//
// Shared memory: the three folds run the fold body of csrc/deep_fold.cuh
// with the node's S-indexed tables in the block's shared memory. Before
// each fold the block copies its nodes' span of the [E, 7] directory
// (one contiguous run of 64 x S rows) into shared memory with coalesced
// 16-byte loads, and with it the claim words of its own entries, which
// become the own-lane codes; each thread then moves its node's rows
// into its table column. The flags words and the replay's merged rows
// go back out the same way, coalesced. 62,720 B of dynamic shared
// memory a 64-thread block at S = 16 (S = 32 takes 124,160 B).
// - The read storm. The TPU kernel refuses deep_read_storm (duplicate
//   storm rows break its routed scatter); this one does not take it
//   either, and storm configs run the fold path, as in JAX.
//
// Phases (each "|" is a grid barrier):
//   P0 copy the DM_CLAIM column to the claim scratch, fill the wave
//      lanes | P1 pre-pass fold; lane keys; atomicMin into claim at the
//      request/notice slots | P2 own-lane codes; flag-pass fold
//      (deep_exact_flags) or the pre-pass flags; the [E] flags word |
//   P3 verdict gathers, truncation, home priority, req_abort; each extra
//      absorption wave is one atomicMin | gather pair across a barrier;
//      then the slot verdicts and the replay fold; the node's own
//      directory rows merged into dm_out, the pre-merge cv_req to
//      scratch | P4 owner-value slot gathers from the other nodes'
//      pre-merge cv_req; patch dm_out's DM_MEM; post-merge cv_req_m |
//   P5 per absorption wave: gather dm_out rows at the committed slots,
//      compose, scatter the rows (| between waves) |
//   P6 reply patches, fan-out reads of DM_ACT/DM_REQ, promotion writes
//      of DM_OWNER, cache, retirement and delta rows out.
// Six barriers at one wave, two more for each further wave.
//
// Races that atomics do not remove: within a composition wave the
// committed entries are unique (the TorchIndexOps contract), and only a
// committed slot gathers a row, so no row is read by one node while
// another writes it. Every other value a slot contributes is masked by
// its commit bit, as in deep_round_core. P6 reads DM_ACT/DM_REQ and
// writes DM_OWNER: different words. atomicMin is order-free, so the
// kernel is deterministic and bit-identical to the plain round.
//
// What bounds it on the H100: at deep@4096 the launch moves 5.08 MB
// (io_contract_bytes: inputs read once, outputs written once; the
// scratch, about 2 MB, stays in L2), and its integer work takes longer:
// chip_smoke.py bounds it by the integer operations a node that this
// kernel issues (counted on its SASS), capped by the work recorded for
// the one-thread-per-node round it replaced, over the int32 rate. The
// three folds take more than half of its time; the rest is the copies,
// the gathers of the middle phases and the six grid barriers, each of
// which waits for the slowest block. The grid is sized to the nodes (64
// blocks of 64 threads at N=4096, one node a thread while they fit the
// resident blocks) so that the barriers are cheap; larger machines loop
// over their nodes. The times and the block size chosen among 32, 64
// and 128 threads are in PERF.md, section 6 (an NVIDIA H100 80GB HBM3
// at 700 W). What holds it back now is the fold body's dependent chain,
// one warp per 32 nodes (csrc/deep_fold.cuh).
//
// Semantics kept from JAX's int32: shifts of signed values whose JAX
// result wraps (round << 11, the key layout) go through uint32_t; the
// arithmetic >> of values that may be negative (DM_ACT, owner -1) stays
// signed; the claim-key hash is uint32 arithmetic (ops/sync_engine.
// _round_key_rs).

#include <cooperative_groups.h>

#include "deep_fold.cuh"
#include "hash32.cuh"

#if !defined(DR_WAVES) || !defined(DR_EXACT)
#error "the build defines DR_WAVES and DR_EXACT"
#endif
#if DF_STORM
#error "the fused round kernel does not take read-storm configs"
#endif

namespace {

using namespace dfold;
using hash32::mix32;
namespace cg = cooperative_groups;

constexpr int WAVES = DR_WAVES;       // absorption waves
constexpr bool EXACT = DR_EXACT != 0; // deep_exact_flags
static_assert(WAVES >= 1 && WAVES <= 14, "deep_waves is in [1, 14]");
static_assert(WAVES1 == (WAVES == 1), "DF_WAVES1 must match DR_WAVES");

constexpr int bit_length(int v) { return v <= 0 ? 0 : 1 + bit_length(v >> 1); }
// lane-key slot bits (sync_engine.slot_bits)
constexpr int SB = WAVES == 1 ? 0 : (bit_length(Q - 1) > 1 ? bit_length(Q - 1) : 1);

constexpr int BLOCK = 64;
constexpr int DM_STATE = 0, DM_COUNT = 1, DM_OWNER = 2, DM_MEM = 3,
              DM_ACT = 4, DM_REQ = 5, DM_CLAIM = 6, DM_COLS = 7;
constexpr int I32_MAX = 0x7FFFFFFF;

// Shared memory of a block (int32 words): the S-indexed fold tables
// (deep_fold.cuh), the block's own directory rows [BLOCK][ROW] as a
// node-major copy of its span of the [E, 7] directory, the own-lane
// codes [BLOCK][S + 1], and per-thread words [SW_WORDS][BLOCK]. ROW and
// S + 1 are odd, so a thread's rows start in distinct banks: a warp's
// cooperative copies (consecutive words) and its per-thread accesses
// (one word of 32 nodes) are both free of bank conflicts.
constexpr int ROW = S * DM_COLS + 1;
constexpr int CROW = S + 1;
constexpr int SW_PRIO = 0, SW_MARK = 1, SW_POIS = 2, SW_WORDS = 3;
constexpr int SM_TABLES = 0;
constexpr int SM_ROWS = SM_TABLES + N_TABLES * S * BLOCK;
constexpr int SM_CODES = SM_ROWS + BLOCK * ROW;
constexpr int SM_WORDS = SM_CODES + BLOCK * CROW;
constexpr int SMEM_BYTES = (SM_WORDS + SW_WORDS * BLOCK) * (int)sizeof(int);
static_assert(SMEM_BYTES <= 227 * 1024, "the block's shared memory is over 227 KB");

// word j of the block's span of the directory, in its copy `rows`
__device__ __forceinline__ int row_at(int j) { return j + j / (S * DM_COLS); }

// Per-node scratch: an int32 [R_ROWS, n] plane, row r of node i at
// r * n + i. Masks hold one bit per slot (Q) or per line (C).
constexpr int R_KIND = 0;                 // [Q] pre-pass slot kinds
constexpr int R_ENT = R_KIND + Q;         // [Q] slot entries
constexpr int R_SVAL = R_ENT + Q;         // [Q] slot values
constexpr int R_KEY = R_SVAL + Q;         // [Q] lane keys
constexpr int R_PMARK = R_KEY + Q;        // pre-pass mark mask [S bits]
constexpr int R_PPOIS = R_PMARK + 1;      // pre-pass poison mask
constexpr int R_CLEAN = R_PPOIS + 1;      // no poison flag (clean_self)
constexpr int R_REQAB = R_CLEAN + 1;      // req_abort mask
constexpr int R_WON = R_REQAB + 1;        // [WAVES] won masks per wave
constexpr int R_CVREQ = R_WON + WAVES;    // [C] pre-merge cv_req (shared)
constexpr int R_CVREQM = R_CVREQ + C;     // [C] post-merge cv_req_m (shared)
constexpr int R_CA = R_CVREQM + C;        // [C] replay cache address
constexpr int R_CS = R_CA + C;            // [C] replay cache state
constexpr int R_CV = R_CS + C;            // [C] replay cache value
constexpr int R_CVSRC = R_CV + C;         // [C] its owner-value slot
constexpr int R_CVREQSRC = R_CVSRC + C;   // [C] cv_req's owner-value slot
constexpr int R_CVM = R_CVREQSRC + C;     // [C] cache value after merge
constexpr int R_DMMSRC = R_CVM + C;       // [S] touched rows' dmm_src
constexpr int R_GOWN = R_DMMSRC + S;      // [G] owner-value slot owners
constexpr int R_GCI = R_GOWN + G;         // [G] and lines
constexpr int R_LWH = R_GCI + G;          // write-hit-after-fill mask
constexpr int R_COMM = R_LWH + 1;         // replay commit mask
constexpr int R_REL = R_COMM + 1;         // replay release mask
constexpr int R_RELV = R_REL + 1;         // [Q] release values
constexpr int R_CNT = R_RELV + Q;         // [7] n_ret rh wh rd wr up ev
constexpr int R_PATCH = R_CNT + 7;        // reply-patch mask
constexpr int R_FILLE = R_PATCH + 1;      // fill-exclusive mask
constexpr int R_FILLV = R_FILLE + 1;      // [Q] patch values
constexpr int R_AW = R_FILLV + Q;         // [Q] committed wave stamps
constexpr int R_ROWS = R_AW + Q;
// Per-entry scratch: [E_PLANES, E] after the per-node rows: the claim
// column, the flags words, and one lane per extra absorption wave.
constexpr int E_PLANES = 2 + (WAVES - 1);

struct RoundArgs {
  const int* params;   // [2, n] round, seed (column 0 read)
  const int* dm;       // [E, 7]
  const int* ca;       // [C, n]
  const int* cv;
  const int* cs;
  const int* woa;      // [W, n]
  const int* wval;
  const int* wlive;
  const int* hor;      // [n]
  int* dm_out;         // [E, 7]
  int* cache_out;      // [3C, n]: address, value, state
  int* nret;           // [n]
  int* delta;          // [10, n]
  int* scratch;        // R_ROWS * n + E_PLANES * E
  int n;
  int prio_bits;       // max(1, bit_length(n - 1))
  int cmr;             // sync_engine.claim_max_rounds
};

// The round's claim keys (sync_engine._round_key_rs): a countdown in the
// high bits, a reseeded bijective node-priority permutation in the low.
struct Keys {
  uint32_t h;
  int pb;        // prio bits
  int pmask;
  int round;
  int countdown; // max(claim_max_rounds - round, 0)
  int thresh;    // fresh lane keys sit strictly below this

  __device__ __forceinline__ int prio(int node) const {
    uint32_t x = (uint32_t)node;
    x = (x * ((h << 1) | 1u) + (h >> 7)) & (uint32_t)pmask;
    x ^= x >> (pb / 2 > 1 ? pb / 2 : 1);
    x = (x * 0x9E3779B9u) & (uint32_t)pmask;
    return (int)x;
  }

  // the node's fill key: countdown above the priority and the slot bits
  __device__ __forceinline__ int key(int node) const {
    const int rk = (int)(((uint32_t)countdown << pb) | (uint32_t)prio(node));
    const int cd = rk >> pb;
    const int p = rk & pmask;
    return (int)(((uint32_t)cd << (pb + 1 + SB)) | ((uint32_t)p << (1 + SB)));
  }
};

__device__ __forceinline__ Keys make_keys(const RoundArgs& a) {
  Keys k;
  k.round = a.params[0];
  const int seed = a.params[a.n];
  k.h = mix32(((uint32_t)k.round * 0x9E3779B9u) ^
              ((uint32_t)seed * 0x85EBCA77u));
  k.pb = a.prio_bits;
  k.pmask = (1 << a.prio_bits) - 1;
  const int d = (int)((uint32_t)a.cmr - (uint32_t)k.round);
  k.countdown = d > 0 ? d : 0;
  k.thresh = (int)((uint32_t)(k.countdown + 1) << (a.prio_bits + 1 + SB));
  return k;
}

__device__ __forceinline__ FoldIn fold_in(const RoundArgs& a) {
  const FoldIn in = {a.ca, a.cv, a.cs, a.woa, a.wval, a.wlive, a.hor, a.n};
  return in;
}

__device__ __forceinline__ bool is_req(int kind) {
  return kind == K_RD || kind == K_WR || kind == K_UP;
}
__device__ __forceinline__ bool is_ev(int kind) {
  return kind == K_EVS || kind == K_EVM;
}
__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ bool bit(int mask, int i) {
  return ((mask >> i) & 1) != 0;
}

// a dense own-lane code: any fresh key on an own entry is foreign
__device__ __forceinline__ int own_code(const Keys& k, int lane,
                                        int prio_self) {
  const bool fresh = lane < k.thresh;
  const bool ev = (lane & 1) == 1;
  const bool beats = ((lane >> (1 + SB)) & k.pmask) < prio_self;
  return (fresh ? OC_FRESH : 0) | (fresh && ev ? OC_EV : 0) |
         (fresh && beats ? OC_BEATS : 0);
}

// The block's nodes are [base, base + BLOCK) (those below n are on);
// thread ln runs node base + ln in every phase. Block-wide helpers are
// called by every thread of the block.

// The fold tables of the block's nodes: their own directory rows (and,
// with OCODE, their own-lane codes from the claim words) copied in with
// coalesced loads, then moved by each thread into its table column.
template <bool OCODE>
__device__ __forceinline__ Tables<BLOCK> stage(const RoundArgs& a,
                                               const Keys& k, int base,
                                               int* smem, const int* claim) {
  const int ln = threadIdx.x, node = base + ln, n = a.n;
  const int nloc = n - base < BLOCK ? n - base : BLOCK;
  int* rows = smem + SM_ROWS;
  int* codes = smem + SM_CODES;
  int* words = smem + SM_WORDS;
  __syncthreads();  // the previous node group is done with shared memory
  if (OCODE && node < n) words[SW_PRIO * BLOCK + ln] = k.prio(node);
  // Every copy below loads a batch of words into registers before it
  // stores any: the compiler keeps a load after a store that it cannot
  // tell apart from it, which would make each load wait for the last.
  const int* span = a.dm + (size_t)base * S * DM_COLS;
  const int total = nloc * S * DM_COLS;
  // 16-byte loads where the span is aligned (it starts at a multiple of
  // BLOCK rows), words for the rest
  const int nvec = ((uintptr_t)span & 15) == 0 ? total / 4 : 0;
  constexpr int VB = 8;   // 16-byte loads in flight a thread
  for (int v0 = ln; v0 < nvec; v0 += VB * BLOCK) {
    int4 w[VB];
#pragma unroll
    for (int u = 0; u < VB; ++u)
      if (v0 + u * BLOCK < nvec)
        w[u] = __ldg(reinterpret_cast<const int4*>(span) + v0 + u * BLOCK);
#pragma unroll
    for (int u = 0; u < VB; ++u) {
      const int j = 4 * (v0 + u * BLOCK);
      if (v0 + u * BLOCK < nvec) {
        rows[row_at(j)] = w[u].x;
        rows[row_at(j + 1)] = w[u].y;
        rows[row_at(j + 2)] = w[u].z;
        rows[row_at(j + 3)] = w[u].w;
      }
    }
  }
  for (int j = 4 * nvec + ln; j < total; j += BLOCK) rows[row_at(j)] = ld(span + j);
  if (OCODE) {
    __syncthreads();
    // the codes, and the claim words as the rows' DM_CLAIM column: a
    // thread's words are j = ln + i * BLOCK, i < S
    int lane[S];
#pragma unroll
    for (int i = 0; i < S; ++i)
      if (ln + i * BLOCK < nloc * S)
        lane[i] = claim[(size_t)base * S + ln + i * BLOCK];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int j = ln + i * BLOCK, owner = j / S;
      if (j < nloc * S) {
        codes[j + owner] =
            own_code(k, lane[i], words[SW_PRIO * BLOCK + owner]);
        rows[row_at(j * DM_COLS + DM_CLAIM)] = lane[i];
      }
    }
  }
  __syncthreads();
  const Tables<BLOCK> t = Tables<BLOCK>::of(smem + SM_TABLES, ln);
  if (node < n) {
    int dir[S][4], oc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int c = 0; c < 4; ++c)   // DM_STATE..DM_MEM = T_DMS..T_DMM
        dir[s][c] = rows[ln * ROW + s * DM_COLS + c];
      if (OCODE) oc[s] = codes[ln * CROW + s];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int c = 0; c < 4; ++c) t.put(T_DMS + c, s, dir[s][c]);
      if (OCODE) t.put(T_OCODE, s, oc[s]);
    }
  }
  return t;
}

// the flags words of the block's own entries, from each node's masks
__device__ __forceinline__ void write_flags(int base, int n, int* smem,
                                            uint32_t mark, uint32_t poison,
                                            int* flags) {
  const int ln = threadIdx.x;
  const int nloc = n - base < BLOCK ? n - base : BLOCK;
  int* words = smem + SM_WORDS;
  words[SW_MARK * BLOCK + ln] = (int)mark;
  words[SW_POIS * BLOCK + ln] = (int)poison;
  __syncthreads();
  // a thread's words are j = ln + i * BLOCK, i < S: all computed, then
  // all stored
  int f[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int j = ln + i * BLOCK, owner = j / S, s = j % S;
    f[i] = j < nloc * S
               ? ((words[SW_MARK * BLOCK + owner] >> s) & 1) * F_MARK +
                     ((words[SW_POIS * BLOCK + owner] >> s) & 1) * F_POISON
               : 0;
  }
#pragma unroll
  for (int i = 0; i < S; ++i)
    if (ln + i * BLOCK < nloc * S) flags[(size_t)base * S + ln + i * BLOCK] = f[i];
}

// P1: pre-pass fold, lane keys, claim scatter-min (block-wide)
__device__ __forceinline__ void phase_pre(const RoundArgs& a, const Keys& k,
                                          int base, int* smem, int* sc,
                                          int* claim) {
  const int n = a.n, E = n * S, node = base + threadIdx.x;
  const Tables<BLOCK> t = stage<false>(a, k, base, smem, claim);
  if (node >= n) return;
  const int bad[Q] = {};
  FoldOut o;
  fold_node<BLOCK, false>(fold_in(a), node, bad, t, o);
  const int key = k.key(node);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    int kq = key | (SB ? q << 1 : 0);
    if (is_ev(o.kind[q])) kq |= 1;
    sc[(R_KIND + q) * n + node] = o.kind[q];
    sc[(R_ENT + q) * n + node] = o.ent[q];
    sc[(R_SVAL + q) * n + node] = o.sval[q];
    sc[(R_KEY + q) * n + node] = kq;
    const int e = o.ent[q];
    if ((is_req(o.kind[q]) || is_ev(o.kind[q])) && e >= 0 && e < E)
      atomicMin(&claim[e], kq);
  }
  sc[R_PMARK * n + node] = (int)o.mark;
  sc[R_PPOIS * n + node] = (int)o.poison;
}

// P2: own-lane codes, the flag-pass fold, the flags word of own entries
// (block-wide)
__device__ __forceinline__ void phase_flags(const RoundArgs& a,
                                            const Keys& k, int base,
                                            int* smem, int* sc,
                                            const int* claim, int* flags) {
  const int n = a.n, node = base + threadIdx.x;
  uint32_t mark = 0, poison = 0;
  if (EXACT) {
    const Tables<BLOCK> t = stage<true>(a, k, base, smem, claim);
    if (node < n) {
      const int bad[Q] = {};
      FoldOut o;
      fold_node<BLOCK, true>(fold_in(a), node, bad, t, o);
      mark = o.mark;
      poison = o.poison;
    }
  } else {
    __syncthreads();  // the previous node group is done with shared memory
    if (node < n) {
      mark = (uint32_t)sc[R_PMARK * n + node];
      poison = (uint32_t)sc[R_PPOIS * n + node];
    }
  }
  write_flags(base, n, smem, mark, poison, flags);
  if (node < n) sc[R_CLEAN * n + node] = poison == 0;
}

// P3, wave j: j == 0 gathers the claim and flags words (lane wins,
// req_abort); j >= 1 gathers wave lane j - 1. Each but the last
// scatter-mins the next wave's candidates.
template <int J>
__device__ __forceinline__ void phase_wave(const RoundArgs& a, const Keys& k,
                                           int node, int* sc,
                                           const int* claim,
                                           const int* flags, int* lanes) {
  const int n = a.n, E = n * S;
  int reqab, won_any = 0;
  if (J == 0) {
    const int prio_self = k.prio(node);
    const bool clean = sc[R_CLEAN * n + node] != 0;
    reqab = 0;
    int won = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int kind = sc[(R_KIND + q) * n + node];
      const int safe = clip(sc[(R_ENT + q) * n + node], 0, E - 1);
      const int kq = sc[(R_KEY + q) * n + node];
      const int got_flags = flags[safe];
      if (claim[safe] == kq) won |= 1 << q;
      const bool home_wins = k.prio(safe >> BB) < prio_self;
      if (is_req(kind) && (got_flags & F_POISON) && home_wins && !clean)
        reqab |= 1 << q;
    }
    sc[R_REQAB * n + node] = reqab;
    sc[R_WON * n + node] = won;
    won_any = won;
  } else {
    reqab = sc[R_REQAB * n + node];
#pragma unroll
    for (int j = 0; j < J; ++j) won_any |= sc[(R_WON + j) * n + node];
    int won = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int kind = sc[(R_KIND + q) * n + node];
      const int safe = clip(sc[(R_ENT + q) * n + node], 0, E - 1);
      const int kq = sc[(R_KEY + q) * n + node];
      const bool cand = is_req(kind) && !bit(reqab, q) && !bit(won_any, q);
      if (cand && lanes[(J - 1) * E + safe] == kq) won |= 1 << q;
    }
    sc[(R_WON + J) * n + node] = won;
    won_any |= won;
  }
  if (J < WAVES - 1) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int kind = sc[(R_KIND + q) * n + node];
      const int e = sc[(R_ENT + q) * n + node];
      const bool cand = is_req(kind) && !bit(reqab, q) && !bit(won_any, q);
      if (cand && e >= 0 && e < E)
        atomicMin(&lanes[J * E + e], sc[(R_KEY + q) * n + node]);
    }
  }
}

// P3, after the last wave: slot verdicts, the replay fold, the block's
// own directory rows into dm_out (block-wide)
__device__ __forceinline__ void phase_replay(const RoundArgs& a,
                                             const Keys& k, int base,
                                             int* smem, int* sc,
                                             const int* claim,
                                             const int* flags) {
  const int n = a.n, E = n * S, ln = threadIdx.x, node = base + ln;
  const Tables<BLOCK> t = stage<true>(a, k, base, smem, claim);
  int* rows = smem + SM_ROWS;
  if (node < n) {
    const int prio_self = k.prio(node);
    const int reqab = sc[R_REQAB * n + node];
    const int won0 = sc[R_WON * n + node];
    int won_any = 0;
#pragma unroll
    for (int j = 0; j < WAVES; ++j) won_any |= sc[(R_WON + j) * n + node];
    int bad[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int kind = sc[(R_KIND + q) * n + node];
      const int safe = clip(sc[(R_ENT + q) * n + node], 0, E - 1);
      const int sval = sc[(R_SVAL + q) * n + node];
      const int lane_got = claim[safe];
      const int got_flags = flags[safe];
      const bool lane_fresh = lane_got < k.thresh;
      const bool lane_is_ev = (lane_got & 1) == 1;
      const bool home_wins = k.prio(safe >> BB) < prio_self;
      const bool ev_abort = is_ev(kind) && (got_flags & F_MARK) && home_wins;
      const bool req_bad =
          is_req(kind) && (!bit(won_any, q) || bit(reqab, q));
      const bool ev_bad = is_ev(kind) && (!bit(won0, q) || ev_abort);
      const bool probe_bad =
          kind == K_PROBE &&
          ((got_flags & F_MARK) || (sval != 0 && lane_fresh && !lane_is_ev));
      bad[q] = (req_bad || ev_bad || probe_bad) ? 1 : 0;
    }
    FoldOut o;
    fold_node<BLOCK, true>(fold_in(a), node, bad, t, o);

#pragma unroll
    for (int c = 0; c < C; ++c) {
      sc[(R_CVREQ + c) * n + node] = o.cv_req[c];
      sc[(R_CA + c) * n + node] = o.ca[c];
      sc[(R_CS + c) * n + node] = o.cs[c];
      sc[(R_CV + c) * n + node] = o.cv[c];
      sc[(R_CVSRC + c) * n + node] = o.cv_src[c];
      sc[(R_CVREQSRC + c) * n + node] = o.cv_req_src[c];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sc[(R_GOWN + g) * n + node] = o.g_owner[g];
      sc[(R_GCI + g) * n + node] = o.g_ci[g];
    }
    sc[R_LWH * n + node] = (int)o.lwh;
    sc[R_COMM * n + node] = (int)o.comm;
    sc[R_REL * n + node] = (int)o.rel;
#pragma unroll
    for (int q = 0; q < Q; ++q) sc[(R_RELV + q) * n + node] = o.relv[q];
    const int cnt[7] = {o.n_ret, o.rh, o.wh, o.c_rd, o.c_wr, o.c_up, o.c_ev};
#pragma unroll
    for (int i = 0; i < 7; ++i) sc[(R_CNT + i) * n + node] = cnt[i];

    // dense merge of own rows into the block's copy of them; DM_ACT
    // packs (round << 11) | (act_h << 9) | (promo << 8) | (kw << 4) | dw,
    // the own chain's stamps being 1
    const uint32_t rtag = (uint32_t)k.round << 11;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool touched = ((o.touched >> s) & 1u) != 0;
      sc[(R_DMMSRC + s) * n + node] = touched ? t.get(T_DMM_SRC, s) : -1;
      if (touched) {
        int* row = rows + ln * ROW + s * DM_COLS;
        const int acc = t.get(T_ACT, s);
        row[DM_STATE] = t.get(T_DMS, s);
        row[DM_COUNT] = t.get(T_DMC, s);
        row[DM_OWNER] = t.get(T_DMO, s);
        row[DM_MEM] = t.get(T_DMM, s);
        row[DM_ACT] = (int)(rtag | ((uint32_t)(acc == ACT_PROMOTE) << 8) |
                            ((uint32_t)(acc == ACT_KILL) << 4) |
                            (uint32_t)(acc == ACT_DOWN));
        row[DM_REQ] = node;
      }
    }
  }
  // the block's rows out, coalesced (DM_CLAIM holds the claim words)
  __syncthreads();
  const int nloc = n - base < BLOCK ? n - base : BLOCK;
  int* span = a.dm_out + (size_t)base * S * DM_COLS;
  const int total = nloc * S * DM_COLS;
  const int nvec = ((uintptr_t)span & 15) == 0 ? total / 4 : 0;
  constexpr int VB = 8;   // as in stage: a batch of loads, then its stores
  for (int v0 = ln; v0 < nvec; v0 += VB * BLOCK) {
    int4 w[VB];
#pragma unroll
    for (int u = 0; u < VB; ++u) {
      const int j = 4 * (v0 + u * BLOCK);
      if (v0 + u * BLOCK < nvec)
        w[u] = make_int4(rows[row_at(j)], rows[row_at(j + 1)],
                         rows[row_at(j + 2)], rows[row_at(j + 3)]);
    }
#pragma unroll
    for (int u = 0; u < VB; ++u)
      if (v0 + u * BLOCK < nvec)
        reinterpret_cast<int4*>(span)[v0 + u * BLOCK] = w[u];
  }
  for (int j = 4 * nvec + ln; j < total; j += BLOCK) span[j] = rows[row_at(j)];
}

// P4: owner-value slots from the other nodes' pre-merge cv_req
__device__ __forceinline__ void phase_merge(const RoundArgs& a, int node,
                                            int* sc) {
  const int n = a.n;
  int gv[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int ci = sc[(R_GCI + g) * n + node];
    const int owner = clip(sc[(R_GOWN + g) * n + node], 0, n - 1);
    gv[g] = sc[(R_CVREQ + ci) * n + owner];
  }
  const auto merged = [&](int v, int src) {
#pragma unroll
    for (int g = 0; g < G; ++g) v = src == g ? gv[g] : v;
    return v;
  };
  // every load before the first store, so that they overlap
  int src[S], cv[C], cv_src[C], cvreq[C], cvreq_src[C];
#pragma unroll
  for (int s = 0; s < S; ++s) src[s] = sc[(R_DMMSRC + s) * n + node];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    cv[c] = sc[(R_CV + c) * n + node];
    cv_src[c] = sc[(R_CVSRC + c) * n + node];
    cvreq[c] = sc[(R_CVREQ + c) * n + node];
    cvreq_src[c] = sc[(R_CVREQSRC + c) * n + node];
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (src[s] >= 0 && src[s] < G)
      a.dm_out[(node * S + s) * DM_COLS + DM_MEM] = merged(0, src[s]);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    sc[(R_CVM + c) * n + node] = merged(cv[c], cv_src[c]);
    sc[(R_CVREQM + c) * n + node] = merged(cvreq[c], cvreq_src[c]);
  }
}

// P5, wave J: request composition at the slots committed in this wave
template <int J>
__device__ __forceinline__ void phase_compose(const RoundArgs& a,
                                              const Keys& k, int node,
                                              int* sc) {
  const int n = a.n, E = n * S;
  const int stamp = J + 2;
  const int won = sc[(R_WON + J) * n + node];
  const int comm = sc[R_COMM * n + node];
  const int relm = sc[R_REL * n + node];
  int patch_acc = 0, fille_acc = 0, fillv[Q], aw[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    fillv[q] = J == 0 ? 0 : sc[(R_FILLV + q) * n + node];
    aw[q] = J == 0 ? 0 : sc[(R_AW + q) * n + node];
  }
  if (J > 0) {
    patch_acc = sc[R_PATCH * n + node];
    fille_acc = sc[R_FILLE * n + node];
  }
  const uint32_t rtag = (uint32_t)k.round << 11;
  // the slots' scratch words, all loaded before the first row store
  int kinds[Q], ents[Q], svals[Q], keys[Q], relvs[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    kinds[q] = sc[(R_KIND + q) * n + node];
    ents[q] = sc[(R_ENT + q) * n + node];
    svals[q] = sc[(R_SVAL + q) * n + node];
    keys[q] = sc[(R_KEY + q) * n + node];
    relvs[q] = sc[(R_RELV + q) * n + node];
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int kind = kinds[q];
    const bool commit =
        (is_req(kind) || is_ev(kind)) && bit(won, q) && bit(comm, q);
    if (!commit) continue;
    const int safe = clip(ents[q], 0, E - 1);
    const int sval = svals[q];
    const int kq = keys[q];
    int* row = a.dm_out + safe * DM_COLS;
    const int r_state = row[DM_STATE], r_cnt = row[DM_COUNT],
              r_own = row[DM_OWNER], r_mem = row[DM_MEM],
              r_act = row[DM_ACT], r_req = row[DM_REQ];
    const int r_ci = (safe & (S - 1)) % C;
    // a pending row (same-round promotion, owner == -1) serves its
    // memory as the owner value; the round-value channel rides DM_REQ
    const bool r_pend = r_state == D_EM && r_own == -1;
    const bool prev_fresh = (r_act >> 11) == k.round;
    const int rv_got = prev_fresh ? (r_req >> 16) & 0x3FF : 0;
    int own_val = r_pend ? r_mem
                         : sc[(R_CVREQM + r_ci) * n + clip(r_own, 0, n - 1)];
    own_val = (rv_got & 0x200) ? r_mem : own_val;
    own_val = (rv_got & 0x100) ? (rv_got & 0xFF) : own_val;
    const bool r_u = r_state == D_U, r_s = r_state == D_S,
               r_em = r_state == D_EM;
    const bool k_rd = kind == K_RD, k_wr = kind == K_WR, k_up = kind == K_UP,
               k_evs = kind == K_EVS, k_evm = kind == K_EVM;
    const bool wlike = k_wr || k_up;
    const int prev_ah = prev_fresh ? (r_act >> 9) & 3 : ACT_NONE;
    const bool prev_promo = prev_fresh && ((r_act >> 8) & 1) == 1;
    const int prev_kw = prev_fresh ? (r_act >> 4) & 15 : 0;
    const int prev_dw = prev_fresh ? r_act & 15 : 0;
    const bool tgt_home = r_own == (safe >> BB);
    // release: the requester displaced its own window fill of this entry
    // later in the window; the slot commits the fill+evict NET row
    const bool rel = bit(relm, q) && (k_rd || wlike);
    const int relv = relvs[q];
    const int evs_cnt = r_s ? r_cnt - 1 : r_cnt;
    int n_state =
        wlike ? D_EM
              : k_rd ? (r_u ? D_EM : D_S)
                     : (k_evm || (k_evs && r_em))
                           ? D_U
                           : (k_evs && r_s)
                                 ? (evs_cnt == 0 ? D_U
                                                 : (evs_cnt == 1 ? D_EM : D_S))
                                 : r_state;
    int n_cnt = (wlike || (k_rd && r_u))
                    ? 1
                    : (k_rd && r_em)
                          ? 2
                          : (k_rd && r_s)
                                ? r_cnt + 1
                                : (k_evm || (k_evs && r_em))
                                      ? 0
                                      : (k_evs && r_s) ? evs_cnt : r_cnt;
    int n_own = (wlike || (k_rd && r_u))
                    ? node
                    : (k_evs && r_s && evs_cnt == 1) ? -1 : r_own;
    int n_mem = ((k_rd || k_wr) && r_em) ? own_val : (k_evm ? sval : r_mem);
    if (rel) {
      n_state = wlike ? D_U : (r_em ? D_EM : r_state);
      n_cnt = wlike ? 0 : (r_em ? 1 : r_cnt);
      n_own = r_own;
      n_mem = wlike ? relv : (r_em ? own_val : r_mem);
    }
    // wave-stamp act composition
    const bool plain_rd = k_rd && !rel;
    const int my_h =
        wlike ? ACT_KILL
              : (k_rd && r_em && tgt_home)
                    ? (rel ? ACT_PROMOTE : ACT_DOWN)
                    : ((k_evs && r_s && evs_cnt == 1) ? ACT_PROMOTE
                                                      : ACT_NONE);
    const int act_h =
        prev_ah == ACT_PROMOTE
            ? (wlike ? ACT_KILL
                     : (k_rd && rel) ? ACT_PROMOTE
                                     : (k_rd ? ACT_DOWN : ACT_NONE))
            : (prev_ah > my_h ? prev_ah : my_h);
    const int n_kw = wlike ? stamp : prev_kw;
    const int n_dw = (plain_rd && r_em && !tgt_home) ? stamp : prev_dw;
    const bool promo_set = (k_evs && r_s && evs_cnt == 1) ||
                           (k_rd && rel && r_em && !tgt_home);
    const bool promo_clr = wlike || k_evs || k_evm || (plain_rd && r_em);
    const bool n_promo = promo_set || (!promo_clr && prev_promo);
    const int n_act = (int)(rtag | ((uint32_t)act_h << 9) |
                            ((uint32_t)n_promo << 8) |
                            ((uint32_t)n_kw << 4) | (uint32_t)n_dw);
    const int rv_new = (wlike && !rel)
                           ? (0x100 | (sval & 0xFF))
                           : (((k_rd && r_u && !rel) || (k_rd && rel && r_em))
                                  ? 0x200
                                  : 0);
    row[DM_STATE] = n_state;
    row[DM_COUNT] = n_cnt;
    row[DM_OWNER] = n_own;
    row[DM_MEM] = n_mem;
    row[DM_ACT] = n_act;
    row[DM_REQ] = node | (rv_new << 16);
    row[DM_CLAIM] = kq;

    // reply patches on the requester's cache, applied in P6 in slot order
    const bool fill_e = k_rd && r_u;
    const int fill_val = wlike ? sval : (r_em ? own_val : r_mem);
    const bool patch = (k_rd || wlike) && !rel;
    if (patch) {
      patch_acc |= 1 << q;
      fillv[q] = fill_val;
    }
    if (fill_e) fille_acc |= 1 << q;
    if (is_req(kind) && !rel) aw[q] = stamp;
  }
  sc[R_PATCH * n + node] = patch_acc;
  sc[R_FILLE * n + node] = fille_acc;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    sc[(R_FILLV + q) * n + node] = fillv[q];
    sc[(R_AW + q) * n + node] = aw[q];
  }
}

// P6: reply patches, fan-out, outputs
__device__ __forceinline__ void phase_finish(const RoundArgs& a,
                                             const Keys& k, int node,
                                             const int* sc) {
  const int n = a.n, E = n * S;
  int ca[C], cv[C], cs[C], awl[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ca[c] = sc[(R_CA + c) * n + node];
    cv[c] = sc[(R_CVM + c) * n + node];
    cs[c] = sc[(R_CS + c) * n + node];
    awl[c] = 0;
  }
  const int lwh = sc[R_LWH * n + node];
  const int patch = sc[R_PATCH * n + node];
  const int fille = sc[R_FILLE * n + node];
  int won_any = 0;
#pragma unroll
  for (int j = 0; j < WAVES; ++j) won_any |= sc[(R_WON + j) * n + node];
  int conflicts = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int kind = sc[(R_KIND + q) * n + node];
    conflicts += (int)((is_req(kind) || is_ev(kind)) && !bit(won_any, q));
    const int rci = (clip(sc[(R_ENT + q) * n + node], 0, E - 1) & (S - 1)) % C;
    const int fv = sc[(R_FILLV + q) * n + node];
    const int aw = sc[(R_AW + q) * n + node];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // lwh: a write HIT followed the line's last fill, so the fold's
      // value is newest; no patch may touch it
      const bool oh = rci == c && bit(patch, q) && !bit(lwh, c);
      if (oh && bit(fille, q)) cs[c] = EXC;
      if (oh) cv[c] = fv;
      if (rci == c && aw > 0) awl[c] = aw;
    }
  }
  // fan-out: the line's entry word, fresh when stamped this round (the
  // words of every line gathered before the first DM_OWNER store, which
  // touches no DM_ACT or DM_REQ word)
  int line_act[C], line_req[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int line_e = clip(ca[c], 0, E - 1);
    line_act[c] = a.dm_out[line_e * DM_COLS + DM_ACT];
    line_req[c] = a.dm_out[line_e * DM_COLS + DM_REQ];
  }
  const int* cnt = sc + R_CNT * n + node;   // n_ret rh wh rd wr up ev
  const int d7[7] = {cnt[0], cnt[n], cnt[2 * n], cnt[3 * n], cnt[4 * n],
                     cnt[5 * n], cnt[6 * n]};
  int kills = 0, promos = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int line_e = clip(ca[c], 0, E - 1);
    const int act = line_act[c];
    const int req = line_req[c];
    const bool fan_fresh = (act >> 11) == k.round;
    const int line_f =
        (fan_fresh ? ((act & 0x7FF) | 0x800) << 16 : 0) | (req & 0xFFFF);
    const bool fresh = ((line_f >> 27) & 1) == 1;
    const int l_ah = fresh ? (line_f >> 25) & 3 : ACT_NONE;
    const bool l_promo = fresh && ((line_f >> 24) & 1) == 1;
    const int l_kw = fresh ? (line_f >> 20) & 15 : 0;
    const int l_dw = fresh ? (line_f >> 16) & 15 : 0;
    const int l_req = line_f & 0xFFFF;
    const bool i_am_home = (line_e >> BB) == node;
    const bool valid = cs[c] != INV;
    const bool not_self = l_req != node;
    const bool kill =
        valid && (i_am_home ? l_ah == ACT_KILL : awl[c] < l_kw);
    const bool promo =
        valid && !kill &&
        (i_am_home ? l_ah == ACT_PROMOTE : (l_promo && not_self));
    const bool down = valid && !kill && !promo &&
                      (i_am_home ? l_ah == ACT_DOWN : awl[c] < l_dw);
    cs[c] = kill ? INV : (promo ? EXC : (down ? SHD : cs[c]));
    if (promo) a.dm_out[line_e * DM_COLS + DM_OWNER] = node;
    kills += (int)kill;
    promos += (int)promo;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    a.cache_out[c * n + node] = ca[c];
    a.cache_out[(C + c) * n + node] = cv[c];
    a.cache_out[(2 * C + c) * n + node] = cs[c];
  }
  a.nret[node] = d7[0];
  const int d[10] = {d7[0], d7[1], d7[2], d7[3], d7[4], d7[5], conflicts,
                     d7[6], kills, promos};
#pragma unroll
  for (int i = 0; i < 10; ++i) a.delta[i * n + node] = d[i];
}

__global__ void __launch_bounds__(BLOCK) deep_round_kernel(RoundArgs a) {
  extern __shared__ int smem[];
  cg::grid_group grid = cg::this_grid();
  const int n = a.n, E = n * S;
  const int first = blockIdx.x * BLOCK + threadIdx.x;
  const int stride = gridDim.x * BLOCK;
  int* sc = a.scratch;
  int* claim = sc + R_ROWS * n;
  int* flags = claim + E;
  int* lanes = flags + E;
  const Keys k = make_keys(a);

  constexpr int EB = 16;   // claim words in flight a thread
  for (int e0 = first; e0 < E; e0 += EB * stride) {
    int w[EB];
#pragma unroll
    for (int u = 0; u < EB; ++u)
      if (e0 + u * stride < E) w[u] = ld(a.dm + (e0 + u * stride) * DM_COLS + DM_CLAIM);
#pragma unroll
    for (int u = 0; u < EB; ++u) {
      const int e = e0 + u * stride;
      if (e < E) {
        claim[e] = w[u];
#pragma unroll
        for (int j = 0; j < WAVES - 1; ++j) lanes[j * E + e] = I32_MAX;
      }
    }
  }
  // the block-wide phases walk the nodes a block at a time; thread ln of
  // the block runs node base + ln, as `first` does in the per-node loops
  grid.sync();
  for (int base = first - threadIdx.x; base < n; base += stride)
    phase_pre(a, k, base, smem, sc, claim);
  grid.sync();
  for (int base = first - threadIdx.x; base < n; base += stride)
    phase_flags(a, k, base, smem, sc, claim, flags);
  grid.sync();
  for (int node = first; node < n; node += stride)
    phase_wave<0>(a, k, node, sc, claim, flags, lanes);
#define DR_WAVE(J)                                              \
  if (J < WAVES) {                                              \
    grid.sync();                                                \
    for (int node = first; node < n; node += stride)            \
      phase_wave<(J < WAVES ? J : 0)>(a, k, node, sc, claim,    \
                                      flags, lanes);            \
  }
  DR_WAVE(1) DR_WAVE(2) DR_WAVE(3) DR_WAVE(4) DR_WAVE(5) DR_WAVE(6)
  DR_WAVE(7) DR_WAVE(8) DR_WAVE(9) DR_WAVE(10) DR_WAVE(11) DR_WAVE(12)
  DR_WAVE(13)
#undef DR_WAVE
  // the same thread ran the node's last wave: no barrier needed
  for (int base = first - threadIdx.x; base < n; base += stride)
    phase_replay(a, k, base, smem, sc, claim, flags);
  grid.sync();
  for (int node = first; node < n; node += stride)
    phase_merge(a, node, sc);
#define DR_COMPOSE(J)                                           \
  if (J < WAVES) {                                              \
    grid.sync();                                                \
    for (int node = first; node < n; node += stride)            \
      phase_compose<(J < WAVES ? J : 0)>(a, k, node, sc);       \
  }
  DR_COMPOSE(0) DR_COMPOSE(1) DR_COMPOSE(2) DR_COMPOSE(3) DR_COMPOSE(4)
  DR_COMPOSE(5) DR_COMPOSE(6) DR_COMPOSE(7) DR_COMPOSE(8) DR_COMPOSE(9)
  DR_COMPOSE(10) DR_COMPOSE(11) DR_COMPOSE(12) DR_COMPOSE(13)
#undef DR_COMPOSE
  grid.sync();
  for (int node = first; node < n; node += stride)
    phase_finish(a, k, node, sc);
}

// Blocks of the launch for n nodes: one node a thread while the nodes
// fit the blocks that can be resident at once (with the kernel's
// dynamic shared memory), else all of those.
int grid_for(int n, int* grid) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && SMEM_BYTES > 48 * 1024)
    e = cudaFuncSetAttribute(deep_round_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, deep_round_kernel, BLOCK, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int want = (n + BLOCK - 1) / BLOCK;
  *grid = want < per_sm * sms ? want : per_sm * sms;
  return 0;
}

}  // namespace

// Plain C entry points (bound with ctypes).
extern "C" {

// int32 elements of the scratch buffer the kernel needs for n nodes
long long deep_round_scratch_ints(int n) {
  return (long long)R_ROWS * n + (long long)E_PLANES * n * S;
}

// dynamic shared memory of a block of the kernel, in bytes
int deep_round_smem_bytes() { return SMEM_BYTES; }

// window steps an iteration of the folds' W loops
int deep_round_window_unroll() { return W_UNROLL; }

// the grid the launch for n nodes uses (>= 1), or -(CUDA error)
int deep_round_grid(int n) {
  int grid = 0;
  const int err = grid_for(n > 0 ? n : 1, &grid);
  return err ? -err : grid;
}

// One round, launched cooperatively on `stream` without synchronising;
// returns the launch's CUDA error (0 on success).
int deep_round(const int* params, const int* dm, const int* ca,
               const int* cv, const int* cs, const int* woa,
               const int* wval, const int* wlive, const int* hor,
               int* dm_out, int* cache_out, int* nret, int* delta,
               int* scratch, int n, int prio_bits, int cmr, void* stream) {
  if (n <= 0) return 0;
  int grid = 0;
  const int err = grid_for(n, &grid);
  if (err) return err;
  RoundArgs a = {params, dm, ca, cv, cs, woa, wval, wlive, hor,
                 dm_out, cache_out, nret, delta, scratch,
                 n, prio_bits, cmr};
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)deep_round_kernel, dim3(grid), dim3(BLOCK), args,
      SMEM_BYTES, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
