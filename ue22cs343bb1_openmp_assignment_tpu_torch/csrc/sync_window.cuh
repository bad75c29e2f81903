// The multi-transaction window fold for one node, one step at a time, as
// __device__ code shared by the two kernels of csrc/sync_window.cu and
// the fused txn_width >= 2 round (csrc/sync_multi_round.cu).
//
// The body is ops/sync_engine.window_fold (JAX ops/pallas_window.py:_fold)
// written out for a single node: per step the instruction comes from the
// procedural hash, is classified against the fold's running cache, and is
// admitted as a hit, as the node's next transaction (ordinal n_txn), or
// stops the window. ops/sync_engine.window_fold is its plain version and
// the parity reference.
//
// Where it departs from the TPU kernel's shape:
// - No step list. The TPU fold keeps W step records and packs the
//   transactions by ordinal afterwards with W x K select chains. A step's
//   ordinal is n_txn at the step that admits it, so the callers store or
//   read slot `ordn` right at that step.
// - K-entry tables. The TPU fold's fill and victim lists grow to W
//   entries, but an entry that admitted no transaction changes nothing,
//   and the admitted ones are exactly ordinals 0..n_txn-1 in step order.
//   Tables indexed by ordinal and scanned in increasing order give the
//   same own1, dup, rel_ord and acq_base.
// - The carry (5 values a line, 2 a table entry, two masks) stays in
//   registers: C and K are compile-time constants, the loops over them
//   are unrolled and dynamic indices are select chains.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash32.cuh"

#if !defined(SW_C) || !defined(SW_K) || !defined(SW_W)
#error "the build defines SW_C, SW_K, SW_W (and the hash's constants)"
#endif

namespace swin {

constexpr int C = SW_C;   // cache lines per node
constexpr int K = SW_K;   // transactions per node per round (txn_width)
constexpr int W = SW_W;   // window steps (drain_depth + txn_width)
constexpr int S_MASK = (1 << SW_BLOCK_BITS) - 1;
static_assert(K >= 2 && K <= 32, "victim tables are 32-bit masks");
static_assert(W >= K, "the window holds at least K steps");

constexpr int MOD = 0, EXC = 1, SHD = 2, INV = 3;      // CacheState
constexpr int OP_READ = 0, OP_WRITE = 1, OP_NOP = 2;   // Op

// One step's record (the fields of window_fold's step dict that a kernel
// uses). ordn, dep, rel_ord and acq_base are K where there is none.
struct Step {
  bool hit_ok, rd_hit, wr_hit, ok, victim, rd, wr, up, v_mod, hc;
  int dep, ordn, addr, val, ci, e1, e2, v_val, rel_ord, acq_base;
};

struct Fold {
  int ca[C], cv[C], cs[C];
  int fo[C];        // ordinal of the ambiguous read fill holding the line
  int cvp[C];       // cache values frozen at the first transaction
  int fe[K];        // fill entry of ordinal j (valid for j < n_txn)
  int ve[K];        // victim entry of ordinal j
  uint32_t vvalid;  // ordinal j displaced a line
  uint32_t velig;   // ... that the node may reacquire (M/E, first touch)
  bool frozen, stopped;
  int n_txn;

  // The fold from the round-start lines of `node` in [C, n] planes.
  __device__ __forceinline__ void init(const int* ca0, const int* cv0,
                                       const int* cs0, int n, int node) {
    int a[C], v[C], s[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      a[c] = ca0[c * n + node];
      v[c] = cv0[c * n + node];
      s[c] = cs0[c * n + node];
    }
    init_lines(a, v, s);
  }

  // The fold from a node's round-start lines, already in registers.
  __device__ __forceinline__ void init_lines(const int (&a)[C],
                                             const int (&v)[C],
                                             const int (&s)[C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ca[c] = a[c];
      cv[c] = v[c];
      cs[c] = s[c];
      fo[c] = K;
      cvp[c] = cv[c];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) fe[j] = ve[j] = 0;
    vvalid = velig = 0;
    frozen = stopped = false;
    n_txn = 0;
  }

  // Step k of `node` (cursor idx, trace length cnt, machine of n nodes,
  // E = n << block_bits directory rows).
  __device__ __forceinline__ Step step(int node, int idx, int cnt, int n,
                                       int E, int k) {
    Step s;
    const int w_idx = (int)((uint32_t)idx + (uint32_t)k);
    const bool live = w_idx < cnt;
    int oa;
    hash32::procedural_instr(node, w_idx, n, oa, s.val);
    const int op = oa >> 28;
    const int addr = oa & 0x0FFFFFFF;
    const int ci = (addr & S_MASK) % C;
    int l_addr = ca[0], l_val = cv[0], l_state = cs[0], l_fo = fo[0];
#pragma unroll
    for (int c = 1; c < C; ++c) {
      const bool m = ci == c;
      l_addr = m ? ca[c] : l_addr;
      l_val = m ? cv[c] : l_val;
      l_state = m ? cs[c] : l_state;
      l_fo = m ? fo[c] : l_fo;
    }
    const bool tag_ok = l_addr == addr && l_state != INV;
    const bool is_rd = op == OP_READ, is_wr = op == OP_WRITE;
    const bool rd_hit = live && is_rd && tag_ok;
    const bool wr_hit =
        live && is_wr && tag_ok && (l_state == MOD || l_state == EXC);
    // a write on an own window read fill (tentatively SHARED): a
    // tentative hit, resolved after the claim
    const bool wr_dep = live && is_wr && tag_ok && l_state == SHD && l_fo < K;
    const bool hit = rd_hit || wr_hit || wr_dep || (live && op == OP_NOP);
    const bool upg = live && is_wr && tag_ok && l_state == SHD && l_fo == K;
    const bool rd_miss = live && is_rd && !tag_ok;
    const bool wr_miss = live && is_wr && !tag_ok;
    const int e1 = addr < 0 ? 0 : (addr > E - 1 ? E - 1 : addr);
    const bool has_victim = !tag_ok && l_state != INV && l_addr != addr;
    const int e2 = l_addr < 0 ? 0 : (l_addr > E - 1 ? E - 1 : l_addr);

    bool own1 = false;   // e1 already filled by this node's window
    int rel_ord = K;     // own fill being displaced
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool tv = j < n_txn;
      own1 = own1 || (tv && fe[j] == e1);
      rel_ord = (tv && has_victim && fe[j] == e2) ? j : rel_ord;
    }
    bool dup = own1;     // e1 re-touches a window entry
    int acq_base = K;    // reacquire after an own M/E evict
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool m = ((vvalid >> j) & 1u) != 0 && ve[j] == e1;
      const bool elig = ((velig >> j) & 1u) != 0;
      dup = dup || (m && !elig);
      acq_base = (m && elig) ? j : acq_base;
    }
    const bool hc = hit && !stopped && frozen && !own1;
    const bool hit_ok = (hit && !stopped && (!frozen || own1)) || hc;
    const bool txn = (rd_miss || wr_miss || upg) && !stopped;
    const bool ok = txn && !dup && n_txn < K;
    rel_ord = ok ? rel_ord : K;
    acq_base = ok ? acq_base : K;
    const bool stop_now = !hit_ok && !ok && !stopped;
    const bool wlike = ok && (wr_miss || upg);
    const bool ambig_rd = ok && rd_miss && acq_base == K;
    const bool wr_eff = (wr_hit || wr_dep) && hit_ok;
    const int fill_cs = wlike ? MOD : (acq_base < K ? EXC : SHD);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool mc = ci == c;
      // hit-write effects, then the prefix cache (frozen at the node's
      // first transaction, before that transaction's fill), then the fill
      cv[c] = (wr_eff && mc) ? s.val : cv[c];
      cs[c] = (wr_eff && mc) ? MOD : cs[c];
      cvp[c] = frozen ? cvp[c] : cv[c];
      ca[c] = (ok && mc) ? addr : ca[c];
      cv[c] = (wlike && mc) ? s.val : cv[c];
      cs[c] = (ok && mc) ? fill_cs : cs[c];
      fo[c] = (ok && mc) ? (ambig_rd ? n_txn : K) : fo[c];
    }
    frozen = frozen || ok;

    s.hit_ok = hit_ok;
    s.rd_hit = rd_hit && hit_ok;
    s.wr_hit = wr_eff;
    s.dep = (wr_dep && hit_ok) ? l_fo : K;
    s.ok = ok;
    s.ordn = ok ? n_txn : K;
    s.addr = addr;
    s.ci = ci;
    s.e1 = e1;
    s.e2 = e2;
    s.victim = ok && has_victim;
    s.rd = ok && rd_miss;
    s.wr = ok && wr_miss;
    s.up = ok && upg;
    s.v_val = l_val;
    s.v_mod = l_state == MOD;
    s.rel_ord = rel_ord;
    s.acq_base = acq_base;
    s.hc = hc;

    const bool elig_new = (l_state == MOD || l_state == EXC) && rel_ord == K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool at = ok && j == n_txn;
      fe[j] = at ? e1 : fe[j];
      ve[j] = at ? e2 : ve[j];
      vvalid |= (at && has_victim) ? (1u << j) : 0u;
      velig |= (at && has_victim && elig_new) ? (1u << j) : 0u;
    }
    n_txn += ok ? 1 : 0;
    stopped = stopped || stop_now;
    return s;
  }
};

}  // namespace swin
