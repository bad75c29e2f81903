// The burst of the single-transaction round for one node, as a device
// function: shared by the burst kernel (csrc/sync_burst.cu) and the
// fused txn_width 1 round (csrc/sync_round.cu).
//
// For the node's H+1 window slots from its cursor, each instruction is
// computed by the procedural hash in registers and classified against
// the ROUND-START cache (within a burst only hits execute, and a hit
// never changes a line's tag or hit/miss class). The burst is the
// leading all-hit prefix of the first H slots: its length d, its read-
// and write-hit counts, and its write effects on the cache values and
// states (the last write to a line wins, any write leaves MODIFIED).
// Slot d is the stopped instruction, the transaction candidate. The
// TPU kernel computes all H+1 slots, keeps per-slot lists and picks slot
// d with a select chain afterwards; here the loop records slot d, the
// first slot that breaks the prefix (or slot H), and stops there: a node
// hashes d + 1 instructions, not H + 1.
// ops/sync_engine.burst_phase is the plain version.
//
// The build defines SW_C (lines a node), SB_H (cfg.drain_depth) and the
// hash's constants (csrc/hash32.cuh).

#pragma once

#include <stdint.h>

#include "hash32.cuh"

#if !defined(SW_C) || !defined(SB_H)
#error "the build defines SW_C and SB_H (and the hash's constants)"
#endif

namespace sburst {

constexpr int C = SW_C;              // cache lines per node
constexpr int H = SB_H;              // burst depth (cfg.drain_depth)
constexpr int S_MASK = (1 << SW_BLOCK_BITS) - 1;
constexpr int MOD = 0, EXC = 1, SHD = 2, INV = 3;   // CacheState
constexpr int OP_READ = 0, OP_WRITE = 1, OP_NOP = 2;

// codec.cache_index
__device__ __forceinline__ int cache_index(int addr) {
  return (addr & S_MASK) % C;
}

struct Burst {
  int d;      // burst length (<= H)
  int rh;     // read hits in the burst
  int wh;     // write hits in the burst
  int oa;     // stopped instruction: op << 28 | addr
  int val;    // its value
  bool live;  // it exists (cursor + d < trace length)
};

// The burst of `node` (of `n`) from cursor `idx` with `cnt` instructions
// in its trace, on its round-start cache lines (ca, cs0); cv and cs come
// in as the round-start values and states and leave as those after the
// burst's writes.
__device__ __forceinline__ Burst burst(int node, int n, int idx, int cnt,
                                       const int (&ca)[C],
                                       const int (&cs0)[C], int (&cv)[C],
                                       int (&cs)[C]) {
  Burst b = {0, 0, 0, 0, 0, false};
#pragma unroll 1
  for (int k = 0; k <= H; ++k) {
    // int32 wrap-around of idx + k as in JAX
    const int w_idx = (int)((uint32_t)idx + (uint32_t)k);
    const bool live = w_idx < cnt;
    int oa, val;
    hash32::procedural_instr(node, w_idx, n, oa, val);
    const int op = oa >> 28, addr = oa & 0x0FFFFFFF;
    const int ci = cache_index(addr);
    int l_addr = ca[0], l_state = cs0[0];
#pragma unroll
    for (int c = 1; c < C; ++c) {
      l_addr = ci == c ? ca[c] : l_addr;
      l_state = ci == c ? cs0[c] : l_state;
    }
    const bool tag_ok = l_addr == addr && l_state != INV;
    const bool rd_hit = live && op == OP_READ && tag_ok;
    const bool wr_hit = live && op == OP_WRITE && tag_ok &&
                        (l_state == MOD || l_state == EXC);
    const bool hit = rd_hit || wr_hit || (live && op == OP_NOP);
    // slot H is only ever the transaction candidate; the first slot
    // that is no burst hit is slot d, and the slots after it change
    // nothing, so the loop ends there
    if (k == H || !hit) {
      b.oa = oa;
      b.val = val;
      b.live = live;
      break;
    }
    b.d += 1;
    b.rh += rd_hit ? 1 : 0;
    b.wh += wr_hit ? 1 : 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      cv[c] = (wr_hit && ci == c) ? val : cv[c];
      cs[c] = (wr_hit && ci == c) ? MOD : cs[c];
    }
  }
  return b;
}

}  // namespace sburst
