// Burst phase of the single-transaction round for Hopper (sm_90a): one
// thread per node.
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas_burst.py:
// _kernel (launched by burst). For each node: the H+1 window slots from
// its cursor, each instruction computed by the procedural hash in
// registers and classified against the ROUND-START cache (within a burst
// only hits execute, and a hit never changes a line's tag or hit/miss
// class); d, the length of the leading all-hit prefix of the first H
// slots; the read- and write-hit counts of that prefix; its write effects
// on the cache values and states (the last write to a line wins, any
// write leaves MODIFIED); and slot d, the stopped instruction (the
// transaction candidate). ops/sync_burst_kernel.plain_burst is the plain
// version and the parity reference.
//
// The TPU kernel keeps H+1 per-slot lists and picks slot d with a select
// chain afterwards. Here one pass does it: slot d is the first slot that
// breaks the prefix (or slot H), so a thread records it when it meets it.
//
// Layout: every operand is an int32 [rows, n] plane (row r of node i at
// r * n + i), as in the Pallas kernel, so loads and stores along the node
// axis coalesce across a warp.
//
// What bounds it on the H100: at N=4096, C=4 it moves 28 rows x 16 KiB =
// 0.46 MB (0.14 us at 3.35 TB/s) and runs about 84 integer instructions
// a slot (the hash with two 32-bit divisions by 1000 and one by the node
// count, then the classification) for at most H+1 slots a node; a node
// needs only its d hits and the slot that stops it, 1.15 slots on
// average mid-run at locality 0.8, so bytes bound it before integer
// work. Both are far below a launch's latency: measured 0.0046 ms a
// launch (NVIDIA H100 80GB HBM3, 700 W), 46 registers, no spills. The
// carry is small (2C + a few registers), so blocks of 32 threads spread
// 4096 nodes over 128 of the 132 SMs.

#include <cuda_runtime.h>

#include "hash32.cuh"

#if !defined(SW_C) || !defined(SB_H)
#error "the build defines SW_C and SB_H (and the hash's constants)"
#endif

namespace {

constexpr int C = SW_C;              // cache lines per node
constexpr int H = SB_H;              // burst depth (cfg.drain_depth)
constexpr int S_MASK = (1 << SW_BLOCK_BITS) - 1;
constexpr int BLOCK = 32;
constexpr int MOD = 0, EXC = 1, INV = 3;   // CacheState
constexpr int OP_READ = 0, OP_WRITE = 1, OP_NOP = 2;

struct BurstArgs {
  const int* ca;    // [C, n] round-start cache
  const int* cv;
  const int* cs;
  const int* idx;   // [n] cursor
  const int* cnt;   // [n] trace length
  int* d;           // [n] burst length
  int* rh;          // [n] read hits in the burst
  int* wh;          // [n] write hits in the burst
  int* oa;          // [n] stopped instruction: op << 28 | addr
  int* val;         // [n] its value
  int* live;        // [n] it exists (cursor + d < trace length)
  int* cvo;         // [C, n] cache values after the burst
  int* cso;         // [C, n] cache states after the burst
  int n;
};

__global__ void __launch_bounds__(BLOCK) sync_burst_kernel(BurstArgs a) {
  const int node = blockIdx.x * BLOCK + threadIdx.x;
  const int n = a.n;
  if (node >= n) return;

  int ca[C], cs0[C], cv[C], cs[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ca[c] = a.ca[c * n + node];
    cs0[c] = a.cs[c * n + node];
    cv[c] = a.cv[c * n + node];
    cs[c] = cs0[c];
  }
  const int idx = a.idx[node], cnt = a.cnt[node];

  bool prefix = true;
  int d = 0, rh = 0, wh = 0;
  int oa_s = 0, val_s = 0, lv_s = 0;
#pragma unroll 1
  for (int k = 0; k <= H; ++k) {
    // int32 wrap-around of idx + k as in JAX
    const int w_idx = (int)((uint32_t)idx + (uint32_t)k);
    const bool live = w_idx < cnt;
    int oa, val;
    hash32::procedural_instr(node, w_idx, n, oa, val);
    const int op = oa >> 28, addr = oa & 0x0FFFFFFF;
    const int ci = (addr & S_MASK) % C;
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
    // slot H is only ever the transaction candidate
    const bool in_burst = prefix && k < H && hit;
    if (prefix && !in_burst) {           // slot d: the first to stop
      oa_s = oa;
      val_s = val;
      lv_s = live ? 1 : 0;
    }
    prefix = in_burst;
    d += in_burst ? 1 : 0;
    rh += (in_burst && rd_hit) ? 1 : 0;
    wh += (in_burst && wr_hit) ? 1 : 0;
    const bool wm = in_burst && wr_hit;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      cv[c] = (wm && ci == c) ? val : cv[c];
      cs[c] = (wm && ci == c) ? MOD : cs[c];
    }
  }

  a.d[node] = d;
  a.rh[node] = rh;
  a.wh[node] = wh;
  a.oa[node] = oa_s;
  a.val[node] = val_s;
  a.live[node] = lv_s;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    a.cvo[c * n + node] = cv[c];
    a.cso[c * n + node] = cs[c];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int sync_burst(const int* ca, const int* cv, const int* cs,
                          const int* idx, const int* cnt, int* d, int* rh,
                          int* wh, int* oa, int* val, int* live, int* cvo,
                          int* cso, int n, void* stream) {
  const BurstArgs a = {ca, cv, cs, idx, cnt, d,   rh,
                       wh, oa, val, live, cvo, cso, n};
  if (n > 0) {
    const int grid = (n + BLOCK - 1) / BLOCK;
    sync_burst_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
