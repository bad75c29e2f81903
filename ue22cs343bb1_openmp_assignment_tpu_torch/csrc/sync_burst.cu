// Burst phase of the single-transaction round for Hopper (sm_90a): one
// thread per node.
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas_burst.py:
// _kernel (launched by burst). For each node: the burst of hits from its
// cursor (the device function sburst::burst of csrc/sync_burst.cuh,
// which says what it computes), written out as d, the read- and
// write-hit counts, the stopped instruction (the transaction candidate)
// and the cache values and states after the burst's writes.
// ops/sync_burst_kernel.plain_burst is the plain version and the parity
// reference. The txn_width 1 round's main path runs the same burst
// inside the fused round kernel (csrc/sync_round.cu); this kernel stays
// the direct counterpart of the TPU kernel.
//
// Layout: every operand is an int32 [rows, n] plane (row r of node i at
// r * n + i), as in the Pallas kernel, so loads and stores along the node
// axis coalesce across a warp.
//
// What bounds it on the H100: at N=4096, C=4 it moves 28 rows x 16 KiB =
// 0.46 MB and, for the d + 1 slots a node needs (1.15 on average mid-run
// at locality 0.8), runs the hash (two 32-bit divisions by 1000 and one
// by the node count) and the classification, so bytes bound it before
// integer work (the SASS count a slot, the bound and the times: PERF.md,
// section 6). Both are far below a launch's latency: what it takes is
// one thread's dependent chain after the launch. The carry
// is small (2C + a few registers), so blocks of 32 threads spread 4096
// nodes over 128 of the 132 SMs.

#include <cuda_runtime.h>

#include "sync_burst.cuh"

namespace {

using namespace sburst;
constexpr int BLOCK = 32;

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
  const Burst b = burst(node, n, a.idx[node], a.cnt[node], ca, cs0, cv, cs);
  a.d[node] = b.d;
  a.rh[node] = b.rh;
  a.wh[node] = b.wh;
  a.oa[node] = b.oa;
  a.val[node] = b.val;
  a.live[node] = b.live ? 1 : 0;
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
