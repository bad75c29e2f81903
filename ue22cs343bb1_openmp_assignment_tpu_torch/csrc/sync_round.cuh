// Device code shared by the two cooperative round kernels of the sync
// engine: csrc/sync_round.cu (txn_width 1) and csrc/sync_multi_round.cu
// (txn_width >= 2). Both take the state of R machines as the engine
// holds it (cache planes [R, n, C], dm [R, E, 7], idx and instr_count
// [R, n], round and seed [R], the counters [R, 11]; one machine is
// R = 1) to the next round's state in one launch; what they share is
// everything outside their node-local folds:
//
// - the operands (Args) and one replica's view of them (replica): each
//   pointer moved to that replica's part, so that a phase reads and
//   writes one machine's tensors exactly as it did before the replica
//   axis;
// - how the grid's blocks share the replicas (Team): the grid is 2-D,
//   gridDim.x blocks serve one replica's nodes and gridDim.y replicas
//   run at once; block row y serves replicas y, y + gridDim.y, ...,
//   which is one replica whenever the grid holds them all (the sizes the
//   card runs);
// - the claim key of ops/sync_engine._round_key_rs in uint32 arithmetic
//   (Keys, make_keys), on the replica's own round and seed, read before
//   the first barrier for the block's first replica (RoundKeys);
// - JAX's clipped gathers (clip) and a node's row of an [n, C] plane in
//   16-byte words (load_row, store_row);
// - P0, the copy of every replica's dm to dm_out over the whole grid
//   (copy_dm), and the counters' start (start_counters: rounds + 1,
//   round + 1, for each replica);
// - the fan-out of one valid line (fan_out_line: kill, downgrade or
//   promote, and DM_OWNER on a promotion);
// - the block's reduction of a replica's metric deltas in the last phase
//   (flush_counters: warp shuffles, then one integer atomicAdd a counter
//   and block);
// - the grid: blocks that can be resident at once, queried once a device
//   and cached, and its split over the replicas (grid_for).
//
// Replicas share no row of any tensor: a replica's view reaches only its
// own part, entries are clipped into its own [0, E), and so the race
// arguments that each kernel's header makes for one machine hold for
// each replica of the launch.
//
// The build defines SR_PB (the claim key's priority bits) and SR_CMR
// (sync_engine.claim_max_rounds), and the hash's constants
// (csrc/hash32.cuh). The cache-state codes live in sround::line, so that
// a kernel can bring this namespace in beside its fold's own.

#pragma once

#include <atomic>
#include <stdint.h>

#include <cuda_runtime.h>

#include "hash32.cuh"

#if !defined(SR_PB) || !defined(SR_CMR)
#error "the build defines SR_PB (prio bits) and SR_CMR (claim_max_rounds)"
#endif

namespace sround {

constexpr int PB = SR_PB;                  // prio bits
constexpr uint32_t PMASK = (1u << PB) - 1u;
constexpr int PSHIFT = PB / 2 > 1 ? PB / 2 : 1;
constexpr int CMR = SR_CMR;                // sync_engine.claim_max_rounds
static_assert(PB >= 1 && PB <= 30, "prio bits in [1, 30]");

constexpr int DM_STATE = 0, DM_COUNT = 1, DM_OWNER = 2, DM_MEM = 3,
              DM_ACT = 4, DM_REQ = 5, DM_CLAIM = 6, DM_COLS = 7;
constexpr int D_EM = 0, D_S = 1, D_U = 2;  // DirState
constexpr int ACT_NONE = 0, ACT_KILL = 1, ACT_DOWNGRADE = 2,
              ACT_PROMOTE = 3;
constexpr int N_METRICS = 11;              // sync_engine.METRIC_FIELDS
// metric deltas, in METRIC_FIELDS order after `rounds`
constexpr int M_RET = 0, M_RH = 1, M_WH = 2, M_RD = 3, M_WR = 4, M_UP = 5,
              M_CONF = 6, M_EV = 7, M_KILL = 8, M_PROMO = 9, N_DELTAS = 10;

namespace line {                           // CacheState
constexpr int MOD = 0, EXC = 1, SHD = 2, INV = 3;
}

// The round's claim keys (sync_engine._round_key_rs): a countdown in the
// high bits, a reseeded bijective node-priority permutation in the low.
struct Keys {
  uint32_t h;
  uint32_t countdown;  // max(claim_max_rounds - round, 0)

  __device__ __forceinline__ int key(int node) const {
    uint32_t x = (uint32_t)node;
    x = (x * ((h << 1) | 1u) + (h >> 7)) & PMASK;
    x ^= x >> PSHIFT;
    x = (x * 0x9E3779B9u) & PMASK;
    return (int)((countdown << PB) | x);
  }
};

__device__ __forceinline__ Keys make_keys(int round, int seed) {
  Keys k;
  k.h = hash32::mix32(((uint32_t)round * 0x9E3779B9u) ^
                      ((uint32_t)seed * 0x85EBCA77u));
  const int d = (int)((uint32_t)CMR - (uint32_t)round);
  k.countdown = d > 0 ? (uint32_t)d : 0u;
  return k;
}

// A replica's round and claim keys (its round and seed words of [R]).
// A kernel reads its block's first replica's at the start, before the
// dm copy, so that no phase waits on those loads after a barrier.
struct RoundKeys {
  int round;
  Keys k;
};

__device__ __forceinline__ RoundKeys round_keys(const int* round,
                                                const int* seed, int r) {
  const int rd = __ldg(round + r);
  return {rd, make_keys(rd, __ldg(seed + r))};
}

__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A node's C words of an [n, C] plane: 16-byte accesses when C is a
// multiple of 4 (the wrappers check that the planes are 16-byte
// aligned). RO: the plane is an input, never written while the kernel
// runs, and read through the read-only path.
template <bool RO, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (RO) return __ldg(p);
  else return *p;
}

template <bool RO, int C>
__device__ __forceinline__ void load_row(const int* plane, int node,
                                         int (&r)[C]) {
  const int* p = plane + (size_t)node * C;
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int j = 0; j < C / 4; ++j) {
      const int4 v = ld<RO>(reinterpret_cast<const int4*>(p) + j);
      r[4 * j] = v.x;
      r[4 * j + 1] = v.y;
      r[4 * j + 2] = v.z;
      r[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = ld<RO>(p + c);
  }
}

template <int C>
__device__ __forceinline__ void store_row(int* plane, int node,
                                          const int (&r)[C]) {
  int* p = plane + (size_t)node * C;
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int j = 0; j < C / 4; ++j)
      reinterpret_cast<int4*>(p)[j] =
          make_int4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = r[c];
  }
}

// The operands of one launch, for `reps` machines of `n` nodes each, in
// replica-major order (replica r's part of a [R, ...] tensor starts at
// r times the size of one machine's).
struct Args {
  const int* ca;       // [R, n, C] round-start cache
  const int* cv;
  const int* cs;
  const int* dm;       // [R, E, 7]
  const int* idx;      // [R, n]
  const int* cnt;      // [R, n] trace length
  const int* round;    // [R]
  const int* seed;     // [R]
  const int* metrics;  // [R, 11]
  int* ca_o;           // [R, n, C]
  int* cv_o;
  int* cs_o;
  int* dm_o;           // [R, E, 7]
  int* idx_o;          // [R, n]
  int* round_o;        // [R]
  int* metrics_o;      // [R, 11]
  int* scratch;        // [R, ROWS, n]
  int n;               // nodes a replica
  int reps;            // replicas
};

// Replica r's view of `a`: every pointer at r's part (C cache lines a
// node, E directory rows and ROWS scratch rows a replica).
template <int C, int ROWS>
__device__ __forceinline__ Args replica(const Args& a, int r, int E) {
  const size_t cell = (size_t)r * a.n;
  const size_t rows = (size_t)r * E * DM_COLS;
  Args v = a;
  v.ca = a.ca + cell * C;
  v.cv = a.cv + cell * C;
  v.cs = a.cs + cell * C;
  v.dm = a.dm + rows;
  v.idx = a.idx + cell;
  v.cnt = a.cnt + cell;
  v.round = a.round + r;
  v.seed = a.seed + r;
  v.metrics = a.metrics + (size_t)r * N_METRICS;
  v.ca_o = a.ca_o + cell * C;
  v.cv_o = a.cv_o + cell * C;
  v.cs_o = a.cs_o + cell * C;
  v.dm_o = a.dm_o + rows;
  v.idx_o = a.idx_o + cell;
  v.round_o = a.round_o + r;
  v.metrics_o = a.metrics_o + (size_t)r * N_METRICS;
  v.scratch = a.scratch + cell * ROWS;
  return v;
}

// This thread's share of the replicas: its block row serves replicas
// group, group + groups, ... (one replica when groups == reps), and in
// each the nodes node0, node0 + nstride, ... From the launch's indices
// alone, so a phase takes it afresh at no cost.
struct Team {
  int group, groups, node0, nstride;
};

template <int BLOCK>
__device__ __forceinline__ Team team() {
  return {(int)blockIdx.y, (int)gridDim.y,
          (int)blockIdx.x * BLOCK + (int)threadIdx.x,
          (int)gridDim.x * BLOCK};
}

// The thread's index in the whole grid and the grid's threads, for the
// loops over every replica's words (copy_dm, start_counters).
template <int BLOCK>
__device__ __forceinline__ int grid_first() {
  return ((int)blockIdx.y * (int)gridDim.x + (int)blockIdx.x) * BLOCK +
         (int)threadIdx.x;
}

template <int BLOCK>
__device__ __forceinline__ int grid_threads() {
  return (int)(gridDim.x * gridDim.y) * BLOCK;
}

// P0: dm -> dm_out (`words` int32) over the whole grid, 16-byte words
// (the wrappers check the alignment), a batch of loads in flight before
// any store. `first` is the thread's index in the grid, `stride` the
// grid's threads.
__device__ __forceinline__ void copy_dm(const int* dm, int* dm_o,
                                        size_t words, int first,
                                        int stride) {
  const size_t nvec = words / 4;
  const int4* src = reinterpret_cast<const int4*>(dm);
  int4* dst = reinterpret_cast<int4*>(dm_o);
  constexpr int VB = 8;   // 16-byte loads in flight a thread
#pragma unroll 1
  for (size_t v0 = first; v0 < nvec; v0 += (size_t)VB * stride) {
    int4 w[VB];
#pragma unroll
    for (int u = 0; u < VB; ++u) {
      const size_t v = v0 + (size_t)u * stride;
      if (v < nvec) w[u] = __ldg(src + v);
    }
#pragma unroll
    for (int u = 0; u < VB; ++u) {
      const size_t v = v0 + (size_t)u * stride;
      if (v < nvec) dst[v] = w[u];
    }
  }
#pragma unroll 1
  for (size_t j = 4 * nvec + first; j < words; j += stride)
    dm_o[j] = __ldg(dm + j);
}

// P0's other half, over the grid: every replica's counters with
// rounds + 1, and its round + 1.
__device__ __forceinline__ void start_counters(const Args& a, int first,
                                               int stride) {
#pragma unroll 1
  for (int i = first; i < a.reps * N_METRICS; i += stride)
    a.metrics_o[i] = (int)((uint32_t)__ldg(a.metrics + i) +
                           (i % N_METRICS == 0 ? 1u : 0u));
#pragma unroll 1
  for (int r = first; r < a.reps; r += stride)
    a.round_o[r] = (int)((uint32_t)__ldg(a.round + r) + 1u);
}

// The fan-out for one line of `node` (tag `tag`, state `state`): a valid
// line reads DM_ACT and DM_REQ at its tag's entry and, where this
// round's action there is another node's, is killed, downgraded or
// promoted; a promoted line writes its node as the entry's DM_OWNER.
__device__ __forceinline__ void fan_out_line(int* dm_o, int E, int round,
                                             int node, int tag, int& state,
                                             int (&acc)[N_DELTAS]) {
  if (state == line::INV) return;
  int* row = dm_o + (size_t)clip(tag, 0, E - 1) * DM_COLS;
  const int act = row[DM_ACT];
  if (row[DM_REQ] == node || (act >> 2) != round) return;
  const int code = act & 3;
  if (code == ACT_KILL) {
    state = line::INV;
    acc[M_KILL] += 1;
  } else if (code == ACT_DOWNGRADE) {
    state = line::SHD;
  } else if (code == ACT_PROMOTE) {
    state = line::EXC;
    acc[M_PROMO] += 1;
    row[DM_OWNER] = node;
  }
}

// The block's metric deltas of one replica onto its metrics_o[1..10]:
// warp sums, then one atomicAdd a counter (integer and order-free, so
// the result is deterministic). Every thread of the block calls it, in
// the last phase, once for each replica the block serves; the leading
// barrier lets it run again for the block's next replica.
template <int BLOCK>
__device__ __forceinline__ void flush_counters(const int (&acc)[N_DELTAS],
                                               int* metrics_o) {
  constexpr int WARPS = BLOCK / 32;
  static_assert(BLOCK % 32 == 0, "whole warps");
  __shared__ int part[WARPS][N_DELTAS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N_DELTAS; ++j) {
    int v = acc[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    if (lane == 0) part[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < N_DELTAS) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[w][threadIdx.x];
    if (s != 0) atomicAdd(metrics_o + 1 + threadIdx.x, s);
  }
}

// The cooperative grid of one kernel: blocks of BLOCK threads, at most
// MAX_PER_SM resident blocks an SM (each grid barrier waits for every
// block to arrive, so larger machines loop over their nodes rather than
// add blocks), SMEM bytes of dynamic shared memory a block. The number
// of blocks that can be resident at once is queried once a device and
// then cached: the grid does not change between rounds.
template <int BLOCK, int MAX_PER_SM, size_t SMEM>
struct Grid {
  static constexpr int MAX_DEVICES = 64;
  std::atomic<int> resident_cache[MAX_DEVICES];  // 0 until asked

  template <class F>
  int resident_blocks(F* kernel, int* out) {
    int dev = 0, sms = 0, coop = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const bool cached = dev >= 0 && dev < MAX_DEVICES;
    if (cached) {
      const int r = resident_cache[dev].load(std::memory_order_relaxed);
      if (r > 0) {
        *out = r;
        return 0;
      }
    }
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        BLOCK, SMEM);
    if (e != cudaSuccess) return (int)e;
    if (!coop) return (int)cudaErrorNotSupported;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    if (per_sm > MAX_PER_SM) per_sm = MAX_PER_SM;
    *out = per_sm * sms;
    if (cached) resident_cache[dev].store(*out, std::memory_order_relaxed);
    return 0;
  }

  // The grid of the launch for reps replicas of n nodes: grid->x blocks
  // a replica, grid->y replicas at once. One node a thread while every
  // replica's nodes fit the blocks that can be resident at once; else
  // the resident blocks split evenly over the replicas (a thread loops
  // over its nodes); past one block a replica, each block row loops over
  // replicas too. At reps 1 this is the grid of one machine.
  template <class F>
  int grid_for(F* kernel, int reps, int n, dim3* grid) {
    int resident = 0;
    const int err = resident_blocks(kernel, &resident);
    if (err) return err;
    const long long want = (n + BLOCK - 1) / BLOCK;
    long long per = want;
    if ((long long)reps * want > resident)
      per = resident / reps < 1 ? 1 : resident / reps;
    const long long fit = resident / per;
    *grid = dim3((unsigned)per, (unsigned)(fit < reps ? fit : reps));
    return 0;
  }
};

}  // namespace sround
