// Window and replay kernels of the multi-transaction round for Hopper
// (sm_90a): one thread per node.
//
// Replace the two Pallas TPU kernels of the JAX package's
// ops/pallas_window.py:
//   _window_kernel (_call_window): the pre-claim fold of a node's W-step
//     window; emits the per-slot transaction records [13K, n] (the 12
//     _SLOT_FIELDS and the step position, K rows each, by transaction
//     ordinal), the per-step records [3W, n] (interior-hit probe flag,
//     dependent-write ordinal, step entry) and the prefix cache values
//     [C, n];
//   _replay_kernel (_call_replay): the same fold again with the claim's
//     verdicts (first_lose [n], fill_state and fill_val [K, n]), applying
//     the retired prefix to the round-start cache; emits the committed
//     cache [3C, n] (address, value, state) and n_ret, rh, wh [3, n].
// Both run the fold body of csrc/sync_window.cuh and compute each
// instruction by the procedural hash in registers (csrc/hash32.cuh).
// ops/sync_window_kernel.plain_window and plain_replay are the plain
// versions and the parity reference.
//
// The claim scatter-min, the row gather, the outcomes and the commit
// scatter between the two launches are plain tensor code
// (ops/sync_engine.multi_middle), as they are XLA ops in the JAX package.
//
// Outputs are fully written: the wrappers allocate with torch.empty, and a
// slot row of a node with no transaction of that ordinal is 0, as in the
// Pallas kernel, so the window kernel stores those zeros after its loop.
//
// Layout: every operand is an int32 [rows, n] plane (row r of node i at
// r * n + i), so loads and stores along the node axis coalesce across a
// warp.
//
// What bounds them on the H100: at N=4096, C=4, K=3, W=7 the window
// kernel moves 78 rows x 16 KiB = 1.28 MB and the replay 36 rows = 0.59
// MB (0.38 and 0.18 us at 3.35 TB/s), and each runs about 283 integer
// instructions a fold step (a hash with three 32-bit divisions, then
// select chains over C lines and K table entries): 0.49 us of the int32
// lanes for the window's 7 steps a node, 0.27 us for the steps a replay
// needs. Integer work bounds them before memory, and a launch's latency
// is above both: measured 0.0048 and 0.0047 ms a launch (NVIDIA H100
// 80GB HBM3, 700 W), 72 and 68 registers, no spills. The carry is small,
// so blocks of 32 threads spread 4096 nodes over 128 of the 132 SMs.

#include "sync_window.cuh"

namespace {

using namespace swin;

constexpr int BLOCK = 32;
// slot-record rows: K rows a field, in ops/sync_engine.SLOT_FIELDS order,
// then pos
enum SlotField {
  F_OK, F_E1, F_E2, F_VAL, F_VVAL, F_VICTIM, F_RD, F_WR, F_UP, F_VMOD,
  F_REL, F_ACQ, F_POS, N_SLOT
};

struct WindowArgs {
  const int* ca;     // [C, n] round-start cache
  const int* cv;
  const int* cs;
  const int* idx;    // [n] cursor
  const int* cnt;    // [n] trace length
  const int* fl;     // [n] first_lose (replay)
  const int* fs;     // [K, n] resolved fill states (replay)
  const int* fv;     // [K, n] resolved fill values (replay)
  int* out0;         // window: slots [13K, n]; replay: cache [3C, n]
  int* out1;         // window: steps [3W, n];  replay: counts [3, n]
  int* out2;         // window: prefix cache values [C, n]
  int n;
};

__global__ void __launch_bounds__(BLOCK) sync_window_kernel(WindowArgs a) {
  const int node = blockIdx.x * BLOCK + threadIdx.x;
  const int n = a.n;
  if (node >= n) return;
  const int E = (int)((uint32_t)n << SW_BLOCK_BITS);
  const int idx = a.idx[node], cnt = a.cnt[node];
  Fold f;
  f.init(a.ca, a.cv, a.cs, n, node);
  const auto slot = [&](int field, int j) -> int& {
    return a.out0[(field * K + j) * n + node];
  };
#pragma unroll 1
  for (int k = 0; k < W; ++k) {
    const Step s = f.step(node, idx, cnt, n, E, k);
    a.out1[k * n + node] = s.hc ? 1 : 0;
    a.out1[(W + k) * n + node] = s.dep;
    a.out1[(2 * W + k) * n + node] = s.e1;
    if (s.ok) {
      const int j = s.ordn;
      slot(F_OK, j) = 1;
      slot(F_E1, j) = s.e1;
      slot(F_E2, j) = s.e2;
      slot(F_VAL, j) = s.val;
      slot(F_VVAL, j) = s.v_val;
      slot(F_VICTIM, j) = s.victim ? 1 : 0;
      slot(F_RD, j) = s.rd ? 1 : 0;
      slot(F_WR, j) = s.wr ? 1 : 0;
      slot(F_UP, j) = s.up ? 1 : 0;
      slot(F_VMOD, j) = s.v_mod ? 1 : 0;
      slot(F_REL, j) = s.rel_ord;
      slot(F_ACQ, j) = s.acq_base;
      slot(F_POS, j) = k;
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j >= f.n_txn) {
#pragma unroll
      for (int field = 0; field < N_SLOT; ++field) slot(field, j) = 0;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) a.out2[c * n + node] = f.cvp[c];
}

__global__ void __launch_bounds__(BLOCK) sync_replay_kernel(WindowArgs a) {
  const int node = blockIdx.x * BLOCK + threadIdx.x;
  const int n = a.n;
  if (node >= n) return;
  const int E = (int)((uint32_t)n << SW_BLOCK_BITS);
  const int idx = a.idx[node], cnt = a.cnt[node];
  const int first_lose = a.fl[node];
  Fold f;
  f.init(a.ca, a.cv, a.cs, n, node);
  int ca_c[C], cv_c[C], cs_c[C];   // the committed cache
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ca_c[c] = f.ca[c];
    cv_c[c] = f.cv[c];
    cs_c[c] = f.cs[c];
  }
  int n_ret = 0, rh = 0, wh = 0;
#pragma unroll 1
  for (int k = 0; k < W; ++k) {
    const Step s = f.step(node, idx, cnt, n, E, k);
    const bool r = k < first_lose && (s.hit_ok || s.ok);
    n_ret += r ? 1 : 0;
    rh += (s.rd_hit && r) ? 1 : 0;
    wh += (s.wr_hit && r) ? 1 : 0;
    const bool fill = s.ok && r;
    int fs = 0, fv = 0;
    if (fill) {
      fs = a.fs[s.ordn * n + node];
      fv = a.fv[s.ordn * n + node];
    }
    const bool wm = s.wr_hit && r;
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
#pragma unroll
  for (int c = 0; c < C; ++c) {
    a.out0[c * n + node] = ca_c[c];
    a.out0[(C + c) * n + node] = cv_c[c];
    a.out0[(2 * C + c) * n + node] = cs_c[c];
  }
  a.out1[node] = n_ret;
  a.out1[n + node] = rh;
  a.out1[2 * n + node] = wh;
}

int grid_of(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" {

int sync_window(const int* ca, const int* cv, const int* cs, const int* idx,
                const int* cnt, int* slots, int* steps, int* cv_pre, int n,
                void* stream) {
  WindowArgs a{};
  a.ca = ca; a.cv = cv; a.cs = cs; a.idx = idx; a.cnt = cnt;
  a.out0 = slots; a.out1 = steps; a.out2 = cv_pre;
  a.n = n;
  if (n > 0)
    sync_window_kernel<<<grid_of(n), BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int sync_window_replay(const int* ca, const int* cv, const int* cs,
                       const int* idx, const int* cnt, const int* first_lose,
                       const int* fill_state, const int* fill_val, int* cache,
                       int* counts, int n, void* stream) {
  WindowArgs a{};
  a.ca = ca; a.cv = cv; a.cs = cs; a.idx = idx; a.cnt = cnt;
  a.fl = first_lose; a.fs = fill_state; a.fv = fill_val;
  a.out0 = cache; a.out1 = counts;
  a.n = n;
  if (n > 0)
    sync_replay_kernel<<<grid_of(n), BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
