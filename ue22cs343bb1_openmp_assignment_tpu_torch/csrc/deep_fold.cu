// Deep-window fold kernel for Hopper (sm_90a): one thread per node, the
// node's own-directory tables in shared memory.
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
// body is csrc/deep_fold.cuh (dfold::fold_node), shared with the fused
// round kernel (csrc/deep_round.cu); ops/deep_fold.py is its plain
// version and the parity reference.
//
// Layout: every input and output keeps the transposed [rows, N] int32
// layout of the Pallas kernels (row r of node i at r * n + i), so the
// round middle is unchanged and each thread's loads and stores along N
// coalesce across a warp. A thread copies its node's own-directory rows
// into its column of the block's tables (7 x S x 64 x 4 B = 28,672 B of
// dynamic shared memory a 64-thread block at S = 16) and touches no
// other column, so the kernel needs no barrier; the outputs are stored
// straight from the thread that owns the node.
//
// What bounds it on the H100: integer work. chip_smoke.py bounds each
// mode by the integer operations a node that this kernel issues
// (counted on its SASS), capped by the work recorded for the
// one-thread-per-node kernel this replaced, over the int32 rate; the
// bytes, 0.6 KB (pre) to 1.2 KB (replay) a node, take less. Its times
// against that bound and against the kernel it replaced, and the block
// size chosen among 32, 64 and 128 threads, are in PERF.md, section 6
// (an NVIDIA H100 80GB HBM3 at 700 W). What holds it back is the fold
// body's dependent chain (csrc/deep_fold.cuh).

#include "deep_fold.cuh"

namespace {

using namespace dfold;

constexpr int BLOCK = 64;
// the block's S-indexed tables
constexpr int SMEM_BYTES = N_TABLES * S * BLOCK * (int)sizeof(int);
static_assert(SMEM_BYTES <= 227 * 1024, "tables exceed a block's shared memory");

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

template <int MODE>
__global__ void __launch_bounds__(BLOCK) deep_fold_kernel(FoldArgs a) {
  extern __shared__ int smem[];
  const int node = blockIdx.x * BLOCK + threadIdx.x;
  const int n = a.n;
  if (node >= n) return;

  // a thread reads and writes only its own column of the tables
  const Tables<BLOCK> t = Tables<BLOCK>::of(smem, threadIdx.x);
  // all of the node's entries loaded before the first store, so that
  // the loads overlap
  int dir[S][5];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    dir[s][0] = ld(a.dms + s * n + node);
    dir[s][1] = ld(a.dmc + s * n + node);
    dir[s][2] = ld(a.dmo + s * n + node);
    dir[s][3] = ld(a.dmm + s * n + node);
    dir[s][4] = MODE != PRE ? ld(a.ocode + s * n + node) : 0;
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int c = 0; c < 4; ++c) t.put(T_DMS + c, s, dir[s][c]);
    if (MODE != PRE) t.put(T_OCODE, s, dir[s][4]);
  }
  int bad[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) bad[q] = MODE == REPLAY ? ld(a.bad + q * n + node) : 0;
  const FoldIn in = {a.ca, a.cv, a.cs, a.woa, a.wval, a.wlive, a.hor, n};
  FoldOut o;
  fold_node<BLOCK, MODE != PRE>(in, node, bad, t, o);

  const auto flag = [&](int s) {
    return (int)((o.mark >> s) & 1u) * F_MARK +
           (int)((o.poison >> s) & 1u) * F_POISON;
  };
  if (MODE == PRE) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      a.out0[q * n + node] = o.kind[q];
      a.out0[(Q + q) * n + node] = o.ent[q];
      a.out0[(2 * Q + q) * n + node] = o.sval[q];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) a.out1[s * n + node] = flag(s);
  } else if (MODE == FLAGS) {
#pragma unroll
    for (int s = 0; s < S; ++s) a.out0[s * n + node] = flag(s);
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      a.out0[i * n + node] = o.ca[i];
      a.out0[(C + i) * n + node] = o.cv[i];
      a.out0[(2 * C + i) * n + node] = o.cs[i];
      a.out0[(3 * C + i) * n + node] = o.cv_src[i];
      a.out0[(4 * C + i) * n + node] = o.cv_req[i];
      a.out0[(5 * C + i) * n + node] = o.cv_req_src[i];
      a.out0[(6 * C + i) * n + node] = (int)((o.lwh >> i) & 1u);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      a.out1[s * n + node] = t.get(T_DMS, s);
      a.out1[(S + s) * n + node] = t.get(T_DMC, s);
      a.out1[(2 * S + s) * n + node] = t.get(T_DMO, s);
      a.out1[(3 * S + s) * n + node] = t.get(T_DMM, s);
      a.out1[(4 * S + s) * n + node] = t.get(T_DMM_SRC, s);
      a.out1[(5 * S + s) * n + node] = (int)((o.touched >> s) & 1u);
      a.out1[(6 * S + s) * n + node] = t.get(T_ACT, s);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      a.out2[q * n + node] = (int)((o.comm >> q) & 1u);
      a.out2[(Q + q) * n + node] = (int)((o.rel >> q) & 1u);
      a.out2[(2 * Q + q) * n + node] = o.relv[q];
      a.out2[(3 * Q + q) * n + node] = (int)((o.reld >> q) & 1u);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      a.out3[g * n + node] = o.g_owner[g];
      a.out3[(G + g) * n + node] = o.g_ci[g];
    }
    a.out4[0 * n + node] = o.n_ret;
    a.out4[1 * n + node] = o.rh;
    a.out4[2 * n + node] = o.wh;
    a.out4[3 * n + node] = o.c_rd;
    a.out4[4 * n + node] = o.c_wr;
    a.out4[5 * n + node] = o.c_up;
    a.out4[6 * n + node] = o.c_ev;
  }
}

template <int MODE>
int launch(const FoldArgs& a, void* stream) {
  if (a.n > 0) {
    if (SMEM_BYTES > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          deep_fold_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          SMEM_BYTES);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (a.n + BLOCK - 1) / BLOCK;
    deep_fold_kernel<MODE><<<grid, BLOCK, SMEM_BYTES,
                             static_cast<cudaStream_t>(stream)>>>(a);
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

// dynamic shared memory of a block of the kernels, in bytes
int deep_fold_smem_bytes() { return SMEM_BYTES; }

// window steps an iteration of the fold's W loop
int deep_fold_window_unroll() { return W_UNROLL; }

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
