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
// latency of one thread's long dependent chain are the limit. One thread
// per node at 128 threads a block gives 32 blocks at N=4096, so most of
// the 132 SMs idle; that is what holds the kernel back, and the next
// step is to split a node's table work across lanes.
//
// The fold body is csrc/deep_fold.cuh (dfold::fold_node), shared with
// the fused round kernel (csrc/deep_round.cu); each kernel here loads
// its mode's verdicts and codes, runs it, and stores its mode's outputs.

#include "deep_fold.cuh"

namespace {

using namespace dfold;

constexpr int BLOCK = 128;

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
  const int node = blockIdx.x * BLOCK + threadIdx.x;
  const int n = a.n;
  if (node >= n) return;

  const FoldIn in = {{a.ca, n, 1},   {a.cv, n, 1},   {a.cs, n, 1},
                     {a.dms, n, 1},  {a.dmc, n, 1},  {a.dmo, n, 1},
                     {a.dmm, n, 1},  {a.woa, n, 1},  {a.wval, n, 1},
                     {a.wlive, n, 1}, a.hor};
  int bad[Q], ocode[S];
#pragma unroll
  for (int q = 0; q < Q; ++q) bad[q] = MODE == REPLAY ? a.bad[q * n + node] : 0;
#pragma unroll
  for (int s = 0; s < S; ++s)
    ocode[s] = MODE == PRE ? 0 : a.ocode[s * n + node];
  FoldOut o;
  fold_node(in, node, bad, ocode, o);

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
      a.out1[s * n + node] = o.dms[s];
      a.out1[(S + s) * n + node] = o.dmc[s];
      a.out1[(2 * S + s) * n + node] = o.dmo[s];
      a.out1[(3 * S + s) * n + node] = o.dmm[s];
      a.out1[(4 * S + s) * n + node] = o.dmm_src[s];
      a.out1[(5 * S + s) * n + node] = (int)((o.touched >> s) & 1u);
      a.out1[(6 * S + s) * n + node] = o.act_acc[s];
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
