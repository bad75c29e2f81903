// The whole single-transaction (txn_width 1) round for Hopper (sm_90a):
// one cooperative kernel a round.
//
// Replaces the JAX package's ops/pallas_burst.py:_kernel and the eager
// round around it. Mosaic has no vector gather and no atomics, so the
// TPU kernel can only be the node-local phases 1-2a of the round (the
// burst), and the arbitration, the commit and the fan-out stay XLA ops
// around it. An H100 has gathers, atomics and grid-wide barriers, so one
// launch here takes the state as the engine holds it to the next round's
// state, as ops/sync_round_kernel.plain_round does in plain PyTorch
// (ops/sync_engine._round_step_single's tensor code):
//
//   in:  cache_addr/val/state [R, n, C], read in place (one 16-byte load
//        a plane and node at C = 4), dm [R, E, 7], idx and instr_count
//        [R, n], round and seed [R], the 11 metric counters [R, 11];
//   out: the cache planes, dm, idx, round + 1 and the counters.
//
// R is the replica axis of a seed ensemble (ops/sync_engine.
// ensemble_round_step): R independent machines in one launch, between
// the same three grid barriers; one machine is R = 1, the same entry
// point and the same code. The design gives blocks to replicas (Team in
// csrc/sync_round.cuh): the grid is 2-D, a row of blocks a replica.
// While the grid holds every replica's nodes at one node a thread, each
// row serves one replica's nodes; past that the resident blocks split
// evenly over the replicas and a thread loops over nodes (and, past one
// block a replica, a row over replicas).
// Every phase runs on one replica's view of the operands (replica()), so
// claims, commits and fan-out stay inside that replica's dm, its claim
// keys come from its own round and seed, and its counters are summed by
// blocks that serve it alone. Replicas share no row, so the argument
// below holds for each replica of a launch.
//
// What it shares with the txn_width >= 2 round (csrc/sync_multi_round.cu)
// outside the node-local burst is in csrc/sync_round.cuh: the operands
// and their replica views, the claim key, the dm copy, the fan-out of one
// line, the counters and the grid.
//
// Phases (each "|" is a grid barrier, cooperative_groups::this_grid()
// .sync(); the launch is cooperative, so every block is resident):
//
//   P0  the grid copies every replica's dm to dm_out in 16-byte words
//       (consecutive threads on consecutive words, 8 loads in flight a
//       thread), and writes each replica's round + 1 and its counters
//       with rounds + 1 |
//   P1  per node: the burst (csrc/sync_burst.cuh) on the round-start
//       cache, with the post-burst values and states written to the
//       output planes; the stopped instruction classified against the
//       post-burst line (transaction, upgrade, victim); the claim key of
//       sync_engine._round_key_rs in uint32 arithmetic; a signed
//       atomicMin of the key on dm_out[e1, DM_CLAIM] and, for a victim,
//       on dm_out[e2, DM_CLAIM] (entries are clipped into [0, E), so no
//       claim drops; a lane without a transaction claims nothing, as the
//       index E of TorchIndexOps.scatter_min drops it) |
//   P2  the claim words at e1 and e2 decide `win`; a winner reads its
//       rows at e1 and e2 and the owner's post-burst line (val_o), works
//       out the transaction and eviction outcomes in registers and
//       writes its two committed rows; every node's idx advances by
//       d + win, and its fill goes to scratch |
//   P3  the fan-out: each valid line reads DM_ACT and DM_REQ at its
//       tag's entry and is killed, downgraded or promoted; a promoted
//       line writes its node as DM_OWNER. Then, in the same thread, the
//       winner's fill of its own line and the cache rows out. The
//       metric deltas, read from what P1 and P2 left in scratch and
//       summed in registers over the thread's nodes of a replica, are
//       reduced per block and added to that replica's counters with one
//       integer atomicAdd per counter and block (order-free, so the
//       result is deterministic).
//
// The plain round's P2a (gathers, win, outcomes) and P2b (the commit
// scatter) run here without a barrier between them. Every value read
// across that merge is settled or masked by a loss:
//
// - A committed row at entry x is written only by x's winner w, which
//   holds the minimum claim key on x (keys are unique per node). Any
//   other node r that reads x's row uses it only if r wins and x is its
//   e1, or its e2 with a victim; r then claimed x, so x's claim word is
//   below r's key and r loses. A row's DM_CLAIM word is rewritten with
//   the winner's key, the value it holds already, so a claim word read
//   during the write is the same either way.
// - val_o reads the output cache planes, which P1 wrote and only P3
//   (after a barrier) writes again.
// - The rows' DM_ACT and DM_REQ words that P2 writes are read only in
//   P3, after a barrier.
//
// P3 reads DM_ACT and DM_REQ and writes DM_OWNER, different words, and
// each node writes only its own cache lines. A promoted entry has one
// holder left (the directory is exact), so its DM_OWNER has one writer.
// P0 | P1 stays a barrier (P1's atomics need the copy of the claim words
// under them), and so does P2 | P3 (the fan-out needs every committed
// row). Three grid barriers.
//
// Per-node values that cross a barrier go through scratch in device
// memory ([R_ROWS, n] a replica, written and read by the same thread,
// coalesced), so a thread can run several nodes: the grid is sized by an
// occupancy query (made once a device and cached), one node a thread
// while the nodes fit, larger machines and ensembles loop.
//
// What bounds it on the H100: bytes. At sync@4096 the launch must move
// dm in and out (E = 65,536 rows of 28 B each way, 3.67 MB) and the
// cache, cursor and counter planes (about 0.46 MB); its integer work is
// the burst's hash for d + 1 slots a node and a few hundred instructions
// of classification, key, outcomes and fan-out, a tenth of the bytes'
// time. The dm copy is the only part that needs bandwidth; the rest is
// the burst's dependent chain, a few gathers and three grid barriers.
// An ensemble of R moves R times the bytes in one launch. Its times
// beside its bound are in PERF.md, section 6.
//
// Semantics kept from JAX's int32: shifts of signed values whose result
// may wrap (round << 2, the key) go through uint32_t; the arithmetic >>
// of DM_ACT, which may be negative, stays signed; idx + n_ret wraps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sync_burst.cuh"
#include "sync_round.cuh"

namespace {

using namespace sburst;
using namespace sround;
namespace cg = cooperative_groups;

constexpr int BLOCK = 64;
// At most this many resident blocks an SM (two warps a scheduler)
constexpr int MAX_BLOCKS_PER_SM = 4;
// Dynamic shared memory a block: none (the block's metric partials are
// a static array). The occupancy query and the launch both pass this.
constexpr size_t SMEM_BYTES = 0;

// Per-node scratch: an int32 [R_ROWS, n] plane, row r of node i at
// r * n + i.
constexpr int R_OA = 0;      // stopped instruction: op << 28 | addr
constexpr int R_VAL = 1;     // its value
constexpr int R_LADDR = 2;   // tag of its line (round start)
constexpr int R_LVAL = 3;    // the line's value after the burst
constexpr int R_BITS = 4;    // d | flags (B_*) | line state << 24
constexpr int R_FILL = 5;    // fill state of a winner, else -1
constexpr int R_FILLV = 6;   // fill value
constexpr int R_HITS = 7;    // the burst's read hits | write hits << 16
constexpr int R_ROWS = 8;
constexpr int B_TXN = 1 << 16, B_VICT = 1 << 17, B_RD = 1 << 18,
              B_WR = 1 << 19, B_UP = 1 << 20;
static_assert(H < (1 << 16), "drain_depth fits 16 bits");

// The phases take one replica's view (replica()): n nodes, round and
// seed 0-d, scratch [R_ROWS, n].

// P1 for one node: burst, classification, claims.
__device__ __forceinline__ void phase_claim(const Args& a, const Keys& k,
                                            int node, int E) {
  const int n = a.n;
  int ca[C], cs0[C], cv[C], cs[C];
  load_row<true>(a.ca, node, ca);
  load_row<true>(a.cv, node, cv);
  load_row<true>(a.cs, node, cs0);
#pragma unroll
  for (int c = 0; c < C; ++c) cs[c] = cs0[c];
  const Burst b = burst(node, n, __ldg(a.idx + node), __ldg(a.cnt + node),
                        ca, cs0, cv, cs);
  store_row(a.cv_o, node, cv);
  store_row(a.cs_o, node, cs);

  // the stopped instruction against its line after the burst
  const int op = b.oa >> 28, addr = b.oa & 0x0FFFFFFF;
  const int ci = cache_index(addr);
  int l_addr = ca[0], l_val = cv[0], l_state = cs[0];
#pragma unroll
  for (int c = 1; c < C; ++c) {
    l_addr = ci == c ? ca[c] : l_addr;
    l_val = ci == c ? cv[c] : l_val;
    l_state = ci == c ? cs[c] : l_state;
  }
  const bool tag_ok = l_addr == addr && l_state != INV;
  const bool upg = b.live && op == OP_WRITE && tag_ok && l_state == SHD;
  const bool rd_miss = b.live && op == OP_READ && !tag_ok;
  const bool wr_miss = b.live && op == OP_WRITE && !tag_ok;
  const bool txn = rd_miss || wr_miss || upg;
  // (a leftover hit at the stop position waits for the next round)
  const bool victim = txn && !tag_ok && l_state != INV && l_addr != addr;
  if (txn) {
    const int key = k.key(node);
    atomicMin(a.dm_o + (size_t)clip(addr, 0, E - 1) * DM_COLS + DM_CLAIM,
              key);
    if (victim)
      atomicMin(a.dm_o + (size_t)clip(l_addr, 0, E - 1) * DM_COLS + DM_CLAIM,
                key);
  }
  int* sc = a.scratch;
  sc[R_OA * n + node] = b.oa;
  sc[R_VAL * n + node] = b.val;
  sc[R_LADDR * n + node] = l_addr;
  sc[R_LVAL * n + node] = l_val;
  sc[R_BITS * n + node] = b.d | (txn ? B_TXN : 0) | (victim ? B_VICT : 0) |
                          (rd_miss ? B_RD : 0) | (wr_miss ? B_WR : 0) |
                          (upg ? B_UP : 0) | (l_state << 24);
  sc[R_HITS * n + node] = b.rh | (b.wh << 16);
}

// P2 for one node: verdict, outcomes, commit.
__device__ __forceinline__ void phase_commit(const Args& a, const Keys& k,
                                             int round, int node, int E) {
  const int n = a.n;
  const int* sc = a.scratch;
  const int bits = sc[R_BITS * n + node];
  const int d = bits & 0xFFFF;
  const bool txn = bits & B_TXN, victim = bits & B_VICT;
  const int addr = sc[R_OA * n + node] & 0x0FFFFFFF;
  const int l_addr = sc[R_LADDR * n + node];
  int* r1 = a.dm_o + (size_t)clip(addr, 0, E - 1) * DM_COLS;
  int* r2 = a.dm_o + (size_t)clip(l_addr, 0, E - 1) * DM_COLS;
  const int key = k.key(node);
  bool win = false;
  if (txn) {
    win = r1[DM_CLAIM] == key;
    if (win && victim) win = r2[DM_CLAIM] == key;
  }
  int fill = -1, fill_val = 0;
  if (win) {
    const bool rd_w = bits & B_RD, wr_w = bits & B_WR, up_w = bits & B_UP;
    const int ci = cache_index(addr);
    const int d1s = r1[DM_STATE], d1c = r1[DM_COUNT], d1o = r1[DM_OWNER],
              d1m = r1[DM_MEM];
    const bool d_u = d1s == D_U, d_em = d1s == D_EM;
    // the EM owner's copy after its burst: same-round local writes by
    // the owner are visible (hits order before transactions)
    const int val_o = a.cv_o[(size_t)clip(d1o, 0, n - 1) * C + ci];
    const bool wlike = wr_w || up_w;
    const bool excl = wlike || (rd_w && d_u);
    const int rtag = (int)((uint32_t)round << 2);
    const int row1[DM_COLS] = {
        excl ? D_EM : D_S,
        excl ? 1 : (rd_w && d_em ? 2 : d1c + 1),
        excl ? node : d1o,
        ((rd_w || wr_w) && d_em) ? val_o : d1m,
        rtag | (wlike ? ACT_KILL : (rd_w && d_em ? ACT_DOWNGRADE : ACT_NONE)),
        node, key};
#pragma unroll
    for (int j = 0; j < DM_COLS; ++j) r1[j] = row1[j];
    if (victim) {
      // the victim entry (EVICT_SHARED / EVICT_MODIFIED semantics)
      const int l_state = bits >> 24;
      const bool ev_mod = l_state == MOD;
      const int n2c = ev_mod ? 0 : r2[DM_COUNT] - 1;
      const int row2[DM_COLS] = {
          n2c == 0 ? D_U : (n2c == 1 ? D_EM : D_S), n2c,
          r2[DM_OWNER],     // updated by the promoted line's own write
          ev_mod ? sc[R_LVAL * n + node] : r2[DM_MEM],
          rtag | (!ev_mod && n2c == 1 ? ACT_PROMOTE : ACT_NONE), node, key};
#pragma unroll
      for (int j = 0; j < DM_COLS; ++j) r2[j] = row2[j];
    }
    fill = rd_w ? (d_u ? EXC : SHD) : MOD;
    fill_val = rd_w ? (d_em ? val_o : d1m) : sc[R_VAL * n + node];
  }
  const int n_ret = d + (win ? 1 : 0);
  a.idx_o[node] = (int)((uint32_t)__ldg(a.idx + node) + (uint32_t)n_ret);
  a.scratch[R_FILL * n + node] = fill;
  a.scratch[R_FILLV * n + node] = fill_val;
}

// P3 for one node: fan-out over its lines, its fill, its cache rows out,
// and the round's metric deltas from what P1 and P2 left in scratch (a
// winner is a node with a fill).
__device__ __forceinline__ void phase_fanout(const Args& a, int round,
                                             int node, int E,
                                             int (&acc)[N_DELTAS]) {
  const int n = a.n;
  // the scratch words first: the fan-out's DM_OWNER stores may alias
  // them as far as the compiler knows, so loads after it would wait
  const int fill = a.scratch[R_FILL * n + node];
  const int bits = a.scratch[R_BITS * n + node];
  const int hits = a.scratch[R_HITS * n + node];
  const int addr = a.scratch[R_OA * n + node] & 0x0FFFFFFF;
  const int fill_val = a.scratch[R_FILLV * n + node];
  int ca[C], cv[C], cs[C];
  load_row<true>(a.ca, node, ca);
  load_row<false>(a.cv_o, node, cv);
  load_row<false>(a.cs_o, node, cs);
#pragma unroll
  for (int c = 0; c < C; ++c)
    fan_out_line(a.dm_o, E, round, node, ca[c], cs[c], acc);
  const bool win = fill >= 0;
  acc[M_RH] += hits & 0xFFFF;
  acc[M_WH] += hits >> 16;
  acc[M_RET] += (bits & 0xFFFF) + (win ? 1 : 0);
  acc[M_CONF] += ((bits & B_TXN) && !win) ? 1 : 0;
  acc[M_RD] += (win && (bits & B_RD)) ? 1 : 0;
  acc[M_WR] += (win && (bits & B_WR)) ? 1 : 0;
  acc[M_UP] += (win && (bits & B_UP)) ? 1 : 0;
  acc[M_EV] += (win && (bits & B_VICT)) ? 1 : 0;
  if (win) {
    const int ci = cache_index(addr);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ca[c] = ci == c ? addr : ca[c];
      cv[c] = ci == c ? fill_val : cv[c];
      cs[c] = ci == c ? fill : cs[c];
    }
  }
  store_row(a.ca_o, node, ca);
  store_row(a.cv_o, node, cv);
  store_row(a.cs_o, node, cs);
}

__global__ void __launch_bounds__(BLOCK) sync_round_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int n = a.n, E = n << SW_BLOCK_BITS;
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
      phase_claim(v, rk.k, node, E);
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
long long sync_round_scratch_ints(int reps, int n) {
  return (long long)R_ROWS * n * reps;
}

// dynamic shared memory a block that the occupancy query and the
// launch pass
int sync_round_smem_bytes() { return (int)SMEM_BYTES; }

// the kernel's static shared memory a block, from the loaded image
// (cudaFuncGetAttributes), or -(CUDA error)
int sync_round_static_smem_bytes() {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, sync_round_kernel);
  return e == cudaSuccess ? (int)attr.sharedSizeBytes : -(int)e;
}

// the grid the launch for reps replicas of n nodes uses (>= 1), or
// -(CUDA error)
int sync_round_grid(int reps, int n) {
  dim3 grid;
  const int err = the_grid.grid_for(sync_round_kernel, reps > 0 ? reps : 1,
                                    n > 0 ? n : 1, &grid);
  return err ? -err : (int)(grid.x * grid.y);
}

// One round of reps machines of n nodes each, launched cooperatively on
// `stream` without synchronising; returns the launch's CUDA error (0 on
// success). reps >= 1, n >= 1.
int sync_round(const int* ca, const int* cv, const int* cs, const int* dm,
               const int* idx, const int* cnt, const int* round,
               const int* seed, const int* metrics, int* ca_o, int* cv_o,
               int* cs_o, int* dm_o, int* idx_o, int* round_o,
               int* metrics_o, int* scratch, int reps, int n,
               void* stream) {
  if (n <= 0 || reps <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid;
  const int err = the_grid.grid_for(sync_round_kernel, reps, n, &grid);
  if (err) return err;
  Args a = {ca,    cv,      cs,        dm,      idx,  cnt,  round,
            seed,  metrics, ca_o,      cv_o,    cs_o, dm_o, idx_o,
            round_o, metrics_o, scratch, n,     reps};
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)sync_round_kernel, grid, dim3(BLOCK), args, SMEM_BYTES,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
