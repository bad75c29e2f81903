// Lane exchange of the routed mailbox transport for Hopper (sm_90a):
// inbox[d][s] = outbox[s][d] for D shards.
//
// Replaces the JAX package's Pallas TPU kernel parallel/rdma_comm.py:
// _ring_exchange (its pallas_call). Shard s's outbox is [D, cap, W] int32
// (lane d: the rows bound for shard d, W = 2 + Fw words a row: receiver
// with -1 for an empty row, priority, payload); shard d's inbox is the
// same shape, lane s holding what shard s sent it. Each (sender, lane) is
// one contiguous run of cap * W words at the same offset pattern on both
// sides, so the exchange is D * D independent block copies.
//
// The TPU kernel runs D - 1 ring steps, each one remote DMA followed by a
// wait on reused semaphores. On the GPU a sender's D destination regions
// are disjoint, so nothing orders the copies: one launch writes every
// lane of every sender at once (the self lane included), stream order is
// the barrier on one card, and events are the barrier across cards (the
// wrapper's job). Lane k of sender s goes to shard (s + k) % D, the TPU
// kernel's ring order, which spreads a sender's peer traffic at no cost.
//
// Grid: (chunks of a lane, lane k, sender). Threads copy 16-byte vectors
// where both the source and the destination run are 16-byte aligned
// (cap * W a multiple of 4 and 16-byte aligned bases), with a scalar tail
// for the last cap * W % 4 words; other runs are copied word by word.
// The D outbox and D inbox base pointers are kernel parameters (D <= 8).
// Across cards with peer access enabled the same kernel runs once per
// sender on the sender's card (s_count = 1) and stores through the
// receivers' pointers.
//
// What bounds it on the H100: it moves 2 * D^2 * cap * W * 4 bytes and
// does no arithmetic beyond addressing, so bytes bound it: at 4096 nodes,
// D = 4, scatter mode (cap 3072, W 9) that is 3.5 MB, 1.06 us at
// 3.35 TB/s, under a launch's latency (~5 us).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef RING_MAX_D
#error "the build defines RING_MAX_D"
#endif

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_D = RING_MAX_D;

struct RingArgs {
  const int* ob[MAX_D];   // sender s's outbox base, [D, cap, W]
  int* ib[MAX_D];         // receiver d's inbox base, [D, cap, W]
  long long lane_words;   // cap * W
  int d;                  // shards
  int s_first;            // first sender of this launch
};

__global__ void __launch_bounds__(BLOCK) ring_exchange_kernel(RingArgs a) {
  const int s = a.s_first + blockIdx.z;
  const int dst = (s + blockIdx.y) % a.d;     // the TPU kernel's ring order
  const long long n = a.lane_words;
  const int* src = a.ob[s] + dst * n;          // rows bound for dst
  int* out = a.ib[dst] + s * n;                // dst's lane from s
  const long long first = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const long long stride = (long long)gridDim.x * BLOCK;
  if ((((uintptr_t)src | (uintptr_t)out) & 15) == 0) {
    const long long nv = n >> 2;
    const int4* vs = reinterpret_cast<const int4*>(src);
    int4* vo = reinterpret_cast<int4*>(out);
    for (long long i = first; i < nv; i += stride) vo[i] = vs[i];
    for (long long i = (nv << 2) + first; i < n; i += stride) out[i] = src[i];
  } else {
    for (long long i = first; i < n; i += stride) out[i] = src[i];
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a CUDA error
// code (0: success) and leaves the caller's current device as it was.

// Launch the exchange for senders [s_first, s_first + s_count) on
// `device`'s `stream` without synchronising. ob[s] and ib[r] are the
// bases of the D outboxes and inboxes (ob[s] is read only for the
// launched senders).
extern "C" int ring_exchange(void* const* ob, void* const* ib, int d,
                             int s_first, int s_count, long long lane_words,
                             int device, void* stream) {
  if (d < 1 || d > MAX_D || s_first < 0 || s_count < 0 ||
      s_first + s_count > d || lane_words < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (s_count == 0 || lane_words == 0) return 0;
  int prev = 0;
  cudaGetDevice(&prev);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  RingArgs a = {};
  for (int i = 0; i < d; ++i) {
    a.ob[i] = static_cast<const int*>(ob[i]);
    a.ib[i] = static_cast<int*>(ib[i]);
  }
  a.lane_words = lane_words;
  a.d = d;
  a.s_first = s_first;
  const long long vecs = (lane_words + 3) / 4;
  long long chunks = (vecs + BLOCK - 1) / BLOCK;
  if (chunks > 1024) chunks = 1024;
  const dim3 grid(static_cast<unsigned>(chunks), d, s_count);
  ring_exchange_kernel<<<grid, BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  err = cudaGetLastError();
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

// Let `device` store into `peer`'s memory (cudaDeviceEnablePeerAccess);
// already enabled counts as success. Returns cudaErrorPeerAccessUnsupported
// when the pair cannot.
extern "C" int ring_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int prev = 0;
  cudaGetDevice(&prev);
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      err = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return static_cast<int>(err);
}
