// The threefry2x32 block of the port's jax.random twin for Hopper (sm_90a).
//
// Not the port of a TPU kernel: on a TPU, jax.random lowers to XLA's own
// threefry2x32, not to a Pallas kernel. The twin (utils/random.py) draws
// every random bit of the workload generators and of fault injection from
// this block: counter i, for i in [0, n), is the pair (hi, lo) of the
// 64-bit index i (jax._src.prng.iota_2x32_shape), and its cipher under the
// key (k0, k1) is 20 rounds of add, rotate and xor with a key injection
// after every four (jax._src.prng._threefry2x32_lowering).
//
// One thread ciphers counter i (a grid-stride loop past the grid's
// threads). The key is read from a [2] device buffer, so a draw needs no
// host sync. Two entry functions:
// - PAIR false: out[i] = y0 ^ y1, the 32-bit draw of random_bits
//   (_threefry_random_bits_partitionable);
// - PAIR true: out[2i], out[2i + 1] = y0, y1, key i of split
//   (_threefry_split_foldlike).
//
// What bounds it on the H100: 77 integer instructions a counter (add,
// funnel-shift rotate and xor a round, the key injections, the counter's
// address) against 4 or 8 bytes written, so integer issue bounds it. The
// compiler puts 25 of them (the IMAD family) on the FMA pipe and 52 on
// the integer pipe, 64 lanes an SM each: 16.8 M counters (the uniform
// generator's 4096 x 4096 draw) take at least 0.052 ms on the integer
// pipe, against 0.02 ms for the 67 MB written. The library has no
// config: one build serves every key, count and mode.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
// grid cap: past 4096 blocks of 256 threads (about 8 blocks an SM) a
// thread takes more counters
constexpr long long MAX_BLOCKS = 4096;

struct ThreefryArgs {
  const uint32_t* key;  // [2]: k0, k1
  uint32_t* out;        // [n] draws, or [n, 2] key pairs
  long long n;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// four rounds of one rotation group
#define THREEFRY_ROUNDS(r0, r1, r2, r3)  \
  x0 += x1; x1 = rotl(x1, r0) ^ x0;      \
  x0 += x1; x1 = rotl(x1, r1) ^ x0;      \
  x0 += x1; x1 = rotl(x1, r2) ^ x0;      \
  x0 += x1; x1 = rotl(x1, r3) ^ x0;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  THREEFRY_ROUNDS(13, 15, 26, 6)
  x0 += k1; x1 += k2 + 1u;
  THREEFRY_ROUNDS(17, 29, 16, 24)
  x0 += k2; x1 += k0 + 2u;
  THREEFRY_ROUNDS(13, 15, 26, 6)
  x0 += k0; x1 += k1 + 3u;
  THREEFRY_ROUNDS(17, 29, 16, 24)
  x0 += k1; x1 += k2 + 4u;
  THREEFRY_ROUNDS(13, 15, 26, 6)
  x0 += k2; x1 += k0 + 5u;
}

#undef THREEFRY_ROUNDS

template <bool PAIR>
__global__ void __launch_bounds__(BLOCK) threefry_kernel(ThreefryArgs a) {
  const uint32_t k0 = __ldg(a.key), k1 = __ldg(a.key + 1);
  const long long stride = (long long)gridDim.x * BLOCK;
#pragma unroll 1
  for (long long i = (long long)blockIdx.x * BLOCK + threadIdx.x; i < a.n;
       i += stride) {
    uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
    threefry2x32(k0, k1, x0, x1);
    if (PAIR) {
      reinterpret_cast<uint2*>(a.out)[i] = make_uint2(x0, x1);
    } else {
      a.out[i] = x0 ^ x1;
    }
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).
extern "C" {

// blocks of the launch for n counters
int threefry_grid(long long n) {
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  return (int)(blocks < 1 ? 1 : blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
}

// Cipher counters 0 .. n - 1 under the key at `key` (2 uint32 on the
// card) into `out` (n uint32, or n pairs when `pair`), launched on
// `device`'s `stream` without synchronising; returns the CUDA error (0:
// success). Leaves the caller's current device as it was.
int threefry(const void* key, void* out, long long n, int pair, int device,
             void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int prev = 0;
  cudaGetDevice(&prev);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  ThreefryArgs a = {static_cast<const uint32_t*>(key),
                    static_cast<uint32_t*>(out), n};
  void* args[] = {&a};
  const dim3 grid(threefry_grid(n));
  e = pair ? cudaLaunchKernel(threefry_kernel<true>, grid, dim3(BLOCK), args,
                              0, static_cast<cudaStream_t>(stream))
           : cudaLaunchKernel(threefry_kernel<false>, grid, dim3(BLOCK), args,
                              0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) cudaGetLastError();
  cudaSetDevice(prev);
  return (int)e;
}

}  // extern "C"
