// A CPU stand-in for the few parts of the CUDA runtime that the port's
// cooperative round kernels use (csrc/sync_round.cu,
// csrc/sync_multi_round.cu) and the threefry kernel's ordinary launch
// (csrc/threefry.cu), so that g++ can build them into a shared library
// and tests/test_torch_cuda_stub.py can call their C entry points on CPU
// tensors. It is a check of the kernels' logic and of their races, not
// of what nvcc makes of them.
//
// - Each CUDA thread is a std::thread; a launch runs one block (the
//   occupancy query reports one SM that holds one block), so the grid
//   is capped at one block and a thread loops over n / 64 nodes when n
//   passes the block's threads. __syncthreads and the grid barrier are
//   std::barrier, __shfl_xor_sync a slot array between two barriers of
//   the warp, __shared__ a static (one block at a time).
// - The threads run the phases between barriers truly in parallel, so
//   the kernels' reads of rows that other nodes write in the same phase
//   happen as they would on the card, in no fixed order.
// - atomicMin and atomicAdd are std::atomic_ref operations; __ldg is a
//   plain load.
//
// - An ordinary launch (cudaLaunchKernel, for a kernel with no barrier)
//   runs every block of the grid, block after block, and every thread of
//   a block after the other, on the calling thread.
//
// The kernel sources include <cuda_runtime.h> and <cooperative_groups.h>;
// the test points both names at this file.

#pragma once

#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct uint3 {
  unsigned x, y, z;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
struct alignas(8) uint2 {
  unsigned x, y;
};
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }

typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorCooperativeLaunchTooLarge = 720,
  cudaErrorNotSupported = 801,
};
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrCooperativeLaunch = 95,
};
struct cudaFuncAttributes {
  size_t sharedSizeBytes;
};

namespace cuda_stub {

constexpr unsigned MAX_THREADS = 1024;

inline thread_local uint3 thread_idx = {0, 0, 0};
inline thread_local uint3 block_idx = {0, 0, 0};
inline dim3 grid_dim, block_dim;

// the running launch's barriers and shuffle slots
struct Launch {
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  int slots[MAX_THREADS];
};
inline Launch* launch = nullptr;

// how to run each kernel that was queried, by its entry address
inline std::mutex entries_lock;
inline std::map<const void*, std::function<void(void**)>> entries;

}  // namespace cuda_stub

#define threadIdx (cuda_stub::thread_idx)
#define blockIdx (cuda_stub::block_idx)
#define gridDim (cuda_stub::grid_dim)
#define blockDim (cuda_stub::block_dim)

template <typename T>
inline T __ldg(const T* p) {
  return *p;
}

inline int atomicMin(int* p, int v) {
  std::atomic_ref<int> r(*p);
  int old = r.load();
  while (v < old && !r.compare_exchange_weak(old, v)) {
  }
  return old;
}

inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}

inline void __syncthreads() { cuda_stub::launch->block->arrive_and_wait(); }

inline int __shfl_xor_sync(unsigned, int v, int lane_mask) {
  cuda_stub::Launch& l = *cuda_stub::launch;
  const unsigned t = threadIdx.x;
  std::barrier<>& warp = *l.warps[t / 32];
  l.slots[t] = v;
  warp.arrive_and_wait();
  const int got = l.slots[(t & ~31u) | ((t & 31u) ^ (unsigned)lane_mask)];
  warp.arrive_and_wait();
  return got;
}

namespace cooperative_groups {
struct grid_group {
  // one block a launch: the grid's barrier is the block's
  void sync() const { __syncthreads(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups

inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}

inline cudaError_t cudaSetDevice(int dev) {
  return dev == 0 ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr,
                                          int) {
  *value = 1;  // one SM; cooperative launches supported
  return cudaSuccess;
}

// The occupancy query is the kernels' only call that carries a kernel's
// type (each queries it before its first launch, cudaLaunchCooperative
// Kernel takes it as const void*), so the query records how to run it.
template <class A>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, void (*kernel)(A), int, size_t) {
  std::lock_guard<std::mutex> hold(cuda_stub::entries_lock);
  cuda_stub::entries[(const void*)kernel] = [kernel](void** args) {
    const A a = *static_cast<const A*>(args[0]);
    kernel(a);
  };
  *blocks = 1;
  return cudaSuccess;
}

template <class F>
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* attr, F*) {
  attr->sharedSizeBytes = 0;  // not known without a compiled image
  return cudaSuccess;
}

inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// Runs the kernel's one block: every thread a std::thread, all started
// together, joined before the call returns (so the launch is complete
// when the C entry point returns, as after a synchronise on the card).
inline cudaError_t cudaLaunchCooperativeKernel(const void* kernel, dim3 grid,
                                               dim3 block, void** args,
                                               size_t, cudaStream_t) {
  std::function<void(void**)> run;
  {
    std::lock_guard<std::mutex> hold(cuda_stub::entries_lock);
    const auto it = cuda_stub::entries.find(kernel);
    if (it == cuda_stub::entries.end()) return cudaErrorInvalidValue;
    run = it->second;
  }
  if (grid.x != 1 || grid.y != 1 || grid.z != 1 || block.y != 1 ||
      block.z != 1 || block.x % 32 != 0 ||
      block.x > cuda_stub::MAX_THREADS)
    return cudaErrorCooperativeLaunchTooLarge;
  cuda_stub::Launch l;
  l.block = std::make_unique<std::barrier<>>(block.x);
  for (unsigned w = 0; w < block.x / 32; ++w)
    l.warps.push_back(std::make_unique<std::barrier<>>(32));
  cuda_stub::launch = &l;
  cuda_stub::grid_dim = grid;
  cuda_stub::block_dim = block;
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < block.x; ++t)
    threads.emplace_back([&, t] {
      cuda_stub::thread_idx = {t, 0, 0};
      cuda_stub::block_idx = {0, 0, 0};
      run(args);
    });
  for (auto& th : threads) th.join();
  cuda_stub::launch = nullptr;
  return cudaSuccess;
}

// An ordinary launch of a kernel without barriers: every (block, thread)
// of the grid in turn on the calling thread, complete when the call
// returns.
template <class A>
inline cudaError_t cudaLaunchKernel(void (*kernel)(A), dim3 grid, dim3 block,
                                    void** args, size_t, cudaStream_t) {
  if (grid.y != 1 || grid.z != 1 || block.y != 1 || block.z != 1 ||
      block.x == 0 || block.x > cuda_stub::MAX_THREADS)
    return cudaErrorInvalidValue;
  const A a = *static_cast<const A*>(args[0]);
  cuda_stub::grid_dim = grid;
  cuda_stub::block_dim = block;
  for (unsigned b = 0; b < grid.x; ++b)
    for (unsigned t = 0; t < block.x; ++t) {
      cuda_stub::block_idx = {b, 0, 0};
      cuda_stub::thread_idx = {t, 0, 0};
      kernel(a);
    }
  return cudaSuccess;
}
