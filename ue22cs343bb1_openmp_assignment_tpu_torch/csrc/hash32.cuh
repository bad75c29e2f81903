// 32-bit hashes shared by the port's kernels: the murmur3-style
// finalizer behind the claim keys (ops/sync_engine._round_key_rs) and
// the procedural 'uniform' instruction stream (procedural.py:
// procedural_instr), both native uint32 arithmetic here.
//
// procedural_instr needs the config's constants as -D defines
// (ops/sync_burst_kernel.procedural_defines): SW_BLOCK_BITS, SW_M
// (blocks per node), SW_SEED_TERM (proc_seed * 2654435761 mod 2^32),
// SW_LOCAL_PERMILLE, SW_WRITE_PERMILLE. The number of nodes is a
// run-time argument, so one library serves every machine size.

#pragma once

#include <stdint.h>

namespace hash32 {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

#if defined(SW_BLOCK_BITS) && defined(SW_M) && defined(SW_SEED_TERM) && \
    defined(SW_LOCAL_PERMILLE) && defined(SW_WRITE_PERMILLE)

// Instruction `idx` of `node` in a machine of `n` nodes: oa = op << 28 |
// addr (op 0 read, 1 write; addr = home << block_bits | block), and the
// value a write stores.
__device__ __forceinline__ void procedural_instr(int node, int idx, int n,
                                                 int& oa, int& val) {
  const uint32_t h = mix32(((uint32_t)node * 0x9E3779B9u) ^
                           ((uint32_t)idx * 0x85EBCA77u) ^
                           (uint32_t)(SW_SEED_TERM));
  const uint32_t h2 = mix32(h ^ 0xC2B2AE35u);
  const bool is_write = (int)(h % 1000u) < (SW_WRITE_PERMILLE);
  const bool local = (int)((h >> 10) % 1000u) < (SW_LOCAL_PERMILLE);
  const int home = local ? node : (int)(h2 % (uint32_t)n);
  const int block = (int)((h2 >> 16) % (uint32_t)(SW_M));
  const int addr = (int)(((uint32_t)home << (SW_BLOCK_BITS)) | (uint32_t)block);
  oa = (int)(((uint32_t)(is_write ? 1 : 0) << 28) | (uint32_t)addr);
  val = (int)((h >> 21) & 0xFFu);
}

#endif

}  // namespace hash32
