// Shared pieces of the hand-written top-k kernels: the packed (dist, index)
// sort key and a block-wide bitonic sort in shared memory.
//
// A key packs a non-negative float distance in its high 32 bits and an
// unsigned index (a rank, or an input position) in its low 32 bits.  For
// non-negative IEEE floats the bit pattern orders like the value, so one
// 64-bit compare orders candidates by the lexicographic key (dist, index):
// distance ties go to the lower index, the tie order of lax.top_k and of
// the Pallas kernels' first-occurrence select-min.  GPU blocks finish in no
// particular order, so the tie order has to live in the key itself.
#pragma once
#include <stdint.h>

typedef unsigned long long key_t64;

// sorts after every real key; also the pad value
#define KEY_NONE 0xFFFFFFFFFFFFFFFFull
#define INF_BITS 0x7f800000u

__device__ __forceinline__ key_t64 make_key(float d, uint32_t idx) {
  // callers pass d >= +0 (clamped or a sum of squares); -0.0 would sort last
  return ((key_t64)__float_as_uint(d) << 32) | (key_t64)idx;
}

__device__ __forceinline__ bool key_finite(key_t64 key) {
  return (uint32_t)(key >> 32) < INF_BITS;
}

__device__ __forceinline__ float key_dist(key_t64 key) {
  return __uint_as_float((uint32_t)(key >> 32));
}

__device__ __forceinline__ uint32_t key_index(key_t64 key) {
  return (uint32_t)(key & 0xFFFFFFFFull);
}

// Ascending bitonic sort of n keys (n a power of two) in shared memory by
// the whole block.  Starts and ends with a barrier.
__device__ void bitonic_sort(key_t64* s, int n) {
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        int j = i ^ stride;
        if (j > i) {
          bool up = (i & size) == 0;
          key_t64 a = s[i], b = s[j];
          if ((a > b) == up) {
            s[i] = b;
            s[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Writes one top-k slot: the key's index and distance, or -1/+inf for a pad.
__device__ __forceinline__ void emit(key_t64 key, int* id, float* dist) {
  const bool fin = key_finite(key);
  *id = fin ? (int)key_index(key) : -1;
  *dist = fin ? key_dist(key) : __uint_as_float(INF_BITS);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static inline int next_pow2_host(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}
