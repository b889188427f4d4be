// Shared pieces of the hand-written top-k kernels: the packed (dist, index)
// sort key, a block-wide bitonic sort in shared memory, and a bitonic merge
// of sorted runs in global memory for a top-k too large for one block.
//
// A key packs a non-negative float distance in its high 32 bits and an
// unsigned index (a rank, or an input position) in its low 32 bits.  For
// non-negative IEEE floats the bit pattern orders like the value, so one
// 64-bit compare orders candidates by the lexicographic key (dist, index):
// distance ties go to the lower index, the tie order of lax.top_k and of
// the Pallas kernels' first-occurrence select-min.  GPU blocks finish in no
// particular order, so the tie order has to live in the key itself.
#pragma once
#include <cuda_runtime.h>
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

// Opts a kernel into more than 48 KB of dynamic shared memory.  The
// attribute stays set for the kernel on its device, so
// cudaFuncSetAttribute runs once per (kernel, device) and again only for
// a larger size.
static int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  enum { SLOTS = 64 };
  static const void* fns[SLOTS];
  static int devs[SLOTS];
  static size_t done[SLOTS];
  static int used = 0;
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  int slot = 0;
  while (slot < used && (fns[slot] != fn || devs[slot] != dev)) ++slot;
  if (slot < used && done[slot] >= bytes) return 0;
  rc = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == 0 && slot < SLOTS) {
    fns[slot] = fn;
    devs[slot] = dev;
    done[slot] = bytes;
    if (slot == used) ++used;
  }
  return rc;
}

#define MERGE_THREADS 256

// One compare-exchange step of an ascending bitonic merge over each row of
// C keys (grid (ceil(C/2 / MERGE_THREADS), rows), one thread per pair).
// flip: pairs i and its mirror in each block of 2*half keys (the first step
// of a stage, which merges two ascending runs of half keys); else pairs i
// and i + half (a half-cleaner).
__global__ void sort_step(key_t64* __restrict__ keys, int C, int half,
                          int flip) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= C / 2) return;
  key_t64* row = keys + (size_t)blockIdx.y * C;
  const int blk = t / half, off = t % half;
  const int i = blk * 2 * half + off;
  const int j = flip ? blk * 2 * half + 2 * half - 1 - off : i + half;
  const key_t64 a = row[i], b = row[j];
  if (a > b) {
    row[i] = b;
    row[j] = a;
  }
}

// The half-cleaners of strides stride0 .. 1 on each tile of R keys, in
// shared memory (grid (C / R, rows)).
__global__ void sort_tile(key_t64* __restrict__ keys, int C, int R,
                          int stride0) {
  extern __shared__ __align__(16) unsigned char smem[];
  key_t64* s = reinterpret_cast<key_t64*>(smem);
  key_t64* tile = keys + (size_t)blockIdx.y * C + (size_t)blockIdx.x * R;
  for (int i = threadIdx.x; i < R; i += blockDim.x) s[i] = tile[i];
  __syncthreads();
  for (int stride = stride0; stride > 0; stride >>= 1) {
    for (int t = threadIdx.x; t < R / 2; t += blockDim.x) {
      const int i = (t / stride) * 2 * stride + t % stride;
      const key_t64 a = s[i], b = s[i + stride];
      if (a > b) {
        s[i] = b;
        s[i + stride] = a;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < R; i += blockDim.x) tile[i] = s[i];
}

// Sorts each of `rows` rows of C keys in place, given that each row is
// C / R ascending runs of R keys (C / R and R powers of two): one launch
// per cross-tile step, the in-tile steps of each stage in shared memory.
// Returns the first CUDA error, 0 on success.
static int merge_sorted_runs(key_t64* keys, int C, int R, int rows,
                             cudaStream_t st) {
  const dim3 pairs((C / 2 + MERGE_THREADS - 1) / MERGE_THREADS, rows);
  const size_t smem_t = (size_t)R * sizeof(key_t64);
  int rc = set_smem((const void*)sort_tile, smem_t);
  if (rc) return rc;
  for (int size = 2 * R; size <= C; size <<= 1) {
    sort_step<<<pairs, MERGE_THREADS, 0, st>>>(keys, C, size / 2, 1);
    for (int half = size / 4; half >= R; half >>= 1)
      sort_step<<<pairs, MERGE_THREADS, 0, st>>>(keys, C, half, 0);
    sort_tile<<<dim3(C / R, rows), MERGE_THREADS, smem_t, st>>>(keys, C, R,
                                                                 R / 2);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}
