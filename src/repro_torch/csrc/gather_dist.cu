// gather_dist and gather_topk: fused neighbor gather + squared L2 (+ top-k),
// batched over queries.
//
// Replaces src/repro/kernels/gather_dist.py::gather_dist_pallas and
// ::gather_topk_pallas (f32 corpus; the int8 + scale corpus arrives with the
// quantized slice).  The reference takes one query; these take (Q, M) ids
// and (Q, d) queries, the batch the beam search steps in lockstep.
//
// gather_dist: out[i, j] = sum_c (x[clip(ids[i, j], 0, N-1), c] - q[i, c])^2,
// the difference form.  Callers mask.
// gather_topk: the same distances with ids < 0 masked to +inf, then the k
// smallest by (dist, input position); output ids are the input ids at those
// positions, -1/+inf padded.
//
// What bounds them on an H100: bytes, and at the beam's shapes launch
// latency.  Each gathered row is d f32 read once for 3*d flops, below one
// flop per byte.  At the main path's shapes (Q = 64, M = 32 or 128, d = 128)
// one call moves 1-4 MB, which the card's memory moves in about a
// microsecond, so the few-microsecond launch dominates.
//
// Design: the TPU kernels steer one (1, d) row DMA per grid step from
// scalar-prefetched ids.  Here one warp owns one gathered row: lanes stride
// over d (neighbouring lanes on neighbouring floats, so each warp load is
// one coalesced 128-byte line), accumulate (x - q)^2 with FMAs and reduce
// with shuffles.  gather_dist spreads the Q*M rows over blocks of 8 warps.
// gather_topk runs one block per query: its warps write each position's
// packed (dist, position) key to shared memory, the block bitonic-sorts the
// next_pow2(max(M, k)) keys, and only the k best leave the block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_key.cuh"

#define THREADS 256

__device__ __forceinline__ float row_d2(const float* __restrict__ xr,
                                        const float* __restrict__ qr, int d,
                                        int lane) {
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float df = __ldg(xr + c) - __ldg(qr + c);
    acc = fmaf(df, df, acc);
  }
  return warp_sum(acc);
}

__global__ void gather_dist_kernel(const float* __restrict__ x,
                                   const int* __restrict__ ids,
                                   const float* __restrict__ q,
                                   float* __restrict__ out, int N, int d,
                                   long long QM, int M) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= QM) return;  // warp-uniform
  const long long qi = row / M;
  int id = ids[row];
  id = id < 0 ? 0 : (id > N - 1 ? N - 1 : id);
  const float s = row_d2(x + (size_t)id * d, q + (size_t)qi * d, d, lane);
  if (lane == 0) out[row] = s;
}

__global__ void gather_topk_kernel(const float* __restrict__ x,
                                   const int* __restrict__ ids,
                                   const float* __restrict__ q,
                                   int* __restrict__ out_ids,
                                   float* __restrict__ out_d, int N, int d,
                                   int M, int k, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  key_t64* keys = reinterpret_cast<key_t64*>(smem);
  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int* idr = ids + (size_t)qi * M;
  const float* qr = q + (size_t)qi * d;
  for (int p = warp; p < P; p += nwarps) {
    key_t64 key = KEY_NONE;  // pad position, or a masked id
    const int id = p < M ? idr[p] : -1;
    if (id >= 0) {  // warp-uniform
      const int idc = id > N - 1 ? N - 1 : id;
      const float s = row_d2(x + (size_t)idc * d, qr, d, lane);
      key = make_key(s, (uint32_t)p);
    }
    if (lane == 0) keys[p] = key;
  }
  bitonic_sort(keys, P);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const key_t64 key = keys[i];
    const bool fin = key_finite(key);
    out_ids[(size_t)qi * k + i] = fin ? idr[key_index(key)] : -1;
    out_d[(size_t)qi * k + i] = fin ? key_dist(key) : __uint_as_float(INF_BITS);
  }
}

extern "C" int gather_dist_launch(const float* x, const int* ids,
                                  const float* q, float* out, int N, int d,
                                  int Q, int M, void* stream) {
  const long long QM = (long long)Q * M;
  const long long blocks = (QM * 32 + THREADS - 1) / THREADS;
  gather_dist_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, ids, q, out, N, d, QM, M);
  return (int)cudaGetLastError();
}

// Requires 1 <= k <= P where P = next_pow2(max(M, k)); the wrapper enforces
// the reference's bound (k <= 128).  Returns the first CUDA error, 0 on
// success.
extern "C" int gather_topk_launch(const float* x, const int* ids,
                                  const float* q, int* out_ids, float* out_d,
                                  int N, int d, int Q, int M, int k,
                                  void* stream) {
  const int P = next_pow2_host(M > k ? M : k);
  const size_t smem = (size_t)P * sizeof(key_t64);
  if (smem > 48 * 1024) {
    int rc = (int)cudaFuncSetAttribute(
        (const void*)gather_topk_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
  }
  gather_topk_kernel<<<Q, THREADS, smem, (cudaStream_t)stream>>>(
      x, ids, q, out_ids, out_d, N, d, M, k, P);
  return (int)cudaGetLastError();
}
