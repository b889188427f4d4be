// gather_dist, gather_topk and gather_rerank: fused neighbor gather +
// squared L2 (+ top-k), batched over queries.
//
// Replaces src/repro/kernels/gather_dist.py::gather_dist_pallas,
// ::gather_topk_pallas (f32, int8 or bf16 corpus with an optional
// per-dimension f32 scale) and ::gather_rerank_pallas (the f32 rescore of
// the quantized path).  The reference's gather_dist and gather_topk take
// one query; these take (Q, M) ids and (Q, d) queries, the batch the beam
// search steps in lockstep, as gather_rerank does.
//
// gather_dist: out[i, j] = sum_c (x[clip(ids[i, j], 0, N-1), c] * scale[c]
// - q[i, c])^2, the difference form, each element upcast to f32 and
// dequantized first.  Callers mask.
// gather_topk / gather_rerank: the same distances with ids < 0 masked to
// +inf, then the k smallest by (dist, input position); output ids are the
// input ids at those positions, -1/+inf padded.  The rerank's callers sort
// each id row ascending first, so its ties go to the lower rank.
//
// What bounds them on an H100: bytes, and at the beam's shapes launch
// latency.  Each gathered row is d elements (4, 1 or 2 bytes) read once
// for 3*d flops, at most 3 flops per byte.  At the main path's shapes
// (Q = 64, M = 32..128, d = 128) one call moves 0.3-4 MB, which the card's
// memory moves in about a microsecond, so the few-microsecond launch
// dominates.
//
// Design: the TPU kernels steer one (1, d) row DMA per grid step from
// scalar-prefetched ids.  Here one warp owns one gathered row (score.cuh's
// row_d2, which the fused beam of beam.cu shares): lanes stride over d
// (neighbouring lanes on neighbouring elements, one coalesced line per warp
// load, any d), accumulate (x*scale - q)^2 with FMAs and reduce with
// shuffles.  gather_dist spreads the Q*M rows over blocks of 8 warps.
// The top-k kernels run one block per query: its warps write each
// position's packed (dist, position) key to shared memory and the block
// bitonic-sorts them.  Where next_pow2(max(M, k)) keys fit one tile
// (TILE_MAX) one sort does it; past that the block folds M in tiles into a
// running best next_pow2(k) keys (as range_scan's merge does), so any M
// fits; and for k > SMEM_K (the rerank only: gather_topk keeps the
// reference's k <= 128) each block of a (S, Q) grid sorts TILE_MAX keys
// into a scratch row that a bitonic merge in global memory finishes, so
// any k stays in the kernel.  The wrapper picks the plan (kernels/
// gather_dist.py::topk_plan) and passes it in.
#include <cuda_runtime.h>
#include <stdint.h>

#include "corpus.cuh"
#include "score.cuh"
#include "topk_key.cuh"

#define THREADS 256

template <typename T>
__global__ void gather_dist_kernel(const T* __restrict__ x,
                                   const float* __restrict__ scale,
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
  const float s =
      row_d2(x + (size_t)id * d, scale, q + (size_t)qi * d, d, lane);
  if (lane == 0) out[row] = s;
}

// The (dist, position) key of position pos of query row idr, or KEY_NONE
// past M or for a masked id; one warp, the key valid in every lane.
template <typename T>
__device__ __forceinline__ key_t64 position_key(
    const T* __restrict__ x, const float* __restrict__ scale,
    const int* __restrict__ idr, const float* __restrict__ qr, int N, int d,
    int M, int pos, int lane) {
  const int id = pos < M ? idr[pos] : -1;
  if (id < 0) return KEY_NONE;  // warp-uniform
  const int idc = id > N - 1 ? N - 1 : id;
  return make_key(row_d2(x + (size_t)idc * d, scale, qr, d, lane),
                  (uint32_t)pos);
}

// One block per query.  buf holds SZ keys: the running best P (P = 0 when
// one tile of SZ >= max(M, k) positions covers the row) and a tile of
// SZ - P new positions; after each sort the best P lead the buffer.
template <typename T>
__global__ void topk_block_kernel(const T* __restrict__ x,
                                  const float* __restrict__ scale,
                                  const int* __restrict__ ids,
                                  const float* __restrict__ q,
                                  int* __restrict__ out_ids,
                                  float* __restrict__ out_d, int N, int d,
                                  int M, int k, int P, int SZ) {
  extern __shared__ __align__(16) unsigned char smem[];
  key_t64* buf = reinterpret_cast<key_t64*>(smem);
  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int* idr = ids + (size_t)qi * M;
  const float* qr = q + (size_t)qi * d;
  for (int i = threadIdx.x; i < P; i += blockDim.x) buf[i] = KEY_NONE;
  const int tile = SZ - P;
  int t0 = 0;
  do {
    for (int p = warp; p < tile; p += nwarps) {
      const key_t64 key =
          position_key(x, scale, idr, qr, N, d, M, t0 + p, lane);
      if (lane == 0) buf[P + p] = key;
    }
    bitonic_sort(buf, SZ);
    t0 += tile;
  } while (t0 < M);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const key_t64 key = buf[i];
    const bool fin = key_finite(key);
    out_ids[(size_t)qi * k + i] = fin ? idr[key_index(key)] : -1;
    out_d[(size_t)qi * k + i] = fin ? key_dist(key) : __uint_as_float(INF_BITS);
  }
}

// Global-memory top-k, pass 1: block (c, i) sorts the keys of positions
// [c*R, (c+1)*R) of query i and writes all R to keys[i, c*R ...].
__global__ void topk_runs_kernel(const float* __restrict__ x,
                                 const int* __restrict__ ids,
                                 const float* __restrict__ q,
                                 key_t64* __restrict__ keys, int N, int d,
                                 int M, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  key_t64* buf = reinterpret_cast<key_t64*>(smem);
  const int c = blockIdx.x;
  const int qi = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int* idr = ids + (size_t)qi * M;
  const float* qr = q + (size_t)qi * d;
  for (int p = warp; p < R; p += nwarps) {
    const key_t64 key = position_key(x, (const float*)nullptr, idr, qr, N, d,
                                     M, c * R + p, lane);
    if (lane == 0) buf[p] = key;
  }
  bitonic_sort(buf, R);
  key_t64* out = keys + (size_t)qi * gridDim.x * R + (size_t)c * R;
  for (int i = threadIdx.x; i < R; i += blockDim.x) out[i] = buf[i];
}

// Global-memory top-k, last pass: the first k keys of each sorted row of C
// keys as the input ids at their positions, -1/+inf past C.
__global__ void topk_emit_kernel(const key_t64* __restrict__ keys, int C,
                                 const int* __restrict__ ids, int M, int k,
                                 int* __restrict__ out_ids,
                                 float* __restrict__ out_d) {
  const int qi = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const key_t64 key = i < C ? keys[(size_t)qi * C + i] : KEY_NONE;
  const bool fin = key_finite(key);
  out_ids[(size_t)qi * k + i] =
      fin ? ids[(size_t)qi * M + key_index(key)] : -1;
  out_d[(size_t)qi * k + i] = fin ? key_dist(key) : __uint_as_float(INF_BITS);
}

template <typename T>
static int launch_topk_block(const T* x, const float* scale, const int* ids,
                             const float* q, int* out_ids, float* out_d,
                             int N, int d, int Q, int M, int k, int P, int SZ,
                             cudaStream_t st) {
  const size_t smem = (size_t)SZ * sizeof(key_t64);
  const int rc = set_smem((const void*)topk_block_kernel<T>, smem);
  if (rc) return rc;
  topk_block_kernel<T><<<Q, THREADS, smem, st>>>(x, scale, ids, q, out_ids,
                                                 out_d, N, d, M, k, P, SZ);
  return (int)cudaGetLastError();
}

// x: (N, d) elements of `dtype` (DT_F32, DT_INT8 or DT_BF16); scale: (d,)
// f32 or null.  Returns the first CUDA error, 0 on success.
extern "C" int gather_dist_launch(const void* x, int dtype,
                                  const float* scale, const int* ids,
                                  const float* q, float* out, int N, int d,
                                  int Q, int M, void* stream) {
  const long long QM = (long long)Q * M;
  const long long blocks = (QM * 32 + THREADS - 1) / THREADS;
  DISPATCH_CORPUS(dtype, T, {
    gather_dist_kernel<T>
        <<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
            static_cast<const T*>(x), scale, ids, q, out, N, d, QM, M);
  });
  return (int)cudaGetLastError();
}

// The block plan (P, SZ) from the wrapper: SZ a power of two, P = 0 with
// SZ >= max(M, k), or P = next_pow2(k) < SZ.  The wrapper enforces the
// reference's bound (k <= 128).
extern "C" int gather_topk_launch(const void* x, int dtype,
                                  const float* scale, const int* ids,
                                  const float* q, int* out_ids, float* out_d,
                                  int N, int d, int Q, int M, int k, int P,
                                  int SZ, void* stream) {
  int rc = 0;
  DISPATCH_CORPUS(dtype, T, {
    rc = launch_topk_block(static_cast<const T*>(x), scale, ids, q, out_ids,
                           out_d, N, d, Q, M, k, P, SZ,
                           (cudaStream_t)stream);
  });
  return rc;
}

// f32 corpus.  S = 0: the block plan (P, SZ) as for gather_topk.  S > 0:
// the global plan over a (Q, S*R) scratch, S a power of two, S*R >= M.
extern "C" int gather_rerank_launch(const float* x, const int* ids,
                                    const float* q, int* out_ids,
                                    float* out_d, key_t64* scratch, int N,
                                    int d, int Q, int M, int k, int P, int SZ,
                                    int R, int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 0)
    return launch_topk_block(x, (const float*)nullptr, ids, q, out_ids, out_d,
                             N, d, Q, M, k, P, SZ, st);
  const size_t smem = (size_t)R * sizeof(key_t64);
  int rc = set_smem((const void*)topk_runs_kernel, smem);
  if (rc) return rc;
  topk_runs_kernel<<<dim3(S, Q), THREADS, smem, st>>>(x, ids, q, scratch, N,
                                                       d, M, R);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int C = S * R;
  rc = merge_sorted_runs(scratch, C, R, Q, st);
  if (rc) return rc;
  topk_emit_kernel<<<dim3((k + THREADS - 1) / THREADS, Q), THREADS, 0, st>>>(
      scratch, C, ids, M, k, out_ids, out_d);
  return (int)cudaGetLastError();
}
