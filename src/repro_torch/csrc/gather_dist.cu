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
// gather_topk: the same distances with ids < 0 masked to +inf, then the k
// smallest by (dist, input position); output ids are the input ids at
// those positions, -1/+inf padded.
// gather_rerank: the same over an f32 corpus, the k smallest by (dist, id):
// ties go to the lower id in whatever order the ids arrive (on the
// reference's contract, ids ascending with -1 last, that is its tie toward
// the lower position); an id >= N reads row N-1 and keeps its own id;
// duplicate ids keep every copy.
//
// What bounds them on an H100: bytes, and at the beam's shapes latency.
// Each gathered row is d elements (4, 1 or 2 bytes) read once for 3*d
// flops, at most 3 flops per byte.  At the main path's shapes (Q = 64,
// M = 32..128, d = 128) one call moves 0.3-4 MB, which the card's memory
// moves in about a microsecond, so the chain of dependent memory round
// trips (ids, then rows) and the launch dominate.
//
// The TPU kernels steer one (1, d) row DMA per grid step from
// scalar-prefetched ids.  gather_dist and gather_topk: one warp owns one
// gathered row (score.cuh's row_d2, which the fused beam of beam.cu
// shares): lanes stride over d, accumulate (x*scale - q)^2 with FMAs and
// reduce with shuffles.  gather_dist spreads the Q*M rows over blocks of 8
// warps; gather_topk runs one block per query, whose warps write each
// position's packed (dist, position) key to shared memory for a block
// bitonic sort (a running best past TILE_MAX keys).
//
// gather_rerank for k <= SELECT_K = 256 (the main path: k = 10), one
// launch of gather_rerank_select, grid (Q, S):
//   * Chunks.  Block (i, c) owns positions [c*R, (c+1)*R) of query i's ids
//     (kernels/gather_dist.py::rerank_plan picks R, about 256 KB of rows,
//     and S; this source holds no k or M threshold).  It stages the
//     chunk's ids in shared memory with one coalesced load and the query,
//     zero-padded to a multiple of 128, beside them, so no row load waits
//     on a dependent id load.
//   * Rows in flight.  A warp is four groups of 8 lanes, each group one
//     row: per 128-element segment each lane starts its 16-byte loads (4)
//     for U = RERANK_U rows before any arithmetic, so a lane has 16 loads
//     in flight and a block 128 rows.  Rows are unpadded (n, d): the last
//     segment is masked past d (x and the padded query both read as 0
//     there), and where d % 4 != 0 or x is not 16-byte aligned the wrapper
//     picks the instance with scalar loads (each lane elements g, g+8, ...
//     of a segment).  The sum is the difference form in f32, each group
//     folding its 8 partial sums with three shuffles.
//   * k without a sort: select.cuh's per-warp threshold lists, 64-key
//     ballot queue and pairwise block merge (range_scan.cu's), keyed on
//     (dist, id); negative ids and positions past M are never scored.
//   * One launch.  A query one chunk covers is emitted by its block; else
//     the last block of the query to arrive merges the S chunk lists
//     (select.cuh's finish_select over a (Q, S, k) scratch and a
//     self-resetting per-query arrival counter).
// k > 256 (off the main path): topk_block_kernel keyed on (dist, id), one
// block per query, while next_pow2(k) keys fit shared memory; else each
// block of a (S, Q) grid sorts TILE_MAX keys into a scratch row that a
// bitonic merge in global memory finishes, so any k stays in the kernel.
// The wrapper (kernels/gather_dist.py::rerank_plan, and topk_plan that
// gather_topk shares) picks the path and its sizes and passes them in.
#include <cuda_runtime.h>
#include <stdint.h>

#include "corpus.cuh"
#include "score.cuh"
#include "topk_key.cuh"

#define THREADS 256
#define NWARPS (THREADS / 32)
// per-warp candidate queue of the rerank's select (select.cuh)
#define QCAP 64
// rows each 8-lane group of gather_rerank_select has in flight
#define RERANK_U 4

#include "select.cuh"

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

// The key of position pos of query row idr, or KEY_NONE past M or for a
// masked id; one warp, the key valid in every lane.  BY_ID: (dist, id), the
// rerank's; else (dist, position), gather_topk's.
template <typename T, bool BY_ID>
__device__ __forceinline__ key_t64 position_key(
    const T* __restrict__ x, const float* __restrict__ scale,
    const int* __restrict__ idr, const float* __restrict__ qr, int N, int d,
    int M, int pos, int lane) {
  const int id = pos < M ? idr[pos] : -1;
  if (id < 0) return KEY_NONE;  // warp-uniform
  const int idc = id > N - 1 ? N - 1 : id;
  return make_key(row_d2(x + (size_t)idc * d, scale, qr, d, lane),
                  BY_ID ? (uint32_t)id : (uint32_t)pos);
}

// One block per query.  buf holds SZ keys: the running best P (P = 0 when
// one tile of SZ >= max(M, k) positions covers the row) and a tile of
// SZ - P new positions; after each sort the best P lead the buffer.
template <typename T, bool BY_ID>
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
          position_key<T, BY_ID>(x, scale, idr, qr, N, d, M, t0 + p, lane);
      if (lane == 0) buf[P + p] = key;
    }
    bitonic_sort(buf, SZ);
    t0 += tile;
  } while (t0 < M);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const key_t64 key = buf[i];
    if (BY_ID) {
      emit(key, out_ids + (size_t)qi * k + i, out_d + (size_t)qi * k + i);
    } else {
      const bool fin = key_finite(key);
      out_ids[(size_t)qi * k + i] = fin ? idr[key_index(key)] : -1;
      out_d[(size_t)qi * k + i] =
          fin ? key_dist(key) : __uint_as_float(INF_BITS);
    }
  }
}

// The rerank past one block, pass 1: block (c, i) sorts the (dist, id)
// keys of positions [c*R, (c+1)*R) of query i and writes all R to
// keys[i, c*R ...].
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
    const key_t64 key = position_key<float, true>(
        x, (const float*)nullptr, idr, qr, N, d, M, c * R + p, lane);
    if (lane == 0) buf[p] = key;
  }
  bitonic_sort(buf, R);
  key_t64* out = keys + (size_t)qi * gridDim.x * R + (size_t)c * R;
  for (int i = threadIdx.x; i < R; i += blockDim.x) out[i] = buf[i];
}

// The rerank past one block, last pass: the first k keys of each sorted row
// of C keys, -1/+inf past C.
__global__ void topk_emit_kernel(const key_t64* __restrict__ keys, int C,
                                 int k, int* __restrict__ out_ids,
                                 float* __restrict__ out_d) {
  const int qi = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  emit(i < C ? keys[(size_t)qi * C + i] : KEY_NONE,
       out_ids + (size_t)qi * k + i, out_d + (size_t)qi * k + i);
}

// grid (Q, S), THREADS threads; block (i, c) scores positions [c*R,
// min((c+1)*R, M)) of query i.  VEC: 16-byte row loads (d % 4 == 0, x
// 16-byte aligned); else scalar loads.  Dynamic shared memory: NWARPS * 2 *
// k list keys, NWARPS * QCAP queue keys, the query zero-padded to nseg * 128
// floats, then the chunk's R ids.  partial: (Q, S, k) keys and arrivals:
// (Q,) ints (all 0 before the launch, and again after it), both unused when
// S = 1.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    gather_rerank_select(const float* __restrict__ x,
                         const int* __restrict__ ids,
                         const float* __restrict__ q,
                         key_t64* __restrict__ partial, int* arrivals,
                         int* __restrict__ out_ids, float* __restrict__ out_d,
                         int N, int d, int M, int R, int k) {
  constexpr int U = RERANK_U;
  extern __shared__ __align__(16) unsigned char smem[];
  key_t64* bufs = reinterpret_cast<key_t64*>(smem);
  key_t64* queues = bufs + NWARPS * 2 * k;
  float* qs = reinterpret_cast<float*>(queues + NWARPS * QCAP);
  const int nseg = (d + 127) >> 7;
  int* cid = reinterpret_cast<int*>(qs + nseg * 128);
  __shared__ int cur[NWARPS];

  const int qi = blockIdx.x;
  const int c = blockIdx.y;
  const int S = gridDim.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane & 7;     // lane within its 8-lane group
  const int grp = lane >> 3;  // the group's row within each step

  const int p0 = c * R;
  const int n = min(R, M - p0);  // positions of this chunk
  const int* idr = ids + (size_t)qi * M + p0;
  for (int i = threadIdx.x; i < n; i += THREADS) cid[i] = idr[i];
  const float* qrow = q + (size_t)qi * d;
  for (int e = threadIdx.x; e < nseg * 128; e += THREADS)
    qs[e] = e < d ? qrow[e] : 0.f;

  WarpTopk top;
  top.list = bufs + 2 * warp * k;
  top.alt = top.list + k;
  top.queue = queues + warp * QCAP;
  top.k = k;
  top.reset(lane);
  __syncthreads();

  for (int t0 = warp * 4 * U; t0 < n; t0 += NWARPS * 4 * U) {
    const float* rp[U];
    int id[U];
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = t0 + 4 * u + grp;
      id[u] = r < n ? cid[r] : -1;
      // an id >= N reads row N - 1 (the plain version's clip)
      rp[u] = id[u] >= 0 ? x + (size_t)min(id[u], N - 1) * d : nullptr;
      acc[u] = 0.f;
    }
    for (int seg = 0; seg < nseg; ++seg) {
      const float* qseg = qs + seg * 128;
      if (VEC) {
        // lane g: float4s g, g + 8, g + 16, g + 24 of the segment; d % 4 == 0,
        // so a float4 lies wholly before d or wholly past it
        float4 v[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = seg * 128 + 4 * (g + 8 * i);
            v[u][i] = rp[u] != nullptr && e < d
                          ? __ldg(reinterpret_cast<const float4*>(rp[u] + e))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qseg + 4 * (g + 8 * i));
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float df = v[u][i].x - qv.x;
            acc[u] = fmaf(df, df, acc[u]);
            df = v[u][i].y - qv.y;
            acc[u] = fmaf(df, df, acc[u]);
            df = v[u][i].z - qv.z;
            acc[u] = fmaf(df, df, acc[u]);
            df = v[u][i].w - qv.w;
            acc[u] = fmaf(df, df, acc[u]);
          }
        }
      } else {
        // lane g: elements g, g + 8, ..., g + 120 of the segment
        float v[U][16];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int e = seg * 128 + g + 8 * j;
            v[u][j] = rp[u] != nullptr && e < d ? __ldg(rp[u] + e) : 0.f;
          }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float qv = qseg[g + 8 * j];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float df = v[u][j] - qv;
            acc[u] = fmaf(df, df, acc[u]);
          }
        }
      }
    }
    if (top.qc > QCAP - 4 * U) top.flush(lane);  // warp-uniform
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
      const key_t64 key = make_key(acc[u], (uint32_t)id[u]);
      top.push(id[u] >= 0 && g == 0 && key < top.thr, key, lane);
    }
  }
  if (top.qc > 0) top.flush(lane);
  if (lane == 0) cur[warp] = top.list == bufs + 2 * warp * k ? 0 : 1;
  const key_t64* res = block_merge(bufs, cur, k, warp, lane);
  __syncthreads();
  finish_select(res, bufs, cur, top, partial, arrivals, qi, c, S, k,
                out_ids + (size_t)qi * k, out_d + (size_t)qi * k, warp,
                lane);
}

template <typename T, bool BY_ID>
static int launch_topk_block(const T* x, const float* scale, const int* ids,
                             const float* q, int* out_ids, float* out_d,
                             int N, int d, int Q, int M, int k, int P, int SZ,
                             cudaStream_t st) {
  const size_t smem = (size_t)SZ * sizeof(key_t64);
  const int rc = set_smem((const void*)topk_block_kernel<T, BY_ID>, smem);
  if (rc) return rc;
  topk_block_kernel<T, BY_ID><<<Q, THREADS, smem, st>>>(
      x, scale, ids, q, out_ids, out_d, N, d, M, k, P, SZ);
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
    rc = launch_topk_block<T, false>(static_cast<const T*>(x), scale, ids,
                                     q, out_ids, out_d, N, d, Q, M, k, P, SZ,
                                     (cudaStream_t)stream);
  });
  return rc;
}

// The paths of gather_rerank_launch, as kernels/gather_dist.py numbers them.
enum { PATH_SELECT = 0, PATH_BLOCK = 1, PATH_RUNS = 2 };

// f32 corpus (N, d); ids (Q, M) int32; q (Q, d).  The wrapper
// (kernels/gather_dist.py::rerank_plan) picks the path and its sizes:
//   PATH_SELECT: S chunks of R positions; vec: 16-byte row loads (d % 4 ==
//     0 and x 16-byte aligned); scratch: (Q, S, k) keys and arrivals: (Q,)
//     ints, 0 before the call and left 0 after it (both unused when S = 1);
//   PATH_BLOCK: one block per query, the block plan (P, SZ) of gather_topk;
//   PATH_RUNS: S (a power of two) sorted runs of R keys per query in a
//     (Q, S*R) scratch, merged in global memory.
// Returns the first CUDA error, 0 on success.
extern "C" int gather_rerank_launch(int path, int vec, const float* x,
                                    const int* ids, const float* q,
                                    int* out_ids, float* out_d,
                                    key_t64* scratch, int* arrivals, int N,
                                    int d, int Q, int M, int k, int R, int S,
                                    int P, int SZ, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  if (path == PATH_SELECT) {
    const size_t smem = (size_t)NWARPS * (2 * k + QCAP) * sizeof(key_t64) +
                        (size_t)((d + 127) / 128) * 128 * sizeof(float) +
                        (size_t)R * sizeof(int);
    const void* fn = vec ? (const void*)gather_rerank_select<true>
                         : (const void*)gather_rerank_select<false>;
    rc = set_smem(fn, smem);
    if (rc) return rc;
    if (vec)
      gather_rerank_select<true><<<dim3(Q, S), THREADS, smem, st>>>(
          x, ids, q, scratch, arrivals, out_ids, out_d, N, d, M, R, k);
    else
      gather_rerank_select<false><<<dim3(Q, S), THREADS, smem, st>>>(
          x, ids, q, scratch, arrivals, out_ids, out_d, N, d, M, R, k);
    return (int)cudaGetLastError();
  }
  if (path == PATH_BLOCK)
    return launch_topk_block<float, true>(x, (const float*)nullptr, ids, q,
                                          out_ids, out_d, N, d, Q, M, k, P,
                                          SZ, st);
  // the bitonic networks below need pow2 sizes
  if (path != PATH_RUNS || (R & (R - 1)) || (S & (S - 1)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)R * sizeof(key_t64);
  rc = set_smem((const void*)topk_runs_kernel, smem);
  if (rc) return rc;
  topk_runs_kernel<<<dim3(S, Q), THREADS, smem, st>>>(x, ids, q, scratch, N,
                                                       d, M, R);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int C = S * R;
  rc = merge_sorted_runs(scratch, C, R, Q, st);
  if (rc) return rc;
  topk_emit_kernel<<<dim3((k + THREADS - 1) / THREADS, Q), THREADS, 0, st>>>(
      scratch, C, k, out_ids, out_d);
  return (int)cudaGetLastError();
}
