// range_scan: fused masked L2 scan + top-k over contiguous rank windows.
//
// Replaces src/repro/kernels/range_scan.py::range_scan_pallas: an f32,
// int8 or bf16 corpus with an optional per-dimension f32 scale (the int8
// copy's dequant factors), n_valid and live masks.
//
// What it computes, per query i: squared L2 in the expansion form
// max(|q|^2 - 2 q.x + |x|^2, 0), x dequantized to f32 (x * scale) first,
// over the rows of window_rows(bucket) ranks starting at the 128-aligned
// block at or below starts[i], masked to ranks in [start, start+len), below
// n_valid, below the window end, and with live[rank] != 0; returns the k
// smallest by (dist, rank), -1/+inf padded.
//
// What bounds it on an H100: bytes.  Each scored row is d_pad elements read
// once (4, 1 or 2 bytes each) and takes 4*d_pad flops (two FMAs per
// element), at most 4 flops per byte (int8), far below the card's
// 67 TFLOP/s f32 over 3.35 TB/s (20 flops per byte).  Every design below
// reads each in-window row once per query, never reads a masked row or a
// row at or past n_pad, and skips what misses the window.  The (Q, W)
// distance matrix is never written: selection happens on chip.
//
// The TPU kernel walks a window's row blocks in order on one core and
// folds each into a running top-k; GPU blocks run in parallel and in no
// order.  Blocks own (query, chunk of R window rows); the rank rides in
// the packed (dist, rank) key, so ties break toward the lower rank
// whatever order the blocks finish in.  The wrapper sizes R
// (kernels/range_scan.py::scan_plan): on the select path about 256 KB of
// rows per block (512 f32 rows at d_pad = 128, 2048 int8), so a block's
// fixed cost, its merges, stays small beside its loads.
//
// The wrapper (kernels/range_scan.py::scan_plan) owns the choice of path
// and passes it to the launcher with R and S.
//
// k <= SELECT_K = 256 (kernels/range_scan.py), the select path (the main
// path: k = 10, and the quantized scan's rerank_depth = 128): one launch,
// range_scan_select.
//   * Rows in flight.  A warp is four groups of 8 lanes, each group one row:
//     per 128-element segment of a row, each lane issues 16-byte loads
//     (4 for f32, 2 for bf16, 1 for int8) for U = 8 / sizeof(T) rows before
//     any arithmetic, so every lane has 8 loads (128 bytes) in flight and a
//     warp 4U rows; the group folds its partial sums with three shuffles.
//     The query (and the scale) sit in shared memory permuted so each lane
//     reads its own 16 values as 4 conflict-free float4s.
//   * No sort to keep k (select.cuh, shared with gather_dist.cu's rerank).
//     Each warp keeps a sorted list of k keys and its k-th key as a
//     threshold; a row enters only if its key beats the threshold, through
//     a 64-key per-warp queue (ballot + popc slots).  A full queue is
//     bitonic-sorted within the warp and merged into the list by rank
//     (each key's place is its index plus a binary search in the other
//     list), which also tightens the threshold.  The block folds its 8
//     warp lists in three pairwise rank merges.
//   * One launch.  A window one chunk covers is emitted by its block.  Else
//     each block writes its k keys to a (Q, S, k) scratch and takes a
//     ticket from a per-query arrival counter (threadfence, atomicAdd); the
//     last block of the query feeds the S sorted lists through the same
//     threshold queue (a list is left at its first key that misses the
//     threshold), merges, emits, and sets the counter back to 0 for the
//     next launch.
//
// 256 < k: two passes, off the main path.  Pass 1 (range_scan_partial,
// grid (Q, S)) scores R rows per block, one warp per row, bitonic-sorts the
// R keys and writes its kc = min(k, R) best; while 2*next_pow2(k) keys fit
// shared memory (next_pow2(k) <= 2048) range_scan_merge folds each query's S*kc
// candidates through a bitonic-sorted buffer; past that, pass 1 keeps
// whole chunks over a pow2 number of chunks, a bitonic merge in global
// memory (merge_sorted_runs) sorts each row, and range_scan_emit writes
// the first k.
#include <cuda_runtime.h>
#include <stdint.h>

#include "corpus.cuh"
#include "topk_key.cuh"

#define THREADS 256
#define NWARPS (THREADS / 32)
// per-warp candidate queue (keys that beat the warp's threshold)
#define QCAP 64

#include "select.cuh"

// --- the select path (k <= 256) ----------------------------------------

// Word i of a 16-byte vector (i a compile-time constant after unrolling).
__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// Element m of a 16-byte vector of T, upcast to f32 (exact).
template <typename T>
__device__ __forceinline__ float vec_elem(const uint4& r, int m);
template <>
__device__ __forceinline__ float vec_elem<float>(const uint4& r, int m) {
  return __uint_as_float(word(r, m));
}
template <>
__device__ __forceinline__ float vec_elem<bf16_bits>(const uint4& r, int m) {
  const uint32_t v = word(r, m >> 1);
  return __uint_as_float((m & 1) ? (v & 0xFFFF0000u) : (v << 16));
}
template <>
__device__ __forceinline__ float vec_elem<int8_t>(const uint4& r, int m) {
  // sign-extend byte m & 3 of its word
  return (float)((int)(word(r, m >> 2) << (24 - 8 * (m & 3))) >> 24);
}

// The row element that float4 slot j (0..3) of lane g (0..7 in its group)
// starts at, within a 128-element segment: the lane loads 16-byte vectors
// g, g + 8, ... of the segment, and its 16 elements fill 4 float4 slots.
template <typename T>
__device__ __forceinline__ int lane_elem(int g, int j) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int F = E / 4;           // float4 slots per vector
  return (g + 8 * (j / F)) * E + (j % F) * 4;
}

// grid (Q, S), THREADS threads; block (i, c) scores window rows
// [c*R, (c+1)*R) of query i.  Dynamic shared memory: NWARPS * 2 * k list
// keys, NWARPS * QCAP queue keys, then the permuted query and scale
// (d_pad floats each).  partial: (Q, S, k) keys and arrivals: (Q,) ints
// (all 0 before the launch, and again after it), both unused when S = 1.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    range_scan_select(const T* __restrict__ x,
                      const float* __restrict__ scale,
                      const int* __restrict__ starts,
                      const int* __restrict__ lens,
                      const float* __restrict__ q,
                      const int* __restrict__ live,
                      key_t64* __restrict__ partial, int* arrivals,
                      int* __restrict__ out_ids, float* __restrict__ out_d,
                      int n_pad, int d_pad, int n_valid, int tb, int w,
                      int R, int k) {
  constexpr int V = sizeof(T);      // 16-byte loads per lane per segment
  constexpr int E = 16 / sizeof(T); // elements per 16-byte load
  constexpr int U = 8 / sizeof(T);  // rows per group per step
  extern __shared__ __align__(16) unsigned char smem[];
  key_t64* bufs = reinterpret_cast<key_t64*>(smem);
  key_t64* queues = bufs + NWARPS * 2 * k;
  float4* qp = reinterpret_cast<float4*>(queues + NWARPS * QCAP);
  float4* sp = qp + d_pad / 4;
  __shared__ float qn_s;
  __shared__ int cur[NWARPS];

  const int qi = blockIdx.x;
  const int c = blockIdx.y;
  const int S = gridDim.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane & 7;    // lane within its 8-lane group
  const int grp = lane >> 3; // the group's row within each step

  const long long start = starts[qi];
  const long long len = lens[qi];
  const long long base = (start / tb) * tb;
  const long long lo_rank = base + (long long)c * R;
  long long hi = start + len;
  hi = min(hi, (long long)n_valid);
  hi = min(hi, (long long)n_pad);
  hi = min(hi, base + w);
  hi = min(hi, lo_rank + R);
  const long long lo = max(lo_rank, start);

  WarpTopk top;
  top.list = bufs + 2 * warp * k;
  top.alt = top.list + k;
  top.queue = queues + warp * QCAP;
  top.k = k;
  top.reset(lane);

  const key_t64* res = bufs;  // warp 0's list: all pads for an empty chunk
  if (lo < hi) {  // block-uniform
    const float* qrow = q + (size_t)qi * d_pad;
    for (int e4 = threadIdx.x; e4 < d_pad / 4; e4 += THREADS) {
      // slot e4 = (segment * 4 + j) * 8 + lane-in-group
      const int e = (e4 >> 5) * 128 + lane_elem<T>(e4 & 7, (e4 >> 3) & 3);
      qp[e4] = *reinterpret_cast<const float4*>(qrow + e);
      sp[e4] = scale != nullptr
                   ? *reinterpret_cast<const float4*>(scale + e)
                   : make_float4(1.f, 1.f, 1.f, 1.f);  // x * 1 == x
    }
    if (warp == 0) {
      float s = 0.f;
      for (int j = lane; j < d_pad; j += 32) s = fmaf(qrow[j], qrow[j], s);
      s = warp_sum(s);
      if (lane == 0) qn_s = s;
    }
    __syncthreads();
    const float qn = qn_s;
    const int nseg = d_pad >> 7;
    const int first = (int)(lo - lo_rank), last = (int)(hi - lo_rank);
    for (int t0 = warp * 4 * U; t0 < last; t0 += NWARPS * 4 * U) {
      if (t0 + 4 * U <= first) continue;  // warp-uniform
      const T* rp[U];
      bool ok[U];
      float dot[U], xn[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = t0 + 4 * u + grp;
        ok[u] = r >= first && r < last;
        if (ok[u] && live != nullptr) ok[u] = live[lo_rank + r] != 0;
        rp[u] = x + (lo_rank + r) * (long long)d_pad;
        dot[u] = 0.f;
        xn[u] = 0.f;
      }
      for (int seg = 0; seg < nseg; ++seg) {
        uint4 raw[U][V];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int i = 0; i < V; ++i)
            raw[u][i] = ok[u] ? __ldg(reinterpret_cast<const uint4*>(
                                          rp[u] + seg * 128) + g + 8 * i)
                              : make_uint4(0, 0, 0, 0);
        float qf[16], sf[16];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 a = qp[(seg * 4 + j) * 8 + g];
          const float4 b = sp[(seg * 4 + j) * 8 + g];
          qf[4 * j] = a.x; qf[4 * j + 1] = a.y;
          qf[4 * j + 2] = a.z; qf[4 * j + 3] = a.w;
          sf[4 * j] = b.x; sf[4 * j + 1] = b.y;
          sf[4 * j + 2] = b.z; sf[4 * j + 3] = b.w;
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int i = 0; i < V; ++i)
#pragma unroll
            for (int t = 0; t < E; ++t) {
              // rounded as x * scale, apart from the sums
              const float v = __fmul_rn(vec_elem<T>(raw[u][i], t),
                                        sf[i * E + t]);
              dot[u] = fmaf(qf[i * E + t], v, dot[u]);
              xn[u] = fmaf(v, v, xn[u]);
            }
      }
      if (top.qc > QCAP - 4 * U) top.flush(lane);  // warp-uniform
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) {
          dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], o);
          xn[u] += __shfl_xor_sync(0xffffffffu, xn[u], o);
        }
        float dist = (-2.f * dot[u] + qn) + xn[u];
        dist = dist > 0.f ? dist : 0.f;  // clamp; also maps -0.0 to +0.0
        const key_t64 key =
            make_key(dist, (uint32_t)(lo_rank + t0 + 4 * u + grp));
        top.push(ok[u] && g == 0 && key < top.thr, key, lane);
      }
    }
    if (top.qc > 0) top.flush(lane);
    if (lane == 0) cur[warp] = top.list == bufs + 2 * warp * k ? 0 : 1;
    res = block_merge(bufs, cur, k, warp, lane);
  }
  __syncthreads();
  finish_select(res, bufs, cur, top, partial, arrivals, qi, c, S, k,
                out_ids + (size_t)qi * k, out_d + (size_t)qi * k, warp,
                lane);
}

// --- the two-pass path (k > 256) ----------------------------------------

template <typename T>
__global__ void range_scan_partial(const T* __restrict__ x,
                                   const float* __restrict__ scale,
                                   const int* __restrict__ starts,
                                   const int* __restrict__ lens,
                                   const float* __restrict__ q,
                                   const int* __restrict__ live,
                                   key_t64* __restrict__ partial, int n_pad,
                                   int d_pad, int n_valid, int tb, int w,
                                   int R, int kc) {
  extern __shared__ __align__(16) unsigned char smem[];
  key_t64* keys = reinterpret_cast<key_t64*>(smem);
  float* qs = reinterpret_cast<float*>(keys + R);
  float* ss = qs + d_pad;  // the scale, when there is one
  __shared__ float qn_s;

  const int qi = blockIdx.x;
  const int c = blockIdx.y;
  const int S = gridDim.y;
  key_t64* out = partial + ((size_t)qi * S + c) * kc;

  const long long start = starts[qi];
  const long long len = lens[qi];
  const long long base = (start / tb) * tb;
  const long long lo_rank = base + (long long)c * R;
  long long hi = start + len;
  hi = min(hi, (long long)n_valid);
  hi = min(hi, (long long)n_pad);
  hi = min(hi, base + w);
  hi = min(hi, lo_rank + R);
  const long long lo = max(lo_rank, start);
  if (lo >= hi) {  // chunk misses the window: nothing to read
    for (int i = threadIdx.x; i < kc; i += blockDim.x) out[i] = KEY_NONE;
    return;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* qrow = q + (size_t)qi * d_pad;
  for (int j = threadIdx.x; j < d_pad; j += blockDim.x) qs[j] = qrow[j];
  if (scale != nullptr)
    for (int j = threadIdx.x; j < d_pad; j += blockDim.x) ss[j] = scale[j];
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int j = lane; j < d_pad; j += 32) s = fmaf(qs[j], qs[j], s);
    s = warp_sum(s);
    if (lane == 0) qn_s = s;
  }
  __syncthreads();
  const float qn = qn_s;

  const int d4 = d_pad >> 2;  // d_pad % 128 == 0
  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  const float4* ss4 = reinterpret_cast<const float4*>(ss);
  for (int r = warp; r < R; r += nwarps) {
    const long long rank = lo_rank + r;
    // warp-uniform: every lane of the warp sees the same rank
    bool ok = rank >= lo && rank < hi;
    if (ok && live != nullptr) ok = live[rank] != 0;
    if (!ok) {
      if (lane == 0) keys[r] = KEY_NONE;
      continue;
    }
    const T* xr = x + rank * d_pad;
    float dot = 0.f, xn = 0.f;
    for (int j = lane; j < d4; j += 32) {
      float4 xv = load4(xr, j);
      if (scale != nullptr) {  // block-uniform; rounded as x * scale
        const float4 sv = ss4[j];
        xv.x = __fmul_rn(xv.x, sv.x);
        xv.y = __fmul_rn(xv.y, sv.y);
        xv.z = __fmul_rn(xv.z, sv.z);
        xv.w = __fmul_rn(xv.w, sv.w);
      }
      const float4 qv = qs4[j];
      dot = fmaf(qv.x, xv.x, dot);
      dot = fmaf(qv.y, xv.y, dot);
      dot = fmaf(qv.z, xv.z, dot);
      dot = fmaf(qv.w, xv.w, dot);
      xn = fmaf(xv.x, xv.x, xn);
      xn = fmaf(xv.y, xv.y, xn);
      xn = fmaf(xv.z, xv.z, xn);
      xn = fmaf(xv.w, xv.w, xn);
    }
    dot = warp_sum(dot);
    xn = warp_sum(xn);
    if (lane == 0) {
      float dist = (-2.f * dot + qn) + xn;
      dist = dist > 0.f ? dist : 0.f;  // clamp; also maps -0.0 to +0.0
      keys[r] = make_key(dist, (uint32_t)rank);
    }
  }
  bitonic_sort(keys, R);
  for (int i = threadIdx.x; i < kc; i += blockDim.x) out[i] = keys[i];
}

__global__ void range_scan_merge(const key_t64* __restrict__ partial, int C,
                                 int k, int P, int SZ,
                                 int* __restrict__ out_ids,
                                 float* __restrict__ out_d) {
  extern __shared__ __align__(16) unsigned char smem[];
  key_t64* buf = reinterpret_cast<key_t64*>(smem);
  const int qi = blockIdx.x;
  const key_t64* cand = partial + (size_t)qi * C;
  for (int i = threadIdx.x; i < P; i += blockDim.x) buf[i] = KEY_NONE;
  const int T = SZ - P;  // new candidates per round
  for (int t0 = 0; t0 < C; t0 += T) {
    for (int i = threadIdx.x; i < T; i += blockDim.x)
      buf[P + i] = (t0 + i < C) ? cand[t0 + i] : KEY_NONE;
    bitonic_sort(buf, SZ);  // the best P now lead the buffer
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    emit(buf[i], out_ids + (size_t)qi * k + i, out_d + (size_t)qi * k + i);
}

// The first k keys of each sorted row of C keys, -1/+inf past C.
__global__ void range_scan_emit(const key_t64* __restrict__ keys, int C,
                                int k, int* __restrict__ out_ids,
                                float* __restrict__ out_d) {
  const int qi = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  emit(i < C ? keys[(size_t)qi * C + i] : KEY_NONE,
       out_ids + (size_t)qi * k + i, out_d + (size_t)qi * k + i);
}

// The paths of range_scan_launch, as kernels/range_scan.py numbers them.
enum { PATH_SELECT = 0, PATH_SMEM_MERGE = 1, PATH_RUN_MERGE = 2 };

// x: (n_pad, d_pad) elements of `dtype` (DT_F32, DT_INT8 or DT_BF16);
// scale: (d_pad,) f32 or null; q, scale and x 16-byte aligned.  The wrapper
// (kernels/range_scan.py::scan_plan) picks the path, R and S:
//   PATH_SELECT: S chunks of R rows (a multiple of 128); partial: (Q, S, k)
//     scratch; arrivals: (Q,) ints, 0 before the call and left 0 after it
//     (both unused when S = 1);
//   PATH_SMEM_MERGE: R a power of two >= k, S = ceil(w / R); partial:
//     (Q, S, kc), kc = min(k, R), merged in a 2 * next_pow2(k)-key buffer;
//   PATH_RUN_MERGE: R and S powers of two, kc = R, and each row of S*R
//     keys is bitonic-merged in place.
// Returns the first CUDA error, 0 on success.
extern "C" int range_scan_launch(int path, const void* x, int dtype,
                                 const float* scale, const int* starts,
                                 const int* lens, const float* q,
                                 const int* live, key_t64* partial,
                                 int* arrivals, int* out_ids, float* out_d,
                                 int n_pad, int d_pad, int Q, int w, int k,
                                 int n_valid, int R, int S, void* stream) {
  const int tb = 128;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  if (path == PATH_SELECT) {
    const size_t smem = (size_t)NWARPS * (2 * k + QCAP) * sizeof(key_t64) +
                        (size_t)2 * d_pad * sizeof(float);
    DISPATCH_CORPUS(dtype, T, {
      rc = set_smem((const void*)range_scan_select<T>, smem);
      if (rc) return rc;
      range_scan_select<T><<<dim3(Q, S), THREADS, smem, st>>>(
          static_cast<const T*>(x), scale, starts, lens, q, live, partial,
          arrivals, out_ids, out_d, n_pad, d_pad, n_valid, tb, w, R, k);
    });
    return (int)cudaGetLastError();
  }
  // the bitonic networks below need pow2 sizes
  if ((path != PATH_SMEM_MERGE && path != PATH_RUN_MERGE) || (R & (R - 1)) ||
      (path == PATH_RUN_MERGE && (S & (S - 1))))
    return (int)cudaErrorInvalidValue;
  const int kc = k < R ? k : R;
  const size_t smem1 = (size_t)R * sizeof(key_t64) +
                       (size_t)d_pad * sizeof(float) * (scale ? 2 : 1);
  DISPATCH_CORPUS(dtype, T, {
    rc = set_smem((const void*)range_scan_partial<T>, smem1);
    if (rc) return rc;
    range_scan_partial<T><<<dim3(Q, S), THREADS, smem1, st>>>(
        static_cast<const T*>(x), scale, starts, lens, q, live, partial,
        n_pad, d_pad, n_valid, tb, w, R, kc);
  });
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  if (path == PATH_SMEM_MERGE) {
    const int P = next_pow2_host(k);
    const int SZ = 2 * P > 1024 ? 2 * P : 1024;
    size_t smem2 = (size_t)SZ * sizeof(key_t64);
    rc = set_smem((const void*)range_scan_merge, smem2);
    if (rc) return rc;
    range_scan_merge<<<Q, THREADS, smem2, st>>>(partial, S * kc, k, P, SZ,
                                                 out_ids, out_d);
    return (int)cudaGetLastError();
  }
  // k past the shared-memory merge: the S runs of R sorted keys per query
  // are merged in global memory, stage by stage
  const int C = S * R;
  rc = merge_sorted_runs(partial, C, R, Q, st);
  if (rc) return rc;
  range_scan_emit<<<dim3((k + THREADS - 1) / THREADS, Q), THREADS, 0, st>>>(
      partial, C, k, out_ids, out_d);
  return (int)cudaGetLastError();
}
