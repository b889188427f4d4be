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
// 67 TFLOP/s f32 over 3.35 TB/s (20 flops per byte).  The design reads each
// in-window row once with one vector load per lane per 4 elements (a warp
// covers a d_pad = 128 row in one coalesced pass: 16 B per lane for f32,
// 4 B for int8, 8 B for bf16), never reads a masked row or a row at or past
// n_pad, and skips a whole chunk that misses the window.  The (Q, W)
// distance matrix is never written: selection happens in shared memory.
//
// Design: the TPU kernel walks a window's row blocks in order on one core
// and folds each into a running top-k; GPU blocks run in parallel and in no
// order.  So pass 1 has grid (Q, S): block (i, c) owns R consecutive window
// rows, one warp per row at a time (q, |q|^2 and the scale in shared
// memory), writes each row's packed (dist, rank) key to shared memory,
// bitonic-sorts the R keys and writes its kc = min(k, R) best to a
// (Q, S, kc) scratch.  Pass 2 has one block per query: it folds the S*kc
// candidates through a shared buffer (running best P = next_pow2(k) keys
// plus a tile of new ones, bitonic-sorted per tile) and writes ids and
// dists.  The rank rides in the key, so ties break toward the lower rank
// whatever the block order.  Only pass 1 depends on the corpus type.
//
// Every k the reference takes stays in the kernel.  While 2*next_pow2(k)
// keys fit one block's shared memory (k <= SMEM_K) the merge above runs.
// Past that, pass 1 keeps whole chunks (kc = R = SMEM_K) over a pow2 number
// of chunks S, so each query's S*R keys are sorted runs of R; a bitonic
// merge in global memory (merge_sorted_runs) sorts the row, and the first k
// keys leave as ids and dists.
#include <cuda_runtime.h>
#include <stdint.h>

#include "corpus.cuh"
#include "topk_key.cuh"

#define THREADS 256
// largest next_pow2(k) whose merge buffer (2*P keys) stays in shared memory
#define SMEM_K 2048

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

// x: (n_pad, d_pad) elements of `dtype` (DT_F32, DT_INT8 or DT_BF16);
// scale: (d_pad,) f32 or null.  partial: (Q, S, kc) scratch, kc = min(k,
// R).  For next_pow2(k) <= SMEM_K the wrapper picks R = max(1024,
// next_pow2(k)) and S = ceil(w / R); past it R = SMEM_K and S =
// next_pow2(ceil(w / R)), so kc = R and each row of S*R keys can be
// bitonic-merged in place.  Returns the first CUDA error, 0 on success.
extern "C" int range_scan_launch(const void* x, int dtype, const float* scale,
                                 const int* starts, const int* lens,
                                 const float* q, const int* live,
                                 key_t64* partial, int* out_ids, float* out_d,
                                 int n_pad, int d_pad, int Q, int w, int k,
                                 int n_valid, int R, int S, void* stream) {
  const int tb = 128;
  const int kc = k < R ? k : R;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem1 = (size_t)R * sizeof(key_t64) +
                       (size_t)d_pad * sizeof(float) * (scale ? 2 : 1);
  int rc = 0;
  DISPATCH_CORPUS(dtype, T, {
    rc = set_smem((const void*)range_scan_partial<T>, smem1);
    if (rc) return rc;
    range_scan_partial<T><<<dim3(Q, S), THREADS, smem1, st>>>(
        static_cast<const T*>(x), scale, starts, lens, q, live, partial,
        n_pad, d_pad, n_valid, tb, w, R, kc);
  });
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int P = next_pow2_host(k);
  if (P <= SMEM_K) {
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
