// l2dist: the batched squared-L2 distance matrix.
//
// Replaces src/repro/kernels/l2dist.py::l2dist_pallas.  For q (Q, d) and
// x (N, d), both f32 or both bf16:
//
//   out[i, j] = max(qn[i] - 2 * sum_c q[i, c] * x[j, c] + xn[j], 0)
//
// with qn, xn the rows' squared norms, every element widened to f32 first,
// f32 products and f32 sums: the expansion form of the reference's plain
// version (kernels/ref.py::l2dist_ref), clamped at 0.  Any Q, N and d; the
// ragged edges are masked here, nothing is padded.
//
// What bounds it on an H100: at the benchmark and segment-tree shapes,
// operations.  The work is 2*Q*N*d flops against (Q + N)*d input elements
// and Q*N f32 outputs: at d = 128 that is about 64 flops per output byte,
// past the card's f32 ridge (67 TFLOP/s outside the tensor cores over
// 3.35 TB/s = 20 flops per byte), so the bound is 2*Q*N*d / 67e12 s;
// at (1024, 262144, 128) about 1.03 ms.  At the microbench shapes
// ((128, 1024, 128), (256, 4096, 128)) the whole call is a few
// microseconds of work and the launch sets the time.
//
// Design: the TPU kernel feeds (128, 512) tiles to the MXU and carries the
// partial product in its VMEM output tile across the d grid axis.  Here
// the f32 contract rules out the tensor cores (no TF32), so the products
// are FFMAs, and the loop has to keep the FMA pipes, not shared memory or
// the block's own epilogue, busy:
//   * Tiles.  Each block of 256 threads owns a 128 x 128 output tile; each
//     thread an 8 x 8 register tile (rows ty*4 + {0..3} and 64 + ty*4 +
//     {0..3}, columns tx*4 + {0..3} and 64 + tx*4 + {0..3}).  Per step of
//     d a thread reads 2 + 2 float4s from shared memory and issues 64
//     FFMAs: each shared value feeds 8 FFMAs.
//   * Layout.  A stage holds 16 steps of d for the tile's 128 q rows and
//     128 x rows, d-major (a step's 128 values contiguous, rows padded to
//     132 floats), so a thread's 8 row values of one step are two float4s
//     and its fragments take 16 registers: with the 64 sums the kernel
//     stays under 128 registers and two blocks share an SM, one block's
//     epilogue and first loads overlapping the other's FFMAs.  The 16 x
//     threads of a warp read 256 contiguous bytes (two wavefronts), its two
//     q row groups one.
//   * Loads.  d advances through two stages: the next stage's q slices are
//     loaded into registers (16-byte loads, 4 threads to a row's 64
//     contiguous bytes, for f32 with d % 4 == 0 and 16-byte aligned rows;
//     masked scalar loads for bf16, odd d and misaligned views, widened to
//     f32) before the current stage's first 8 steps of FFMAs and stored
//     transposed into the other stage after them, its x slices likewise
//     around the last 8 steps: 8 prefetched values live at a time, so the
//     kernel fits 128 registers without spills.  (A 16-byte cp.async copy
//     cannot transpose; the row-major stage it needs costs 32 fragment
//     registers, so one block per SM, and measured slower, PERF.md.)
//   * Norms.  Each of the 256 threads sums one of the tile's 128 + 128 rows
//     from the staged steps (one FFMA a step against the 64 of its
//     register tile), in d order, and the epilogue folds them in, rounded
//     as the plain version rounds them ((qn - 2 dot) + xn, no contraction),
//     then clamps.
//   * Stores.  A thread's 4 adjacent columns leave as one float4 (the 16
//     threads of a row cover 256 contiguous bytes) where N % 4 == 0 and the
//     4 columns are inside N, else as masked scalars.  Output offsets are
//     64-bit.
//   * Order.  blockIdx.x walks the q tiles, so the blocks in flight share a
//     few x tiles and all of q in L2, and x is read from memory about once.
// Every sum runs in d order with one FFMA per element, as the previous
// 64 x 64 tiling did, so the results are the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "corpus.cuh"

#define L2_BM 128
#define L2_BN 128
#define L2_BK 16
#define L2_LD (L2_BM + 4)  // floats of one step of a stage (padded)
#define L2_THREADS 256

// One thread's share of one operand's half of a stage, prefetched in
// registers: slices e = threadIdx.x + 256 h (h = 0, 1), row e / 4, values
// 4 (e % 4) .. 4 (e % 4) + 3 of the step.  One operand at a time keeps 8
// values live, not 16, so the kernel fits 128 registers without spills.
template <typename T, bool VEC>
struct Prefetch {
  float v[2][4];  // [h][value]

  __device__ void load(const T* base, int row0, int rows, int d, int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = threadIdx.x + L2_THREADS * h;
      const int row = row0 + (e >> 2), k = k0 + (e & 3) * 4;
      const bool in_rows = row < rows;
      if constexpr (VEC) {
        // f32, d % 4 == 0: the 4 values are all inside d or all past it
        const float4 f =
            in_rows && k < d
                ? __ldg(reinterpret_cast<const float4*>(
                      reinterpret_cast<const float*>(base) +
                      (size_t)row * d + k))
                : make_float4(0.f, 0.f, 0.f, 0.f);
        v[h][0] = f.x;
        v[h][1] = f.y;
        v[h][2] = f.z;
        v[h][3] = f.w;
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          v[h][t] = in_rows && k + t < d
                        ? to_f32(base[(size_t)row * d + k + t])
                        : 0.f;
      }
    }
  }

  // Transposed into an operand's stage: value t of slice e goes to step
  // 4 (e % 4) + t, row e / 4 (a warp's stores meet at most two to a bank).
  __device__ void store(float (*st)[L2_LD]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = threadIdx.x + L2_THREADS * h;
      const int r = e >> 2, k = (e & 3) * 4;
#pragma unroll
      for (int t = 0; t < 4; ++t) st[k + t][r] = v[h][t];
    }
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(L2_THREADS, 2)
    l2dist_kernel(const T* __restrict__ q, const T* __restrict__ x,
                  float* __restrict__ out, int Q, int N, int d,
                  int tile0) {
  // [stage][operand][step][row]
  __shared__ __align__(16) float tiles[2][2][L2_BK][L2_LD];
  __shared__ float norms[L2_BM + L2_BN];  // the tile's q rows, then x rows
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * L2_BM;
  const int n0 = (tile0 + blockIdx.y) * L2_BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;  // the squared norm of tile row threadIdx.x
  const int nr = threadIdx.x & (L2_BM - 1);
  const int nop = threadIdx.x >> 7;  // 0: a q row, 1: an x row

  Prefetch<T, VEC> pf;
  pf.load(q, m0, Q, d, 0);
  pf.store(tiles[0][0]);
  pf.load(x, n0, N, d, 0);
  pf.store(tiles[0][1]);
  __syncthreads();
  const int nk = (d + L2_BK - 1) / L2_BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    // the next stage's q slices during the first half of the steps, its x
    // slices during the second (stage cur ^ 1 is free: the barrier that
    // ended the previous round came after its last reads)
    if (more) pf.load(q, m0, Q, d, (kt + 1) * L2_BK);
#pragma unroll
    for (int k = 0; k < L2_BK; ++k) {
      if (k == L2_BK / 2 && more) {
        pf.store(tiles[cur ^ 1][0]);
        pf.load(x, n0, N, d, (kt + 1) * L2_BK);
      }
      const float* qs = tiles[cur][0][k];
      const float* xs = tiles[cur][1][k];
      const float v = tiles[cur][nop][k][nr];
      nrm = fmaf(v, v, nrm);
      const float4 a0 = *reinterpret_cast<const float4*>(qs + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(qs + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(xs + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(xs + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) pf.store(tiles[cur ^ 1][1]);
    __syncthreads();
  }
  norms[threadIdx.x] = nrm;
  __syncthreads();

  const bool vec = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i >> 2) * 64 + ty * 4 + (i & 3);
    const int row = m0 + r;
    if (row >= Q) continue;
    const float qr = norms[r];
    float* orow = out + (size_t)row * N;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int cl = g * 64 + tx * 4;
      const int col = n0 + cl;
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        v[t] = fmaxf(__fadd_rn(__fsub_rn(qr, 2.f * acc[i][g * 4 + t]),
                               norms[L2_BM + cl + t]),
                     0.f);
      if (vec && col + 3 < N) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (col + t < N) orow[col + t] = v[t];
      }
    }
  }
}

// One launch per 65535 x tiles (the grid's y extent): one launch up to
// N = 8,388,480.
template <typename T, bool VEC>
static int launch_l2dist(const T* q, const T* x, float* out, int Q, int N,
                         int d, cudaStream_t st) {
  const int tiles = (N + L2_BN - 1) / L2_BN;
  for (int t0 = 0; t0 < tiles; t0 += 65535) {
    const int ty = tiles - t0 < 65535 ? tiles - t0 : 65535;
    const dim3 grid((Q + L2_BM - 1) / L2_BM, ty);
    l2dist_kernel<T, VEC><<<grid, L2_THREADS, 0, st>>>(q, x, out, Q, N, d,
                                                        t0);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}

// q (Q, d), x (N, d), both of element type `dtype` (DT_F32 or DT_BF16);
// out (Q, N) f32, 16-byte aligned.  Q, N >= 1.
extern "C" int l2dist_launch(const void* q, const void* x, int dtype,
                             float* out, int Q, int N, int d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32: {
      const float* qf = static_cast<const float*>(q);
      const float* xf = static_cast<const float*>(x);
      if (d % 4 == 0 && (((uintptr_t)q | (uintptr_t)x) & 15) == 0)
        return launch_l2dist<float, true>(qf, xf, out, Q, N, d, st);
      return launch_l2dist<float, false>(qf, xf, out, Q, N, d, st);
    }
    case DT_BF16:
      return launch_l2dist<bf16_bits, false>(
          static_cast<const bf16_bits*>(q), static_cast<const bf16_bits*>(x),
          out, Q, N, d, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
