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
// are FFMAs: each block owns a 64 x 64 output tile, steps along d in
// chunks of 16 through shared memory (transposed, so a thread's operands
// are conflict-free reads), and each of its 256 threads keeps a 4 x 4
// register tile of sums.  Each shared value feeds 4 FFMAs, which keeps the
// loop off the shared-memory limit only partly: a simple kernel, right
// first; wgmma-free register blocking, TMA and a persistent schedule are
// left to the PR that makes it fast.  The row norms are summed from the
// same shared tiles (threads 0-63 one q row each, 64-127 one x row each,
// one FFMA per staged element) and folded in the epilogue, rounded as the
// plain version rounds them ((qn - 2 dot) + xn, no contraction), then
// clamped.  Output offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "corpus.cuh"

#define L2_BM 64
#define L2_BN 64
#define L2_BK 16
#define L2_THREADS 256

template <typename T>
__global__ void __launch_bounds__(L2_THREADS)
    l2dist_kernel(const T* __restrict__ q, const T* __restrict__ x,
                  float* __restrict__ out, int Q, int N, int d) {
  // k-major tiles: a thread reads its 4 q rows and its 4 x rows of one k
  // step from 4 + 4 words; the +1 keeps the transposing stores apart
  __shared__ float qs[L2_BK][L2_BM + 1];
  __shared__ float xs[L2_BK][L2_BN + 1];
  __shared__ float qn[L2_BM], xn[L2_BN];  // the tile's row norms
  const int tx = threadIdx.x & 15;  // output columns tx, tx+16, tx+32, tx+48
  const int ty = threadIdx.x >> 4;  // output rows ty, ty+16, ty+32, ty+48
  const int m0 = blockIdx.y * L2_BM;
  const int n0 = blockIdx.x * L2_BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;  // threads < 128: the squared norm of row threadIdx.x

  for (int k0 = 0; k0 < d; k0 += L2_BK) {
    // 64 rows x 16 columns of each operand; neighbouring threads read
    // neighbouring columns of a row, zeros past every edge
#pragma unroll
    for (int e = threadIdx.x; e < L2_BM * L2_BK; e += L2_THREADS) {
      const int r = e / L2_BK, c = e % L2_BK;
      const int gc = k0 + c;
      const int gq = m0 + r, gx = n0 + r;
      qs[c][r] = (gq < Q && gc < d) ? to_f32(q[(size_t)gq * d + gc]) : 0.f;
      xs[c][r] = (gx < N && gc < d) ? to_f32(x[(size_t)gx * d + gc]) : 0.f;
    }
    __syncthreads();
    if (threadIdx.x < L2_BM + L2_BN) {
      const int r = threadIdx.x & (L2_BM - 1);
      const float(*t)[L2_BM + 1] = threadIdx.x < L2_BM ? qs : xs;
#pragma unroll
      for (int k = 0; k < L2_BK; ++k) nrm = fmaf(t[k][r], t[k][r], nrm);
    }
#pragma unroll
    for (int k = 0; k < L2_BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (threadIdx.x < L2_BM)
    qn[threadIdx.x] = nrm;
  else if (threadIdx.x < L2_BM + L2_BN)
    xn[threadIdx.x - L2_BM] = nrm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= Q) continue;
    const float qr = qn[ty + 16 * i];
    float* orow = out + (size_t)row * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= N) continue;
      const float v =
          __fadd_rn(__fsub_rn(qr, 2.f * acc[i][j]), xn[tx + 16 * j]);
      orow[col] = fmaxf(v, 0.f);
    }
  }
}

template <typename T>
static int launch_l2dist(const T* q, const T* x, float* out, int Q, int N,
                         int d, cudaStream_t st) {
  const dim3 grid((N + L2_BN - 1) / L2_BN, (Q + L2_BM - 1) / L2_BM);
  l2dist_kernel<T><<<grid, L2_THREADS, 0, st>>>(q, x, out, Q, N, d);
  return (int)cudaGetLastError();
}

// q (Q, d), x (N, d), both of element type `dtype` (DT_F32 or DT_BF16);
// out (Q, N) f32.  Q, N >= 1; Q <= 65535 * 64.
extern "C" int l2dist_launch(const void* q, const void* x, int dtype,
                             float* out, int Q, int N, int d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return launch_l2dist(static_cast<const float*>(q),
                           static_cast<const float*>(x), out, Q, N, d, st);
    case DT_BF16:
      return launch_l2dist(static_cast<const bf16_bits*>(q),
                           static_cast<const bf16_bits*>(x), out, Q, N, d,
                           st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
