// Squared L2 of gathered corpus rows against a query row, one warp per
// row: the scoring step shared by the gather kernels (gather_dist.cu) and
// the fused beam (beam.cu), so both sum in one order.
//
// Lane l of the warp takes elements l, l+32, l+64, ... of the row (one
// coalesced line per warp load, any d), upcasts each to f32, multiplies it
// by the per-dimension scale when one is given (rounded apart from the
// subtraction, as the plain version rounds it), takes the difference with
// the query and accumulates its square with an FMA; a butterfly of shuffles
// folds the 32 partial sums.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "corpus.cuh"
#include "topk_key.cuh"

// R rows at once, each in the order above: every lane issues its loads of
// all R rows before it folds any, so the warp waits on one memory round
// trip, not R.  xr[r] == nullptr skips row r's loads (out[r] is then
// meaningless).  The query and the scale may lie in shared memory.
template <typename T, int R>
__device__ __forceinline__ void rows_d2(const T* const* xr,
                                        const float* scale, const float* qr,
                                        int d, int lane, float* out) {
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int c = lane; c < d; c += 32) {
    float xv[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      xv[r] = xr[r] != nullptr ? to_f32(__ldg(xr[r] + c)) : 0.f;
    const float qc = qr[c];
    const float sc = scale != nullptr ? scale[c] : 1.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v = xv[r];
      if (scale != nullptr) v = __fmul_rn(v, sc);
      const float df = v - qc;
      acc[r] = fmaf(df, df, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = warp_sum(acc[r]);
}

// One row.
template <typename T>
__device__ __forceinline__ float row_d2(const T* xr, const float* scale,
                                        const float* qr, int d, int lane) {
  float s;
  rows_d2<T, 1>(&xr, scale, qr, d, lane, &s);
  return s;
}
