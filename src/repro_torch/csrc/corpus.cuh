// Corpus element types of the scoring kernels.  A corpus is f32, int8 (the
// quantized copy, with a per-dimension f32 scale) or bf16 (kept as its raw
// 16 bits: the high half of an f32).  Every element is upcast to f32 and,
// when a scale is given, multiplied by it before any arithmetic, as the
// Pallas kernels dequantize in VMEM right after the narrow DMA.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes the wrappers pass (repro_torch.kernels._build.DTYPE_CODES)
#define DT_F32 0
#define DT_INT8 1
#define DT_BF16 2

typedef uint16_t bf16_bits;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(bf16_bits v) {
  return __uint_as_float((uint32_t)v << 16);  // exact
}

// Elements 4j .. 4j+3 of a row in one vector load (16, 4 or 8 bytes; the
// row must be aligned to that width), upcast to f32.
__device__ __forceinline__ float4 load4(const float* r, int j) {
  return __ldg(reinterpret_cast<const float4*>(r) + j);
}
__device__ __forceinline__ float4 load4(const int8_t* r, int j) {
  const char4 v = __ldg(reinterpret_cast<const char4*>(r) + j);
  return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
}
__device__ __forceinline__ float4 load4(const bf16_bits* r, int j) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(r) + j);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xFFFF0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xFFFF0000u));
}

// Runs the statement with T bound to the element type of `dtype`; returns
// cudaErrorInvalidValue from the enclosing function for an unknown code.
#define DISPATCH_CORPUS(dtype, T, ...)              \
  switch (dtype) {                                  \
    case DT_F32: {                                  \
      typedef float T;                              \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    case DT_INT8: {                                 \
      typedef int8_t T;                             \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    case DT_BF16: {                                 \
      typedef bf16_bits T;                          \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    default:                                        \
      return (int)cudaErrorInvalidValue;            \
  }
