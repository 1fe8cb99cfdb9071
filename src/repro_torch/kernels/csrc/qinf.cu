// Blockwise inf-norm b-bit quantization (paper eq. 21) for Hopper, sm_90a.
//
// B1  qinf_quantize_kernel   replaces src/repro/kernels/quantize.py::
//     qinf_quantize_blocks (Pallas body _quantize_kernel).
// B2  qinf_dequantize_kernel replaces src/repro/kernels/quantize.py::
//     qinf_dequantize_blocks (Pallas body _dequantize_kernel).
//
// Both are bound by device-memory bytes, not arithmetic: B1 reads x (4 B
// for f32) and the noise u (4 B) and writes one int8 code per element plus
// one f32 scale per row, about 9 B and ten f32 operations an element; B2
// reads 1 B and writes 4 B.  At the H100's 67 TFLOP/s (f32, no tensor
// cores) against 3.35 TB/s the operations cost a fraction of the bytes.
//
// Design.  The TPU kernel lays a 256-element block along the 128-lane axis
// and tiles 8 rows per grid step.  Here one warp owns one block (row): each
// lane strides over the row, the row's max |x| is a 5-step butterfly of
// warp shuffles, and the row is read a second time (from L1) to emit codes.
// Eight warps share a thread block; rows are independent, so there is no
// cross-block reduction and no row padding (the TPU's R % 8 rule is gone).
// Any block width works, so every QInf shape of the main path runs here.
//
// Exactness.  Codes must equal the reference bit for bit, so the code
// argument is evaluated in the reference's order with explicitly rounded
// intrinsics that the compiler may neither contract into an FMA nor
// approximate: __fmul_rn(levels, |x|), then __fdiv_rn(., safe) (IEEE
// division; an approximate divide flips floor() at integer boundaries), then
// __fadd_rn(., u).  Build without --use_fast_math.
//
// Plain C interface (no PyTorch headers, so nvcc builds it in seconds);
// src/repro_torch/kernels/quantize.py loads it with ctypes, allocates every
// output and passes raw pointers and the current stream.  Each launcher
// returns cudaGetLastError() so a refused launch raises in Python.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype tags shared with quantize.py::_DTYPE_TAG
constexpr int kF32 = 0;
constexpr int kF64 = 1;
constexpr int kBF16 = 2;

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) { return __double2float_rn(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ double from_f32<double>(float v) { return (double)v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// B1: x (rows, block) of T, u (rows, block) f32 -> codes int8, scales f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qinf_quantize_kernel(const T* __restrict__ x, const float* __restrict__ u,
                     int8_t* __restrict__ codes, float* __restrict__ scales,
                     long long rows, int block, float levels) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp: shuffles stay full
  const long long base = row * (long long)block;

  float maxabs = 0.0f;
  for (int j = lane; j < block; j += 32)
    maxabs = fmaxf(maxabs, fabsf(to_f32(x[base + j])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    maxabs = fmaxf(maxabs, __shfl_xor_sync(0xffffffffu, maxabs, off));
  const float safe = maxabs > 0.0f ? maxabs : 1.0f;

  for (int j = lane; j < block; j += 32) {
    const float v = to_f32(x[base + j]);
    float mag = floorf(
        __fadd_rn(__fdiv_rn(__fmul_rn(levels, fabsf(v)), safe), u[base + j]));
    mag = fminf(mag, levels);
    const float sgn = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
    codes[base + j] = (int8_t)(int)(sgn * mag);
  }
  if (lane == 0) scales[row] = __fdiv_rn(maxabs, levels);
}

// B2: codes (rows, block) int8, scales (rows,) f32 -> out (rows, block) T,
// out = T(f32(code) * scale).  Grid-stride over the flat element range.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qinf_dequantize_kernel(const int8_t* __restrict__ codes,
                       const float* __restrict__ scales, T* __restrict__ out,
                       long long n, int block) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = from_f32<T>(__fmul_rn((float)codes[i], scales[i / block]));
}

}  // namespace

extern "C" {

int qinf_quantize_blocks_launch(const void* x, int x_dtype, const float* u,
                                int8_t* codes, float* scales, long long rows,
                                int block, int bits, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const float levels = (float)(1 << (bits - 1));
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = (cudaStream_t)stream;
  switch (x_dtype) {
    case kF32:
      qinf_quantize_kernel<float><<<grid, kThreads, 0, s>>>(
          (const float*)x, u, codes, scales, rows, block, levels);
      break;
    case kF64:
      qinf_quantize_kernel<double><<<grid, kThreads, 0, s>>>(
          (const double*)x, u, codes, scales, rows, block, levels);
      break;
    case kBF16:
      qinf_quantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          (const __nv_bfloat16*)x, u, codes, scales, rows, block, levels);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int qinf_dequantize_blocks_launch(const int8_t* codes, const float* scales,
                                  void* out, int out_dtype, long long rows,
                                  int block, void* stream) {
  const long long n = rows * (long long)block;
  if (n <= 0) return (int)cudaSuccess;
  long long want = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // 32 blocks per SM keeps all 132 busy
  const dim3 grid((unsigned)(want < cap ? want : cap));
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case kF32:
      qinf_dequantize_kernel<float><<<grid, kThreads, 0, s>>>(
          codes, scales, (float*)out, n, block);
      break;
    case kF64:
      qinf_dequantize_kernel<double><<<grid, kThreads, 0, s>>>(
          codes, scales, (double*)out, n, block);
      break;
    case kBF16:
      qinf_dequantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          codes, scales, (__nv_bfloat16*)out, n, block);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* qinf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
