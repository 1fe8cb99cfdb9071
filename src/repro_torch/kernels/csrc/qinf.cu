// Blockwise inf-norm b-bit quantization (paper eq. 21) for Hopper, sm_90a.
//
// B1  qinf_quantize_kernel   replaces src/repro/kernels/quantize.py::
//     qinf_quantize_blocks (Pallas body _quantize_kernel).
// B2  qinf_dequantize_vec_kernel / qinf_dequantize_row_kernel replace
//     src/repro/kernels/quantize.py::qinf_dequantize_blocks (Pallas body
//     _dequantize_kernel).
//
// Both are bound by device-memory bytes, not arithmetic: B1 reads x (4 B
// for f32) and the noise u (4 B) and writes one int8 code per element plus
// one f32 scale per row, about 9 B and ten f32 operations an element; B2
// reads 1 B and writes 4 B.  At the H100's 67 TFLOP/s (f32, no tensor
// cores) against 3.35 TB/s the operations cost a fraction of the bytes.
//
// B1 design.  The TPU kernel lays a 256-element block along the 128-lane
// axis and tiles 8 rows per grid step.  Here one warp owns one block (row):
// each lane strides over the row, the row's max |x| is a 5-step butterfly of
// warp shuffles, and the row is read a second time (from L1) to emit codes.
// Eight warps share a thread block; rows are independent, so there is no
// cross-block reduction and no row padding (the TPU's R % 8 rule is gone).
// Any block width works, so every QInf shape of the main path runs here.
//
// B2 design.  B2 moves 5 B an element (f32 out) and computes one product,
// so what counts is that every store is a wide, contiguous run.  Vector
// variant: each thread owns the G = 16 B / sizeof(out) consecutive codes
// behind one 16-byte output store (4 for f32, 8 for bf16, 2 for f64),
// reads them with one G-byte load and the row's scale with one load, and
// writes one 16-byte store; neighbouring lanes own neighbouring units, so
// a warp's loads and its stores each cover one contiguous run (512 B of
// output a warp store).  A thread block holds whole rows (rows of at most
// 256 units; wider rows are cut across blockIdx.y), so a thread finds its
// row with one small int division and no 64-bit division.  Why not 16
// consecutive codes a thread (one 16-byte load): each warp store's 16-byte
// pieces would land 64 B apart, half-filling 32 sectors; on an H100 that
// stays under half the bytes bound.  The vector variant needs a width
// that is a multiple of 16 and 16-byte aligned codes and output.  Every
// other shape (a ragged width, a view whose storage offset breaks the
// alignment) takes the row variant: one warp per row, the scale loaded
// once, one element a lane.  The launcher picks the variant from the
// width and the alignment (qinf_dequantize_blocks_vector).
//
// Exactness.  Codes must equal the reference bit for bit, so the code
// argument is evaluated in the reference's order with explicitly rounded
// intrinsics that the compiler may neither contract into an FMA nor
// approximate: __fmul_rn(levels, |x|), then __fdiv_rn(., safe) (IEEE
// division; an approximate divide flips floor() at integer boundaries), then
// __fadd_rn(., u).  B2 is __fmul_rn((float)code, scale) and one rounding to
// the output dtype.  Build without --use_fast_math.
//
// Plain C interface (no PyTorch headers, so nvcc builds it in seconds):
// csrc/binding.cpp allocates every output and calls each launcher with raw
// pointers, the device index and the current stream.  Each launcher
// returns cudaGetLastError() so a refused launch raises in Python.

#include "common.cuh"

namespace {

using qinf::kBF16;
using qinf::kVecBytes;
using qinf::kF32;
using qinf::kF64;
using qinf::kThreads;
using qinf::kWarpsPerBlock;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) { return __double2float_rn(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// B2, vector variant: codes (rows, block) int8 with block % 16 == 0,
// scales (rows,) f32 -> out (rows, block) T, out = T(f32(code) * scale).
// A thread owns G = Vec16<T>::kN consecutive codes (one G-byte load) and
// writes them with one 16-byte store; ``upr`` = block / G units a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qinf_dequantize_vec_kernel(const int8_t* __restrict__ codes,
                           const float* __restrict__ scales,
                           T* __restrict__ out, long long rows, int block,
                           int upr, int rpb) {
  constexpr int G = qinf::Vec16<T>::kN;
  using Word = typename qinf::Bytes<G>::type;
  long long row;
  int unit;
  if (!qinf::row_unit(upr, rpb, rows, blockIdx.x, &row, &unit)) return;
  const float scale = __ldg(scales + row);
  const long long e = row * block + (long long)unit * G;
  const Word c = __ldg(reinterpret_cast<const Word*>(codes + e));
  float v[G];
#pragma unroll
  for (int j = 0; j < G; ++j)
    v[j] = __fmul_rn((float)(int8_t)qinf::byte_of(c, j), scale);
  qinf::store_vec16<false>(out + e, v);
}

// B2, row variant (any width, any alignment): one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qinf_dequantize_row_kernel(const int8_t* __restrict__ codes,
                           const float* __restrict__ scales,
                           T* __restrict__ out, long long rows, int block) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float scale = scales[row];
  const long long base = row * (long long)block;
  for (int j = lane; j < block; j += 32)
    out[base + j] = qinf::from_f32<T>(__fmul_rn((float)codes[base + j], scale));
}

template <typename T>
void launch_dequantize(const int8_t* codes, const float* scales, T* out,
                       long long rows, int block, int vec, cudaStream_t s) {
  if (vec) {
    const int upr = block / qinf::Vec16<T>::kN;
    qinf_dequantize_vec_kernel<T>
        <<<qinf::row_unit_grid(upr, rows, 1), kThreads, 0, s>>>(
            codes, scales, out, rows, block, upr, qinf::rows_per_block(upr));
  } else {
    const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
    qinf_dequantize_row_kernel<T><<<grid, kThreads, 0, s>>>(codes, scales, out,
                                                            rows, block);
  }
}

}  // namespace

extern "C" {

int qinf_quantize_blocks_launch(const void* x, int x_dtype, const float* u,
                                int8_t* codes, float* scales, long long rows,
                                int block, int bits, int device, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  qinf::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
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

// Whether B2 takes its vector variant: rows of whole 16-byte chunks of
// codes, 16-byte aligned codes and output.
int qinf_dequantize_blocks_vector(const void* codes, const void* out,
                                  int block) {
  return block % kVecBytes == 0 && qinf::aligned16(codes) &&
         qinf::aligned16(out);
}

int qinf_dequantize_blocks_launch(const int8_t* codes, const float* scales,
                                  void* out, int out_dtype, long long rows,
                                  int block, int device, void* stream) {
  if (rows <= 0 || block <= 0) return (int)cudaSuccess;
  const int vec = qinf_dequantize_blocks_vector(codes, out, block);
  qinf::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_dtype) {
    case kF32:
      launch_dequantize(codes, scales, (float*)out, rows, block, vec, s);
      break;
    case kF64:
      launch_dequantize(codes, scales, (double*)out, rows, block, vec, s);
      break;
    case kBF16:
      launch_dequantize(codes, scales, (__nv_bfloat16*)out, rows, block, vec,
                        s);
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
