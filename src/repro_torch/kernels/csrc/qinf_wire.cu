// Wire-path QInf kernels of the neighbor-gossip backend, for Hopper, sm_90a.
//
// B3  qinf_quantize_pack_kernel       replaces src/repro/kernels/quantize.py::
//     qinf_quantize_pack_blocks (Pallas body _quantize_pack_kernel).
// B4  qinf_unpack_dequant_mix_kernel  replaces src/repro/kernels/quantize.py::
//     qinf_unpack_dequant_mix_blocks (Pallas body _unpack_dequant_mix_kernel).
//
// B3 is B1 (qinf.cu) fused with the wire encoding: each code c becomes the
// offset byte c + 2^(b-1); for b <= 3 two codes share a byte in HALVES
// order (byte k of a block = code k | code k + B/2 << 4), for b >= 4 each
// code is one byte.  The int8 codes never reach device memory.
// B4 decodes the S payloads a node holds for one bucket group (sender 0 is
// the node itself, then one per hop), dequantizes each, rounds it through
// the output dtype, and writes mix[t] = sum_s w[t, s] * Q_s for every
// schedule round t plus qself = Q_0.  The per-sender Q_s never reach
// device memory.
//
// Bound.  Both are bound by device-memory bytes.  B3 reads x and u (8 B)
// and writes half a byte (b <= 3) plus 4 B of scale per block: ~8.52 B an
// element against ~10 f32 operations.  B4 reads S half-bytes and writes
// T + 1 outputs of 4 B: at S = 3, T = 1, ~9.5 B an element against
// ~4 S + 2 T S operations.  At 67 TFLOP/s (f32, no tensor cores) against
// 3.35 TB/s the operations cost a fraction of the bytes.
//
// Design.  One warp owns one row (block) as in B1: the row's max |x| is a
// shuffle butterfly, and lane k then handles the element pairs (k, k + B/2)
// and writes their byte directly, so B = 128 and B = 256 (the two widths
// of a transformer's bucket layout) and any even B work.  B4 takes a
// leading node dim: packed (N, S, R, W), scales (N, S, R), weights
// (N, T, S), and one warp owns one (node, row); each node applies its own
// receiver-indexed weights, so per node the function is exactly the TPU
// kernel's, and all N nodes of one bucket group take one launch.  No row
// padding: the TPU's R % 8 rule is gone.  Loads are one element a lane
// (no vector loads, no TMA): a simple kernel first.
//
// Exactness.  B3's codes must equal the reference bit for bit: the code
// argument is __fmul_rn(levels, |x|), then __fdiv_rn(., safe), then
// __fadd_rn(., u), in the reference's order, with no FMA contraction and
// IEEE division.  B4 accumulates in sender order s = 0..S-1 with __fmul_rn
// and __fadd_rn (acc = w0 q0, then acc += ws qs), which is what the plain
// version (src/repro_torch/kernels/ref.py::weighted_mix_ref) computes.
// Build without --use_fast_math.
//
// Plain C interface (no PyTorch headers); src/repro_torch/kernels/
// quantize.py loads it with ctypes, allocates every output and passes raw
// pointers and the current stream.  Each launcher returns
// cudaGetLastError() so a refused launch raises in Python.

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

__device__ __forceinline__ int qinf_code(float v, float uu, float levels,
                                         float safe) {
  float mag =
      floorf(__fadd_rn(__fdiv_rn(__fmul_rn(levels, fabsf(v)), safe), uu));
  mag = fminf(mag, levels);
  const float sgn = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
  return (int)(sgn * mag);
}

// B3: x, u (rows, block) f32 -> packed (rows, W) u8, scales (rows,) f32.
__global__ void __launch_bounds__(kThreads)
qinf_quantize_pack_kernel(const float* __restrict__ x,
                          const float* __restrict__ u,
                          uint8_t* __restrict__ packed,
                          float* __restrict__ scales, long long rows,
                          int block, float levels, int offset, int nibble) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp: shuffles stay full
  const long long base = row * (long long)block;

  float maxabs = 0.0f;
  for (int j = lane; j < block; j += 32)
    maxabs = fmaxf(maxabs, fabsf(x[base + j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    maxabs = fmaxf(maxabs, __shfl_xor_sync(0xffffffffu, maxabs, off));
  const float safe = maxabs > 0.0f ? maxabs : 1.0f;

  if (nibble) {
    const int half = block >> 1;
    uint8_t* out = packed + row * (long long)half;
    for (int k = lane; k < half; k += 32) {
      const int lo = qinf_code(x[base + k], u[base + k], levels, safe) + offset;
      const int hi = qinf_code(x[base + k + half], u[base + k + half], levels,
                               safe) + offset;
      out[k] = (uint8_t)(lo | (hi << 4));
    }
  } else {
    uint8_t* out = packed + row * (long long)block;
    for (int k = lane; k < block; k += 32)
      out[k] = (uint8_t)(qinf_code(x[base + k], u[base + k], levels, safe) +
                         offset);
  }
  if (lane == 0) scales[row] = __fdiv_rn(maxabs, levels);
}

// Q_s rounded through the output dtype, back in f32.
template <typename T>
__device__ __forceinline__ float round_through(float v);
template <>
__device__ __forceinline__ float round_through<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_through<double>(float v) { return v; }
template <>
__device__ __forceinline__ float round_through<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// The dequantized element e of sender s's row.
__device__ __forceinline__ float dequant(const uint8_t* __restrict__ prow,
                                         float scale, int e, int half,
                                         int offset, int nibble) {
  int code;
  if (nibble) {
    const int byte = prow[e < half ? e : e - half];
    code = (e < half ? (byte & 0x0F) : ((byte >> 4) & 0x0F)) - offset;
  } else {
    code = (int)prow[e] - offset;
  }
  return __fmul_rn((float)code, scale);
}

// B4: packed (N, S, R, W) u8, scales (N, S, R) f32, w (N, T, S) f32 ->
// mix (N, T, R, B), qself (N, R, B) of T_out.
template <typename TOut>
__global__ void __launch_bounds__(kThreads)
qinf_unpack_dequant_mix_kernel(const uint8_t* __restrict__ packed,
                               const float* __restrict__ scales,
                               const float* __restrict__ w,
                               TOut* __restrict__ mix,
                               TOut* __restrict__ qself, long long nodes,
                               int S, int T, long long R, int block, int W,
                               int offset, int nibble) {
  const int lane = threadIdx.x & 31;
  const long long gid =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (gid >= nodes * R) return;
  const long long n = gid / R;
  const long long r = gid - n * R;
  const int half = block >> 1;
  const float* wn = w + n * (long long)T * S;
  const long long prow0 = (n * S * R + r) * (long long)W;   // sender 0's row
  const long long srow0 = n * S * R + r;
  const long long sender_stride = R * (long long)W;

  for (int e = lane; e < block; e += 32) {
    for (int t = 0; t < T; ++t) {
      float acc = 0.0f;
      for (int s = 0; s < S; ++s) {
        const float q = round_through<TOut>(
            dequant(packed + prow0 + s * sender_stride, scales[srow0 + s * R],
                    e, half, offset, nibble));
        if (t == 0 && s == 0)
          qself[(n * R + r) * block + e] = from_f32<TOut>(q);
        const float term = __fmul_rn(wn[t * S + s], q);
        acc = s == 0 ? term : __fadd_rn(acc, term);
      }
      mix[((n * T + t) * R + r) * block + e] = from_f32<TOut>(acc);
    }
  }
}

}  // namespace

extern "C" {

int qinf_quantize_pack_blocks_launch(const float* x, const float* u,
                                     uint8_t* packed, float* scales,
                                     long long rows, int block, int bits,
                                     void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const float levels = (float)(1 << (bits - 1));
  const int nibble = bits + 1 <= 4 ? 1 : 0;
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  qinf_quantize_pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, u, packed, scales, rows, block, levels, 1 << (bits - 1), nibble);
  return (int)cudaGetLastError();
}

int qinf_unpack_dequant_mix_blocks_launch(const uint8_t* packed,
                                          const float* scales, const float* w,
                                          void* mix, void* qself,
                                          int out_dtype, long long nodes,
                                          int S, int T, long long R,
                                          int block, int bits, void* stream) {
  const long long warps = nodes * R;
  if (warps <= 0) return (int)cudaSuccess;
  const int nibble = bits + 1 <= 4 ? 1 : 0;
  const int W = nibble ? block / 2 : block;
  const int offset = 1 << (bits - 1);
  const dim3 grid((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t st = (cudaStream_t)stream;
  switch (out_dtype) {
    case kF32:
      qinf_unpack_dequant_mix_kernel<float><<<grid, kThreads, 0, st>>>(
          packed, scales, w, (float*)mix, (float*)qself, nodes, S, T, R, block,
          W, offset, nibble);
      break;
    case kF64:
      qinf_unpack_dequant_mix_kernel<double><<<grid, kThreads, 0, st>>>(
          packed, scales, w, (double*)mix, (double*)qself, nodes, S, T, R,
          block, W, offset, nibble);
      break;
    case kBF16:
      qinf_unpack_dequant_mix_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          packed, scales, w, (__nv_bfloat16*)mix, (__nv_bfloat16*)qself, nodes,
          S, T, R, block, W, offset, nibble);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
