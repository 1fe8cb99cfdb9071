// Blockwise inf-norm b-bit quantization (paper eq. 21) for Hopper, sm_90a.
//
// B1  qinf_quantize_vec_kernel / qinf_quantize_row_kernel replace
//     src/repro/kernels/quantize.py::qinf_quantize_blocks (Pallas body
//     _quantize_kernel).
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
// B1 takes a leaf as it lies in memory: x is L rows of D elements, the
// row stride ldx apart (unit stride within a row), and block j of row n
// covers elements [jB, min(jB + B, D)); elements at or past D count as 0
// (they enter the max as 0, their code is 0 and their noise is not read),
// which is what zero-padding the last axis to a multiple of B and
// quantizing the padded rows gives.  The noise, the codes and the scales
// are (L * ceil(D/B), B), (L * ceil(D/B), B) and (L * ceil(D/B),)
// contiguous.  The (R, B) call is the case D = B, ldx = B.
//
// B1 design.  The TPU kernel lays a 256-element block along the 128-lane
// axis and tiles 8 rows per grid step.  Here one warp owns one block, and
// rows are independent, so there is no cross-block reduction and no row
// padding.  Vector variant: the block stays in registers between the
// reduction and the codes, so x and u make one trip from memory.  Lane l
// holds the 16-byte chunks l, l + 32, ... of x (4 f32, 8 bf16 or 2 f64
// elements a chunk; chunks of neighbouring lanes are neighbours, so each
// warp load covers one contiguous 512 B run) and the noise behind them,
// all loads issued before the 5-step shuffle butterfly of the row max;
// each chunk's codes leave in one store of its 4, 8 or 2 bytes (one
// contiguous run a warp store), lane 0 writes the scale.  K = chunks a
// lane, the smallest power of two that covers the block, is a template
// argument, so x and u sit in 2 K V registers: blocks of up to
// kQuantizeVecMaxBlock = 1024 elements (32 a lane).  At block 256 f32:
// K = 2, two 16-byte loads of x and two of u a lane, two 4-byte stores.
// A chunk that runs past D loads element by element; one wholly past D
// loads nothing.  The variant needs B * itemsize a multiple of 16 (whole
// chunks a block), x and u 16-byte aligned and, for L > 1, the row stride
// a multiple of 16 bytes, so that every block starts aligned.  Every other
// leaf -- a wider block, rows that break the alignment (a contiguous
// (5, 129) f32 leaf), a view off the alignment -- takes the row variant:
// the first design's two-pass body, one element a lane, x read again (from L1) for
// the codes, the tail read in place the same way.  The launcher picks the
// variant from the shape and the alignment (qinf_quantize_blocks_vector).
// Rows per thread block: 2 warps while a call has fewer than
// kSmallCallRows = 132 x 8 blocks, so the dense main path's 248 blocks run
// on 124 thread blocks, one an SM, instead of 31; 8 warps above.
// ptxas -v (CUDA 12.8, sm_90a): the f32 vector kernel at block 256 (K = 2)
// takes 35 registers, 48 resident warps an SM in 8-warp thread blocks; the
// row variant 32 registers, 64 warps; the widest vector instances (bf16
// K = 4, f64 K = 16) 89 and 102 registers, 16 warps.
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

// B1's vector variant holds blocks of up to this many elements in
// registers (32 a lane); below kSmallCallRows blocks a call runs 2 warps a
// thread block, so that its blocks spread over the H100's 132 SMs.
constexpr int kQuantizeVecMaxBlock = 1024;
constexpr long long kSmallCallRows = 132LL * kWarpsPerBlock;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) { return __double2float_rn(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One code: sign(v) * min(floor(levels * |v| / safe + u), levels), each
// operation rounded once, in the reference's order.  At 8 bits the code
// +128 saturates to +127, as the reference's cast to int8 does.
__device__ __forceinline__ int8_t qinf_code(float v, float u, float safe,
                                            float levels) {
  float mag = floorf(__fadd_rn(__fdiv_rn(__fmul_rn(levels, fabsf(v)), safe), u));
  mag = fminf(mag, levels);
  const float sgn = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
  const int c = (int)(sgn * mag);
  return (int8_t)(c > 127 ? 127 : c);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// B1's block r of the leaf: its row's elements (xr) and how many of the
// block's elements lie inside the leaf (w <= block).
template <typename T>
__device__ __forceinline__ const T* leaf_block(const T* x, long long r,
                                               long long nb, long long D,
                                               long long ldx, int block,
                                               int* w) {
  const long long n = nb == 1 ? r : r / nb;
  const long long col = (r - n * nb) * block;
  *w = (int)min((long long)block, D - col);
  return x + n * ldx + col;
}

// One 16-byte chunk of x as f32: 4 f32, 2 f64 or 8 bf16 elements.
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_chunk(const double* p, float (&v)[2]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = __double2float_rn(a.x);
  v[1] = __double2float_rn(a.y);
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&v)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // a bf16 is the upper half of its f32
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
  }
}

// The f32 noise behind one chunk: 2, 4 or 8 values.
__device__ __forceinline__ void load_noise(const float* p, float (&v)[2]) {
  const float2 a = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void load_noise(const float* p, float (&v)[4]) {
  load_chunk(p, v);
}
__device__ __forceinline__ void load_noise(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The V codes of one chunk as one V-byte store.
template <int V>
__device__ __forceinline__ void store_codes(int8_t* p, const int8_t (&c)[V]) {
  using Word = typename qinf::Bytes<V>::type;
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < V; ++j)
    (j < 4 ? lo : hi) |= (uint32_t)(uint8_t)c[j] << (8 * (j & 3));
  if constexpr (V == 8) {
    *reinterpret_cast<Word*>(p) = make_uint2(lo, hi);
  } else {
    *reinterpret_cast<Word*>(p) = (Word)lo;
  }
}

// B1, vector variant: one warp a block held in registers, K chunks of
// V = 16 / sizeof(T) elements a lane (block % V == 0, block <= K * 32 * V,
// x, u and every block start 16-byte aligned).
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
qinf_quantize_vec_kernel(const T* __restrict__ x, const float* __restrict__ u,
                         int8_t* __restrict__ codes, float* __restrict__ scales,
                         long long blocks, long long nb, long long D,
                         long long ldx, int block, float levels) {
  constexpr int V = qinf::Vec16<T>::kN;
  const int lane = threadIdx.x & 31;
  const long long r =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= blocks) return;  // uniform across the warp: shuffles stay full
  int w;
  const T* xr = leaf_block(x, r, nb, D, ldx, block, &w);
  const long long base = r * (long long)block;

  float xv[K][V], uv[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = (k * 32 + lane) * V;  // the chunk's first element
    if (e + V <= w) {
      load_chunk(xr + e, xv[k]);
      load_noise(u + base + e, uv[k]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const bool in = e + i < w;
        xv[k][i] = in ? to_f32(xr[e + i]) : 0.0f;
        uv[k][i] = in ? u[base + e + i] : 0.0f;
      }
    }
  }
  float maxabs = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) maxabs = fmaxf(maxabs, fabsf(xv[k][i]));
  maxabs = warp_max(maxabs);
  const float safe = maxabs > 0.0f ? maxabs : 1.0f;

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = (k * 32 + lane) * V;
    if (e < block) {
      int8_t c[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        c[i] = qinf_code(xv[k][i], uv[k][i], safe, levels);
      store_codes<V>(codes + base + e, c);
    }
  }
  if (lane == 0) scales[r] = __fdiv_rn(maxabs, levels);
}

// B1, row variant (any block, any alignment): one warp a block, one
// element a lane; x is read a second time (from L1) for the codes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qinf_quantize_row_kernel(const T* __restrict__ x, const float* __restrict__ u,
                         int8_t* __restrict__ codes, float* __restrict__ scales,
                         long long blocks, long long nb, long long D,
                         long long ldx, int block, float levels) {
  const int lane = threadIdx.x & 31;
  const long long r =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= blocks) return;
  int w;
  const T* xr = leaf_block(x, r, nb, D, ldx, block, &w);
  const long long base = r * (long long)block;

  float maxabs = 0.0f;
  for (int j = lane; j < w; j += 32) maxabs = fmaxf(maxabs, fabsf(to_f32(xr[j])));
  maxabs = warp_max(maxabs);
  const float safe = maxabs > 0.0f ? maxabs : 1.0f;
  for (int j = lane; j < block; j += 32)
    codes[base + j] =
        j < w ? qinf_code(to_f32(xr[j]), u[base + j], safe, levels) : 0;
  if (lane == 0) scales[r] = __fdiv_rn(maxabs, levels);
}

// Launches the vector variant with the smallest K (a power of two) whose
// K * 32 chunks cover the block.
template <typename T, int K>
void launch_quantize_vec(dim3 grid, int threads, cudaStream_t s, const T* x,
                         const float* u, int8_t* codes, float* scales,
                         long long blocks, long long nb, long long D,
                         long long ldx, int block, float levels) {
  constexpr int kCover = K * 32 * qinf::Vec16<T>::kN;
  if constexpr (kCover < kQuantizeVecMaxBlock) {
    if (block > kCover) {
      launch_quantize_vec<T, 2 * K>(grid, threads, s, x, u, codes, scales,
                                    blocks, nb, D, ldx, block, levels);
      return;
    }
  }
  qinf_quantize_vec_kernel<T, K><<<grid, threads, 0, s>>>(
      x, u, codes, scales, blocks, nb, D, ldx, block, levels);
}

template <typename T>
void launch_quantize(const T* x, const float* u, int8_t* codes,
                     float* scales, long long blocks, long long nb,
                     long long D, long long ldx, int block, float levels,
                     int vec, cudaStream_t s) {
  const int warps = blocks < kSmallCallRows ? 2 : kWarpsPerBlock;
  const dim3 grid((unsigned)((blocks + warps - 1) / warps));
  if (vec)
    launch_quantize_vec<T, 1>(grid, warps * 32, s, x, u, codes, scales,
                              blocks, nb, D, ldx, block, levels);
  else
    qinf_quantize_row_kernel<T><<<grid, warps * 32, 0, s>>>(
        x, u, codes, scales, blocks, nb, D, ldx, block, levels);
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

// Whether B1 takes its vector variant for x (dtype tag x_dtype, ``rows``
// leaf rows ``ldx`` elements apart), noise u and block ``block``.
int qinf_quantize_blocks_vector(const void* x, int x_dtype, long long rows,
                                long long ldx, const void* u, int block) {
  const int size = x_dtype == kF64 ? 8 : x_dtype == kBF16 ? 2 : 4;
  return block > 0 && block <= kQuantizeVecMaxBlock &&
         (block * size) % kVecBytes == 0 && qinf::aligned16(x) &&
         qinf::aligned16(u) && (rows <= 1 || (ldx * size) % kVecBytes == 0);
}

// B1 over a leaf x of ``rows`` x ``D`` elements, rows ``ldx`` elements
// apart, in blocks of ``block``: u, codes (rows * ceil(D / block), block),
// scales (rows * ceil(D / block),).
int qinf_quantize_blocks_launch(const void* x, int x_dtype, long long rows,
                                long long D, long long ldx, const float* u,
                                int8_t* codes, float* scales, int block,
                                int bits, int device, void* stream) {
  if (rows <= 0 || D <= 0 || block <= 0) return (int)cudaSuccess;
  const long long nb = (D + block - 1) / block;
  const long long blocks = rows * nb;
  const int vec = qinf_quantize_blocks_vector(x, x_dtype, rows, ldx, u, block);
  qinf::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const float levels = (float)(1 << (bits - 1));
  cudaStream_t s = (cudaStream_t)stream;
  switch (x_dtype) {
    case kF32:
      launch_quantize((const float*)x, u, codes, scales, blocks, nb, D, ldx,
                      block, levels, vec, s);
      break;
    case kF64:
      launch_quantize((const double*)x, u, codes, scales, blocks, nb, D, ldx,
                      block, levels, vec, s);
      break;
    case kBF16:
      launch_quantize((const __nv_bfloat16*)x, u, codes, scales, blocks, nb,
                      D, ldx, block, levels, vec, s);
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
