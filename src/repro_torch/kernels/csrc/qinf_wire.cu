// Wire-path QInf kernels of the neighbor-gossip backend, for Hopper, sm_90a.
//
// B3  qinf_quantize_pack_kernel  replaces src/repro/kernels/quantize.py::
//     qinf_quantize_pack_blocks (Pallas body _quantize_pack_kernel).
// B4  qinf_unpack_dequant_mix_vec_kernel / _row_kernel replace
//     src/repro/kernels/quantize.py::qinf_unpack_dequant_mix_blocks (Pallas
//     body _unpack_dequant_mix_kernel).
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
// B3 design.  One warp owns one row (block) as in B1: the row's max |x| is
// a shuffle butterfly, and lane k then handles the element pairs
// (k, k + B/2) and writes their byte directly, so B = 128 and B = 256 (the
// two widths of a transformer's bucket layout) and any even B work.  No row
// padding: the TPU's R % 8 rule is gone.
//
// B4 design.  B4 takes a leading node dim: packed (N, S, R, W), scales
// (N, S, R), weights (N, T, S); each node applies its own receiver-indexed
// weights, so per node the function is exactly the TPU kernel's, and all N
// nodes of one bucket group take one launch.  Its cost is the 8 B an
// element it writes (mix and qself at T = 1, f32), so the vector variant
// is built around wide, contiguous stores and few registers.  A thread
// owns G = 16 B / sizeof(out) payload bytes k0..k0+G-1 of one (node, row)
// for every sender (4 for f32, 8 for bf16, 2 for f64).  It issues the S
// payload loads (G bytes each, every byte read once) and the S scale loads
// together before any arithmetic and holds them in registers (at most
// kMaxSenders).  Per output half (low nibbles: elements k0..; high
// nibbles: B/2+k0..; byte packing has one half) it decodes each Q_s once,
// writes qself, and for each round t loads the node's S weights of t and
// writes mix[t], one 16-byte store per output.  Neighbouring lanes own
// neighbouring bytes, so every warp load is one contiguous run and every
// warp store one contiguous 512 B run.  Stores are streaming (evict-first):
// the outputs of a bucket group far exceed the 50 MB L2.  A thread block
// holds whole rows and blockIdx.x counts (node, row group), so there is no
// 64-bit division.  Why not 16 payload bytes a thread: each warp store's
// 16-byte pieces would land 64 B apart, half-filling every sector they
// touch, and holding all 32 decoded elements of every sender lets the
// compiler hoist the decode out of the round loop at over 250 registers;
// on an H100 that stays under half the bytes bound.  __launch_bounds__
// caps it at 64 registers (32 resident warps an SM).  The vector variant
// needs a payload row of whole 16-byte chunks (W % 16 == 0), a 16-byte
// aligned payload and outputs and S <= kMaxSenders = 4 (a ring's self + 2
// hops, exponential-8's self + 3); every other shape takes the row
// variant, one warp per (node, row), one element a lane.  The launcher picks the variant from
// the shape and the alignment (qinf_unpack_dequant_mix_blocks_vector).
//
// Exactness.  B3's codes must equal the reference bit for bit: the code
// argument is __fmul_rn(levels, |x|), then __fdiv_rn(., safe), then
// __fadd_rn(., u), in the reference's order, with no FMA contraction and
// IEEE division.  B4 accumulates in sender order s = 0..S-1 with __fmul_rn
// and __fadd_rn (acc = w0 q0, then acc += ws qs), which is what the plain
// version (src/repro_torch/kernels/ref.py::weighted_mix_ref) computes, so
// both variants are bit-equal to it.  Build without --use_fast_math.
//
// Plain C interface (no PyTorch headers): csrc/binding.cpp allocates
// every output and calls each launcher with raw pointers, the device index
// and the current stream.  Each launcher returns cudaGetLastError() so a
// refused launch raises in Python.

#include "common.cuh"

namespace {

using qinf::kBF16;
using qinf::kVecBytes;
using qinf::kF32;
using qinf::kF64;
using qinf::kThreads;
using qinf::kWarpsPerBlock;
using qinf::from_f32;

constexpr int kMaxSenders = 4;  // senders the B4 vector variant holds
constexpr bool kStreamStores = true;  // B4's outputs far exceed the L2

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

// B4, vector variant: packed (N, S, R, W) u8 with W % 16 == 0, scales
// (N, S, R) f32, w (N, T, S) f32 -> mix (N, T, R, B), qself (N, R, B) of
// TOut.  A thread owns G = Vec16<TOut>::kN payload bytes of one (node, row)
// for every sender (S <= kMaxSenders); ``upr`` = W / G units a row,
// ``groups`` row groups a node along blockIdx.x.  The register cap (64)
// keeps 32 warps an SM resident.
template <typename TOut>
__global__ void __launch_bounds__(kThreads, 4)
qinf_unpack_dequant_mix_vec_kernel(const uint8_t* __restrict__ packed,
                                   const float* __restrict__ scales,
                                   const float* __restrict__ w,
                                   TOut* __restrict__ mix,
                                   TOut* __restrict__ qself, long long R,
                                   int S, int T, int block, int W, int offset,
                                   int nibble, int upr, int rpb,
                                   unsigned groups) {
  constexpr int G = qinf::Vec16<TOut>::kN;
  using Word = typename qinf::Bytes<G>::type;
  const unsigned n = blockIdx.x / groups;
  long long r;
  int unit;
  if (!qinf::row_unit(upr, rpb, R, blockIdx.x - n * groups, &r, &unit))
    return;
  const long long srow0 = (long long)n * S * R + r;  // sender 0's row

  // every sender's payload word and scale, all loads issued together
  Word p[kMaxSenders];
  float sc[kMaxSenders];
#pragma unroll
  for (int s = 0; s < kMaxSenders; ++s) {
    if (s < S) {
      const long long row = srow0 + s * R;
      p[s] = __ldg(reinterpret_cast<const Word*>(packed + row * W) + unit);
      sc[s] = __ldg(scales + row);
    }
  }

  const float* wn = w + (long long)n * T * S;
  TOut* qdst = qself + ((long long)n * R + r) * block + unit * G;
  TOut* mdst = mix + ((long long)n * T * R + r) * block + unit * G;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // low nibbles, then high (nibble packing)
    if (h == 1 && !nibble) break;
    const int off = h * (block >> 1);
    // Q_s of this half, each decoded and rounded once
    float q[kMaxSenders][G];
#pragma unroll
    for (int s = 0; s < kMaxSenders; ++s) {
      if (s < S) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const uint32_t byte = qinf::byte_of(p[s], j);
          const int code =
              (int)(nibble ? (h ? byte >> 4 : byte & 0x0Fu) : byte) - offset;
          q[s][j] = round_through<TOut>(__fmul_rn((float)code, sc[s]));
        }
      }
    }
    qinf::store_vec16<kStreamStores>(qdst + off, q[0]);
    for (int t = 0; t < T; ++t) {
      float acc[G];
#pragma unroll
      for (int s = 0; s < kMaxSenders; ++s) {
        if (s < S) {
          const float ws = __ldg(wn + t * S + s);  // round t's weights
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const float term = __fmul_rn(ws, q[s][j]);
            acc[j] = s == 0 ? term : __fadd_rn(acc[j], term);
          }
        }
      }
      qinf::store_vec16<kStreamStores>(mdst + (long long)t * R * block + off,
                                       acc);
    }
  }
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

// B4, row variant (any width, alignment and S): one warp per (node, row),
// one element a lane.
template <typename TOut>
__global__ void __launch_bounds__(kThreads)
qinf_unpack_dequant_mix_row_kernel(const uint8_t* __restrict__ packed,
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

template <typename TOut>
void launch_mix(const uint8_t* packed, const float* scales, const float* w,
                TOut* mix, TOut* qself, long long nodes, int S, int T,
                long long R, int block, int W, int offset, int nibble, int vec,
                cudaStream_t st) {
  if (vec) {
    const int upr = W / qinf::Vec16<TOut>::kN;
    const int rpb = qinf::rows_per_block(upr);
    const unsigned groups = (unsigned)qinf::row_groups(upr, R);
    const dim3 grid = qinf::row_unit_grid(upr, R, nodes);
    qinf_unpack_dequant_mix_vec_kernel<TOut><<<grid, kThreads, 0, st>>>(
        packed, scales, w, mix, qself, R, S, T, block, W, offset, nibble, upr,
        rpb, groups);
  } else {
    const long long warps = nodes * R;
    const dim3 grid((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
    qinf_unpack_dequant_mix_row_kernel<TOut><<<grid, kThreads, 0, st>>>(
        packed, scales, w, mix, qself, nodes, S, T, R, block, W, offset,
        nibble);
  }
}

}  // namespace

extern "C" {

int qinf_quantize_pack_blocks_launch(const float* x, const float* u,
                                     uint8_t* packed, float* scales,
                                     long long rows, int block, int bits,
                                     int device, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  qinf::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const float levels = (float)(1 << (bits - 1));
  const int nibble = bits + 1 <= 4 ? 1 : 0;
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  qinf_quantize_pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, u, packed, scales, rows, block, levels, 1 << (bits - 1), nibble);
  return (int)cudaGetLastError();
}

// Whether B4 takes its vector variant: payload rows of whole 16-byte
// chunks (width W), at most kMaxSenders senders, 16-byte aligned payload,
// mix and qself.
int qinf_unpack_dequant_mix_blocks_vector(const void* packed, const void* mix,
                                          const void* qself, int width,
                                          int senders) {
  return width % kVecBytes == 0 && senders <= kMaxSenders &&
         qinf::aligned16(packed) && qinf::aligned16(mix) &&
         qinf::aligned16(qself);
}

int qinf_unpack_dequant_mix_blocks_launch(const uint8_t* packed,
                                          const float* scales, const float* w,
                                          void* mix, void* qself,
                                          int out_dtype, long long nodes,
                                          int S, int T, long long R,
                                          int block, int bits, int device,
                                          void* stream) {
  if (nodes * R <= 0 || block <= 0) return (int)cudaSuccess;  // no output
  const int nibble = bits + 1 <= 4 ? 1 : 0;
  const int W = nibble ? block / 2 : block;
  const int offset = 1 << (bits - 1);
  const int vec = qinf_unpack_dequant_mix_blocks_vector(packed, mix, qself, W,
                                                        S);
  qinf::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t st = (cudaStream_t)stream;
  switch (out_dtype) {
    case kF32:
      launch_mix(packed, scales, w, (float*)mix, (float*)qself, nodes, S, T, R,
                 block, W, offset, nibble, vec, st);
      break;
    case kF64:
      launch_mix(packed, scales, w, (double*)mix, (double*)qself, nodes, S, T,
                 R, block, W, offset, nibble, vec, st);
      break;
    case kBF16:
      launch_mix(packed, scales, w, (__nv_bfloat16*)mix,
                 (__nv_bfloat16*)qself, nodes, S, T, R, block, W, offset,
                 nibble, vec, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
