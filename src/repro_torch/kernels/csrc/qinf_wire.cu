// Wire-path QInf kernels of the neighbor-gossip backend, for Hopper, sm_90a.
//
// B3  qinf_quantize_pack_vec_kernel / _row_kernel replace
//     src/repro/kernels/quantize.py::qinf_quantize_pack_blocks (Pallas body
//     _quantize_pack_kernel).
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
// B3 design.  B3 reads 8 B an element and writes a half byte or a byte, so what
// counts is one trip to memory with wide loads, and lanes that do not idle at
// narrow blocks.  Vector variant (after B1's in qinf.cu): a unit is what one
// lane turns into one 4-byte store -- under nibble packing the pair of 16-byte
// chunks (c, c + C/2) of a row of C = B/4 chunks (the HALVES partners of chunk
// c's four elements are exactly chunk c + C/2's), else one chunk.  A row has U
// = B/8 (nibble) or B/4 units. At U <= 32, a power of two, a warp holds 32/U
// rows, U lanes each, and the row max is a butterfly of log2 U shuffles inside
// each U-lane segment (block 256 at 2 bits: U = 32, one row a warp; block 8: 32
// rows a warp, no shuffle, every lane stores its own scale).  At U > 32, a
// multiple of 32, a lane holds K = U/32 units (K a template argument, blocks up
// to kPackVecMaxBlock = 1024).  Every 16-byte load of x and u is issued before
// the max and the row stays in registers for the codes; each lane writes its
// units as 4-byte stores, neighbouring lanes neighbouring words, so every warp
// store is one contiguous run; the scale is stored once a row.  The payload is
// read back at once by the wire's torch.cat, and evict-first stores measured no
// faster on an H100, so its stores are plain.  Rows per thread block: 2 warps
// while a call has fewer than kSmallCallWarps warps, 8 above (B1's rule).
// Every other shape -- an odd unit count (block 20, the vision model's gates;
// block 4 under nibble packing), x or u off the 16-byte alignment, blocks above
// 1024 -- takes the row variant, the first design: one warp a row, lane k the
// element pairs (k, k + B/2) (or the element k), x read again for the codes,
// one byte a store.  The launcher picks the variant from the shape and the
// pointers (qinf_quantize_pack_blocks_vector).  No row padding: the TPU's R % 8
// rule is gone.
//
// B4 design.  B4 takes a leading node dim: packed (N, S, R, W), scales
// (N, S, R), weights (N, T, S); each node applies its own receiver-indexed
// weights, so per node the function is exactly the TPU kernel's, and all N
// nodes of one bucket group take one launch.  It is bound by bytes, and
// most of them are the T + 1 outputs it writes: at T = 2, S = 6, nibble
// packing and f32 out it reads 3 B and writes 12 B an element against
// ~6 S + 2 T S f32 operations.  So the vector variant is built around wide,
// contiguous stores, few registers and few instructions a byte.  A thread
// owns G = 16 B / sizeof(out) payload bytes k0..k0+G-1 of one (node, row)
// for every sender (4 for f32, 8 for bf16, 2 for f64).  Per chunk of kT
// rounds it streams the senders in order, kSenders at a time: the chunk's
// payload words and scales are all loaded before any arithmetic, once for
// both output halves (low nibbles: elements k0..; high nibbles:
// B/2+k0..; byte packing has one half); then per half each Q_s is decoded
// and rounded once, written as qself at s = 0, and folded into the half's
// accumulators acc[t][G] (acc = w0 q0, then acc += ws qs); after the last
// sender every round's G outputs of a half leave as one 16-byte store.  A
// count above its chunk loops over further chunks (a further round chunk
// decodes the senders again), so any S and T take this variant.  The
// weights are read through the read-only cache, one uniform load per round
// and sender: a thread block holds one node's rows, so its lanes all read
// one word.  Holding every sender's decoded half-row instead, to reuse it
// across rounds, costs S x G registers and capped an earlier design at 4
// senders; streaming them costs 2 x kT x G accumulators.  Those bound the
// chunks (MixChunk): under the 64-register cap of __launch_bounds__ (32
// resident warps an SM) a one-round chunk holds 4 senders, a two-round one
// 8 at f32 and 6 at f64, without spills (ptxas -v); at bf16 two rounds
// spill, so bf16 accumulates one round at a time.  The launcher takes the
// one-round instance at T = 1, which holds half the accumulators: at the
// ring trainer's T = 1, S = 3 group (8 x 700,456 rows of 256, f32) it
// takes 4.6936 and 4.6853 ms against 4.6835 and 4.6817 for the earlier
// design, which held every sender's half-row (wire_ab.py, the two trees in
// turns in one call, NVIDIA H100 80GB HBM3 at 700 W), so one kernel
// serves every S and T.
// Neighbouring lanes own neighbouring words, so every warp load is one
// contiguous run and, on rows of 32 units or more, every warp store one
// contiguous 512 B run.  Stores are streaming (evict-first): the outputs
// of a bucket group far exceed the 50 MB L2.  A thread block holds whole
// rows (256 / upr rows of upr = W / G units: block 8 at 2 bits and f32 is
// one unit a row, 256 rows a block) and blockIdx.x counts (node, row
// group), so there is no 64-bit division.  Why not 16 payload bytes a
// thread: each warp store's 16-byte pieces would land 64 B apart,
// half-filling every sector they touch.  The vector variant needs every
// unit's G codes a half to make one 16-byte store: W a multiple of G, the
// payload G-byte aligned, mix and qself 16-byte aligned.  No 16-byte store
// serves any other shape -- a payload row of W % G != 0 bytes (block 20 at
// 2 bits, W = 10, and nibble-packed block 4, W = 2, for f32 and bf16;
// block 8 at 2 bits for bf16) or a view off those alignments -- so it
// takes the row variant, one warp per (node, row), one element a lane.
// The launcher picks the variant from the shape, the output dtype and the
// alignment (qinf_unpack_dequant_mix_blocks_vector).
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

constexpr int kPackVecMaxBlock = 1024;  // widest row B3's vector variant holds
constexpr bool kStreamStores = true;  // B4's outputs far exceed the L2

__device__ __forceinline__ int qinf_code(float v, float uu, float levels,
                                         float safe) {
  float mag =
      floorf(__fadd_rn(__fdiv_rn(__fmul_rn(levels, fabsf(v)), safe), uu));
  mag = fminf(mag, levels);
  const float sgn = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
  return (int)(sgn * mag);
}

// Four f32 from one 16-byte load at a 16-byte aligned address; zeros
// where ``in`` is false (nothing is read).
__device__ __forceinline__ void load4(const float* p, bool in,
                                      float (&v)[4]) {
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (in) a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// B3, vector variant: x, u (rows, block) f32, 16-byte aligned, block % 4
// == 0 (% 8 under nibble packing) -> packed (rows, W) u8, scales (rows,)
// f32.  A unit is what one lane turns into one 4-byte store: the chunk
// pair (c, c + C/2) of a row (C = block / 4 chunks of 4 f32) under nibble
// packing, whose HALVES partners are exactly each other's elements, else
// the one chunk c.  ``units`` = U units a row; 2^log2p = min(U, 32) lanes
// share a row, so a warp holds 32 >> log2p rows, and each lane K units of
// its row (units lane, lane + 32, ... when U > 32).  Every 16-byte load of
// x and u is issued before the segmented butterfly of the row max, and
// the row stays in registers for the codes.
template <bool kNibble, int K>
__global__ void __launch_bounds__(kThreads)
qinf_quantize_pack_vec_kernel(const float* __restrict__ x,
                              const float* __restrict__ u,
                              uint8_t* __restrict__ packed,
                              float* __restrict__ scales, long long rows,
                              int block, int units, int log2p, float levels,
                              int offset) {
  constexpr int kChunks = kNibble ? 2 : 1;  // chunks a unit
  const int lane = threadIdx.x & 31;
  const long long row0 =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5))
      << (5 - log2p);                          // the warp's first row
  if (row0 >= rows) return;  // uniform across the warp: shuffles stay full
  const long long row = row0 + (lane >> log2p);
  const int unit0 = lane & ((1 << log2p) - 1);
  const bool live = row < rows;
  const int half = block >> 1;  // a high nibble's element offset
  const float* xr = x + row * block;
  const float* ur = u + row * block;

  float xv[K][kChunks][4], uv[K][kChunks][4];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int unit = unit0 + 32 * k;
    const bool in = live && unit < units;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int e = 4 * unit + c * half;
      load4(xr + e, in, xv[k][c]);
      load4(ur + e, in, uv[k][c]);
    }
  }
  float maxabs = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) maxabs = fmaxf(maxabs, fabsf(xv[k][c][i]));
  // the butterfly stays inside each 2^log2p-lane segment (one row)
  for (int off = 1; off < (1 << log2p); off <<= 1)
    maxabs = fmaxf(maxabs, __shfl_xor_sync(0xffffffffu, maxabs, off));
  const float safe = maxabs > 0.0f ? maxabs : 1.0f;

  uint8_t* out = packed + row * (long long)(kNibble ? half : block);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int unit = unit0 + 32 * k;
    if (live && unit < units) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t b =
            (uint32_t)(qinf_code(xv[k][0][i], uv[k][0][i], levels, safe) +
                       offset);
        if (kNibble)
          b |= (uint32_t)(qinf_code(xv[k][kChunks - 1][i],
                                    uv[k][kChunks - 1][i], levels, safe) +
                          offset) << 4;
        word |= b << (8 * i);
      }
      *reinterpret_cast<uint32_t*>(out + 4 * unit) = word;
    }
  }
  if (live && unit0 == 0) scales[row] = __fdiv_rn(maxabs, levels);
}

// B3, row variant (any width, any alignment): one warp a row; lane k
// handles the element pairs (k, k + B/2) (nibble packing) or the element k
// and writes its byte; x is read a second time (from L1) for the codes.
__global__ void __launch_bounds__(kThreads)
qinf_quantize_pack_row_kernel(const float* __restrict__ x,
                              const float* __restrict__ u,
                              uint8_t* __restrict__ packed,
                              float* __restrict__ scales, long long rows,
                              int block, float levels, int offset,
                              int nibble) {
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

// Launches the vector variant with the smallest K (a power of two) whose
// K * 32 lanes' units cover a row of ``units`` units.
template <bool kNibble, int K>
void launch_pack_vec(dim3 grid, int threads, cudaStream_t st, const float* x,
                     const float* u, uint8_t* packed, float* scales,
                     long long rows, int block, int units, int log2p,
                     float levels, int offset) {
  if constexpr (K * 32 * (kNibble ? 8 : 4) < kPackVecMaxBlock) {
    if (units > 32 * K) {
      launch_pack_vec<kNibble, 2 * K>(grid, threads, st, x, u, packed, scales,
                                      rows, block, units, log2p, levels,
                                      offset);
      return;
    }
  }
  qinf_quantize_pack_vec_kernel<kNibble, K><<<grid, threads, 0, st>>>(
      x, u, packed, scales, rows, block, units, log2p, levels, offset);
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

// B4's vector variant: the senders a chunk holds in registers when it
// accumulates kRounds rounds at once, by output dtype (G = 4 f32, 8 bf16,
// 2 f64 outputs a thread and half), under the 64-register cap without
// spills (ptxas -v).  One round: 4 senders (wider chunks fit too, at more
// registers, and read no faster at T = 1: b4_chunks.py).  Two rounds: the
// widest that fits, 8 at f32 and 6 at f64; at bf16 two rounds of 2 x 8
// accumulators a half spill.  A call with T == 1 takes the one-round
// chunk, any other the widest round chunk of its dtype (kMaxRounds).
template <typename TOut, int kRounds>
struct MixChunk;
template <>
struct MixChunk<float, 1> {
  static constexpr int kSenders = 4;
};
template <>
struct MixChunk<float, 2> {
  static constexpr int kSenders = 8;
};
template <>
struct MixChunk<double, 1> {
  static constexpr int kSenders = 4;
};
template <>
struct MixChunk<double, 2> {
  static constexpr int kSenders = 6;
};
template <>
struct MixChunk<__nv_bfloat16, 1> {
  static constexpr int kSenders = 4;
};
template <typename TOut>
constexpr int kMaxRounds = 2;
template <>
constexpr int kMaxRounds<__nv_bfloat16> = 1;

// B4, vector variant: packed (N, S, R, W) u8 with W % G == 0, scales
// (N, S, R) f32, w (N, T, S) f32 -> mix (N, T, R, B), qself (N, R, B) of
// TOut, any S and T.  A thread owns G = Vec16<TOut>::kN payload bytes of
// one (node, row) for every sender; ``upr`` = W / G units a row,
// ``groups`` row groups a node along blockIdx.x.  Per chunk of kT rounds
// it streams the senders in chunks, each chunk's words loaded once for
// both halves, each Q_s decoded once a half and folded into the rounds'
// accumulators of its half in sender order.  The register cap (64) keeps
// 32 warps an SM resident.
template <typename TOut, int kT>
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
  constexpr int kS = MixChunk<TOut, kT>::kSenders;
  using Word = typename qinf::Bytes<G>::type;
  const unsigned n = blockIdx.x / groups;
  long long r;
  int unit;
  if (!qinf::row_unit(upr, rpb, R, blockIdx.x - n * groups, &r, &unit))
    return;
  const long long srow0 = (long long)n * S * R + r;  // sender 0's row
  const Word* pw = reinterpret_cast<const Word*>(packed + srow0 * W) + unit;
  const long long pstride = R * (long long)(W / G);  // words a sender
  const float* sc0 = scales + srow0;
  const float* wn = w + (long long)n * T * S;
  TOut* qdst = qself + ((long long)n * R + r) * block + unit * G;
  TOut* mdst = mix + ((long long)n * T * R + r) * block + unit * G;
  const long long tstride = R * (long long)block;  // mix rows of a round
  const int hoff = block >> 1;  // a high nibble's element offset

  for (int t0 = 0; t0 < T; t0 += kT) {
    float acc[2][kT][G];  // [half][round][element]
    for (int s0 = 0; s0 < S; s0 += kS) {
      // the chunk's payload words and scales, all loads issued together
      Word p[kS];
      float sc[kS];
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        if (s0 + i < S) {
          p[i] = __ldg(pw + (s0 + i) * pstride);
          sc[i] = __ldg(sc0 + (s0 + i) * R);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // low nibbles, then high
        if (h == 1 && !nibble) break;
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          const int s = s0 + i;
          if (s < S) {
            float q[G];  // Q_s of this half, decoded and rounded once
#pragma unroll
            for (int j = 0; j < G; ++j) {
              const uint32_t byte = qinf::byte_of(p[i], j);
              const int code =
                  (int)(nibble ? (h ? byte >> 4 : byte & 0x0Fu) : byte) -
                  offset;
              q[j] = round_through<TOut>(__fmul_rn((float)code, sc[i]));
            }
            if (s == 0 && t0 == 0)
              qinf::store_vec16<kStreamStores>(qdst + h * hoff, q);
#pragma unroll
            for (int k = 0; k < kT; ++k) {
              if (t0 + k < T) {
                const float ws = __ldg(wn + (t0 + k) * S + s);
#pragma unroll
                for (int j = 0; j < G; ++j) {
                  const float term = __fmul_rn(ws, q[j]);
                  acc[h][k][j] =
                      s == 0 ? term : __fadd_rn(acc[h][k][j], term);
                }
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !nibble) break;
#pragma unroll
      for (int k = 0; k < kT; ++k)
        if (t0 + k < T)
          qinf::store_vec16<kStreamStores>(
              mdst + (t0 + k) * tstride + h * hoff, acc[h][k]);
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

// B4, row variant (any width and alignment): one warp per (node, row),
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
    if (T == 1 || kMaxRounds<TOut> == 1)
      qinf_unpack_dequant_mix_vec_kernel<TOut, 1><<<grid, kThreads, 0, st>>>(
          packed, scales, w, mix, qself, R, S, T, block, W, offset, nibble,
          upr, rpb, groups);
    else
      qinf_unpack_dequant_mix_vec_kernel<TOut, kMaxRounds<TOut>>
          <<<grid, kThreads, 0, st>>>(packed, scales, w, mix, qself, R, S, T,
                                      block, W, offset, nibble, upr, rpb,
                                      groups);
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

// Whether B3 takes its vector variant: 16-byte aligned x and u, rows of
// whole units (block % 4 == 0, % 8 under nibble packing) and U units a row
// either a power of two up to 32 (several rows a warp) or a multiple of 32
// up to block kPackVecMaxBlock.
int qinf_quantize_pack_blocks_vector(const void* x, const void* u, int block,
                                     int bits) {
  const bool nibble = bits + 1 <= 4;
  const int per_unit = nibble ? 8 : 4;  // elements a unit
  if (block <= 0 || block % per_unit != 0 || !qinf::aligned16(x) ||
      !qinf::aligned16(u))
    return 0;
  const int units = block / per_unit;
  return units <= 32 ? (units & (units - 1)) == 0
                     : units % 32 == 0 && block <= kPackVecMaxBlock;
}

int qinf_quantize_pack_blocks_launch(const float* x, const float* u,
                                     uint8_t* packed, float* scales,
                                     long long rows, int block, int bits,
                                     int device, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  qinf::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const float levels = (float)(1 << (bits - 1));
  const int offset = 1 << (bits - 1);
  const bool nibble = bits + 1 <= 4;
  cudaStream_t st = (cudaStream_t)stream;
  if (qinf_quantize_pack_blocks_vector(x, u, block, bits)) {
    const int units = block / (nibble ? 8 : 4);
    int log2p = 0;  // lanes a row: min(units, 32), a power of two
    while ((1 << log2p) < units && log2p < 5) ++log2p;
    const long long warps = (rows + (32 >> log2p) - 1) >> (5 - log2p);
    const int wpb = warps < qinf::kSmallCallWarps ? 2 : kWarpsPerBlock;
    const dim3 grid((unsigned)((warps + wpb - 1) / wpb));
    if (nibble)
      launch_pack_vec<true, 1>(grid, wpb * 32, st, x, u, packed, scales, rows,
                               block, units, log2p, levels, offset);
    else
      launch_pack_vec<false, 1>(grid, wpb * 32, st, x, u, packed, scales,
                                rows, block, units, log2p, levels, offset);
  } else {
    const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
    qinf_quantize_pack_row_kernel<<<grid, kThreads, 0, st>>>(
        x, u, packed, scales, rows, block, levels, offset, nibble ? 1 : 0);
  }
  return (int)cudaGetLastError();
}

// Whether B4 takes its vector variant for an output of ``out_bytes`` a
// value: every unit's G = 16 / out_bytes codes a half make one 16-byte
// store -- payload rows of whole G-byte words (width W % G == 0), a G-byte
// aligned payload, 16-byte aligned mix and qself.  Any S and T.
int qinf_unpack_dequant_mix_blocks_vector(const void* packed, const void* mix,
                                          const void* qself, int width,
                                          int out_bytes) {
  if (out_bytes <= 0 || kVecBytes % out_bytes != 0) return 0;
  const int G = kVecBytes / out_bytes;
  return width > 0 && width % G == 0 &&
         reinterpret_cast<uintptr_t>(packed) % G == 0 &&
         qinf::aligned16(mix) && qinf::aligned16(qself);
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
  const int out_bytes = out_dtype == kF64 ? 8 : out_dtype == kBF16 ? 2 : 4;
  const int vec =
      qinf_unpack_dequant_mix_blocks_vector(packed, mix, qself, W, out_bytes);
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
