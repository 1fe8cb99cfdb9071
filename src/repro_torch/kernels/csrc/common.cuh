// Shared by qinf.cu and qinf_wire.cu: dtype tags, the f32 -> output dtype
// conversions, 16-byte vector stores and the launchers' device guard.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qinf {

// dtype tags shared with quantize.py::_DTYPE_TAG
constexpr int kF32 = 0;
constexpr int kF64 = 1;
constexpr int kBF16 = 2;

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
// below this many warps a call runs 2 warps a thread block, so that its
// rows spread over the H100's 132 SMs; 8 warps above
constexpr long long kSmallCallWarps = 132LL * kWarpsPerBlock;
constexpr int kVecBytes = 16;  // one vector store; rows of the vector
                               // variants are whole multiples of it

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

// Elements of T that fill one 16-byte store: 4 f32, 8 bf16, 2 f64.
template <typename T>
struct Vec16 {
  static constexpr int kN = kVecBytes / (int)sizeof(T);
};

// G bytes loaded as one word: the codes or payload bytes behind one
// 16-byte store of Vec16<T>::kN = G elements.
template <int G>
struct Bytes;
template <>
struct Bytes<2> { using type = unsigned short; };
template <>
struct Bytes<4> { using type = unsigned int; };
template <>
struct Bytes<8> { using type = uint2; };

// Byte j (known at compile time once unrolled) of a word of Bytes<G>.
__device__ __forceinline__ uint32_t byte_of(unsigned short w, int j) {
  return ((uint32_t)w >> (8 * j)) & 0xFFu;
}
__device__ __forceinline__ uint32_t byte_of(unsigned int w, int j) {
  return (w >> (8 * j)) & 0xFFu;
}
__device__ __forceinline__ uint32_t byte_of(const uint2& w, int j) {
  return ((j < 4 ? w.x : w.y) >> (8 * (j & 3))) & 0xFFu;
}

// The vector variants' thread layout over (rows, units) with ``upr`` units
// per row: a thread block holds ``rpb`` = kThreads / upr whole rows when a
// row has at most kThreads units (lanes of a warp on consecutive units, so
// each warp load and store covers one contiguous run), else blockIdx.y cuts
// a row's units into kThreads-wide slices (rpb = 1).  ``group`` is the
// block's row group (rows group * rpb ...).  Returns false for a thread
// past the last row or unit.
__device__ __forceinline__ bool row_unit(int upr, int rpb, long long rows,
                                         long long group, long long* row,
                                         int* unit) {
  int rib = 0;
  if (upr <= kThreads) {
    rib = (int)threadIdx.x / upr;
    *unit = (int)threadIdx.x - rib * upr;
    if (rib >= rpb) return false;
  } else {
    *unit = (int)(blockIdx.y * kThreads + threadIdx.x);
    if (*unit >= upr) return false;
  }
  *row = group * rpb + rib;
  return *row < rows;
}

// Host side of row_unit: rows per thread block, row groups, and the grid
// for ``depth`` independent (rows, units) tables laid along grid.x.
inline int rows_per_block(int upr) { return upr <= kThreads ? kThreads / upr : 1; }
inline long long row_groups(int upr, long long rows) {
  const int rpb = rows_per_block(upr);
  return (rows + rpb - 1) / rpb;
}
inline dim3 row_unit_grid(int upr, long long rows, long long depth) {
  return dim3((unsigned)(row_groups(upr, rows) * depth),
              upr <= kThreads ? 1u : (unsigned)((upr + kThreads - 1) / kThreads));
}

template <bool kStream, typename V>
__device__ __forceinline__ void st16(V* p, const V& v) {
  if constexpr (kStream) {
    __stcs(p, v);  // evict-first: output that is not read again soon
  } else {
    *p = v;
  }
}

// Vec16<T>::kN values, converted to T, as one 16-byte store at a 16-byte
// aligned address.
template <bool kStream>
__device__ __forceinline__ void store_vec16(float* dst, const float (&v)[4]) {
  st16<kStream>(reinterpret_cast<float4*>(dst),
                make_float4(v[0], v[1], v[2], v[3]));
}
template <bool kStream>
__device__ __forceinline__ void store_vec16(double* dst, const float (&v)[2]) {
  st16<kStream>(reinterpret_cast<double2*>(dst),
                make_double2((double)v[0], (double)v[1]));
}
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
template <bool kStream>
__device__ __forceinline__ void store_vec16(__nv_bfloat16* dst,
                                            const float (&v)[8]) {
  st16<kStream>(reinterpret_cast<uint4*>(dst),
                make_uint4(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]),
                           bf16x2_bits(v[4], v[5]), bf16x2_bits(v[6], v[7])));
}

// Makes ``device`` current for one launch and restores the caller's device
// afterwards; costs one cudaGetDevice when ``device`` is current already.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    int cur = -1;
    err_ = cudaGetDevice(&cur);
    if (err_ == cudaSuccess && cur != device) {
      err_ = cudaSetDevice(device);
      if (err_ == cudaSuccess) prev_ = cur;
    }
  }
  ~DeviceGuard() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_ = cudaSuccess;
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace qinf
