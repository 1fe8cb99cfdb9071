// The grouped products of the expert-share MoE layer, for Hopper, sm_90a.
//
// M1  moe_rows_mm_kernel: each group's live rows times that group's expert
//     matrix, or its transpose, C[r] (+)= A[r] W_g, for the sorted rows r
//     of group g = node * held + expert (the experts' forward products and
//     the rows' gradients in backward).
// M2  moe_wgrad_kernel: each group's A_g^T B_g over its rows, the held
//     experts' weight gradients.
//
// Neither replaces a TPU kernel: the reference routes through dense
// one-hot dispatch and combine tensors and einsums (src/repro/models/
// moe.py).  The port's dropless layer sorts the routed slots by (node,
// held expert) on the device (kernels/moe.py::plan), and these kernels run
// every group's product in one launch.  The number of rows in each group
// is known only on the device: M1 reads a tile table (the group and first
// row of each BM-row tile, computed on the device from the sorted offsets
// and sized for the most tiles any routing gives), M2 reads the offsets
// themselves, so nothing is read back to the host and a tile past the live
// ones returns at once.
//
// Bound.  The port trains in float32 with TF32 off, so the products run
// outside the tensor cores: 67 TFLOP/s of f32 FMA on the H100.  At the
// deepseek-moe-16b.ring4 cell's shapes (D 2,048, F 1,408, ~190 rows a
// group) each product does ~2 x 6,100 x 2,048 x 1,408 = 35 GFLOP against
// ~170 MB of operands: bound by the arithmetic, ~0.5 ms a launch.
//
// Design.  A classic register-tiled SIMT product: a block computes a
// BM x 128 tile of C with 8 x 8 outputs a thread, walking the depth in
// steps of 8 through two shared-memory buffers (the next step's operands
// are loaded into registers while the current step computes, then stored
// into the other buffer: one barrier a step).  Shared memory holds both
// operands depth-major (As[k][m], Bs[k][n]), so a thread reads its 8 + 8
// operands of a depth step as four 16-byte loads; rows are padded by 4
// floats, so the transposing stores hit distinct banks.  Global loads are
// masked and coalesced along whichever axis of an operand is contiguous: the loaders are templated on it, so the transposed weight of
// backward (W^T, contiguous along the depth) and M2's row-major A (A^T,
// contiguous along the output rows) are read along their contiguous axis
// and transposed on the way into shared memory, never strided; where the
// rows are 16-byte aligned and the widths multiples of 4 (the cell's), a
// load is 16 bytes.  Tiles of 64 rows (a group's ~190 rows fill 3 tiles
// to 99 %; M2 runs on the same shape, its depth the group's rows), three
// blocks an SM.  Sums are plain f32 FMAs in depth order; a result differs
// from cuBLAS's f32 product by rounding only.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBK = 8;   // depth a step
constexpr int kTM = 8;   // output rows a thread
constexpr int kTN = 8;   // output columns a thread
constexpr int kBN = 128; // output columns a block
constexpr int kPad = 4;  // shared-memory row padding, floats

struct Params {
  // A(m, k) at a[m * sam + k * sak]; B(k, n) at b_g[k * sbk + n * sbn],
  // b_g = b + (g / held) * sbn_node + (g % held) * sbe; C(m, n) at
  // c_g[m * scm + n], c_g = c + (g / held) * scn + (g % held) * sce
  const float* a;
  long long sam, sak;
  const float* b;
  long long sbk, sbn, sbnode, sbe;
  float* c;
  long long scm, scn, sce;
  const int* tile_group;  // M1: the group of each BM-row tile, G past the live
  const int* tile_row0;   // M1: its first sorted row
  const int* offsets;     // (G + 1,): the first row of each group, then R
  int M, N, K;            // M2: M rows of C; M1: K the depth
  int groups, held;
  int accumulate;         // M1: C += A W instead of C = A W
  int vec;                // C's rows 16-byte aligned: 16-byte stores
};

// V consecutive floats of an operand's contiguous axis: one 16-byte load
// (V = 4) or one float (V = 1)
template <int V>
struct Unit {
  float v[V];
};

template <int V>
__device__ __forceinline__ Unit<V> load_unit(const float* p, bool ok) {
  Unit<V> u;
  if constexpr (V == 4) {
    const float4 x = ok ? *reinterpret_cast<const float4*>(p)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    u.v[0] = x.x;
    u.v[1] = x.y;
    u.v[2] = x.z;
    u.v[3] = x.w;
  } else {
    u.v[0] = ok ? *p : 0.0f;
  }
  return u;
}

// One BM x kBN tile of C (the module note); both kernels below are this.
// Each global load is a unit of V floats along the operand's contiguous
// axis; V = 4 where every operand's rows are 16-byte aligned and the
// widths a multiple of 4, so a unit is wholly in bounds or wholly out.
template <int BM, bool kWgrad, bool kAKContig, bool kBNContig, int V>
__device__ __forceinline__ void gemm_tile(const Params& q) {
  constexpr int NT = (BM / kTM) * (kBN / kTN);
  constexpr int A_PER = BM * kBK / V / NT;  // units a thread a step
  constexpr int B_PER = kBN * kBK / V / NT;
  static_assert(A_PER * NT * V == BM * kBK && B_PER * NT * V == kBN * kBK,
                "tile loads must divide evenly");
  __shared__ __align__(16) float As[2][kBK][BM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];

  const int tid = threadIdx.x;
  int g, m0, m1, k0, k1;
  if (kWgrad) {
    g = blockIdx.z;
    m0 = blockIdx.x * BM;
    m1 = q.M;
    k0 = q.offsets[g];
    k1 = q.offsets[g + 1];
  } else {
    g = q.tile_group[blockIdx.x];
    if (g >= q.groups) return;  // past the live tiles
    m0 = q.tile_row0[blockIdx.x];
    m1 = min(m0 + BM, q.offsets[g + 1]);
    k0 = 0;
    k1 = q.K;
  }
  const int n0 = blockIdx.y * kBN;
  const long long node = g / q.held, expert = g % q.held;
  const float* __restrict__ A = q.a;
  const float* __restrict__ B = q.b + node * q.sbnode + expert * q.sbe;
  float* __restrict__ C = q.c + node * q.scn + expert * q.sce;

  // unit i of a thread: its (m or n, k) in the tile; k-contiguous units run
  // along k, the others along m or n
  auto a_at = [&](int i, int* m, int* k) {
    const int idx = tid + i * NT;
    if (kAKContig) {
      *m = idx / (kBK / V);
      *k = (idx % (kBK / V)) * V;
    } else {
      *k = idx / (BM / V);
      *m = (idx % (BM / V)) * V;
    }
  };
  auto b_at = [&](int i, int* n, int* k) {
    const int idx = tid + i * NT;
    if (kBNContig) {
      *k = idx / (kBN / V);
      *n = (idx % (kBN / V)) * V;
    } else {
      *n = idx / (kBK / V);
      *k = (idx % (kBK / V)) * V;
    }
  };
  Unit<V> ra[A_PER], rb[B_PER];
  auto load = [&](int kt) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      int m, k;
      a_at(i, &m, &k);
      const int gm = m0 + m, gk = kt + k;
      const bool ok = gm < m1 && gk < k1;
      ra[i] = load_unit<V>(
          A + (ok ? (long long)gm * q.sam + (long long)gk * q.sak : 0), ok);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      int n, k;
      b_at(i, &n, &k);
      const int gn = n0 + n, gk = kt + k;
      const bool ok = gn < q.N && gk < k1;
      rb[i] = load_unit<V>(
          B + (ok ? (long long)gk * q.sbk + (long long)gn * q.sbn : 0), ok);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      int m, k;
      a_at(i, &m, &k);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (kAKContig)
          As[buf][k + j][m] = ra[i].v[j];
        else
          As[buf][k][m + j] = ra[i].v[j];
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      int n, k;
      b_at(i, &n, &k);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (kBNContig)
          Bs[buf][k][n + j] = rb[i].v[j];
        else
          Bs[buf][k + j][n] = rb[i].v[j];
      }
    }
  };

  // thread (tx, ty) owns rows ty*4 + {0..3} and BM/2 + ty*4 + {0..3}, and
  // columns tx*4 + {0..3} and kBN/2 + tx*4 + {0..3}
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  if (k0 < k1) {
    load(k0);
    store(0);
    __syncthreads();
    int buf = 0;
    for (int kt = k0; kt < k1; kt += kBK) {
      const bool more = kt + kBK < k1;
      if (more) load(kt + kBK);
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[buf][k][BM / 2 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[buf][k][kBN / 2 + tx * 4]);
        const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (more) store(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + (i / 4) * (BM / 2) + ty * 4 + (i % 4);
    if (gm >= m1) continue;
    float* row = C + (long long)gm * q.scm;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * (kBN / 2) + tx * 4;
      float v[4] = {acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                    acc[i][h * 4 + 3]};
      if (q.vec && gn + 3 < q.N) {
        float4* p = reinterpret_cast<float4*>(row + gn);
        if (q.accumulate) {
          const float4 o = *p;
          v[0] += o.x;
          v[1] += o.y;
          v[2] += o.z;
          v[3] += o.w;
        }
        *p = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < q.N) row[gn + j] = q.accumulate ? row[gn + j] + v[j] : v[j];
      }
    }
  }
}

constexpr int kRowsBM = 64;
constexpr int kThreads = (kRowsBM / kTM) * (kBN / kTN);
// blocks an SM keeps: at 3 a thread has 168 registers, enough for its 64
// sums, 16 operands and the staged loads without spilling
constexpr int kMinBlocks = 3;

// M1; kBNContig false: the weight is read transposed
template <bool kBNContig, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    moe_rows_mm_kernel(Params q) {
  gemm_tile<kRowsBM, false, true, kBNContig, V>(q);
}

// M2, on M1's tile shape
template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    moe_wgrad_kernel(Params q) {
  gemm_tile<kRowsBM, true, false, true, V>(q);
}

bool aligned_rows(const float* base, long long s0, long long s1, long long s2,
                  int n) {
  return qinf::aligned16(base) && s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0 &&
         n % 4 == 0;
}

}  // namespace

extern "C" {

// M1: c (rows, n_out) (+)= a (rows, K) times w_g for every live row of
// every group.  ``w`` (N, held, K, n_out) with strides (sw_node, sw_e,
// sw_k, sw_c); the transpose is a stride swap by the caller, and one of
// sw_k, sw_c must be 1.  ``tiles`` entries of (tile_group, tile_row0),
// made for tiles of ``bm`` rows, which must be kRowsBM.
int moe_rows_mm_launch(const float* a, long long sa, const float* w,
                       long long sw_node, long long sw_e, long long sw_k,
                       long long sw_c, float* c, long long sc,
                       const int* tile_group, const int* tile_row0,
                       long long tiles, const int* offsets, int K, int n_out,
                       int groups, int held, int accumulate, int bm,
                       int device, void* stream) {
  if (bm != kRowsBM || (sw_c != 1 && sw_k != 1))
    return (int)cudaErrorInvalidValue;
  if (tiles <= 0 || n_out <= 0 || groups <= 0) return (int)cudaSuccess;
  qinf::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  Params q{};
  q.a = a;
  q.sam = sa;
  q.sak = 1;
  q.b = w;
  q.sbk = sw_k;
  q.sbn = sw_c;
  q.sbnode = sw_node;
  q.sbe = sw_e;
  q.c = c;
  q.scm = sc;
  q.tile_group = tile_group;
  q.tile_row0 = tile_row0;
  q.offsets = offsets;
  q.N = n_out;
  q.K = K;
  q.groups = groups;
  q.held = held;
  q.accumulate = accumulate;
  q.vec = aligned_rows(c, sc, 0, 0, n_out);
  // 16-byte units: a's rows along the depth, w's along its unit axis
  const bool units =
      aligned_rows(a, sa, 0, 0, K) &&
      aligned_rows(w, sw_node, sw_e, sw_c == 1 ? sw_k : sw_c,
                   sw_c == 1 ? n_out : K);
  const dim3 grid((unsigned)tiles, (unsigned)((n_out + kBN - 1) / kBN));
  cudaStream_t st = (cudaStream_t)stream;
  if (sw_c == 1 && units)
    moe_rows_mm_kernel<true, 4><<<grid, kThreads, 0, st>>>(q);
  else if (sw_c == 1)
    moe_rows_mm_kernel<true, 1><<<grid, kThreads, 0, st>>>(q);
  else if (units)
    moe_rows_mm_kernel<false, 4><<<grid, kThreads, 0, st>>>(q);
  else
    moe_rows_mm_kernel<false, 1><<<grid, kThreads, 0, st>>>(q);
  return (int)cudaGetLastError();
}

// M2: c[g / held, g % held] = a_g^T b_g over group g's rows, a (rows, m1)
// and b (rows, m2) with row strides sa, sb; c (N, held, m1, m2) with
// strides (sc_node, sc_e, sc_1, 1).  A group with no rows gets zeros.
int moe_wgrad_launch(const float* a, long long sa, const float* b,
                     long long sb, float* c, long long sc_node, long long sc_e,
                     long long sc_1, const int* offsets, int m1, int m2,
                     int groups, int held, int device, void* stream) {
  if (m1 <= 0 || m2 <= 0 || groups <= 0) return (int)cudaSuccess;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  qinf::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  Params q{};
  q.a = a;
  q.sam = 1;
  q.sak = sa;
  q.b = b;
  q.sbk = sb;
  q.sbn = 1;
  q.c = c;
  q.scm = sc_1;
  q.scn = sc_node;
  q.sce = sc_e;
  q.offsets = offsets;
  q.M = m1;
  q.N = m2;
  q.groups = groups;
  q.held = held;
  q.vec = aligned_rows(c, sc_1, sc_node, sc_e, m2);
  const dim3 grid((unsigned)((m1 + kRowsBM - 1) / kRowsBM),
                  (unsigned)((m2 + kBN - 1) / kBN), (unsigned)groups);
  cudaStream_t st = (cudaStream_t)stream;
  if (aligned_rows(a, sa, 0, 0, m1) && aligned_rows(b, sb, 0, 0, m2))
    moe_wgrad_kernel<4><<<grid, kThreads, 0, st>>>(q);
  else
    moe_wgrad_kernel<1><<<grid, kThreads, 0, st>>>(q);
  return (int)cudaGetLastError();
}

}  // extern "C"
