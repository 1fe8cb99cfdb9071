// The Prox-LEAD update of the neighbor-gossip trainer, for Hopper, sm_90a.
//
// B5  proxlead_head_kernel: lines 6-7 of Algorithm 1 before the exchange,
//     z = (x - eta g) - eta d and the diff z - h.
// B6  proxlead_tail_kernel: lines 7-10 after it, H, Hw and D updated in
//     place and the prox of the corrected z written over z as the new X.
//
// Neither replaces a TPU kernel: the reference leaves these lines to XLA,
// which fuses them on its own (src/repro/optim/decentralized.py,
// local_step).  The port ran them as ~20 eager ATen ops a leaf, each a
// whole pass over a node-stacked leaf, plus five passes of the l1 prox
// (src/repro_torch/optim/decentralized.py::_sharded_update and
// core/prox.py::_soft keep that sequence where these kernels do not serve).
//
// Bound.  Both are bound by device-memory bytes and do almost no
// arithmetic.  B5 reads x, g, d and h and writes z and the diff: 24 B an
// element against 5 f32 operations.  B6 reads z, d, h, q (the node's own
// dequantized payload) and T Hw and T W Q slots and writes d, h, the T Hw
// slots and x: 4 (7 + 3 T) B an element, 40 at T = 1 and 52 at T = 2,
// against ~15 operations.  At 67 TFLOP/s (f32) against 3.35 TB/s the
// operations cost a few percent of the bytes.
//
// Design.  Every stream is read and written once, so the kernels are one
// pass with wide accesses and enough bytes in flight.  Every operand is a
// node-stacked leaf seen as (nodes, rows, cols) with its own node, slot
// and row strides and a unit inner stride: the state's leaves are
// contiguous, but the diff rows of the bucketed wire and B4's qself and
// mix outputs are views into bucket-group tables, with the group's row
// count between nodes and the block padding between rows.  Where every
// operand's rows follow one another (no padding: row stride = cols), the
// launcher folds a node's rows into one, so the loop carries no division.
// A thread block works on one node (blockIdx.y) and walks its elements
// with a grid-stride loop in units of V elements; the grid holds as many
// blocks as the card keeps resident (the occupancy API, 132 SMs), split
// evenly over the nodes, so each block makes many trips and no second
// partial wave waits.  Vector variant (V = 4): every operand 16-byte
// aligned, cols and every stride a multiple of 4 elements; each unit is
// one 16-byte load a stream, all issued before the arithmetic (6 loads in
// B6 at T = 1, 8 at T = 2: the Hw and W Q slots are a template argument
// there, so they too load before any store), and one 16-byte store a
// written stream.  Stores and B6's loads are evict-first: nothing is read
// again before the next step's forward pass, far beyond the 50 MB L2.
// B5, which writes none of what it reads, loads through the read-only
// path (__ldg): 11.87 against 12.18 ms over the qwen3 cells' state, where
// B6 measured no gain from it; plain stores cost B5 7 % and B6 2 %, a
// grid of 2 or 4 times the resident blocks moved neither, and a cap of
// 32 registers slowed B6 by 6-17 % (NVIDIA H100 80GB HBM3, 700 W, each
// variant twice in turns in one call).
// Any other leaf -- an odd last axis (whisper's conv weights, last axis
// 3), a view off the alignment -- takes the scalar variant (V = 1), the
// same loop one element a unit.  Both launchers pick the variant by one
// rule (proxlead_vector).
//
// Exactness.  The kernels compute the eager sequence operation for
// operation, in its order, each ATen kernel's rounding kept: a separate
// eager op is __fmul_rn / __fadd_rn / __fsub_rn, so nvcc contracts nothing
// into an FMA that the eager path rounds twice.  One eager op is an FMA on
// the card: `Hw.add_(W Q, alpha=alpha)` (T > 1), which ATen's add kernel
// computes as self + alpha * other in one expression that nvcc contracts;
// here it is __fmaf_rn(alpha, wq, hw).  The scalar constants come rounded
// to f32 from the host as ATen rounds a Python float operand
// (f32(gamma / (2 eta)), f32(1 - alpha), ...); a division of a leaf by a
// host scalar is, on the card, a product with the f32 reciprocal computed
// on the host, so the prox's divisor arrives as that reciprocal.  The l1
// prox is sign(z) * max(|z| - t, 0) with ATen's sign ((0 < z) - (z < 0))
// and its NaN-keeping clamp.  Build without --use_fast_math.
//
// Plain C interface (no PyTorch headers): csrc/binding.cpp checks the
// tensors, allocates z and hands each launcher the operands' pointers and
// strides, the device index and the current stream; each launcher returns
// cudaGetLastError() so a refused launch raises in Python.

#include "common.cuh"

namespace {

using qinf::kThreads;

// prox flags, shared with kernels/proxlead.py::PROX_FLAGS
constexpr int kSoft = 1;    // soft-threshold at thresh
constexpr int kNonneg = 2;  // clamp at 0, NaN kept
constexpr int kDiv = 4;     // times recip (a division by a host scalar)

// operands a kernel takes and strides an operand (node, slot, row)
constexpr int kOperands = 6;
constexpr int kStrides = 3;

struct Operand {
  float* p;
  long long sn, st, sl;  // node, slot and row strides, in elements
};

struct Operands {
  Operand o[kOperands];
};

struct TailConsts {
  float one_minus_alpha, alpha, d_coef, z_coef, thresh, recip;
  int prox;
};

// V elements at p: evict-first, or (kReadOnly: memory the kernel does not
// write) through the read-only data path.
template <int V, bool kReadOnly = false>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4* q = reinterpret_cast<const float4*>(p);
    float4 a;
    if constexpr (kReadOnly)
      a = __ldg(q);
    else
      a = __ldcs(q);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else if constexpr (kReadOnly) {
    v[0] = __ldg(p);
  } else {
    v[0] = __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

// ATen's clamp(v, min=0): NaN kept, else max(v, 0)
__device__ __forceinline__ float clamp0(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

__device__ __forceinline__ float prox(float v, const TailConsts& k) {
  if (k.prox & kSoft) {  // sign(v) * clamp(|v| - t, min=0)
    const float m = clamp0(__fsub_rn(fabsf(v), k.thresh));
    v = __fmul_rn((float)((0.0f < v) - (v < 0.0f)), m);
  }
  if (k.prox & kNonneg) v = clamp0(v);
  if (k.prox & kDiv) v = __fmul_rn(v, k.recip);
  return v;
}

// Element offset of unit i of node n's (rows, cols) view: the row and the
// column, with no division when the rows were folded into one.
struct Walk {
  long long rows, upr;  // rows a node, units a row
  __device__ __forceinline__ void at(long long i, long long* l,
                                     long long* c) const {
    if (rows > 1) {
      *l = i / upr;
      *c = i - *l * upr;
    } else {
      *l = 0;
      *c = i;
    }
  }
};

__device__ __forceinline__ float* node_base(const Operand& o) {
  return o.p + (long long)blockIdx.y * o.sn;
}

// B5: ops x, g, d, h (read), z, diff (written).
template <int V>
__global__ void __launch_bounds__(kThreads)
    proxlead_head_kernel(Operands ops, Walk walk, float eta) {
  float* base[kOperands];
#pragma unroll
  for (int k = 0; k < kOperands; ++k) base[k] = node_base(ops.o[k]);
  const long long units = walk.rows * walk.upr;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < units; i += step) {
    long long l, c;
    walk.at(i, &l, &c);
    float* at[kOperands];
#pragma unroll
    for (int k = 0; k < kOperands; ++k)
      at[k] = base[k] + l * ops.o[k].sl + c * V;
    float x[V], g[V], d[V], h[V], z[V], diff[V];
    load<V, true>(at[0], x);
    load<V, true>(at[1], g);
    load<V, true>(at[2], d);
    load<V, true>(at[3], h);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      // z = x - eta * g - eta * d, left to right
      z[e] = __fsub_rn(__fsub_rn(x[e], __fmul_rn(g[e], eta)),
                       __fmul_rn(d[e], eta));
      diff[e] = __fsub_rn(z[e], h[e]);
    }
    store<V>(at[4], z);
    store<V>(at[5], diff);
  }
}

// B6: ops z (read, then the new X), d, h (updated), hw (kSlots slots,
// updated), q (read), w (kSlots slots, read); round t's slot is read.
// kSlots 1 or 2; 0: any slot count, the slots loaded and stored one by
// one.
template <int V, int kSlots>
__global__ void __launch_bounds__(kThreads)
    proxlead_tail_kernel(Operands ops, Walk walk, int slots, int t,
                         TailConsts k) {
  float* base[kOperands];
#pragma unroll
  for (int j = 0; j < kOperands; ++j) base[j] = node_base(ops.o[j]);
  const long long st_hw = ops.o[3].st, st_w = ops.o[5].st;
  const long long units = walk.rows * walk.upr;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < units; i += step) {
    long long l, c;
    walk.at(i, &l, &c);
    float* at[kOperands];
#pragma unroll
    for (int j = 0; j < kOperands; ++j)
      at[j] = base[j] + l * ops.o[j].sl + c * V;
    float z[V], d[V], h[V], q[V], zw[V];
    load<V>(at[0], z);
    load<V>(at[1], d);
    load<V>(at[2], h);
    load<V>(at[4], q);
    if constexpr (kSlots == 1) {
      float hw[V], w[V];
      load<V>(at[3], hw);
      load<V>(at[5], w);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        zw[e] = __fadd_rn(w[e], hw[e]);  // zhat_w = W Q + Hw
        hw[e] = __fadd_rn(__fmul_rn(hw[e], k.one_minus_alpha),
                          __fmul_rn(k.alpha, zw[e]));
      }
      store<V>(at[3], hw);
    } else if constexpr (kSlots == 2) {
      float hw0[V], hw1[V], w0[V], w1[V];
      load<V>(at[3], hw0);
      load<V>(at[3] + st_hw, hw1);
      load<V>(at[5], w0);
      load<V>(at[5] + st_w, w1);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        // slot k % T
        zw[e] = t == 0 ? __fadd_rn(hw0[e], w0[e]) : __fadd_rn(hw1[e], w1[e]);
        // Hw[t'] += alpha W_t' Q (ATen's add with alpha: one FMA)
        hw0[e] = __fmaf_rn(k.alpha, w0[e], hw0[e]);
        hw1[e] = __fmaf_rn(k.alpha, w1[e], hw1[e]);
      }
      store<V>(at[3], hw0);
      store<V>(at[3] + st_hw, hw1);
    } else {
      for (int s = 0; s < slots; ++s) {
        float hw[V], w[V];
        load<V>(at[3] + s * st_hw, hw);
        load<V>(at[5] + s * st_w, w);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (s == t) zw[e] = __fadd_rn(hw[e], w[e]);
          hw[e] = __fmaf_rn(k.alpha, w[e], hw[e]);
        }
        store<V>(at[3] + s * st_hw, hw);
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float zhat = __fadd_rn(q[e], h[e]);  // Q_self + H
      h[e] = __fadd_rn(__fmul_rn(h[e], k.one_minus_alpha),
                       __fmul_rn(k.alpha, zhat));
      const float err = __fsub_rn(zhat, zw[e]);
      d[e] = __fadd_rn(d[e], __fmul_rn(k.d_coef, err));
      z[e] = prox(__fsub_rn(z[e], __fmul_rn(k.z_coef, err)), k);
    }
    store<V>(at[1], d);
    store<V>(at[2], h);
    store<V>(at[0], z);
  }
}

// The operands of one call: pointers and strides as the binding passes
// them, a node's rows folded into one row of rows x cols where every
// operand's rows follow one another.
Operands operands(void* const* p, const long long* s, long long* rows,
                  long long* cols) {
  Operands ops;
  bool fold = true;
  for (int k = 0; k < kOperands; ++k) {
    ops.o[k] = {static_cast<float*>(p[k]), s[k * kStrides],
                s[k * kStrides + 1], s[k * kStrides + 2]};
    fold = fold && (*rows == 1 || ops.o[k].sl == *cols);
  }
  if (fold && *rows > 1) {
    *cols *= *rows;
    *rows = 1;
    for (int k = 0; k < kOperands; ++k) ops.o[k].sl = *cols;
  }
  return ops;
}

// Whether every operand takes 16-byte units: aligned, cols and every
// stride a multiple of 4 elements.
bool vector_ok(void* const* p, const long long* s, long long cols) {
  if (cols % 4 != 0) return false;
  for (int k = 0; k < kOperands; ++k) {
    if (!qinf::aligned16(p[k])) return false;
    for (int j = 0; j < kStrides; ++j)
      if (s[k * kStrides + j] % 4 != 0) return false;
  }
  return true;
}

// Thread blocks of ``kernel`` the current device keeps resident at once
// (SMs x blocks an SM), asked once per kernel and device.
template <typename K>
cudaError_t resident_blocks(K kernel, long long* out) {
  struct Entry {
    const void* fn;
    int device;
    long long blocks;
  };
  static Entry cache[32];
  static int used = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < used; ++i) {
    if (cache[i].fn == fn && cache[i].device == device) {
      *out = cache[i].blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  *out = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (used < 32) cache[used++] = {fn, device, *out};
  return cudaSuccess;
}

// Blocks a node: the card's resident blocks of ``kernel`` split over the
// nodes, no more than a node's units need.
template <typename K>
cudaError_t grid_for(K kernel, long long nodes, long long units, dim3* grid) {
  long long resident = 0;
  const cudaError_t err = resident_blocks(kernel, &resident);
  if (err != cudaSuccess) return err;
  long long x = (resident + nodes - 1) / nodes;
  const long long need = (units + kThreads - 1) / kThreads;
  if (x > need) x = need;
  *grid = dim3((unsigned)(x > 0 ? x : 1), (unsigned)nodes);
  return cudaSuccess;
}

template <typename K, typename... A>
int launch(K kernel, long long nodes, long long units, cudaStream_t stream,
           A... args) {
  dim3 grid;
  const cudaError_t err = grid_for(kernel, nodes, units, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Whether B5 or B6 takes its vector variant: ``p`` the six operands'
// pointers, ``s`` their (node, slot, row) strides, ``cols`` the last axis.
int proxlead_vector(void* const* p, const long long* s, long long cols) {
  return vector_ok(p, s, cols);
}

int proxlead_head_launch(void* const* p, const long long* s, long long nodes,
                         long long rows, long long cols, float eta,
                         int device, void* stream) {
  if (nodes <= 0 || rows <= 0 || cols <= 0) return (int)cudaSuccess;
  qinf::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const bool vec = proxlead_vector(p, s, cols);
  const Operands ops = operands(p, s, &rows, &cols);
  const int V = vec ? 4 : 1;
  const Walk walk{rows, cols / V};
  const long long units = rows * walk.upr;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    return launch(proxlead_head_kernel<4>, nodes, units, st, ops, walk, eta);
  return launch(proxlead_head_kernel<1>, nodes, units, st, ops, walk, eta);
}

// ``k``: f32 (1 - alpha, alpha, gamma / (2 eta), gamma / 2, the prox's
// threshold, the reciprocal of its divisor); ``prox``: its flags.
int proxlead_tail_launch(void* const* p, const long long* s, long long nodes,
                         long long rows, long long cols, int slots, int t,
                         const float* k, int prox, int device, void* stream) {
  if (nodes <= 0 || rows <= 0 || cols <= 0) return (int)cudaSuccess;
  if (slots < 1 || t < 0 || t >= slots) return (int)cudaErrorInvalidValue;
  qinf::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const bool vec = proxlead_vector(p, s, cols);
  const Operands ops = operands(p, s, &rows, &cols);
  const TailConsts c{k[0], k[1], k[2], k[3], k[4], k[5], prox};
  const int V = vec ? 4 : 1;
  const Walk walk{rows, cols / V};
  const long long units = rows * walk.upr;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    if (slots == 1)
      return launch(proxlead_tail_kernel<4, 1>, nodes, units, st, ops, walk,
                    slots, t, c);
    if (slots == 2)
      return launch(proxlead_tail_kernel<4, 2>, nodes, units, st, ops, walk,
                    slots, t, c);
    return launch(proxlead_tail_kernel<4, 0>, nodes, units, st, ops, walk,
                  slots, t, c);
  }
  if (slots == 1)
    return launch(proxlead_tail_kernel<1, 1>, nodes, units, st, ops, walk,
                  slots, t, c);
  return launch(proxlead_tail_kernel<1, 0>, nodes, units, st, ops, walk,
                slots, t, c);
}

}  // extern "C"
