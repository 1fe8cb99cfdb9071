// CPython binding of the launchers of the four QInf kernels, of the two
// Prox-LEAD update kernels and of the MoE layer's two grouped products
// (module _qinf_binding).
//
// Each function checks that its inputs are what the kernel takes and
// raises the fault it finds (TypeError for a dtype, ValueError for a shape,
// the bits, an odd block under nibble packing, or tensors that are not
// contiguous on one CUDA device -- B1's x need only have rows of unit
// stride, see leaf_rows, and B5/B6 take views, see node_rows), allocates
// the kernel's outputs with at::empty on the inputs' device (PyTorch's
// caching allocator, on the C++ side), calls the kernel's C launcher from
// csrc/qinf.cu, csrc/qinf_wire.cu, csrc/proxlead_update.cu or
// csrc/moe_gemm.cu with raw
// pointers, the device index and that device's
// current PyTorch stream, and returns the outputs; a non-zero CUDA error
// raises RuntimeError, and a C++ exception (an allocation that fails)
// becomes PyTorch's Python exception for it (HANDLE_TH_ERRORS).  These are
// the only checks a CUDA tensor meets: the Python wrappers (quantize.py)
// check the CPU path's inputs alone.  The launchers' addresses come from
// set_launchers() (quantize.py loads the kernel libraries and passes them
// once); this file compiles no device code.  A METH_FASTCALL call costs
// well under a microsecond; the main path's B1/B2 calls do a few
// microseconds of device work, so everything a launch needs on the host
// happens here, and the Python wrapper only dispatches.

#include <Python.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <initializer_list>
#include <vector>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/csrc/Exceptions.h>
#include <torch/csrc/autograd/python_variable.h>

namespace {

// the C launchers (their signatures in csrc/qinf.cu and csrc/qinf_wire.cu)
using QuantizeFn = int (*)(const void*, int, long long, long long, long long,
                           const void*, void*, void*, int, int, const void*,
                           long long, int, void*);
using DequantizeFn = int (*)(const void*, const void*, void*, int, long long,
                             int, int, void*);
using PackFn = int (*)(const void*, const void*, void*, void*, long long, int,
                       int, int, void*);
using MixFn = int (*)(const void*, const void*, const void*, void*, void*,
                      int, long long, int, int, long long, int, int, int,
                      void*);
using HeadFn = int (*)(void* const*, const long long*, long long, long long,
                      long long, float, int, void*);
using TailFn = int (*)(void* const*, const long long*, long long, long long,
                      long long, int, int, const float*, int, int, void*);
using RowsMmFn = int (*)(const float*, long long, const float*, long long,
                        long long, long long, long long, float*, long long,
                        const int*, const int*, long long, const int*, int,
                        int, int, int, int, int, int, void*);
using WgradFn = int (*)(const float*, long long, const float*, long long,
                        float*, long long, long long, long long, const int*,
                        int, int, int, int, int, void*);
using ErrorFn = const char* (*)(int);

QuantizeFn g_quantize = nullptr;
DequantizeFn g_dequantize = nullptr;
PackFn g_pack = nullptr;
MixFn g_mix = nullptr;
HeadFn g_head = nullptr;
TailFn g_tail = nullptr;
RowsMmFn g_rows_mm = nullptr;
WgradFn g_wgrad = nullptr;
ErrorFn g_error = nullptr;

// output dtypes by tag (quantize.py::_DTYPE_TAG, csrc/common.cuh)
bool out_type(long tag, at::ScalarType* t) {
  if (tag < 0 || tag > 2) return false;
  *t = tag == 1 ? at::kDouble : tag == 2 ? at::kBFloat16 : at::kFloat;
  return true;
}

// the dtype tag of a B1 input, -1 for any other dtype
int in_tag(const at::Tensor& x) {
  switch (x.scalar_type()) {
    case at::kFloat: return 0;
    case at::kDouble: return 1;
    case at::kBFloat16: return 2;
    default: return -1;
  }
}

// Sets the Python exception ``exc``; returns nullptr, what a binding
// function returns once an exception is set.
template <typename... A>
std::nullptr_t raise(PyObject* exc, const char* fmt, A... args) {
  PyErr_Format(exc, fmt, args...);
  return nullptr;
}

bool parse(PyObject* const* args, Py_ssize_t nargs, Py_ssize_t want,
           int n_tensors, const char* name) {
  if (nargs != want) {
    raise(PyExc_TypeError, "%s takes %zd arguments, got %zd", name, want,
          nargs);
    return false;
  }
  for (int i = 0; i < n_tensors; ++i) {
    if (!THPVariable_Check(args[i])) {
      raise(PyExc_TypeError, "%s: argument %d is not a tensor", name, i);
      return false;
    }
  }
  return true;
}

const at::Tensor& tensor(PyObject* o) { return THPVariable_Unpack(o); }
long as_long(PyObject* o) { return PyLong_AsLong(o); }
const char* dtype(const at::Tensor& t) { return c10::toString(t.scalar_type()); }

// A tensor's shape as "[d0, d1, ...]" for an error message, written with
// snprintf: formatting the sizes with c10::str (iostreams) segfaulted in
// this module under the CUDA 12.8 build of PyTorch 2.11.
struct Shape {
  char text[128];
  explicit Shape(const at::Tensor& t) : Shape(t.sizes()) {}
  explicit Shape(c10::IntArrayRef sizes) {
    int n = snprintf(text, sizeof text, "[");
    for (size_t i = 0; i < sizes.size() && n < (int)sizeof text; ++i)
      n += snprintf(text + n, sizeof text - n, i ? ", %lld" : "%lld",
                    (long long)sizes[i]);
    if (n < (int)sizeof text) snprintf(text + n, sizeof text - n, "]");
  }
};

// B1 takes 1..8 bits (at 8 its top code saturates, see qinf.cu); the
// wire kernels B3/B4 1..7
bool bits_ok(long bits, long most = 7) {
  if (bits >= 1 && bits <= most) return true;
  raise(PyExc_ValueError, "bits must be in 1..%ld, got %ld", most, bits);
  return false;
}

// Every tensor contiguous and on the first one's CUDA device; sets
// ``*device`` to it.
bool one_device(std::initializer_list<const at::Tensor*> ts, const char* what,
                int* device) {
  *device = (*ts.begin())->is_cuda() ? (*ts.begin())->get_device() : -1;
  for (const at::Tensor* t : ts) {
    if (*device < 0 || !t->is_cuda() || t->get_device() != *device ||
        !t->is_contiguous()) {
      raise(PyExc_ValueError, "%s must be contiguous on one CUDA device",
            what);
      return false;
    }
  }
  return true;
}

void* stream_of(int device) {
  return c10::cuda::getCurrentCUDAStream(device).stream();
}

PyObject* launched(const char* kernel, int err, PyObject* result) {
  if (err != 0) {
    Py_XDECREF(result);
    PyErr_Format(PyExc_RuntimeError, "%s launch failed: CUDA error %d (%s)",
                 kernel, err, g_error(err));
    return nullptr;
  }
  return result;
}

PyObject* wrap2(const at::Tensor& a, const at::Tensor& b) {
  PyObject* pair = PyTuple_New(2);
  if (pair == nullptr) return nullptr;
  PyObject* wa = THPVariable_Wrap(a);
  PyObject* wb = wa == nullptr ? nullptr : THPVariable_Wrap(b);
  if (wb == nullptr) {
    Py_XDECREF(wa);
    Py_DECREF(pair);
    return nullptr;
  }
  PyTuple_SET_ITEM(pair, 0, wa);  // steals the references
  PyTuple_SET_ITEM(pair, 1, wb);
  return pair;
}

// The noise shape of leaf x (..., D) in blocks of B:
// blockwise_shape(x.shape, B) = (..., ceil(D / B), B), a 0-d x counting
// as (1,).
std::vector<int64_t> blocked_shape(const at::Tensor& x, int64_t B) {
  std::vector<int64_t> s(x.sizes().begin(), x.sizes().end());
  const int64_t D = s.empty() ? 1 : s.back();
  if (!s.empty()) s.pop_back();
  s.push_back((D + B - 1) / B);
  s.push_back(B);
  return s;
}

// Leaf x (..., D) as L rows of D elements, ``*ldx`` elements apart: true
// when the last axis has unit stride and the leading axes collapse to one
// row stride (any contiguous tensor, a view with a storage offset, rows
// cut from wider ones), which is what kernel B1 reads in place.
bool leaf_rows(const at::Tensor& x, int64_t* L, int64_t* ldx) {
  const int64_t d = x.dim();
  const int64_t D = d ? x.size(d - 1) : 1;
  *L = D ? x.numel() / D : 1;
  *ldx = D;
  if (d == 0 || x.numel() == 0) return true;
  if (D > 1 && x.stride(d - 1) != 1) return false;
  bool first = true;
  int64_t span = 0;  // elements spanned by the axes below axis i
  for (int64_t i = d - 2; i >= 0; --i) {
    if (x.size(i) == 1) continue;
    if (first) {
      *ldx = x.stride(i);
      first = false;
    } else if (x.stride(i) != span) {
      return false;
    }
    span = x.stride(i) * x.size(i);
  }
  return true;
}

// The last per-point level operand whose values were read and found good:
// its storage, version counter and length (see point_levels_ok).
struct CheckedLevels {
  const void* data = nullptr;
  int64_t version = -1, numel = 0;
  int device = -1;
};
CheckedLevels g_checked_levels;

// B1's per-point level operand: f32, contiguous, 1-D, on x's device, a
// length P that divides the leaf's L rows, each value a power of two in
// [1, 128].  The values are read on the host (one small copy, which waits
// for the stream) the first time a tensor is seen and again only after it
// changes (its version counter moves), so a sweep that keeps one operand
// for the whole run pays the copy once.
bool point_levels_ok(const at::Tensor& lv, const at::Tensor& x, int64_t L) {
  if (lv.scalar_type() != at::kFloat) {
    raise(PyExc_TypeError, "levels must be f32, got %s", dtype(lv));
    return false;
  }
  if (!lv.is_cuda() || !x.is_cuda() || lv.get_device() != x.get_device() ||
      !lv.is_contiguous()) {
    raise(PyExc_ValueError, "levels must be contiguous on x's CUDA device");
    return false;
  }
  const int64_t P = lv.numel();
  if (lv.dim() != 1 || P < 1 || L % P != 0) {
    raise(PyExc_ValueError, "levels %s must be (P,) with P dividing the "
          "leaf's %lld rows", Shape(lv).text, (long long)L);
    return false;
  }
  CheckedLevels& c = g_checked_levels;
  if (c.data == lv.data_ptr() && c.version == lv._version() &&
      c.numel == P && c.device == lv.get_device())
    return true;
  const at::Tensor host = lv.to(at::kCPU);
  const float* v = static_cast<float*>(host.data_ptr());
  for (int64_t i = 0; i < P; ++i) {
    const float f = v[i];
    int e = 0;
    if (!(f >= 1.0f && f <= 128.0f && std::frexp(f, &e) == 0.5f)) {
      char value[32];  // PyErr_Format has no float conversion
      snprintf(value, sizeof value, "%g", (double)f);
      raise(PyExc_ValueError, "levels[%lld] = %s is not a power of two in "
            "[1, 128] (2^(bits-1) for bits 1..8)", (long long)i, value);
      return false;
    }
  }
  c = {lv.data_ptr(), lv._version(), P, lv.get_device()};
  return true;
}

// (x (..., D), u, bits) -> (codes int8 in u's shape, scales f32 in u's
// shape with a last axis of 1): the leaf x in blocks of B = u's last axis,
// its ragged last block read in place.  u is the leaf's blocked noise
// (blocked_shape), or x's own shape when D = B (the (R, B) call).  x
// f32/f64/bf16 with rows of unit stride (leaf_rows), u f32 contiguous.
// quantize_blocks_levels takes (x, u, levels) instead: a level count per
// point (point_levels_ok), the points stacked on x's leading rows.
PyObject* quantize_any(PyObject* const* args, Py_ssize_t n, bool per_point) {
  const char* name =
      per_point ? "qinf_quantize_blocks_levels" : "qinf_quantize_blocks";
  if (!parse(args, n, 3, per_point ? 3 : 2, name)) return nullptr;
  const at::Tensor& x = tensor(args[0]);
  const at::Tensor& u = tensor(args[1]);
  const long bits = per_point ? 1 : as_long(args[2]);
  if (PyErr_Occurred()) return nullptr;
  const int tag = in_tag(x);
  int64_t L, ldx;
  const int64_t D = x.dim() ? x.size(-1) : 1;
  const int64_t B = u.dim() ? u.size(-1) : 0;
  if (B < 1 || B > (1 << 30))
    return raise(PyExc_ValueError, "noise shape %s has no block axis for x "
                 "%s", Shape(u).text, Shape(x).text);
  const std::vector<int64_t> want = blocked_shape(x, B);
  if (!u.sizes().equals(want) &&
      !(x.dim() >= 1 && D == B && u.sizes().equals(x.sizes())))
    return raise(PyExc_ValueError, "noise shape %s != blocked shape %s",
                 Shape(u).text, Shape(want).text);
  if (!bits_ok(bits, 8)) return nullptr;
  if (tag < 0 || u.scalar_type() != at::kFloat)
    return raise(PyExc_TypeError, "kernel takes x f32/f64/bf16 and u f32, "
                "got %s and %s", dtype(x), dtype(u));
  if (!x.is_cuda() || !u.is_cuda() || x.get_device() != u.get_device() ||
      !u.is_contiguous() || !leaf_rows(x, &L, &ldx))
    return raise(PyExc_ValueError, "x must have rows of unit stride and u "
                 "must be contiguous on one CUDA device");
  const at::Tensor* lv = per_point ? &tensor(args[2]) : nullptr;
  if (lv != nullptr && !point_levels_ok(*lv, x, L)) return nullptr;
  const int device = x.get_device();
  std::vector<int64_t> scale_shape(u.sizes().begin(), u.sizes().end());
  scale_shape.back() = 1;
  at::Tensor codes = at::empty(u.sizes(), u.options().dtype(at::kChar));
  at::Tensor scales = at::empty(scale_shape, u.options());
  const int err = g_quantize(
      x.data_ptr(), tag, L, D, ldx, u.data_ptr(), codes.data_ptr(),
      scales.data_ptr(), (int)B, (int)bits,
      lv != nullptr ? lv->data_ptr() : nullptr,
      lv != nullptr ? lv->numel() : 0, device, stream_of(device));
  return launched(name, err, wrap2(codes, scales));
}

PyObject* quantize_blocks(PyObject*, PyObject* const* args, Py_ssize_t n) {
  HANDLE_TH_ERRORS
  return quantize_any(args, n, false);
  END_HANDLE_TH_ERRORS
}

PyObject* quantize_blocks_levels(PyObject*, PyObject* const* args,
                                 Py_ssize_t n) {
  HANDLE_TH_ERRORS
  return quantize_any(args, n, true);
  END_HANDLE_TH_ERRORS
}

// (codes int8 (R, B), scales f32 (R, 1), out_tag) -> out (R, B)
PyObject* dequantize_blocks(PyObject*, PyObject* const* args, Py_ssize_t n) {
  HANDLE_TH_ERRORS
  if (!parse(args, n, 3, 2, "qinf_dequantize_blocks")) return nullptr;
  const at::Tensor& codes = tensor(args[0]);
  const at::Tensor& scales = tensor(args[1]);
  const long tag = as_long(args[2]);
  if (PyErr_Occurred()) return nullptr;
  at::ScalarType out_t;
  int device;
  if (codes.dim() != 2 || scales.dim() != 2 ||
      scales.size(0) != codes.size(0) || scales.size(1) != 1)
    return raise(PyExc_ValueError, "want codes (R, block) and scales (R, 1), "
                "got %s and %s", Shape(codes).text, Shape(scales).text);
  if (codes.scalar_type() != at::kChar || scales.scalar_type() != at::kFloat ||
      !out_type(tag, &out_t))
    return raise(PyExc_TypeError, "kernel takes int8 codes, f32 scales and "
                "an output tag 0 (f32), 1 (f64) or 2 (bf16), got %s, %s and "
                "%ld",
                dtype(codes), dtype(scales), tag);
  if (!one_device({&codes, &scales}, "codes and scales", &device))
    return nullptr;
  const int64_t R = codes.size(0), B = codes.size(1);
  at::Tensor out = at::empty({R, B}, codes.options().dtype(out_t));
  const int err = g_dequantize(codes.data_ptr(), scales.data_ptr(),
                               out.data_ptr(), (int)tag, R, (int)B, device,
                               stream_of(device));
  return launched("qinf_dequantize_blocks", err, THPVariable_Wrap(out));
  END_HANDLE_TH_ERRORS
}

// (x f32 (R, B), u f32 (R, B), bits) -> (packed u8 (R, W), scales f32
// (R, 1)), W = B / 2 for bits <= 3 (B even), else B
PyObject* quantize_pack_blocks(PyObject*, PyObject* const* args,
                               Py_ssize_t n) {
  HANDLE_TH_ERRORS
  if (!parse(args, n, 3, 2, "qinf_quantize_pack_blocks")) return nullptr;
  const at::Tensor& x = tensor(args[0]);
  const at::Tensor& u = tensor(args[1]);
  const long bits = as_long(args[2]);
  if (PyErr_Occurred()) return nullptr;
  const bool nibble = bits + 1 <= 4;
  int device;
  if (x.dim() != 2 || u.sizes() != x.sizes())
    return raise(PyExc_ValueError, "want x and u of one (R, block) shape, "
                "got %s and %s", Shape(x).text, Shape(u).text);
  if (!bits_ok(bits)) return nullptr;
  if (nibble && x.size(1) % 2)
    return raise(PyExc_ValueError, "nibble packing (bits <= 3) needs an even "
                "block, got %lld", (long long)x.size(1));
  if (x.scalar_type() != at::kFloat || u.scalar_type() != at::kFloat)
    return raise(PyExc_TypeError, "B3 takes f32 x and u, got %s and %s",
                dtype(x), dtype(u));
  if (!one_device({&x, &u}, "x and u", &device)) return nullptr;
  const int64_t R = x.size(0), B = x.size(1);
  at::Tensor packed =
      at::empty({R, nibble ? B / 2 : B}, x.options().dtype(at::kByte));
  at::Tensor scales = at::empty({R, 1}, x.options().dtype(at::kFloat));
  const int err = g_pack(x.data_ptr(), u.data_ptr(), packed.data_ptr(),
                         scales.data_ptr(), R, (int)B, (int)bits, device,
                         stream_of(device));
  return launched("qinf_quantize_pack_blocks", err, wrap2(packed, scales));
  END_HANDLE_TH_ERRORS
}

// (packed u8 (N, S, R, W), scales f32 (N, S, R, 1), w f32 (N, T, S), bits,
//  out_tag) -> (mix (N, T, R, B), qself (N, R, B)), B = 2 W for bits <= 3,
// else W; S, T >= 1
PyObject* unpack_dequant_mix_blocks(PyObject*, PyObject* const* args,
                                    Py_ssize_t n) {
  HANDLE_TH_ERRORS
  if (!parse(args, n, 5, 3, "qinf_unpack_dequant_mix_blocks")) return nullptr;
  const at::Tensor& packed = tensor(args[0]);
  const at::Tensor& scales = tensor(args[1]);
  const at::Tensor& w = tensor(args[2]);
  const long bits = as_long(args[3]), tag = as_long(args[4]);
  if (PyErr_Occurred()) return nullptr;
  at::ScalarType out_t;
  int device;
  if (packed.dim() != 4)
    return raise(PyExc_ValueError, "want packed (N, S, R, W), got %s",
                Shape(packed).text);
  const int64_t N = packed.size(0), S = packed.size(1), R = packed.size(2);
  const int64_t W = packed.size(3);
  if (scales.dim() != 4 || scales.size(0) != N || scales.size(1) != S ||
      scales.size(2) != R || scales.size(3) != 1 || w.dim() != 3 ||
      w.size(0) != N || w.size(2) != S || S < 1 || w.size(1) < 1)
    return raise(PyExc_ValueError, "shapes disagree: packed %s, scales %s, "
                "w %s", Shape(packed).text, Shape(scales).text,
                Shape(w).text);
  if (!bits_ok(bits)) return nullptr;
  if (packed.scalar_type() != at::kByte || scales.scalar_type() != at::kFloat ||
      w.scalar_type() != at::kFloat || !out_type(tag, &out_t))
    return raise(PyExc_TypeError, "B4 takes uint8 payloads, f32 scales and "
                "weights and an output tag 0 (f32), 1 (f64) or 2 (bf16), got "
                "%s, %s, %s and %ld", dtype(packed), dtype(scales), dtype(w), tag);
  if (!one_device({&packed, &scales, &w}, "packed, scales and w", &device))
    return nullptr;
  const int64_t T = w.size(1), B = bits + 1 <= 4 ? 2 * W : W;
  const auto opts = packed.options().dtype(out_t);
  at::Tensor mix = at::empty({N, T, R, B}, opts);
  at::Tensor qself = at::empty({N, R, B}, opts);
  const int err = g_mix(packed.data_ptr(), scales.data_ptr(), w.data_ptr(),
                        mix.data_ptr(), qself.data_ptr(), (int)tag, N, (int)S,
                        (int)T, R, (int)B, (int)bits, device,
                        stream_of(device));
  return launched("qinf_unpack_dequant_mix_blocks", err, wrap2(mix, qself));
  END_HANDLE_TH_ERRORS
}

// A node-stacked operand (N, [T,] *shape) of B5/B6 as N (x T) blocks of L
// rows of D elements: ``s`` gets its node, slot (0 without slots) and row
// strides.  True when the last axis has unit stride and the leaf's leading
// axes collapse to one row stride -- a contiguous leaf, or a view into a
// bucket group's rows (the wire's diff rows, B4's qself and mix), whose
// rows skip the block padding and whose nodes lie a group apart.
bool node_rows(const at::Tensor& t, int lead, int64_t s[3], int64_t* L,
               int64_t* D) {
  const int64_t d = t.dim();
  if (d < lead) return false;
  s[0] = t.stride(0);
  s[1] = lead == 2 ? t.stride(1) : 0;
  *L = 1;
  *D = d > lead ? t.size(d - 1) : 1;
  s[2] = *D;
  if (d == lead) return true;
  if (*D > 1 && t.stride(d - 1) != 1) return false;
  bool first = true;
  int64_t span = 0;  // elements spanned by the axes below axis i
  for (int64_t i = d - 2; i >= lead; --i) {
    *L *= t.size(i);
    if (t.size(i) == 1) continue;
    if (first) {
      s[2] = t.stride(i);
      first = false;
    } else if (t.stride(i) != span) {
      return false;
    }
    span = t.stride(i) * t.size(i);
  }
  return true;
}

// The six operands of a B5/B6 call: f32, on one CUDA device, with node
// rows (node_rows; ``lead[k]`` 2 for an operand with a slot axis), in
// the shape of ``like``'s leaf ((N, *shape), slots (N, T, *shape) with
// one T).  Fills the pointers and the (node, slot, row) strides, L, D and
// T; raises and returns false otherwise.
bool update_operands(const char* name, const at::Tensor* const* ts,
                     const int* lead, void* p[6], long long s[18],
                     int64_t* L, int64_t* D, int64_t* T, int* device) {
  const at::Tensor& like = *ts[0];
  *T = 1;
  for (int k = 0; k < 6; ++k) {
    const at::Tensor& t = *ts[k];
    if (t.scalar_type() != at::kFloat) {
      raise(PyExc_TypeError, "%s takes f32 leaves, got %s for operand %d",
            name, dtype(t), k);
      return false;
    }
  }
  for (int k = 0; k < 6; ++k) {
    const at::Tensor& t = *ts[k];
    bool same = t.dim() == like.dim() + lead[k] - 1 && like.dim() >= 1 &&
                t.size(0) == like.size(0);
    for (int64_t i = 1; same && i < like.dim(); ++i)
      same = t.size(i + lead[k] - 1) == like.size(i);
    if (same && lead[k] == 2) {
      if (*T == 1 && k == 3) *T = t.size(1);
      same = t.size(1) == *T && *T >= 1;
    }
    if (!same) {
      raise(PyExc_ValueError, "%s: operand %d %s does not match the leaf "
            "%s", name, k, Shape(t).text, Shape(like).text);
      return false;
    }
  }
  *device = like.is_cuda() ? like.get_device() : -1;
  for (int k = 0; k < 6; ++k) {
    const at::Tensor& t = *ts[k];
    int64_t st[3], l, d;
    if (*device < 0 || !t.is_cuda() || t.get_device() != *device ||
        !node_rows(t, lead[k], st, &l, &d)) {
      raise(PyExc_ValueError, "%s: the operands must lie on one CUDA "
            "device, each with rows of unit stride (operand %d)", name, k);
      return false;
    }
    *L = l;
    *D = d;
    p[k] = t.data_ptr();
    for (int j = 0; j < 3; ++j) s[k * 3 + j] = st[j];
  }
  if (like.size(0) > 65535) {
    raise(PyExc_ValueError, "%s: %lld nodes, at most 65535", name,
          (long long)like.size(0));
    return false;
  }
  return true;
}

// B5: (x, g, d, h, diff, eta) -> z, each a node-stacked f32 leaf (N,
// *shape); z = (x - eta g) - eta d is allocated here, diff (written with
// z - h) is the caller's: the bucketed wire's rows or a fresh tensor.
PyObject* proxlead_head(PyObject*, PyObject* const* args, Py_ssize_t n) {
  HANDLE_TH_ERRORS
  if (!parse(args, n, 6, 5, "proxlead_head")) return nullptr;
  const double eta = PyFloat_AsDouble(args[5]);
  if (PyErr_Occurred()) return nullptr;
  const at::Tensor& x = tensor(args[0]);
  at::Tensor z;
  if (x.scalar_type() == at::kFloat && x.is_cuda())
    z = at::empty(x.sizes(), x.options());
  else
    z = x;  // refused below, before any launch
  const at::Tensor* ts[6] = {&x, &tensor(args[1]), &tensor(args[2]),
                             &tensor(args[3]), &z, &tensor(args[4])};
  const int lead[6] = {1, 1, 1, 1, 1, 1};
  void* p[6];
  long long s[18];
  int64_t L, D, T;
  int device;
  if (!update_operands("proxlead_head", ts, lead, p, s, &L, &D, &T,
                       &device))
    return nullptr;
  const int err = g_head(p, s, x.size(0), L, D, (float)eta, device,
                         stream_of(device));
  return launched("proxlead_head", err, THPVariable_Wrap(z));
  END_HANDLE_TH_ERRORS
}

// B6: (z, d, h, hw, q, w, t, one_minus_alpha, alpha, d_coef, z_coef,
// prox_flags, thresh, div) -> None.  z, d, h, q (N, *shape); hw and w
// (N, T, *shape), slot t read.  d, h, hw are updated in place and the
// prox of the corrected z is written over z.  The Python floats are
// rounded to f32 as ATen rounds a scalar operand; a division by ``div``
// is, as on the card's eager path, a product with 1.0f / f32(div).
PyObject* proxlead_tail(PyObject*, PyObject* const* args, Py_ssize_t n) {
  HANDLE_TH_ERRORS
  if (!parse(args, n, 14, 6, "proxlead_tail")) return nullptr;
  const long t = as_long(args[6]);
  float k[6];
  for (int i = 0; i < 4; ++i) k[i] = (float)PyFloat_AsDouble(args[7 + i]);
  const long prox = as_long(args[11]);
  k[4] = (float)PyFloat_AsDouble(args[12]);
  const float div = (float)PyFloat_AsDouble(args[13]);
  if (PyErr_Occurred()) return nullptr;
  k[5] = 1.0f / div;
  const at::Tensor* ts[6] = {&tensor(args[0]), &tensor(args[1]),
                             &tensor(args[2]), &tensor(args[3]),
                             &tensor(args[4]), &tensor(args[5])};
  const int lead[6] = {1, 1, 1, 2, 1, 2};
  void* p[6];
  long long s[18];
  int64_t L, D, T;
  int device;
  if (!update_operands("proxlead_tail", ts, lead, p, s, &L, &D, &T,
                       &device))
    return nullptr;
  if (t < 0 || t >= T)
    return raise(PyExc_ValueError, "proxlead_tail: slot %ld of %lld", t,
                 (long long)T);
  if (prox < 0 || prox > 7)
    return raise(PyExc_ValueError, "proxlead_tail: prox flags %ld", prox);
  const int err = g_tail(p, s, ts[0]->size(0), L, D, (int)T, (int)t, k,
                         (int)prox, device, stream_of(device));
  Py_INCREF(Py_None);
  return launched("proxlead_tail", err, Py_None);
  END_HANDLE_TH_ERRORS
}

// An f32 (rows, width) operand of M1/M2 with rows of unit stride on
// ``device``.
bool moe_rows(const at::Tensor& t, const char* name, const char* what,
              int device) {
  if (t.scalar_type() != at::kFloat) {
    raise(PyExc_TypeError, "%s takes f32 operands, got %s for %s", name,
          dtype(t), what);
    return false;
  }
  if (t.dim() != 2 || t.stride(1) != 1 || !t.is_cuda() ||
      t.get_device() != device) {
    raise(PyExc_ValueError, "%s: %s %s must be (rows, width) with rows of "
          "unit stride on the first operand's CUDA device", name, what,
          Shape(t).text);
    return false;
  }
  return true;
}

// A contiguous int32 index vector of ``n`` entries on ``device``.
bool moe_index(const at::Tensor& t, int64_t n, const char* name,
               const char* what, int device) {
  if (t.scalar_type() != at::kInt || t.dim() != 1 || t.size(0) != n ||
      !t.is_contiguous() || !t.is_cuda() || t.get_device() != device) {
    raise(PyExc_ValueError, "%s: %s must be a contiguous int32 vector of "
          "%lld on the operands' device, got %s %s", name, what,
          (long long)n, dtype(t), Shape(t).text);
    return false;
  }
  return true;
}

// M1: (a, w, tile_group, tile_row0, offsets, transpose, accumulate, bm,
// out) -> out.  a (rows, K) f32; w (N, held, K, n) f32, or (N, held, n, K)
// under ``transpose``, with one of its two last axes of unit stride; the
// tile table (int32, one entry a bm-row tile) and the group offsets
// (int32, N held + 1) as kernels/moe.py::Plan makes them; ``out`` (rows,
// n) f32, or None for a fresh one.  Each group's live rows of ``out`` get
// (or, under ``accumulate``, gain) their product; other rows are left.
PyObject* moe_rows_mm(PyObject*, PyObject* const* args, Py_ssize_t n) {
  HANDLE_TH_ERRORS
  if (!parse(args, n, 9, 5, "moe_rows_mm")) return nullptr;
  const long transpose = as_long(args[5]), accumulate = as_long(args[6]),
             bm = as_long(args[7]);
  if (PyErr_Occurred()) return nullptr;
  const at::Tensor& a = tensor(args[0]);
  const at::Tensor& w = tensor(args[1]);
  const int device = a.is_cuda() ? a.get_device() : -1;
  if (device < 0)
    return raise(PyExc_ValueError, "moe_rows_mm: a must lie on a CUDA "
                 "device");
  if (!moe_rows(a, "moe_rows_mm", "a", device)) return nullptr;
  if (w.scalar_type() != at::kFloat)
    return raise(PyExc_TypeError, "moe_rows_mm takes f32 weights, got %s",
                 dtype(w));
  if (w.dim() != 4 || !w.is_cuda() || w.get_device() != device)
    return raise(PyExc_ValueError, "moe_rows_mm: w %s must be (nodes, held, "
                 "in, out) on a's device", Shape(w).text);
  const int64_t K = w.size(transpose ? 3 : 2), NC = w.size(transpose ? 2 : 3);
  const int64_t sk = w.stride(transpose ? 3 : 2),
                sc = w.stride(transpose ? 2 : 3);
  if (a.size(1) != K || (sk != 1 && sc != 1))
    return raise(PyExc_ValueError, "moe_rows_mm: rows of width %lld against "
                 "w %s (transpose %ld), whose rows or columns must have unit "
                 "stride", (long long)a.size(1), Shape(w).text, transpose);
  const int64_t G = w.size(0) * w.size(1);
  const at::Tensor& group = tensor(args[2]);
  const at::Tensor& row0 = tensor(args[3]);
  const at::Tensor& off = tensor(args[4]);
  if (!moe_index(group, group.numel(), "moe_rows_mm", "tile_group", device) ||
      !moe_index(row0, group.numel(), "moe_rows_mm", "tile_row0", device) ||
      !moe_index(off, G + 1, "moe_rows_mm", "offsets", device))
    return nullptr;
  at::Tensor out;
  if (args[8] == Py_None) {
    out = at::empty({a.size(0), NC}, a.options());
  } else {
    if (!THPVariable_Check(args[8]))
      return raise(PyExc_TypeError, "moe_rows_mm: out is not a tensor");
    out = tensor(args[8]);
    if (!moe_rows(out, "moe_rows_mm", "out", device)) return nullptr;
    if (out.size(0) != a.size(0) || out.size(1) != NC)
      return raise(PyExc_ValueError, "moe_rows_mm: out %s, want [%lld, "
                   "%lld]", Shape(out).text, (long long)a.size(0),
                   (long long)NC);
  }
  if (K > INT32_MAX || NC > INT32_MAX || G > INT32_MAX)
    return raise(PyExc_ValueError, "moe_rows_mm: widths past int32");
  const int err = g_rows_mm(
      static_cast<float*>(a.data_ptr()), a.stride(0), static_cast<float*>(w.data_ptr()), w.stride(0),
      w.stride(1), sk, sc, static_cast<float*>(out.data_ptr()), out.stride(0),
      static_cast<int*>(group.data_ptr()), static_cast<int*>(row0.data_ptr()), group.numel(),
      static_cast<int*>(off.data_ptr()), (int)K, (int)NC, (int)G, (int)w.size(1),
      (int)(accumulate != 0), (int)bm, device, stream_of(device));
  return launched("moe_rows_mm", err, THPVariable_Wrap(out));
  END_HANDLE_TH_ERRORS
}

// M2: (a, b, offsets, held) -> out (G / held, held, m1, m2), group g's
// a_g^T b_g over its rows; a (rows, m1), b (rows, m2) f32, offsets int32
// (G + 1).
PyObject* moe_wgrad(PyObject*, PyObject* const* args, Py_ssize_t n) {
  HANDLE_TH_ERRORS
  if (!parse(args, n, 4, 3, "moe_wgrad")) return nullptr;
  const long held = as_long(args[3]);
  if (PyErr_Occurred()) return nullptr;
  const at::Tensor& a = tensor(args[0]);
  const at::Tensor& b = tensor(args[1]);
  const at::Tensor& off = tensor(args[2]);
  const int device = a.is_cuda() ? a.get_device() : -1;
  if (device < 0)
    return raise(PyExc_ValueError, "moe_wgrad: a must lie on a CUDA device");
  if (!moe_rows(a, "moe_wgrad", "a", device) ||
      !moe_rows(b, "moe_wgrad", "b", device))
    return nullptr;
  const int64_t G = off.numel() - 1;
  if (a.size(0) != b.size(0) || held <= 0 || G <= 0 || G % held != 0 ||
      G > 65535)
    return raise(PyExc_ValueError, "moe_wgrad: a %s and b %s must share "
                 "their rows, and the offsets (%lld groups, at most 65535) "
                 "fill nodes of %ld held experts", Shape(a).text,
                 Shape(b).text, (long long)G, held);
  if (!moe_index(off, G + 1, "moe_wgrad", "offsets", device)) return nullptr;
  at::Tensor out = at::empty({G / held, (int64_t)held, a.size(1), b.size(1)},
                             a.options());
  const int err = g_wgrad(
      static_cast<float*>(a.data_ptr()), a.stride(0), static_cast<float*>(b.data_ptr()), b.stride(0),
      static_cast<float*>(out.data_ptr()), out.stride(0), out.stride(1), out.stride(2),
      static_cast<int*>(off.data_ptr()), (int)a.size(1), (int)b.size(1), (int)G, (int)held,
      device, stream_of(device));
  return launched("moe_wgrad", err, THPVariable_Wrap(out));
  END_HANDLE_TH_ERRORS
}

// (quantize, dequantize, pack, mix, head, tail, rows_mm, wgrad,
// error_string) launcher addresses
PyObject* set_launchers(PyObject*, PyObject* args) {
  PyObject *q, *d, *p, *m, *h, *t, *r, *w, *e;
  if (!PyArg_ParseTuple(args, "OOOOOOOOO", &q, &d, &p, &m, &h, &t, &r, &w,
                        &e))
    return nullptr;
  g_quantize = reinterpret_cast<QuantizeFn>(PyLong_AsVoidPtr(q));
  g_dequantize = reinterpret_cast<DequantizeFn>(PyLong_AsVoidPtr(d));
  g_pack = reinterpret_cast<PackFn>(PyLong_AsVoidPtr(p));
  g_mix = reinterpret_cast<MixFn>(PyLong_AsVoidPtr(m));
  g_head = reinterpret_cast<HeadFn>(PyLong_AsVoidPtr(h));
  g_tail = reinterpret_cast<TailFn>(PyLong_AsVoidPtr(t));
  g_rows_mm = reinterpret_cast<RowsMmFn>(PyLong_AsVoidPtr(r));
  g_wgrad = reinterpret_cast<WgradFn>(PyLong_AsVoidPtr(w));
  g_error = reinterpret_cast<ErrorFn>(PyLong_AsVoidPtr(e));
  if (PyErr_Occurred()) return nullptr;
  Py_RETURN_NONE;
}

PyMethodDef kMethods[] = {
    {"set_launchers", set_launchers, METH_VARARGS, nullptr},
    {"qinf_quantize_blocks", (PyCFunction)(void (*)(void))quantize_blocks,
     METH_FASTCALL, nullptr},
    {"qinf_quantize_blocks_levels",
     (PyCFunction)(void (*)(void))quantize_blocks_levels, METH_FASTCALL,
     nullptr},
    {"qinf_dequantize_blocks", (PyCFunction)(void (*)(void))dequantize_blocks,
     METH_FASTCALL, nullptr},
    {"qinf_quantize_pack_blocks",
     (PyCFunction)(void (*)(void))quantize_pack_blocks, METH_FASTCALL, nullptr},
    {"qinf_unpack_dequant_mix_blocks",
     (PyCFunction)(void (*)(void))unpack_dequant_mix_blocks, METH_FASTCALL,
     nullptr},
    {"proxlead_head", (PyCFunction)(void (*)(void))proxlead_head,
     METH_FASTCALL, nullptr},
    {"proxlead_tail", (PyCFunction)(void (*)(void))proxlead_tail,
     METH_FASTCALL, nullptr},
    {"moe_rows_mm", (PyCFunction)(void (*)(void))moe_rows_mm, METH_FASTCALL,
     nullptr},
    {"moe_wgrad", (PyCFunction)(void (*)(void))moe_wgrad, METH_FASTCALL,
     nullptr},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "_qinf_binding", nullptr, -1,
                       kMethods};

}  // namespace

PyMODINIT_FUNC PyInit__qinf_binding() { return PyModule_Create(&kModule); }
