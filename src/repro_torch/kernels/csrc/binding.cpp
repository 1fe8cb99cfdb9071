// CPython binding of the four QInf kernels' launchers (module _qinf_binding).
//
// Each function checks that its inputs are what the kernel takes and
// raises the fault it finds (TypeError for a dtype, ValueError for a shape,
// the bits, an odd block under nibble packing, or tensors that are not
// contiguous on one CUDA device -- B1's x need only have rows of unit
// stride, see leaf_rows), allocates the kernel's outputs with
// at::empty on the inputs' device (PyTorch's caching allocator, on the C++
// side), calls the kernel's C launcher from csrc/qinf.cu or
// csrc/qinf_wire.cu with raw pointers, the device index and that device's
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

#include <cstddef>
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
                           const void*, void*, void*, int, int, int, void*);
using DequantizeFn = int (*)(const void*, const void*, void*, int, long long,
                             int, int, void*);
using PackFn = int (*)(const void*, const void*, void*, void*, long long, int,
                       int, int, void*);
using MixFn = int (*)(const void*, const void*, const void*, void*, void*,
                      int, long long, int, int, long long, int, int, int,
                      void*);
using ErrorFn = const char* (*)(int);

QuantizeFn g_quantize = nullptr;
DequantizeFn g_dequantize = nullptr;
PackFn g_pack = nullptr;
MixFn g_mix = nullptr;
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

// (x (..., D), u, bits) -> (codes int8 in u's shape, scales f32 in u's
// shape with a last axis of 1): the leaf x in blocks of B = u's last axis,
// its ragged last block read in place.  u is the leaf's blocked noise
// (blocked_shape), or x's own shape when D = B (the (R, B) call).  x
// f32/f64/bf16 with rows of unit stride (leaf_rows), u f32 contiguous.
PyObject* quantize_blocks(PyObject*, PyObject* const* args, Py_ssize_t n) {
  HANDLE_TH_ERRORS
  if (!parse(args, n, 3, 2, "qinf_quantize_blocks")) return nullptr;
  const at::Tensor& x = tensor(args[0]);
  const at::Tensor& u = tensor(args[1]);
  const long bits = as_long(args[2]);
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
  const int device = x.get_device();
  std::vector<int64_t> scale_shape(u.sizes().begin(), u.sizes().end());
  scale_shape.back() = 1;
  at::Tensor codes = at::empty(u.sizes(), u.options().dtype(at::kChar));
  at::Tensor scales = at::empty(scale_shape, u.options());
  const int err = g_quantize(x.data_ptr(), tag, L, D, ldx, u.data_ptr(),
                             codes.data_ptr(), scales.data_ptr(), (int)B,
                             (int)bits, device, stream_of(device));
  return launched("qinf_quantize_blocks", err, wrap2(codes, scales));
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

// (quantize, dequantize, pack, mix, error_string) launcher addresses
PyObject* set_launchers(PyObject*, PyObject* args) {
  PyObject *q, *d, *p, *m, *e;
  if (!PyArg_ParseTuple(args, "OOOOO", &q, &d, &p, &m, &e)) return nullptr;
  g_quantize = reinterpret_cast<QuantizeFn>(PyLong_AsVoidPtr(q));
  g_dequantize = reinterpret_cast<DequantizeFn>(PyLong_AsVoidPtr(d));
  g_pack = reinterpret_cast<PackFn>(PyLong_AsVoidPtr(p));
  g_mix = reinterpret_cast<MixFn>(PyLong_AsVoidPtr(m));
  g_error = reinterpret_cast<ErrorFn>(PyLong_AsVoidPtr(e));
  if (PyErr_Occurred()) return nullptr;
  Py_RETURN_NONE;
}

PyMethodDef kMethods[] = {
    {"set_launchers", set_launchers, METH_VARARGS, nullptr},
    {"qinf_quantize_blocks", (PyCFunction)(void (*)(void))quantize_blocks,
     METH_FASTCALL, nullptr},
    {"qinf_dequantize_blocks", (PyCFunction)(void (*)(void))dequantize_blocks,
     METH_FASTCALL, nullptr},
    {"qinf_quantize_pack_blocks",
     (PyCFunction)(void (*)(void))quantize_pack_blocks, METH_FASTCALL, nullptr},
    {"qinf_unpack_dequant_mix_blocks",
     (PyCFunction)(void (*)(void))unpack_dequant_mix_blocks, METH_FASTCALL,
     nullptr},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "_qinf_binding", nullptr, -1,
                       kMethods};

}  // namespace

PyMODINIT_FUNC PyInit__qinf_binding() { return PyModule_Create(&kModule); }
