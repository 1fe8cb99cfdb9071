"""Builds, loads and launches the hand-written CUDA kernels.

``csrc/qinf.cu`` holds B1 (quantize) and B2 (dequantize), ``csrc/
qinf_wire.cu`` B3 (quantize + wire pack) and B4 (unpack + dequantize +
mix): the Hopper versions of the Pallas kernels in
``repro.kernels.quantize``.  ``csrc/proxlead_update.cu`` holds B5 and B6,
the neighbor trainer's Prox-LEAD update (their wrappers are
:mod:`repro_torch.kernels.proxlead`).  All include ``csrc/common.cuh``
and have a plain C interface.  ``csrc/binding.cpp`` is a small CPython
module (no device code) through which every launch goes: it checks the
inputs, allocates a kernel's outputs with ``at::empty`` and calls the
kernel's C launcher.  :func:`build` compiles the kernel sources with
``nvcc`` for ``sm_90a`` and the
binding with the host C++ compiler against PyTorch's headers, one compiler
process per source, all started together, into ``_build/`` next to this
file (keyed by a hash of the sources, flags and PyTorch version, so an
unchanged source builds once); ctypes loads the kernel libraries and hands
the launchers' addresses to the binding.  Nothing is compiled at import,
and any build or launch failure raises.

The wrappers dispatch on the device of their input: a CUDA tensor
launches the kernel, a CPU tensor runs the plain version from
:mod:`repro_torch.kernels.ref`, a ``meta`` tensor takes the card's route
dry (:func:`_dry`), and any other device raises.  There is no fallback
from the card to the plain version.

The ``meta`` route is what a dry run of a step
(:mod:`repro_torch.launch.dryrun`) sees of a kernel: it makes the checks
the binding makes, raising the same error types, and allocates the
outputs the binding would allocate, with ``torch.empty`` -- the one ATen
op (``aten::empty.memory_format``) the binding's ``at::empty`` shows a
dispatch mode on the card -- in the binding's order.  It computes and
launches nothing, so it is no fallback: nothing runs on ``meta``.  Its
calls count in :data:`META_CALLS`, never in :data:`LAUNCHES`.

One launch path, :func:`_launch`, serves every kernel and keeps the
host's share of a call small (the main path's B1/B2 calls do a few
microseconds of device work): for a CUDA tensor the wrapper hands its
arguments straight to the binding -- a CPython ``METH_FASTCALL`` function
-- which checks dtypes, shapes, bits, device and contiguity and raises
TypeError or ValueError naming the fault, allocates the outputs on the
C++ side and launches on the inputs' device and its current PyTorch
stream.  The wrappers' own checks serve the CPU path only.  The C
launcher switches device only if the tensors live on another one than the
current and returns ``cudaGetLastError()``; the binding raises on any
error, and :func:`_launch` counts the launch in :data:`LAUNCHES`.  Each
kernel has a vector and a row variant; its C launcher picks one from the
shape and the alignment of inputs and outputs, B4's also from its output
dtype (:func:`uses_vector_variant` asks it).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys
import sysconfig
import tempfile
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.kernels import ref as kref

_HERE = pathlib.Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
#: the kernel libraries (nvcc) and the binding that launches them (C++)
SOURCES = {"qinf": _CSRC / "qinf.cu", "qinf_wire": _CSRC / "qinf_wire.cu",
           "proxlead_update": _CSRC / "proxlead_update.cu",
           "binding": _CSRC / "binding.cpp"}
HEADERS = (_CSRC / "common.cuh",)
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

# dtype tags shared with csrc/common.cuh and csrc/binding.cpp
_DTYPE_TAG = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

#: launches of each kernel since the last :func:`reset_launch_counts`;
#: incremented only where a wrapper launches its kernel on the card
LAUNCHES: Dict[str, int] = {"qinf_quantize_blocks": 0,
                            "qinf_dequantize_blocks": 0,
                            "qinf_quantize_pack_blocks": 0,
                            "qinf_unpack_dequant_mix_blocks": 0,
                            "proxlead_head": 0, "proxlead_tail": 0}


#: calls of each kernel's wrapper on ``meta`` tensors since the last
#: :func:`reset_meta_calls`: the launches a dry-run step would make
META_CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def reset_meta_calls() -> None:
    for k in META_CALLS:
        META_CALLS[k] = 0


def meta_call_counts() -> Dict[str, int]:
    return dict(META_CALLS)


def packed_width(block: int, bits: int) -> int:
    """Wire bytes per quantization block: nibble-packed for bits <= 3."""
    return block // 2 if kref.wire_bits_per_element(bits) == 4 else block


def _nvcc() -> str:
    cands = [os.environ.get("NVCC"), shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME); the CUDA "
                       "kernels cannot be built")


def _command(name: str, out: str) -> List[str]:
    """The compiler command that builds source ``name`` into ``out``."""
    src = str(SOURCES[name])
    if name != "binding":
        return [_nvcc(), *NVCC_FLAGS, "-o", out, src]
    from torch.utils import cpp_extension
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (set CXX); the kernel "
                           "binding cannot be built")
    libdir = cpp_extension.library_paths()[0]
    cuda_include = os.path.join(os.path.dirname(os.path.dirname(_nvcc())),
                                "include")
    return [cxx, *CXX_FLAGS,
            f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
            *(f"-I{p}" for p in cpp_extension.include_paths()),
            f"-I{cuda_include}", f"-I{sysconfig.get_paths()['include']}",
            "-o", out, src, f"-L{libdir}", f"-Wl,-rpath,{libdir}", "-lc10",
            "-lc10_cuda", "-ltorch", "-ltorch_cpu", "-ltorch_python"]


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in HEADERS:
        h.update(header.read_bytes())
    h.update(" ".join(_command(name, "")).encode())
    h.update(f"{torch.__version__} {sys.version}".encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_log(name: str) -> pathlib.Path:
    """What the compiler printed while building source ``name`` (for the
    kernel sources ``ptxas``'s registers, shared memory and spills of
    every kernel)."""
    return _lib_path(name).with_suffix(".log")


def build() -> Dict[str, pathlib.Path]:
    """Compile every source of :data:`SOURCES` that was not built yet, one
    compiler per source, all started together; returns name -> shared
    library path and leaves the compiler's output in :func:`build_log`.
    Raises on any compiler error."""
    libs = {name: _lib_path(name) for name in SOURCES}
    todo = [name for name, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to private names, then rename: a concurrent build never
    # loads a half-written library
    jobs = {}
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs[name] = (tmp, subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        failed = []
        for name, (tmp, proc) in jobs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{proc.args[0]} failed ({proc.returncode}) on "
                              f"{SOURCES[name]}:\n{out}\n{err}")
            else:
                build_log(name).write_text(out + err)
                os.replace(tmp, libs[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for tmp, proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return libs


@functools.lru_cache(maxsize=None)
def _libs() -> Dict[str, object]:
    """Builds what is missing, loads the kernel libraries and the binding,
    and hands the binding the kernels' C launchers."""
    paths = build()
    q, w, u = (ctypes.CDLL(str(paths[n]))
               for n in ("qinf", "qinf_wire", "proxlead_update"))
    spec = importlib.util.spec_from_file_location("_qinf_binding",
                                                  paths["binding"])
    binding = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(binding)

    def addr(fn) -> int:
        return ctypes.cast(fn, ctypes.c_void_p).value

    binding.set_launchers(addr(q.qinf_quantize_blocks_launch),
                          addr(q.qinf_dequantize_blocks_launch),
                          addr(w.qinf_quantize_pack_blocks_launch),
                          addr(w.qinf_unpack_dequant_mix_blocks_launch),
                          addr(u.proxlead_head_launch),
                          addr(u.proxlead_tail_launch),
                          addr(q.qinf_error_string))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    q.qinf_quantize_blocks_vector.argtypes = [vp, i32, i64, i64, vp, i32]
    q.qinf_dequantize_blocks_vector.argtypes = [vp, vp, i32]
    w.qinf_quantize_pack_blocks_vector.argtypes = [vp, vp, i32, i32]
    w.qinf_unpack_dequant_mix_blocks_vector.argtypes = [vp, vp, vp, i32, i32]
    u.proxlead_vector.argtypes = [vp, vp, i64]
    for entry in (*LAUNCHES, *_ENTRIES):
        _LAUNCHERS[entry] = getattr(binding, entry)
    return {"qinf": q, "qinf_wire": w, "proxlead_update": u,
            "binding": binding}


#: binding call -> its binding function, filled by the first :func:`_libs`
_LAUNCHERS: Dict[str, Callable] = {}
#: binding calls other than the four kernels' own -> the kernel they launch
_ENTRIES: Dict[str, str] = {
    "qinf_quantize_blocks_levels": "qinf_quantize_blocks"}


def _launch(entry: str, *args):
    """Launches a kernel through the binding call ``entry`` (a kernel's
    name, or one of :data:`_ENTRIES`) with ``args`` (its inputs as
    ``csrc/binding.cpp`` takes them), counts the launch under the kernel's
    name and returns the outputs the binding allocated.  The binding
    raises, launching nothing, on inputs the kernel does not take, and
    raises on any CUDA error."""
    if not _LAUNCHERS:
        _libs()
    out = _LAUNCHERS[entry](*args)
    LAUNCHES[_ENTRIES.get(entry, entry)] += 1
    return out


def uses_vector_variant(kernel: str, *args) -> bool:
    """Whether the C launcher of B1 (``args``: the leaf x and its noise u,
    tensors), B2 (codes and output pointers, block), B3 (x and u, tensors,
    and the bits) or B4 (the payload, mix and qself, tensors: the rule
    reads the payload width, the output dtype and the alignments) takes
    its vector variant: the choice the launcher makes at every launch,
    asked by the tests and ``chip_smoke.py`` (B5/B6's:
    :func:`repro_torch.kernels.proxlead.uses_vector_variant`)."""
    libs = _libs()
    if kernel == "qinf_quantize_blocks":
        x, u = args
        D = x.shape[-1] if x.dim() else 1
        # the row stride: that of the innermost leading axis longer than 1
        ldx = next((x.stride(i) for i in reversed(range(x.dim() - 1))
                    if x.shape[i] > 1), D)
        return bool(libs["qinf"].qinf_quantize_blocks_vector(
            x.data_ptr(), _DTYPE_TAG.get(x.dtype, -1), x.numel() // max(D, 1),
            ldx, u.data_ptr(), u.shape[-1]))
    if kernel == "qinf_dequantize_blocks":
        return bool(libs["qinf"].qinf_dequantize_blocks_vector(*args))
    if kernel == "qinf_quantize_pack_blocks":
        x, u, bits = args
        return bool(libs["qinf_wire"].qinf_quantize_pack_blocks_vector(
            x.data_ptr(), u.data_ptr(), x.shape[-1], bits))
    packed, mix, qself = args
    return bool(libs["qinf_wire"].qinf_unpack_dequant_mix_blocks_vector(
        packed.data_ptr(), mix.data_ptr(), qself.data_ptr(), packed.shape[-1],
        mix.element_size()))


def _leaf_rows(x: torch.Tensor):
    """(rows, ok) of leaf x (..., D) as B1 reads it in place
    (``csrc/binding.cpp::leaf_rows``): ok when the last axis has unit
    stride and the leading axes collapse to one row stride."""
    d = x.dim()
    D = x.shape[-1] if d else 1
    rows = x.numel() // D if D else 1
    if d == 0 or x.numel() == 0:
        return rows, True
    if D > 1 and x.stride(-1) != 1:
        return rows, False
    span = None                     # elements spanned by the axes below
    for i in reversed(range(d - 1)):
        if x.shape[i] == 1:
            continue
        if span is not None and x.stride(i) != span:
            return rows, False
        span = x.stride(i) * x.shape[i]
    return rows, True


def _dry(kernel: str, *shapes_dtypes, device) -> tuple:
    """The card's outputs of ``kernel`` on ``meta``: one ``torch.empty``
    per (shape, dtype), in the binding's order; counts the call in
    :data:`META_CALLS`."""
    META_CALLS[kernel] += 1
    outs = tuple(torch.empty(shape, dtype=dtype, device=device)
                 for shape, dtype in shapes_dtypes)
    return outs if len(outs) > 1 else outs[0]


def _meta_quantize(x, u, bits, levels):
    """B1's binding checks (``quantize_any``) and outputs, on ``meta``."""
    B = u.shape[-1] if u.dim() else 0
    if not 1 <= B <= 1 << 30:
        raise ValueError(f"noise shape {list(u.shape)} has no block axis for "
                         f"x {list(x.shape)}")
    D = x.shape[-1] if x.dim() else 1
    want = tuple(x.shape[:-1]) + (-(-D // B), B)
    if tuple(u.shape) != want and not (x.dim() >= 1 and D == B
                                       and u.shape == x.shape):
        raise ValueError(f"noise shape {list(u.shape)} != blocked shape "
                         f"{list(want)}")
    if levels is None and not 1 <= bits <= 8:
        raise ValueError(f"bits must be in 1..8, got {bits}")
    if x.dtype not in _DTYPE_TAG or u.dtype != torch.float32:
        raise TypeError(f"kernel takes x f32/f64/bf16 and u f32, got "
                        f"{x.dtype} and {u.dtype}")
    rows, ok = _leaf_rows(x)
    if not (ok and u.is_meta and u.is_contiguous()):
        raise ValueError("x must have rows of unit stride and u must be "
                         "contiguous on one device")
    if levels is not None:
        if levels.dtype != torch.float32:
            raise TypeError(f"levels must be f32, got {levels.dtype}")
        if not (levels.is_meta and levels.is_contiguous()):
            raise ValueError("levels must be contiguous on x's device")
        P = levels.numel()
        if levels.dim() != 1 or P < 1 or rows % P:
            raise ValueError(f"levels {list(levels.shape)} must be (P,) with "
                             f"P dividing the leaf's {rows} rows")
    return _dry("qinf_quantize_blocks", (u.shape, torch.int8),
                (u.shape[:-1] + (1,), torch.float32), device=u.device)


def _one_device(ts, what: str) -> None:
    if not all(t.is_meta and t.is_contiguous() for t in ts):
        raise ValueError(f"{what} must be contiguous on one device")


def _meta_dequantize(codes, scales, out_dtype):
    """B2's binding checks and output, on ``meta``."""
    if (codes.dim() != 2 or scales.dim() != 2
            or scales.shape != (codes.shape[0], 1)):
        raise ValueError(f"want codes (R, block) and scales (R, 1), got "
                         f"{list(codes.shape)} and {list(scales.shape)}")
    if (codes.dtype != torch.int8 or scales.dtype != torch.float32
            or out_dtype not in _DTYPE_TAG):
        raise TypeError(f"kernel takes int8 codes, f32 scales and an f32, "
                        f"f64 or bf16 output, got {codes.dtype}, "
                        f"{scales.dtype} and {out_dtype}")
    _one_device((codes, scales), "codes and scales")
    return _dry("qinf_dequantize_blocks", (codes.shape, out_dtype),
                device=codes.device)


def _meta_quantize_pack(x, u, bits):
    """B3's binding checks and outputs, on ``meta``."""
    if x.dim() != 2 or u.shape != x.shape:
        raise ValueError(f"want x and u of one (R, block) shape, got "
                         f"{list(x.shape)} and {list(u.shape)}")
    if not 1 <= bits <= 7:
        raise ValueError(f"bits must be in 1..7, got {bits}")
    R, B = x.shape
    if B % 2 and kref.wire_bits_per_element(bits) == 4:
        raise ValueError(f"nibble packing (bits <= 3) needs an even block, "
                         f"got {B}")
    if x.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"B3 takes f32 x and u, got {x.dtype} and {u.dtype}")
    _one_device((x, u), "x and u")
    return _dry("qinf_quantize_pack_blocks",
                ((R, packed_width(B, bits)), torch.uint8),
                ((R, 1), torch.float32), device=x.device)


def _meta_unpack_dequant_mix(packed, scales, w, bits, out_dtype):
    """B4's binding checks and outputs, on ``meta``."""
    if packed.dim() != 4:
        raise ValueError(f"want packed (N, S, R, W), got "
                         f"{list(packed.shape)}")
    N, S, R, W = packed.shape
    if (scales.shape != (N, S, R, 1) or w.dim() != 3
            or w.shape[::2] != (N, S) or min(S, w.shape[1]) < 1):
        raise ValueError(f"shapes disagree: packed {list(packed.shape)}, "
                         f"scales {list(scales.shape)}, w {list(w.shape)}")
    if not 1 <= bits <= 7:
        raise ValueError(f"bits must be in 1..7, got {bits}")
    if (packed.dtype != torch.uint8 or scales.dtype != torch.float32
            or w.dtype != torch.float32 or out_dtype not in _DTYPE_TAG):
        raise TypeError(f"B4 takes uint8 payloads, f32 scales and weights "
                        f"and an f32/f64/bf16 output, got {packed.dtype}, "
                        f"{scales.dtype}, {w.dtype} -> {out_dtype}")
    _one_device((packed, scales, w), "packed, scales and w")
    B = 2 * W if kref.wire_bits_per_element(bits) == 4 else W
    return _dry("qinf_unpack_dequant_mix_blocks",
                ((N, w.shape[1], R, B), out_dtype), ((N, R, B), out_dtype),
                device=packed.device)


def _plain_device(t: torch.Tensor) -> None:
    """The plain versions run on the CPU only; any other device raises."""
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")


def qinf_quantize_blocks(x: torch.Tensor, u: torch.Tensor, bits: int,
                         levels: Optional[torch.Tensor] = None):
    """B1: quantize (R, block) rows -> (codes int8 (R, block), scales f32
    (R, 1)).  ``x`` f32, f64 or bf16; ``u`` f32 U[0,1) noise of x's shape;
    1 <= bits <= 8 (codes are int8 in [-2^{b-1}, 2^{b-1}]; at 8 bits the
    code +128 saturates to +127, as the reference's cast does).

    ``levels`` (P,) f32, each a level count 2^{b-1} for bits b in 1..8,
    replaces ``bits``: the rows are P equal runs, one a grid point, and run
    p quantizes at ``levels[p]`` (the sweep's stacked grid, one launch for
    every point at its own bits).  P must divide the rows.

    On the card the kernel also takes a whole leaf x (..., D) with its
    blocked noise u (..., ceil(D / block), block) and reads the ragged last
    block in place (codes in u's shape, scales with its last axis 1), as
    :func:`repro_torch.kernels.ops.qinf_quantize_lastdim` calls it; the
    (R, block) call is the case D = block, and the P runs are then runs of
    the leaf's rows."""
    if x.is_cuda:
        if levels is not None:
            return _launch("qinf_quantize_blocks_levels", x, u, levels)
        return _launch("qinf_quantize_blocks", x, u, bits)
    if x.is_meta:
        return _meta_quantize(x, u, bits, levels)
    if x.dim() != 2 or u.shape != x.shape:
        raise ValueError(f"want x and u of one (R, block) shape, got "
                         f"{tuple(x.shape)} and {tuple(u.shape)}")
    _plain_device(x)
    if levels is not None:
        return kref.qinf_quantize_blocks_ref(
            x, u, levels=kref.levels_per_row(levels, x.shape[0]))
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in 1..8, got {bits}")
    return kref.qinf_quantize_blocks_ref(x, u, bits)


def qinf_dequantize_blocks(codes: torch.Tensor, scales: torch.Tensor,
                           out_dtype=torch.float32) -> torch.Tensor:
    """B2: codes (R, block) int8 times scales (R, 1) f32, computed in f32
    and written as ``out_dtype`` (f32, f64 or bf16)."""
    if codes.is_cuda:
        return _launch("qinf_dequantize_blocks", codes, scales,
                       _DTYPE_TAG.get(out_dtype, -1))
    if codes.is_meta:
        return _meta_dequantize(codes, scales, out_dtype)
    if codes.dim() != 2 or scales.shape != (codes.shape[0], 1):
        raise ValueError(f"want codes (R, block) and scales (R, 1), got "
                         f"{tuple(codes.shape)} and {tuple(scales.shape)}")
    _plain_device(codes)
    return kref.qinf_dequantize_blocks_ref(codes, scales, out_dtype)


def qinf_quantize_pack_blocks(x: torch.Tensor, u: torch.Tensor, bits: int):
    """B3: quantize (R, block) f32 rows and wire-pack them -> (packed uint8
    (R, W), scales f32 (R, 1)), W = :func:`packed_width`.  Offset codes
    ``c + 2^{b-1}``, two to a byte in HALVES order for bits <= 3 (so an
    even block), one byte each otherwise; ``u`` f32 U[0,1) noise of x's
    shape; 1 <= bits <= 7."""
    if x.is_cuda:
        return _launch("qinf_quantize_pack_blocks", x, u, bits)
    if x.is_meta:
        return _meta_quantize_pack(x, u, bits)
    if x.dim() != 2 or u.shape != x.shape:
        raise ValueError(f"want x and u of one (R, block) shape, got "
                         f"{tuple(x.shape)} and {tuple(u.shape)}")
    if not 1 <= bits <= 7:
        raise ValueError(f"bits must be in 1..7, got {bits}")
    if x.shape[1] % 2 and kref.wire_bits_per_element(bits) == 4:
        raise ValueError(f"nibble packing (bits <= 3) needs an even block, "
                         f"got {x.shape[1]}")
    if x.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"B3 takes f32 x and u, got {x.dtype} and {u.dtype}")
    _plain_device(x)
    return kref.qinf_quantize_pack_blocks_ref(x, u, bits)


def qinf_unpack_dequant_mix_blocks(packed: torch.Tensor, scales: torch.Tensor,
                                   w: torch.Tensor, bits: int,
                                   out_dtype=torch.float32):
    """B4: unpack + dequantize + weighted mix of the S payloads of one
    bucket group (sender 0 is self), for every node at once.

    ``packed`` (N, S, R, W) uint8, ``scales`` (N, S, R, 1) f32, ``w``
    (N, T, S) f32 with S, T >= 1 -> (mix (N, T, R, B), qself (N, R, B)) in
    ``out_dtype`` (f32, f64 or bf16): node n mixes with its own weights,
    mix[n, t] = sum_s w[n, t, s] Q_s accumulated in f32 in sender order,
    each Q_s rounded through ``out_dtype`` first.  One launch covers all
    nodes."""
    if packed.is_cuda:
        return _launch("qinf_unpack_dequant_mix_blocks", packed, scales, w,
                       bits, _DTYPE_TAG.get(out_dtype, -1))
    if packed.is_meta:
        return _meta_unpack_dequant_mix(packed, scales, w, bits, out_dtype)
    if packed.dim() != 4:
        raise ValueError(f"want packed (N, S, R, W), got "
                         f"{tuple(packed.shape)}")
    N, S, R, W = packed.shape
    if (scales.shape != (N, S, R, 1) or w.dim() != 3
            or w.shape[::2] != (N, S) or min(S, w.shape[1]) < 1):
        raise ValueError(f"shapes disagree: packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}, w {tuple(w.shape)}")
    if not 1 <= bits <= 7:
        raise ValueError(f"bits must be in 1..7, got {bits}")
    if (packed.dtype != torch.uint8 or scales.dtype != torch.float32
            or w.dtype != torch.float32 or out_dtype not in _DTYPE_TAG):
        raise TypeError(f"B4 takes uint8 payloads, f32 scales and weights "
                        f"and an f32/f64/bf16 output, got {packed.dtype}, "
                        f"{scales.dtype}, {w.dtype} -> {out_dtype}")
    _plain_device(packed)
    return kref.qinf_unpack_dequant_mix_blocks_ref(packed, scales, w, bits,
                                                   out_dtype)
