"""Builds, loads and launches the hand-written CUDA quantization kernels.

``csrc/qinf.cu`` holds B1 (quantize) and B2 (dequantize), ``csrc/
qinf_wire.cu`` B3 (quantize + wire pack) and B4 (unpack + dequantize +
mix): the Hopper versions of the Pallas kernels in
``repro.kernels.quantize``.  Each source has a plain C interface:
:func:`build` compiles every source with ``nvcc`` for ``sm_90a``, one
compiler process per source, all started together, into ``_build/`` next
to this file (keyed by a hash of the source and flags, so an unchanged
source builds once), and ctypes loads the libraries.  Nothing is compiled
at import, and any build or launch failure raises.

The wrappers dispatch on the device of their input: a CUDA tensor
launches the kernel (and counts the launch in :data:`LAUNCHES`), a CPU
tensor runs the plain version from :mod:`repro_torch.kernels.ref`, and any
other device raises.  There is no fallback from the card to the plain
version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict

import torch

from repro_torch.kernels import ref as kref

_HERE = pathlib.Path(__file__).resolve().parent
SOURCES = {"qinf": _HERE / "csrc" / "qinf.cu",
           "qinf_wire": _HERE / "csrc" / "qinf_wire.cu"}
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")

# dtype tags shared with csrc/*.cu
_DTYPE_TAG = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

#: launches of each kernel since the last :func:`reset_launch_counts`;
#: incremented only where a wrapper launches its kernel on the card
LAUNCHES: Dict[str, int] = {"qinf_quantize_blocks": 0,
                            "qinf_dequantize_blocks": 0,
                            "qinf_quantize_pack_blocks": 0,
                            "qinf_unpack_dequant_mix_blocks": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


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


def _lib_path(name: str) -> pathlib.Path:
    tag = hashlib.sha256(SOURCES[name].read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build() -> Dict[str, pathlib.Path]:
    """Compile every source of :data:`SOURCES` that was not built yet, one
    ``nvcc`` per source, all started together; returns name -> shared
    library path.  Raises on any compiler error."""
    libs = {name: _lib_path(name) for name in SOURCES}
    todo = [name for name, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to private names, then rename: a concurrent build never
    # loads a half-written library
    jobs = {}
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        failed = []
        for name, (tmp, proc) in jobs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on "
                              f"{SOURCES[name]}:\n{out}\n{err}")
            else:
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
def _libs() -> Dict[str, ctypes.CDLL]:
    libs = {name: ctypes.CDLL(str(path)) for name, path in build().items()}
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    q, w = libs["qinf"], libs["qinf_wire"]
    signatures = (
        (q.qinf_quantize_blocks_launch, [vp, i32, vp, vp, vp, i64, i32, i32,
                                         vp]),
        (q.qinf_dequantize_blocks_launch, [vp, vp, vp, i32, i64, i32, vp]),
        (w.qinf_quantize_pack_blocks_launch, [vp, vp, vp, vp, i64, i32, i32,
                                              vp]),
        (w.qinf_unpack_dequant_mix_blocks_launch, [vp, vp, vp, vp, vp, i32,
                                                   i64, i32, i32, i64, i32,
                                                   i32, vp]))
    for fn, argtypes in signatures:
        fn.argtypes, fn.restype = argtypes, i32
    q.qinf_error_string.argtypes = [i32]
    q.qinf_error_string.restype = ctypes.c_char_p
    return libs


def _lib() -> ctypes.CDLL:
    return _libs()["qinf"]


def _wire_lib() -> ctypes.CDLL:
    return _libs()["qinf_wire"]


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({_lib().qinf_error_string(err).decode()})")


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def qinf_quantize_blocks(x: torch.Tensor, u: torch.Tensor, bits: int):
    """B1: quantize (R, block) rows -> (codes int8 (R, block), scales f32
    (R, 1)).  ``x`` f32, f64 or bf16; ``u`` f32 U[0,1) noise of x's shape;
    1 <= bits <= 7 (codes are int8 in [-2^{b-1}, 2^{b-1}])."""
    if x.dim() != 2 or tuple(u.shape) != tuple(x.shape):
        raise ValueError(f"want x and u of one (R, block) shape, got "
                         f"{tuple(x.shape)} and {tuple(u.shape)}")
    if not 1 <= bits <= 7:
        raise ValueError(f"bits must be in 1..7, got {bits}")
    if _device_kind(x) == "cpu":
        return kref.qinf_quantize_blocks_ref(x, u, bits)
    if x.dtype not in _DTYPE_TAG or u.dtype != torch.float32:
        raise TypeError(f"kernel takes x f32/f64/bf16 and u f32, got "
                        f"{x.dtype} and {u.dtype}")
    if u.device != x.device or not (x.is_contiguous() and u.is_contiguous()):
        raise ValueError("x and u must be contiguous on one device")
    R, block = x.shape
    codes = torch.empty((R, block), dtype=torch.int8, device=x.device)
    scales = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.qinf_quantize_blocks_launch(
            x.data_ptr(), _DTYPE_TAG[x.dtype], u.data_ptr(),
            codes.data_ptr(), scales.data_ptr(), R, block, bits,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check(err, "qinf_quantize_blocks")
    LAUNCHES["qinf_quantize_blocks"] += 1
    return codes, scales


def qinf_dequantize_blocks(codes: torch.Tensor, scales: torch.Tensor,
                           out_dtype=torch.float32) -> torch.Tensor:
    """B2: codes (R, block) int8 times scales (R, 1) f32, computed in f32
    and written as ``out_dtype`` (f32, f64 or bf16)."""
    if codes.dim() != 2 or tuple(scales.shape) != (codes.shape[0], 1):
        raise ValueError(f"want codes (R, block) and scales (R, 1), got "
                         f"{tuple(codes.shape)} and {tuple(scales.shape)}")
    if _device_kind(codes) == "cpu":
        return kref.qinf_dequantize_blocks_ref(codes, scales, out_dtype)
    if (codes.dtype != torch.int8 or scales.dtype != torch.float32
            or out_dtype not in _DTYPE_TAG):
        raise TypeError(f"kernel takes int8 codes, f32 scales and an "
                        f"f32/f64/bf16 output, got {codes.dtype}, "
                        f"{scales.dtype} -> {out_dtype}")
    if scales.device != codes.device or not (codes.is_contiguous()
                                             and scales.is_contiguous()):
        raise ValueError("codes and scales must be contiguous on one device")
    R, block = codes.shape
    out = torch.empty((R, block), dtype=out_dtype, device=codes.device)
    lib = _lib()
    with torch.cuda.device(codes.device):
        err = lib.qinf_dequantize_blocks_launch(
            codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
            _DTYPE_TAG[out_dtype], R, block,
            torch.cuda.current_stream(codes.device).cuda_stream)
    _check(err, "qinf_dequantize_blocks")
    LAUNCHES["qinf_dequantize_blocks"] += 1
    return out


def qinf_quantize_pack_blocks(x: torch.Tensor, u: torch.Tensor, bits: int):
    """B3: quantize (R, block) f32 rows and wire-pack them -> (packed uint8
    (R, W), scales f32 (R, 1)), W = :func:`packed_width`.  Offset codes
    ``c + 2^{b-1}``, two to a byte in HALVES order for bits <= 3 (so an
    even block), one byte each otherwise; ``u`` f32 U[0,1) noise of x's
    shape; 1 <= bits <= 7."""
    if x.dim() != 2 or tuple(u.shape) != tuple(x.shape):
        raise ValueError(f"want x and u of one (R, block) shape, got "
                         f"{tuple(x.shape)} and {tuple(u.shape)}")
    if not 1 <= bits <= 7:
        raise ValueError(f"bits must be in 1..7, got {bits}")
    R, block = x.shape
    if block % 2 and kref.wire_bits_per_element(bits) == 4:
        raise ValueError(f"nibble packing (bits <= 3) needs an even block, "
                         f"got {block}")
    if x.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"B3 takes f32 x and u, got {x.dtype} and {u.dtype}")
    if _device_kind(x) == "cpu":
        return kref.qinf_quantize_pack_blocks_ref(x, u, bits)
    if u.device != x.device or not (x.is_contiguous() and u.is_contiguous()):
        raise ValueError("x and u must be contiguous on one device")
    packed = torch.empty((R, packed_width(block, bits)), dtype=torch.uint8,
                         device=x.device)
    scales = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _wire_lib().qinf_quantize_pack_blocks_launch(
            x.data_ptr(), u.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            R, block, bits, torch.cuda.current_stream(x.device).cuda_stream)
    _check(err, "qinf_quantize_pack_blocks")
    LAUNCHES["qinf_quantize_pack_blocks"] += 1
    return packed, scales


def qinf_unpack_dequant_mix_blocks(packed: torch.Tensor, scales: torch.Tensor,
                                   w: torch.Tensor, bits: int,
                                   out_dtype=torch.float32):
    """B4: unpack + dequantize + weighted mix of the S payloads of one
    bucket group (sender 0 is self), for every node at once.

    ``packed`` (N, S, R, W) uint8, ``scales`` (N, S, R, 1) f32, ``w``
    (N, T, S) f32 -> (mix (N, T, R, B), qself (N, R, B)) in ``out_dtype``
    (f32, f64 or bf16): node n mixes with its own weights, mix[n, t] =
    sum_s w[n, t, s] Q_s accumulated in f32 in sender order, each Q_s
    rounded through ``out_dtype`` first.  One launch covers all nodes."""
    if packed.dim() != 4:
        raise ValueError(f"want packed (N, S, R, W), got "
                         f"{tuple(packed.shape)}")
    N, S, R, W = packed.shape
    if (tuple(scales.shape) != (N, S, R, 1) or w.dim() != 3
            or tuple(w.shape[::2]) != (N, S)):
        raise ValueError(f"shapes disagree: packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}, w {tuple(w.shape)}")
    if not 1 <= bits <= 7:
        raise ValueError(f"bits must be in 1..7, got {bits}")
    if (packed.dtype != torch.uint8 or scales.dtype != torch.float32
            or w.dtype != torch.float32 or out_dtype not in _DTYPE_TAG):
        raise TypeError(f"B4 takes uint8 payloads, f32 scales and weights "
                        f"and an f32/f64/bf16 output, got {packed.dtype}, "
                        f"{scales.dtype}, {w.dtype} -> {out_dtype}")
    T = w.shape[1]
    block = W * 2 if kref.wire_bits_per_element(bits) == 4 else W
    if _device_kind(packed) == "cpu":
        mix, qself = kref.qinf_unpack_dequant_mix_blocks_ref(
            packed, scales, w, bits, out_dtype)
    else:
        if not (scales.device == w.device == packed.device
                and packed.is_contiguous() and scales.is_contiguous()
                and w.is_contiguous()):
            raise ValueError("packed, scales and w must be contiguous on one "
                             "device")
        mix = torch.empty((N, T, R, block), dtype=out_dtype,
                          device=packed.device)
        qself = torch.empty((N, R, block), dtype=out_dtype,
                            device=packed.device)
        with torch.cuda.device(packed.device):
            err = _wire_lib().qinf_unpack_dequant_mix_blocks_launch(
                packed.data_ptr(), scales.data_ptr(), w.data_ptr(),
                mix.data_ptr(), qself.data_ptr(), _DTYPE_TAG[out_dtype], N, S,
                T, R, block, bits,
                torch.cuda.current_stream(packed.device).cuda_stream)
        _check(err, "qinf_unpack_dequant_mix_blocks")
        LAUNCHES["qinf_unpack_dequant_mix_blocks"] += 1
    return mix, qself
