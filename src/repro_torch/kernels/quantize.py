"""Builds, loads and launches the hand-written CUDA quantization kernels.

``csrc/qinf.cu`` holds B1 (quantize) and B2 (dequantize), the Hopper
versions of the Pallas kernels in ``repro.kernels.quantize``.  The source
has a plain C interface: :func:`build` compiles it with ``nvcc`` for
``sm_90a`` into ``_build/`` next to this file (keyed by a hash of the
source and flags, so an unchanged source builds once), and ctypes loads it.
Nothing is compiled at import, and any build or launch failure raises.

The two wrappers dispatch on the device of their input: a CUDA tensor
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
SOURCE = _HERE / "csrc" / "qinf.cu"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")

# dtype tags shared with csrc/qinf.cu
_DTYPE_TAG = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

#: launches of each kernel since the last :func:`reset_launch_counts`;
#: incremented only where a wrapper launches its kernel on the card
LAUNCHES: Dict[str, int] = {"qinf_quantize_blocks": 0,
                            "qinf_dequantize_blocks": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    cands = [os.environ.get("NVCC"), shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME); the CUDA "
                       "kernels cannot be built")


def build() -> pathlib.Path:
    """Compile ``csrc/qinf.cu`` unless this source was already built;
    returns the shared library's path.  Raises on any compiler error."""
    nvcc = _nvcc()
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    lib = BUILD_DIR / f"libqinf_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}) on {SOURCE}:\n"
                               f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.qinf_quantize_blocks_launch.argtypes = [vp, i32, vp, vp, vp, i64,
                                                i32, i32, vp]
    lib.qinf_quantize_blocks_launch.restype = i32
    lib.qinf_dequantize_blocks_launch.argtypes = [vp, vp, vp, i32, i64, i32,
                                                  vp]
    lib.qinf_dequantize_blocks_launch.restype = i32
    lib.qinf_error_string.argtypes = [i32]
    lib.qinf_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.qinf_error_string(err).decode()})")


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
    _check(lib, err, "qinf_quantize_blocks")
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
    _check(lib, err, "qinf_dequantize_blocks")
    LAUNCHES["qinf_dequantize_blocks"] += 1
    return out
