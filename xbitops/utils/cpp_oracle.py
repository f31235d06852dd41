"""ctypes bindings for the C++ scalar oracle (``cpp/xbit_oracle.cc``).

Builds the shared library on demand (g++ direct, or use the CMake project in
``cpp/``) and exposes numpy-friendly wrappers.  This is the bit-exact fp16
referee the kernels are checked against — the role the reference's
``cpp_simulate.cc`` plays for its CUDA kernels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import cache
from pathlib import Path

import numpy as np

_CPP_DIR = Path(__file__).resolve().parent.parent / "cpp"


def _build_lib() -> Path:
    out = _CPP_DIR / "libxbit_oracle.so"
    src = _CPP_DIR / "xbit_oracle.cc"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    # build beside the target and rename: concurrent test workers never
    # load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(src), "-o", str(tmp)],
        check=True,
        cwd=_CPP_DIR,
    )
    os.replace(tmp, out)
    return out


@cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build_lib()))
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    i32 = ctypes.c_int
    lib.xbit_dequant_f16.argtypes = [u32p, u16p, u32p, i32p, i64, i64, i32, i32, i32, u16p]
    lib.xbit_gemv_f16.argtypes = [u16p, u32p, u16p, u32p, i32p, i64, i64, i64, i32, i32, i32, u16p]
    lib.xbit_gemv_f16acc.argtypes = [u16p, u32p, u16p, u32p, i32p, i64, i64, i64, i32, i32, i32, u16p]
    lib.xbit_pack.argtypes = [u8p, i64, i64, i32, u32p]
    lib.xbit_half_to_float.argtypes = [ctypes.c_uint16]
    lib.xbit_half_to_float.restype = ctypes.c_float
    lib.xbit_float_to_half.argtypes = [ctypes.c_float]
    lib.xbit_float_to_half.restype = ctypes.c_uint16
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _gidx_ptr(g_idx):
    if g_idx is None:
        return ctypes.POINTER(ctypes.c_int32)()
    g_idx = np.ascontiguousarray(g_idx, np.int32)
    return _ptr(g_idx, ctypes.c_int32)


def dequant_f16(
    qweight: np.ndarray,
    scales_f16: np.ndarray,
    qzeros: np.ndarray,
    bits: int,
    group_size: int,
    K: int,
    add_zero_bias: int = 0,
    g_idx=None,
) -> np.ndarray:
    """GPTQ arrays → dense fp16 weights [K, N], software-fp16 rounding."""
    N = scales_f16.shape[1]
    qweight = np.ascontiguousarray(qweight).view(np.uint32)
    qzeros = np.ascontiguousarray(qzeros).view(np.uint32)
    scales = np.ascontiguousarray(scales_f16.astype(np.float16)).view(np.uint16)
    out = np.empty((K, N), np.uint16)
    _lib().xbit_dequant_f16(
        _ptr(qweight, ctypes.c_uint32), _ptr(scales, ctypes.c_uint16),
        _ptr(qzeros, ctypes.c_uint32), _gidx_ptr(g_idx),
        K, N, bits, group_size, add_zero_bias, _ptr(out, ctypes.c_uint16),
    )
    return out.view(np.float16)


def gemv_f16(
    a_f16: np.ndarray,
    qweight: np.ndarray,
    scales_f16: np.ndarray,
    qzeros: np.ndarray,
    bits: int,
    group_size: int,
    K: int,
    add_zero_bias: int = 0,
    g_idx=None,
) -> np.ndarray:
    """fp16 GEMM against GPTQ weights, f32 accumulation, fp16 output."""
    M = a_f16.shape[0]
    N = scales_f16.shape[1]
    a = np.ascontiguousarray(a_f16.astype(np.float16)).view(np.uint16)
    qweight = np.ascontiguousarray(qweight).view(np.uint32)
    qzeros = np.ascontiguousarray(qzeros).view(np.uint32)
    scales = np.ascontiguousarray(scales_f16.astype(np.float16)).view(np.uint16)
    out = np.empty((M, N), np.uint16)
    _lib().xbit_gemv_f16(
        _ptr(a, ctypes.c_uint16), _ptr(qweight, ctypes.c_uint32),
        _ptr(scales, ctypes.c_uint16), _ptr(qzeros, ctypes.c_uint32),
        _gidx_ptr(g_idx), M, K, N, bits, group_size, add_zero_bias,
        _ptr(out, ctypes.c_uint16),
    )
    return out.view(np.float16)


def gemv_f16acc(
    a_f16: np.ndarray,
    qweight: np.ndarray,
    scales_f16: np.ndarray,
    qzeros: np.ndarray,
    bits: int,
    group_size: int,
    K: int,
    add_zero_bias: int = 0,
    g_idx=None,
) -> np.ndarray:
    """fp16 GEMM with fp16 ACCUMULATION chains — emulates the reference's
    shipped ``__hfma2`` kernel (gemv_w4a16_pt.cu:115-124), the comparator for
    its fp16-accum tolerance gate (rel 1.001 AND abs 4e-4)."""
    M = a_f16.shape[0]
    N = scales_f16.shape[1]
    a = np.ascontiguousarray(a_f16.astype(np.float16)).view(np.uint16)
    qweight = np.ascontiguousarray(qweight).view(np.uint32)
    qzeros = np.ascontiguousarray(qzeros).view(np.uint32)
    scales = np.ascontiguousarray(scales_f16.astype(np.float16)).view(np.uint16)
    out = np.empty((M, N), np.uint16)
    _lib().xbit_gemv_f16acc(
        _ptr(a, ctypes.c_uint16), _ptr(qweight, ctypes.c_uint32),
        _ptr(scales, ctypes.c_uint16), _ptr(qzeros, ctypes.c_uint32),
        _gidx_ptr(g_idx), M, K, N, bits, group_size, add_zero_bias,
        _ptr(out, ctypes.c_uint16),
    )
    return out.view(np.float16)


def pack(vals: np.ndarray, bits: int) -> np.ndarray:
    """Independent C++ packer (parity check for formats.gptq_pack)."""
    K, N = vals.shape
    vals = np.ascontiguousarray(vals, np.uint8)
    out = np.empty(((K * bits + 31) // 32, N), np.uint32)
    _lib().xbit_pack(_ptr(vals, ctypes.c_uint8), K, N, bits, _ptr(out, ctypes.c_uint32))
    return out.view(np.int32)


def half_roundtrip(f: float) -> float:
    return _lib().xbit_half_to_float(_lib().xbit_float_to_half(ctypes.c_float(f)))
