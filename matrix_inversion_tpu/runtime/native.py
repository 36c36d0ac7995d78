"""ctypes bindings for the native marshalling library (native/qmarshal.cc).

The library is compiled with ``-march=native``, so it is only ever loaded
from a build directory stamped with this host and the source's hash:
``native/build/<host>-<machine>-<sha256[:12]>/libqmarshal.so``.  A library
built on another machine, or from other source, is never found.  Build it
with ``python -m matrix_inversion_tpu.runtime.native`` (needs a C++17
compiler).  Every entry point has a numpy fallback in ``ops.radix``, so the
framework works without the build — just with slower host-side
quantization for very large batches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SOURCE = os.path.join(_NATIVE_DIR, "qmarshal.cc")

_LIB = None
_TRIED = False


def library_path() -> str:
    """Where this host's build of the current source lives."""
    with open(_SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:12]
    stamp = f"{platform.node()}-{platform.machine()}-{digest}"
    return os.path.join(_NATIVE_DIR, "build", stamp, "libqmarshal.so")


def build() -> str:
    """Compile native/qmarshal.cc for this host (no-op when already built).

    Raises ``RuntimeError`` when no C++ compiler is found and
    ``subprocess.CalledProcessError`` when compilation fails.
    """
    global _TRIED
    path = library_path()
    _TRIED = False  # let the next call load this build
    if os.path.exists(path):
        return path
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++ or g++) on PATH")
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    # build beside the target and rename: concurrent builders never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        subprocess.run(
            [cxx, "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread", _SOURCE, "-o", tmp],
            check=True,
        )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = library_path()
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.qmarshal_abi_version.restype = ctypes.c_int
    if lib.qmarshal_abi_version() != 1:
        return None

    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c32, c64 = ctypes.c_int32, ctypes.c_int64

    lib.quantize_digits.argtypes = [f64p, c64, c32, c32, c32, i32p, i32p]
    lib.quantize_packed.argtypes = [f64p, c64, c32, c32, c32, i64p, i64p]
    lib.dequantize_digits.argtypes = [i32p, c64, c32, c32, c32, f64p]
    lib.dequantize_packed.argtypes = [i64p, i64p, c64, c32, c32, c32, f64p]
    lib.pack_digits.argtypes = [i32p, c64, c32, c32, i64p]
    _LIB = lib
    return lib


def available() -> bool:
    return _lib() is not None


def quantize_digits(values, length, ints, base):
    """float64 array (any shape) -> (digits int32[..., length], signs int32[...])."""
    lib = _lib()
    values = np.ascontiguousarray(values, dtype=np.float64)
    n = values.size
    digits = np.empty(values.shape + (length,), dtype=np.int32)
    signs = np.empty(values.shape, dtype=np.int32)
    lib.quantize_digits(values.reshape(-1), n, length, ints, base,
                        digits.reshape(-1, length), signs.reshape(-1))
    return digits, signs


def quantize_packed(values, length, ints, base):
    """float64 array -> (mags int64[...], signs int64[...])."""
    lib = _lib()
    values = np.ascontiguousarray(values, dtype=np.float64)
    n = values.size
    mags = np.empty(values.shape, dtype=np.int64)
    signs = np.empty(values.shape, dtype=np.int64)
    lib.quantize_packed(values.reshape(-1), n, length, ints, base,
                        mags.reshape(-1), signs.reshape(-1))
    return mags, signs


def dequantize_digits(digits_and_sign, length, ints, base):
    """(..., length+1) int32 digit+sign arrays -> float64 values."""
    lib = _lib()
    arr = np.ascontiguousarray(digits_and_sign, dtype=np.int32)
    n = arr.size // (length + 1)
    out = np.empty(arr.shape[:-1], dtype=np.float64)
    lib.dequantize_digits(arr.reshape(-1, length + 1), n, length, ints, base,
                          out.reshape(-1))
    return out


def dequantize_packed(mags, signs, length, ints, base):
    lib = _lib()
    mags = np.ascontiguousarray(mags, dtype=np.int64)
    signs = np.ascontiguousarray(signs, dtype=np.int64)
    out = np.empty(mags.shape, dtype=np.float64)
    lib.dequantize_packed(mags.reshape(-1), signs.reshape(-1), mags.size,
                          length, ints, base, out.reshape(-1))
    return out


def pack_digits(digits, base):
    lib = _lib()
    digits = np.ascontiguousarray(digits, dtype=np.int32)
    length = digits.shape[-1]
    n = digits.size // length
    out = np.empty(digits.shape[:-1], dtype=np.int64)
    lib.pack_digits(digits.reshape(-1, length), n, length, base, out.reshape(-1))
    return out


if __name__ == "__main__":
    print(build())
