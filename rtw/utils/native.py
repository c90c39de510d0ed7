"""Loader for the native C++ runtime components (native/rtw_native.cpp).

Compiles the shared library on first use with the system g++ into a
per-source-hash cache under <checkout>/build/native (so editing the .cpp
invalidates cleanly) and binds it via ctypes.  Every entry point has a NumPy fallback — the framework is
fully functional without a compiler; the native tier exists because the
reference's equivalent host paths (printPPM, stb packing, host RNG) are
native C++ and the pure-Python PPM encoder is ~100x slower at full
resolution.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                    "rtw_native.cpp")
_CACHE = os.path.join(os.path.dirname(__file__), "..", "..", "build",
                      "native")

_lib = None
_tried = False


def _build() -> "ctypes.CDLL | None":
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
    except OSError:
        return None
    tag = hashlib.sha256(src).hexdigest()[:16]
    so_path = os.path.join(_CACHE, f"rtw_native_{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(_CACHE, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
               _SRC]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except (OSError, subprocess.SubprocessError) as e:  # no compiler etc.
            print(f"INFO: native build unavailable ({e}); using NumPy "
                  f"fallbacks", file=sys.stderr)
            return None
    lib = ctypes.CDLL(so_path)
    lib.rtw_ppm_encode.restype = ctypes.c_size_t
    lib.rtw_ppm_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_void_p]
    lib.rtw_pack_rgb8.restype = None
    lib.rtw_pack_rgb8.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_void_p]
    lib.rtw_srgb_encode.restype = None
    lib.rtw_srgb_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_float, ctypes.c_void_p]
    lib.rtw_xorshift32_fill.restype = ctypes.c_uint32
    lib.rtw_xorshift32_fill.argtypes = [ctypes.c_uint32, ctypes.c_int64,
                                        ctypes.c_void_p]
    return lib


def get() -> "ctypes.CDLL | None":
    """The loaded native library, or None (NumPy fallbacks apply)."""
    global _lib, _tried
    if not _tried:
        _tried = True
        _lib = _build()
    return _lib


# ---------------------------------------------------------------------------
# High-level wrappers (native with fallback)
# ---------------------------------------------------------------------------

def ppm_encode(img_u8: np.ndarray) -> bytes:
    """P3-PPM text for a top-row-first uint8 [H, W, 3] image."""
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w, _ = img_u8.shape
    lib = get()
    if lib is not None:
        buf = ctypes.create_string_buffer(64 + h * w * 12)
        n = lib.rtw_ppm_encode(img_u8.ctypes.data, h, w, buf)
        return buf.raw[:n]
    flat = img_u8.reshape(-1, 3)
    body = "".join(f"{r} {g} {b}\n" for r, g, b in flat)
    return f"P3\n{w} {h}\n255\n{body}".encode()


def pack_rgb8(img_u8: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] -> 0x00BBGGRR uint32 (texture atlas layout)."""
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    n = img_u8.size // 3
    lib = get()
    if lib is not None:
        out = np.empty(n, np.uint32)
        lib.rtw_pack_rgb8(img_u8.ctypes.data, n, out.ctypes.data)
        return out.reshape(img_u8.shape[:-1])
    flat = img_u8.reshape(-1, 3).astype(np.uint32)
    return (flat[:, 0] | (flat[:, 1] << 8)
            | (flat[:, 2] << 16)).reshape(img_u8.shape[:-1])


def srgb_encode(linear: np.ndarray, gamma: float = 2.0) -> np.ndarray:
    """Clamp + gamma + quantize float32 [...] -> uint8 [...]."""
    linear = np.ascontiguousarray(linear, np.float32)
    lib = get()
    if lib is not None:
        out = np.empty(linear.size, np.uint8)
        lib.rtw_srgb_encode(linear.ctypes.data, linear.size,
                            np.float32(1.0 / gamma), out.ctypes.data)
        return out.reshape(linear.shape)
    return (np.clip(linear, 0.0, 1.0) ** (1.0 / gamma) * 255.99).astype(
        np.uint8)


def xorshift32_fill(seed: int, n: int) -> tuple[np.ndarray, int]:
    """`n` consecutive reference-randf draws; returns (draws, new_state)."""
    lib = get()
    if lib is not None:
        out = np.empty(n, np.float32)
        s = lib.rtw_xorshift32_fill(np.uint32(seed), n, out.ctypes.data)
        return out, int(s)
    from rtw.utils.rng import XorShift32

    r = XorShift32(seed)
    out = np.array([r.randf() for _ in range(n)], np.float32)
    return out, int(r.state)
