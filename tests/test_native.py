"""Native C++ module tests: byte/bit equality against the NumPy fallbacks.

The native tier (native/rtw_native.cpp via utils/native.py) mirrors the
reference's native host paths — printPPM, stb packing, host xorshift32 —
and must be a drop-in for the Python implementations."""

import numpy as np
import pytest

from rtw.utils import native as N
from rtw.utils.rng import XorShift32


requires_native = pytest.mark.skipif(N.get() is None,
                                     reason="no C++ toolchain")


def _py_ppm(img):
    h, w, _ = img.shape
    flat = img.reshape(-1, 3)
    body = "".join(f"{r} {g} {b}\n" for r, g, b in flat)
    return f"P3\n{w} {h}\n255\n{body}".encode()


@requires_native
def test_ppm_encode_matches_python():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (13, 7, 3), np.uint8)
    assert N.ppm_encode(img) == _py_ppm(img)
    # edge values
    img = np.array([[[0, 9, 10], [99, 100, 255]]], np.uint8)
    assert N.ppm_encode(img) == _py_ppm(img)


@requires_native
def test_pack_rgb8_matches():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (17, 5, 3), np.uint8)
    ref = (img[..., 0].astype(np.uint32)
           | (img[..., 1].astype(np.uint32) << 8)
           | (img[..., 2].astype(np.uint32) << 16))
    np.testing.assert_array_equal(N.pack_rgb8(img), ref)


@requires_native
def test_srgb_encode_matches():
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.2, 1.4, 1000).astype(np.float32)
    ref = (np.clip(x, 0.0, 1.0) ** 0.5 * 255.99).astype(np.uint8)
    got = N.srgb_encode(x, gamma=2.0)
    # powf rounding may differ by 1 ulp at quantization boundaries
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@requires_native
def test_xorshift32_bit_exact():
    """The native stream must reproduce the reference host RNG bit-for-bit
    (random-scene geometry parity depends on it)."""
    ref = XorShift32(0x314759)
    expected = np.array([ref.randf() for _ in range(10_000)], np.float32)
    got, state = N.xorshift32_fill(0x314759, 10_000)
    np.testing.assert_array_equal(got, expected)
    assert state == int(ref.state)
