"""Image output: P3 PPM (stdout-compatible with the reference's printPPM,
Director.cpp:1010-1031) and 8-bit RGB PNG (stdlib zlib + struct)."""

from __future__ import annotations

import struct
import sys
import zlib

import numpy as np


def write_ppm(img_u8: np.ndarray, stream=None) -> None:
    """Write a top-row-first uint8 [H, W, 3] image as P3 PPM.

    Matches the reference byte format: header `P3\\n<W> <H>\\n255\\n` then one
    `r g b` triple per line (printPPM emits space-separated ints; the
    reference iterates bottom-up over a bottom-origin buffer which equals
    top-down over a top-origin image)."""
    if stream is None:
        stream = sys.stdout
    h, w, _ = img_u8.shape
    out = [f"P3\n{w} {h}\n255\n"]
    flat = img_u8.reshape(-1, 3)
    out.extend(f"{r} {g} {b}\n" for r, g, b in flat)
    stream.write("".join(out))


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img_u8: np.ndarray) -> bytes:
    """Top-row-first uint8 [H, W, 3] image -> PNG bytes (8-bit RGB, no
    filtering, one zlib stream)."""
    img = np.ascontiguousarray(img_u8, dtype=np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"expected [H, W, 3], got {img.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)           # filter byte 0 per scanline
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """Inverse of encode_png (8-bit RGB, filter type 0 only)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError("only 8-bit RGB PNGs are supported")
        elif tag == b"IDAT":
            idat += body
        pos += n + 12
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if rows[:, 0].any():
        raise ValueError("only unfiltered PNGs are supported")
    return rows[:, 1:].reshape(h, w, 3).copy()


def write_png(img_u8: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img_u8))


def write_image(img_u8: np.ndarray, path: str | None) -> None:
    """path=None or '-' -> PPM on stdout (reference behavior); *.ppm -> PPM
    file; otherwise PNG."""
    if path is None or path == "-":
        write_ppm(img_u8)
    elif path.endswith(".ppm"):
        with open(path, "w") as f:
            write_ppm(img_u8, f)
    else:
        write_png(img_u8, path)


def ssim(a: np.ndarray, b: np.ndarray, win: int = 8) -> float:
    """Mean structural similarity between two [H, W, 3] float images in
    [0, 1] (uniform win x win windows, standard SSIM constants).

    Used by the reference-image comparison harness (tools/compare_reference)
    to score our renders against the reference's committed renders
    (RestOfLife/assets/img/) as *structural* goldens — per-pixel equality is
    not meaningful across different RNG streams, spp and the reference's
    NN denoiser."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        a = a.mean(axis=-1)
        b = b.mean(axis=-1)
    h, w = a.shape
    hh, ww = h // win * win, w // win * win
    # non-overlapping windows: [H/win, W/win, win*win]
    blocks = (lambda x: x[:hh, :ww].reshape(hh // win, win, ww // win, win)
              .transpose(0, 2, 1, 3).reshape(hh // win, ww // win, -1))
    ab, bb = blocks(a), blocks(b)
    mu_a = ab.mean(-1)
    mu_b = bb.mean(-1)
    va = ab.var(-1)
    vb = bb.var(-1)
    cov = (ab * bb).mean(-1) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)))
    return float(s.mean())
