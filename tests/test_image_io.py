"""Image I/O without an image library: the stdlib PNG writer and the
committed earth-map pixels."""

import builtins
import os

import numpy as np
import pytest

from rtw.utils.image import decode_png, encode_png, write_image


def test_png_round_trip_without_pil(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("PIL blocked")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    img = np.random.default_rng(0).integers(0, 256, (7, 11, 3),
                                            dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_image(img, path)
    with open(path, "rb") as f:
        data = f.read()
    assert data == encode_png(img)
    np.testing.assert_array_equal(decode_png(data), img)


def test_earthmap_npz_matches_jpeg():
    """assets/earthmap.npz holds exactly the JPEG's decoded pixels."""
    Image = pytest.importorskip("PIL.Image")
    from rtw.models.builder import ASSET_DIR

    with np.load(os.path.join(ASSET_DIR, "earthmap.npz")) as z:
        npz = z["rgb"]
    jpg = np.asarray(Image.open(os.path.join(ASSET_DIR, "earthmap.jpg"))
                     .convert("RGB"), np.uint8)
    assert npz.dtype == np.uint8
    np.testing.assert_array_equal(npz, jpg)
