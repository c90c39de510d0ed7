"""Guard the committed reference-parity evidence (docs/PARITY.md).

docs/parity/scene{N}_vs_ref.png are side-by-side images — left half OUR
render (200 spp), right half the reference's committed render
(RestOfLife/assets/img) — produced by tools/compare_reference.py.  This
test re-scores the committed halves with the same SSIM so the numbers
recorded in docs/PARITY.md stay true of the committed evidence.  (Per-pixel
regression protection of the live estimator is tests/test_goldens.py; this
file pins the *evidence artifacts*.)"""

import os

import numpy as np
import pytest

from rtw.utils.image import ssim

PARITY_DIR = os.path.join(os.path.dirname(__file__), "..", "docs", "parity")

# floors = measured SSIM (docs/PARITY.md) minus a safety margin
SSIM_FLOORS = {0: 0.48, 1: 0.47, 2: 0.39, 4: 0.30}


@pytest.mark.parametrize("sid", sorted(SSIM_FLOORS))
def test_committed_parity_pair(sid):
    from PIL import Image

    path = os.path.join(PARITY_DIR, f"scene{sid}_vs_ref.png")
    assert os.path.exists(path), f"missing parity evidence {path}"
    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    h, w, _ = img.shape
    ours, ref = img[:, : w // 2], img[:, w // 2:]
    s = ssim(ours, ref)
    assert s >= SSIM_FLOORS[sid], (
        f"scene {sid} parity pair SSIM {s:.3f} below floor "
        f"{SSIM_FLOORS[sid]} — docs/parity evidence no longer matches")
