"""Scene-level golden tests: small deterministic renders of every registered
scene, checked two ways (SURVEY §4 tier 3):

1. **Per-pixel goldens** — the render must match the committed image
   (tests/goldens/scene{N}.npz) per-pixel to fp-reassociation tolerance, so
   a spatial regression (shifted geometry, flipped normal, broken texture)
   cannot pass by luck of compensating errors.
2. **Channel means** — a fast whole-estimator smoke with statistical
   tolerance; kept as a readable first-line diagnostic.

Regenerate after an INTENTIONAL estimator change with
`python tests/test_goldens.py` and explain the change in the commit."""

import os

import numpy as np
import pytest

import rtw as rt

# scheduler pinned to "regen": per-pixel goldens must be independent of
# batch width (the queue scheduler reassociates per-pixel sums)
CFG = dict(nx=64, ny=48, spp=32, max_depth=10, seed=0, scheduler="regen")

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

# channel means per scene, generated on the CPU backend
EXPECTED = {
    0: [0.139198, 0.124440, 0.113935],
    1: [0.331535, 0.377647, 0.476739],
    2: [0.161109, 0.156372, 0.164586],
    3: [0.477820, 0.486974, 0.525290],
    4: [0.357408, 0.377792, 0.358139],
    5: [0.371871, 0.457955, 0.107648],
}


def _render(sid):
    cfg = rt.RenderConfig(scene_id=sid, **CFG)
    return np.asarray(rt.render(rt.build_scene(sid, cfg.nx, cfg.ny), cfg))


@pytest.mark.parametrize("sid", sorted(EXPECTED))
def test_scene_goldens(sid):
    img = _render(sid)
    assert np.isfinite(img).all()
    got = img.reshape(-1, 3).mean(axis=0)
    np.testing.assert_allclose(got, EXPECTED[sid], rtol=0.02, atol=0.003)

    path = os.path.join(GOLDEN_DIR, f"scene{sid}.npz")
    assert os.path.exists(path), (
        f"missing golden {path} — generate with `python tests/test_goldens.py`")
    with np.load(path) as z:
        ref = z["img"]
    # fp-reassociation tolerance only; any spatial estimator change trips it
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-4)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for sid in sorted(EXPECTED):
        img = _render(sid)
        m = img.reshape(-1, 3).mean(axis=0)
        print(f"    {sid}: [{m[0]:.6f}, {m[1]:.6f}, {m[2]:.6f}],")
        np.savez_compressed(os.path.join(GOLDEN_DIR, f"scene{sid}.npz"),
                            img=img.astype(np.float32))
        print(f"    wrote goldens/scene{sid}.npz")
