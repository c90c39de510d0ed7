"""Denoiser tests: the à-trous post-filter must reduce display-space error
against a converged reference without destroying edges (SURVEY §5
"Denoiser": classical replacement for the reference's OptiX LDR pass)."""

import numpy as np
import pytest

import rtw as rt
from rtw.denoise import denoise, atrous, primary_features


@pytest.fixture(scope="module")
def cornell_pair():
    cfg = rt.RenderConfig(nx=80, ny=80, spp=4, max_depth=8, scene_id=0)
    scene = rt.build_scene(0, 80, 80)
    noisy = np.asarray(rt.render(scene, cfg))
    ref = np.asarray(rt.render(
        scene, rt.RenderConfig(nx=80, ny=80, spp=256, max_depth=8,
                               scene_id=0, seed=1)))
    return scene, cfg, noisy, ref


def _disp(img, gamma=2.0):
    return np.clip(img, 0.0, 1.0) ** (1.0 / gamma)


def test_denoise_reduces_error(cornell_pair):
    scene, cfg, noisy, ref = cornell_pair
    dn = np.asarray(denoise(noisy, scene, cfg))          # display-space out
    ref_d = _disp(ref)
    mse_noisy = ((_disp(noisy) - ref_d) ** 2).mean()
    mse_dn = ((dn - ref_d) ** 2).mean()
    assert mse_dn < mse_noisy / 1.25, (mse_noisy, mse_dn)


def test_denoise_preserves_edges(cornell_pair):
    scene, cfg, noisy, ref = cornell_pair
    dn = np.asarray(denoise(noisy, scene, cfg))
    # the red/green wall split must survive: column-wise hue contrast between
    # the left and right borders stays strong after filtering
    left_g = dn[20:60, 2:8, 1].mean()
    left_r = dn[20:60, 2:8, 0].mean()
    right_r = dn[20:60, -8:-2, 0].mean()
    right_g = dn[20:60, -8:-2, 1].mean()
    assert left_g > left_r * 1.3       # green wall stays green
    assert right_r > right_g * 1.3     # red wall stays red


def test_features_shapes(cornell_pair):
    scene, cfg, _, _ = cornell_pair
    alb, nrm, mask = primary_features(scene, cfg)
    assert alb.shape == (cfg.ny, cfg.nx, 3)
    assert nrm.shape == (cfg.ny, cfg.nx, 3)
    assert mask.shape == (cfg.ny, cfg.nx)
    assert 0.5 < float(mask.mean()) <= 1.0   # closed box: mostly hits
    assert np.isfinite(np.asarray(alb)).all()


def test_atrous_identity_on_flat():
    # a constant image is a fixed point (weights normalize out)
    img = np.full((32, 32, 3), 0.25, np.float32)
    out = np.asarray(atrous(img, iterations=3))
    np.testing.assert_allclose(out, img, atol=1e-5)
