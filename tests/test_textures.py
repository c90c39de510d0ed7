"""Texture evaluation tests (texture/*.cu parity; SURVEY §4 tier 1)."""

import numpy as np
import jax.numpy as jnp
import pytest

from rtw.models import scene as S
from rtw.models.builder import SceneBuilder
from rtw.ops.textures import eval_texture as _eval_texture, perlin_noise as _perlin, turbulence as _turb
from rtw.ops.vec import v3


def eval_texture(tex, tid, u, v, p, present=(True,) * 5):
    return _eval_texture(tex, tid, u, v, v3(p), present).stack()


def perlin_noise(tex, p):
    return _perlin(tex, v3(p))


def turbulence(tex, p):
    return _turb(tex, v3(p))


def _scene_with_textures():
    b = SceneBuilder()
    red = b.constant_texture((1.0, 0.0, 0.0))
    blue = b.constant_texture((0.0, 0.0, 1.0))
    checker = b.checker_texture(red, blue)
    noise = b.noise_texture(4.0)
    null = b.null_texture()
    m = b.lambertian(red)
    b.sphere((0, 0, 0), 1.0, m)
    b.set_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 60, 1.0, 0.0, 1.0)
    return b.build(), dict(red=red, blue=blue, checker=checker, noise=noise,
                           null=null)


def _eval(scene, tid, p, u=0.0, v=0.0):
    n = p.shape[0]
    return np.asarray(eval_texture(
        scene.textures,
        jnp.full((n,), tid, jnp.int32),
        jnp.full((n,), u, jnp.float32),
        jnp.full((n,), v, jnp.float32),
        jnp.asarray(p, jnp.float32)))


def test_constant_and_null():
    scene, t = _scene_with_textures()
    p = np.zeros((4, 3), np.float32)
    np.testing.assert_allclose(_eval(scene, t["red"], p), [[1, 0, 0]] * 4)
    np.testing.assert_allclose(_eval(scene, t["null"], p), 0.0)


def test_checker_alternation():
    scene, t = _scene_with_textures()
    # sines = sin(10x)sin(10y)sin(10z); at (pi/20)*(1,1,1) all sines = 1 > 0
    # -> even (blue); flip x sign -> odd (red)
    a = np.pi / 20.0
    p = np.array([[a, a, a], [-a, a, a]], np.float32)
    out = _eval(scene, t["checker"], p)
    np.testing.assert_allclose(out[0], [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(out[1], [1, 0, 0], atol=1e-6)


def test_perlin_range_and_smoothness():
    scene, t = _scene_with_textures()
    rng = np.random.default_rng(0)
    p = jnp.asarray(rng.uniform(-10, 10, (2000, 3)).astype(np.float32))
    n = np.asarray(perlin_noise(scene.textures, p))
    assert np.abs(n).max() <= 1.0 + 1e-5
    assert n.std() > 0.05  # non-degenerate
    # lattice-point values: gradient noise is 0 at integer lattice points
    pi = jnp.asarray(rng.integers(-5, 5, (64, 3)).astype(np.float32))
    ni = np.asarray(perlin_noise(scene.textures, pi))
    np.testing.assert_allclose(ni, 0.0, atol=1e-5)


def test_turbulence_positive():
    scene, t = _scene_with_textures()
    rng = np.random.default_rng(1)
    p = jnp.asarray(rng.uniform(-10, 10, (512, 3)).astype(np.float32))
    tb = np.asarray(turbulence(scene.textures, p))
    assert (tb >= 0).all()
    assert tb.max() < 2.0


def test_marble_range():
    scene, t = _scene_with_textures()
    rng = np.random.default_rng(2)
    p = rng.uniform(-3, 3, (512, 3)).astype(np.float32)
    out = _eval(scene, t["noise"], p)
    assert out.min() >= 0.0 and out.max() <= 1.0 + 1e-5
    assert np.allclose(out[:, 0], out[:, 1])  # greyscale


def test_image_texture_bilinear():
    from rtw.models.registry import EARTHMAP
    b = SceneBuilder()
    earth = b.image_texture(EARTHMAP)
    m = b.lambertian(earth)
    b.sphere((0, 0, 0), 1.0, m)
    b.set_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 60, 1.0, 0.0, 1.0)
    scene = b.build()
    # sample a horizontal scanline across the equator: finite, in [0,1],
    # and varying (oceans vs continents)
    n = 64
    u = jnp.linspace(0.0, 1.0, n)
    out = np.asarray(eval_texture(
        scene.textures, jnp.full((n,), earth, jnp.int32), u,
        jnp.full((n,), 0.5, jnp.float32), jnp.zeros((n, 3), jnp.float32)))
    assert out.min() >= 0.0 and out.max() <= 1.0
    assert out.std() > 0.05
    # the equatorial line of earthmap.jpg is mostly ocean at u=0.45 (Pacific
    # on the left half given the map wraps at the antimeridian)
    assert out[:, 2].mean() > out[:, 0].mean() * 0.8  # bluish overall


def test_checker_nesting_rejected():
    b = SceneBuilder()
    c1 = b.checker_texture(b.constant_texture((1, 1, 1)),
                           b.constant_texture((0, 0, 0)))
    with pytest.raises(ValueError):
        b.checker_texture(c1, b.constant_texture((0, 0, 0)))


def test_bilinear_565_matches_rgb8():
    """RGB565 pair-atlas bilinear == exact 8-bit bilinear within the 5-bit
    quantization bound, including the clamp-addressing edges."""
    import jax.numpy as jnp
    from rtw.ops.textures import _image_bilinear, _image_bilinear_565
    import rtw as rt

    scene = rt.build_scene(2, 64, 32)   # has the earth image texture
    tex = scene.textures
    rng = np.random.default_rng(3)
    n = 4096
    u = jnp.asarray(rng.uniform(-0.1, 1.1, n), jnp.float32)  # past the edges
    v = jnp.asarray(rng.uniform(-0.1, 1.1, n), jnp.float32)
    iid = jnp.zeros(n, jnp.int32)
    a = np.asarray(_image_bilinear(tex, iid, u, v).stack())
    b = np.asarray(_image_bilinear_565(tex, iid, u, v).stack())
    # 5-bit channels quantize at 1/62 half-step; allow 2 half-steps for the
    # bilinear mix of 4 taps
    assert np.abs(a - b).max() <= 2.0 / 62.0 + 1e-6


def test_nearest565_close_to_bilinear():
    """cfg.tex_filter='nearest565' (one-gather point sampling) must agree
    with the bilinear 565 fetch at texel centers and stay close elsewhere
    (it is a documented quality-for-speed knob, not a different texture)."""
    import rtw as rt
    from rtw.ops.textures import _image_bilinear_565, _image_nearest_565

    scene = rt.build_scene(2, 32, 32)   # earth image atlas
    tex = scene.textures
    rng = np.random.default_rng(3)
    n = 4096
    u = jnp.asarray(rng.uniform(0.02, 0.98, n), jnp.float32)
    v = jnp.asarray(rng.uniform(0.02, 0.98, n), jnp.float32)
    ids = jnp.zeros((n,), jnp.int32)
    a = np.asarray(_image_bilinear_565(tex, ids, u, v).stack())
    b = np.asarray(_image_nearest_565(tex, ids, u, v).stack())
    assert np.isfinite(b).all()
    # same image content: mean agrees tightly, pointwise within one texel's
    # neighborhood contrast
    assert abs(a.mean() - b.mean()) < 0.01
    assert np.abs(a - b).mean() < 0.08


def test_tiled_atlas_gate_exact():
    """The tile-ladder atlas gate (ops/shading._image_eval_tiled) must
    return the full-width fetch on every needing lane (same taps, same
    blend — differing only by XLA fusion reassociation, hence 1-ulp
    tolerance), across ladder tiers (count in the T/8, T/4, T/2 and T
    regimes) and with needing granules scattered anywhere."""
    import rtw as rt
    from rtw.ops.shading import (_image_eval, _image_eval_tiled,
                                     _ATLAS_GRANULE)

    scene = rt.build_scene(2, 32, 32)   # earth image atlas
    rng = np.random.default_rng(5)
    g = _ATLAS_GRANULE
    t = 16
    n = t * g
    u = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    v = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    ids = jnp.zeros((n,), jnp.int32)

    full = np.asarray(_image_eval(scene, ids, u, v, "rgb565").stack())
    for needing_tiles in (1, 3, 7, 13, 16, 0):
        tn = np.zeros(t, bool)
        tn[rng.choice(t, needing_tiles, replace=False)] = True
        need = np.zeros((t, g), bool)
        # sparse needing lanes inside a needing granule
        need[tn] = rng.random((needing_tiles, g)) < 0.1 if needing_tiles \
            else False
        need_j = jnp.asarray(need.reshape(-1))
        out = np.asarray(_image_eval_tiled(scene, ids, u, v, "rgb565",
                                           need_j).stack())
        m = need.reshape(-1)
        np.testing.assert_allclose(out[m], full[m], atol=1e-6,
                                   err_msg=f"tiles={needing_tiles}")


def test_stoch565_expectation_is_bilinear():
    """cfg.tex_filter='stoch565' (one-gather stochastic-row bilinear) is an
    UNBIASED estimator of the 565 bilinear value: averaging the fetch over
    many independent row-selection uniforms converges to
    _image_bilinear_565 at every (u, v), and each single draw is one of
    the two x-blended rows (bounded by the two row values)."""
    import jax.numpy as jnp
    from rtw.ops.textures import _image_bilinear_565, _image_stoch_565
    import rtw as rt

    scene = rt.build_scene(2, 64, 32)   # has the earth image texture
    tex = scene.textures
    rng = np.random.default_rng(11)
    n = 512
    u = jnp.asarray(rng.uniform(-0.1, 1.1, n), jnp.float32)  # past the edges
    v = jnp.asarray(rng.uniform(-0.1, 1.1, n), jnp.float32)
    iid = jnp.zeros(n, jnp.int32)
    want = np.asarray(_image_bilinear_565(tex, iid, u, v).stack())

    reps = 2048
    acc = np.zeros_like(want)
    for r in range(reps):
        xi = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
        acc += np.asarray(_image_stoch_565(tex, iid, u, v, xi).stack())
    mean = acc / reps
    # MC error of a Bernoulli mix of two texel rows at 2048 draws: the
    # row gap is <= 1.0 per channel -> se <= 0.5/sqrt(2048) ~ 0.011/channel
    assert np.abs(mean - want).max() < 0.06
    assert np.abs(mean - want).mean() < 0.01


def test_stoch565_render_matches_bilinear():
    """A real render with tex_filter='stoch565' converges to the rgb565
    image: same scene/sampling, the two estimators differ only in texture
    filtering, so at moderate spp the images must agree to MC-noise
    tolerance on average."""
    import rtw as rt

    nx, ny, spp = 64, 32, 64
    scene = rt.build_scene(2, nx, ny)
    import dataclasses
    base = rt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=8, scene_id=2)
    a = np.asarray(rt.render(scene, dataclasses.replace(
        base, tex_filter="rgb565")))
    b = np.asarray(rt.render(scene, dataclasses.replace(
        base, tex_filter="stoch565")))
    assert np.isfinite(b).all()
    # identical estimator draws (the filter uniform rides a dedicated
    # slot), so differences are confined to image-texture paths
    assert np.abs(a - b).mean() < 0.01
    assert np.abs(a - b).max() < 0.35
