"""Gradient validation vs central finite differences (SURVEY §4 tier 4;
BASELINE.json metric: "grad allclose vs FD").

Detached sampling makes the estimator a smooth function of albedo, emission
and camera parameters *for a fixed random stream*, so analytic gradients of
the sampled estimator must match finite differences of the same estimator
to high precision (this is not an MC-noise comparison — same keys on both
sides)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import rtw as rt
from rtw.models import scene as S
from rtw.models.builder import SceneBuilder
from rtw.diff import (extract_params, apply_params, render_for_grad,
                          make_loss_and_grad)
from rtw.utils import rng as R


@pytest.fixture(scope="module")
def simple_scene():
    """Lambertian + light scene: every gradient path is exercised (albedo
    products, NEE emission, BSDF-side emission, camera geometry)."""
    b = SceneBuilder()
    ground = b.lambertian(b.constant_texture((0.6, 0.5, 0.4)))
    ball = b.lambertian(b.constant_texture((0.3, 0.6, 0.2)))
    lt = b.constant_texture((5.0, 5.0, 5.0))
    b.sphere((0.0, -100.5, -3.0), 100.0, ground)
    b.sphere((0.0, 0.0, -3.0), 0.5, ball)
    b.rect(-1.0, 1.0, -1.0, 1.0, 3.0, True, S.AXIS_Y, b.diffuse_light(lt))
    b.add_light((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0),
                (5.0, 5.0, 5.0), tex=lt)
    b.set_camera((0, 0.3, 0), (0, 0, -3), (0, 1, 0), 45, 1.0, 0.0, 1.0)
    return b.build()


CFG = rt.RenderConfig(nx=12, ny=12, spp=1, max_depth=4, differentiable=True)
N_SAMPLES = 3


def _fd_vs_grad(scene, get_set, eps, rtol):
    key = R.base_key(7)
    pix = jnp.arange(CFG.num_pixels, dtype=jnp.int32)
    get, put = get_set
    params = extract_params(scene)

    def scalar_est(v):
        p = put(params, v)
        return jnp.sum(render_for_grad(p, scene, CFG, pix, key, N_SAMPLES))

    v0 = get(params)
    analytic = float(jax.grad(scalar_est)(v0))
    numeric = float((scalar_est(v0 + eps) - scalar_est(v0 - eps)) / (2 * eps))
    assert np.isfinite(analytic) and np.isfinite(numeric)
    assert numeric != 0.0, "estimator insensitive — test is vacuous"
    np.testing.assert_allclose(analytic, numeric, rtol=rtol)
    return analytic


def test_albedo_gradient_matches_fd(simple_scene):
    # ground red-channel albedo (texture row 0, channel 0)
    gs = (lambda p: p["tex_color"][0, 0],
          lambda p, v: {**p, "tex_color": p["tex_color"].at[0, 0].set(v)})
    _fd_vs_grad(simple_scene, gs, eps=1e-2, rtol=2e-2)


def test_emission_gradient_matches_fd(simple_scene):
    # light emission green channel (texture row 2 backs the light)
    row = simple_scene.light_tex[0]
    gs = (lambda p: p["tex_color"][row, 1],
          lambda p, v: {**p, "tex_color": p["tex_color"].at[row, 1].set(v)})
    g = _fd_vs_grad(simple_scene, gs, eps=1e-2, rtol=2e-2)
    assert g > 0  # more emission -> more radiance


def test_camera_gradient_matches_fd():
    """Camera gradients are validated on a *smooth* configuration: direct
    lighting (max_depth=1) of a frame-filling ground with no silhouettes in
    view.  With silhouette edges in frame, FD picks up visibility jumps that
    path-space gradients (detached sampling, no edge sampling) deliberately
    do not model — the documented scope (diff.py docstring, SURVEY §7.3)."""
    b = SceneBuilder()
    ground = b.lambertian(b.constant_texture((0.6, 0.5, 0.4)))
    lt = b.constant_texture((5.0, 5.0, 5.0))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, ground)
    # off-center light -> lateral illumination gradient on the ground, so
    # the image is a smooth nonconstant function of camera translation
    b.rect(5.0, 25.0, -10.0, 10.0, 12.0, True, S.AXIS_Y, b.diffuse_light(lt))
    b.add_light((5.0, 12.0, -10.0), (20.0, 0.0, 0.0), (0.0, 0.0, 20.0),
                (5.0, 5.0, 5.0), tex=lt)
    # look straight down at the ground: every camera ray hits it
    b.set_camera((0, 5.0, 0), (0, 0, 0), (0, 0, -1), 45, 1.0, 0.0, 1.0)
    scene = b.build()

    cfg = rt.RenderConfig(nx=12, ny=12, spp=1, max_depth=1,
                          differentiable=True)
    key = R.base_key(7)
    pix = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
    params = extract_params(scene)

    import dataclasses

    # differentiate the frustum's lower-left x (a pan): first-order effect
    # on every hit point (origin alone barely moves hit points because each
    # ray re-aims through its fixed frustum target)
    def scalar_est(v):
        cam = params["camera"]
        p = {**params, "camera": dataclasses.replace(
            cam, lower_left=cam.lower_left.at[0].set(v))}
        return jnp.sum(render_for_grad(p, scene, cfg, pix, key, N_SAMPLES))

    v0 = params["camera"].lower_left[0]
    analytic = float(jax.grad(scalar_est)(v0))
    eps = 5e-3
    numeric = float((scalar_est(v0 + eps) - scalar_est(v0 - eps)) / (2 * eps))
    assert np.isfinite(analytic) and numeric != 0.0
    np.testing.assert_allclose(analytic, numeric, rtol=5e-2)


def test_loss_and_grad_runs(simple_scene):
    fn = make_loss_and_grad(simple_scene, CFG, n_samples=2)
    pix = jnp.arange(CFG.num_pixels, dtype=jnp.int32)
    target = jnp.zeros((CFG.num_pixels, 3), jnp.float32)
    loss, grads = fn(extract_params(simple_scene), target, pix, R.base_key(0))
    assert np.isfinite(float(loss)) and float(loss) > 0
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(np.isfinite(np.asarray(l)).all() for l in leaves)
    # albedo rows of used textures must receive gradient
    assert float(jnp.abs(grads["tex_color"]).sum()) > 0


def test_gradient_descent_recovers_albedo(simple_scene):
    """End-to-end inverse rendering sanity: perturb the ball albedo, descend
    on MSE to the original render, albedo moves back toward the truth."""
    key = R.base_key(11)
    pix = jnp.arange(CFG.num_pixels, dtype=jnp.int32)
    true_params = extract_params(simple_scene)
    target = render_for_grad(true_params, simple_scene, CFG, pix, key, 2)

    params = {**true_params,
              "tex_color": true_params["tex_color"].at[1, :].set(
                  jnp.asarray([0.8, 0.1, 0.9]))}

    def loss_fn(p):
        img = render_for_grad(p, simple_scene, CFG, pix, key, 2)
        return jnp.mean((img - target) ** 2)

    vg = jax.jit(jax.value_and_grad(loss_fn))
    l0 = None
    for i in range(12):
        loss, g = vg(params)
        if l0 is None:
            l0 = float(loss)
        params = {**params,
                  "tex_color": params["tex_color"] - 40.0 * g["tex_color"]}
    assert float(loss) < 0.5 * l0


def test_chunked_grad_matches_monolithic(simple_scene):
    """make_loss_and_grad_chunked (constant-memory spp accumulation +
    cfg.remat bounce rematerialization) must produce the same loss and
    gradients as the monolithic estimator."""
    from rtw.diff import make_loss_and_grad_chunked

    scene = simple_scene
    key = R.base_key(3)
    pix = jnp.arange(CFG.num_pixels, dtype=jnp.int32)
    params = extract_params(scene)
    target = jnp.zeros((CFG.num_pixels, 3), jnp.float32)

    loss_m, grads_m = make_loss_and_grad(scene, CFG, 4)(params, target, pix,
                                                        key)
    loss_c, grads_c = make_loss_and_grad_chunked(scene, CFG, 4, 2)(
        params, target, pix, key)
    np.testing.assert_allclose(float(loss_c), float(loss_m), rtol=1e-5)
    flat_m = jax.tree_util.tree_leaves(grads_m)
    flat_c = jax.tree_util.tree_leaves(grads_c)
    for a, b in zip(flat_m, flat_c):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("sid", [0, 1, 2, 3, 4, 5])
def test_gradients_finite_all_scenes(sid):
    """Every reference scene must yield finite gradients.  Regression for
    two masked-lane NaN-cotangent leaks found in round 4 (both poisoned the
    SHARED camera gradient through the lane sum while the primal image was
    fine): a TNW ground box with maxx == 0.0 made the sphere payload's
    1/p9[3] inf on mismatched-winner lanes, and zero-density volume PAD
    rows sent inf `flight` into d_len's cotangent (intersect.py guards)."""
    size = 24
    cfg = rt.RenderConfig(nx=size, ny=size, spp=1, max_depth=3,
                          differentiable=True, backend="jnp", scene_id=sid)
    scene = rt.build_scene(sid, size, size)
    pix = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
    params = extract_params(scene)
    target = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
    loss, g = make_loss_and_grad(scene, cfg, 2)(params, target, pix,
                                                R.base_key(3))
    assert np.isfinite(float(loss))
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.isfinite(np.asarray(l)).all() for l in leaves), \
        [np.isnan(np.asarray(l)).any() for l in leaves]
    assert float(jnp.abs(g["tex_color"]).sum()) > 0


@pytest.mark.parametrize("sid", [0, 3])
def test_pallas_grad_matches_jnp(sid):
    """The fast gradient path (kernel forward trace under stop_gradient +
    reeval_hit differentiable winner payload) must produce the same loss and
    gradients as the pure-JAX sweep — on scenes exercising instance
    transforms, dielectric/metal, NEE (Cornell) and volumes (scene 3)."""
    import dataclasses
    from rtw.ops import trace_kernel as TK

    scene = rt.build_scene(sid, 12, 12)
    cfg_jnp = rt.RenderConfig(nx=12, ny=12, spp=1, max_depth=4,
                              differentiable=True, backend="jnp",
                              scene_id=sid)
    cfg_pal = dataclasses.replace(cfg_jnp, backend="pallas")
    key = R.base_key(13)
    pix = jnp.arange(cfg_jnp.num_pixels, dtype=jnp.int32)
    params = extract_params(scene)
    target = jnp.zeros((cfg_jnp.num_pixels, 3), jnp.float32)

    l1, g1 = make_loss_and_grad(scene, cfg_jnp, 2)(params, target, pix, key)
    with TK.interpret_mode():
        l2, g2 = make_loss_and_grad(scene, cfg_pal, 2)(params, target, pix,
                                                       key)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g2)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=2e-3, atol=1e-5)


def test_pallas_grad_fd(simple_scene):
    """FD validation directly through the fast gradient path."""
    import dataclasses
    from rtw.ops import trace_kernel as TK

    cfg = dataclasses.replace(CFG, backend="pallas")
    key = R.base_key(7)
    pix = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
    params = extract_params(simple_scene)

    def scalar_est(v):
        p = {**params, "tex_color": params["tex_color"].at[0, 0].set(v)}
        return jnp.sum(render_for_grad(p, simple_scene, cfg, pix, key,
                                       N_SAMPLES))

    v0 = params["tex_color"][0, 0]
    with TK.interpret_mode():
        analytic = float(jax.grad(scalar_est)(v0))
        eps = 1e-2
        numeric = float((scalar_est(v0 + eps) - scalar_est(v0 - eps))
                        / (2 * eps))
    assert np.isfinite(analytic) and numeric != 0.0
    np.testing.assert_allclose(analytic, numeric, rtol=2e-2)


def test_remat_matches_no_remat(simple_scene):
    """jax.checkpoint on the bounce scan body must not change gradients."""
    import dataclasses

    scene = simple_scene
    key = R.base_key(5)
    pix = jnp.arange(CFG.num_pixels, dtype=jnp.int32)
    params = extract_params(scene)
    target = jnp.zeros((CFG.num_pixels, 3), jnp.float32)
    cfg_no = dataclasses.replace(CFG, remat=False)

    l1, g1 = make_loss_and_grad(scene, CFG, 2)(params, target, pix, key)
    l2, g2 = make_loss_and_grad(scene, cfg_no, 2)(params, target, pix, key)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-7)
