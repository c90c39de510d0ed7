"""Pallas-Triton trace kernels against the pure-JAX reference sweep.

The kernels run here through the Pallas interpreter
(trace_kernel.interpret_mode); the same comparison runs compiled on the
GPU in chip_smoke.py phase (c).  The pure-JAX ops/intersect.py sweep is the
reference implementation: the kernel's (t, prim) winner must agree with it
on every ray, and the hit record built from it must equal the reference's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import rtw as rt
from rtw import integrator as IG
from rtw.ops import trace_kernel as TK
from rtw.ops.intersect import intersect_scene, nearest, occluded, winner_hit
from rtw.ops.shading import gather_shade
from rtw.ops.vec import v3


def _rand_rays(rng, n, scale, origin_shift):
    o = v3(jnp.asarray(rng.uniform(-1, 1, (n, 3)) * scale + origin_shift,
                       jnp.float32))
    d = v3(jnp.asarray(rng.normal(size=(n, 3)), jnp.float32))
    return o, d


def _assert_same_winner(scene, o, d, tm, vu):
    """Kernel (interpreted) vs reference: winner, t, hit record, shading
    record and occlusion."""
    h_ref = intersect_scene(scene, o, d, 1e-6, 1e27, tm, vu)
    occ_ref = occluded(scene, o, d, 1e-4, 1e4, tm, vu)
    with TK.interpret_mode():
        k_t, k_i = TK.nearest_pallas(scene, o, d, 1e-6, 1e27, tm, vu)
        occ_k = TK.occluded_pallas(scene, o, d, 1e-4, 1e4, tm, vu)
    np.testing.assert_array_equal(np.asarray(h_ref.prim_idx), np.asarray(k_i))
    hit = np.asarray(h_ref.prim_idx) >= 0
    # rtol 2e-4: grazing hits amplify FMA-contraction differences between
    # the two compilations through the quadratic's catastrophic cancellation
    np.testing.assert_allclose(np.asarray(h_ref.t)[hit],
                               np.asarray(k_t)[hit], rtol=2e-4)
    np.testing.assert_array_equal(np.asarray(occ_ref), np.asarray(occ_k))

    h_k = winner_hit(scene, k_t, k_i, o, d, tm, 1e-6)
    for a, b in [(h_ref.point, h_k.point), (h_ref.normal, h_k.normal)]:
        np.testing.assert_allclose(np.asarray(a.stack())[hit],
                                   np.asarray(b.stack())[hit],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(h_ref.u)[hit],
                               np.asarray(h_k.u)[hit], atol=1e-4)
    np.testing.assert_array_equal(np.asarray(h_ref.mat_id),
                                  np.asarray(h_k.mat_id))
    sh_ref = gather_shade(scene, h_ref.prim_idx, h_ref.prim_idx >= 0)
    sh_k = gather_shade(scene, h_k.prim_idx, h_k.prim_idx >= 0)
    np.testing.assert_array_equal(np.asarray(sh_ref.mat_type),
                                  np.asarray(sh_k.mat_type))
    return hit


@pytest.mark.parametrize("sid,scale,shift", [
    (0, 600.0, (278.0, 278.0, -400.0)),   # Cornell: transforms + NEE light
    (3, 600.0, (278.0, 278.0, -400.0)),   # volumes + transforms
    (5, 4.0, (0.0, 1.0, 1.0)),            # spheres only
    (1, 12.0, (0.0, 1.0, 0.0)),           # moving spheres, many blocks
    (2, 12.0, (0.0, 1.0, 0.0)),           # image texture, light rect
    (4, 600.0, (278.0, 278.0, -400.0)),   # boxes, volumes, xformed spheres
])
def test_kernel_matches_jnp(sid, scale, shift):
    scene = rt.build_scene(sid, 64, 64)
    rng = np.random.default_rng(7)
    n = 2 * TK.RAY_BLOCK
    o, d = _rand_rays(rng, n, scale, shift)
    tm = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    vu = jnp.asarray(rng.uniform(0.05, 0.95,
                                 (max(scene.n_vol, 1), n)), jnp.float32)
    hit = _assert_same_winner(scene, o, d, tm, vu)
    assert hit.any()


def _many_prim_scene():
    """Synthetic large scene: >= 3 blocks each of spheres, boxes and rects,
    so the kernels' multi-block groups and per-block culls are exercised."""
    from rtw.models.builder import SceneBuilder
    import rtw.models.scene as S

    b = SceneBuilder()
    rng = np.random.default_rng(3)
    mat = b.lambertian(b.constant_texture((0.5, 0.5, 0.5)))
    for _ in range(200):
        c = rng.uniform(-100, 100, 3)
        b.sphere(c, rng.uniform(1.0, 6.0), mat)
    for _ in range(200):
        lo = rng.uniform(-100, 100, 3)
        b.box(lo, lo + rng.uniform(2.0, 10.0, 3), mat)
    for _ in range(200):
        a0, b0 = rng.uniform(-100, 90, 2)
        b.rect(a0, a0 + 10, b0, b0 + 10, rng.uniform(-100, 100), False,
               S.AXIS_Y, mat)
    b.set_camera(lookfrom=(0, 0, -300), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov=40.0, aspect=1.0, aperture=0.0, focus_dist=10.0)
    return b.build()


def test_kernel_dynamic_traversal_matches_jnp():
    """Multi-block groups (the culled block loop) on a 600-prim scene."""
    scene = _many_prim_scene()
    assert any(e[2] // e[6] >= 3 for e in scene.chunk_plan)
    rng = np.random.default_rng(9)
    n = TK.RAY_BLOCK
    o, d = _rand_rays(rng, n, 120.0, (0.0, 0.0, 0.0))
    tm = jnp.zeros((n,), jnp.float32)
    vu = jnp.full((1, n), 0.5, jnp.float32)
    hit = _assert_same_winner(scene, o, d, tm, vu)
    assert hit.sum() > 30


def test_kernel_ragged_ray_count():
    """A ray count that is not a multiple of the ray block: the padded
    tail is dead and sliced off."""
    scene = rt.build_scene(5, 16, 16)
    rng = np.random.default_rng(1)
    n = TK.RAY_BLOCK + 37
    o, d = _rand_rays(rng, n, 4.0, (0.0, 1.0, 1.0))
    tm = jnp.zeros((n,), jnp.float32)
    vu = jnp.full((1, n), 0.5, jnp.float32)
    with TK.interpret_mode():
        k_t, k_i = TK.nearest_pallas(scene, o, d, 1e-6, 1e27, tm, vu)
        occ = TK.occluded_pallas(scene, o, d, 1e-4, 1e4, tm, vu)
    assert k_t.shape == (n,) and k_i.shape == (n,) and occ.shape == (n,)
    r_t, r_i = nearest(scene, o, d, 1e-6, 1e27, tm, vu)
    np.testing.assert_array_equal(np.asarray(k_i), np.asarray(r_i))
    np.testing.assert_array_equal(
        np.asarray(occ), np.asarray(occluded(scene, o, d, 1e-4, 1e4, tm, vu)))


def test_kernel_dead_lanes_miss():
    """tmax = -BIG (the integrator's dead-lane sentinel) forces a miss and
    no occlusion, whatever the ray points at."""
    scene = rt.build_scene(0, 16, 16)
    n = TK.RAY_BLOCK
    o = v3(jnp.tile(jnp.asarray([[278.0, 278.0, -800.0]], jnp.float32),
                    (n, 1)))
    d = v3(jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (n, 1)))
    alive = np.arange(n) % 2 == 0
    tmax = jnp.where(jnp.asarray(alive), 1e27, -TK.BIG)
    tm = jnp.zeros((n,), jnp.float32)
    vu = jnp.full((1, n), 0.5, jnp.float32)
    with TK.interpret_mode():
        k_t, k_i = TK.nearest_pallas(scene, o, d, 1e-6, tmax, tm, vu)
        occ = TK.occluded_pallas(scene, o, d, 1e-4, tmax, tm, vu)
    k_i, occ = np.asarray(k_i), np.asarray(occ)
    assert (k_i[alive] >= 0).all()                 # the back wall is hit
    assert (k_i[~alive] == -1).all()
    assert not occ[~alive].any()
    assert (np.asarray(k_t)[~alive] >= TK.BIG).all()


@pytest.mark.parametrize("backend,sid,platform,expect", [
    ("auto", 4, "gpu", True),       # >= KERNEL_MIN_PRIMS on the GPU
    ("auto", 0, "gpu", True),       # Cornell: 8 surface prims
    ("auto", 3, "gpu", False),      # Cornell volumes: 6 surface + 2 volume
    ("auto", 5, "gpu", False),      # three spheres fuse in XLA
    ("auto", 4, "cpu", False),      # never off the GPU
    ("jnp", 4, "gpu", False),
    ("pallas", 5, "gpu", True),     # forced, on the GPU
])
def test_auto_dispatch(monkeypatch, backend, sid, platform, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    scene = rt.build_scene(sid, 16, 16)
    n_surface = sum(e[1] for e in scene.chunk_plan) - scene.n_vol
    assert (n_surface >= IG.KERNEL_MIN_PRIMS) == (sid not in (3, 5))
    cfg = rt.RenderConfig(nx=16, ny=16, backend=backend, scene_id=sid)
    assert IG._pallas_backend(cfg, scene) is expect


def test_forced_pallas_off_gpu_raises():
    """No silent fallback: backend='pallas' off the GPU raises eagerly (in
    render(), before any jit cache could serve an interpreted kernel) and
    names the fix; the tests' interpreter is the only exception."""
    assert jax.default_backend() == "cpu"
    scene = rt.build_scene(5, 16, 8)
    cfg = rt.RenderConfig(nx=16, ny=8, spp=1, max_depth=2, scene_id=5,
                          backend="pallas", seed=123)
    with pytest.raises(ValueError, match="needs a GPU"):
        rt.render(scene, cfg)
    o, d = _rand_rays(np.random.default_rng(0), 8, 1.0, (0, 0, 0))
    with pytest.raises(ValueError, match="need a GPU"):
        TK.nearest_pallas(scene, o, d, 1e-6, 1e27, jnp.zeros(8),
                          jnp.zeros((1, 8)))
    with TK.interpret_mode():
        assert IG._pallas_backend(cfg, scene)
    with pytest.raises(ValueError, match="unknown backend"):
        rt.RenderConfig(backend="mega")
    with pytest.raises(ValueError, match="unknown scheduler"):
        rt.RenderConfig(scheduler="qmega")
