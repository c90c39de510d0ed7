"""Sharding tests on the 8-virtual-device CPU mesh (SURVEY §4 tier 5).

The key property: because RNG is keyed by logical (pixel, sample) indices,
the rendered image must be *bit-identical* across mesh shapes and sharding
strategies — sharding must never change the estimator.  Bitwise identity is
the guarantee of scheduler="regen" (per-lane sample order is fixed); the
default work-queue scheduler produces the same per-pixel sample set but
reassociates the per-pixel sum in claim order, so it is asserted allclose
across mesh shapes instead (test_queue_scheduler_mesh_allclose).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import rtw as rt
from rtw.parallel.mesh import make_mesh, render_sharded, grad_sharded
from rtw.utils import rng as R
from rtw.diff import extract_params


@pytest.fixture(scope="module")
def small_setup():
    cfg = rt.RenderConfig(nx=40, ny=16, spp=8, max_depth=4, scene_id=5,
                          scheduler="regen")
    scene = rt.build_scene(5, cfg.nx, cfg.ny)
    return scene, cfg


def test_queue_scheduler_mesh_allclose(small_setup):
    """The work-queue scheduler's image equals the regen scheduler's and is
    mesh-shape-stable to fp-reassociation tolerance."""
    scene, cfg_regen = small_setup
    import dataclasses

    cfg = dataclasses.replace(cfg_regen, scheduler="queue")
    ref = np.asarray(rt.render(scene, cfg_regen))
    img1 = np.asarray(rt.render(scene, cfg))
    img2 = render_sharded(scene, cfg, make_mesh(jax.devices()[:2]),
                          mode="pixels")
    img8 = render_sharded(scene, cfg, make_mesh(jax.devices()[:8]),
                          mode="pixels")
    for im in (img1, img2, img8):
        np.testing.assert_allclose(im, ref, atol=1e-5, rtol=1e-5)


def test_queue_flush_policy_estimator_neutral(small_setup):
    """cfg.flush_denom only reorders flush timing — identical per-pixel
    sample sets, so images agree to fp-reassociation tolerance across
    flush-every-iteration (0), the default deferred policy, and an extreme
    defer (8)."""
    scene, cfg_regen = small_setup
    import dataclasses

    imgs = []
    for fd in (0, 2, 8):
        cfg = dataclasses.replace(cfg_regen, scheduler="queue",
                                  flush_denom=fd)
        imgs.append(np.asarray(rt.render(scene, cfg)))
    np.testing.assert_allclose(imgs[1], imgs[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(imgs[2], imgs[0], atol=1e-5, rtol=1e-5)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_pixel_sharding_bit_identical(small_setup):
    scene, cfg = small_setup
    ref = np.asarray(rt.render(scene, cfg))
    mesh8 = make_mesh(jax.devices()[:8])
    img8 = render_sharded(scene, cfg, mesh8, mode="pixels")
    np.testing.assert_array_equal(img8, ref)


def test_mesh_shape_invariance(small_setup):
    scene, cfg = small_setup
    mesh2 = make_mesh(jax.devices()[:2])
    mesh8 = make_mesh(jax.devices()[:8])
    img2 = render_sharded(scene, cfg, mesh2, mode="pixels")
    img8 = render_sharded(scene, cfg, mesh8, mode="pixels")
    np.testing.assert_array_equal(img2, img8)


def test_sample_sharding_matches(small_setup):
    scene, cfg = small_setup
    ref = np.asarray(rt.render(scene, cfg))
    mesh = make_mesh(jax.devices()[:8])
    img = render_sharded(scene, cfg, mesh, mode="samples")
    # same estimator, different accumulation order -> fp-tolerance equality
    np.testing.assert_allclose(img, ref, atol=1e-5, rtol=1e-5)


def test_grad_sharded_matches_single_device(small_setup):
    scene, _ = small_setup
    cfg = rt.RenderConfig(nx=40, ny=16, spp=2, max_depth=3, scene_id=5,
                          differentiable=True)
    key = R.base_key(0)
    params = extract_params(scene)
    target = np.zeros((cfg.ny, cfg.nx, 3), np.float32)

    mesh1 = make_mesh(jax.devices()[:1])
    mesh8 = make_mesh(jax.devices()[:8])
    l1, g1 = grad_sharded(scene, cfg, mesh1, params, target, key, n_samples=2)
    l8, g8 = grad_sharded(scene, cfg, mesh8, params, target, key, n_samples=2)
    assert np.isfinite(float(l1))
    np.testing.assert_allclose(float(l1), float(l8), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g8)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-4)


def test_sharded_checkpoint_resume(small_setup, tmp_path):
    """Interrupting a sharded render and resuming from its checkpoint yields
    the bit-exact image of an uninterrupted run."""
    scene, _ = small_setup
    cfg = rt.RenderConfig(nx=40, ny=16, spp=8, max_depth=4, scene_id=5,
                          spp_chunk=2)
    mesh = make_mesh(jax.devices()[:4])
    ref = render_sharded(scene, cfg, mesh, mode="pixels")

    path = str(tmp_path / "shard.ckpt")
    # "preempted" run: only the first chunks land (simulate by rendering a
    # truncated spp with the same chunking, then seeding the checkpoint)
    cfg_half = rt.RenderConfig(nx=40, ny=16, spp=4, max_depth=4, scene_id=5,
                               spp_chunk=2)
    half = render_sharded(scene, cfg_half, mesh, mode="pixels",
                          checkpoint_path=str(tmp_path / "half.ckpt"))
    from rtw.utils import checkpoint as ckpt
    st = ckpt.load(str(tmp_path / "half.ckpt"), cfg_half)
    assert st is not None and st[2] == 4
    # write it under the full config's fingerprint to resume from spp=4
    ckpt.save(path, cfg, st[0], st[1], st[2])

    resumed = render_sharded(scene, cfg, mesh, mode="pixels",
                             checkpoint_path=path)
    np.testing.assert_array_equal(resumed, ref)


def test_grad_sharded_pads_odd_pixel_count(small_setup):
    """grad_sharded must accept pixel counts that don't divide the device
    count (padded lanes carry weight 0) and agree with a 1-device run."""
    scene, _ = small_setup
    # 42*3 = 126 pixels, not divisible by 8 (or 4)
    cfg = rt.RenderConfig(nx=42, ny=3, spp=2, max_depth=3, scene_id=5,
                          differentiable=True)
    key = R.base_key(0)
    params = extract_params(scene)
    target = np.zeros((cfg.ny, cfg.nx, 3), np.float32)
    mesh1 = make_mesh(jax.devices()[:1])
    mesh8 = make_mesh(jax.devices()[:8])
    l1, g1 = grad_sharded(scene, cfg, mesh1, params, target, key, n_samples=2)
    l8, g8 = grad_sharded(scene, cfg, mesh8, params, target, key, n_samples=2)
    np.testing.assert_allclose(float(l1), float(l8), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g8)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-4)


def test_checkpoint_every_non_divisible(small_setup, tmp_path):
    """checkpoint_every that is not a multiple of the spp chunk must still
    fire (>= threshold since last save, not exact-multiple)."""
    scene, _ = small_setup
    cfg = rt.RenderConfig(nx=40, ny=16, spp=8, max_depth=4, scene_id=5,
                          spp_chunk=2)
    path = str(tmp_path / "odd.ckpt")
    from rtw.utils import checkpoint as ckpt
    saves = []
    orig = ckpt.save

    def spy(path_, cfg_, acc, rays, spp):
        saves.append(spp)
        return orig(path_, cfg_, acc, rays, spp)

    ckpt.save = spy
    try:
        rt.render(scene, cfg, checkpoint_path=path, checkpoint_every=3)
    finally:
        ckpt.save = orig
    # chunks land at 2,4,6,8; >=3-since-last-save fires at 4 and 8 (end)
    assert saves == [4, 8], saves


def test_sample_sharding_metrics(small_setup):
    scene, cfg = small_setup
    mesh = make_mesh(jax.devices()[:8])
    m = {}
    img = render_sharded(scene, cfg, mesh, mode="samples", metrics=m)
    assert m["rays"] > 0 and m["devices"] == 8
    ref = np.asarray(rt.render(scene, cfg))
    np.testing.assert_allclose(img, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scheduler", ["regen", "queue"])
@pytest.mark.parametrize("mode", ["pixels", "samples"])
def test_sharded_ray_count_matches_single_device(small_setup, mode,
                                                 scheduler):
    """render_sharded's `rays` (psum over the mesh) counts exactly the rays
    of the one-device render(): same paths, same bounces, same shadow rays,
    so rays/s on N devices compares with rays/s on one."""
    import dataclasses

    scene, cfg_regen = small_setup
    cfg = dataclasses.replace(cfg_regen, scheduler=scheduler)
    m1, m8 = {}, {}
    rt.render(scene, cfg, metrics=m1)
    render_sharded(scene, cfg, make_mesh(jax.devices()[:8]), mode=mode,
                   metrics=m8)
    assert m1["rays"] > m1["paths"]           # bounces and shadow rays
    assert m8["rays"] == m1["rays"]
    assert m8["paths"] == m1["paths"]


def test_sharded_pallas_queue_interpret(small_setup):
    """The multi-card configuration — queue scheduler + Pallas-Triton trace
    kernels under shard_map — on the 8-device CPU mesh through the Pallas
    interpreter.  Must agree with the single-device render of the same
    config to queue-reassociation tolerance."""
    import dataclasses
    from rtw.ops import trace_kernel as TK

    scene, cfg_regen = small_setup
    cfg = dataclasses.replace(cfg_regen, backend="pallas",
                              scheduler="queue")
    with TK.interpret_mode():
        ref = np.asarray(rt.render(scene, cfg))
        img8 = render_sharded(scene, cfg, make_mesh(jax.devices()[:8]),
                              mode="pixels")
    assert np.isfinite(img8).all()
    np.testing.assert_allclose(np.asarray(img8), ref, atol=2e-5, rtol=2e-5)


def test_sharded_image_texture_stoch565():
    """Sharded rendering of an image-texture scene under the round-5
    default stochastic-bilinear filter: the dedicated filter-jitter slot
    is keyed by (pixel, sample, bounce) like every other draw, so the
    regen-scheduler image must be bit-identical across mesh shapes, and
    the queue scheduler must agree to fp-reassociation tolerance."""
    import dataclasses

    cfg = rt.RenderConfig(nx=40, ny=16, spp=4, max_depth=4, scene_id=2,
                          scheduler="regen", tex_filter="stoch565")
    scene = rt.build_scene(2, cfg.nx, cfg.ny)
    ref = np.asarray(rt.render(scene, cfg))
    assert np.isfinite(ref).all() and ref.max() > 0.0
    img2 = np.asarray(render_sharded(scene, cfg,
                                     make_mesh(jax.devices()[:2]),
                                     mode="pixels"))
    img8 = np.asarray(render_sharded(scene, cfg,
                                     make_mesh(jax.devices()[:8]),
                                     mode="pixels"))
    np.testing.assert_array_equal(img2, ref)
    np.testing.assert_array_equal(img8, ref)

    cfg_q = dataclasses.replace(cfg, scheduler="queue")
    img_q = np.asarray(rt.render(scene, cfg_q))
    np.testing.assert_allclose(img_q, ref, atol=1e-5, rtol=1e-5)
