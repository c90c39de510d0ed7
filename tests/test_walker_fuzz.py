"""Randomized-scene fuzz of the trace kernels (SURVEY §5 sanitizers row).

Random scenes, with group sizes drawn around block-count edges (64*k +
{-1, 0, +1} prims, so partial last blocks, exact multiples and single-prim
tails all occur), traced by the pure-JAX sweep and by the Pallas-Triton
kernels in interpret mode (per-block AABB cull included).  Both must agree
on winner identity, t, and occlusion for every ray.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from rtw.models.builder import SceneBuilder
from rtw.ops import trace_kernel as TK
from rtw.ops.intersect import intersect_scene, occluded
from rtw.ops.vec import v3


def _fuzz_scene(seed: int):
    """Random sphere/box/rect groups with adversarial block counts.

    Block size is 64 (SceneBuilder.build's chunk_size); counts are drawn
    one under, on and one over a block multiple."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mat = b.lambertian(b.constant_texture((0.6, 0.6, 0.6)))
    metal = b.metal(b.constant_texture((0.9, 0.8, 0.6)), 0.1)

    # counts around block-count edges: 64*k + {-1, 0, +1} prims
    k_s = int(rng.integers(3, 9))
    n_sph = 64 * k_s + int(rng.integers(-1, 2))
    for _ in range(n_sph):
        c = rng.uniform(-120, 120, 3)
        b.sphere(c, rng.uniform(1.0, 5.0), mat if rng.random() < 0.7
                 else metal)
    k_b = int(rng.integers(3, 7))
    n_box = 64 * k_b + int(rng.integers(-1, 2))
    for _ in range(n_box):
        lo = rng.uniform(-120, 120, 3)
        b.box(lo, lo + rng.uniform(2.0, 8.0, 3), mat)
    n_rect = int(rng.integers(190, 260))
    for _ in range(n_rect):
        a0, b0 = rng.uniform(-120, 110, 2)
        b.rect(a0, a0 + rng.uniform(3, 12), b0, b0 + rng.uniform(3, 12),
               rng.uniform(-120, 120), False,
               int(rng.integers(0, 3)), mat)
    b.set_camera(lookfrom=(0, 0, -300), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov=40.0, aspect=1.0, aperture=0.0, focus_dist=10.0)
    return b.build()


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_walker_fuzz_flat_twolevel_jnp(seed):
    scene = _fuzz_scene(seed)
    rng = np.random.default_rng(seed + 1)
    n = 8 * TK.RAY_BLOCK
    o = v3(jnp.asarray(rng.uniform(-1, 1, (n, 3)) * 250.0, jnp.float32))
    d = v3(jnp.asarray(rng.normal(size=(n, 3)), jnp.float32))
    tm = jnp.zeros((n,), jnp.float32)
    vu = jnp.ones((1, n), jnp.float32) * 0.5

    h_ref = intersect_scene(scene, o, d, 1e-6, 1e27, tm, vu)
    occ_ref = occluded(scene, o, d, 1e-4, 1e4, tm, vu)

    with TK.interpret_mode():
        k_t, k_i = TK.nearest_pallas(scene, o, d, 1e-6, 1e27, tm, vu)
        occ_k = TK.occluded_pallas(scene, o, d, 1e-4, 1e4, tm, vu)

    hit = np.asarray(h_ref.prim_idx) >= 0
    assert hit.sum() > 10
    np.testing.assert_array_equal(np.asarray(h_ref.prim_idx), np.asarray(k_i))
    np.testing.assert_allclose(np.asarray(h_ref.t)[hit], np.asarray(k_t)[hit],
                               rtol=2e-4)
    np.testing.assert_array_equal(np.asarray(occ_ref), np.asarray(occ_k))
