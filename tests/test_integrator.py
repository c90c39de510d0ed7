"""Property tests of the estimator (SURVEY §4 tier 2): furnace tests,
energy conservation, sky miss shading, emission one-sidedness."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import rtw as rt
from rtw.models import scene as S
from rtw.models.builder import SceneBuilder
from rtw.integrator import trace_paths
from rtw.utils import rng as R


def _render_mean(scene, cfg, n_pix=None):
    img = np.asarray(rt.render(scene, cfg))
    return img


def test_furnace_lambertian():
    """Constant-albedo lambertian sphere under the uniform-ish sky: a camera
    ray hitting the sphere head-on converges to roughly albedo * sky.  Use a
    WHITE sky by making albedo comparisons relative: with albedo=1 the
    render must converge to the sky radiance (energy conservation: no gain,
    no loss at the surface)."""
    b = SceneBuilder()
    white = b.lambertian(b.constant_texture((1.0, 1.0, 1.0)))
    b.sphere((0.0, 0.0, -3.0), 1.0, white)
    b.set_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 40, 1.0, 0.0, 1.0)
    scene = b.build()
    cfg = rt.RenderConfig(nx=24, ny=24, spp=512, max_depth=32, seed=1)
    img = _render_mean(scene, cfg)
    # center pixels hit the sphere; the books' sky has mean radiance ~0.75
    # hemispherically but varies by direction — so instead compare against
    # an albedo-0.5 render: white furnace ratio should be ~1/(1-0.5*k)...
    # Simpler exact property: with albedo 1 and deep depth, sphere pixels
    # must be bounded by the sky's [min,max] = [0.5*(1,1,1)+..], i.e. within
    # [0.6, 1.05], and not lose energy to below the darkest sky value * 0.9.
    center = img[10:14, 10:14]
    assert center.min() > 0.55
    assert center.max() < 1.05


def test_sky_gradient_miss():
    """Rays that miss get the white->blue gradient (miss/miss.cu:8-21)."""
    b = SceneBuilder()
    m = b.lambertian(b.constant_texture((0.5, 0.5, 0.5)))
    b.sphere((0.0, -10050.0, 0.0), 10000.0, m)  # far below, out of view
    b.set_camera((0, 0, 0), (0, 1, 0), (0, 0, -1), 60, 1.0, 0.0, 1.0)
    scene = b.build()
    cfg = rt.RenderConfig(nx=16, ny=16, spp=8, max_depth=3)
    img = _render_mean(scene, cfg)
    # looking straight up: t = 0.5*(1+1) = 1 -> (0.5, 0.7, 1.0)
    center = img[8, 8]
    np.testing.assert_allclose(center, [0.5, 0.7, 1.0], atol=0.08)


def test_black_sky_when_lights_exist():
    b = SceneBuilder()
    lt = b.constant_texture((5.0, 5.0, 5.0))
    b.rect(-1, 1, -1, 1, -50.0, False, S.AXIS_Z, b.diffuse_light(lt))
    b.add_light((-1, -1, -50.0), (2, 0, 0), (0, 2, 0), (5.0, 5.0, 5.0), tex=lt)
    b.set_camera((0, 0, 0), (0, 1, 0), (0, 0, -1), 60, 1.0, 0.0, 1.0)
    scene = b.build()
    assert float(scene.sky_light) == 0.0
    cfg = rt.RenderConfig(nx=8, ny=8, spp=4, max_depth=3)
    img = _render_mean(scene, cfg)
    np.testing.assert_allclose(img, 0.0, atol=1e-6)  # nothing to see


def test_emission_one_sided():
    """Diffuse light emits only when hit from the front
    (diffuseLight.cu:48-63: dot(normal, ray_dir) < 0)."""
    b = SceneBuilder()
    lt = b.constant_texture((5.0, 5.0, 5.0))
    mat = b.diffuse_light(lt)
    b.rect(-10, 10, -10, 10, -3.0, False, S.AXIS_Z, mat)  # normal +z
    b.add_light((-10, -10, -3.0), (20, 0, 0), (0, 20, 0), (5.0, 5.0, 5.0),
                tex=lt)
    b.set_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 60, 1.0, 0.0, 1.0)
    front = b.build()
    cfg = rt.RenderConfig(nx=8, ny=8, spp=4, max_depth=3)
    img_front = _render_mean(front, cfg)
    np.testing.assert_allclose(img_front, 5.0, atol=1e-4)

    b2 = SceneBuilder()
    lt2 = b2.constant_texture((5.0, 5.0, 5.0))
    mat2 = b2.diffuse_light(lt2)
    b2.rect(-10, 10, -10, 10, -3.0, True, S.AXIS_Z, mat2)  # flipped: -z
    b2.add_light((-10, -10, -3.0), (20, 0, 0), (0, 20, 0), (5.0, 5.0, 5.0),
                 tex=lt2)
    b2.set_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 60, 1.0, 0.0, 1.0)
    back = b2.build()
    img_back = _render_mean(back, cfg)
    np.testing.assert_allclose(img_back, 0.0, atol=1e-6)


def test_metal_mirror_reflection():
    """fuzz=0 metal floor reflects the sky: looking down at a mirror at
    grazing-free normal incidence shows the up-sky color * albedo."""
    b = SceneBuilder()
    mirror = b.metal(b.constant_texture((1.0, 1.0, 1.0)), 0.0)
    b.rect(-100, 100, -100, 100, -2.0, False, S.AXIS_Y, mirror)  # floor below
    b.set_camera((0, 0, 0), (0, -1, 0), (1, 0, 0), 60, 1.0, 0.0, 1.0)
    scene = b.build()
    cfg = rt.RenderConfig(nx=8, ny=8, spp=16, max_depth=4)
    img = _render_mean(scene, cfg)
    # straight down -> reflect straight up -> sky (0.5, 0.7, 1.0)
    np.testing.assert_allclose(img[4, 4], [0.5, 0.7, 1.0], atol=0.05)


def test_rr_energy_unbiased():
    """Russian roulette must not change the expected value: render the same
    diffuse-bounce scene with RR starting early vs late; means must agree
    within MC error."""
    b = SceneBuilder()
    grey = b.lambertian(b.constant_texture((0.6, 0.6, 0.6)))
    b.sphere((0.0, 0.0, -3.0), 1.0, grey)
    b.set_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 30, 1.0, 0.0, 1.0)
    scene = b.build()
    early = rt.RenderConfig(nx=16, ny=16, spp=600, max_depth=24,
                            rr_start_depth=2, seed=3)
    late = rt.RenderConfig(nx=16, ny=16, spp=600, max_depth=24,
                           rr_start_depth=20, seed=4)
    img_e = _render_mean(scene, early).mean()
    img_l = _render_mean(scene, late).mean()
    assert abs(img_e - img_l) / img_l < 0.02


def test_nan_free_all_scenes():
    for sid in (0, 1, 2, 3, 4, 5):
        cfg = rt.RenderConfig(nx=20, ny=12, spp=2, max_depth=5, scene_id=sid)
        scene = rt.build_scene(sid, cfg.nx, cfg.ny)
        img = np.asarray(rt.render(scene, cfg))
        assert np.isfinite(img).all(), f"scene {sid} produced non-finite"


def test_bounce_stats_metrics():
    """cfg.bounce_stats populates per-bounce ray counts and occupancy in the
    metrics dict without changing the image (SURVEY §5 wavefront metrics).
    occupancy_trace adds the per-iteration curve (round-5 split: the curve
    is the expensive part and is opt-in)."""
    cfg = rt.RenderConfig(nx=40, ny=24, spp=4, max_depth=8, scene_id=5,
                          bounce_stats=True, occupancy_trace=True)
    scene = rt.build_scene(5, cfg.nx, cfg.ny)
    m = {}
    img = np.asarray(rt.render(scene, cfg, metrics=m))

    cfg_off = rt.RenderConfig(nx=40, ny=24, spp=4, max_depth=8, scene_id=5)
    img_off = np.asarray(rt.render(scene, cfg_off))
    np.testing.assert_array_equal(img, img_off)

    rbd = m["rays_by_depth"]
    assert len(rbd) == cfg.max_depth
    # every path has a depth-0 ray: spp * pixels of them
    assert rbd[0] == cfg.spp * cfg.num_pixels
    # deeper bounces are rarer (RR + termination)
    assert rbd[-1] <= rbd[2]
    # bounce rays (sans NEE shadow rays) must total the depth histogram
    assert sum(rbd) <= m["rays"]
    assert 0.0 < m["mean_occupancy"] <= 1.0
    assert m["wavefront_iterations"] >= cfg.max_depth
    occ = m["occupancy_by_iter"]
    assert occ and occ[0] == 1.0 and occ[-1] <= occ[0]

    # counters-only mode (production default): same counters, no curve
    cfg_c = rt.RenderConfig(nx=40, ny=24, spp=4, max_depth=8, scene_id=5,
                            bounce_stats=True)
    mc = {}
    img_c = np.asarray(rt.render(scene, cfg_c, metrics=mc))
    np.testing.assert_array_equal(img_c, img_off)
    assert mc["rays_by_depth"] == m["rays_by_depth"]
    assert mc["mean_occupancy"] == m["mean_occupancy"]
    assert mc["occupancy_by_iter"] == []


def test_mis_unbiased_vs_bsdf_only():
    """NEE + power-heuristic MIS must estimate the same image as brute-force
    BSDF-only path tracing (SURVEY §4 tier 2: MIS estimator unbiasedness on
    the Cornell light).  BSDF-only is obtained by deregistering the light
    from NEE (num_lights=0; emission still collected on BSDF hits, and
    sky_light stays off because it is a scene leaf, not derived)."""
    import dataclasses

    scene = rt.build_scene(0, 24, 24)
    assert float(scene.sky_light) == 0.0
    mis_cfg = rt.RenderConfig(nx=24, ny=24, spp=400, max_depth=12, seed=7)
    mis = _render_mean(scene, mis_cfg).mean()

    bsdf_scene = dataclasses.replace(scene, num_lights=0)
    bsdf_cfg = rt.RenderConfig(nx=24, ny=24, spp=6000, max_depth=12, seed=8)
    bsdf = _render_mean(bsdf_scene, bsdf_cfg).mean()
    assert abs(mis - bsdf) / bsdf < 0.04, (mis, bsdf)


def test_book_mixture_unbiased():
    """cfg.estimator='book' — the books' literal 0.5/0.5 cosine/light
    mixture (SURVEY §7.4 quirk 3; the reference's mixturePdf.cu:10-37
    comments the cosine branch out, making it light-only in practice) —
    must estimate the same image as the default NEE+MIS estimator.

    Scene: lit floor viewed straight-down (pure one-bounce-indirect), the
    regime where the mixture's variance is tame enough that moderate spp
    separate bias from noise: measured offline, book at 3x2000 spp spans
    0.6265-0.6279 around mis 0.6283 (-0.2%).  On Cornell the mixture's
    light-branch throughput w = cos_pdf/mix_pdf ~ 0.03 makes Russian
    roulette scale survivors ~50x — firefly variance that needs ~100k spp
    to bound 1%, which is why the equivalence test does NOT use Cornell
    (a 1600-spp Cornell run read -5.5% purely from the tail)."""
    b = SceneBuilder()
    grey = b.lambertian(b.constant_texture((0.7, 0.7, 0.7)))
    b.rect(-8, 8, -8, 8, 0.0, False, S.AXIS_Y, grey)
    em = b.diffuse_light(b.constant_texture((1.0, 1.0, 1.0)))
    b.rect(-4.0, 4.0, -4.0, 4.0, 1.5, True, S.AXIS_Y, em)
    b.add_light(position=(-4.0, 1.5, -4.0), vec_u=(8.0, 0.0, 0.0),
                vec_v=(0.0, 0.0, 8.0), emission=(1.0, 1.0, 1.0))
    b.set_camera((0, 0.5, 0), (0, 0.0, 0), (1, 0, 0), 60, 1.0, 0.0, 0.5)
    scene = b.build()

    mis_cfg = rt.RenderConfig(nx=24, ny=24, spp=400, max_depth=6, seed=1)
    mis = _render_mean(scene, mis_cfg).mean()
    book_cfg = rt.RenderConfig(nx=24, ny=24, spp=2000, max_depth=6,
                               seed=2, estimator="book")
    book = _render_mean(scene, book_cfg).mean()
    assert abs(book - mis) / mis < 0.02, (book, mis)



def test_mis_unbiased_two_lights():
    """MIS with L>1 lights must match brute-force BSDF-only path tracing.

    The scene is built so two historical L>1 bugs each produce a LARGE bias:
    a tiny decoy light occupies row 0 and a huge close ceiling light (whose
    BSDF-side weight should be ~1) dominates an indirect-only view.
    - row-0 hardcoded BSDF-side pdf (pre-fix _light_pdf_at): weights the big
      light's hits with the decoy's area -> w_bsdf ~ 0 -> measured -71% bias.
    - NEE weight with the raw per-light pdf while the BSDF side divides by L
      (selection-inclusive): weights no longer sum to 1 -> measured +12%.
    Fixed code agrees with BSDF-only to ~0.01% at these sample counts."""
    import dataclasses

    def build():
        b = SceneBuilder()
        grey = b.lambertian(b.constant_texture((0.7, 0.7, 0.7)))
        b.rect(-8, 8, -8, 8, 0.0, False, S.AXIS_Y, grey)      # floor
        # row 0: tiny decoy light far away
        em_t = b.diffuse_light(b.constant_texture((1.0, 1.0, 1.0)))
        b.rect(7.0, 7.1, 7.0, 7.1, 4.0, True, S.AXIS_Y, em_t)
        b.add_light(position=(7.0, 4.0, 7.0), vec_u=(0.1, 0.0, 0.0),
                    vec_v=(0.0, 0.0, 0.1), emission=(1.0, 1.0, 1.0))
        # row 1: giant ceiling light right above the viewed floor patch
        em_b = b.diffuse_light(b.constant_texture((1.0, 1.0, 1.0)))
        b.rect(-4.0, 4.0, -4.0, 4.0, 1.5, True, S.AXIS_Y, em_b)
        b.add_light(position=(-4.0, 1.5, -4.0), vec_u=(8.0, 0.0, 0.0),
                    vec_v=(0.0, 0.0, 8.0), emission=(1.0, 1.0, 1.0))
        # camera just above the floor looking straight down (never sees
        # a light directly — the image is pure one-bounce-indirect)
        b.set_camera((0, 0.5, 0), (0, 0.0, 0), (1, 0, 0), 60, 1.0, 0.0, 0.5)
        return b.build()

    scene = build()
    assert scene.num_lights == 2
    mis_cfg = rt.RenderConfig(nx=24, ny=24, spp=400, max_depth=6, seed=11)
    mis = _render_mean(scene, mis_cfg).mean()

    bsdf_scene = dataclasses.replace(scene, num_lights=0)
    bsdf_cfg = rt.RenderConfig(nx=24, ny=24, spp=3000, max_depth=6, seed=12)
    bsdf = _render_mean(bsdf_scene, bsdf_cfg).mean()
    assert abs(mis - bsdf) / bsdf < 0.03, (mis, bsdf)


def test_light_row_index_exact():
    """Build-time prim->light-row matching (builder._match_lights_to_prims):
    exact rows for multi-light scenes including the Cornell normal-offset
    quirk (light rect at k=554.9, LightDefinition at y=554 — SURVEY §7.4
    quirk 15), and -1 for unregistered emissive geometry."""
    scene = rt.build_scene(0, 16, 16)
    rows = np.asarray(scene.prims.light_row_p)
    types = np.asarray(scene.prims.mat_type_p)
    emissive = (types == S.MAT_DIFFUSE_LIGHT) & (np.asarray(
        scene.prims.prim_type) == S.PRIM_RECT)
    # despite the 0.9 offset along the normal, the light prim maps to row 0
    assert (rows[emissive] == 0).all() and emissive.sum() == 1
    assert (rows[~emissive] == -1).all()


def test_mis_unbiased_unregistered_emissive_single_light():
    """One REGISTERED light plus an emissive rect never passed to
    add_light: NEE can't sample the unregistered emitter, so BSDF hits on
    it must carry FULL weight (pdf 0 on the NEE side).  The former L==1
    closed form attributed every emissive hit to light row 0 and
    down-weighted the unregistered emitter — biased-dark.  Exactness check
    vs brute-force BSDF-only tracing."""
    import dataclasses

    def build():
        b = SceneBuilder()
        grey = b.lambertian(b.constant_texture((0.7, 0.7, 0.7)))
        b.rect(-8, 8, -8, 8, 0.0, False, S.AXIS_Y, grey)      # floor
        # registered light: small, off to the side
        em_r = b.diffuse_light(b.constant_texture((1.0, 1.0, 1.0)))
        b.rect(5.0, 6.0, 5.0, 6.0, 3.0, True, S.AXIS_Y, em_r)
        b.add_light(position=(5.0, 3.0, 5.0), vec_u=(1.0, 0.0, 0.0),
                    vec_v=(0.0, 0.0, 1.0), emission=(1.0, 1.0, 1.0))
        # UNREGISTERED emitter: big ceiling panel right above the view
        em_u = b.diffuse_light(b.constant_texture((1.0, 1.0, 1.0)))
        b.rect(-4.0, 4.0, -4.0, 4.0, 1.5, True, S.AXIS_Y, em_u)
        b.set_camera((0, 0.5, 0), (0, 0.0, 0), (1, 0, 0), 60, 1.0, 0.0, 0.5)
        return b.build()

    scene = build()
    assert scene.num_lights == 1 and scene.emissives_unregistered
    mis_cfg = rt.RenderConfig(nx=24, ny=24, spp=400, max_depth=6, seed=31)
    mis = _render_mean(scene, mis_cfg).mean()

    bsdf_scene = dataclasses.replace(scene, num_lights=0)
    bsdf_cfg = rt.RenderConfig(nx=24, ny=24, spp=3000, max_depth=6, seed=32)
    bsdf = _render_mean(bsdf_scene, bsdf_cfg).mean()
    assert abs(mis - bsdf) / bsdf < 0.03, (mis, bsdf)


def test_light_row_containment_tiling():
    """A light realized by TWO rect prims tiling it: both map to the row
    (containment matching), so BSDF-side MIS stays exact."""
    b = SceneBuilder()
    grey = b.lambertian(b.constant_texture((0.7, 0.7, 0.7)))
    b.rect(-8, 8, -8, 8, 0.0, False, S.AXIS_Y, grey)
    em = b.diffuse_light(b.constant_texture((1.0, 1.0, 1.0)))
    b.rect(-4.0, 0.0, -4.0, 4.0, 1.5, True, S.AXIS_Y, em)   # left half
    b.rect(0.0, 4.0, -4.0, 4.0, 1.5, True, S.AXIS_Y, em)    # right half
    b.add_light(position=(-4.0, 1.5, -4.0), vec_u=(8.0, 0.0, 0.0),
                vec_v=(0.0, 0.0, 8.0), emission=(1.0, 1.0, 1.0))
    b.set_camera((0, 0.5, 0), (0, 0.0, 0), (1, 0, 0), 60, 1.0, 0.0, 0.5)
    scene = b.build()
    rows = np.asarray(scene.prims.light_row_p)
    types = np.asarray(scene.prims.mat_type_p)
    emissive = types == S.MAT_DIFFUSE_LIGHT
    assert (rows[emissive] == 0).all() and emissive.sum() == 2
    assert not scene.emissives_unregistered


def test_mis_unbiased_coplanar_adjacent_lights():
    """Two coplanar lights sharing an edge — the arrangement the former
    geometric membership test (plane + parallelogram-coords tolerances) could
    mis-attribute near the shared edge.  The build-time prim->row index is
    exact, so MIS must still agree with brute-force BSDF-only tracing."""
    import dataclasses

    def build():
        b = SceneBuilder()
        grey = b.lambertian(b.constant_texture((0.7, 0.7, 0.7)))
        b.rect(-8, 8, -8, 8, 0.0, False, S.AXIS_Y, grey)      # floor
        # two equal-size lights tiling [-4, 4] x [-4, 4] at y=1.5, sharing
        # the x=0 edge; identical emission so any mis-attribution shows as
        # a pdf (not radiance) error
        for x0, x1, li in [(-4.0, 0.0, 0), (0.0, 4.0, 1)]:
            em = b.diffuse_light(b.constant_texture((1.0, 1.0, 1.0)))
            b.rect(x0, x1, -4.0, 4.0, 1.5, True, S.AXIS_Y, em)
            b.add_light(position=(x0, 1.5, -4.0), vec_u=(x1 - x0, 0.0, 0.0),
                        vec_v=(0.0, 0.0, 8.0), emission=(1.0, 1.0, 1.0))
        b.set_camera((0, 0.5, 0), (0, 0.0, 0), (1, 0, 0), 60, 1.0, 0.0, 0.5)
        return b.build()

    scene = build()
    assert scene.num_lights == 2
    rows = np.asarray(scene.prims.light_row_p)
    assert sorted(rows[rows >= 0]) == [0, 1]
    mis_cfg = rt.RenderConfig(nx=24, ny=24, spp=400, max_depth=6, seed=21)
    mis = _render_mean(scene, mis_cfg).mean()

    bsdf_scene = dataclasses.replace(scene, num_lights=0)
    bsdf_cfg = rt.RenderConfig(nx=24, ny=24, spp=3000, max_depth=6, seed=22)
    bsdf = _render_mean(bsdf_scene, bsdf_cfg).mean()
    assert abs(mis - bsdf) / bsdf < 0.03, (mis, bsdf)


@pytest.mark.parametrize("nx,ny", [(64, 64), (96, 32), (100, 56), (80, 48),
                                   (50, 40), (1200, 600), (33, 35)])
def test_decode_tile_pixel_matches_permutation(nx, ny):
    """decode_tile_pixel is the exact closed form of render.tile_permutation
    (incl. partial edge tiles) — the analytic claim-pixel decode the
    work-queue flush uses under cfg.pixel_layout='tile32'."""
    from rtw.render import tile_permutation
    from rtw.integrator import decode_tile_pixel

    perm = tile_permutation(nx, ny)
    pos = jnp.arange(nx * ny, dtype=jnp.int32)
    got = np.asarray(decode_tile_pixel(pos, nx, ny))
    np.testing.assert_array_equal(got, perm)


def test_queue_tile32_layout_bitwise_matches_generic():
    """The analytic pixel decode changes no estimator bit: same items, same
    claim order, identical accumulators."""
    import dataclasses
    from rtw.render import tile_permutation
    from rtw.integrator import trace_wavefront_queue

    nx, ny = 64, 48
    scene = rt.build_scene(5, nx, ny)
    cfg = rt.RenderConfig(nx=nx, ny=ny, spp=3, max_depth=5,
                          scheduler="queue", seed=4)
    pix = jnp.asarray(tile_permutation(nx, ny))
    key = R.base_key(cfg.seed)
    a, ra, _ = jax.jit(lambda: trace_wavefront_queue(
        scene, cfg, pix, key, 0, cfg.spp))()
    cfg32 = dataclasses.replace(cfg, pixel_layout="tile32")
    b, rb, _ = jax.jit(lambda: trace_wavefront_queue(
        scene, cfg32, pix, key, 0, cfg.spp))()
    np.testing.assert_array_equal(np.stack([np.asarray(c) for c in a]),
                                  np.stack([np.asarray(c) for c in b]))
    assert float(ra) == float(rb)


def test_light_matcher_overlap_semantics():
    """_quad_square_overlap is a true convex-polygon test: containment and
    straddling overlap; disjoint, edge-adjacent, and rotated-diagonal
    (bbox-overlapping but polygon-disjoint) do not."""
    from rtw.models.builder import _quad_square_overlap

    sq = lambda a0, a1, b0, b1: (np.array([a0, a1, a0, a1], float),
                                 np.array([b0, b0, b1, b1], float))
    assert _quad_square_overlap(*sq(0.2, 0.8, 0.2, 0.8))      # contained
    assert _quad_square_overlap(*sq(0.5, 1.5, 0.5, 1.5))      # straddles
    assert not _quad_square_overlap(*sq(2.0, 3.0, 0.0, 1.0))  # disjoint
    assert not _quad_square_overlap(*sq(1.0, 2.0, 0.0, 1.0))  # edge-adjacent
    # diamond centered (1.4, 1.4): corner bbox reaches into the unit square
    # but the rotated polygon itself is disjoint — must NOT overlap
    a = np.array([0.9, 1.4, 1.4, 1.9])
    b = np.array([1.4, 0.9, 1.9, 1.4])
    assert not _quad_square_overlap(a, b)


def test_builder_light_diagnostics():
    """Partial-overlap emissive prims error at build; zero-match lights
    warn (ADVICE r3 items 1-2)."""
    import warnings

    def base(light_rect):
        b = SceneBuilder()
        white = b.lambertian(b.constant_texture((0.7, 0.7, 0.7)))
        b.rect(0, 10, 0, 10, 0.0, False, S.AXIS_Y, white)
        em = b.diffuse_light(b.constant_texture((4.0, 4.0, 4.0)))
        b.rect(*light_rect, 5.0, True, S.AXIS_Y, em)
        b.add_light(position=(0.0, 5.0, 0.0), vec_u=(2.0, 0.0, 0.0),
                    vec_v=(0.0, 0.0, 2.0), emission=(4.0, 4.0, 4.0))
        b.set_camera((5, 1, 5), (5, 0, 5), (1, 0, 0), 60, 1.0, 0.0, 1.0)
        return b

    # prim [1, 3]x[0, 2] half-in half-out of the light [0, 2]x[0, 2]
    with pytest.raises(ValueError, match="partially overlaps"):
        base((1.0, 3.0, 0.0, 2.0)).build()

    # prim fully elsewhere: the registered light matches nothing -> warn
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        base((6.0, 8.0, 6.0, 8.0)).build()
    assert any("matched no emissive primitive" in str(x.message) for x in w)


def test_furnace_cavity_exact():
    """CLOSED-FORM furnace (VERDICT r4 weak-item 7: the sky-based furnace
    bracket [0.55, 1.05] is too loose to catch a few-percent energy leak).
    Inside a cavity whose walls all emit radiance L, the incident radiance
    is L from every direction, so an albedo-1 lambertian sphere must
    reflect EXACTLY L (out = albedo * integral L cos/pi = L), and wall
    pixels terminate at exactly L on first hit.  Any estimator gain/loss
    (broken cosine pdf, RR weighting, NEE weight, MIS double-count) shifts
    the mean off L — tolerance here is MC noise only (~1-2% at 256 spp)."""
    L = 0.7
    b = SceneBuilder()
    lt = b.constant_texture((L, L, L))
    lm = b.diffuse_light(lt)
    white = b.lambertian(b.constant_texture((1.0, 1.0, 1.0)))
    b.sphere((0.0, 0.0, 0.0), 1.0, white)
    h = 5.0
    # 6 faces, flip chosen so every normal (and emission side) faces INWARD
    b.rect(-h, h, -h, h, -h, False, S.AXIS_Z, lm)   # back:   normal +z
    b.rect(-h, h, -h, h, h, True, S.AXIS_Z, lm)     # front:  normal -z
    b.rect(-h, h, -h, h, -h, False, S.AXIS_Y, lm)   # floor:  normal +y
    b.rect(-h, h, -h, h, h, True, S.AXIS_Y, lm)     # ceil:   normal -y
    b.rect(-h, h, -h, h, -h, False, S.AXIS_X, lm)   # left:   normal +x
    b.rect(-h, h, -h, h, h, True, S.AXIS_X, lm)     # right:  normal -x
    for axis, k, u, v in [
        (2, -h, (2 * h, 0, 0), (0, 2 * h, 0)),
        (2, h, (2 * h, 0, 0), (0, 2 * h, 0)),
        (1, -h, (2 * h, 0, 0), (0, 0, 2 * h)),
        (1, h, (2 * h, 0, 0), (0, 0, 2 * h)),
        (0, -h, (0, 2 * h, 0), (0, 0, 2 * h)),
        (0, h, (0, 2 * h, 0), (0, 0, 2 * h)),
    ]:
        pos = [-h, -h, -h]
        pos[axis] = k
        b.add_light(tuple(pos), u, v, (L, L, L), tex=lt)
    b.set_camera((0, 0, 4.0), (0, 0, 0), (0, 1, 0), 40, 1.0, 0.0, 1.0)
    scene = b.build()

    cfg = rt.RenderConfig(nx=24, ny=24, spp=256, max_depth=24, seed=3)
    img = np.asarray(rt.render(scene, cfg))
    # center pixels: the albedo-1 sphere; corners: emitting walls
    sphere_px = img[9:15, 9:15]
    wall_px = np.concatenate([img[:2].reshape(-1, 3),
                              img[-2:].reshape(-1, 3)])
    assert abs(sphere_px.mean() - L) < 0.02 * L
    assert np.all(np.abs(sphere_px - L) < 0.12 * L)
    # wall hits terminate at exactly L (no estimator involved)
    np.testing.assert_allclose(wall_px, L, atol=1e-5)
