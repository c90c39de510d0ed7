"""Wavefront path-tracing integrator.

Data-parallel re-architecture of the reference's per-pixel megakernel
(raygen/raygen.cu:28-159 + shaders/closehit.cu + material/*.cu): instead of
per-thread recursion with function-table callables and SER reordering, a
whole wavefront of paths advances in lockstep through a bounce loop.  Every
material's scatter is evaluated branch-free for every lane and per-lane
`mat_type` selects — with 6 material models this costs less than the memory
traffic a gather/scatter compaction would add, and it keeps the whole bounce
a single fused XLA computation.

All per-ray state is SoA component planes ([N] arrays / Vec3 of them,
ops/vec.py): every elementwise op streams one dense plane per component
instead of the strided [N, 3] rows the batched PerRayData AoS of the
reference (lib/raydata.cuh:59-78) would give.

Estimator (lambertian path):  cosine-hemisphere BSDF sampling + next-event
estimation on the scene's parallelogram lights with power-heuristic MIS
(closehit.cu:70-118, rectPdf.cu:124-193, raydata.cuh:167-171).  With
`cfg.mis_bsdf_weight=True` (default) BSDF-sampled rays that hit a light are
also MIS-weighted — the unbiased completion of the reference's one-sided
scheme (which adds full emission on BSDF light hits, diffuseLight.cu:48-69;
set False for reference-parity).  The reference's "mixture" PDF is light-only
in practice (mixturePdf.cu:33-37 comments out the cosine branch); NEE+MIS is
the equivalent structure done properly.

Russian roulette from depth >= 2 with p = max(throughput) (raygen.cu:74-82).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from rtw.models import scene as S
from rtw.ops import sampling as sm
from rtw.ops import vec as V
from rtw.ops.vec import Vec3
from rtw.ops.bounce import BounceEnv, bounce_core
from rtw.ops.intersect import (BIG, intersect_scene, occluded,
                                   reeval_hit, winner_hit)
from rtw.ops.shading import gather_shade, resolve_albedo
from rtw.utils import rng as R


# 'auto' traces with the Pallas-Triton kernels on a GPU from this many
# surface (non-volume) primitives up.  Measured on an H100 (PERF.md): the
# kernel with the queue scheduler beat the XLA sweep with regen on the
# 8-surface-prim Cornell box (1.5x) and on the 520-1410-prim scenes
# (5-10x); the XLA sweep won on the 4-prim three-sphere scene and on the
# Cornell-volumes scene (6 surface prims + 2 volumes, which the kernel
# tests for every ray with no cull).
KERNEL_MIN_PRIMS = 8


def _pallas_backend(cfg, scene) -> bool:
    """Static choice of trace backend.  'auto' uses the Pallas-Triton
    kernels (ops/trace_kernel.py) on a GPU for scenes of at least
    KERNEL_MIN_PRIMS surface primitives; the pure-JAX sweep is the reference
    implementation everywhere else.  A forced 'pallas' off the GPU raises,
    unless the tests' interpreter is on (trace_kernel.interpret_mode).

    Differentiable renders ride the SAME kernels: the kernel runs the
    forward trace under stop_gradient (winner identity is a detached
    decision either way) and ops/intersect.reeval_hit recomputes the
    winner's payload differentiably — see bounce_step."""
    if cfg.backend == "pallas":
        from rtw.ops import trace_kernel as TK

        if not TK.kernel_available():
            raise ValueError(
                f"backend='pallas' needs a GPU (backend is "
                f"{jax.default_backend()!r}); use 'jnp' or 'auto'")
        return True
    if cfg.backend == "jnp":
        return False
    n_surface = sum(e[1] for e in scene.chunk_plan) - scene.n_vol
    return n_surface >= KERNEL_MIN_PRIMS and jax.default_backend() == "gpu"


def check_backend(cfg, scene) -> None:
    """Validate cfg.backend eagerly, outside any jit cache (raises like
    _pallas_backend)."""
    _pallas_backend(cfg, scene)


class PathState(NamedTuple):
    """SoA wavefront state — the batched PerRayData (lib/raydata.cuh:59-78)."""

    origin: Vec3       # [N] planes
    direction: Vec3    # [N] planes (unnormalized camera rays, like the ref)
    throughput: Vec3   # [N] planes
    radiance: Vec3     # [N] planes
    alive: Any         # [N] bool
    time: Any          # [N] shutter gather time
    prev_pdf: Any      # [N] bsdf pdf of previous diffuse bounce (MIS carry)
    prev_diffuse: Any  # [N] bool: previous bounce eligible for MIS light-hit
    ray_count: Any     # scalar f32: rays traced (bounce + NEE shadow rays)


def generate_camera_rays(scene: S.Scene, cfg, pixel_idx, path_keys) -> PathState:
    """Thin-lens primary rays (shaders/camera.cu:11-19 + raygen.cu:129-139).

    Unlike the reference, the lens radius is actually honored (SURVEY §7.4
    quirk 2: the reference never uploads cameraLensRadius, silently disabling
    depth of field)."""
    cam = scene.camera
    u = R.camera_uniforms(path_keys, cfg.rng)          # [5, N]
    x = (pixel_idx % cfg.nx).astype(jnp.float32)
    y = (pixel_idx // cfg.nx).astype(jnp.float32)
    s = (x + u[0]) / np.float32(cfg.nx)
    t = (y + u[1]) / np.float32(cfg.ny)

    cam_o = V.v3(cam.origin)
    cam_u = V.v3(cam.u)
    cam_v = V.v3(cam.v)
    lower_left = V.v3(cam.lower_left)
    horizontal = V.v3(cam.horizontal)
    vertical = V.v3(cam.vertical)

    rdx, rdy = sm.unit_disk(u[2], u[3])
    rdx = cam.lens_radius * rdx
    rdy = cam.lens_radius * rdy
    origin = cam_o + cam_u * rdx + cam_v * rdy
    direction = lower_left + horizontal * s + vertical * t - origin
    time = cam.time0 + u[4] * (cam.time1 - cam.time0)

    n = pixel_idx.shape[0]
    return PathState(
        origin=origin,
        direction=direction,
        throughput=V.ones(n),
        radiance=V.zeros(n),
        alive=jnp.ones((n,), bool),
        time=time,
        prev_pdf=jnp.ones((n,), jnp.float32),
        prev_diffuse=jnp.zeros((n,), bool),
        ray_count=jnp.zeros((), jnp.float32),
    )


def _light_pdf_at(scene: S.Scene, origin: Vec3, point: Vec3, dir_unit: Vec3,
                  prim_idx, mask):
    """Solid-angle pdf of NEE having sampled the direction that hit a light at
    `point` (uniform light selection x uniform area), used for MIS weighting
    of BSDF-sampled light hits.  `mask`: lanes whose value is consumed —
    others get neutral inputs so reverse-mode can't overflow (double-where
    pattern).

    The hit light's row comes from the build-time prim -> light-row index
    (Primitives.light_row_p) keyed by the winning `prim_idx` — exact for any
    light arrangement (coplanar, adjacent, grazing), unlike a geometric
    containment test.  Emissive geometry that is NOT registered as a light
    resolves to row -1 -> pdf 0 — correct, since NEE can never sample it, so
    the BSDF sample carries full weight (power_heuristic(p, 0) = 1).

    ONE-SIDED, matching NEE's validity gate exactly: NEE
    refuses samples where the light faces away from the shading point
    (bounce_core's costa > 1e-6), so a BSDF ray hitting a light's BACK
    side must see pdf 0 here (-> full BSDF weight), not the abs() pdf —
    the abs() form discounted back-side hits as if NEE covered them,
    losing energy.  Invisible to the reference scenes (their registered
    light normals all face the scene; the back sides are unreachable) but
    a ~10% deficit in a closed light cavity — caught by the
    furnace test (test_furnace_cavity_exact backface variant)."""
    lights = scene.lights
    L = max(scene.num_lights, 1)
    d = point - origin
    dist2 = jnp.where(mask, d.dot(d), 1.0)

    if L == 1 and not scene.emissives_unregistered:
        # every emissive prim IS light row 0: closed form, no row gather
        ln = V.v3(lights.normal[0])
        area = lights.area[0]
        cos_t = -dir_unit.dot(ln)            # signed: NEE samples only the
        sel = mask & (cos_t > 1e-6)          # side the normal faces
        pdf = dist2 / (area * jnp.where(sel, cos_t, 1.0)) / np.float32(L)
        return jnp.where(sel, pdf, 0.0)

    row = scene.prims.light_row_p[jnp.maximum(prim_idx, 0)]
    row = jnp.where(mask & (prim_idx >= 0), row, -1)
    r = jnp.maximum(row, 0)
    area = lights.area[r]
    ln = V.gather_rows(lights.normal, r)
    cos_t = -dir_unit.dot(ln)                # signed (see docstring)
    sel = (row >= 0) & (cos_t > 1e-6)
    pdf = dist2 / (jnp.where(sel, area * cos_t, 1.0) * np.float32(L))
    return jnp.where(sel, pdf, 0.0)


def _light_pdf_dir(scene: S.Scene, origin: Vec3, dir_unit: Vec3, mask):
    """(1/L) * sum over lights of the solid-angle pdf of direction
    `dir_unit` from `origin` hitting that light — the books'
    hittable_pdf::value (a geometric parallelogram intersection, NO scene
    occlusion), needed by the book-mixture estimator's mixture pdf.
    Lights are a static, small table, so this is L unrolled scalar-
    broadcast plane tests (no gathers)."""
    lights = scene.lights
    L = scene.num_lights
    total = jnp.zeros_like(origin.x)
    for li in range(L):
        q = V.v3(lights.position[li])
        eu = V.v3(lights.vec_u[li])
        ev = V.v3(lights.vec_v[li])
        ln = V.v3(lights.normal[li])
        area = lights.area[li]
        denom = dir_unit.dot(ln)
        ok = jnp.abs(denom) > 1e-8
        denom_s = jnp.where(ok, denom, 1.0)
        t = (q - origin).dot(ln) / denom_s
        ok = ok & (t > 1e-4)
        p = origin + dir_unit * t
        w = p - q
        uu = eu.dot(eu)
        vv = ev.dot(ev)
        uv = eu.dot(ev)
        det = uu * vv - uv * uv
        wu = w.dot(eu)
        wv = w.dot(ev)
        a = (wu * vv - wv * uv) / det
        b = (wv * uu - wu * uv) / det
        ok = ok & (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
        pdf_l = jnp.where(ok & mask,
                          t * t / (area * jnp.maximum(jnp.abs(denom), 1e-8)),
                          0.0)
        total = total + pdf_l
    return total / np.float32(max(L, 1))


def bounce_step(scene: S.Scene, cfg, path_keys, state: PathState, bounce):
    """One wavefront bounce: trace, shade, NEE, RR.  Returns new state."""
    nv = max(scene.n_vol, 1)
    # stochastic texture filtering draws its row-selection uniform from a
    # DEDICATED trailing slot: fast/tea slot streams are independent by
    # index, so appending it leaves every estimator draw untouched, and
    # independence from those draws is what keeps E[albedo * estimator]
    # unbiased (ops/textures._image_stoch_565)
    tex_slot = (cfg.tex_filter == "stoch565"
                and bool(scene.tex_present[S.TEX_IMAGE]))
    n_slots = R.NUM_FIXED_SLOTS + 2 * nv + (1 if tex_slot else 0)
    U = R.bounce_uniforms(path_keys, bounce + 1, n_slots, cfg.rng)  # [n_slots, N]
    vol_u = U[R.NUM_FIXED_SLOTS: R.NUM_FIXED_SLOTS + nv]
    occ_u = U[R.NUM_FIXED_SLOTS + nv: R.NUM_FIXED_SLOTS + 2 * nv]
    tex_u = U[R.NUM_FIXED_SLOTS + 2 * nv] if tex_slot else None

    o, d = state.origin, state.direction
    # Dead lanes get tmax = -BIG: no primitive block can activate for them
    # (the kernels' slab test needs near < tmax, and near >= -BIG always —
    # a merely-negative sentinel would still activate lanes whose origin
    # sits inside a block AABB), so ray blocks whose lanes are ALL dead (the
    # compacted drain tail, see trace_wavefront) skip every block at
    # slab-test cost only.  Their forced miss is invisible — every consumer
    # below is masked by state.alive.
    tmax_lane = jnp.where(state.alive, np.float32(cfg.t_max),
                          np.float32(-BIG))
    use_pallas = _pallas_backend(cfg, scene)
    if use_pallas:
        # The kernel picks the winner — a detached, piecewise-constant
        # decision: every input is stop_gradient, so the pallas_call is
        # never differentiated.  Differentiable renders then recompute ONLY
        # the winner's t/payload in JAX (reeval_hit); gather_shade routes
        # texture-color gradients.  Same estimator and VJP structure as the
        # pure-JAX sweep.
        from rtw.ops.trace_kernel import nearest_pallas

        sg = lax.stop_gradient
        best_t, best_prim = nearest_pallas(
            sg(scene), sg(o), sg(d), cfg.t_min, sg(tmax_lane),
            sg(state.time), sg(vol_u))
        if cfg.differentiable:
            hit = reeval_hit(scene, best_prim, o, d, cfg.t_min, cfg.t_max,
                             state.time, vol_u, t_hint=best_t)
        else:
            hit = winner_hit(scene, best_t, best_prim, o, d, state.time,
                             cfg.t_min)
    else:
        hit = intersect_scene(scene, o, d, cfg.t_min, tmax_lane, state.time,
                              vol_u)
    shade = gather_shade(scene, hit.prim_idx, hit.prim_idx >= 0)
    miss = hit.prim_idx < 0

    # albedo resolution (textures) stays outside the shared core: the
    # procedural/atlas texture machinery is executor-specific
    albedo = resolve_albedo(scene, shade, hit.point, hit.u, hit.v,
                            cfg.tex_filter, cfg.tex_tile_gate, tex_u)

    env = BounceEnv(
        mat_present=scene.mat_present,
        num_lights=scene.num_lights,
        mis_bsdf_weight=cfg.mis_bsdf_weight,
        rr_start_depth=cfg.rr_start_depth,
        sky_gate=scene.sky_light,
        light_pdf_at=(lambda o_, p_, du_, pi_, m_:
                      _light_pdf_at(scene, o_, p_, du_, pi_, m_)),
        pick_light=functools.partial(_pick_light, scene),
        occlude=functools.partial(_occlude, scene, cfg, use_pallas,
                                  state.time, occ_u),
        estimator=cfg.estimator,
        light_pdf_dir=functools.partial(_light_pdf_dir, scene),
    )
    res = bounce_core(env, U, bounce, state.alive, o, d, state.time,
                      state.throughput, state.radiance, state.prev_pdf,
                      state.prev_diffuse, miss, hit.point, hit.normal,
                      shade.mat_type, shade.fuzz, shade.eta, albedo,
                      hit.prim_idx)
    return PathState(origin=res.origin, direction=res.direction,
                     throughput=res.throughput, radiance=res.radiance,
                     alive=res.alive, time=state.time,
                     prev_pdf=res.prev_pdf, prev_diffuse=res.prev_diffuse,
                     ray_count=state.ray_count + jnp.sum(res.rays_lane))


def _pick_light(scene: S.Scene, u_sel, ua, ub):
    """BounceEnv.pick_light for the XLA integrator: uniform selection among
    the scene's Lights rows (row gathers; L == 1 folds to broadcasts)."""
    lights = scene.lights
    L = scene.num_lights
    li = (jnp.zeros_like(u_sel, dtype=jnp.int32) if L == 1 else
          jnp.clip((u_sel * L).astype(jnp.int32), 0, L - 1))
    l_area = lights.area[0] if L == 1 else lights.area[li]
    lpos = (V.gather_rows(lights.position, li)
            + V.gather_rows(lights.vec_u, li) * ua
            + V.gather_rows(lights.vec_v, li) * ub)
    return (lpos, l_area, V.gather_rows(lights.normal, li),
            V.gather_rows(lights.emission, li))


def _occlude(scene: S.Scene, cfg, use_pallas, time, occ_u,
             shadow_org, ldir_u, occ_tmax, want):
    """BounceEnv.occlude for the XLA integrator: shadow-ray any-hit query
    through the configured trace backend."""
    if use_pallas:
        from rtw.ops.trace_kernel import occluded_pallas

        # visibility is a detached boolean (it carries no gradient in the
        # detached-sampling estimator, diff.py docstring); stop_gradient on
        # every input keeps the pallas_call out of the differentiated graph
        sg = lax.stop_gradient
        return occluded_pallas(sg(scene), sg(shadow_org), sg(ldir_u),
                               cfg.shadow_eps, sg(occ_tmax), sg(time),
                               sg(occ_u))
    return occluded(scene, shadow_org, ldir_u, cfg.shadow_eps, occ_tmax,
                    time, occ_u)


def trace_paths_counted(scene: S.Scene, cfg, pixel_idx, sample_idx, key):
    """Trace one sample for each pixel in `pixel_idx`.

    Returns (radiance Vec3 of [N] planes, scalar ray count).  Uses a
    while_loop that exits once every path is dead (cheap tail bounces) or
    lax.scan when cfg.differentiable (reverse-mode AD needs a static trip
    count)."""
    path_keys = R.make_path_keys(key, pixel_idx, sample_idx, cfg.rng)
    state = generate_camera_rays(scene, cfg, pixel_idx, path_keys)

    if cfg.differentiable:
        def scan_body(st, bounce):
            return bounce_step(scene, cfg, path_keys, st, bounce), None

        if cfg.remat:
            # rematerialize each bounce in the backward sweep: the saved
            # residuals drop from every intermediate of the bounce body
            # (~dozens of [N] planes x max_depth) to just the carried
            # PathState per bounce — the memory plan that makes full-image
            # gradient renders fit (SURVEY §7.3 "backward-pass memory")
            scan_body = jax.checkpoint(scan_body)
        state, _ = lax.scan(scan_body, state, jnp.arange(cfg.max_depth))
    else:
        def cond(carry):
            bounce, st = carry
            return (bounce < cfg.max_depth) & jnp.any(st.alive)

        def body(carry):
            bounce, st = carry
            return bounce + 1, bounce_step(scene, cfg, path_keys, st, bounce)

        _, state = lax.while_loop(cond, body, (jnp.asarray(0, jnp.int32), state))

    # NaN scrub (raygen.cu:17-24 removeNaNs)
    radiance = Vec3(*(jnp.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0)
                      for c in state.radiance))
    return radiance, state.ray_count


def trace_paths(scene: S.Scene, cfg, pixel_idx, sample_idx, key):
    """As trace_paths_counted but returns [N, 3] radiance (boundary format)."""
    rad, _ = trace_paths_counted(scene, cfg, pixel_idx, sample_idx, key)
    return rad.stack()


class _WavefrontState(NamedTuple):
    """Persistent-wavefront carry: one in-flight path per lane plus the
    lane's sample cursor and radiance accumulator."""

    path: PathState
    path_keys: Any     # per-path RNG state (uint32 plane or threefry keys)
    depth: Any         # [N] int32: current bounce index of the lane's path
    sample: Any        # [N] int32: lane's current sample index
    accum: Vec3        # [N] planes: sum of completed samples' radiance
    rays: Any          # scalar f32
    pixel: Any         # [N] int32: lane's pixel (rides along under compaction)
    slot: Any          # [N] int32: lane's original position (for un-permute)
    thresh: Any        # scalar int32: alive count at the last compaction
    stats: Any         # () or WavefrontStats (cfg.bounce_stats)


_OCC_TRACE_CAP = 512   # iteration-occupancy trace length (per jitted step)


class WavefrontStats(NamedTuple):
    """Wavefront observability counters (cfg.bounce_stats; SURVEY §5
    'per-bounce wavefront sizes').  All accumulate additively across tiles
    and spp chunks.

    `len_hist[L]` counts FINISHED paths of length L bounces (bin 0 unused);
    the per-depth ray counts the metrics report derive exactly from it:
    rays_by_depth[d] = sum over L > d of len_hist[L], since a length-L path
    traced at depths 0..L-1.  Recording lengths at path FINISH (one [N]
    scatter per queue FLUSH instead of any per-iteration per-depth
    attribution) keeps instrumented runs cheap."""

    len_hist: Any        # [max_depth + 1] f32: finished-path length counts
    iters: Any           # scalar f32: wavefront iterations run
    alive_sum: Any       # scalar f32: sum over iterations of alive lanes
    occ_sum: Any         # [CAP] f32: alive lanes at iteration i (summed)
    occ_cnt: Any         # [CAP] f32: contributions at iteration i


def _stats_zero(max_depth: int, trace: bool = False) -> WavefrontStats:
    cap = _OCC_TRACE_CAP if trace else 0
    return WavefrontStats(
        len_hist=jnp.zeros((max_depth + 1,), jnp.float32),
        iters=jnp.zeros((), jnp.float32),
        alive_sum=jnp.zeros((), jnp.float32),
        occ_sum=jnp.zeros((cap,), jnp.float32),
        occ_cnt=jnp.zeros((cap,), jnp.float32),
    )


def _stats_update(st: WavefrontStats, alive, it, trace: bool) -> WavefrontStats:
    """Record one wavefront iteration's occupancy: cheap scalar counters;
    with `trace` (cfg.occupancy_trace) also the per-iteration occupancy
    curve — two [CAP] scatter-adds per iteration, the part worth ~15%
    (path lengths are recorded separately at finish time,
    _stats_record_lengths)."""
    a_f = alive.astype(jnp.float32)
    n_alive = jnp.sum(a_f)
    st = st._replace(iters=st.iters + 1.0, alive_sum=st.alive_sum + n_alive)
    if not trace:
        return st
    ti = jnp.minimum(it.astype(jnp.int32), _OCC_TRACE_CAP - 1)
    return st._replace(
        occ_sum=st.occ_sum.at[ti].add(n_alive),
        occ_cnt=st.occ_cnt.at[ti].add(1.0),
    )


def _stats_record_lengths(st: WavefrontStats, finished, length,
                          max_depth: int) -> WavefrontStats:
    """Add newly finished paths' lengths to the histogram (one [N]
    scatter-add; masked lanes land in the unused bin 0 with weight 0)."""
    idx = jnp.where(finished, jnp.minimum(length, max_depth), 0)
    return st._replace(len_hist=st.len_hist.at[idx].add(
        finished.astype(jnp.float32)))


def _alive_first_perm(alive):
    """Gather indices of the stable alive-first partition of the lanes.

    cumsum-based (2 scans + 1 scatter) — far cheaper than a sort, and the
    partition is all the trace kernels need: dead lanes collect into
    contiguous all-dead tiles that resolve at slab-test cost (their tmax is
    forced below tmin in bounce_step)."""
    n = alive.shape[0]
    a = alive.astype(jnp.int32)
    n_alive = jnp.sum(a)
    pos_alive = jnp.cumsum(a) - 1
    pos_dead = n_alive + jnp.cumsum(1 - a) - 1
    dest = jnp.where(alive, pos_alive, pos_dead)
    return jnp.zeros((n,), jnp.int32).at[dest].set(
        jnp.arange(n, dtype=jnp.int32))


def _permute_wavefront(wf: _WavefrontState, perm) -> _WavefrontState:
    """Apply a lane permutation to every per-lane column of the carry.

    Pure relabeling: each lane keeps its whole (pixel, sample cursor, RNG
    state, accumulator) context, so the estimator — and the image, which is
    un-permuted through `slot` at the end — is bit-identical."""
    p = wf.path
    path = PathState(
        origin=Vec3(p.origin.x[perm], p.origin.y[perm], p.origin.z[perm]),
        direction=Vec3(p.direction.x[perm], p.direction.y[perm],
                       p.direction.z[perm]),
        throughput=Vec3(p.throughput.x[perm], p.throughput.y[perm],
                        p.throughput.z[perm]),
        radiance=Vec3(p.radiance.x[perm], p.radiance.y[perm],
                      p.radiance.z[perm]),
        alive=p.alive[perm],
        time=p.time[perm],
        prev_pdf=p.prev_pdf[perm],
        prev_diffuse=p.prev_diffuse[perm],
        ray_count=p.ray_count,
    )
    return _WavefrontState(
        path=path,
        path_keys=wf.path_keys[perm],
        depth=wf.depth[perm],
        sample=wf.sample[perm],
        accum=Vec3(wf.accum.x[perm], wf.accum.y[perm], wf.accum.z[perm]),
        rays=wf.rays,
        pixel=wf.pixel[perm],
        slot=wf.slot[perm],
        thresh=wf.thresh,
        stats=wf.stats,
    )


def trace_wavefront(scene: S.Scene, cfg, pixel_idx, key, s0: int,
                    n_samples: int):
    """Dispatch to the configured wavefront scheduler (cfg.scheduler).

    "queue" (default): global work-queue scheduler — lanes that finish a
    sample claim ANY pixel's next sample, so per-pixel difficulty variance
    (glass/volume pixels trace 5-10x more bounces than sky pixels) cannot
    strand the wavefront at single-digit occupancy.  Per-pixel sums are
    exact but floating-point addition order follows claim order, so images
    are deterministic for a fixed (config, batch width) yet not bitwise
    identical across different batch/mesh widths.

    "regen": per-lane regeneration — each lane owns one pixel and renders
    its samples in ascending order, making the image bitwise independent of
    batch width and mesh shape (the distributed-determinism mode).  Costs
    long drain tails on scenes with uneven pixel difficulty.
    """
    sched = cfg.scheduler
    if sched == "auto":
        # queue pays for itself when pixel-difficulty variance strands the
        # wavefront: on the GPU it won on every kernel-traced scene.  The
        # smallest scenes run the pure-XLA sweep, whose whole bounce fuses
        # into a handful of kernels; there the queue's lax.cond flush would
        # split that fusion (for the same reason compaction is compiled
        # out), and regen measured faster.
        sched = "queue" if _pallas_backend(cfg, scene) else "regen"
    if sched == "queue":
        return trace_wavefront_queue(scene, cfg, pixel_idx, key, s0,
                                     n_samples)
    return trace_wavefront_regen(scene, cfg, pixel_idx, key, s0, n_samples)


def trace_wavefront_regen(scene: S.Scene, cfg, pixel_idx, key, s0: int,
                          n_samples: int):
    """Persistent wavefront with ray regeneration — the data-parallel
    answer to the
    occupancy collapse of a fixed-depth bounce loop.

    A per-sample while_loop runs until EVERY lane's path dies; with Russian
    roulette the mean path length is ~5 bounces but the loop runs to ~20,
    i.e. ~25% average occupancy.  Here each lane immediately starts its next
    sample (same pixel, sample cursor +1) the moment its path terminates, so
    occupancy stays ~100% until the final tail.  This replaces OptiX's
    persistent-thread scheduling of __raygen__ launches (the reference gets
    this for free from the hardware scheduler).

    Draw discipline is unchanged — every uniform is keyed by logical
    (pixel, sample, bounce, slot) — so the image is bit-identical to the
    per-sample loop up to float addition order *within one lane*, which is
    also sample-ascending here.

    Once the drain tail begins (no lane regenerates, occupancy only decays),
    lanes are periodically partitioned alive-first (`_alive_first_perm`) —
    each halving of the alive count triggers one compaction.  Dead lanes
    collect into contiguous all-dead ray blocks which the trace kernels
    resolve at slab-test cost (bounce_step forces their tmax below tmin), so
    the straggler tail costs ~occupancy instead of ~100% per iteration.  The
    image is bit-identical: a lane carries its whole (pixel, sample, RNG,
    accumulator) context through the permutation and is un-permuted by
    `slot` at the end.

    Returns (accum Vec3 [N] = sum over samples [s0, s0+n_samples), rays,
    stats) where stats is a WavefrontStats when cfg.bounce_stats else ()."""
    n = pixel_idx.shape[0]
    compacting = _pallas_backend(cfg, scene)
    s_init = jnp.full((n,), s0, jnp.int32)
    path_keys = R.make_path_keys(key, pixel_idx, s_init, cfg.rng)
    path = generate_camera_rays(scene, cfg, pixel_idx, path_keys)
    s_end = s0 + n_samples

    wf = _WavefrontState(
        path=path,
        path_keys=path_keys,
        depth=jnp.zeros((n,), jnp.int32),
        sample=s_init,
        accum=V.zeros(n),
        rays=jnp.zeros((), jnp.float32),
        pixel=pixel_idx,
        slot=jnp.arange(n, dtype=jnp.int32),
        thresh=jnp.asarray(n, jnp.int32),
        stats=(_stats_zero(cfg.max_depth, cfg.occupancy_trace)
               if cfg.bounce_stats else ()),
    )

    def cond(wf):
        return jnp.any(wf.path.alive)

    def body(wf):
        stats = (_stats_update(wf.stats, wf.path.alive, wf.stats.iters,
                               cfg.occupancy_trace)
                 if cfg.bounce_stats else ())
        st = bounce_step(scene, cfg, wf.path_keys, wf.path, wf.depth)
        depth = wf.depth + 1
        # a path is finished when the bounce killed it or it hit max_depth
        finished = wf.path.alive & (~st.alive | (depth >= cfg.max_depth))
        if cfg.bounce_stats:
            stats = _stats_record_lengths(stats, finished, depth,
                                          cfg.max_depth)

        # NaN scrub per completed sample (raygen.cu:17-24 removeNaNs), so a
        # single bad sample can't poison the lane's whole accumulator
        rad = Vec3(*(jnp.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0)
                     for c in st.radiance))
        accum = V.where(finished, wf.accum + rad, wf.accum)
        sample = jnp.where(finished, wf.sample + 1, wf.sample)
        regen = finished & (sample < s_end)

        # regenerate: fresh path for (pixel, sample) — computed for all lanes,
        # selected per lane (lockstep; the cost is one camera-ray block)
        new_keys = R.make_path_keys(key, wf.pixel, sample, cfg.rng)
        fresh = generate_camera_rays(scene, cfg, wf.pixel, new_keys)

        alive = jnp.where(finished, regen, st.alive)
        path = PathState(
            origin=V.where(regen, fresh.origin, st.origin),
            direction=V.where(regen, fresh.direction, st.direction),
            throughput=V.where(regen, fresh.throughput, st.throughput),
            radiance=V.where(finished, fresh.radiance, st.radiance),
            alive=alive,
            time=jnp.where(regen, fresh.time, st.time),
            prev_pdf=jnp.where(regen, fresh.prev_pdf, st.prev_pdf),
            prev_diffuse=jnp.where(regen, fresh.prev_diffuse,
                                   st.prev_diffuse),
            ray_count=st.ray_count,
        )
        keys = jnp.where(regen, new_keys, wf.path_keys)
        nwf = _WavefrontState(
            path=path,
            path_keys=keys,
            depth=jnp.where(regen, 0, depth),
            sample=sample,
            accum=accum,
            rays=st.ray_count,
            pixel=wf.pixel,
            slot=wf.slot,
            thresh=wf.thresh,
            stats=stats,
        )

        if not compacting:
            return nwf

        # drain-tail compaction: each halving of the alive count repacks
        # alive lanes to the front (a cumsum partition + one gather per
        # carried column), so
        # all-dead suffix tiles resolve at slab-test cost every following
        # iteration.  Only worth anything for the tiled Pallas backend: the
        # plain-XLA sweep is lockstep over all lanes regardless of order,
        # and the lax.cond splits its otherwise fully-fused bounce body —
        # so it is compiled out there.
        n_alive = jnp.sum(alive.astype(jnp.int32))
        do_compact = (n_alive * 2 < nwf.thresh) & (n_alive > 0)

        def compact(w):
            w = _permute_wavefront(w, _alive_first_perm(w.path.alive))
            return w._replace(thresh=n_alive)

        return lax.cond(do_compact, compact, lambda w: w, nwf)

    wf = lax.while_loop(cond, body, wf)
    if not compacting:
        return wf.accum, wf.rays, wf.stats    # slot is the identity
    zero = jnp.zeros((n,), jnp.float32)
    accum = Vec3(zero.at[wf.slot].set(wf.accum.x),
                 zero.at[wf.slot].set(wf.accum.y),
                 zero.at[wf.slot].set(wf.accum.z))
    return accum, wf.rays, wf.stats


class _QueueState(NamedTuple):
    """Work-queue wavefront carry.  `accum` is indexed by ITEM POSITION
    (column r sums pixel_idx[r]'s samples), so lane permutations never touch
    it — each lane carries `item_pos` pointing at its column."""

    path: PathState
    path_keys: Any     # per-path RNG state
    depth: Any         # [N] int32: bounce index of the lane's current path
    item_pos: Any      # [N] int32: accum column this lane's sample belongs to
    sample: Any        # [N] int32: sample index of the lane's current item
    pixel: Any         # [N] int32: pixel id of the lane's current item
    pending: Any       # [N] bool: finished, contribution not yet flushed
    accum: Vec3        # [N] planes: per-position radiance sums
    rays: Any          # scalar f32
    cursor: Any        # scalar int32: next unclaimed item
    thresh: Any        # scalar int32: alive count at the last compaction
    stats: Any         # () or WavefrontStats


def _resolved_flush_denom(cfg) -> int:
    """cfg.flush_denom (see config.py); module hook kept for experiments."""
    return cfg.flush_denom if _FLUSH_DENOM is None else _FLUSH_DENOM


_FLUSH_DENOM = None   # experiment override; None = use cfg.flush_denom


def decode_tile_pixel(pos, nx: int, ny: int, tile: int = 32):
    """Closed form of render.tile_permutation: the pixel id rendered by lane
    `pos` under the (y//T, x//T, y%T, x%T) lexsort, including partial edge
    tiles.  Lets the work-queue flush derive a claimed item's pixel with a
    dozen int ops instead of a per-lane gather through pixel_idx."""
    t = tile
    rx, ry = nx % t, ny % t
    ntx, nty = nx // t, ny // t
    lanes_row = nx * t
    ty = pos // lanes_row        # partial last row has < lanes_row lanes but
    rem = pos - ty * lanes_row   # still floors to nty for every lane in it
    if ry:
        last_row = ty >= nty
        th = jnp.where(last_row, ry, t)
        tx_raw = jnp.where(last_row, rem // (ry * t), rem // (t * t))
    else:
        th = t
        tx_raw = rem // (t * t)
    tx = jnp.minimum(tx_raw, ntx) if rx else tx_raw
    local = rem - tx * (th * t)
    if rx:
        last_col = tx >= ntx
        iy = jnp.where(last_col, local // rx, local // t)
        tw = jnp.where(last_col, rx, t)
        ix = local - iy * tw
    else:
        iy = local // t
        ix = local - iy * t
    return (ty * t + iy) * nx + tx * t + ix


def trace_wavefront_queue(scene: S.Scene, cfg, pixel_idx, key, s0: int,
                          n_samples: int):
    """Persistent wavefront with a GLOBAL work queue — the data-parallel
    replacement for OptiX's hardware thread scheduler.

    Work items are (pixel, sample) pairs, enumerated sample-major:
    item i = (pixel_idx[i mod N], s0 + i div N).  Every lane starts on item
    = its own index; the moment a lane's path terminates it scatter-adds the
    finished sample into its accum row and claims item `cursor + rank`
    (rank = its position among this iteration's finishers), so occupancy
    stays ~100% until the global queue drains, with a tail bounded by ONE
    path length (~max_depth) instead of a whole straggler pixel's sample
    budget.  Versus per-lane regeneration (trace_wavefront_regen) this
    matters because glass / volume pixels trace many times the bounces of
    sky pixels while the per-iteration XLA shading work runs full-width,
    so idle lanes bill almost as much as live ones.

    Estimator: identical samples (RNG is keyed by logical (pixel, sample)
    only); per-pixel sums are reassociated in claim order, so the image is
    deterministic for fixed batch width but not bit-identical across batch
    widths — use cfg.scheduler="regen" for bitwise mesh-shape invariance.

    Claims are rank-ordered, so consecutive finishers take consecutive
    items = spatially adjacent pixels under render.tile_permutation — tile
    coherence degrades gracefully instead of collapsing.

    Returns (accum Vec3 [N] positional sums, rays, stats)."""
    n = pixel_idx.shape[0]
    n_items = n * n_samples
    s_init = jnp.full((n,), s0, jnp.int32)
    path_keys = R.make_path_keys(key, pixel_idx, s_init, cfg.rng)
    path = generate_camera_rays(scene, cfg, pixel_idx, path_keys)

    wf = _QueueState(
        path=path,
        path_keys=path_keys,
        depth=jnp.zeros((n,), jnp.int32),
        item_pos=jnp.arange(n, dtype=jnp.int32),
        sample=s_init,
        pixel=pixel_idx,
        pending=jnp.zeros((n,), bool),
        accum=V.zeros(n),
        rays=jnp.zeros((), jnp.float32),
        cursor=jnp.asarray(n, jnp.int32),
        thresh=jnp.asarray(n, jnp.int32),
        stats=(_stats_zero(cfg.max_depth, cfg.occupancy_trace)
               if cfg.bounce_stats else ()),
    )

    def cond(wf):
        return jnp.any(wf.path.alive) | jnp.any(wf.pending)

    def flush(w: _QueueState) -> _QueueState:
        """Scatter every pending lane's finished sample into its accum
        column and claim it a new item (cursor + rank among pending)."""
        pend = w.pending
        stats = w.stats
        if cfg.bounce_stats:
            # pending lanes' depth froze at their path length (see body)
            stats = _stats_record_lengths(stats, pend, w.depth,
                                          cfg.max_depth)
        rad = Vec3(*(jnp.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0)
                     for c in w.path.radiance))   # scrub per sample
        # three 1-D scatter-adds, NOT one packed [3, N] scatter: the packed
        # form (`accum.at[:, pos].add(vals)`) lowers to a generic windowed
        # scatter; XLA's 1-D scatter-add specialization is the fast path
        accum = Vec3(
            w.accum.x.at[w.item_pos].add(jnp.where(pend, rad.x, 0.0)),
            w.accum.y.at[w.item_pos].add(jnp.where(pend, rad.y, 0.0)),
            w.accum.z.at[w.item_pos].add(jnp.where(pend, rad.z, 0.0)),
        )
        fin = pend.astype(jnp.int32)
        rank = jnp.cumsum(fin) - 1
        new_item = w.cursor + rank
        have = pend & (new_item < n_items)
        q = new_item // n
        pos = jnp.where(have, new_item - q * n, w.item_pos)
        sample = jnp.where(have, s0 + q, w.sample)
        if cfg.pixel_layout == "tile32":
            pixel = jnp.where(have, decode_tile_pixel(pos, cfg.nx, cfg.ny),
                              w.pixel)
        else:
            pixel = jnp.where(have, pixel_idx[jnp.minimum(pos, n - 1)],
                              w.pixel)

        new_keys = R.make_path_keys(key, pixel, sample, cfg.rng)
        fresh = generate_camera_rays(scene, cfg, pixel, new_keys)
        p = w.path
        path = PathState(
            origin=V.where(have, fresh.origin, p.origin),
            direction=V.where(have, fresh.direction, p.direction),
            throughput=V.where(have, fresh.throughput, p.throughput),
            radiance=V.where(pend, fresh.radiance, p.radiance),
            alive=p.alive | have,
            time=jnp.where(have, fresh.time, p.time),
            prev_pdf=jnp.where(have, fresh.prev_pdf, p.prev_pdf),
            prev_diffuse=jnp.where(have, fresh.prev_diffuse, p.prev_diffuse),
            ray_count=p.ray_count,
        )
        return w._replace(
            path=path,
            path_keys=jnp.where(have, new_keys, w.path_keys),
            depth=jnp.where(have, 0, w.depth),
            item_pos=pos, sample=sample, pixel=pixel,
            pending=jnp.zeros_like(pend),
            accum=accum,
            cursor=w.cursor + jnp.sum(fin),
            stats=stats,
        )

    def body(wf):
        stats = (_stats_update(wf.stats, wf.path.alive, wf.stats.iters,
                               cfg.occupancy_trace)
                 if cfg.bounce_stats else ())
        st = bounce_step(scene, cfg, wf.path_keys, wf.path, wf.depth)
        # dead (pending) lanes keep their final depth: at flush time
        # `depth` IS the finished path's length, so the stats histogram can
        # record lengths there (once per flush instead of per iteration)
        depth = jnp.where(wf.path.alive, wf.depth + 1, wf.depth)
        finished = wf.path.alive & (~st.alive | (depth >= cfg.max_depth))
        pending = wf.pending | finished
        running = st.alive & ~finished

        nwf = wf._replace(
            path=st._replace(alive=running), depth=depth,
            pending=pending, rays=st.ray_count, stats=stats,
        )

        # Flush policy (cfg.flush_denom): deferring the flush behind a
        # pending >= N/k threshold skips its scatter/gather block on most
        # iterations; pending lanes idle an iteration or two.
        fd = _resolved_flush_denom(cfg)
        if fd <= 0:
            nwf = flush(nwf)
        else:
            n_pend = jnp.sum(pending.astype(jnp.int32))
            n_run = jnp.sum(running.astype(jnp.int32))
            do_flush = (n_pend * fd >= n) | ((n_run == 0)
                                             & (n_pend > 0))
            nwf = lax.cond(do_flush, flush, lambda w: w, nwf)

        # NO SER-style coherence sort here: applying a permutation to the
        # ~20-plane carry costs far more than the sort itself (see
        # docs/QUIRKS.md "SER-style lane sorting").  Any future reordering
        # must avoid permuting the carry (e.g. reorder only inside a trace
        # kernel's ray block).
        #
        # NO drain-tail compaction here (unlike trace_wavefront_regen): the
        # queue's tail is one path length, and a compaction permutes ~20
        # carry planes — more than the short tail it would save.  The XLA
        # glue (shading/flush) is lockstep full-width regardless of lane
        # order.
        return nwf

    wf = lax.while_loop(cond, body, wf)
    return wf.accum, wf.rays, wf.stats
