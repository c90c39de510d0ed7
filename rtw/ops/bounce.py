"""The single definition of the estimator physics — one bounce, all paths.

Every scatter/NEE/MIS/RR decision of the renderer lives HERE, once.  The
wavefront integrator (integrator.bounce_step) calls `bounce_core` with a
`BounceEnv` that injects the scene-specific accessors (light sampling and
pdfs, the occlusion query of the configured trace backend); RNG uniforms
are drawn by the caller.  A future whole-bounce kernel would call the same
core, so a change to the estimator cannot land in one execution path only
(the reference has exactly one closehit.cu for the same reason).

Estimator semantics (with reference citations):

- miss: white->blue sky gradient gated by skyLight (miss/miss.cu:8-21,
  Director.cpp:523)
- lambertian: cosine-hemisphere scatter via ONB (lambertianMaterial.cu),
  metal: fuzzy mirror (metalMaterial.cu), dielectric: Snell + Schlick
  (dielectricMaterial.cu), isotropic: uniform sphere
  (isotropicMaterial.cu), diffuse light: one-sided emission + terminate
  (diffuseLight.cu), normal-debug: book-correct normal color
- NEE on parallelogram lights with selection-inclusive pdf and
  power-heuristic MIS (closehit.cu:70-118, rectPdf.cu:124-193,
  raydata.cuh:167-171); optional MIS weighting of BSDF-sampled light hits
  (cfg.mis_bsdf_weight — the unbiased completion of the reference's
  one-sided scheme)
- Russian roulette from depth >= rr_start with p = max(throughput)
  (raygen.cu:74-82)

All boolean state updates use boolean algebra instead of select, which
every lowering (XLA, Pallas) accepts for i1 vectors.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from rtw.models import scene as S
from rtw.ops import sampling as sm
from rtw.ops import vec as V
from rtw.ops.intersect import BIG
from rtw.ops.vec import Vec3
from rtw.utils import rng as R


class BounceEnv(NamedTuple):
    """Execution-environment accessors injected by each bounce executor."""

    mat_present: tuple            # static MAT_* presence flags
    num_lights: int               # static
    mis_bsdf_weight: bool         # static
    rr_start_depth: int           # static
    sky_gate: Any                 # traced scalar: sky_light (0.0 / 1.0)
    # (origin, point, dir_unit, prim_idx, mask) -> solid-angle pdf of NEE
    # having sampled this direction (BSDF-side MIS weight).  None when
    # mis_bsdf_weight is off or there are no lights.
    light_pdf_at: Optional[Callable[..., Any]]
    # (u_select, uA, uB) -> (lpos Vec3, l_area, l_nrm Vec3, l_emit Vec3).
    # Selection among L lights is internal; the returned area is the chosen
    # light's (the 1/L selection factor is applied in core via num_lights).
    pick_light: Optional[Callable[..., Any]]
    # (shadow_org Vec3, ldir_u Vec3, occ_tmax, want) -> occluded bool plane
    occlude: Optional[Callable[..., Any]]
    # Estimator family (config.RenderConfig.estimator): "mis" (NEE+MIS,
    # default) or "book" (the books' literal 0.5/0.5 cosine/light mixture).
    estimator: str = "mis"
    # (origin Vec3, dir_unit Vec3, mask) -> (1/L) * sum_l pdf_l(dir): the
    # mixture's light-pdf of an ARBITRARY direction (geometric ray-vs-light
    # test, no scene occlusion) — the books' hittable_pdf::value.  Only
    # consulted when estimator == "book".
    light_pdf_dir: Optional[Callable[..., Any]] = None


class BounceResult(NamedTuple):
    origin: Vec3
    direction: Vec3
    throughput: Vec3
    radiance: Vec3
    alive: Any            # [N] bool: path still tracing after this bounce
    prev_pdf: Any
    prev_diffuse: Any     # [N] bool
    rays_lane: Any        # [N] f32: traversal queries this lane issued


def bounce_core(env: BounceEnv, U, depth, alive, o: Vec3, d: Vec3,
                time, thr: Vec3, rad: Vec3, prev_pdf, prev_diffuse,
                miss, point: Vec3, nrm: Vec3, mat_type, fuzz, eta,
                albedo: Vec3, prim_idx) -> BounceResult:
    """One wavefront bounce after the trace: miss shade, material scatter,
    NEE + MIS, advance, Russian roulette.

    U: list/array of per-lane uniform planes indexed by utils.rng slot ids.
    depth: per-lane (or scalar) bounce index.  miss: prim_idx < 0 plane.
    (point, nrm, mat_type, fuzz, eta, albedo): the winner's hit record and
    resolved shading inputs.  All planes are [N]."""
    n = mat_type.shape[0]
    hit_alive = alive & ~miss
    rays_lane = alive.astype(jnp.float32)
    radiance = rad

    # ----- miss: sky gradient or black (miss/miss.cu:8-21) ----------------
    d_unit = d.normalized()
    sky_t = 0.5 * (d_unit.y + 1.0)
    # (1-t)*white + t*(0.5,0.7,1.0), gated by skyLight (Director.cpp:523)
    sky = Vec3((1.0 - 0.5 * sky_t) * env.sky_gate,
               (1.0 - 0.3 * sky_t) * env.sky_gate,
               jnp.ones_like(sky_t) * env.sky_gate)
    m_sky = alive & miss
    radiance = V.where(m_sky, radiance + thr * sky, radiance)

    # ----- material branches (static scene specialization: mat_present
    # keeps models the scene doesn't contain out of the compiled program,
    # the analog of a per-scene SBT with only reachable program groups) ----
    mp = env.mat_present
    false_n = jnp.zeros((n,), bool)
    zero3 = V.zeros(n)
    ones3 = V.ones(n)
    ones = jnp.ones((n,), jnp.float32)

    is_lamb = (mat_type == S.MAT_LAMBERTIAN) if mp[S.MAT_LAMBERTIAN] else false_n
    is_metal = (mat_type == S.MAT_METAL) if mp[S.MAT_METAL] else false_n
    is_diel = (mat_type == S.MAT_DIELECTRIC) if mp[S.MAT_DIELECTRIC] else false_n
    is_light = (mat_type == S.MAT_DIFFUSE_LIGHT) if mp[S.MAT_DIFFUSE_LIGHT] else false_n
    is_iso = (mat_type == S.MAT_ISOTROPIC) if mp[S.MAT_ISOTROPIC] else false_n
    is_norm = (mat_type == S.MAT_NORMAL) if mp[S.MAT_NORMAL] else false_n

    scatter_dir = d_unit  # placeholder for lanes that terminate anyway
    attenuation = albedo
    cancel = false_n
    terminate = false_n

    # ----- lambertian: cosine-hemisphere scatter (lambertianMaterial.cu) --
    book = env.estimator == "book" and env.num_lights > 0
    if mp[S.MAT_LAMBERTIAN] and book:
        # The books' mixture estimator (RTW book 3 ch. 10 / the reference's
        # intended mixturePdf.cu:10-37): draw the NEXT ray itself from
        # 0.5 * cosine + 0.5 * light-area sampling and weight the diffuse
        # reflectance by scattering_pdf / mixture_pdf.  No shadow rays, no
        # MIS — light transport arrives only through actual light hits.
        ou, ov, ow = sm.build_onb(nrm)
        local = sm.cosine_direction(U[R.U_SCATTER_0], U[R.U_SCATTER_1])
        cos_dir = sm.onb_local(ou, ov, ow, local).normalized()
        lpos, _la, _ln, _le = env.pick_light(
            U[R.U_LIGHT_SELECT], U[R.U_LIGHT_A], U[R.U_LIGHT_B])
        ldir = lpos - point
        ldist = ldir.length()
        ldir_u = ldir * (1.0 / jnp.maximum(ldist, 1e-12))
        take_light = U[R.U_DIELECTRIC] < 0.5     # slot unused by lambertian
        lamb_dir = V.where(take_light, ldir_u, cos_dir)
        cos_pdf = jnp.maximum(nrm.dot(lamb_dir), 0.0) * sm.INV_PI
        lgt_pdf = env.light_pdf_dir(point, lamb_dir, hit_alive & is_lamb)
        lamb_pdf = 0.5 * cos_pdf + 0.5 * lgt_pdf
        # scattering_pdf == cos_pdf for lambertian; a zero of either kills
        # the contribution (the books multiply the recursion by 0)
        lamb_cancel = (lamb_pdf <= 0.0) | (cos_pdf <= 0.0)
        pdf_safe = jnp.where(lamb_cancel, 1.0, lamb_pdf)
        w_mix = jnp.where(lamb_cancel, 0.0, cos_pdf / pdf_safe)
        attenuation = V.where(is_lamb, albedo * w_mix, attenuation)
        scatter_dir = V.where(is_lamb, lamb_dir, scatter_dir)
        cancel = cancel | (is_lamb & lamb_cancel)
    elif mp[S.MAT_LAMBERTIAN]:
        ou, ov, ow = sm.build_onb(nrm)
        local = sm.cosine_direction(U[R.U_SCATTER_0], U[R.U_SCATTER_1])
        lamb_dir = sm.onb_local(ou, ov, ow, local).normalized()
        lamb_pdf = local.z * sm.INV_PI
        lamb_scatter_pdf = nrm.dot(lamb_dir) * sm.INV_PI
        lamb_cancel = (lamb_pdf <= 0.0) | (lamb_scatter_pdf <= 0.0)
        scatter_dir = V.where(is_lamb, lamb_dir, scatter_dir)
        cancel = cancel | (is_lamb & lamb_cancel)
    else:
        lamb_pdf = ones

    # ----- metal: fuzzy mirror (metalMaterial.cu) -------------------------
    if mp[S.MAT_METAL]:
        refl = V.reflect(d_unit, nrm)
        fuzz_vec = sm.unit_ball(U[R.U_SCATTER_0], U[R.U_SCATTER_1],
                                 U[R.U_SCATTER_2])
        metal_dir = (refl + fuzz_vec * fuzz).normalized()
        metal_cancel = metal_dir.dot(nrm) <= 0.0
        scatter_dir = V.where(is_metal, metal_dir, scatter_dir)
        cancel = cancel | (is_metal & metal_cancel)

    # ----- dielectric: Snell + Schlick (dielectricMaterial.cu) ------------
    if mp[S.MAT_DIELECTRIC]:
        outside = d_unit.dot(nrm) < 0.0
        ln = V.where(outside, nrm, -nrm)
        eta_i = jnp.where(outside, 1.0, eta)
        eta_t = jnp.where(outside, eta, 1.0)
        ratio = eta_i / eta_t
        cos_i = jnp.minimum((-d_unit).dot(ln), 1.0)
        sin_i = sm.safe_sqrt(1.0 - cos_i * cos_i)
        tir = ratio * sin_i > 1.0
        reflect_prob = sm.fresnel_schlick(cos_i, eta_i, eta_t)
        do_reflect = tir | (U[R.U_DIELECTRIC] < reflect_prob)
        sin_t = jnp.minimum(ratio * sin_i, 1.0)
        cos_t = sm.safe_sqrt(1.0 - sin_t * sin_t)
        refr_dir = (d_unit + ln * cos_i) * ratio - ln * cos_t
        diel_dir = V.where(do_reflect, V.reflect(d_unit, ln), refr_dir)
        scatter_dir = V.where(is_diel, diel_dir, scatter_dir)
        attenuation = V.where(is_diel, ones3, attenuation)

    # ----- isotropic: uniform sphere scatter (isotropicMaterial.cu) -------
    if mp[S.MAT_ISOTROPIC]:
        iso_dir = sm.sphere_surface(U[R.U_SCATTER_0], U[R.U_SCATTER_1])
        scatter_dir = V.where(is_iso, iso_dir, scatter_dir)

    # ----- diffuse light: one-sided emission, terminate (diffuseLight.cu) -
    if mp[S.MAT_DIFFUSE_LIGHT]:
        facing = nrm.dot(d_unit) < 0.0
        emitted = V.where(facing, albedo, zero3)
        if env.mis_bsdf_weight and env.num_lights > 0 and not book:
            w_mask = hit_alive & is_light & prev_diffuse
            lp = env.light_pdf_at(o, point, d_unit, prim_idx, w_mask)
            prev_safe = jnp.where(w_mask, prev_pdf, 1.0)
            w_bsdf = jnp.where(w_mask, sm.power_heuristic(prev_safe, lp), 1.0)
        else:
            w_bsdf = ones
        radiance = V.where(hit_alive & is_light,
                           radiance + thr * emitted * w_bsdf, radiance)
        attenuation = V.where(is_light, zero3, attenuation)
        terminate = terminate | is_light

    # ----- normal-debug: terminate with normal color (normalMaterial.cu;
    # book-correct contribution — the reference's port renders black,
    # SURVEY §2.2) ---------------------------------------------------------
    if mp[S.MAT_NORMAL]:
        radiance = V.where(hit_alive & is_norm,
                           radiance + thr * (nrm * 0.5 + 0.5), radiance)
        attenuation = V.where(is_norm, zero3, attenuation)
        terminate = terminate | is_norm

    terminate = terminate | cancel

    # ----- next-event estimation (closehit.cu:70-118); the book-mixture
    # estimator has no shadow rays — light sampling IS the scatter ---------
    if env.num_lights > 0 and mp[S.MAT_LAMBERTIAN] and not book:
        lpos, l_area, l_nrm, l_emission = env.pick_light(
            U[R.U_LIGHT_SELECT], U[R.U_LIGHT_A], U[R.U_LIGHT_B])
        ldir = lpos - point
        ldist = ldir.length()
        ldir_u = ldir * (1.0 / jnp.maximum(ldist, 1e-12))
        costa = (-ldir_u).dot(l_nrm)
        l_valid = (ldist > 1e-6) & (costa > 1e-6)
        # "double-where": neutralize inputs on invalid lanes BEFORE the
        # divisions so their (masked-out) cotangents can't overflow to
        # inf/NaN and poison reverse-mode (standard jnp.where-grad trap)
        costa_safe = jnp.where(l_valid, costa, 1.0)
        # selection-INCLUSIVE pdf (uniform 1/L light choice x uniform area,
        # mapped to solid angle).  Both the estimator divisor and the MIS
        # weight use this same pdf — the reference instead scales emission
        # by numLights (rectPdf.cu:158-160, value-equivalent) but weights
        # with the raw per-light pdf, which would mis-weight any L>1 scene;
        # no live reference scene has L>1.  env.light_pdf_at (the BSDF-side
        # weight) matches this definition.
        l_pdf = jnp.where(
            l_valid,
            ldist * ldist / (np.float32(env.num_lights) * l_area
                             * costa_safe), 0.0)

        # diffuse BSDF toward the light (lambertianMaterial.cu:74-81)
        bsdf_pdf = jnp.maximum(ldir_u.dot(nrm), 0.0) * sm.INV_PI

        nee_active = (hit_alive & is_lamb & ~cancel
                      & l_valid & (bsdf_pdf > 0.0))
        rays_lane = rays_lane + nee_active.astype(jnp.float32)
        shadow_org = sm.offset_point(point, nrm, ldir_u)
        # relative end margin: the absolute 5e-5 of the reference
        # (closehit.cu:100) is smaller than fp32 error at scene scale and
        # than the acne offset above, making the light occlude itself.
        # Lanes with no NEE work get tmax = -BIG: fully-inactive shadow
        # tiles resolve at slab-test cost (verdict masked out below).
        occ_tmax = jnp.where(nee_active, ldist * np.float32(0.999),
                             np.float32(-BIG))
        shadowed = env.occlude(shadow_org, ldir_u, occ_tmax, nee_active)
        l_pdf_safe = jnp.where(nee_active, l_pdf, 1.0)
        bsdf_safe = jnp.where(nee_active, bsdf_pdf, 1.0)
        w_nee = sm.power_heuristic(l_pdf_safe, bsdf_safe)
        # f = albedo/pi; contribution = f * Le * w * cos / l_pdf
        nee_s = (w_nee * jnp.maximum(ldir_u.dot(nrm), 0.0) * sm.INV_PI
                 / l_pdf_safe)
        nee = albedo * l_emission * nee_s
        radiance = V.where(nee_active & ~shadowed,
                           radiance + thr * nee, radiance)

    # ----- advance --------------------------------------------------------
    new_alive = hit_alive & ~terminate
    # volume (isotropic) scatter points must NOT be offset along the fake
    # +X normal: they continue from inside the medium
    next_org = V.where(is_iso, point,
                       sm.offset_point(point, nrm, scatter_dir))
    origin = V.where(hit_alive, next_org, o)
    direction = V.where(new_alive, scatter_dir, d)
    throughput = V.where(new_alive, thr * attenuation, thr)

    # ----- russian roulette (raygen.cu:74-82) -----------------------------
    rr_on = depth >= env.rr_start_depth
    p_cont = throughput.max_component()
    kill = U[R.U_RR] > p_cont
    rr_kill = rr_on & kill
    alive_out = new_alive & ~rr_kill
    rr_scale = jnp.where(rr_on & ~kill & new_alive,
                         1.0 / jnp.maximum(p_cont, 1e-12), 1.0)
    throughput = throughput * rr_scale

    prev_pdf = jnp.where(new_alive & is_lamb, lamb_pdf, prev_pdf)
    # boolean algebra, not select (see module docstring)
    prev_diffuse = (new_alive & is_lamb) | (~new_alive & prev_diffuse)

    return BounceResult(origin=origin, direction=direction,
                        throughput=throughput, radiance=radiance,
                        alive=alive_out, prev_pdf=prev_pdf,
                        prev_diffuse=prev_diffuse, rays_lane=rays_lane)
