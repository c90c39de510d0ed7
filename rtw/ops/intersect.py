"""Vectorized scene intersection — the XLA replacement for OptiX traversal.

The reference leans on hardware BVH traversal (`optixTraverse`) dispatching
into 7 intersection programs (RestOfLife/geometry/*.cu, shaders/aarect*.cu).
Here a ray wavefront is tested against the scene as dense [prim-chunk x rays]
blocks:

- Primitives are grouped at build time by (prim_type, rect_axis,
  has_transform) into *statically typed chunks* (see models/builder.py), so
  each chunk runs exactly one specialized test — no per-lane dispatch, no
  divergence, perfect lockstep.
- All ray state is SoA component planes (`Vec3` of [N] arrays, ops/vec.py)
  and every t-matrix is [C, N] with the RAY axis minormost, so elementwise
  work streams contiguous ray planes.
- Each chunk yields a [C, N] t-matrix; a running (t, prim) argmin is merged
  chunk by chunk, and the chunk winner's hit payload (point/normal/uv) is
  computed once per ray from the statically known type — the analog of the
  8-attribute-register contract between IS programs and __closesthit__
  (sphere.cu:74-90).
- Volume (participating-media) primitives consume one pre-drawn free-flight
  uniform per (ray, volume slot) per trace — keyed RNG instead of the
  reference's mutable seed (volumeBox.cu:79-80), so results are independent
  of evaluation order.  Unlike the reference (SURVEY §7.4 quirk 5) the
  sampled distance is *rejected* when it exceeds the distance inside the
  boundary, per the book.

For small scenes (Cornell: 8 prims) XLA fuses this brute-force sweep into
the rest of the bounce — one elementwise block + min-reduce, no memory
traffic beyond the rays themselves.  Large scenes scan fixed-size blocks
(`_group_scan`) so the traced graph stays O(#groups), not O(#prims); on the
GPU ops/trace_kernel.py replaces that scan with one Pallas-Triton kernel.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from rtw.models import scene as S
from rtw.ops.vec import Vec3, where as wherev
from rtw.ops.sampling import safe_sqrt

BIG = np.float32(1e30)


class Hit(NamedTuple):
    """Per-ray nearest-hit record (HitRecord + instance/material resolution,
    lib/raydata.cuh:80-95 + closehit.cu:50-63).  SoA planes."""

    t: Any          # [N] float32; >= BIG/2 means miss
    prim_idx: Any   # [N] int32; -1 = miss
    mat_id: Any     # [N] int32
    point: Vec3     # [N] planes, world-space hit point
    normal: Vec3    # [N] planes, world-space unit normal
    u: Any          # [N] texture u
    v: Any          # [N] texture v


# ---------------------------------------------------------------------------
# Per-type t tests.  Rays are Vec3 of [N] (or [C, N]) planes; chunk params are
# [C, 1] columns.  Each returns t of shape [C, N] with BIG where there is no
# hit in (tmin, tmax).  tmin scalar, tmax [N] or scalar.
# ---------------------------------------------------------------------------

def _col(params, i):
    """[C, 9] chunk param table -> [C, 1] broadcast column.

    A list/tuple of per-ray [N] planes (the winner-reeval path, reeval_hit)
    passes through elementwise instead: the same test math then runs [N]
    against [N] — one primitive per ray."""
    if isinstance(params, (list, tuple)):
        return params[i]
    return params[:, i][:, None]


def _sphere_roots(o: Vec3, d: Vec3, center: Vec3, radius):
    """Quadratic roots vs spheres -> (t1, t2, valid) each [C, N]."""
    oc = o - center
    a = d.dot(d)
    b = oc.dot(d)
    c = oc.dot(oc) - radius * radius
    disc = b * b - a * c
    valid = disc >= 0.0
    sq = safe_sqrt(disc)
    inv_a = 1.0 / a
    return (-b - sq) * inv_a, (-b + sq) * inv_a, valid


def sphere_t(params, o, d, tmin, tmax):
    center = Vec3(_col(params, 0), _col(params, 1), _col(params, 2))
    t1, t2, valid = _sphere_roots(o, d, center, _col(params, 3))
    t = jnp.where((t1 > tmin) & (t1 < tmax), t1,
                  jnp.where((t2 > tmin) & (t2 < tmax), t2, BIG))
    return jnp.where(valid, t, BIG)


def moving_sphere_t(params, o, d, tmin, tmax, time):
    """Center lerped by per-ray gather time (movingSphere.cu:33-39,66)."""
    c0 = Vec3(_col(params, 0), _col(params, 1), _col(params, 2))
    c1 = Vec3(_col(params, 4), _col(params, 5), _col(params, 6))
    t0 = _col(params, 7)
    t1p = _col(params, 8)
    span = t1p - t0
    tb = time if isinstance(params, (list, tuple)) else time[None, :]
    frac = jnp.where(span == 0.0, 0.0,
                     (tb - t0) / jnp.where(span == 0.0, 1.0, span))
    center = c0 + (c1 - c0) * frac
    r1, r2, valid = _sphere_roots(o, d, center, _col(params, 3))
    t = jnp.where((r1 > tmin) & (r1 < tmax), r1,
                  jnp.where((r2 > tmin) & (r2 < tmax), r2, BIG))
    return jnp.where(valid, t, BIG)


_AXIS_OTHERS = {S.AXIS_X: (1, 2), S.AXIS_Y: (0, 2), S.AXIS_Z: (0, 1)}


def rect_t(params, o: Vec3, d: Vec3, tmin, tmax, axis: int):
    """Axis-aligned rect plane-slab test (shaders/aarect{x,y,z}.cu)."""
    a0, a1, b0, b1, k = (_col(params, i) for i in range(5))
    ia, ib = _AXIS_OTHERS[axis]
    dk = d[axis]
    t = (k - o[axis]) / jnp.where(dk == 0.0, 1e-30, dk)
    pa = o[ia] + t * d[ia]
    pb = o[ib] + t * d[ib]
    inside = (pa >= a0) & (pa <= a1) & (pb >= b0) & (pb <= b1)
    return jnp.where(inside & (t > tmin) & (t < tmax), t, BIG)


def _box_roots(o: Vec3, d: Vec3, bmin: Vec3, bmax: Vec3):
    """Slab test -> (near, far) [C, N] over the full real line."""
    near = jnp.full_like(o.x + d.x, -BIG)
    far = jnp.full_like(near, BIG)
    for ax in range(3):
        inv = 1.0 / jnp.where(d[ax] == 0.0, 1e-30, d[ax])
        t0 = (bmin[ax] - o[ax]) * inv
        t1 = (bmax[ax] - o[ax]) * inv
        near = jnp.maximum(near, jnp.minimum(t0, t1))
        far = jnp.minimum(far, jnp.maximum(t0, t1))
    return near, far


def _volume_t(near, far, valid, density, u, tmin, tmax, d_len):
    """Free-flight sampling inside a boundary (volumeBox.cu:55-113 with the
    book-correct rejection: a sample beyond the far boundary misses)."""
    h1 = jnp.maximum(jnp.maximum(near, tmin), 0.0)
    h2 = jnp.minimum(far, tmax)
    ok = valid & (h1 < h2)
    dist_inside = (h2 - h1) * d_len
    # density guard: block PAD rows carry density 0; 1/0 = inf makes
    # `flight` inf there, and inf reaches d_len's REVERSE-MODE cotangent as
    # 0 * inf = NaN through `flight / d_len` (d_len depends on the
    # differentiable ray direction) — the masked primal is fine but the NaN
    # cotangent contaminates shared camera gradients through the lane sum.
    flight = (-(1.0 / jnp.maximum(density, 1e-20))
              * jnp.log(jnp.maximum(u, 1e-30)))
    ok = ok & (flight <= dist_inside)
    t = h1 + flight / d_len
    return jnp.where(ok, t, BIG)


def volume_sphere_t(params, o, d, tmin, tmax, u):
    center = Vec3(_col(params, 0), _col(params, 1), _col(params, 2))
    t1, t2, valid = _sphere_roots(o, d, center, _col(params, 3))
    d_len = jnp.sqrt(jnp.maximum(d.dot(d), 1e-30))
    return _volume_t(t1, t2, valid, _col(params, 4), u, tmin, tmax, d_len)


def box_t(params, o, d, tmin, tmax):
    """Solid axis-aligned box via one slab test — the data-parallel collapse of
    the reference's 6-AARect composite (ioGeometryGroup.h:27-41 createBox):
    identical hits at 1/6 the primitive count.  Entry hit at `near` when the
    origin is outside, exit hit at `far` when inside — exactly which of the
    six rects the composite would report."""
    bmin = Vec3(_col(params, 0), _col(params, 1), _col(params, 2))
    bmax = Vec3(_col(params, 3), _col(params, 4), _col(params, 5))
    near, far = _box_roots(o, d, bmin, bmax)
    t = jnp.where((near > tmin) & (near < tmax), near,
                  jnp.where((far > tmin) & (far < tmax), far, BIG))
    return jnp.where(near <= far, t, BIG)


def _box_payload(p9, o: Vec3, d: Vec3, t, tmin):
    """Hit face (outward normal) + per-face uv of the box prim, matching the
    createBox rect layout: Z faces uv from (x, y), Y faces from (x, z),
    X faces from (y, z) (builder.box face rect params)."""
    point = o + d * t
    bmin = [p9[0], p9[1], p9[2]]
    bmax = [p9[3], p9[4], p9[5]]
    # recompute the slab ts at the winning prim to identify the face axis
    tns, tfs = [], []
    for ax in range(3):
        dk = d[ax]
        inv = 1.0 / jnp.where(dk == 0.0, 1e-30, dk)
        t0 = (bmin[ax] - o[ax]) * inv
        t1 = (bmax[ax] - o[ax]) * inv
        tns.append(jnp.minimum(t0, t1))
        tfs.append(jnp.maximum(t0, t1))
    near = jnp.maximum(jnp.maximum(tns[0], tns[1]), tns[2])
    entry = near > tmin    # same branch box_t used to pick near vs far
    # entry face: axis attaining `near`; exit face: axis attaining `far`
    sel = []
    for ax in range(3):
        is_near = tns[ax] >= jnp.maximum(tns[(ax + 1) % 3], tns[(ax + 2) % 3])
        is_far = tfs[ax] <= jnp.minimum(tfs[(ax + 1) % 3], tfs[(ax + 2) % 3])
        # boolean combine of the i1 masks
        sel.append((entry & is_near) | (~entry & is_far))
    # break argmax ties deterministically: first axis wins
    sel[1] = sel[1] & ~sel[0]
    sel[2] = sel[2] & ~sel[0] & ~sel[1]
    d_sign = [jnp.where(d[ax] >= 0.0, 1.0, -1.0) for ax in range(3)]
    # entering with d>0 crosses the min face (outward normal -axis)
    n_sign = [jnp.where(entry, -d_sign[ax], d_sign[ax]) for ax in range(3)]
    normal = Vec3(*(jnp.where(sel[ax], n_sign[ax], 0.0) for ax in range(3)))
    zero = jnp.zeros_like(t)
    uu, vv = zero, zero
    for ax, (ia, ib) in ((0, (1, 2)), (1, (0, 2)), (2, (0, 1))):
        fu = (point[ia] - bmin[ia]) / jnp.maximum(bmax[ia] - bmin[ia], 1e-20)
        fv = (point[ib] - bmin[ib]) / jnp.maximum(bmax[ib] - bmin[ib], 1e-20)
        uu = jnp.where(sel[ax], fu, uu)
        vv = jnp.where(sel[ax], fv, vv)
    return point, normal, uu, vv


def volume_box_t(params, o, d, tmin, tmax, u):
    bmin = Vec3(_col(params, 0), _col(params, 1), _col(params, 2))
    bmax = Vec3(_col(params, 3), _col(params, 4), _col(params, 5))
    near, far = _box_roots(o, d, bmin, bmax)
    d_len = jnp.sqrt(jnp.maximum(d.dot(d), 1e-30))
    return _volume_t(near, far, near <= far, _col(params, 6), u, tmin, tmax,
                     d_len)


# ---------------------------------------------------------------------------
# Chunked scene sweep
# ---------------------------------------------------------------------------

def _chunk_mat(m):
    """[C, 3, 4] affine batch -> nested [C, 1] column lists for vec.affine_*."""
    return [[m[:, i, j][:, None] for j in range(4)] for i in range(3)]


def _xform_rays(w2o, o: Vec3, d: Vec3):
    """Object-space rays per prim: Vec3 of [C, N] planes."""
    m = _chunk_mat(w2o)
    o_obj = Vec3(
        m[0][0] * o.x + m[0][1] * o.y + m[0][2] * o.z + m[0][3],
        m[1][0] * o.x + m[1][1] * o.y + m[1][2] * o.z + m[1][3],
        m[2][0] * o.x + m[2][1] * o.y + m[2][2] * o.z + m[2][3],
    )
    d_obj = Vec3(
        m[0][0] * d.x + m[0][1] * d.y + m[0][2] * d.z,
        m[1][0] * d.x + m[1][1] * d.y + m[1][2] * d.z,
        m[2][0] * d.x + m[2][1] * d.y + m[2][2] * d.z,
    )
    return o_obj, d_obj


def _block_t(ptype, axis, has_xform, params, w2o, slots, o, d, tmin, tmax,
             time, vol_u, valid):
    """t-matrix [C, N] for one block of C same-typed primitives.

    params [C, 9]; w2o [C, 3, 4]; slots [C]; valid [C] (pad mask).
    """
    if has_xform:
        o_obj, d_obj = _xform_rays(w2o, o, d)
    else:
        o_obj, d_obj = o, d

    if ptype == S.PRIM_SPHERE:
        t = sphere_t(params, o_obj, d_obj, tmin, tmax)
    elif ptype == S.PRIM_MOVING_SPHERE:
        t = moving_sphere_t(params, o_obj, d_obj, tmin, tmax, time)
    elif ptype == S.PRIM_RECT:
        t = rect_t(params, o_obj, d_obj, tmin, tmax, axis)
    elif ptype == S.PRIM_BOX:
        t = box_t(params, o_obj, d_obj, tmin, tmax)
    elif ptype in (S.PRIM_VOLUME_SPHERE, S.PRIM_VOLUME_BOX):
        u = vol_u[jnp.maximum(slots, 0)]  # [C, N]
        fn = volume_sphere_t if ptype == S.PRIM_VOLUME_SPHERE else volume_box_t
        t = fn(params, o_obj, d_obj, tmin, tmax, u)
    else:  # pragma: no cover
        raise ValueError(f"unknown prim type {ptype}")

    return jnp.where(valid[:, None], t, BIG)


def _group_scan(scene, entry, o, d, tmin, tmax, time, vol_u, reduce_fn, init):
    """Run one typed group through `reduce_fn(carry, t_mat, base)` where
    t_mat is [C, N].  Large groups scan over fixed-size blocks so the traced
    graph stays O(#groups), not O(#prims) — essential because this host's XLA
    compile is slow and TNW-final has ~3.4k primitives."""
    start, count, size, ptype, axis, has_xform, block = entry
    prims = scene.prims
    params = prims.params[start:start + size]
    w2o = prims.w2o[start:start + size]
    slots = prims.vol_slot[start:start + size]
    valid = jnp.asarray(np.arange(size) < count)

    n_blocks = size // block
    if n_blocks == 1:
        t_mat = _block_t(ptype, axis, has_xform, params, w2o, slots,
                         o, d, tmin, tmax, time, vol_u, valid)
        return reduce_fn(init, t_mat, jnp.asarray(start, jnp.int32))

    def body(carry, xs):
        p, m, sl, va, base = xs
        t_mat = _block_t(ptype, axis, has_xform, p, m, sl,
                         o, d, tmin, tmax, time, vol_u, va)
        return reduce_fn(carry, t_mat, base), None

    xs = (
        params.reshape(n_blocks, block, -1),
        w2o.reshape(n_blocks, block, 3, 4),
        slots.reshape(n_blocks, block),
        valid.reshape(n_blocks, block),
        jnp.asarray(start + np.arange(n_blocks) * block, jnp.int32),
    )
    carry, _ = jax.lax.scan(body, init, xs)
    return carry


def _gather_xform(prims, idx):
    """Per-ray world<->object transforms of the winning prim as nested [N]
    component lists (12 scalar gathers each)."""
    w2o = [[prims.w2o[:, i, j][idx] for j in range(4)] for i in range(3)]
    o2w = [[prims.o2w[:, i, j][idx] for j in range(4)] for i in range(3)]
    return w2o, o2w


def _sphere_uv(n: Vec3):
    """Spherical uv from unit normal (sphere.cu:24-32).

    Detached from AD: arctan2/arcsin have pole singularities whose backward
    inf/NaN would poison whole-wavefront gradients.  Texture-*coordinate*
    gradients are out of the differentiability scope (diff.py docstring);
    hit-point-driven texture gradients (noise) still flow via `p`."""
    n = jax.tree_util.tree_map(jax.lax.stop_gradient, n)
    phi = jnp.arctan2(n.z, n.x)
    theta = jnp.arcsin(jnp.clip(n.y, -1.0, 1.0))
    u = 1.0 - (phi + np.pi) / (2.0 * np.pi)
    v = (theta + np.pi / 2.0) / np.pi
    return u, v


def _payload(ptype: int, axis: int, p9, o: Vec3, d: Vec3, t, time,
             tmin=0.0):
    """Object-space hit payload for one gathered prim per ray.
    p9: list of 9 [N] param planes; o, d Vec3 [N]; t [N].
    `tmin` is consumed only by the box payload (entry-vs-exit face choice).
    Returns (point Vec3, normal Vec3, u, v)."""
    if ptype == S.PRIM_BOX:
        return _box_payload(p9, o, d, t, tmin)
    point = o + d * t
    zero = jnp.zeros_like(t)
    # Radius guard: the payload runs for EVERY lane with the lane's winner
    # params gathered positionally, so lanes whose winner is another type
    # see garbage in p9[3] — a TNW ground box with maxx == 0.0 exactly makes
    # 1/p9[3] = inf here, and the masked lane's inf forward value becomes a
    # 0*inf = NaN COTANGENT in reverse-mode that contaminates the shared
    # camera-parameter gradient through the lane sum (masking selects
    # values, not cotangent arithmetic).  Real radii are > 0.
    if ptype == S.PRIM_SPHERE:
        r_safe = jnp.where(jnp.abs(p9[3]) > 1e-20, p9[3], 1.0)
        normal = (point - Vec3(p9[0], p9[1], p9[2])) * (1.0 / r_safe)
        u, v = _sphere_uv(normal)
        return point, normal, u, v
    if ptype == S.PRIM_MOVING_SPHERE:
        c0 = Vec3(p9[0], p9[1], p9[2])
        c1 = Vec3(p9[4], p9[5], p9[6])
        span = p9[8] - p9[7]
        frac = jnp.where(span == 0.0, 0.0,
                         (time - p9[7]) / jnp.where(span == 0.0, 1.0, span))
        center = c0 + (c1 - c0) * frac
        r_safe = jnp.where(jnp.abs(p9[3]) > 1e-20, p9[3], 1.0)
        normal = (point - center) * (1.0 / r_safe)
        u, v = _sphere_uv(normal)
        return point, normal, u, v
    if ptype == S.PRIM_RECT:
        ia, ib = _AXIS_OTHERS[axis]
        a0, a1, b0, b1 = p9[0], p9[1], p9[2], p9[3]
        flip = p9[6]
        sign = jnp.where(flip > 0.5, -1.0, 1.0)
        comps = [zero, zero, zero]
        comps[axis] = sign
        normal = Vec3(*comps)
        u = (point[ia] - a0) / jnp.maximum(a1 - a0, 1e-20)
        v = (point[ib] - b0) / jnp.maximum(b1 - b0, 1e-20)
        return point, normal, u, v
    # volumes: constant +X normal, zero uv (volumeBox.cu:88-94)
    return point, Vec3(jnp.ones_like(t), zero, zero), zero, zero


def intersect_scene(scene, o: Vec3, d: Vec3, tmin, tmax, time, vol_u) -> Hit:
    """Nearest hit of each ray against every primitive.

    o, d: Vec3 of [N] planes (d need not be unit — t is in units of |d|, as
    in the reference where camera rays are unnormalized, raygen.cu:107-120).
    time: [N] gather times for motion blur.  vol_u: [max(n_vol,1), N]
    pre-drawn free-flight uniforms.
    """
    best_t, best_prim = nearest(scene, o, d, tmin, tmax, time, vol_u)
    return winner_hit(scene, best_t, best_prim, o, d, time, tmin)


def nearest(scene, o: Vec3, d: Vec3, tmin, tmax, time, vol_u):
    """Pass 1 of intersect_scene: the (t, prim) argmin over every typed
    group — (best_t [N], best_prim [N], -1 on miss)."""
    n = o.x.shape[0]
    best_t = jnp.full((n,), BIG, jnp.float32)
    best_prim = jnp.full((n,), -1, jnp.int32)

    def min_reduce(carry, t_mat, base):
        bt, bp = carry
        c_arg = jnp.argmin(t_mat, axis=0).astype(jnp.int32)
        c_t = jnp.min(t_mat, axis=0)
        better = c_t < bt
        return (jnp.where(better, c_t, bt),
                jnp.where(better, base + c_arg, bp))

    for entry in scene.chunk_plan:
        best_t, best_prim = _group_scan(scene, entry, o, d, tmin, tmax, time,
                                        vol_u, min_reduce, (best_t, best_prim))
    return best_t, best_prim


def winner_hit(scene, best_t, best_prim, o: Vec3, d: Vec3, time,
               tmin) -> Hit:
    """Pass 2 of intersect_scene: the hit record of each ray's winner
    (from `nearest` or the trace kernel)."""
    prims = scene.prims
    hit_mask = best_prim >= 0
    safe_prim = jnp.maximum(best_prim, 0)
    # payload t clamped to 0 on miss lanes: a BIG t would produce ~1e30 hit
    # points whose squared distances overflow to inf downstream — masked in
    # the primal but 0*inf = NaN in reverse-mode
    t_pay = jnp.where(hit_mask, best_t, 0.0)

    # pass 2: payload for the global winner.  Gather the winner's parameters
    # once ([N] planes), then one statically-typed payload computation per
    # group, selected by which group owns the winning prim.
    p9 = [prims.params[:, k][safe_prim] for k in range(S.NUM_PRIM_PARAMS)]
    point, normal, uu, vv = _winner_payload(scene, safe_prim, hit_mask, p9,
                                            o, d, t_pay, time, tmin)
    mat_id = jnp.where(hit_mask, prims.material_id[safe_prim], 0)
    return Hit(t=best_t, prim_idx=best_prim, mat_id=mat_id,
               point=point, normal=normal, u=uu, v=vv)


def _winner_payload(scene, safe_prim, hit_mask, p9, o: Vec3, d: Vec3, t_pay,
                    time, tmin):
    """Hit payload (point, normal, u, v) for per-ray winners `safe_prim`:
    one statically-typed payload computation per chunk-plan group, selected
    by which group owns each lane's winning prim.  Shared by
    intersect_scene's pass 2 and reeval_hit."""
    n = t_pay.shape[0]
    prims = scene.prims
    any_xform = any(e[5] for e in scene.chunk_plan)
    if any_xform:
        w2o_g, o2w_g = _gather_xform(prims, safe_prim)
        o_x = Vec3(
            w2o_g[0][0] * o.x + w2o_g[0][1] * o.y + w2o_g[0][2] * o.z + w2o_g[0][3],
            w2o_g[1][0] * o.x + w2o_g[1][1] * o.y + w2o_g[1][2] * o.z + w2o_g[1][3],
            w2o_g[2][0] * o.x + w2o_g[2][1] * o.y + w2o_g[2][2] * o.z + w2o_g[2][3],
        )
        d_x = Vec3(
            w2o_g[0][0] * d.x + w2o_g[0][1] * d.y + w2o_g[0][2] * d.z,
            w2o_g[1][0] * d.x + w2o_g[1][1] * d.y + w2o_g[1][2] * d.z,
            w2o_g[2][0] * d.x + w2o_g[2][1] * d.y + w2o_g[2][2] * d.z,
        )

    zero = jnp.zeros((n,), jnp.float32)
    point = Vec3(zero, zero, zero)
    normal = Vec3(zero, zero, zero)
    uu, vv = zero, zero
    for entry in scene.chunk_plan:
        start, count, size, ptype, axis, has_xform, _ = entry
        in_group = hit_mask & (safe_prim >= start) & (safe_prim < start + size)
        o_sel, d_sel = (o_x, d_x) if has_xform else (o, d)
        g_point, g_normal, g_u, g_v = _payload(ptype, axis, p9, o_sel,
                                               d_sel, t_pay, time, tmin=tmin)
        if has_xform:
            g_point = Vec3(
                o2w_g[0][0] * g_point.x + o2w_g[0][1] * g_point.y
                + o2w_g[0][2] * g_point.z + o2w_g[0][3],
                o2w_g[1][0] * g_point.x + o2w_g[1][1] * g_point.y
                + o2w_g[1][2] * g_point.z + o2w_g[1][3],
                o2w_g[2][0] * g_point.x + o2w_g[2][1] * g_point.y
                + o2w_g[2][2] * g_point.z + o2w_g[2][3],
            )
            # normal transforms with (W2O)^T
            g_normal = Vec3(
                w2o_g[0][0] * g_normal.x + w2o_g[1][0] * g_normal.y
                + w2o_g[2][0] * g_normal.z,
                w2o_g[0][1] * g_normal.x + w2o_g[1][1] * g_normal.y
                + w2o_g[2][1] * g_normal.z,
                w2o_g[0][2] * g_normal.x + w2o_g[1][2] * g_normal.y
                + w2o_g[2][2] * g_normal.z,
            )
        point = wherev(in_group, g_point, point)
        normal = wherev(in_group, g_normal, normal)
        uu = jnp.where(in_group, g_u, uu)
        vv = jnp.where(in_group, g_v, vv)

    return point, normal.normalized(), uu, vv


def reeval_hit(scene, prim_idx, o: Vec3, d: Vec3, tmin, tmax, time, vol_u,
               t_hint=None) -> Hit:
    """Differentiable hit record re-derived from a DETACHED winner.

    The fast gradient path (integrator.bounce_step with cfg.differentiable
    on the kernel backend) obtains `prim_idx` from the non-differentiable
    trace kernel under stop_gradient — legitimate because argmin winners are
    piecewise-constant decisions, the same detached-sampling discipline
    intersect_scene applies implicitly (jnp.min routes the cotangent to the
    winner only).  This function then recomputes (t, point, normal, uv) for
    JUST each ray's winning primitive in plain JAX: O(#groups) elementwise
    work per ray instead of the O(P) sweep, with the identical VJP structure
    (t differentiable through ray origin/direction and prim params; the
    winner identity detached).

    `t_hint`: the kernel's accepted t.  Used (detached) only where the
    elementwise re-evaluation disagrees with the kernel's accept decision at
    fp tolerance (e.g. a root within 1 ulp of the tmin/tmax window) so the
    payload never sees a BIG t.

    Reference capability: ONE hot path serving every workload — the
    reference renders and (hypothetically) differentiates through the same
    optixLaunch program (Director.cpp:982-984); here gradient renders ride
    the same Pallas trace kernels as plain ones."""
    n = o.x.shape[0]
    prims = scene.prims
    hit_mask = prim_idx >= 0
    sp = jnp.maximum(prim_idx, 0)
    p9 = [prims.params[:, k][sp] for k in range(S.NUM_PRIM_PARAMS)]

    if scene.n_vol > 0:
        slots = jnp.maximum(prims.vol_slot[sp], 0)
        u_sel = jnp.take_along_axis(vol_u, slots[None, :], axis=0)[0]
    else:
        u_sel = jnp.zeros((n,), jnp.float32)

    any_xform = any(e[5] for e in scene.chunk_plan)
    if any_xform:
        w2o_g, _ = _gather_xform(prims, sp)
        o_t = Vec3(
            w2o_g[0][0] * o.x + w2o_g[0][1] * o.y + w2o_g[0][2] * o.z + w2o_g[0][3],
            w2o_g[1][0] * o.x + w2o_g[1][1] * o.y + w2o_g[1][2] * o.z + w2o_g[1][3],
            w2o_g[2][0] * o.x + w2o_g[2][1] * o.y + w2o_g[2][2] * o.z + w2o_g[2][3],
        )
        d_t = Vec3(
            w2o_g[0][0] * d.x + w2o_g[0][1] * d.y + w2o_g[0][2] * d.z,
            w2o_g[1][0] * d.x + w2o_g[1][1] * d.y + w2o_g[1][2] * d.z,
            w2o_g[2][0] * d.x + w2o_g[2][1] * d.y + w2o_g[2][2] * d.z,
        )

    tmax_b = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (n,))
    t_re = jnp.zeros((n,), jnp.float32)
    for entry in scene.chunk_plan:
        start, count, size, ptype, axis, has_xform, _ = entry
        in_group = hit_mask & (sp >= start) & (sp < start + size)
        o_sel, d_sel = (o_t, d_t) if has_xform else (o, d)
        if ptype == S.PRIM_SPHERE:
            t_g = sphere_t(p9, o_sel, d_sel, tmin, tmax_b)
        elif ptype == S.PRIM_MOVING_SPHERE:
            t_g = moving_sphere_t(p9, o_sel, d_sel, tmin, tmax_b, time)
        elif ptype == S.PRIM_RECT:
            t_g = rect_t(p9, o_sel, d_sel, tmin, tmax_b, axis)
        elif ptype == S.PRIM_BOX:
            t_g = box_t(p9, o_sel, d_sel, tmin, tmax_b)
        elif ptype == S.PRIM_VOLUME_SPHERE:
            t_g = volume_sphere_t(p9, o_sel, d_sel, tmin, tmax_b, u_sel)
        elif ptype == S.PRIM_VOLUME_BOX:
            t_g = volume_box_t(p9, o_sel, d_sel, tmin, tmax_b, u_sel)
        else:  # pragma: no cover
            raise ValueError(f"unknown prim type {ptype}")
        t_re = jnp.where(in_group, t_g, t_re)

    if t_hint is not None:
        agree = t_re < BIG * 0.5
        t_re = jnp.where(agree, t_re, jax.lax.stop_gradient(t_hint))
    t_pay = jnp.where(hit_mask, t_re, 0.0)

    point, normal, uu, vv = _winner_payload(scene, sp, hit_mask, p9,
                                            o, d, t_pay, time, tmin)
    mat_id = jnp.where(hit_mask, prims.material_id[sp], 0)
    return Hit(t=jnp.where(hit_mask, t_re, BIG), prim_idx=prim_idx,
               mat_id=mat_id, point=point, normal=normal, u=uu, v=vv)


def occluded(scene, o: Vec3, d: Vec3, tmin, tmax, time, vol_u):
    """Boolean shadow query: any hit in (tmin, tmax)?  The analog of
    traceOcclusion's TERMINATE_ON_FIRST_HIT probe (closehit.cu:16-42), with
    volumes participating stochastically exactly as in the reference (their
    IS programs run for shadow rays too)."""
    n = o.x.shape[0]

    def any_reduce(occ, t_mat, base):
        return occ | jnp.any(t_mat < BIG, axis=0)

    occ = jnp.zeros((n,), bool)
    for entry in scene.chunk_plan:
        occ = _group_scan(scene, entry, o, d, tmin, tmax, time, vol_u,
                          any_reduce, occ)
    return occ
